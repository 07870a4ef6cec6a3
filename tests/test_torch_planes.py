"""Port parity: ``arrow_tpu_torch.ops.planes`` against the JAX package's
``ops/planes``: the pack matrix equal word for word, the round trip
bit-exact (NaN payloads, -0.0, validity planes past 32 columns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.core import datatype as jdt
from arrow_tpu.ops import planes as jplanes
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core.array import Array as TArray
from arrow_tpu_torch.ops import planes as tplanes

CAP = 300

# (name, numpy storage dtype, JAX type, port type)
KINDS = [
    ("bool", np.bool_, jdt.bool_, tdt.bool_),
    ("int8", np.int8, jdt.int8, tdt.int8),
    ("int16", np.int16, jdt.int16, tdt.int16),
    ("int32", np.int32, jdt.int32, tdt.int32),
    ("int64", np.int64, jdt.int64, tdt.int64),
    ("uint8", np.uint8, jdt.uint8, tdt.uint8),
    ("uint16", np.uint16, jdt.uint16, tdt.uint16),
    ("uint32", np.uint32, jdt.uint32, tdt.uint32),
    ("uint64", np.uint64, jdt.uint64, tdt.uint64),
    ("float16", np.float16, jdt.float16, tdt.float16),
    ("float32", np.float32, jdt.float32, tdt.float32),
    ("float64", np.float64, jdt.float64, tdt.float64),
    ("date32", np.int32, jdt.date32, tdt.date32),
    ("timestamp", np.int64, jdt.timestamp("us"), tdt.timestamp("us")),
    ("decimal_narrow", np.int64, jdt.DecimalType(12, 2),
     tdt.DecimalType(12, 2)),
    ("decimal_wide", np.int64, jdt.DecimalType(30, 4),
     tdt.DecimalType(30, 4)),
]


def _values(rng, name, np_t):
    """Random storage bits of every pattern: for floats any bit pattern
    (NaN payloads, signalling NaNs, -0.0, subnormals)."""
    shape = (CAP, 2) if name == "decimal_wide" else (CAP,)
    if np_t == np.bool_:
        return rng.random(shape) < 0.5
    raw = rng.integers(0, 256, shape + (np.dtype(np_t).itemsize,),
                       dtype=np.uint8)
    return raw.view(np_t).reshape(shape)


def _pair(rng, name, np_t, jt, tt, nullable):
    v = _values(rng, name, np_t)
    valid = rng.random(CAP) < 0.7 if nullable else None
    ja = at.Array(jt, jnp.asarray(v),
                  None if valid is None else jnp.asarray(valid))
    ta = TArray(tt, torch.from_numpy(v.copy()),
                None if valid is None else torch.from_numpy(valid))
    return v, valid, ja, ta


@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("nullable", [False, True], ids=["dense", "nulls"])
def test_pack_one_column_vs_jax(kind, nullable):
    name, np_t, jt, tt = kind
    rng = np.random.default_rng(len(name))
    v, valid, ja, ta = _pair(rng, name, np_t, jt, tt, nullable)
    assert tplanes.plane_width(tt) == jplanes.plane_width(jt)
    jmat, jspec = jplanes.pack_columns([ja])
    tmat, tspec = tplanes.pack_columns([ta])
    assert tmat.dtype == torch.int32
    np.testing.assert_array_equal(tmat.numpy().view(np.uint32),
                                  np.asarray(jmat))
    assert [(w, hv) for _, w, hv in tspec] == \
        [(w, hv) for _, w, hv in jspec]
    assert tplanes.pack_spec([ta]) == tspec
    (back,) = tplanes.unpack_columns(tmat, tspec, CAP)
    assert back.values.dtype == ta.values.dtype
    got = back.values.numpy()
    # bit-exact: compare the storage bytes
    np.testing.assert_array_equal(got.view(np.uint8), v.view(np.uint8))
    if nullable:
        np.testing.assert_array_equal(back.validity.numpy(), valid)
    else:
        assert back.validity is None


def test_pack_many_columns_validity_planes_past_32_vs_jax():
    rng = np.random.default_rng(77)
    jcols, tcols, raw = [], [], []
    for i in range(70):
        name, np_t, jt, tt = KINDS[i % len(KINDS)]
        v, valid, ja, ta = _pair(rng, name, np_t, jt, tt, i % 7 != 3)
        jcols.append(ja)
        tcols.append(ta)
        raw.append((v, valid))
    jmat, _ = jplanes.pack_columns(jcols)
    tmat, tspec = tplanes.pack_columns(tcols)
    n_valid = sum(1 for _, valid in raw if valid is not None)
    assert n_valid > 32 and tmat.shape[1] == sum(
        w for _, w, _ in tspec) + (n_valid + 31) // 32
    np.testing.assert_array_equal(tmat.numpy().view(np.uint32),
                                  np.asarray(jmat))
    # a row gather through the matrix, then unpack, with a join's null
    # extension
    idx = torch.from_numpy(rng.integers(0, CAP, 500))
    extra = torch.from_numpy(rng.random(500) < 0.8)
    out = tplanes.unpack_columns(tmat[idx], tspec, 500, extra_valid=extra)
    for a, (v, valid) in zip(out, raw):
        np.testing.assert_array_equal(a.values.numpy().view(np.uint8),
                                      v[idx.numpy()].view(np.uint8))
        want = extra.numpy() if valid is None else \
            valid[idx.numpy()] & extra.numpy()
        np.testing.assert_array_equal(a.validity.numpy(), want)


def test_varlen_and_dictionary_do_not_pack():
    assert tplanes.plane_width(tdt.string) is None
    assert not tplanes.can_pack([tdt.int32, tdt.string])
    assert tplanes.can_pack([tdt.int32, tdt.float64, tdt.bool_])
    # a dictionary column packs as its int32 indices
    assert tplanes.plane_width(tdt.DictionaryType(tdt.int32, tdt.string)) \
        == 1
