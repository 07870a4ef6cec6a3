"""Port parity: ``partition_histogram`` (its plain version, which the
wrapper takes for CPU tensors) and ``hash32`` / ``hash64`` against the JAX
package on the same numpy inputs. The JAX histogram runs its Pallas kernel
in interpret mode.

Everything here is integers: every comparison is exact, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.core import datatype as jdt
from arrow_tpu.core.array import Array as JArray
from arrow_tpu.ops import hashing as jhashing
from arrow_tpu.ops.pallas_kernels import partition_histogram as \
    jpartition_histogram
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core.array import Array, array_from_numpy
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import hashing


# ---- partition_histogram -----------------------------------------------------

@pytest.mark.parametrize("P", [1, 3, 8, 128])
@pytest.mark.parametrize("n", [1, 1023, 1024, 5000])
def test_partition_histogram_vs_jax(n, P):
    """dest holds -1, P and P + 1 as well: values outside [0, P) are
    ignored by both."""
    rng = np.random.default_rng(n * 131 + P)
    d = rng.integers(-1, P + 2, n).astype(np.int32)
    want = np.asarray(jpartition_histogram(jnp.asarray(d), P))
    for fn in (ck.partition_histogram, ck.partition_histogram_plain):
        got = fn(torch.from_numpy(d), P)
        assert got.dtype == torch.int32 and got.shape == (P,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,P", [(100, 4), (1024, 8), (4096, 16),
                                 (5000, 64), (7, 2)])
def test_partition_histogram_cases_of_the_jax_kernel_test(rng, n, P):
    d = rng.integers(-1, P + 2, n).astype(np.int32)
    want = np.asarray(jpartition_histogram(jnp.asarray(d), P))
    np.testing.assert_array_equal(
        ck.partition_histogram(torch.from_numpy(d), P).numpy(), want)
    np.testing.assert_array_equal(
        want, np.array([(d == p).sum() for p in range(P)], np.int32))


@pytest.mark.parametrize("fill", ["all_one_value", "all_P", "all_minus_one"])
def test_partition_histogram_degenerate_dest_vs_jax(fill):
    P, n = 8, 3000
    d = np.full(n, {"all_one_value": 5, "all_P": P,
                    "all_minus_one": -1}[fill], np.int32)
    want = np.asarray(jpartition_histogram(jnp.asarray(d), P))
    np.testing.assert_array_equal(
        ck.partition_histogram(torch.from_numpy(d), P).numpy(), want)
    assert int(want.sum()) == (n if fill == "all_one_value" else 0)


def test_partition_histogram_no_rows_and_no_launch_on_cpu():
    """n = 0 gives zeros (the JAX kernel has no grid step to run there, so
    the expectation is the definition); a CPU tensor never counts as a
    kernel launch."""
    before = ck.LAUNCHES["partition_histogram"]
    got = ck.partition_histogram(torch.zeros((0,), dtype=torch.int32), 8)
    assert got.tolist() == [0] * 8 and got.dtype == torch.int32
    ck.partition_histogram(torch.arange(10, dtype=torch.int32), 4)
    assert ck.LAUNCHES["partition_histogram"] == before


def test_partition_histogram_refuses_what_the_kernel_does_not_take():
    """More partitions than the kernel supports raise (the JAX function
    returns a SHORT result there, which is not copied); so do other dtypes
    and shapes."""
    d = torch.zeros((16,), dtype=torch.int32)
    assert ck.MAX_PARTITIONS >= 128
    with pytest.raises(ValueError):
        ck.partition_histogram(d, ck.MAX_PARTITIONS + 1)
    with pytest.raises(ValueError):
        ck.partition_histogram(d, 0)
    with pytest.raises(ValueError):
        ck.partition_histogram(d.long(), 4)
    with pytest.raises(ValueError):
        ck.partition_histogram(d.reshape(4, 4), 4)


# ---- hash32 / hash64 ---------------------------------------------------------

_TYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64", "float16", "float32", "float64", "bool_", "date32",
          "date64", "timestamp"]


def _type_pair(name):
    if name == "timestamp":
        return jdt.TimestampType("us"), tdt.TimestampType("us")
    return getattr(jdt, name), getattr(tdt, name)


def _values(rng, name, n):
    jt, _ = _type_pair(name)
    npd = np.dtype(jt.storage_np)
    if npd.kind == "b":
        return rng.integers(0, 2, n).astype(np.bool_)
    if npd.kind == "f":
        x = rng.standard_normal(n).astype(npd)
        x[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0]
        x[6] = np.frombuffer(np.array([0x7FC00001], np.uint32).tobytes(),
                             np.float32)[0] if npd == np.float32 else np.nan
        return x
    info = np.iinfo(npd)
    x = rng.integers(info.min, info.max, n, dtype=npd, endpoint=True)
    x[:3] = [0, info.max, info.min]
    return x


def _pair(name, x, valid):
    jt, tt = _type_pair(name)
    return (JArray(jt, jnp.asarray(x),
                   None if valid is None else jnp.asarray(valid)),
            array_from_numpy(x, tt, validity=valid, device="cpu"))


def _assert_same_hashes(jcols, tcols, seed):
    got = hashing.hash32(tcols, seed=seed)
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < (1 << 32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhashing.hash32(jcols, seed=seed))
        .astype(np.int64))
    np.testing.assert_array_equal(
        hashing.hash64(tcols, seed=seed).numpy().view(np.uint64),
        np.asarray(jhashing.hash64(jcols, seed=seed)))


@pytest.mark.parametrize("with_validity", [False, True],
                         ids=["all_valid", "nulls"])
@pytest.mark.parametrize("name", _TYPES)
def test_hash_one_column_vs_jax(name, with_validity):
    rng = np.random.default_rng(len(name) * 7 + with_validity)
    n = 777
    x = _values(rng, name, n)
    valid = rng.random(n) < 0.8 if with_validity else None
    jcol, tcol = _pair(name, x, valid)
    for seed in (0, 7, 0x5108FF1E, 0x1B873593, 0xFFFFFFFF):
        _assert_same_hashes([jcol], [tcol], seed)


@pytest.mark.parametrize("seed", [0, 3, 0x5108FF1E])
def test_hash_several_columns_vs_jax(seed):
    """Per-column seeds and null markers over a five-column key, some
    columns with nulls, some without."""
    rng = np.random.default_rng(seed + 1)
    n = 1500
    jcols, tcols = [], []
    for i, name in enumerate(["int64", "float64", "int32", "bool_",
                              "uint64"]):
        valid = rng.random(n) < 0.7 if i % 2 == 0 else None
        j, t = _pair(name, _values(rng, name, n), valid)
        jcols.append(j)
        tcols.append(t)
    _assert_same_hashes(jcols, tcols, seed)
    np.testing.assert_array_equal(
        hashing.combine_hashes32(hashing.hash32(tcols[:1]),
                                 hashing.hash32(tcols[1:])).numpy(),
        np.asarray(jhashing.combine_hashes32(
            jhashing.hash32(jcols[:1]), jhashing.hash32(jcols[1:])))
        .astype(np.int64))


def test_hash32_validity_presence_invariant(rng):
    """hash32(col with validity=None) == hash32(col with an all-true
    mask), and both equal the JAX hash."""
    vals = rng.integers(0, 1000, 257)
    a = array_from_numpy(vals, device="cpu")
    b = array_from_numpy(vals, validity=np.ones(257, np.bool_), device="cpu")
    assert a.validity is None and b.validity is not None
    assert torch.equal(hashing.hash32([a], seed=7),
                       hashing.hash32([b], seed=7))
    want = jhashing.hash32([JArray(jdt.int64, jnp.asarray(vals), None)],
                           seed=7)
    np.testing.assert_array_equal(hashing.hash32([a], seed=7).numpy(),
                                  np.asarray(want).astype(np.int64))


def test_hash_nulls_hash_alike_and_apart_from_zero(rng):
    x = rng.integers(-5, 5, 300)
    valid = rng.random(300) < 0.5
    h = hashing.hash32([array_from_numpy(x, validity=valid, device="cpu")])
    assert len(set(h[~torch.from_numpy(valid)].tolist())) == 1
    zero = hashing.hash32([array_from_numpy(np.zeros(1, np.int64),
                                            device="cpu")])
    assert int(zero[0]) not in set(h[~torch.from_numpy(valid)].tolist())


def test_hash_helpers_vs_jax(rng):
    cols = {"a": rng.integers(0, 50, 400), "b": rng.standard_normal(400)}
    tb = batch_from_numpy(cols, device="cpu")
    jcols = [JArray(jdt.int64, jnp.asarray(cols["a"])),
             JArray(jdt.float64, jnp.asarray(cols["b"]))]
    np.testing.assert_array_equal(
        hashing.hash_batch_columns(tb, ["a", "b"], seed=5).numpy(),
        np.asarray(jhashing.hash32(jcols, seed=5)).astype(np.int64))
    for tl, jl in zip(hashing.normalize_keys([tb["a"], tb["b"]]),
                      jhashing.normalize_keys(jcols)):
        np.testing.assert_array_equal(tl.numpy(),
                                      np.asarray(jl).astype(np.int64))


def test_hash_of_varlen_and_dictionary_keys_is_not_ported():
    """String and dictionary keys hash now (they were not ported before):
    a string column through its sampled fingerprint, a dictionary column
    through its values' content lanes, both as the JAX package does."""
    import pyarrow as pa
    from arrow_tpu.core.interop import array_from_pyarrow as jfrom
    from arrow_tpu.ops import hashing as jhashing
    from arrow_tpu_torch.core.interop import array_from_pyarrow as tfrom
    s = pa.array(["", "a", None, "x" * 17, "é"] * 5)
    for arr in (s, s.dictionary_encode()):
        got = hashing.hash32([tfrom(arr, device="cpu")]).numpy()
        want = np.asarray(jhashing.hash32([jfrom(arr)])).astype(np.int64)
        np.testing.assert_array_equal(got, want)
