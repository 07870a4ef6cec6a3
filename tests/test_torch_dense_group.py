"""Port parity: the plain dense_group_reduce against the JAX Pallas kernel
(interpret mode on the CPU), for every kind, at G = 128.

Integers and f32 min/max must match exactly; f32 sums within
|diff| <= 1e-5 * sum(|x|) + 1e-6 per slot, because the two sum in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.ops.pallas_kernels import _DG_ARITY
from arrow_tpu.ops.pallas_kernels import dense_group_reduce as jax_dgr
from arrow_tpu_torch.ops import cuda_kernels as ck

G = 128
N = 3000


def _inputs(kind, gid, rng):
    """Inputs of one kind, pre-masked as consume_dense does; slot 7 of the
    f32 extremes holds a NaN."""
    n = gid.shape[0]
    if kind in ("sum", "min", "max"):
        x = rng.standard_normal(n).astype(np.float32)
        if kind != "sum":
            x[gid == 7] = np.nan
        return [x]
    if kind == "sumc":
        return [rng.integers(0, 1 << 16, n).astype(np.int32)]
    if kind in ("imin64", "imax64"):
        return [rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
                for _ in range(2)]
    return [rng.integers(-1000, 1000, n).astype(np.int32)]


def _gid(rng):
    """Slots 0..99 used (100..127 stay empty), inactive rows (-1) and rows
    at or past G, which no slot may take."""
    gid = rng.integers(-1, 100, N).astype(np.int32)
    gid[::97] = G
    gid[::89] = G + 77
    return gid


def _compare(kind, gid, xs, got, want):
    slot = np.where((gid >= 0) & (gid < G), gid, G)
    for j, (a, b) in enumerate(zip(got, want)):
        if kind == "sum":
            absum = np.bincount(slot, weights=np.abs(xs[0]).astype(
                np.float64), minlength=G + 1)[:G]
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            assert (d <= 1e-5 * absum + 1e-6).all(), (kind, d.max())
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{kind}[{j}]")


@pytest.mark.parametrize("kind", sorted(_DG_ARITY))
def test_dense_group_reduce_plain_vs_jax(kind):
    rng = np.random.default_rng(sorted(_DG_ARITY).index(kind))
    gid = _gid(rng)
    xs = _inputs(kind, gid, rng)
    jrows, jouts = jax_dgr(jnp.asarray(gid), tuple(jnp.asarray(x) for x in xs),
                           (kind,), G)
    rows, outs = ck.dense_group_reduce(
        torch.from_numpy(gid), tuple(torch.from_numpy(x) for x in xs),
        (kind,), G)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert [o.numpy().dtype for o in outs] == [
        np.asarray(o).dtype for o in jouts]
    _compare(kind, gid, xs, [o.numpy() for o in outs],
             [np.asarray(o) for o in jouts])
    if kind in ("min", "max"):
        assert np.isnan(outs[0][7].item())
    empty = np.asarray(jrows) == 0
    assert empty[100:].all()


def test_dense_group_reduce_all_kinds_one_call():
    """Several kinds in one call (the slice's kind list), in and out of
    order as consume_dense builds it."""
    rng = np.random.default_rng(11)
    gid = _gid(rng)
    kinds = ("imin", "count", "sum", "min", "count", "sumc", "sumc",
             "sumc", "sumc", "imin64")
    xs = [x for k in kinds for x in _inputs(k, gid, rng)]
    jrows, jouts = jax_dgr(jnp.asarray(gid), tuple(jnp.asarray(x) for x in xs),
                           kinds, G)
    rows, outs = ck.dense_group_reduce(
        torch.from_numpy(gid), tuple(torch.from_numpy(x) for x in xs),
        kinds, G)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    oi = ij = 0
    for k in kinds:
        ni, no = _DG_ARITY[k]
        _compare(k, gid, xs[ij:ij + ni], [o.numpy() for o in outs[oi:oi + no]],
                 [np.asarray(o) for o in jouts[oi:oi + no]])
        oi += no
        ij += ni


@pytest.mark.parametrize("G_,n_kinds", [(128, 10), (1024, 10), (4096, 24)])
def test_dense_group_launch_groups_fit_shared_memory(G_, n_kinds):
    """The CUDA wrapper's split of the kinds over launches: every launch
    holds at most 16 kinds and (1 + outputs) * G * 4 bytes within budget,
    in order, and covers every kind once."""
    kinds = tuple((["sumc", "imin64", "sum", "count"] * 8)[:n_kinds])
    groups = ck._dg_launch_groups(kinds, G_)
    assert [i for g in groups for i in g] == list(range(n_kinds))
    for g in groups:
        outs = sum(ck._DG_ARITY[kinds[i]][1] for i in g)
        assert len(g) <= ck._DG_MAX_KINDS
        assert 4 * G_ * (1 + outs) <= ck._DG_SMEM_BUDGET
        assert 4 * G_ * (1 + outs) == 4 * G_ + sum(
            ck._dg_acc_bytes(kinds[i], G_) for i in g)
    if G_ == 1024:
        assert len(groups) == 1      # the slice's call: one launch


def test_dense_group_reduce_rejects_bad_arguments():
    gid = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(ValueError):
        ck.dense_group_reduce(gid, (x,), ("sum",), 100)       # G % 128
    with pytest.raises(ValueError):
        ck.dense_group_reduce(gid, (x.int(),), ("sum",), 128)  # dtype
    with pytest.raises(ValueError):
        ck.dense_group_reduce(gid, (x, x), ("sum",), 128)     # arity


# ---- the card's native kinds --------------------------------------------------

_I64 = np.iinfo(np.int64)


def _native_case(rng):
    """gid with inactive and out-of-range rows and a busy last slot (the
    null-key slot G - 1), an int64 column with the type's extremes and
    sums that wrap past 2^63, and a validity stream."""
    gid = _gid(rng)
    gid[::13] = G - 1
    w = rng.integers(-(1 << 62), 1 << 62, N)
    w[:N // 4] = rng.integers(-100, 100, N // 4)
    w[gid == 5] = rng.integers((1 << 62), _I64.max, int((gid == 5).sum()))
    w[3], w[4] = _I64.max, _I64.min
    valid = rng.random(N) >= 0.2
    return gid, w, valid


def _tpu_sum64(gid, w, ok):
    """The int64 sum as the TPU caller gets it: four 16-bit limb streams of
    the sign-biased value, pre-masked, through "sumc"; recombined and
    un-biased by the valid count."""
    u = w.view(np.uint64) ^ np.uint64(1 << 63)
    limbs = [np.where(ok, (u >> np.uint64(16 * k)) & np.uint64(0xFFFF), 0)
             .astype(np.int32) for k in range(4)]
    _, outs = jax_dgr(jnp.asarray(gid),
                      tuple(jnp.asarray(x) for x in limbs) +
                      (jnp.asarray(ok.astype(np.int32)),),
                      ("sumc",) * 4 + ("count",), G)
    outs = [np.asarray(o) for o in outs]
    total = np.zeros(G, np.uint64)
    for k in range(4):
        limb = (outs[2 * k + 1].astype(np.uint32).astype(np.uint64)
                << np.uint64(32)) | outs[2 * k].astype(np.uint32)
        total += limb << np.uint64(16 * k)
    cnt = outs[8].astype(np.uint64)
    return (total - (cnt << np.uint64(63))).view(np.int64)


def _tpu_extreme64(gid, w, ok, is_min):
    """The int64 min / max as the TPU caller gets it: a pre-masked (hi,
    biased lo) pair through "imin64" / "imax64"."""
    ident = np.int32(_DG_IDENT_I32[is_min])
    hi = np.where(ok, (w >> 32).astype(np.int32), ident)
    lo_b = np.where(ok, ((w & 0xFFFFFFFF) - (1 << 31)).astype(np.int32),
                    ident)
    _, (ohi, olo) = jax_dgr(jnp.asarray(gid),
                            (jnp.asarray(hi), jnp.asarray(lo_b)),
                            ("imin64" if is_min else "imax64",), G)
    ohi, olo = np.asarray(ohi).astype(np.int64), np.asarray(olo)
    return (ohi << 32) | ((olo.astype(np.int64) & 0xFFFFFFFF) ^ (1 << 31))


_DG_IDENT_I32 = {True: (1 << 31) - 1, False: -(1 << 31)}


@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid",
                                                           "validity"])
@pytest.mark.parametrize("kind", ["sum64", "min64", "max64", "first_row"])
def test_native_kinds_plain_vs_tpu_kinds_and_numpy(kind, with_valid):
    rng = np.random.default_rng(len(kind) + with_valid)
    gid, w, valid = _native_case(rng)
    if not with_valid:
        valid = np.ones(N, np.bool_)
    active = (gid >= 0) & (gid < G)
    ok = active & valid
    xs = () if kind == "first_row" else (torch.from_numpy(w),)
    rows, (out,) = ck.dense_group_reduce(
        torch.from_numpy(gid), xs, (kind,), G,
        valid=(torch.from_numpy(valid),) if with_valid else None)
    out = out.numpy()
    np.testing.assert_array_equal(
        rows.numpy(), np.bincount(gid[active], minlength=G))
    # numpy, slot by slot
    want = np.empty(G, out.dtype)
    for s in range(G):
        m = ok & (gid == s)
        if kind == "sum64":
            want[s] = w[m].view(np.uint64).sum(dtype=np.uint64).view(np.int64)
        elif kind == "min64":
            want[s] = w[m].min() if m.any() else _I64.max
        elif kind == "max64":
            want[s] = w[m].max() if m.any() else _I64.min
        else:
            want[s] = np.flatnonzero(m)[0] if m.any() else (1 << 31) - 1
    np.testing.assert_array_equal(out, want)
    assert out.dtype == (np.int32 if kind == "first_row" else np.int64)
    # the TPU kinds it replaces, through the JAX kernel
    if kind == "sum64":
        tpu = _tpu_sum64(gid, w, ok)
        assert (np.abs(want[5].astype(np.float64)) > 0)    # slot 5 wrapped
    elif kind == "first_row":
        iota = np.where(ok, np.arange(N, dtype=np.int32), (1 << 31) - 1)
        _, (tpu,) = jax_dgr(jnp.asarray(gid), (jnp.asarray(iota),),
                            ("imin",), G)
        tpu = np.asarray(tpu)
    else:
        tpu = _tpu_extreme64(gid, w, ok, kind == "min64")
    np.testing.assert_array_equal(out, tpu)


def test_native_kinds_share_streams_in_one_call():
    """The slice's new call: first_row, sum and min of one f32 column,
    sum64 and min64 of one int64 column, a count for the column with
    nulls; the validity of a column applies to its kinds alone."""
    rng = np.random.default_rng(23)
    gid, w, w_valid = _native_case(rng)
    v = rng.standard_normal(N).astype(np.float32)
    v[gid == 7] = np.nan
    tg, tv, tw = (torch.from_numpy(x) for x in (gid, v, w))
    twv = torch.from_numpy(w_valid)
    kinds = ("first_row", "sum", "min", "sum64", "min64", "count")
    rows, outs = ck.dense_group_reduce(
        tg, (tv, tv, tw, tw, twv.to(torch.int32)), kinds, G,
        valid=(None, None, None, twv, twv, None))
    singles = []
    for kind, xs, vd in (("first_row", (), None), ("sum", (tv,), None),
                         ("min", (tv,), None), ("sum64", (tw,), twv),
                         ("min64", (tw,), twv),
                         ("count", (twv.to(torch.int32),), None)):
        r, (o,) = ck.dense_group_reduce(tg, xs, (kind,), G, valid=(vd,))
        assert torch.equal(r, rows)
        singles.append(o)
    for kind, a, b in zip(kinds, outs, singles):
        assert a.dtype == b.dtype
        # same order of the same adds on the CPU: equal, NaN slot included
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num()), kind
    assert outs[2][7].isnan()
    # a masked-out count equals the valid rows of the slot
    active = (gid >= 0) & (gid < G)
    np.testing.assert_array_equal(
        outs[5].numpy(), np.bincount(gid[active & w_valid], minlength=G))


def test_native_kinds_launch_groups_and_bad_arguments():
    # the slice's call at G = 4096 fits one launch: 4 + 4 * 3 + 8 * 2 bytes
    kinds = ("first_row", "sum", "min", "sum64", "min64")
    assert ck._dg_launch_groups(kinds, 4096) == [[0, 1, 2, 3, 4]]
    assert 4 * 4096 + sum(ck._dg_acc_bytes(k, 4096) for k in kinds) \
        <= ck._DG_SMEM_BUDGET
    gid = torch.zeros(8, dtype=torch.int32)
    w = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        ck.dense_group_reduce(gid, (w.int(),), ("sum64",), 128)
    with pytest.raises(ValueError, match="inputs"):
        ck.dense_group_reduce(gid, (w,), ("first_row",), 128)
    with pytest.raises(ValueError, match="validity"):
        ck.dense_group_reduce(gid, (w,), ("min64",), 128,
                              valid=(torch.zeros(8, dtype=torch.uint8),))
    with pytest.raises(ValueError, match="per kind"):
        ck.dense_group_reduce(gid, (w,), ("min64",), 128, valid=())


@pytest.mark.parametrize("length", [N, 2000, "tensor"])
@pytest.mark.parametrize("with_nulls", [False, True], ids=["valid", "nulls"])
def test_dense_key_equals_the_gid_it_stands_for(with_nulls, length):
    """A ``DenseKey`` (the slot formed from the key column) gives what the
    gid built as the JAX ``consume_dense`` builds it gives: key - lo, null
    keys in slot G - 1, rows past the length nowhere."""
    rng = np.random.default_rng(31)
    gid, w, valid = _native_case(rng)
    lo = -(1 << 45)
    keys = gid.astype(np.int64) + lo        # also below lo and past lo + G
    k_ok = rng.random(N) >= 0.1 if with_nulls else None
    n_rows = 1500 if length == "tensor" else length
    want_gid = np.where(np.arange(N) < n_rows, gid, -1)
    if with_nulls:
        want_gid = np.where(k_ok | (np.arange(N) >= n_rows), want_gid, G - 1)
    key = ck.DenseKey(torch.from_numpy(keys), lo,
                      torch.tensor(n_rows, dtype=torch.int32)
                      if length == "tensor" else n_rows,
                      None if k_ok is None else torch.from_numpy(k_ok))
    np.testing.assert_array_equal(ck.dense_key_gid(key, G).numpy(), want_gid)
    kinds = ("first_row", "sum64", "min64")
    xs = (torch.from_numpy(w),) * 2
    vd = (None, torch.from_numpy(valid), None)
    rows, outs = ck.dense_group_reduce(key, xs, kinds, G, vd)
    wrows, wouts = ck.dense_group_reduce(
        torch.from_numpy(want_gid.astype(np.int32)), xs, kinds, G, vd)
    assert torch.equal(rows, wrows)
    for a, b in zip(outs, wouts):
        assert torch.equal(a, b)
    if with_nulls:
        assert int(rows[G - 1]) >= int((~k_ok[:n_rows]).sum()) > 0


def test_dense_key_bad_arguments():
    k = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        ck.dense_group_reduce(ck.DenseKey(k.int(), 0, 8, None), (), (), 128)
    with pytest.raises(ValueError, match="validity"):
        ck.dense_group_reduce(
            ck.DenseKey(k, 0, 8, torch.zeros(7, dtype=torch.bool)), (), (),
            128)
    with pytest.raises(ValueError, match="lo"):
        ck.dense_group_reduce(ck.DenseKey(k, 1 << 63, 8, None), (), (), 128)
    rows, _ = ck.dense_group_reduce(ck.DenseKey(k, 0, 5, None), (), (), 128)
    assert int(rows[0]) == 5 and int(rows.sum()) == 5
