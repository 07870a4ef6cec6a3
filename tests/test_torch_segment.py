"""Port parity for the segment reductions (``arrow_tpu_torch/ops/segment``)
against the JAX package's ``ops/segment`` on the same sort-grouped data.

The context (starts, ends, group ids, row ids) and every integer result,
every min and max (NaN, +-inf and the int64 extremes included) are equal.
Float sums are added in another order: f64 within 1e-12 * sum(|x|) + 1e-12
per run, f32 within 1e-5 * sum(|x|) + 1e-6. Runs that do not exist (slots
past the number of distinct keys) are unspecified in the JAX package and
hold the reduction's identity in the port; only runs in use are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.ops import distinct as jdist
from arrow_tpu.ops import segment as jseg
from arrow_tpu_torch.ops import distinct as tdist
from arrow_tpu_torch.ops import segment as tseg

CAP, R = 600, 64


def _contexts(seed, n_keys=20, active_p=0.8, need_codes=True):
    """The same grouped batch in both packages: (jctx, tctx, n runs)."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, n_keys, (CAP, 1)).astype(np.uint32)
    active = rng.random(CAP) < active_p
    jg, _ = jdist.sort_group(jnp.asarray(lanes), jnp.asarray(active),
                             rep_capacity=R, need_codes=need_codes)
    tg, _ = tdist.sort_group(torch.from_numpy(lanes.astype(np.int64)),
                             torch.from_numpy(active), rep_capacity=R,
                             need_codes=need_codes)
    rep_gids = np.where(np.arange(R) < int(jg.num_unique),
                        100 + np.arange(R), -1).astype(np.int32)
    jctx = jseg.make_segment_context(jg, jnp.asarray(rep_gids))
    tctx = tseg.make_segment_context(tg, torch.from_numpy(rep_gids))
    return jctx, tctx, int(jg.num_unique), rng


def _sorted(jctx, x):
    """x (per original row) in each package's sorted order. Row order
    inside a run may differ between the two sorts."""
    return x[np.asarray(jctx.perm)]


@pytest.mark.parametrize("need_codes", [True, False],
                         ids=["codes", "no_codes"])
@pytest.mark.parametrize("active_p", [0.8, 1.0, 0.0],
                         ids=["some", "all", "none"])
def test_make_segment_context_vs_jax(active_p, need_codes):
    jctx, tctx, n, _ = _contexts(1, active_p=active_p,
                                 need_codes=need_codes)
    assert int(tctx.num_segs) == n
    for name in ("starts", "ends", "gid_global", "head", "s_active"):
        np.testing.assert_array_equal(getattr(tctx, name).numpy(),
                                      np.asarray(getattr(jctx, name)), name)
    act = np.asarray(jctx.s_active)
    np.testing.assert_array_equal(tctx.seg.numpy()[act],
                                  np.asarray(jctx.seg)[act])
    if need_codes:
        np.testing.assert_array_equal(tctx.row_gids.numpy(),
                                      np.asarray(jctx.row_gids))
    else:
        assert tctx.row_gids is None and jctx.row_gids is None
    # the one-pass reductions' slot: the run of each active row, else R
    slot = tctx.slot.numpy()
    np.testing.assert_array_equal(slot[act], np.asarray(jctx.seg)[act])
    assert (slot[~act] == R).all()
    # the float sums' run boundaries: [start, next start), empty past n
    off = tctx.offsets.numpy()
    assert off.shape == (R + 1,) and (np.diff(off) >= 0).all()
    np.testing.assert_array_equal(off[:n], np.asarray(jctx.starts)[:n])
    np.testing.assert_array_equal(off[1:n + 1], np.asarray(jctx.ends)[:n])
    assert (off[n:] == act.sum()).all()
    # the same rows make up each run
    jp, tp = np.asarray(jctx.perm), tctx.perm.numpy()
    for s in range(n):
        a, b = int(tctx.starts[s]), int(tctx.ends[s])
        assert sorted(jp[a:b]) == sorted(tp[a:b])


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64,
                                   np.float32],
                         ids=["i64", "i32", "f64", "f32"])
def test_seg_sum_vs_jax(dtype):
    jctx, tctx, n, rng = _contexts(2)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, CAP, dtype=dtype)   # wraps
    else:
        x = (rng.standard_normal(CAP) * 1e3).astype(dtype)
    x = np.where(np.asarray(jctx.s_active)[np.argsort(np.asarray(jctx.perm))],
                 x, 0).astype(dtype)
    want = np.asarray(jseg.seg_sum(jctx, jnp.asarray(_sorted(jctx, x))))
    got = tseg.seg_sum(tctx, torch.from_numpy(x)[tctx.perm])
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (R,)
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got.numpy()[:n], want[:n])
        assert (got.numpy()[n:] == 0).all()
    else:
        rtol, atol = (1e-12, 1e-12) if dtype is np.float64 else (1e-5, 1e-6)
        xs = _sorted(jctx, x)
        for s in range(n):
            a, b = int(jctx.starts[s]), int(jctx.ends[s])
            bound = rtol * np.abs(xs[a:b]).sum() + atol
            assert abs(float(got[s]) - float(want[s])) <= bound, s


def _with_specials(rng, dtype):
    """Values with NaN, +-inf (floats) or the type's extremes (ints)."""
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(CAP).astype(dtype)
        x[rng.random(CAP) < 0.05] = np.nan
        x[rng.random(CAP) < 0.05] = np.inf
        x[rng.random(CAP) < 0.05] = -np.inf
        x[rng.random(CAP) < 0.05] = -0.0
        return x
    if dtype is np.bool_:
        return rng.random(CAP) < 0.5
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, CAP, dtype=dtype, endpoint=True)
    x[rng.random(CAP) < 0.05] = info.max
    x[rng.random(CAP) < 0.05] = info.min
    return x


@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.float32,
                                   np.int32, np.int16, np.int8, np.uint8,
                                   np.bool_],
                         ids=["i64", "f64", "f32", "i32", "i16", "i8", "u8",
                              "bool"])
def test_seg_reduce_min_max_vs_jax(dtype, is_min):
    jctx, tctx, n, rng = _contexts(3)
    x = _with_specials(rng, dtype)
    jfn = jseg.seg_reduce_min if is_min else jseg.seg_reduce_max
    tfn = tseg.seg_reduce_min if is_min else tseg.seg_reduce_max
    want = np.asarray(jfn(jctx, jnp.asarray(_sorted(jctx, x))))
    got = tfn(tctx, torch.from_numpy(x)[tctx.perm])
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (R,)
    np.testing.assert_array_equal(got.numpy()[:n], want[:n])
    if np.issubdtype(dtype, np.floating):
        assert np.isnan(want[:n]).any()         # NaN wins min and max
        np.testing.assert_array_equal(np.signbit(got.numpy()[:n]),
                                      np.signbit(want[:n]))


def test_seg_reductions_with_no_active_rows():
    """Every run is empty: integer sums are 0, the one-pass reductions
    hold their identity."""
    _, tctx, n, rng = _contexts(4, active_p=0.0)
    assert n == 0
    x = torch.from_numpy(rng.standard_normal(CAP))
    assert (tseg.seg_sum(tctx, x) == 0).all()
    assert (tseg.seg_sum(tctx, torch.ones(CAP, dtype=torch.int64)) == 0).all()
    assert (tseg.seg_reduce_min(tctx, x) == float("inf")).all()
    assert (tseg.seg_reduce_max(tctx, x.long()) ==
            torch.iinfo(torch.int64).min).all()


def test_running_scan_vs_jax():
    rng = np.random.default_rng(6)
    v = rng.integers(-50, 50, 257).astype(np.int32)
    for jop, top, fill in ((jnp.maximum, torch.maximum, -100),
                           (jnp.minimum, torch.minimum, 100),
                           (jnp.add, torch.add, 0),
                           (jnp.bitwise_or, torch.bitwise_or, 0)):
        want = np.asarray(jseg.running_scan(jnp.asarray(v), jop, fill))
        got = tseg.running_scan(torch.from_numpy(v), top, fill)
        np.testing.assert_array_equal(got.numpy(), want)
