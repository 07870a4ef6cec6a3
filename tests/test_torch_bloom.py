"""Port parity: ``arrow_tpu_torch.ops.bloom`` against the JAX package's
``ops/bloom``: hashes, bitset and query mask equal exactly; no false
negatives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.ops import bloom as jbloom
from arrow_tpu_torch.ops import bloom as tbloom


def _lanes(rng, n, L, small):
    hi = 50 if small else 1 << 32
    return rng.integers(0, hi, (n, L), dtype=np.int64)


@pytest.mark.parametrize("L", [1, 2, 3, 5])
@pytest.mark.parametrize("small", [True, False], ids=["small", "wide"])
def test_lane_hashes_vs_jax(L, small):
    rng = np.random.default_rng(L)
    lanes = _lanes(rng, 1000, L, small)
    w1, w2 = jbloom._lane_hashes(jnp.asarray(lanes.astype(np.uint32)))
    g1, g2 = tbloom._lane_hashes(torch.from_numpy(lanes))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2).astype(np.int64))


@pytest.mark.parametrize("max_keys", [1, 100, 1024, 5000, 1 << 20, 1 << 24])
def test_bloom_m_log2_vs_jax(max_keys):
    assert tbloom.bloom_m_log2(max_keys) == jbloom.bloom_m_log2(max_keys)
    assert tbloom.BLOOM_K == jbloom.BLOOM_K


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_build_and_query_vs_jax(L, k):
    rng = np.random.default_rng(10 * L + k)
    build = _lanes(rng, 800, L, True)
    active = rng.random(800) < 0.8
    probe = np.concatenate([build[:300], _lanes(rng, 700, L, False)])
    pact = rng.random(1000) < 0.9
    m_log2 = tbloom.bloom_m_log2(800)
    want = jbloom.build_bloom(jnp.asarray(build.astype(np.uint32)),
                              jnp.asarray(active), m_log2, k)
    got = tbloom.build_bloom(torch.from_numpy(build),
                             torch.from_numpy(active), m_log2, k)
    assert got.dtype == torch.bool and got.shape == (1 << m_log2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wq = jbloom.query_bloom(want, jnp.asarray(probe.astype(np.uint32)),
                            jnp.asarray(pact), k)
    gq = tbloom.query_bloom(got, torch.from_numpy(probe),
                            torch.from_numpy(pact), k)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    # no false negatives: an inserted key that is probed actively hits
    inserted = {tuple(r) for r in build[active]}
    must = np.array([tuple(r) in inserted for r in probe]) & pact
    assert gq.numpy()[must].all()
    assert not gq.numpy()[~pact].any()


def test_bloom_with_no_active_rows_is_empty():
    lanes = torch.zeros((16, 2), dtype=torch.int64)
    bits = tbloom.build_bloom(lanes, torch.zeros(16, dtype=torch.bool), 13)
    assert not bits.any()
    assert not tbloom.query_bloom(bits, lanes,
                                  torch.ones(16, dtype=torch.bool)).any()
