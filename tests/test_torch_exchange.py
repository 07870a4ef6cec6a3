"""Port parity: the exchange (``parallel/shuffle.py``) against the JAX
package's functions run under ``shard_map`` on the 8-virtual-device CPU
mesh; the port runs 8 logical shards on the CPU.

Send buffers, counts, received buffers, lengths and error flags are
compared whole, slot for slot (the buffers are zero-filled, so the slots
past a bucket's count are part of the contract). Everything is moved, not
computed: every comparison is exact, floats included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from arrow_tpu.core import datatype as jdt
from arrow_tpu.core.schema import Field as JField, Schema as JSchema
from arrow_tpu.parallel import shuffle as jshuffle
from arrow_tpu.parallel.context import _local_batch
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.core.array import array_from_numpy
from arrow_tpu_torch.core.batch import Batch
from arrow_tpu_torch.core.schema import Field, Schema
from arrow_tpu_torch.parallel import DistContext, shuffle

N = 8               # shards
LOCAL_CAP = 64
CAP = N * LOCAL_CAP
_JSCHEMA = JSchema((JField("k", jdt.int64), JField("v", jdt.float64),
                    JField("u", jdt.uint32)))


def _columns(seed, glen, key_hi=1000):
    """k int64 (no validity), v float64 (with nulls), u uint32 (no
    validity), CAP rows of which ``glen`` are real."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-key_hi, key_hi, CAP),
            "v": rng.standard_normal(CAP),
            "vvalid": rng.random(CAP) < 0.8,
            "u": rng.integers(0, 1 << 32, CAP, dtype=np.uint32)}


def _port_shards(cols, glen):
    ctx = DistContext(devices=["cpu"] * N)
    arrays = {
        "k": array_from_numpy(cols["k"][:glen], capacity=CAP, device="cpu"),
        "v": array_from_numpy(cols["v"][:glen], validity=cols["vvalid"][:glen],
                              capacity=CAP, device="cpu"),
        "u": array_from_numpy(cols["u"][:glen], capacity=CAP, device="cpu")}
    # rows past the length hold what the JAX side holds there
    arrays["k"].values[glen:] = torch.from_numpy(cols["k"][glen:])
    arrays["v"].values[glen:] = torch.from_numpy(cols["v"][glen:])
    arrays["v"].validity[glen:] = torch.from_numpy(cols["vvalid"][glen:])
    arrays["u"].values.view(torch.int32)[glen:] = torch.from_numpy(
        cols["u"][glen:].view(np.int32))
    schema = Schema(tuple(Field(n, a.type) for n, a in arrays.items()))
    return ctx, ctx.shard_batch(Batch(schema, list(arrays.values()), glen))


def _jax_sharded(step, args, n_out):
    """``step`` on every shard's block of ``args`` under shard_map; the
    outputs come back as numpy with the shards along axis 0."""
    mesh = Mesh(np.asarray(jax.devices()), ("d",))
    fn = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=tuple(P("d") for _ in args),
        out_specs=tuple(P("d") for _ in range(n_out)), check_vma=False))
    return [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]


def _jax_local_batch(k, v, vvalid, u, glen):
    i = jax.lax.axis_index("d")
    local_len = jnp.clip(jnp.int32(glen) - i.astype(jnp.int32) * LOCAL_CAP,
                         0, LOCAL_CAP)
    return _local_batch(_JSCHEMA, [None] * 3, [k, None, v, vvalid, u, None],
                        local_len)


def _per_shard(x):
    return x.reshape((N, -1) + x.shape[1:])


@pytest.mark.parametrize("B,glen,explicit_dest", [
    (LOCAL_CAP, CAP, False), (2 * LOCAL_CAP, 470, False), (5, 470, False),
    (LOCAL_CAP, 300, True)],
    ids=["full", "partly_filled", "bucket_too_small", "explicit_dest"])
def test_partition_for_exchange_vs_jax(B, glen, explicit_dest):
    cols = _columns(B + glen, glen)
    rng = np.random.default_rng(1)
    dest = rng.integers(0, N, CAP).astype(np.int32)

    def jstep(k, v, vvalid, u, d):
        lb = _jax_local_batch(k, v, vvalid, u, glen)
        send, counts, err = jshuffle.partition_for_exchange(
            lb, ["k"], N, B, dest=d if explicit_dest else None)
        return tuple(s for s in send if s is not None) + \
            (counts, err.reshape((1,)))

    want = _jax_sharded(jstep, [cols["k"], cols["v"], cols["vvalid"],
                                cols["u"], dest], 6)
    _, sharded = _port_shards(cols, glen)
    errs = []
    for s, local in enumerate(sharded.shards):
        send, counts, err = shuffle.partition_for_exchange(
            local, ["k"], N, B,
            dest=torch.from_numpy(dest[s * LOCAL_CAP:(s + 1) * LOCAL_CAP])
            if explicit_dest else None)
        assert send[1] is None and send[5] is None
        for got, w in zip([send[0], send[2], send[3], send[4]], want[:4]):
            assert got.shape == (N, B)
            np.testing.assert_array_equal(got.numpy(), _per_shard(w)[s])
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), _per_shard(want[4])[s])
        assert int(err) == int(want[5][s])
        errs.append(int(err))
    assert any(errs) == (B == 5)


@pytest.mark.parametrize("B,glen", [(2 * LOCAL_CAP, CAP), (LOCAL_CAP, 470),
                                    (6, 470)],
                         ids=["full", "partly_filled", "bucket_too_small"])
def test_shuffle_batch_vs_jax(B, glen):
    """The whole raw-row shuffle: received batch (values, validity, zeros
    past the rows), its length and the error flag per shard; and every row
    lands on shard hash32(k) % 8."""
    cols = _columns(7 * B + glen, glen)

    def jstep(k, v, vvalid, u):
        lb = _jax_local_batch(k, v, vvalid, u, glen)
        out, err = jshuffle.shuffle_batch(lb, ["k"], "d", N,
                                          bucket_capacity=B)
        assert out.column("k").validity is None
        return (out.column("k").values, out.column("v").values,
                out.column("v").validity, out.column("u").values,
                jnp.asarray(out.length, jnp.int32).reshape((1,)),
                err.reshape((1,)))

    want = _jax_sharded(jstep, [cols["k"], cols["v"], cols["vvalid"],
                                cols["u"]], 6)
    ctx, sharded = _port_shards(cols, glen)
    out = shuffle.shuffle_batch(sharded.shards, ["k"], ctx.devices,
                                bucket_capacity=B)
    from arrow_tpu_torch.ops.hashing import hash32
    total = 0
    for s, (rb, err) in enumerate(out):
        assert rb.capacity == N * B
        assert rb.column("k").validity is None
        for got, w in zip([rb.column("k").values, rb.column("v").values,
                           rb.column("v").validity, rb.column("u").values],
                          want[:4]):
            np.testing.assert_array_equal(got.numpy(), _per_shard(w)[s])
        assert int(rb.length) == int(want[4][s])
        assert int(err) == int(want[5][s])
        n = min(int(rb.length), rb.capacity)
        total += n
        if B != 6:
            place = hash32([rb.column("k")], seed=shuffle.EXCHANGE_SEED) % N
            assert bool((place[:n] == s).all())
    if B != 6:
        assert total == glen
        assert not any(int(err) for _, err in out)
    else:
        assert any(int(err) for _, err in out)


@pytest.mark.parametrize("B", [LOCAL_CAP, 3],
                         ids=["fits", "bucket_too_small"])
def test_shuffle_rows_vs_jax(B):
    """Arbitrary leaves by explicit destination: a 2-D leaf, a bool leaf, a
    None leaf passing through, and dest values >= P dropping their rows."""
    rng = np.random.default_rng(B)
    a = rng.integers(-100, 100, CAP)
    m = rng.standard_normal((CAP, 3)).astype(np.float32)
    f = rng.random(CAP) < 0.5
    dest = rng.integers(0, N + 3, CAP).astype(np.int32)

    def jstep(a_, m_, f_, d_):
        out, total, err = jshuffle.shuffle_rows([a_, None, m_, f_], d_, N,
                                                B, "d")
        assert out[1] is None
        return (out[0], out[2], out[3], total.reshape((1,)),
                err.reshape((1,)))

    want = _jax_sharded(jstep, [a, m, f, dest], 5)

    def block(x, s):
        return torch.from_numpy(x[s * LOCAL_CAP:(s + 1) * LOCAL_CAP])

    leaves = [[block(a, s), None, block(m, s), block(f, s)]
              for s in range(N)]
    out = shuffle.shuffle_rows(leaves, [block(dest, s) for s in range(N)],
                               B, [torch.device("cpu")] * N)
    for s, (recv, total, err) in enumerate(out):
        assert recv[1] is None
        for got, w in zip([recv[0], recv[2], recv[3]], want[:3]):
            assert got.shape[0] == N * B
            np.testing.assert_array_equal(got.numpy(), _per_shard(w)[s])
        assert total.dtype == torch.int32 and int(total) == int(want[3][s])
        assert int(err) == int(want[4][s])
    assert any(int(e) for _, _, e in out) == (B == 3)


def _port_local(cols, s, n):
    """Shard s's block of ``cols`` as a local batch of LOCAL_CAP rows, the
    first ``n`` of them real; the rows past them hold what the JAX side
    holds there."""
    blk = {k: v[s * LOCAL_CAP:(s + 1) * LOCAL_CAP] for k, v in cols.items()}
    arrays = {
        "k": array_from_numpy(blk["k"][:n], capacity=LOCAL_CAP, device="cpu"),
        "v": array_from_numpy(blk["v"][:n], validity=blk["vvalid"][:n],
                              capacity=LOCAL_CAP, device="cpu"),
        "u": array_from_numpy(blk["u"][:n], capacity=LOCAL_CAP,
                              device="cpu")}
    arrays["k"].values[n:] = torch.from_numpy(blk["k"][n:])
    arrays["v"].values[n:] = torch.from_numpy(blk["v"][n:])
    arrays["v"].validity[n:] = torch.from_numpy(blk["vvalid"][n:])
    arrays["u"].values.view(torch.int32)[n:] = torch.from_numpy(
        blk["u"][n:].view(np.int32))
    schema = Schema(tuple(Field(k, a.type) for k, a in arrays.items()))
    return Batch(schema, list(arrays.values()), n)


_UNEQUAL = np.array([64, 10, 0, 64, 33, 1, 57, 5], np.int32)


@pytest.mark.parametrize("B", [LOCAL_CAP, 4], ids=["fits", "bucket_too_small"])
def test_batched_send_of_unequal_shards_vs_jax(B):
    """The send side as ``shuffle_batch`` runs it over shards of unequal
    lengths (one of them empty): every shard's destinations, ONE
    histogram and ONE positions call over all of them, then each shard's
    scatter. Send buffers slot for slot, counts and error flags equal the
    JAX package's ``partition_for_exchange`` on each shard."""
    cols = _columns(11 + B, CAP)

    def jstep(k, v, vvalid, u, lens):
        lb = _local_batch(_JSCHEMA, [None] * 3, [k, None, v, vvalid, u, None],
                          lens[0])
        send, counts, err = jshuffle.partition_for_exchange(lb, ["k"], N, B)
        return tuple(x for x in send if x is not None) + \
            (counts, err.reshape((1,)))

    want = _jax_sharded(jstep, [cols["k"], cols["v"], cols["vvalid"],
                                cols["u"], _UNEQUAL], 6)
    locals_ = [_port_local(cols, s, int(n)) for s, n in enumerate(_UNEQUAL)]
    dests = [shuffle._batch_dest(b, ["k"], N, shuffle.EXCHANGE_SEED, None)
             for b in locals_]
    counts, positions = shuffle._bucket_positions(dests, N, B)
    assert counts.shape == (N, N)
    for s, local in enumerate(locals_):
        send, c, err = shuffle.partition_for_exchange(
            local, ["k"], N, B, counts=counts[s], positions=positions[s])
        assert send[1] is None and send[5] is None
        for got, w in zip([send[0], send[2], send[3], send[4]], want[:4]):
            np.testing.assert_array_equal(got.numpy(), _per_shard(w)[s])
        np.testing.assert_array_equal(c.numpy(), _per_shard(want[4])[s])
        assert int(err) == int(want[5][s])
        # the shard alone (its own pair of kernel calls) gives the same
        alone = shuffle.partition_for_exchange(local, ["k"], N, B)
        for a, b in zip(alone[0], send):
            assert (a is None and b is None) or torch.equal(a, b)
        assert torch.equal(alone[1], c) and int(alone[2]) == int(err)
    assert any(int(e) for e in want[5]) == (B == 4)


@pytest.mark.parametrize("B", [2 * LOCAL_CAP, 5], ids=["fits",
                                                    "bucket_too_small"])
def test_shuffle_batch_of_unequal_shards_vs_jax(B):
    """The whole raw-row shuffle of shards of unequal lengths: received
    batches, lengths and error flags equal the JAX package's."""
    cols = _columns(23 + B, CAP)

    def jstep(k, v, vvalid, u, lens):
        lb = _local_batch(_JSCHEMA, [None] * 3, [k, None, v, vvalid, u, None],
                          lens[0])
        out, err = jshuffle.shuffle_batch(lb, ["k"], "d", N,
                                          bucket_capacity=B)
        return (out.column("k").values, out.column("v").values,
                out.column("v").validity, out.column("u").values,
                jnp.asarray(out.length, jnp.int32).reshape((1,)),
                err.reshape((1,)))

    want = _jax_sharded(jstep, [cols["k"], cols["v"], cols["vvalid"],
                                cols["u"], _UNEQUAL], 6)
    locals_ = [_port_local(cols, s, int(n)) for s, n in enumerate(_UNEQUAL)]
    out = shuffle.shuffle_batch(locals_, ["k"], [torch.device("cpu")] * N,
                                bucket_capacity=B)
    for s, (rb, err) in enumerate(out):
        for got, w in zip([rb.column("k").values, rb.column("v").values,
                           rb.column("v").validity, rb.column("u").values],
                          want[:4]):
            np.testing.assert_array_equal(got.numpy(), _per_shard(w)[s])
        assert int(rb.length) == int(want[4][s])
        assert int(err) == int(want[5][s])
    assert any(int(e) for _, e in out) == (B == 5)


def test_exchange_is_the_transpose_of_the_buckets():
    """recv[p][s] = send[s][p] for buffers and counts; None passes."""
    devs = [torch.device("cpu")] * 3
    send = [[torch.full((3, 2), 10 * s) + torch.arange(3)[:, None], None]
            for s in range(3)]
    counts = [torch.tensor([s, s + 1, s + 2], dtype=torch.int32)
              for s in range(3)]
    recv, rc = shuffle.exchange(send, counts, devs)
    for p in range(3):
        assert recv[p][1] is None
        assert recv[p][0].tolist() == [[10 * s + p] * 2 for s in range(3)]
        assert rc[p].tolist() == [s + p for s in range(3)]


def test_shuffle_of_string_columns_is_refused():
    from arrow_tpu_torch.core import datatype as tdt
    from arrow_tpu_torch.core.array import Array
    b = Batch(Schema((Field("s", tdt.string),)),
              [Array(tdt.string, torch.zeros((4,), dtype=torch.uint8))], 4)
    with pytest.raises(NotImplementedError):
        shuffle.partition_for_exchange(b, ["s"], 2, 4)
    ctx = DistContext(devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError):
        ctx.shard_batch(b)


def test_shard_batch_blocks_and_local_lengths():
    """Capacity padded to a multiple of n, contiguous blocks, local lengths
    from the global one, device or host."""
    cols = {"k": np.arange(21, dtype=np.int64)}
    b = batch_from_numpy(cols, device="cpu", capacity=30)
    ctx = DistContext(devices=["cpu"] * 4)
    sb = ctx.shard_batch(b)
    assert sb.local_capacity == 8 and sb.capacity == 32 and len(sb) == 21
    assert [s.length for s in sb.shards] == [8, 8, 5, 0]
    got = torch.cat([s.column("k").values for s in sb.shards])
    assert got[:21].tolist() == list(range(21)) and not got[21:].any()
    assert ctx._is_sharded(sb) and not ctx._is_sharded(b)
    assert not DistContext(devices=["cpu"] * 4)._is_sharded(sb)
    sb2 = ctx.shard_batch(b.with_length(torch.tensor(21)))
    assert [int(s.length) for s in sb2.shards] == [8, 8, 5, 0]
    assert all(isinstance(s.length, torch.Tensor) for s in sb2.shards)
