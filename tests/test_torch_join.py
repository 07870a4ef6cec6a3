"""Port parity: ``arrow_tpu_torch.ops.join`` against the JAX package's
``ops/join`` (the same ``HashJoin`` driven directly: build, probe with the
same ``impl``, finish) and, for the join types, against pyarrow's hash join.
Join output order is unspecified: rows are compared as multisets, integers
and nulls exactly, floats by their bits (they are only moved)."""

import jax
import numpy as np
import pyarrow as pa
import pyarrow.acero as pac
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.acero.options import HashJoinNodeOptions as JOptions
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.ops.join import HashJoin as JHashJoin
from arrow_tpu_torch.acero.options import HashJoinNodeOptions as TOptions
from arrow_tpu_torch.compute.expressions import field as tfield
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import join_routed
from arrow_tpu_torch.ops.join import HashJoin as THashJoin, \
    build_state_from_numpy

JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti"]
ROUTES = ["sort", "packed"]


def _rows(batches):
    """Sorted list of row tuples of some pyarrow batches: floats as their
    bits, nulls as None (sorted first)."""
    rows = []
    for rb in batches:
        if rb is None:
            continue
        cols = []
        for c in rb.columns:
            valid = np.asarray(c.is_valid())
            if pa.types.is_floating(c.type):
                np_t = np.float32 if c.type.bit_width == 32 else np.float64
                v = c.fill_null(0).to_numpy(zero_copy_only=False) \
                    .astype(np_t).view(
                        np.uint32 if np_t == np.float32 else np.uint64)
            else:
                v = c.fill_null(0).to_numpy(zero_copy_only=False)
            cols.append([(1, int(x)) if ok else (0, 0)
                         for x, ok in zip(v, valid)])
        rows.extend(zip(*cols) if cols else [()] * rb.num_rows)
    return sorted(rows)


def _pa(b):
    return None if b is None else b.to_pyarrow()


def _run(Join, Options, to_batch, lefts, right, impl, *,
         build_capacity=None, probe_capacity=None, **kw):
    """(rows, error flag, schema names, build state) of one join through
    either package: ``lefts`` are the probe batches, streamed in turn. With
    the error flag set there are no rows to read."""
    rb_ = to_batch(right, build_capacity)
    lbs = [to_batch(l, probe_capacity) for l in lefts]
    opts = Options(**kw)
    hj = Join(lbs[0].schema, rb_.schema, opts)
    bs = hj.build(rb_)
    outs = []
    for lb in lbs:
        out, bs = hj.probe(bs, lb, impl=impl)
        outs.append(out)
    outs.append(hj.finish(bs))
    outs = [] if int(bs.error) else [_pa(o) for o in outs]
    return _rows(outs), int(bs.error), list(hj.out_schema.names), bs


def _jax(lefts, right, impl, **kw):
    return _run(JHashJoin, JOptions,
                lambda rb, cap: at.Batch.from_pyarrow(rb, capacity=cap),
                lefts, right, impl, **kw)


def _port(lefts, right, impl, **kw):
    return _run(THashJoin, TOptions,
                lambda rb, cap: batch_from_pyarrow(rb, capacity=cap,
                                                   device="cpu"),
                lefts, right, impl, **kw)


def _oracle(left, right, join_type, lkeys, rkeys, **kw):
    decl = pac.Declaration("hashjoin", pac.HashJoinNodeOptions(
        join_type, lkeys, rkeys, **kw), [
        pac.Declaration("table_source", pac.TableSourceNodeOptions(
            pa.Table.from_batches([left]))),
        pac.Declaration("table_source", pac.TableSourceNodeOptions(
            pa.Table.from_batches([right]))),
    ])
    return decl.to_table()


def _keys(rng, n, kmax, null_prob):
    return pa.array(rng.integers(0, kmax, n),
                    mask=rng.random(n) < null_prob if null_prob else None)


def _tables(rng, nl=500, nr=200, kmax=50, null_prob=0.1, unique=False):
    rk = pa.array(rng.permutation(4 * nr)[:nr].astype(np.int64)) if unique \
        else _keys(rng, nr, kmax, null_prob)
    left = pa.record_batch({
        "k": _keys(rng, nl, 4 * nr if unique else kmax, null_prob),
        "lv": pa.array(rng.standard_normal(nl).astype(np.float32)),
        "li": pa.array(np.arange(nl, dtype=np.int32)),
    })
    right = pa.record_batch({
        "k": rk,
        "rv": pa.array(rng.standard_normal(nr),
                       mask=rng.random(nr) < 0.1),
        "ri": pa.array(np.arange(nr) * 10),
    })
    return left, right


_SUFFIX = dict(output_suffix_for_left="_l", output_suffix_for_right="_r")


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("impl", ROUTES)
def test_join_types_vs_jax_and_pyarrow(join_type, impl):
    """Duplicate and null keys on both sides, all eight types, the generic
    and the packed route."""
    rng = np.random.default_rng(JOIN_TYPES.index(join_type))
    left, right = _tables(rng)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              max_build_rows=256, fanout_capacity=1 << 13, **_SUFFIX)
    want, werr, wnames, _ = _jax([left], right, impl, **kw)
    got, gerr, gnames, bs = _port([left], right, impl, **kw)
    assert int(bs.pack_bits) <= 30
    assert gerr == werr == 0 and gnames == wnames
    assert got == want
    exp = _oracle(left, right, join_type, ["k"], ["k"], **_SUFFIX)
    assert gnames == exp.schema.names
    assert got == _rows(exp.to_batches())


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_unique_build_compaction_vs_jax_and_pyarrow(join_type):
    """impl "packed_u" on unique build keys (types without the compaction
    probe take the packed route under that name, as in the JAX package)."""
    rng = np.random.default_rng(40 + JOIN_TYPES.index(join_type))
    left, right = _tables(rng, unique=True)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              max_build_rows=256, fanout_capacity=1 << 12, **_SUFFIX)
    want, werr, _, _ = _jax([left], right, "packed_u", **kw)
    got, gerr, gnames, bs = _port([left], right, "packed_u", **kw)
    assert int(bs.num_groups) == int(bs.num_active) == 200
    assert gerr == werr == 0 and got == want
    exp = _oracle(left, right, join_type, ["k"], ["k"], **_SUFFIX)
    assert got == _rows(exp.to_batches())


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_join_routed_picks_the_jax_route(join_type):
    """``join_routed`` picks "packed_u" / "packed" / "sort" by the rule of
    the JAX package's ``HashJoinNode._build_recover``."""
    rng = np.random.default_rng(3)
    for unique, wide, want_impl in ((True, False, "packed_u"),
                                    (False, False, "packed"),
                                    (False, True, "sort")):
        left, right = _tables(rng, unique=unique)
        if wide:    # a key column whose range no 30-bit window holds
            mul = np.int64(0x2545F4914F6CDD1D)
            left = left.set_column(0, "k", pa.array(
                left.column(0).fill_null(0).to_numpy() * mul))
            right = right.set_column(0, "k", pa.array(
                right.column(0).fill_null(0).to_numpy() * mul))
        tl = batch_from_pyarrow(left, device="cpu")
        tr = batch_from_pyarrow(right, device="cpu")
        hj = THashJoin(tl.schema, tr.schema, TOptions(
            join_type, ["k"], ["k"], max_build_rows=256,
            fanout_capacity=1 << 13, **_SUFFIX))
        bs, impl = join_routed(hj, tr)
        if want_impl == "packed_u" and not hj.supports_unique_fast():
            want_impl = "packed"
        assert impl == want_impl
        out, bs = hj.probe(bs, tl, impl=impl)
        got = _rows([_pa(out), _pa(hj.finish(bs))])
        exp = _oracle(left, right, join_type, ["k"], ["k"], **_SUFFIX)
        assert got == _rows(exp.to_batches())


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "right anti", "left semi"])
@pytest.mark.parametrize("impl", ["sort", "packed"])
def test_multi_key_streamed_probe_vs_jax(join_type, impl):
    """Two keys of different types with nulls; the probe side arrives in
    three batches of different capacities against one build state."""
    rng = np.random.default_rng(8)
    n = 300

    def side(n, tag):
        return pa.record_batch({
            "a": _keys(rng, n, 6, 0.1),
            "b": pa.array(rng.integers(-3, 3, n).astype(np.int16),
                          mask=rng.random(n) < 0.1),
            tag: pa.array(np.arange(n, dtype=np.int64)),
        })
    right = side(150, "rv")
    lefts = [side(n, "lv"), side(40, "lv"), side(170, "lv")]
    kw = dict(join_type=join_type, left_keys=["a", "b"],
              right_keys=["a", "b"], max_build_rows=256,
              fanout_capacity=1 << 13, **_SUFFIX)
    want, werr, wnames, _ = _jax(lefts, right, impl, probe_capacity=512,
                                 **kw)
    got, gerr, gnames, _ = _port(lefts, right, impl, probe_capacity=512,
                                 **kw)
    assert gerr == werr == 0 and gnames == wnames and got == want
    whole = pa.Table.from_batches(lefts).combine_chunks().to_batches()[0]
    exp = _oracle(whole, right, join_type, ["a", "b"], ["a", "b"], **_SUFFIX)
    assert got == _rows(exp.to_batches())


@pytest.mark.parametrize("lout,rout", [(["lv"], ["rv", "k"]), ([], ["ri"]),
                                       (["k", "li"], []), (None, None)],
                         ids=["lv|rv,k", "|ri", "k,li|", "all"])
@pytest.mark.parametrize("join_type", ["inner", "full outer"])
def test_output_projection_and_suffixes_vs_jax(join_type, lout, rout):
    rng = np.random.default_rng(12)
    left, right = _tables(rng)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              left_output=lout, right_output=rout, max_build_rows=256,
              fanout_capacity=1 << 13, output_suffix_for_right="_right")
    want, _, wnames, _ = _jax([left], right, "packed", **kw)
    got, _, gnames, _ = _port([left], right, "packed", **kw)
    assert gnames == wnames and got == want


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("impl", ["sort", "packed"])
def test_residual_filter_vs_jax(join_type, impl):
    """A residual filter of comparisons only, evaluated per matched pair:
    a pair that fails (or comes out null) is no match."""
    rng = np.random.default_rng(20 + JOIN_TYPES.index(join_type))
    left, right = _tables(rng, nl=300, nr=120, kmax=25)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              max_build_rows=128, fanout_capacity=1 << 13, **_SUFFIX)
    want, werr, _, _ = _jax([left], right, impl,
                            filter=jfield("li") < jfield("ri"), **kw)
    got, gerr, _, _ = _port([left], right, impl,
                            filter=tfield("li") < tfield("ri"), **kw)
    assert gerr == werr == 0 and got == want
    want, _, _, _ = _jax([left], right, impl,
                         filter=jfield("lv") > jfield("rv"), **kw)
    got, _, _, _ = _port([left], right, impl,
                         filter=tfield("lv") > tfield("rv"), **kw)
    assert got == want


def test_residual_filter_name_checks():
    rng = np.random.default_rng(1)
    left, right = _tables(rng)
    tl = batch_from_pyarrow(left, device="cpu")
    tr = batch_from_pyarrow(right, device="cpu")
    with pytest.raises(ValueError, match="both sides"):
        THashJoin(tl.schema, tr.schema, TOptions(
            "inner", ["k"], ["k"], filter=tfield("k") > 0))
    with pytest.raises(KeyError, match="unknown"):
        THashJoin(tl.schema, tr.schema, TOptions(
            "inner", ["k"], ["k"], filter=tfield("nope") > 0))


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_empty_build_vs_jax(join_type):
    rng = np.random.default_rng(2)
    left, right = _tables(rng, nl=100)
    right = right.slice(0, 0)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              max_build_rows=64, fanout_capacity=1 << 10, **_SUFFIX)
    for impl in ("sort", "packed"):
        want, werr, _, _ = _jax([left], right, impl, build_capacity=64, **kw)
        got, gerr, _, _ = _port([left], right, impl, build_capacity=64, **kw)
        assert gerr == werr == 0 and got == want
        n_out = {"inner": 0, "left outer": 100, "full outer": 100,
                 "left anti": 100}.get(join_type, 0)
        assert len(got) == n_out


@pytest.mark.parametrize("impl", ["sort", "packed"])
def test_fanout_capacity_error_flag(impl):
    """More pairs than ``fanout_capacity``: the deferred error flag is set
    in both packages; at a capacity that holds them it is not."""
    rng = np.random.default_rng(4)
    left, right = _tables(rng, kmax=5, null_prob=0.0)
    kw = dict(join_type="inner", left_keys=["k"], right_keys=["k"],
              max_build_rows=256, **_SUFFIX)
    _, werr, _, _ = _jax([left], right, impl, fanout_capacity=1000, **kw)
    _, gerr, _, _ = _port([left], right, impl, fanout_capacity=1000, **kw)
    assert werr != 0 and gerr != 0
    _, gerr, _, _ = _port([left], right, impl, fanout_capacity=1 << 15, **kw)
    assert gerr == 0


def test_build_capacity_error_flag_and_join_routed_raises():
    """More distinct build keys than ``max_build_rows``."""
    rng = np.random.default_rng(6)
    left, right = _tables(rng, unique=True)
    kw = dict(join_type="inner", left_keys=["k"], right_keys=["k"],
              max_build_rows=128, **_SUFFIX)
    _, werr, _, _ = _jax([left], right, "sort", **kw)
    _, gerr, _, _ = _port([left], right, "sort", **kw)
    assert werr != 0 and gerr != 0
    tr = batch_from_pyarrow(right, device="cpu")
    tl = batch_from_pyarrow(left, device="cpu")
    hj = THashJoin(tl.schema, tr.schema, TOptions(**kw))
    with pytest.raises(RuntimeError, match="max_build_rows"):
        join_routed(hj, tr)


@pytest.mark.parametrize("span_bits", [28, 29, 30, 31, 33])
def test_keys_straddling_the_30_bit_pack_limit(span_bits):
    """An int64 key whose range needs ``span_bits`` bits (plus none for the
    constant validity and high lanes): ``pack_bits`` equals the JAX
    package's, ``join_routed`` switches route past 30, and every route
    that is valid gives the same rows."""
    rng = np.random.default_rng(span_bits)
    base = 1 << 20
    top = (1 << span_bits) - 1
    bk = np.unique(np.concatenate([
        [base, base + top], base + rng.integers(0, top, 150)]))
    pk = np.concatenate([bk[rng.integers(0, len(bk), 200)],
                         base + rng.integers(0, top, 100),
                         [base - 1, base + top + 1]])
    left = pa.record_batch({"k": pa.array(pk),
                            "lv": pa.array(np.arange(len(pk)))})
    right = pa.record_batch({"k": pa.array(bk),
                             "rv": pa.array(np.arange(len(bk)))})
    kw = dict(join_type="left outer", left_keys=["k"], right_keys=["k"],
              max_build_rows=256, **_SUFFIX)
    want, _, _, jbs = _jax([left], right, "sort", **kw)
    got, _, _, tbs = _port([left], right, "sort", **kw)
    assert int(tbs.pack_bits) == int(jbs.pack_bits)
    assert (int(tbs.pack_bits) <= 30) == (span_bits <= 30)
    assert got == want
    tr = batch_from_pyarrow(right, device="cpu")
    tl = batch_from_pyarrow(left, device="cpu")
    hj = THashJoin(tl.schema, tr.schema, TOptions(**kw))
    bs, impl = join_routed(hj, tr)
    assert impl == ("packed_u" if span_bits <= 30 else "sort")
    out, bs = hj.probe(bs, tl, impl=impl)
    assert _rows([_pa(out)]) == want
    if span_bits <= 30:
        assert _port([left], right, "packed", **kw)[0] == want


def test_build_state_fields_vs_jax():
    """The build's spans, lanes, packing spec and payload planes equal the
    JAX package's where both are defined (the sort order inside a run of
    equal keys is free)."""
    rng = np.random.default_rng(14)
    left, right = _tables(rng, unique=True)
    kw = dict(join_type="inner", left_keys=["k"], right_keys=["k"],
              max_build_rows=256)
    _, _, _, jbs = _jax([left], right, "packed", **kw)
    _, _, _, tbs = _port([left], right, "packed", **kw)
    n = int(jbs.num_groups)
    assert int(tbs.num_groups) == n and int(tbs.num_active) == int(
        jbs.num_active)
    # (inactive rows sort last, in an order that is free)
    np.testing.assert_array_equal(tbs.perm.numpy()[:200],
                                  np.asarray(jbs.perm)[:200])
    for name in ("starts_seg", "ends_seg", "gid_of_seg", "bsegs",
                 "pack_lo", "pack_span", "pack_shift", "packed_seg"):
        np.testing.assert_array_equal(
            getattr(tbs, name).numpy().astype(np.int64),
            np.asarray(getattr(jbs, name)).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tbs.seg_lanes.numpy()[:n],
                                  np.asarray(jbs.seg_lanes)[:n])
    np.testing.assert_array_equal(
        tbs.payload_mat.numpy().view(np.uint32)[:200],
        np.asarray(jbs.payload_mat)[:200])


@pytest.mark.parametrize("join_type", ["inner", "full outer", "right anti"])
@pytest.mark.parametrize("impl", ["sort", "packed"])
def test_probe_a_jax_built_state(join_type, impl):
    """``build_state_from_numpy``: the JAX package builds, its state goes
    over as numpy arrays, the port probes and finishes: the same rows."""
    rng = np.random.default_rng(16)
    left, right = _tables(rng)
    kw = dict(join_type=join_type, left_keys=["k"], right_keys=["k"],
              max_build_rows=256, fanout_capacity=1 << 13, **_SUFFIX)
    want, _, _, _ = _jax([left], right, impl, **kw)
    jr = at.Batch.from_pyarrow(right)
    jhj = JHashJoin(at.Batch.from_pyarrow(left).schema, jr.schema,
                    JOptions(**kw))
    leaves = jax.tree_util.tree_map(np.asarray, jhj.build(jr))
    tl = batch_from_pyarrow(left, device="cpu")
    tr = batch_from_pyarrow(right, device="cpu")
    thj = THashJoin(tl.schema, tr.schema, TOptions(**kw))
    bs = build_state_from_numpy(thj, leaves, device="cpu")
    out, bs = thj.probe(bs, tl, impl=impl)
    assert int(bs.error) == 0
    assert _rows([_pa(out), _pa(thj.finish(bs))]) == want


def test_floats_are_moved_bit_for_bit():
    """NaN payloads, -0.0 and subnormals in payload columns come out with
    the bits they went in with."""
    rng = np.random.default_rng(18)
    n = 256
    bits64 = rng.integers(0, 1 << 63, n, dtype=np.int64) | \
        (rng.integers(0, 2, n, dtype=np.int64) << 63)
    bits64[:8] = [0x7FF8000000000001, -0x8000000000000, 0, -(1 << 63), 1,
                  0x7FF0000000000000, 0x7FF4000000000000, 0x0008000000000000]
    bits32 = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    k = np.arange(n, dtype=np.int64)
    right = batch_from_pyarrow(pa.record_batch({"k": pa.array(k)}),
                               device="cpu")
    from arrow_tpu_torch.core.batch import batch_from_numpy
    right = batch_from_numpy({"k": k, "rv": bits64.view(np.float64)},
                             device="cpu")
    left = batch_from_numpy({"k": k[::-1].copy(),
                             "lv": bits32.view(np.float32)[::-1].copy()},
                            device="cpu")
    for impl in ("sort", "packed", "packed_u"):
        hj = THashJoin(left.schema, right.schema, TOptions(
            "inner", ["k"], ["k"], left_output=["k", "lv"],
            right_output=["rv"], max_build_rows=n))
        out, bs = hj.probe(hj.build(right), left, impl=impl)
        assert int(out.length) == n
        ok_ = out.column("k").values.numpy()[:n]
        order = np.argsort(ok_)
        np.testing.assert_array_equal(ok_[order], k)
        np.testing.assert_array_equal(
            out.column("lv").values.numpy()[:n][order].view(np.uint32),
            bits32)
        np.testing.assert_array_equal(
            out.column("rv").values.numpy()[:n][order].view(np.int64),
            bits64)


def test_bloom_and_partition_ids_vs_jax():
    rng = np.random.default_rng(22)
    left, right = _tables(rng)
    kw = dict(join_type="inner", left_keys=["k"], right_keys=["k"],
              max_build_rows=256)
    jl, jr = at.Batch.from_pyarrow(left), at.Batch.from_pyarrow(right)
    tl = batch_from_pyarrow(left, device="cpu")
    tr = batch_from_pyarrow(right, device="cpu")
    jhj = JHashJoin(jl.schema, jr.schema, JOptions(**kw))
    thj = THashJoin(tl.schema, tr.schema, TOptions(**kw))
    jbits = jhj.bloom_build(jhj.build(jr))
    tbits = thj.bloom_build(thj.build(tr))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(
        thj.bloom_mask(tbits, tl).values.numpy(),
        np.asarray(jhj.bloom_mask(jbits, jl).values))
    for side, (jb, tb) in (("build", (jr, tr)), ("probe", (jl, tl))):
        got = thj.partition_ids(tb, side, 8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jhj.partition_ids(jb, side, 8)))


def test_varlen_output_columns_name_their_queue_item():
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.schema import Field, Schema
    ls = Schema((Field("k", dt.int64, True), Field("s", dt.string, True)))
    rs = Schema((Field("k", dt.int64, True),))
    # varlen output columns are ported: they gather through take_array,
    # the fixed-width ones through the plane matrix
    hj = THashJoin(ls, rs, TOptions("inner", ["k"], ["k"]))
    assert hj._lpack == ["k"] and hj.left_out == ["k", "s"]
    THashJoin(ls, rs, TOptions("inner", ["k"], ["k"], left_output=["k"]))


@pytest.mark.parametrize("L", [1, 3, 6])
@pytest.mark.parametrize("bits", [8, 30, 40])
def test_pack_key_lanes_plain_vs_jax(L, bits):
    """The plain version of the ``pack_key_lanes`` kernel against the JAX
    package's ``_pack_lanes``: windows that wrap around 2^32, lanes outside
    their window, shifts of 32 and more; a list of lanes or the columns of
    a matrix; the active flag."""
    import jax.numpy as jnp
    from arrow_tpu.ops.join import _pack_lanes as jpack
    from arrow_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.default_rng(L * 100 + bits)
    n = 2000
    per = min(max(bits // L, 1), 31)
    lo = rng.integers(0, 1 << 32, L, dtype=np.int64)
    lo[0] = (1 << 32) - 3               # a window across the wrap
    span = np.full(L, (1 << per) - 1, dtype=np.int64)
    shift = np.arange(L - 1, -1, -1, dtype=np.int64) * per
    lanes = (lo[None, :] + rng.integers(0, 1 << per, (n, L))) % (1 << 32)
    out = rng.random((n, L)) < 0.05     # some lanes outside their window
    lanes = np.where(out, (lanes + span[None, :] + 1 + rng.integers(
        0, 1000, (n, L))) % (1 << 32), lanes)
    want = np.asarray(jpack(
        jnp.asarray(lanes.astype(np.uint32)), jnp.asarray(
            lo.astype(np.uint32)), jnp.asarray(span.astype(np.uint32)),
        jnp.asarray(shift.astype(np.uint32)))).astype(np.int64)
    mat = torch.from_numpy(lanes)
    args = [torch.from_numpy(x) for x in (lo, span, shift)]
    got = ck.pack_key_lanes(mat.unbind(1), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    got = ck.pack_key_lanes([mat[:, j].contiguous() for j in range(L)],
                            *args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == ck.PACK_MISS).sum() >= out.any(axis=1).sum()
    active = rng.random(n) < 0.7
    got = ck.pack_key_lanes(mat.unbind(1), *args, torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(active, want, ck.PACK_MISS))
    with pytest.raises(ValueError, match="lanes"):
        ck.pack_key_lanes([], *args)
