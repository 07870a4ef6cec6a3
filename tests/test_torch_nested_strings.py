"""Port parity of the seven nested functions of ``strings_regex``: the
splits and ``binary_join`` on the device (the compaction kernel's plain
version on the CPU), ``split_pattern_regex``, ``extract_regex`` and
``extract_regex_span`` through the host hop (its direct, dictionary and
pushdown branches). Each against pyarrow and against the JAX package's
buffers on the same input; where the JAX package differs from pyarrow
(ROADMAP C30 (b), (e)) the port follows pyarrow and the difference stays on
record.

A trailing whitespace run is one separator in both packages and in
pyarrow's ``ascii_split_whitespace``; pyarrow's ``utf8_split_whitespace``
gives one more empty token for a trailing run of two or more codepoints
(``test_trailing_whitespace_run``), and the reference's ASCII finder reads
one byte past a row whose run touches its end
(``scalar_string_ascii.cc:2900-2904``, on record in the JAX package's
``_split_whitespace``). Both packages implement the evident intent: one
separator. The other inputs here have no trailing run of two.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu import compute as jc
from arrow_tpu.core import interop as jinterop
from arrow_tpu.ops import strings_regex as jsr
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.ops import strings_regex as tsr
from arrow_tpu_torch.utils.errors import ArrowInvalid
from torch_parity import assert_layout_same

ROWS = ["aaa", "a b", "", None, " a ", "x　y z", "aXbXXc", "aaaa",
        "\tlead and  trail\n", "q\x85r\xa0s", "é b é", "XX", "a-b-c-d"]


def _stage(arr, capacity=None):
    return (tinterop.array_from_pyarrow(arr, capacity=capacity,
                                        device="cpu"),
            jinterop.array_from_pyarrow(arr, capacity=capacity))


def _words(rng, n):
    vocab = np.array(["furiously", "ideas", "pending", "x", "é",
                      "blithely", "requests."])
    seps = np.array([" ", "  ", "\t", " \n "])
    rows = []
    for _ in range(n):
        k = rng.integers(0, 6)
        w = vocab[rng.integers(0, len(vocab), k)]
        s = seps[rng.integers(0, len(seps), max(k - 1, 0))]
        rows.append("".join(a + b for a, b in zip(w, list(s) + [""])))
    return rows


@pytest.mark.parametrize("pattern", ["aa", "X", "a", " ", "-"])
@pytest.mark.parametrize("max_splits", [None, 0, 1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_pattern_matches_pyarrow(pattern, max_splits, reverse):
    """Greedy non-overlapping matches, from the right with ``reverse``;
    the JAX package agrees except C30 (e): ``reverse`` without
    ``max_splits`` matches from the left there, which differs for a
    self-overlapping pattern ("aaa" split at "aa")."""
    a = pa.array(ROWS)
    t, j = _stage(a)
    got = tc.call_function("split_pattern", [t], tsr.SplitPatternOptions(
        pattern, max_splits, reverse))
    want = pc.split_pattern(a, pattern, max_splits=max_splits,
                            reverse=reverse).to_pylist()
    assert got.to_pylist() == want
    jgot = jc.call_function("split_pattern", [j], jsr.SplitPatternOptions(
        pattern, max_splits, reverse))
    if reverse and max_splits is None and pattern == "aa":
        assert jgot.to_pylist()[0] == ["", "a"] and want[0] == ["a", ""]
    else:
        assert_layout_same(got, jgot)


def test_split_pattern_empty_separator_raises():
    t, _ = _stage(pa.array(ROWS))
    with pytest.raises(ArrowInvalid, match="Empty separator"):
        tc.call_function("split_pattern", [t],
                         tsr.SplitPatternOptions(""))


@pytest.mark.parametrize("fn", ["utf8_split_whitespace",
                                "ascii_split_whitespace"])
@pytest.mark.parametrize("max_splits", [None, 1, 3])
def test_split_whitespace_matches_pyarrow(fn, max_splits):
    """Maximal whitespace runs; ``utf8`` on the oracle's space class,
    ``ascii`` on ASCII whitespace only. C30 (b): the JAX package splits
    both on Python's ``\\s``, so its ``ascii_split_whitespace`` splits at
    U+3000, U+0085 and U+00A0 too."""
    rows = ROWS + _words(np.random.default_rng(1), 200)
    a = pa.array(rows)
    t, j = _stage(a)
    got = tc.call_function(fn, [t], tsr.SplitOptions(max_splits))
    want = getattr(pc, fn)(a, max_splits=max_splits).to_pylist()
    assert got.to_pylist() == want
    jgot = jc.call_function(fn, [j], jsr.SplitOptions(max_splits))
    if fn == "utf8_split_whitespace":
        assert_layout_same(got, jgot)
    else:
        assert jgot.to_pylist()[5][0] == "x"
        assert want[5][0] == "x　y"
    with pytest.raises(NotImplementedError):
        tc.call_function(fn, [t], tsr.SplitOptions(1, reverse=True))


def test_trailing_whitespace_run():
    """One separator for a trailing run, in both packages: ["a", ""]. On
    record: pyarrow's utf8 splitter gives ["a", "", ""] for a run of two
    or more, its ASCII splitter ["a", ""]."""
    a = pa.array(["a \n", "b\t ", " \n"])
    t, j = _stage(a)
    for fn in ("utf8_split_whitespace", "ascii_split_whitespace"):
        got = tc.call_function(fn, [t])
        assert got.to_pylist() == [["a", ""], ["b", ""], ["", ""]]
        assert_layout_same(got, jc.call_function(fn, [j]))
    assert pc.ascii_split_whitespace(a).to_pylist() == \
        [["a", ""], ["b", ""], ["", ""]]
    assert pc.utf8_split_whitespace(a).to_pylist() == \
        [["a", "", ""], ["b", "", ""], ["", "", ""]]


def test_split_a_dictionary_column():
    a = pa.array(ROWS * 3).dictionary_encode()
    t, _ = _stage(a)
    got = tc.call_function("utf8_split_whitespace", [t])
    assert got.to_pylist() == pc.utf8_split_whitespace(
        a.dictionary_decode()).to_pylist()


@pytest.mark.parametrize("sep", ["--", "", "array"])
def test_binary_join_matches_pyarrow_and_jax(sep):
    """Null where the list, the separator or an element is null."""
    lists = pa.array([["a", "bc"], [], None, ["c", None], ["d"],
                      ["é", "f", "gh"], [""], ["", ""]],
                     pa.list_(pa.string()))
    sep_arr = pa.array(["-", None, "+", "+", "", "::", "x", "yz"])
    tl, jl = _stage(lists)
    if sep == "array":
        ts, js = _stage(sep_arr)
        want = pc.binary_join(lists, sep_arr)
    else:
        ts = js = sep
        want = pc.binary_join(lists, sep)
    got = tc.call_function("binary_join", [tl, ts])
    assert got.to_pyarrow().equals(want)
    assert_layout_same(got, jc.call_function("binary_join", [jl, js]))


def test_split_then_join_round_trip():
    a = pa.array(_words(np.random.default_rng(2), 300))
    t, _ = _stage(a)
    parts = tc.call_function("split_pattern", [t],
                             tsr.SplitPatternOptions(" "))
    back = tc.call_function("binary_join", [parts, " "])
    assert back.to_pylist() == a.to_pylist()


REGEX = r"(?P<l>[a-z]+)(?P<d>\d+)?"


@pytest.mark.parametrize("staging", ["direct", "dictionary", "pushdown"])
def test_regex_hops_match_pyarrow(staging, monkeypatch):
    """The three regex host hops on each branch of ``_via_pc``: a nested
    result of the dictionary and pushdown branches is taken by code on the
    host. ``HOST_HOPS`` counts the branch."""
    vals = ["ab12", "zz", None, "q9", "", "x-7 y8", "é1"]
    a = pa.array(vals * 4)
    if staging == "dictionary":
        a = a.dictionary_encode()
    if staging == "pushdown":
        monkeypatch.setattr(tsr, "_PUSHDOWN_MIN_ROWS", 16)
    t, j = _stage(a)
    plain = a.dictionary_decode() if staging == "dictionary" else a
    tsr.reset_host_hops()
    for fn, opts, popts in (
            ("extract_regex", tsr.ExtractRegexOptions(REGEX), REGEX),
            ("extract_regex_span", tsr.ExtractRegexOptions(REGEX), REGEX),
            ("split_pattern_regex", tsr.SplitPatternOptions(r"\d"), r"\d"),
            ("split_pattern_regex", tsr.SplitPatternOptions(r"\d", 1),
             r"\d")):
        got = tc.call_function(fn, [t], opts)
        kw = {"max_splits": opts.max_splits} \
            if fn == "split_pattern_regex" else {}
        assert got.to_pylist() == getattr(pc, fn)(plain, popts,
                                                  **kw).to_pylist(), fn
    assert tsr.HOST_HOPS == {staging: 4}
    if staging == "direct":
        # the JAX package's extract_regex_span runs Python ``re`` and gives
        # the same spans here
        jgot = jc.call_function("extract_regex_span", [j],
                                jsr.ExtractRegexOptions(REGEX))
        assert jgot.to_pylist() == tc.call_function(
            "extract_regex_span", [t],
            tsr.ExtractRegexOptions(REGEX)).to_pylist()


def test_regex_hop_falls_back_to_python_re():
    """A pattern RE2 rejects (a backreference) runs through Python ``re``,
    as in the JAX package."""
    a = pa.array(["abab", "xyz", None, "cdcd"])
    t, j = _stage(a)
    opts = tsr.SplitPatternOptions(r"(ab)\1")
    tsr.reset_host_hops()
    got = tc.call_function("split_pattern_regex", [t], opts)
    want = jc.call_function("split_pattern_regex", [j],
                            jsr.SplitPatternOptions(r"(ab)\1"))
    assert got.to_pylist() == want.to_pylist()
    assert tsr.HOST_HOPS["python_re"] == 1
