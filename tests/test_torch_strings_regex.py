"""Port parity of the regex family's eight non-nested functions
(``ops/strings_regex.py``) against the JAX package's, on the CPU, in all
three branches of the host hop: a dictionary column (the regex over its
values, a take by code), a plain column of at least 65,536 rows (the
pushdown: a device distinct, RE2 over the unique slots, a take by code)
and the direct hop; the fallback of the pushdown where a distinct string
is longer than its slot, and Python ``re`` where RE2 rejects the
pattern (mirroring ``tests/test_strings_regex.py``). Outputs compare
exactly (validity, offsets, used bytes, capacities) and against
pyarrow."""

import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.compute import call_function as jcall
from arrow_tpu.core import interop as jinterop
from arrow_tpu.ops import strings_regex as jsre
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.ops import strings_regex as tsre

from test_torch_strings_family import _assert_same

A = pa.array(["hello world", "a-b-c", None, "", "  pad  "])

REGEX = [("match_substring_regex", dict(pattern="^h.*d$")),
         ("match_substring_regex", dict(pattern="L+", ignore_case=True)),
         ("count_substring_regex", dict(pattern="[lo]")),
         ("find_substring_regex", dict(pattern="o")),
         ("replace_substring_regex", dict(pattern="[aeiou]",
                                          replacement="_")),
         ("replace_substring_regex", dict(pattern="l", replacement="LL",
                                          max_replacements=1))]


@pytest.fixture(scope="module")
def big():
    """bench.py's host_boundary words over 65,536 + 1,024 rows, a few
    nulls: the pushdown's threshold passed."""
    n = tsre._PUSHDOWN_MIN_ROWS + 1024
    assert n >= jsre._PUSHDOWN_MIN_ROWS
    rng = np.random.default_rng(7)
    words = np.array([f"id{i % 977:03d}x{i % 31}" for i in range(4096)])
    vals = words[rng.integers(0, len(words), n)].tolist()
    return pa.array([None if i % 9973 == 0 else v
                     for i, v in enumerate(vals)])


def _both(fn, arr, kw, branch):
    t = tinterop.array_from_pyarrow(arr, device="cpu")
    j = jinterop.array_from_pyarrow(arr)
    tsre.reset_host_hops()
    got = tcall(fn, [t], **kw)
    assert tsre.HOST_HOPS == {branch: 1}, dict(tsre.HOST_HOPS)
    # the dictionary and pushdown branches take their results from the
    # unique values' results
    _assert_same(got, jcall(fn, [j], **kw), taken=branch != "direct")
    plain = arr.dictionary_decode() if pa.types.is_dictionary(arr.type) \
        else arr
    assert got.to_pylist() == getattr(pc, fn)(plain, **kw).to_pylist()


@pytest.mark.parametrize("fn,kw", REGEX, ids=[f"{f}-{i}" for i, (f, _) in
                                              enumerate(REGEX)])
def test_direct_hop(fn, kw):
    _both(fn, A, kw, "direct")


@pytest.mark.parametrize("fn,kw", REGEX, ids=[f"{f}-{i}" for i, (f, _) in
                                              enumerate(REGEX)])
def test_dictionary_branch(fn, kw):
    _both(fn, A.dictionary_encode(), kw, "dictionary")


@pytest.mark.parametrize("fn,kw", [
    ("match_substring_regex", dict(pattern=r"7x[12]?[0-9]$")),
    ("count_substring_regex", dict(pattern="[0-9]")),
    ("find_substring_regex", dict(pattern="x")),
    ("replace_substring_regex", dict(pattern="x[0-9]+$",
                                     replacement="!"))])
def test_pushdown_branch(big, fn, kw):
    _both(fn, big, kw, "pushdown")


def test_pushdown_long_slot_falls_back():
    """A distinct string longer than the 64-byte slot: the direct hop,
    still right."""
    n = tsre._PUSHDOWN_MIN_ROWS
    long_word = "x" * (tsre._PUSHDOWN_SLOT_BYTES + 9)
    arr = pa.array([long_word if i % 3 == 0 else f"w{i % 50}"
                    for i in range(n)])
    _both("match_substring_regex", arr, dict(pattern="x{65}"), "direct")


def test_pushdown_too_many_distinct_falls_back():
    n = tsre._PUSHDOWN_MIN_ROWS
    arr = pa.array([f"w{i}" for i in range(n)])
    _both("match_substring_regex", arr, dict(pattern="9$"), "direct")


@pytest.mark.parametrize("fn,kw", [
    ("match_substring_regex", dict(pattern=r"(l)\1")),
    ("find_substring_regex", dict(pattern=r"(?<=l)o")),
    ("replace_substring_regex", dict(pattern=r"(l)\1", replacement="_"))])
def test_pattern_re2_rejects(fn, kw):
    """Backreferences and lookbehind: RE2 raises, Python ``re`` runs."""
    arr = pa.array(["hello world", "loll", None, ""])
    with pytest.raises(pa.ArrowInvalid):
        getattr(pc, fn)(arr, **kw)
    rx = re.compile(kw["pattern"])
    py = {"match_substring_regex": lambda s: rx.search(s) is not None,
          "find_substring_regex":
              lambda s: -1 if rx.search(s) is None else rx.search(s).start(),
          "replace_substring_regex":
              lambda s: rx.sub(kw.get("replacement", ""), s)}[fn]
    want = [None if s is None else py(s) for s in arr.to_pylist()]
    for a in (arr, arr.dictionary_encode()):
        t = tinterop.array_from_pyarrow(a, device="cpu")
        tsre.reset_host_hops()
        got = tcall(fn, [t], **kw)
        assert tsre.HOST_HOPS == {"python_re": 1}, dict(tsre.HOST_HOPS)
        assert got.to_pylist() == want
        if not pa.types.is_dictionary(a.type):
            _assert_same(got, jcall(fn, [jinterop.array_from_pyarrow(a)],
                                    **kw))


@pytest.mark.parametrize("branch", ["direct", "dictionary", "pushdown"])
def test_non_pattern_error_raises(big, monkeypatch, branch):
    """Only a pattern RE2 rejects takes Python ``re``: any other error of
    the host call (here pyarrow's out-of-memory) reaches the caller, in
    every branch."""
    arr = {"direct": A, "dictionary": A.dictionary_encode(),
           "pushdown": big}[branch]

    def fail(*args, **kwargs):
        raise pa.ArrowMemoryError("host out of memory")
    monkeypatch.setattr(tsre, "_host_regex", fail)
    monkeypatch.setattr(tsre, "_compile", lambda *a: pytest.fail(
        "fell back to Python re"))
    t = tinterop.array_from_pyarrow(arr, device="cpu")
    with pytest.raises(pa.ArrowMemoryError):
        tcall("match_substring_regex", [t], pattern="o")


@pytest.mark.parametrize("fn,opts", [
    ("binary_replace_slice", tsre.ReplaceSliceOptions(1, 3, "XY")),
    ("utf8_replace_slice", tsre.ReplaceSliceOptions(0, 1, "é")),
    ("utf8_zero_fill", tsre.ZeroFillOptions(5)),
    ("utf8_zero_fill", tsre.ZeroFillOptions(6, "*")),
    ("utf8_normalize", tsre.Utf8NormalizeOptions("NFD")),
    ("utf8_normalize", tsre.Utf8NormalizeOptions("NFKC"))])
def test_host_elementwise(fn, opts):
    arr = pa.array(["hello", "x", None, "-42", "é", "ﬃ", "+7", ""])
    jopts = getattr(jsre, type(opts).__name__)(*vars(opts).values())
    tsre.reset_host_hops()
    got = tcall(fn, [tinterop.array_from_pyarrow(arr, device="cpu")],
                options=opts)
    assert tsre.HOST_HOPS == {"host_elementwise": 1}
    if (fn, opts.padding if fn == "utf8_zero_fill" else None) == \
            ("utf8_zero_fill", "*"):
        # C28f: the JAX package takes "" for a sign and raises
        with pytest.raises(IndexError):
            jcall(fn, [jinterop.array_from_pyarrow(arr)], options=jopts)
        assert got.to_pylist() == pc.utf8_zero_fill(
            arr, width=6, padding="*").to_pylist()
        return
    _assert_same(got, jcall(fn, [jinterop.array_from_pyarrow(arr)],
                            options=jopts))
