"""Port parity of the string function family (``ops/strings.py`` and
``ops/unicode_text.py``): each of the 63 functions against the JAX
package's on the same pyarrow data, on the CPU, with the cases of
``tests/test_strings.py`` (nulls, empty strings, capacities past the
length) and the Unicode corpus. Outputs compare exactly: validity, the
offsets of every row and the bytes they use, fixed-width values of the
valid rows, and the capacities (rows and pool bytes).

Where the port does not copy a fault of the JAX package (ROADMAP C28:
codepoint slicing, codepoint pad widths, codepoint trim sets, Unicode
whitespace, int32 pools that wrap), it is held against pyarrow, and the
JAX package's difference is kept on record."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.compute import call_function as jcall
from arrow_tpu.core import interop as jinterop
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.compute import registry as tregistry
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.core.array import dictionary_from_numpy
from arrow_tpu_torch.ops import strings as tstr

SAMPLE = pa.array(["Hello World", "hEllO", "", None, "a1 b2", "ZZZ",
                   "  padded  ", "tail    "])

UNICODE = pa.array([
    "ß", "İstanbul", "ǆungla hello", "aΣb σc ΤΕΛΟΣ", "ı", "ﬃ",
    "Hello World", "", "ʼn", "ΐ", "µzµ", "ǅenan ǄUNGLA", "ᏣᎳᎩ",
    "𐐀𐐨 deseret", "ab_cd 12", "  spaced  ", "ÉÀ-éà", "ẞß",
    "数字123", "٣٤٥", "Ⅷ ⅷ", "¾", None, "x", "\tb c",
])

# the array of the probes behind ROADMAP C28
C28 = pa.array(["héllo", "añb", "ß", "xyz", None, "ÀÉÎõü", "lll",
                "  éa  "])


def rand_strings(seed, n, max_len=12, charset="abcXYZ 019_",
                 null_prob=0.15):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < null_prob:
            out.append(None)
        else:
            ln = int(rng.integers(0, max_len + 1))
            out.append("".join(rng.choice(list(charset), ln)))
    return pa.array(out, type=pa.string())


def _np(x):
    return np.asarray(x)


def _valid(validity, n):
    return np.ones(n, bool) if validity is None else _np(validity)[:n]


def _assert_same(t, j, taken=False):
    """A port Array against a JAX Array. ``taken``: the port's result is a
    take, whose byte pool holds exactly its bytes (the JAX package sizes it
    by a bound)."""
    n = len(j)
    assert len(t) == n and t.capacity == j.capacity
    ok = _valid(t.validity, n)
    np.testing.assert_array_equal(ok, _valid(j.validity, n))
    if j.offsets is not None:
        if taken:
            assert t.values.shape[0] == max(int(t.offsets[n]), 1), \
                "pool capacity"
        else:
            assert t.values.shape[0] == j.values.shape[0], "pool capacity"
        off = t.offsets[:n + 1].numpy()
        np.testing.assert_array_equal(off, _np(j.offsets)[:n + 1])
        np.testing.assert_array_equal(t.values[:off[-1]].numpy(),
                                      _np(j.values)[:off[-1]])
    else:
        np.testing.assert_array_equal(t.values[:n].numpy()[ok],
                                      _np(j.values)[:n][ok])


def _stage(arr, capacity=None):
    return (tinterop.array_from_pyarrow(arr, capacity=capacity,
                                        device="cpu"),
            jinterop.array_from_pyarrow(arr, capacity=capacity))


def both(fn, arr, *more, capacity=None, **kw):
    """Run ``fn`` in both packages on ``arr`` (staged at ``capacity``) and
    compare; returns the port's result."""
    t, j = _stage(arr, capacity)
    got = tcall(fn, [t, *more], **kw)
    _assert_same(got, jcall(fn, [j, *more], **kw))
    return got


def oracle(fn, arr, **kw):
    """The port against pyarrow."""
    t = tinterop.array_from_pyarrow(arr, device="cpu")
    got = tcall(fn, [t], **kw).to_pyarrow()
    want = getattr(pc, fn)(arr, **kw)
    assert got.to_pylist() == want.to_pylist(), (fn, got, want)


def test_registers_the_family():
    names = set(tregistry.list_functions())
    expect = {
        "binary_length", "utf8_length", "ascii_upper", "ascii_lower",
        "ascii_swapcase", "ascii_capitalize", "ascii_title", "ascii_reverse",
        "binary_reverse", "utf8_upper", "utf8_lower", "utf8_swapcase",
        "utf8_capitalize", "utf8_title", "utf8_reverse", "ascii_is_alnum",
        "ascii_is_alpha", "ascii_is_decimal", "ascii_is_space",
        "ascii_is_printable", "string_is_ascii", "utf8_is_alnum",
        "utf8_is_alpha", "utf8_is_decimal", "utf8_is_digit",
        "utf8_is_numeric", "utf8_is_space", "utf8_is_printable",
        "ascii_is_lower", "ascii_is_upper", "utf8_is_lower", "utf8_is_upper",
        "ascii_is_title", "utf8_is_title", "match_substring",
        "find_substring", "count_substring", "starts_with", "ends_with",
        "match_like", "binary_slice", "utf8_slice_codeunits", "utf8_trim",
        "utf8_ltrim", "utf8_rtrim", "ascii_trim", "ascii_ltrim",
        "ascii_rtrim", "utf8_trim_whitespace", "utf8_ltrim_whitespace",
        "utf8_rtrim_whitespace", "ascii_trim_whitespace",
        "ascii_ltrim_whitespace", "ascii_rtrim_whitespace", "utf8_lpad",
        "utf8_rpad", "utf8_center", "ascii_lpad", "ascii_rpad",
        "ascii_center", "binary_repeat", "binary_join_element_wise",
        "replace_substring"}
    assert len(expect) == 63 and expect <= names


@pytest.mark.parametrize("fn", ["binary_length", "utf8_length"])
def test_lengths(fn):
    both(fn, SAMPLE, capacity=16)
    both(fn, UNICODE)


@pytest.mark.parametrize("fn", [
    "ascii_upper", "ascii_lower", "ascii_swapcase", "ascii_capitalize",
    "ascii_title", "ascii_reverse", "binary_reverse", "utf8_upper",
    "utf8_lower", "utf8_swapcase", "utf8_capitalize", "utf8_title",
    "utf8_reverse"])
def test_case_transforms(fn):
    both(fn, SAMPLE, capacity=16)
    both(fn, rand_strings(1, 200))
    if fn.startswith("utf8"):
        both(fn, UNICODE)


@pytest.mark.parametrize("fn", [
    "ascii_is_alnum", "ascii_is_alpha", "ascii_is_decimal",
    "ascii_is_space", "ascii_is_printable", "ascii_is_lower",
    "ascii_is_upper", "ascii_is_title", "string_is_ascii",
    "utf8_is_alnum", "utf8_is_alpha", "utf8_is_digit", "utf8_is_decimal",
    "utf8_is_numeric", "utf8_is_space", "utf8_is_printable",
    "utf8_is_lower", "utf8_is_upper", "utf8_is_title"])
def test_predicates(fn):
    a = pa.array(["abc", "ABC", "a1", "123", "  ", "", None, "Hello World",
                  "Hello world", "hELLO", "a b", "A1B2"])
    both(fn, a, capacity=16)
    both(fn, rand_strings(2, 150))
    both(fn, UNICODE)


@pytest.mark.parametrize("pattern", ["ab", "a", "XY", "", "Hello",
                                     "not-there"])
@pytest.mark.parametrize("fn", ["match_substring", "find_substring",
                                "count_substring"])
def test_match_find_count(fn, pattern):
    a = pa.array(["abab", "aaab", "", None, "XYXY", "Hello World",
                  "aaaa", "abababa"])
    both(fn, a, capacity=16, pattern=pattern)
    if pattern:
        both(fn, rand_strings(3, 200, charset="abX"), pattern=pattern)


@pytest.mark.parametrize("pattern", ["aba", "aa", "ab", "abab"])
def test_count_overlapping_patterns(pattern):
    # greedy, not overlapping: "abababa" holds 2 "aba", "aaaa" 2 "aa"
    both("count_substring", pa.array(["abababa", "aaaa", "aaa", "ababab"]),
         pattern=pattern)


@pytest.mark.parametrize("fn", ["match_substring", "find_substring",
                                "count_substring", "starts_with",
                                "ends_with"])
def test_match_ignore_case(fn):
    both(fn, pa.array(["AbC", "xyz", None, "ABCabc"]), pattern="bC",
         ignore_case=True)


@pytest.mark.parametrize("fn", ["starts_with", "ends_with"])
def test_starts_ends(fn):
    a = pa.array(["abab", "ab", "b", "", None, "xyzab"])
    for p in ["ab", "b", "", "abababX"]:
        both(fn, a, pattern=p)


def test_match_like():
    a = pa.array(["foobar", "foo", "barfoo", "xfoox", None])
    for p in ["foo%", "%foo", "%foo%", "foo", "%"]:
        both("match_like", a, pattern=p)
    for p in ["f_o", "f%o"]:
        with pytest.raises(NotImplementedError, match="match_like"):
            tcall("match_like", [_stage(a)[0]], pattern=p)


@pytest.mark.parametrize("start,stop,step", [
    (0, 2, 1), (1, None, 1), (-3, -1, 1), (2, 100, 1), (1, 100, 2),
    (-100, 3, 1), (4, 0, -2), (0, 0, 1), (-1, None, -1), (3, -6, -1)])
def test_slice(start, stop, step):
    a = pa.array(["hello", "", "ab", None, "longer-string"])
    b = a.cast(pa.binary())
    both("binary_slice", b, capacity=8, start=start, stop=stop, step=step)
    # ASCII: codepoints are bytes, the JAX package agrees
    both("utf8_slice_codeunits", a, capacity=8, start=start, stop=stop,
         step=step)
    oracle("utf8_slice_codeunits", UNICODE, start=start, stop=stop,
           step=step)


@pytest.mark.parametrize("fn", ["utf8_trim", "utf8_ltrim", "utf8_rtrim",
                                "ascii_trim", "ascii_ltrim", "ascii_rtrim"])
def test_trim(fn):
    a = pa.array(["xxhixx", "  hi  ", "xhx", "", None, "xxxx"])
    both(fn, a, capacity=8, characters=" x")


@pytest.mark.parametrize("fn", [
    "utf8_trim_whitespace", "utf8_ltrim_whitespace",
    "utf8_rtrim_whitespace", "ascii_trim_whitespace",
    "ascii_ltrim_whitespace", "ascii_rtrim_whitespace"])
def test_trim_whitespace(fn):
    both(fn, pa.array(["\t hi \n", "hi", "  ", "", None]), capacity=8)


@pytest.mark.parametrize("fn,width", [
    ("utf8_lpad", 6), ("utf8_rpad", 6), ("utf8_center", 7),
    ("utf8_center", 6), ("ascii_lpad", 6), ("ascii_rpad", 6),
    ("ascii_center", 7), ("ascii_center", 6)])
def test_pad(fn, width):
    a = pa.array(["ab", "abcdefgh", "", None])
    both(fn, a, capacity=8, width=width, padding="*")
    both(fn, a, width=width, padding="*", lean_left_on_odd_padding=False)


@pytest.mark.parametrize("reps", [3, 0, "column"])
def test_repeat(reps):
    a = pa.array(["ab", "", None, "x"])
    if reps == "column":
        r = pa.array([2, 5, 1, None], pa.int64())
        t, j = _stage(a)
        got = tcall("binary_repeat", [t, _stage(r)[0]])
        _assert_same(got, jcall("binary_repeat", [j, _stage(r)[1]]))
        return
    both("binary_repeat", a, reps)


@pytest.mark.parametrize("sep", ["-", ""])
def test_join_element_wise(sep):
    a = pa.array(["a", None, "c", ""])
    b = pa.array(["1", "2", None, "4"])
    (ta, ja), (tb, jb) = _stage(a), _stage(b)
    for targs, jargs in [([ta, tb, sep], [ja, jb, sep]),
                         ([ta, tb, ta, sep], [ja, jb, ja, sep]),
                         ([ta, "lit", tb], [ja, "lit", jb])]:
        _assert_same(tcall("binary_join_element_wise", targs),
                     jcall("binary_join_element_wise", jargs))
    # a separator column
    s = pa.array(["+", "++", "", None])
    _assert_same(tcall("binary_join_element_wise", [ta, tb, _stage(s)[0]]),
                 jcall("binary_join_element_wise", [ja, jb, _stage(s)[1]]))


@pytest.mark.parametrize("maxr", [None, 1, 2, 0])
def test_replace_substring(maxr):
    a = pa.array(["ababab", "xx", "", None, "aba", "abababa"])
    both("replace_substring", a, capacity=8, pattern="ab",
         replacement="XYZ", max_replacements=maxr)


@pytest.mark.parametrize("pattern,replacement", [("o", ""), ("ll", "L"),
                                                 ("aa", "b")])
def test_replace_shrink(pattern, replacement):
    a = pa.array(["hello world", "wow", None, "aaaaa", "llll"])
    both("replace_substring", a, pattern=pattern, replacement=replacement)
    both("replace_substring", rand_strings(4, 100, charset="aol"),
         pattern=pattern, replacement=replacement)


def test_utf8_case_random_codepoints():
    """Over the whole case-mapped range, multi-byte growth included."""
    rng = np.random.default_rng(5)
    pool = ([chr(c) for c in rng.integers(0x20, 0x1E944, 400)
             if not (0xD800 <= c < 0xE000)] +
            [chr(c) for c in rng.integers(0x1E944, 0x10FFFF, 100)
             if not (0xD800 <= c < 0xE000)])
    a = pa.array(["".join(rng.choice(pool, rng.integers(0, 12)))
                  for _ in range(64)])
    for fn in ("utf8_upper", "utf8_lower", "utf8_swapcase", "utf8_title",
               "utf8_capitalize", "utf8_reverse", "utf8_length",
               "utf8_is_title"):
        both(fn, a)


def test_empty_pool():
    """A column whose rows are all empty or null."""
    a = pa.array(["", None, ""])
    for fn in ("utf8_upper", "utf8_reverse", "utf8_is_alpha",
               "ascii_trim_whitespace", "utf8_length"):
        got = tcall(fn, [_stage(a)[0]]).to_pyarrow()
        assert got.to_pylist() == getattr(pc, fn)(a).to_pylist(), fn


def test_dictionary_input_reads_the_dictionary():
    """A dictionary column of strings is read through its dictionary (the
    JAX package passes its codes as bytes)."""
    d = dictionary_from_numpy(np.array([1, 0, 2, 1]),
                              np.array(["ab", "héllo", "Zz"]),
                              validity=[True, True, False, True],
                              device="cpu")
    plain = pa.array(["héllo", "ab", None, "héllo"])
    for fn, kw in [("utf8_upper", {}), ("utf8_length", {}),
                   ("match_substring", {"pattern": "ll"}),
                   ("utf8_lpad", {"width": 7, "padding": "*"})]:
        assert tcall(fn, [d], **kw).to_pylist() == \
            getattr(pc, fn)(plain, **kw).to_pylist(), fn


# ---- C28: faults of the JAX package the port does not copy -----------------

@pytest.mark.parametrize("start,stop,step", [(0, 2, 1), (1, None, 1),
                                             (-2, None, 1), (4, 0, -2)])
def test_c28a_slice_by_codepoints(start, stop, step):
    kw = dict(start=start, stop=stop, step=step)
    oracle("utf8_slice_codeunits", C28, **kw)
    if (start, stop, step) == (0, 2, 1):
        # the JAX package cuts 'héllo' inside 'é': invalid UTF-8
        j = jcall("utf8_slice_codeunits", [jinterop.array_from_pyarrow(C28)],
                  **kw)
        with pytest.raises(UnicodeDecodeError):
            j.to_pyarrow().to_pylist()


@pytest.mark.parametrize("fn", ["utf8_lpad", "utf8_rpad", "utf8_center"])
@pytest.mark.parametrize("padding", ["*", "é", "日"])
def test_c28b_pad_width_in_codepoints(fn, padding):
    oracle(fn, C28, width=6, padding=padding)
    j = jinterop.array_from_pyarrow(C28)
    if padding == "*":
        # the JAX package counts 'héllo''s 6 bytes as its width
        assert jcall(fn, [j], width=6, padding=padding).to_pylist()[0] \
            == "héllo"
    else:
        with pytest.raises(ValueError, match="one byte"):
            jcall(fn, [j], width=6, padding=padding)


def test_c28b_pad_rejects_wider_padding():
    with pytest.raises(ValueError, match="one codepoint"):
        tcall("utf8_lpad", [_stage(C28)[0]], width=6, padding="ab")
    with pytest.raises(ValueError, match="one byte"):
        tcall("ascii_lpad", [_stage(C28)[0]], width=6, padding="é")


@pytest.mark.parametrize("fn", ["utf8_trim", "utf8_ltrim", "utf8_rtrim"])
@pytest.mark.parametrize("characters", ["hé", "éa ", "ßx", "õüÀ"])
def test_c28c_trim_codepoint_sets(fn, characters):
    oracle(fn, C28, characters=characters)
    if (fn, characters) == ("utf8_trim", "hé"):
        # the JAX package trims the bytes of 'é' one by one
        j = jcall(fn, [jinterop.array_from_pyarrow(C28)],
                  characters=characters)
        with pytest.raises(UnicodeDecodeError):
            j.to_pyarrow().to_pylist()


@pytest.mark.parametrize("fn", ["utf8_trim_whitespace",
                                "utf8_ltrim_whitespace",
                                "utf8_rtrim_whitespace"])
def test_c28e_unicode_whitespace(fn):
    a = pa.array(["　hi ", "  x  ", "plain ", None])
    oracle(fn, a)
    # the JAX package trims ASCII whitespace only
    got = jcall(fn, [jinterop.array_from_pyarrow(a)]).to_pylist()
    assert got[0] == "　hi "


@pytest.mark.parametrize("fn,args,kw", [
    ("binary_repeat", [1 << 31], {}),
    ("utf8_lpad", [], {"width": (1 << 31) + 5, "padding": "*"}),
    ("ascii_center", [], {"width": 1 << 31, "padding": "*"})])
def test_c28d_pool_past_int32_raises(fn, args, kw):
    """The output pool would pass 2^31 - 1 bytes: the port raises before
    it allocates (the JAX package's int32 prefix sums wrap there)."""
    t = tinterop.array_from_pyarrow(pa.array(["ab", "c"]), device="cpu")
    with pytest.raises(ValueError, match=f"{fn}: an output pool of"):
        tcall(fn, [t, *args], **kw)


def test_c28d_jax_offsets_wrap():
    """The JAX package's ``_build_varlen`` prefix-sums the new lengths in
    int32 with no check (``arrow_tpu/ops/strings.py:129-131``): two rows
    of 2^30 bytes give a negative end offset."""
    import jax.numpy as jnp
    n = jnp.array([1 << 30, 1 << 30], jnp.int32)
    assert int(jnp.cumsum(n, dtype=jnp.int32)[-1]) < 0
    import torch
    t = tstr._new_offsets(tinterop.array_from_pyarrow(
        pa.array(["a", "b"]), capacity=2, device="cpu"),
        torch.tensor([1 << 30, 1 << 30], dtype=torch.int32))
    assert int(t[-1]) == 1 << 31
