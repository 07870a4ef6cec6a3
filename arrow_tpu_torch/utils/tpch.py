"""TPC-H data generator (host-side, numpy-vectorized, spec-exact): the
port's copy of the JAX package's ``utils/tpch.py``, which imports only numpy
and pyarrow. pyarrow is imported inside the functions here, so that
``import arrow_tpu_torch`` runs without it.

Reference: ``cpp/src/arrow/acero/tpch_node.cc`` (3.5k LoC dbgen
re-creation used by ``tpch_benchmark.cc``). Like the reference, this is
a *spec-conformant* generator, not a byte-identical clone of the dbgen
binary: the reference itself draws from ``pcg32``/``pcg64`` RNGs with
arbitrary seeds (``tpch_node.cc:646``), so row-for-row byte identity
with dbgen is not the parity bar — TPC-H clause 4.2.2/4.2.3 structural
conformance is. This module implements that structure exactly:

  * **pseudotext grammar** (clause 4.2.2.10): sentence = noun-phrase /
    verb-phrase / prepositional-phrase forms over the spec word lists;
    every comment column is a random slice of a shared text pool with
    the spec's per-column length ranges (``tpch_node.cc:248``
    TpchPseudotext does the same, slicing a 300 MB pool). The pool here
    is a fixed 32 MB (``_TEXT_POOL_BYTES``): a diversity reservoir, not
    a correctness knob.
  * **key structure**: sparse orderkeys (bits spread so only 1/4 of the
    key space is used), partsupp's magic supplier formula
    ``(partkey + (i * ((S/4) + (partkey-1)/S))) % S + 1`` shared by
    L_SUPPKEY so every (l_partkey, l_suppkey) exists in partsupp
    (``tpch_node.cc:1156,1887``), custkeys ≡ 0 (mod 3) never place
    orders (Q13/Q22 rely on this).
  * **derived expressions**: l_extendedprice = l_quantity *
    p_retailprice(partkey) with retailprice = (90000 + ((pk/10) % 20001)
    + 100*(pk%1000))/100 (``tpch_node.cc:1060``); o_totalprice = sum of
    l_extendedprice*(1+l_tax)*(1-l_discount) over the order's lines
    (``tpch_node.cc:1651``); o_orderstatus = F/O/P from the lines'
    l_linestatus.
  * **value domains**: phones are (nationkey+10)-XXX-XXX-XXXX, V-string
    addresses over dbgen's 64-char alphabet, p_name = 5 distinct color
    words, p_brand = Brand#MN sharing M with p_mfgr, containers = the
    5x8 two-word grid, quantity 1..50, discount 0..0.10, tax 0..0.08,
    dates in [1992-01-01, 1998-12-31] with the clause 4.2.3 offsets.
  * **Q16's special supplier comments**: 5*SF rows contain "Customer …
    Complaints" and 5*SF contain "Customer … Recommends"
    (``tpch_node.cc:2423``).

All tables generate in bulk numpy passes; strings build as raw byte
pools + offsets (no per-row Python). Low-cardinality text columns are
dictionary-encoded where the engine expects it.
"""

from __future__ import annotations

import datetime as dtm

import numpy as np

__all__ = ["tpch_table", "TPCH_TABLES"]

TPCH_TABLES = ["region", "nation", "supplier", "customer", "part",
               "partsupp", "orders", "lineitem"]

_EPOCH = dtm.date(1970, 1, 1)
_D = lambda y, m, d: (dtm.date(y, m, d) - _EPOCH).days  # noqa: E731
_STARTDATE = _D(1992, 1, 1)     # tpch_node.cc kStartDate = 8035
_CURRENTDATE = _D(1995, 6, 17)  # kCurrentDate = 9298
_ENDDATE = _D(1998, 12, 31)     # kEndDate = 10591

# ---- spec vocabularies (TPC-H clause 4.2.2.13 / dists.dss data) ----------

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"]
_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
            "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN",
            "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE",
            "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM",
            "RUSSIA", "UNITED KINGDOM", "UNITED STATES"]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                  3, 4, 2, 3, 3, 1]
_TYPES = [f"{a} {b} {c}" for a in ["STANDARD", "SMALL", "MEDIUM", "LARGE",
                                   "ECONOMY", "PROMO"]
          for b in ["ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                    "BRUSHED"]
          for c in ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]]
# clause 4.2.2.13: container = syllable-1 x syllable-2 (5 x 8 grid)
_CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
               for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                         "CAN", "DRUM"]]
# 92 color words (P_NAME draws 5 distinct ones per part)
_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque",
    "black", "blanched", "blue", "blush", "brown", "burlywood",
    "burnished", "chartreuse", "chiffon", "chocolate", "coral",
    "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
    "dodger", "drab", "firebrick", "floral", "forest", "frosted",
    "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
    "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
    "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow"]

# pseudotext grammar word lists (clause 4.2.2.10 / dists.dss)
_NOUNS = [
    "foxes", "ideas", "theodolites", "pinto beans", "instructions",
    "dependencies", "excuses", "platelets", "asymptotes", "courts",
    "dolphins", "multipliers", "sauternes", "warthogs", "frets",
    "dinos", "attainments", "somas", "Tiresias", "patterns", "forges",
    "braids", "hockey players", "frays", "warhorses", "dugouts",
    "notornis", "epitaphs", "pearls", "tithes", "waters", "orbits",
    "gifts", "sheaves", "depths", "sentiments", "decoys", "realms",
    "pains", "grouches", "escapades", "accounts", "deposits",
    "packages", "requests"]
_VERBS = [
    "sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
    "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
    "sublate", "solve", "thrash", "promise", "engage", "hinder",
    "print", "x-ray", "breach", "eat", "grow", "impress", "mold",
    "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
    "kindle", "play", "hang", "believe", "doubt"]
_ADJECTIVES = [
    "furious", "sly", "careful", "blithe", "quick", "fluffy", "slow",
    "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
    "stealthy", "permanent", "enticing", "idle", "busy", "regular",
    "final", "ironic", "even", "bold", "silent", "special", "express",
    "pending", "unusual", "ironic"]
_ADVERBS = [
    "sometimes", "always", "never", "furiously", "slyly", "carefully",
    "blithely", "quickly", "fluffily", "slowly", "quietly",
    "ruthlessly", "thinly", "closely", "doggedly", "daringly",
    "bravely", "stealthily", "permanently", "enticingly", "idly",
    "busily", "regularly", "finally", "ironically", "evenly", "boldly",
    "silently"]
_PREPOSITIONS = [
    "about", "above", "according to", "across", "after", "against",
    "along", "alongside of", "among", "around", "at", "atop", "before",
    "behind", "beneath", "beside", "besides", "between", "beyond",
    "by", "despite", "during", "except", "for", "from", "in place of",
    "inside", "instead of", "into", "near", "of", "on", "outside",
    "over", "past", "since", "through", "throughout", "to", "toward",
    "under", "until", "up", "upon", "without", "with", "within"]
_AUXILIARIES = [
    "do", "may", "might", "shall", "will", "would", "can", "could",
    "should", "ought to", "must", "will have to", "shall have to",
    "could have to", "should have to", "must have to", "need to",
    "try to"]
_TERMINATORS = [".", ";", ":", "?", "!", "--"]

# dbgen's 64-char V-string alphabet (tpch_node.cc:610 alpha_numerics)
_VSTR_ALPHABET = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyz"
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZ,. #-", dtype=np.uint8)

_ORDERS_PER_SF = 1_500_000
_CUST_PER_SF = 150_000
_PART_PER_SF = 200_000
_SUPP_PER_SF = 10_000


# ---- pseudotext pool ------------------------------------------------------

_TEXT_POOL: np.ndarray | None = None  # uint8, built once per process
_TEXT_POOL_BYTES = 32 << 20


def _phrase_pick(rng, table, n):
    """n random entries of a python word list as an S-bytes array."""
    arr = np.asarray([w.encode() for w in table], dtype=object)
    return arr[rng.integers(0, len(arr), n)]


def _noun_phrase(rng, n):
    """noun | adj noun | adj, adj noun | adverb adj noun."""
    form = rng.integers(0, 4, n)
    noun = _phrase_pick(rng, _NOUNS, n)
    adj = _phrase_pick(rng, _ADJECTIVES, n)
    adj2 = _phrase_pick(rng, _ADJECTIVES, n)
    adv = _phrase_pick(rng, _ADVERBS, n)
    out = np.empty(n, dtype=object)
    out[form == 0] = noun[form == 0]
    m = form == 1
    out[m] = adj[m] + b" " + noun[m]
    m = form == 2
    out[m] = adj[m] + b", " + adj2[m] + b" " + noun[m]
    m = form == 3
    out[m] = adv[m] + b" " + adj[m] + b" " + noun[m]
    return out


def _verb_phrase(rng, n):
    """verb | aux verb | verb adverb | aux verb adverb."""
    form = rng.integers(0, 4, n)
    verb = _phrase_pick(rng, _VERBS, n)
    aux = _phrase_pick(rng, _AUXILIARIES, n)
    adv = _phrase_pick(rng, _ADVERBS, n)
    out = np.empty(n, dtype=object)
    out[form == 0] = verb[form == 0]
    m = form == 1
    out[m] = aux[m] + b" " + verb[m]
    m = form == 2
    out[m] = verb[m] + b" " + adv[m]
    m = form == 3
    out[m] = aux[m] + b" " + verb[m] + b" " + adv[m]
    return out


def _prep_phrase(rng, n):
    """preposition the noun-phrase."""
    return _phrase_pick(rng, _PREPOSITIONS, n) + b" the " + \
        _noun_phrase(rng, n)


def _sentences(rng, n):
    """Clause 4.2.2.10 sentence forms, vectorized."""
    form = rng.integers(0, 5, n)
    np1 = _noun_phrase(rng, n)
    vp = _verb_phrase(rng, n)
    term = _phrase_pick(rng, _TERMINATORS, n)
    out = np.empty(n, dtype=object)
    m = form == 0
    out[m] = np1[m] + b" " + vp[m] + term[m]
    m = form == 1
    pp = _prep_phrase(rng, int(m.sum()))
    out[m] = np1[m] + b" " + vp[m] + b" " + pp + term[m]
    m = form == 2
    np2 = _noun_phrase(rng, int(m.sum()))
    out[m] = np1[m] + b" " + vp[m] + b" " + np2 + term[m]
    m = form == 3
    pp = _prep_phrase(rng, int(m.sum()))
    np2 = _noun_phrase(rng, int(m.sum()))
    out[m] = np1[m] + b" " + pp + b" " + vp[m] + b" " + np2 + term[m]
    m = form == 4
    pp = _prep_phrase(rng, int(m.sum()))
    pp2 = _prep_phrase(rng, int(m.sum()))
    out[m] = np1[m] + b" " + pp + b" " + vp[m] + b" " + pp2 + term[m]
    return out


def _text_pool() -> np.ndarray:
    """The shared pseudotext pool (uint8). Built once; every comment
    column slices it at random offsets, mirroring TpchPseudotext's
    300 MB buffer + random-slice design (``tpch_node.cc:316``)."""
    global _TEXT_POOL
    if _TEXT_POOL is not None:
        return _TEXT_POOL
    target = _TEXT_POOL_BYTES
    rng = np.random.default_rng(0x7C9)  # pool seed is fixed: one pool
    chunks = []
    total = 0
    # average sentence ~45 bytes; batch generation until the target
    while total < target:
        want = max((target - total) // 45, 1 << 14)
        s = _sentences(rng, want)
        joined = b" ".join(s.tolist())
        chunks.append(np.frombuffer(joined, dtype=np.uint8))
        total += len(joined)
    _TEXT_POOL = np.concatenate(chunks)[:target]
    return _TEXT_POOL


def _ragged_utf8(data: np.ndarray, lengths: np.ndarray) -> pa.Array:
    """Build a pyarrow string array from a flat uint8 pool + row lengths
    (one vectorized gather, no per-row Python)."""
    import pyarrow as pa
    offsets = np.zeros(len(lengths) + 1, dtype=np.int32)
    np.cumsum(lengths, out=offsets[1:])
    return pa.Array.from_buffers(
        pa.utf8(), len(lengths),
        [None, pa.py_buffer(offsets.tobytes()),
         pa.py_buffer(data.tobytes())])


def _comments(rng, n, lo, hi) -> pa.Array:
    """n pseudotext slices with lengths uniform in [lo, hi]
    (``tpch_node.cc:316`` GenerateComments)."""
    pool = _text_pool()
    lengths = rng.integers(lo, hi + 1, n).astype(np.int64)
    starts = rng.integers(0, len(pool) - hi, n)
    total = int(lengths.sum())
    row = np.repeat(np.arange(n), lengths)
    cum = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=cum[1:])
    pos = np.arange(total, dtype=np.int64) - cum[row]
    return _ragged_utf8(pool[starts[row] + pos], lengths)


def _vstring(rng, n, lo, hi) -> pa.Array:
    """V-string: random-length strings over the 64-char alphabet
    (``tpch_node.cc:600``)."""
    lengths = rng.integers(lo, hi + 1, n).astype(np.int64)
    total = int(lengths.sum())
    chars = _VSTR_ALPHABET[rng.integers(0, 64, total)]
    return _ragged_utf8(chars, lengths)


def _phones(rng, nationkey: np.ndarray) -> pa.Array:
    """(nationkey+10)-XXX-XXX-XXXX (``tpch_node.cc:617``)."""
    import pyarrow as pa
    n = len(nationkey)
    cc = (nationkey + 10).astype("U2")
    l1 = rng.integers(100, 1000, n).astype("U3")
    l2 = rng.integers(100, 1000, n).astype("U3")
    l3 = rng.integers(1000, 10000, n).astype("U4")
    out = np.char.add(np.char.add(np.char.add(
        np.char.add(np.char.add(np.char.add(cc, "-"), l1), "-"), l2),
        "-"), l3)
    return pa.array(out)


def _numbered(prefix: str, keys: np.ndarray) -> pa.Array:
    """'Prefix#%09d' names (C_NAME/S_NAME/O_CLERK)."""
    import pyarrow as pa
    return pa.array(np.char.add(
        prefix + "#", np.char.zfill(keys.astype("U9"), 9)))


def _dict_col(rng, n, vocab):
    import pyarrow as pa
    idx = rng.integers(0, len(vocab), n).astype(np.int32)
    return pa.DictionaryArray.from_arrays(
        pa.array(idx), pa.array(vocab, type=pa.string()))


def _date32(days):
    import pyarrow as pa
    return pa.array(days.astype(np.int32), type=pa.int32()).cast(
        pa.date32())


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    """(90000 + ((pk/10) % 20001) + 100*(pk%1000))/100
    (``tpch_node.cc:1060``)."""
    pk = partkey.astype(np.int64)
    return (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0


def _ps_suppkey(partkey: np.ndarray, i: np.ndarray, S: int) -> np.ndarray:
    """The spec's partsupp supplier formula (``tpch_node.cc:1185``)."""
    pk = partkey.astype(np.int64)
    return (pk + (i * ((S // 4) + (pk - 1) // S))) % S + 1


def _orders_skeleton(rng, sf):
    """Shared by orders + lineitem: per-order key, custkey, date, line
    count. Orderkeys are sparse (1/4 of the key space); custkeys ≡ 0
    (mod 3) never buy (clause 4.2.3)."""
    n_orders = max(int(_ORDERS_PER_SF * sf), 10)
    n_cust = max(int(_CUST_PER_SF * sf), 5)
    idx = np.arange(n_orders, dtype=np.int64)
    # dbgen spreads 8-row runs across a 32-key stride: keys 1..8 then
    # 33..40, ... -> exactly 1/4 of the key space is populated
    okey = (idx // 8) * 32 + (idx % 8) + 1
    ckey = rng.integers(1, n_cust + 1, n_orders)
    ckey = np.where(ckey % 3 == 0, np.where(ckey + 1 > n_cust,
                                            ckey - 1, ckey + 1), ckey)
    odate = rng.integers(_STARTDATE, _ENDDATE - 151 + 1, n_orders)
    nlines = rng.integers(1, 8, n_orders)
    return n_orders, okey, ckey, odate, nlines


def _lineitem_parts(rng, sf, n, l_odate):
    """The lineitem columns whose values orders must see (for
    O_TOTALPRICE / O_ORDERSTATUS): partkey/suppkey/qty/prices/dates."""
    n_part = max(int(_PART_PER_SF * sf), 5)
    n_supp = max(int(_SUPP_PER_SF * sf), 3)
    partkey = rng.integers(1, n_part + 1, n)
    suppkey = _ps_suppkey(partkey, rng.integers(0, 4, n), n_supp)
    qty = rng.integers(1, 51, n).astype(np.float64)
    extprice = np.round(qty * _retailprice(partkey), 2)
    discount = rng.integers(0, 11, n) / 100.0
    tax = rng.integers(0, 9, n) / 100.0
    shipdate = l_odate + rng.integers(1, 122, n)
    commitdate = l_odate + rng.integers(30, 91, n)
    receiptdate = shipdate + rng.integers(1, 31, n)
    return (partkey, suppkey, qty, extprice, discount, tax, shipdate,
            commitdate, receiptdate)


def _finish(cols: dict, comment: str, make_comment, columns):
    """The table of ``cols`` and, drawn last, its comment column, with
    only ``columns`` (all if None). The comment is not drawn when it is
    not asked for: it is the costliest column, and the columns drawn
    before it keep their values."""
    import pyarrow as pa
    if columns is None or comment in columns:
        cols[comment] = make_comment()
    t = pa.table(cols)
    return t if columns is None else t.select(list(columns))


def tpch_table(name: str, scale_factor: float = 0.01,
               seed: int = 42, columns=None) -> pa.Table:
    """Generate one TPC-H table as a pyarrow.Table; with ``columns``, only
    those (a comment drawn last is then skipped unless named)."""
    import pyarrow as pa
    rng = np.random.default_rng(seed + TPCH_TABLES.index(name))
    sf = scale_factor
    n_cust = max(int(_CUST_PER_SF * sf), 5)
    n_part = max(int(_PART_PER_SF * sf), 5)
    n_supp = max(int(_SUPP_PER_SF * sf), 3)

    if name == "region":
        return _finish({
            "r_regionkey": pa.array(range(5), type=pa.int64()),
            "r_name": pa.array(_REGIONS),
        }, "r_comment", lambda: _comments(rng, 5, 31, 115), columns)

    if name == "nation":
        return _finish({
            "n_nationkey": pa.array(range(25), type=pa.int64()),
            "n_name": pa.array(_NATIONS),
            "n_regionkey": pa.array(_NATION_REGION, type=pa.int64()),
        }, "n_comment", lambda: _comments(rng, 25, 31, 114), columns)

    if name == "supplier":
        k = np.arange(1, n_supp + 1, dtype=np.int64)
        nationkey = rng.integers(0, 25, n_supp)
        comments = _comments(rng, n_supp, 25, 100)
        # Q16 special rows: 5*SF "Customer Complaints" + 5*SF
        # "Customer Recommends" (tpch_node.cc:2423)
        n_special = max(int(5 * sf), 1)
        marks = rng.choice(n_supp, size=min(2 * n_special, n_supp),
                           replace=False)
        py = comments.to_pylist()
        for j, row in enumerate(marks):
            tag = ("Customer Complaints" if j < n_special
                   else "Customer Recommends")
            base = py[row]
            py[row] = (base[:max(len(base) - len(tag), 0)] + tag)
        return _finish({
            "s_suppkey": pa.array(k),
            "s_name": _numbered("Supplier", k),
            "s_address": _vstring(rng, n_supp, 10, 40),
            "s_nationkey": pa.array(nationkey, type=pa.int64()),
            "s_phone": _phones(rng, nationkey),
            "s_acctbal": pa.array(
                np.round(rng.uniform(-999.99, 9999.99, n_supp), 2)),
        }, "s_comment", lambda: pa.array(py, type=pa.string()), columns)

    if name == "customer":
        k = np.arange(1, n_cust + 1, dtype=np.int64)
        nationkey = rng.integers(0, 25, n_cust)
        return _finish({
            "c_custkey": pa.array(k),
            "c_name": _numbered("Customer", k),
            "c_address": _vstring(rng, n_cust, 10, 40),
            "c_nationkey": pa.array(nationkey, type=pa.int64()),
            "c_phone": _phones(rng, nationkey),
            "c_acctbal": pa.array(
                np.round(rng.uniform(-999.99, 9999.99, n_cust), 2)),
            "c_mktsegment": _dict_col(rng, n_cust, _SEGMENTS),
        }, "c_comment", lambda: _comments(rng, n_cust, 29, 116), columns)

    if name == "part":
        k = np.arange(1, n_part + 1, dtype=np.int64)
        # P_NAME: 5 distinct colors per part — sample 5 without
        # replacement via per-row argsort of uniform keys
        keys = rng.random((n_part, len(_COLORS)))
        pick = np.argsort(keys, axis=1)[:, :5]
        colors = np.asarray(_COLORS)
        name_col = colors[pick[:, 0]]
        for j in range(1, 5):
            name_col = np.char.add(np.char.add(name_col, " "),
                                   colors[pick[:, j]])
        mfgr = rng.integers(1, 6, n_part)
        brand = mfgr * 10 + rng.integers(1, 6, n_part)
        return _finish({
            "p_partkey": pa.array(k),
            "p_name": pa.array(name_col),
            "p_mfgr": pa.DictionaryArray.from_arrays(
                pa.array((mfgr - 1).astype(np.int32)),
                pa.array([f"Manufacturer#{i}" for i in range(1, 6)])),
            "p_brand": pa.array(np.char.add("Brand#", brand.astype("U2"))
                                ).dictionary_encode(),
            "p_type": _dict_col(rng, n_part, _TYPES),
            "p_size": pa.array(rng.integers(1, 51, n_part),
                               type=pa.int64()),
            "p_container": _dict_col(rng, n_part, _CONTAINERS),
            "p_retailprice": pa.array(_retailprice(k)),
        }, "p_comment", lambda: _comments(rng, n_part, 5, 22), columns)

    if name == "partsupp":
        nps = n_part * 4
        pkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
        i = np.tile(np.arange(4, dtype=np.int64), n_part)
        return _finish({
            "ps_partkey": pa.array(pkey),
            "ps_suppkey": pa.array(_ps_suppkey(pkey, i, n_supp)),
            "ps_availqty": pa.array(rng.integers(1, 10000, nps),
                                    type=pa.int64()),
            "ps_supplycost": pa.array(
                np.round(rng.uniform(1.0, 1000.0, nps), 2)),
        }, "ps_comment", lambda: _comments(rng, nps, 49, 198), columns)

    if name == "orders":
        n_orders, okey, ckey, odate, nlines = _orders_skeleton(rng, sf)
        # derive totalprice/orderstatus from the SAME lineitem values the
        # lineitem table will generate (shared rng stream discipline)
        rng_l = np.random.default_rng(
            seed + TPCH_TABLES.index("lineitem"))
        n = int(nlines.sum())
        l_odate = np.repeat(odate, nlines)
        (_, _, _, extprice, discount, tax, shipdate, _, _) = \
            _lineitem_parts(rng_l, sf, n, l_odate)
        starts = np.cumsum(nlines) - nlines
        per_line = extprice * (1.0 + tax) * (1.0 - discount)
        total = np.round(np.add.reduceat(per_line, starts), 2)
        n_open = np.add.reduceat(
            (shipdate > _CURRENTDATE).astype(np.int64), starts)
        status_idx = np.where(n_open == 0, 0,
                              np.where(n_open == nlines, 1, 2)
                              ).astype(np.int32)  # F / O / P
        clerks = rng.integers(1, max(int(1000 * sf), 1) + 1, n_orders)
        return _finish({
            "o_orderkey": pa.array(okey),
            "o_custkey": pa.array(ckey, type=pa.int64()),
            "o_orderstatus": pa.DictionaryArray.from_arrays(
                pa.array(status_idx), pa.array(["F", "O", "P"])),
            "o_totalprice": pa.array(total),
            "o_orderdate": _date32(odate),
            "o_orderpriority": _dict_col(rng, n_orders, _PRIORITIES),
            "o_clerk": _numbered("Clerk", clerks),
            "o_shippriority": pa.array(np.zeros(n_orders, np.int64)),
        }, "o_comment", lambda: _comments(rng, n_orders, 19, 78), columns)

    if name == "lineitem":
        # regenerate the SAME skeleton the orders table used
        rng_o = np.random.default_rng(seed + TPCH_TABLES.index("orders"))
        n_orders, okey, _, odate, nlines = _orders_skeleton(rng_o, sf)
        n = int(nlines.sum())
        l_okey = np.repeat(okey, nlines)
        l_odate = np.repeat(odate, nlines)
        first = np.repeat(np.cumsum(nlines) - nlines, nlines)
        linenumber = np.arange(n, dtype=np.int64) - first + 1
        (partkey, suppkey, qty, extprice, discount, tax, shipdate,
         commitdate, receiptdate) = _lineitem_parts(rng, sf, n, l_odate)
        linestatus_idx = (shipdate > _CURRENTDATE).astype(np.int32)
        rf = rng.integers(0, 2, n).astype(np.int32)  # R or A when returned
        returnflag_idx = np.where(receiptdate <= _CURRENTDATE, rf,
                                  2).astype(np.int32)
        return _finish({
            "l_orderkey": pa.array(l_okey),
            "l_partkey": pa.array(partkey, type=pa.int64()),
            "l_suppkey": pa.array(suppkey, type=pa.int64()),
            "l_linenumber": pa.array(linenumber),
            "l_quantity": pa.array(qty),
            "l_extendedprice": pa.array(extprice),
            "l_discount": pa.array(discount),
            "l_tax": pa.array(tax),
            "l_returnflag": pa.DictionaryArray.from_arrays(
                pa.array(returnflag_idx), pa.array(["R", "A", "N"])),
            "l_linestatus": pa.DictionaryArray.from_arrays(
                pa.array(linestatus_idx), pa.array(["F", "O"])),
            "l_shipdate": _date32(shipdate),
            "l_commitdate": _date32(commitdate),
            "l_receiptdate": _date32(receiptdate),
            "l_shipinstruct": _dict_col(rng, n, _INSTRUCT),
            "l_shipmode": _dict_col(rng, n, _MODES),
        }, "l_comment", lambda: _comments(rng, n, 10, 43), columns)

    raise KeyError(f"unknown TPC-H table {name!r}")
