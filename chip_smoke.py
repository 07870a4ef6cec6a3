#!/usr/bin/env python3
"""Smoke test of the PyTorch port (arrow_tpu_torch) on one NVIDIA GPU.

Builds the CUDA kernels from csrc/, checks each kernel against its plain
PyTorch version on the card, then drives the slices of the port at 100M
rows (BASELINE config #2) and checks each result against a numpy oracle:

  path 1  ``arrow_tpu_torch.entry.entry``: compaction-kernel filter ->
          dense group-by kernel (1K distinct int64 keys, float32 values);
  path 2  ``arrow_tpu_torch.entry.entry_generic``: take-index filter on the
          tile-compaction and tile-stitch kernels -> sort-grouping consume
          (3M distinct keys, float64 values, 4M-slot state);
  path 3a ``arrow_tpu_torch.entry.entry_distributed``: the distributed
          group-by over 8 logical shards of the card (1M distinct keys):
          per-shard filter + pre-aggregation, state-row exchange on the
          partition-histogram kernel, merge;
  path 3b ``arrow_tpu_torch.parallel.shuffle.shuffle_batch``: the raw-row
          exchange of the same batch by key hash over 4 logical shards,
          and one shard's send side of the same exchange over 8;
  path 3m path 3a's group-by across processes (``parallel/multihost``):
          2 worker processes x 4 logical shards of the card in one gloo
          group (the card's tensors through pinned host buffers; the
          exchange one ``all_to_all_single``), each process's Table row for
          row against path 3a's; then ``dryrun_multichip``'s five checks
          and path 7b's Declaration on its first two lineitem batches
          (against numpy) across the two processes; per process its step
          ms, the bytes it sent to the other, the collectives' ms, peak
          memory, its kernel calls against their plain versions; run
          after path 7b;
  path 3n path 3a's group-by in one worker process over 8 logical shards,
          the exchange through a one-rank NCCL group, against path 3a's
          Table row for row;
  path 4  ``arrow_tpu_torch.entry.entry_sort``: a two-key stable sort of
          100M rows (int64 ascending, int32 with 5 % nulls descending,
          nulls last) and the take through it: path 4d with an int32 in
          the string key's place;
  path 4d ``arrow_tpu_torch.entry.entry_sort_dict`` (BASELINE config #3
          without path 4's cut): 100M rows sorted by a dictionary<int32,
          utf8> key over 1,000 values ``cat%04d`` (5 % null) ascending,
          then int64 ``i`` descending, nulls last, against numpy's stable
          sort of the dictionary ranks;
  path 5a ``arrow_tpu_torch.entry.entry_join`` (BASELINE config #4): inner
          join of a 100M-row probe side against 2^20 unique build keys, a
          quarter of the probe rows matching (route "packed_u");
  path 5b the same with Zipf(1.5)-skewed probe keys (every row matches);
  path 5c the other routes at 10M probe rows: duplicate build keys
          ("packed"), two wide keys ("sort"), and left semi / left anti /
          full outer + finish on the packed route;
  path 1b path 1 with 100,000 distinct keys: the sorted dense reduction;
  path 6  ``arrow_tpu_torch.entry.entry_q3`` (BASELINE config #5): the
          Q3-shaped Declaration (filter -> hashjoin -> hashjoin -> project
          -> aggregate -> order_by -> fetch) through the plan engine over
          100M lineitem, 25M orders and 2.5M customer rows in 2^22-row
          batches, against a numpy oracle; per plan node its device ms and
          host reads. Cut against config #5: 100M lineitem rows, not SF100's
          600M; one card, no ``dist=``; dates and the segment are int32
          codes, not dictionary strings;
  path 6s path 6's Declaration and tables with customer's segment as
          TPC-H's ``c_mktsegment``, a dictionary<int32, utf8> of the five
          segment names, filtered by ``== "BUILDING"``, against path 6's
          oracle; every call of its four kernels against its plain version;
  path 6b a table_source -> filter -> hashjoin Declaration on two wide
          int64 keys (2^20 build x 10M probe rows, the "sort" route), which
          runs the Bloom pushdown;
  path 7b path 6's Declaration on path 6's tables with ``dist=`` over 8
          logical shards of the card: both joins ``DistHashJoin``, the
          aggregate the state-row exchange, against path 6's oracle;
  path 7a ``arrow_tpu_torch.entry.dryrun_multichip`` over 8 logical
          shards: distributed group-by, join, sort, one hot key and the Q3
          Declaration with ``dist=``, each against numpy or pyarrow;
  path 7c ``arrow_tpu_torch.entry.entry_dist_join``: ``DistContext.join``
          inner of 2^20 build rows and 25M probe rows (config #4's shape,
          the probe cut from 100M: the raw-row exchange's buffers);
  path 7d ``arrow_tpu_torch.entry.entry_dist_sort``: ``DistContext.sort_by``
          of config #3's columns at 25M rows (cut from 100M as 7c is);
  path 7s path 7b with path 6s's segment: ``entry_q3_dist(...,
          segment="BUILDING")``'s step on path 6's orders, path 6s's
          customer table and the first 6 batches of path 6's lineitem
          (25,165,824 rows),
          ``c_mktsegment`` a dictionary<int32, utf8> whose codes cross the
          exchange; against numpy's oracle for those rows (cut from
          100M rows for the script's time limit);
  path 7e ``arrow_tpu_torch.entry.entry_dist_sort_dict``: path 7d with path
          4d's dictionary string in ``k2``'s place (BASELINE config #3
          across shards, 25M rows): ``k1`` ascending, then ``s`` over
          ``cat%04d`` (5 % null) descending, nulls last, against numpy's
          stable sort of the ranks, index for index;
  path 3s ``arrow_tpu_torch.entry.entry_dist_dict``: path 3a keyed by
          ``name``, a dictionary<int32, utf8> over 1,000,000 TPC-H
          ``C_NAME`` values: the state-row exchange hashes, and the merge
          keys, the codes by their content lanes; against path 3a's numpy
          oracle by index;
  path 8  ``arrow_tpu_torch.entry.entry_strings``: config #2's filter ->
          group-by of 100M rows keyed by a raw string column, TPC-H's
          ``C_NAME`` form ``Customer#%09d`` (18 bytes, a 1.8 GB pool) of
          1,000,000 customer keys: the one-launch filter compacts the
          columns and the row lengths, a second launch the byte pool; the
          group-by keys the strings' fingerprint content lanes; against a
          numpy oracle grouped by the customer key, each B1 call against
          its plain version, the filter and its pool compaction timed;
          then the name column sorted (``sort_indices_batch``) and
          compared row by row with itself in that order
          (``compare_varlen``, Array vs Array), each against the
          customer keys' order, with its peak under 40 GB;
  path 1c ``arrow_tpu_torch.entry.entry_any_all``: path 1's filter ->
          dense group-by with count_all, sum(v), min(w) and any / all of a
          bool column ``f`` (5 % null; False for keys = 1 mod 4, True for
          keys = 0 mod 4): one B1 and one B3 launch, the bool aggregates
          as B3's ``any8`` / ``all8`` kinds; against a numpy oracle, any /
          all and their nulls exactly; B3's call held against its plain
          version, timed, and its two bool kinds alone beside a PyTorch
          ``scatter_reduce_`` "amax" over an int32 copy;
  path 9  ``arrow_tpu_torch.entry.entry_groupby_q6``: db-benchmark's groupby
          q6 ("median v3 sd v3 by id4 id5") on its table G1_1e8_1e2_0_0
          (nine columns, 10^8 rows, made from the seed) through
          ``Table.group_by``: the exact median and the sample sd of 10,000
          groups against numpy's (1e-12 and 1e-9 relative), with the
          device ms of its layers (route probe, sort, the sd's and the
          median's consume, the median's finalize);
  path 3q ``arrow_tpu_torch.entry.entry_dist_groupby_q6``: q6 over 4 logical
          shards through ``DistContext.group_by`` (the median's state is not
          row-shaped: the raw-row exchange, one B4 and one
          ``partition_positions`` launch), against path 9's oracle with the
          groups as a set; both exchange kernels at its call held against
          their plain versions and timed;
  path 10 ``arrow_tpu_torch.entry.entry_q13``: TPC-H Q13 at SF 10 (1.5M
          customer, 15M orders rows of the port's generator; cut from SF
          100: the host generator and the host regex) through the plan
          engine: orders filtered by ``o_comment`` not matching
          ``special.*requests`` (the regex's host hop: the pushdown's
          device distinct finds too many uniques, then the direct hop, one
          an orders batch), customer left outer join orders, count by
          customer, count_all by count, ordered; against pyarrow's run of
          the same query, exactly;
  path 11 ``arrow_tpu_torch.entry.entry_q22``: TPC-H Q22 on path 10's
          tables: the country code ``utf8_slice_codeunits(c_phone, 0, 2)``
          on the card, a scalar average read once, a left anti join
          against orders, count and sum by the 2-byte code; against
          pyarrow (counts exact, sums within 1e-12 relative);
  path 12d bench.py's host_boundary (``entry_host_boundary``) at 100M rows:
          ``match_substring_regex(s, "7x[12]?[0-9]$")`` then the filter,
          ``s`` a dictionary of its 4,096 words (the regex over the
          dictionary, one take by code); path 12p the same with ``s`` a
          plain varlen column (the pushdown: a distinct of 100M strings on
          the card, RE2 over the 4,096 unique slots on the host, one take
          by code); both against Python ``re`` over the words, indexed by
          the rows' codes;
  path 13 ``arrow_tpu_torch.entry.entry_q12``: TPC-H Q12 at SF 10 on
          path 10's orders and a lineitem of 60M rows (its five columns
          Q12 reads and Q7's three more, generated once without
          ``l_comment``): ``l_shipmode IN ('MAIL', 'SHIP')`` (``is_in``
          on the dictionary), date32 ranges, the join to orders, the
          CASE as ``cast(is_in(o_orderpriority, ...), int64)``, sums by
          ship mode; against pyarrow's run, exactly;
  path 14 ``arrow_tpu_torch.entry.entry_q7``: TPC-H Q7 at SF 10 on the
          same tables with supplier and nation: ``is_in`` on each nation
          side, five joins, the pair predicate, ``year(l_shipdate)`` on
          the card, revenue by (supp_nation, cust_nation, l_year);
          against pyarrow (keys exact, revenue within 1e-12 relative);
  path 15 ``arrow_tpu_torch.entry.entry_wordcount``: HiBench's WordCount
          over path 10's 15M ``o_comment`` rows (``utf8_split_whitespace``
          on the card, its pool compacted by B1, ``list_flatten``, a
          count by the raw string word, ordered by count then word),
          against pyarrow's split, flatten and count;
  path 16 ``arrow_tpu_torch.entry.entry_baskets``: order baskets of
          paths 13 / 14's lineitem (``l_orderkey``, ``l_partkey``,
          ``l_linenumber``, ``l_quantity``; 60M rows into 15M groups):
          ``hash_list`` of the parts (2^26 buffer rows),
          ``hash_pivot_wider`` of the quantities by line number, the list
          and struct functions, a filter whose flat columns B1 compacts
          and whose list and struct columns B2 and the stitch take;
          against numpy (each basket a run of the sorted key);
  path 16r ``arrow_tpu_torch.entry.entry_ree_keys``: each batch of path
          16's ``l_orderkey`` run-end encoded (B2 and the stitch) and
          decoded, against its input and numpy's run ends;
  path 17 ``arrow_tpu_torch.entry.entry_sorted_merge``: paths 13 / 14's
          lineitem (``l_orderkey``, ``l_linenumber``, ``l_shipdate``,
          ``l_extendedprice``, the dictionary ``l_shipmode``) cut into 8
          sources by ``l_orderkey`` range, each sorted by (shipdate,
          orderkey, linenumber) on the card in set-up, in 2^22-row
          batches; the plan ``sorted_merge`` of the 8 ``table_source``
          nodes; against numpy: keys in order, the ids ``l_orderkey * 8 +
          l_linenumber`` a permutation of the input's, every payload its
          input row's, the dictionary decoded;
  path 17g ``arrow_tpu_torch.entry.entry_tpch_gen_q1``: TPC-H Q1 over the
          plan's own ``tpch_gen`` lineitem at SF 1 (the host generator in
          the step, only Q1's seven columns by the projection pushdown),
          against numpy's Q1 of the same table (keys and counts exact,
          sums and means within 1e-12 of the sums of |x|);
  paths 18 / 18f ``arrow_tpu_torch.entry.entry_asof``: the
          trades-and-quotes as-of join of 25M trades against 100M quotes
          of one 6.5-hour session over 8,192 symbols (2^22-row batches),
          ``asofjoin`` on ``ts`` by ``sym``, a quote at most 1 s old; 18f
          a tenth of the rows and a quote at most 1 s ahead; against
          numpy's searchsorted on the quotes sorted by (sym, ts): bid,
          ask and nulls exact;
  path 19 ``arrow_tpu_torch.entry.entry_decimal_q1``: paths 13 / 14's
          lineitem with ``l_quantity``, ``l_extendedprice``,
          ``l_discount``, ``l_tax`` as decimal128(15, 2) (and
          ``l_extendedprice`` at decimal128(38, 2), two limbs): Q1's
          filter and exact decimal sums by (returnflag, linestatus), the
          rows priced above 50000.00 (a decimal scalar) sorted by price
          descending and orderkey, their count by the decimal
          ``l_discount``; against numpy int64, exactly;
  path 20 ``arrow_tpu_torch.entry.entry_scan_q12``: TPC-H Q12 over dataset
          scans: set-up writes paths 13 / 14's lineitem (Q12's columns)
          with ``dataset.write_dataset`` as a hive-partitioned parquet
          dataset by ``l_shipmode`` and orders as one file; the step is
          Q12's plan with ``scan`` sources (``is_in(l_shipmode, ...)``
          prunes 5 of 7 fragments on the host, the date conjuncts run on
          the card); against path 13's result and pyarrow's, exactly;
          fragments read and pruned, bytes read, the scan's share;
  path 21 ``arrow_tpu_torch.entry.entry_disk_sort``: the external sort of
          path 17's lineitem columns (``l_shipmode`` a plain string, so a
          byte pool goes to disk too) in 2^22-row batches staged as they
          are pulled, by (shipdate, orderkey, linenumber) with a budget of
          1/8 of the input's device bytes (a sorted ATB run a batch,
          merged back), consumed through ``to_batches_prefetched``; row
          for row against the same sort in memory on the card and
          numpy's stable sort; each run's peak device memory is taken
          above the bytes held before it, and the in-memory sort's must
          be the higher; the output's live and allocated bytes; a second
          run stopped by a ``StopSource`` after the first merged batch
          raises ``CancelledError`` and leaves no run directory;
  path 22 ``arrow_tpu_torch.entry.entry_partitioned_join``: the Grace
          join of SF 10's orders (the build side, 15M rows) and lineitem
          (60M) on the order key with a budget of 1/4 of the orders'
          bytes: both sides split into 16 partition files on the card (B4
          and ``partition_positions``, one launch each a batch), joined
          partition by partition; both outputs sorted by (l_orderkey,
          l_linenumber) on the card, equal column for column to the
          in-memory join's; its peak above the bytes held before it
          (the inputs and the in-memory join's output) below the
          in-memory join's above its own; a left anti and a full outer
          join on about a
          tenth of each table (rows without a match on both sides)
          against their in-memory runs; the tracing metrics after paths
          20-22 as a JSON line ``{"metrics": ...}``;
  path 23 ``engine.declaration_to_substrait`` / ``engine.run_query``:
          path 6's Q3 Declaration on its tables serialized as a binary
          Substrait plan and as its JSON form, each run by ``run_query``
          on the card with the default driver, against path 6's numpy
          oracle and path 6's Table row for row (run after path 6);
  path 24 an Avro scan: TPC-H's orders at SF 1 (``o_orderkey``,
          ``o_orderstatus``, ``o_totalprice``, ``o_orderdate``) written
          by a worker process (no card) as 4 deflate Avro files while
          paths 1-22 run, then read through ``dataset`` by a scan ->
          filter (1995) -> aggregate (count, sum of ``o_totalprice`` by
          status) plan on the card, against numpy on the same rows; the
          host's decode and staging apart from the rest (run after path
          22);
  path 25 the plan drivers side by side: path 6's Q3 and path 13's Q12
          each eager (the default), fused (``to_table(fused=True)``;
          each lineitem morsel of a recurring shape after the first
          replays a CUDA graph of its segment where the plan's shape
          allows: Q3's) and lazy, each against its oracle and all three
          row for row; per driver its step's ms, its host reads (torch's
          sync debug mode counts them; the fused Q3's at most
          ``Q3_FUSED_SYNCS``), the graphs captured and replayed, its
          launches (replays counted); every B1 and B2 call captured in
          one more fused Q3 run against its plain version on the inputs
          of its graph's last replay; a fused Q12 whose deferred check fires (a one-slot
          group table) and falls back; and a learned probe route
          unlearned (ROADMAP C2) when the data changes under it (path 6's
          first 2 lineitem batches, the order keys spread past 30 bits);
  the graph replay phase: ONE CUDA graph holding a B1 call and a B4 +
          ``partition_positions`` pair, replayed 3 times on new data, each
          replay's outputs against the plain versions, an eager B1 call
          between replays (``graph_replay_phase``);
  the string sweep: the string family's 71 functions
          (``entry.STRING_SWEEP``, the unit tests' options) once each on
          the card over the first 2^18 rows of path 10's ``o_comment``
          (one in 16 a non-ASCII string of the unit tests', one in 97
          null), each byte for byte against the port's CPU result on the
          same rows (the CPU's run once every card call is timed, after
          every path, ``SWEEP_CPU_WORKERS`` functions at a time); its
          device ms and the peak above the input;
  the A7b sweep: the 83 functions of the casts, temporal functions,
          checked arithmetic, vector_misc and set lookup, and ``cast``
          over every pair of types it dispatches (``cast:<src>-><dst>``),
          527 entries (``entry.A7B_SWEEP``) over 2^18-row columns made
          from the seed (``entry.a7b_sweep_columns``: every integer and
          float width, one row in 97 null; Q7's ``l_shipdate``; an
          instant over 1900-2100 with its nanosecond digits, naive, in
          New York and in Paris; times, durations, strings), each on the
          card against the CPU's run (once every card call is timed,
          ``SWEEP_CPU_WORKERS`` entries at a time): integers, bools,
          dates, offsets and bytes byte for byte, floats within the
          entry's stated ulps
          or 1e-12 (float32: 1e-5) times the running sum of |x|; and
          ``add_checked`` past INT64_MAX raising ``ArrowInvalid`` on
          both devices;
  the A7c sweep: the 19 functions of the nested layouts, ``ree`` and
          ``pivot``, take / filter / concat of list, fixed-size-list, map,
          struct and union columns, ``hash_list`` and ``hash_pivot_wider``
          through ``Table.group_by``, the pivot_longer node and the sparse
          tensors' to_dense / mv / mm (``entry.A7C_SWEEP``) over 2^18-row
          columns made from the seed and a 4096^2 matrix at 1 %, each on
          the card against the CPU's run (as the A7b sweep's): exact, the
          products within
          1e-12 of |A| |x|, ``random`` by its range and its seed.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

The filter kernel B1 (``filter_compact_columns``: one launch compacts a
batch's columns as they lie) is held against its plain version first on
synthetic calls (every column width in one launch, caps that end mid
tile, misaligned and strided views, 70 columns in three launches, the
one-matrix form ``filter_compact_chunks`` up to 100M x 20 B), then at every
call paths 1, 1b, 3a, 3s, 5c, 6, 6b, 7a-7e and 7s make to it. The
exchange's two kernels, the partition histogram B4
(``partition_histogram_segments``: counts and tile offsets) and
``partition_positions`` (every row's slot in its bucket), are held
against their plain versions on synthetic calls (one segment and eight
of unequal lengths, misaligned views, buckets that hold all, some and
none of the rows), then at every call paths 3a,
3b, 3s, 7a-7e and 7s make to them: ONE launch of each a shuffle over all
the shards of the card, and no ``torch.sort`` inside the exchange's
``_bucket_rows``. Paths 3s, 7a-7e and 7s hold every call they make to B1,
the two exchange kernels and the key packing against its plain version,
and the launches those calls make against their counted runs'.

Paths 1-23 run their plans on the eager driver, ``to_table``'s default;
24 and 25 name theirs.

Paths 10-22 hold every call they make to B1, B2, the stitch,
``pack_key_lanes``, B3, B4 and ``partition_positions`` against its plain
version. Prints the card's
name and power limit, one line per check, a JSON line ``{"sweep": {...}}``
(each entry of both sweeps: ms and peak), a JSON line ``{"paths": {...}}`` (each path's counted step: ms and peak device bytes;
path 1 also its filter layer's device ms, the expression excluded), a JSON
line ``{"kernels": [...]}`` (the four kernels that stand for the JAX package's
Pallas kernels, the tile stitch and the join's key packing, which stand for
passes it leaves to XLA, and the bucket positions, which stand for its
exchange's stable sort by destination) with each kernel's launches on its path's counted
run and, at the arguments that path gave it, its error against the plain
version, its time, the plain version's, the least time the card could take
(``bound_ms``: bytes moved over the memory rate) and the time of one
PyTorch call computing the same function (``library_ms``, null where there
is none); a kernel that further paths launch carries the same numbers at
their arguments under suffixed keys (``ms_path_3b``,
``ms_path_5c_left_semi`` ...: every call path 5c's semi, anti and outer
joins make is held against the plain version too, and every call of path
6's four kernels), and the dense group-by
kernel also those of the twelve-stream call the earlier slices made
(``ms_nine_kinds`` ...). B1's entries also carry, at each call,
``device_ms`` (the calls queued behind a sleep: the card's time alone;
``arrow_tpu_torch.bench_reductions.measure_filter`` times them), ``host_ms``
(the host's time to issue one call), ``columns_index_ms`` (one ``c[sel]``
per column; its ``library_ms`` is ``chunks[sel]`` on the columns packed as
u8 planes side by side, the JAX caller's form) and ``widths`` (the bytes a
row of each column); B4's and ``partition_positions``' the same
``device_ms`` and ``host_ms``, and ``rows`` and ``segments`` (the call's
shards). Last comes
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when there is no
CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

try:
    from arrow_tpu_torch.bench_reductions import (
        HBM_BYTES_PER_S, check_filter, cuda_ms, fc_widths, measure_filter,
        measure_hist, measure_positions)
except ImportError as e:
    sys.exit(f"chip_smoke: arrow_tpu_torch not importable ({e}); run from "
             "the repository root")

N_ROWS = 100_000_000
NUM_KEYS = 1000
# f32 sums: atomics and numpy's float64 bincount add in other orders
SUM_RTOL = 1e-5         # times the sum of |x| in the slot
SUM_ATOL_KERNEL = 1e-6  # kernel vs plain version
SUM_ATOL_SLICE = 1e-3   # slice vs numpy oracle
# path 2
NUM_KEYS_GENERIC = 3_000_000
MAX_GROUPS_GENERIC = 1 << 22
# f64 sums: the port adds each group's rows in sorted order, numpy's
# bincount in input order
SUM64_RTOL = 1e-12      # times the sum of |v| in the group
SUM64_ATOL = 1e-12
# path 3
NUM_KEYS_DIST = 1_000_000
N_SHARDS = 8
MAX_GROUPS_PER_SHARD = 1 << 21
# The raw-row exchange allocates, per shard, send and receive buffers of
# P * B = 2 * N_ROWS rows per leaf (B = 2 x the local capacity) and a result
# of the same capacity: 4.8 GB each at 24 B a row. With 8 shards the send
# buffers and the results alone are 77 GB, so path 3b runs 4 shards; rows,
# keys and the bucket factor are not cut.
N_SHARDS_RAW = 4
# paths 3m / 3n: path 3a's rows; path 7b's lineitem batches Q3 reads
N_ROWS_3M = N_ROWS
Q3M_BATCHES = 2
DIST_TIMEOUT = 240             # seconds for a path's worker processes
# path 4 (sort) and path 5 (join)
NUM_KEYS_SORT = 1_000_000
N_BUILD = 1 << 20
N_PROBE_ROUTES = 10_000_000     # path 5c's probe depth
BUILD_KEYS_DUP = 1 << 18        # path 5c: 2^20 build rows over 2^18 keys
# path 1b
NUM_KEYS_SORTED_DENSE = 100_000
MAX_GROUPS_SORTED_DENSE = 1 << 17
# path 6 (BASELINE #5 cut to 100M lineitem rows) and 6b
N_LINEITEM = 100_000_000
# path 7s: path 7b's plan on the first 6 of its lineitem batches (cut from
# path 6's 100M rows: the script's time limit)
N_LINEITEM_7S = 25_000_000
Q3_BATCH_ROWS = 1 << 22         # the JAX package's Q3 bench (bench.py)
Q3_MAX_GROUPS = 1 << 22         # holds path 6's ~3.8M groups: no replay
BLOOM_LV_MIN = -1.0             # path 6b's probe filter keeps 84 % of rows
# paths 7c (BASELINE #4's join) and 7d (BASELINE #3's sort) over 8 logical
# shards. The raw-row exchange holds, per side, (P, B) send buffers, their
# stacked receive and its compaction: 2n x the local capacity rows each
# (3n x for the sort's bucket factor 3), so 100M probe rows would need
# about 66 GB and 100M sort rows 150 GB: both run 25M rows (ROADMAP P5,
# buffers sized by the counts, would lift the cut)
N_PROBE_DIST = 25_000_000
N_SORT_DIST = 25_000_000
SORT_BUCKET_FACTOR = 3
# path 4d: BASELINE #3's dictionary of "cat%04d" values
NUM_VALUES_DICT = 1000
# path 8: C_NAME strings of 1M customer keys, a 2^21-slot state
NUM_KEYS_STRINGS = 1_000_000
MAX_GROUPS_STRINGS = 1 << 21
# paths 9 and 3q: db-benchmark groupby G1_1e8_1e2_0_0, question q6
Q6_K = 100
Q6_MEDIAN_RTOL = 1e-12  # the interpolation's last ulp
Q6_SD_RTOL = 1e-9
N_SHARDS_Q6 = 4
# paths 10 and 11: TPC-H Q13 and Q22 at SF 10 (cut from SF 100: the host
# generator and Q13's host regex); path 12: bench.py's host_boundary at
# 100M rows (its own cut there is 2M); the string and A7b sweeps over
# 2^18 rows (cut from 2^20: their CPU sides are host time, and paths 20-22
# need it inside the script's time limit)
TPCH_SF = 10
TPCH_SEED = 42
HB_SEED = 7
N_SWEEP = 1 << 18
SWEEP_PEAK_BYTES = 24e9
# the sweeps' CPU results, computed this many entries at a time once
# every card call is timed
SWEEP_CPU_WORKERS = 4
# the A7c sweep's rows (cut from 2^20 as the others); its sparse
# products' float64 tolerance, times |A| |x| (cuSPARSE and the CPU add in
# other orders)
N_A7C = 1 << 18
A7C_PRODUCT_RTOL = 1e-12
# path 17g: the generator in the step runs on the host three times (the
# warm-up, the counted run, the recording run): SF 1, cut from SF 10
TPCH_GEN_SF = 1.0
# path 18: a session of 100M quotes and 25M trades, a quote at most 1 s
# old; path 18f a tenth of the rows, a quote at most 1 s ahead
N_QUOTES = 100_000_000
N_TRADES = 25_000_000
ASOF_TOLERANCE = -1_000_000_000
# the kernel phase under capture: one graph of a B1 call and a B4 +
# positions pair at path 6's batch rows, replayed on new data
GRAPH_ROWS = 1 << 22
GRAPH_P = 16
GRAPH_REPLAYS = 3
# paths 23-25: the plan drivers ``entry.plan_driver`` names; path 25's
# unlearning on path 6's first lineitem batches, its keys spread by a
# factor past the packed route's 30 bits
PLAN_DRIVERS = ("eager", "fused", "lazy")
# the synchronising operations of path 25's fused Q3 run (measured 3 by
# tools/torch_fused_q3_ab.py on an H100 80GB HBM3 at 700 W): the driver's
# ONE read at the end, and a scalar's copy from pageable memory
# (``kernel_utils.host_to_device``) in each of the two morsels of one
# segment that run as plain calls (its first, its tail); a run that makes
# more fails
Q3_FUSED_SYNCS = 3
Q3_UNLEARN_BATCHES = 2
Q3_KEY_SPREAD = 1 << 20
# path 24: TPC-H's orders at SF 1 (cut from SF 10: the Avro decoder is
# pure Python on the host) as 4 deflate files
AVRO_SF = 1.0
AVRO_FILES = 4
AVRO_WRITER_TIMEOUT = 900


def counted_syncs(torch, fn):
    """(fn(), the synchronizing CUDA operations it made): torch's sync
    debug mode warns once at each (a device-to-host copy, ``item``,
    ``nonzero``, a stream synchronisation), and the warnings are counted:
    the host reads of a plan run, whichever module made them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res, sum("synchroniz" in str(w.message) for w in seen)


def replayed_calls_agree(torch, ck, selection, run, label: str):
    """``run()`` with B1's and B2's wrappers in ``selection`` recording
    every call made while a graph is captured, its inputs and outputs
    (held, so the graph's memory pool does not reuse them): after the run
    they hold what the last replay of their graph gave, and each call's
    outputs are held against its plain version on those inputs. Returns
    (run's result, the calls checked of each wrapper)."""
    names = ("filter_compact_columns", "tile_compact_local")
    calls = {n: [] for n in names}
    inner = {n: getattr(selection, n) for n in names}

    def wrap(n):
        def rec(*a):
            out = inner[n](*a)
            if torch.cuda.is_current_stream_capturing():
                calls[n].append((a, out))
            return out
        return rec
    for n in names:
        setattr(selection, n, wrap(n))
    try:
        res = run()
    finally:
        for n in names:
            setattr(selection, n, inner[n])
    torch.cuda.synchronize()
    for (sel, cols), (outs, count) in calls["filter_compact_columns"]:
        want, wn = ck.filter_compact_columns_plain(sel, cols)
        n = int(wn)
        check(int(count) == n and all(torch.equal(o[:n], w[:n])
                                      for o, w in zip(outs, want)),
              f"{label}: a replayed B1 call differs from its plain version")
    for (sel,), (loc, counts) in calls["tile_compact_local"]:
        wl, wc = ck.tile_compact_local_plain(sel)
        check(torch.equal(loc, wl) and torch.equal(counts, wc),
              f"{label}: a replayed B2 call differs from its plain version")
    return res, {n: len(v) for n, v in calls.items()}


def graph_replay_phase(torch, ck, dev, gen) -> dict:
    """The kernels under capture: ONE CUDA graph holding a B1 call (three
    columns: int64, int32 and a (cap, 12) byte matrix) and a B4 +
    ``partition_positions`` pair, replayed GRAPH_REPLAYS times on new data
    copied into its inputs; after each replay its outputs against the
    plain versions on the same inputs, and an eager B1 call on the default
    stream between replays against them too (the graph's B1 scratch is its
    own: a replay with the frozen epoch and ticket base of a shared one
    would read the last replay's status words). The launches a capture
    adds (none) and each replay adds (the graph's three). Returns the
    report: replays, launches a replay, the graph's replay ms against the
    same calls made eagerly."""
    cap, P, B = GRAPH_ROWS, GRAPH_P, GRAPH_ROWS // GRAPH_P
    sel = torch.empty(cap, dtype=torch.bool, device=dev)
    cols = [torch.empty(cap, dtype=torch.int64, device=dev),
            torch.empty(cap, dtype=torch.int32, device=dev),
            torch.empty((cap, 12), dtype=torch.uint8, device=dev)]
    dest = torch.empty(cap, dtype=torch.int32, device=dev)

    def fill(r):
        sel.copy_(torch.rand(cap, generator=gen, device=dev) < 0.2 + 0.2 * r)
        cols[0].copy_(torch.randint(-(1 << 62), 1 << 62, (cap,),
                                    generator=gen, device=dev))
        cols[1].copy_(torch.randint(-(1 << 31), 1 << 31, (cap,),
                                    generator=gen, device=dev,
                                    dtype=torch.int32))
        cols[2].copy_(torch.randint(0, 256, (cap, 12), generator=gen,
                                    device=dev, dtype=torch.uint8))
        dest.copy_(torch.randint(-1, P + 1, (cap,), generator=gen,
                                 device=dev, dtype=torch.int32))

    def body():
        outs, count = ck.filter_compact_columns(sel, cols)
        counts, tiles = ck.partition_histogram_segments([dest], P)
        (pos,) = ck.partition_positions([dest], P, B, tiles)
        return outs, count, counts, pos

    def same(got, label):
        outs, count, counts, pos = got
        want, n = ck.filter_compact_columns_plain(sel, cols)
        n = int(n)
        check(int(count) == n and all(torch.equal(o[:n], w[:n])
                                      for o, w in zip(outs, want)),
              f"graph replay {label}: B1 differs from its plain version")
        wc, _ = ck.partition_histogram_segments_plain([dest], P)
        check(torch.equal(counts, wc), f"graph replay {label}: B4's counts "
              "differ from its plain version")
        (wp,) = ck.partition_positions_plain([dest], P, B)
        check(torch.equal(pos, wp), f"graph replay {label}: the positions "
              "differ from their plain version")
        return n

    fill(0)
    body()                  # loads the kernels
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    graph = ck.capture_graph(body)
    check(ck.LAUNCHES == before, "graph replay: the capture added launches")
    check(graph.launches == {"filter_compact_chunks": 1,
                             "partition_histogram": 1,
                             "partition_positions": 1},
          f"graph replay: the graph holds {graph.launches}")
    kept = []
    for r in range(GRAPH_REPLAYS):
        fill(r)
        got = graph.replay()
        torch.cuda.synchronize()
        kept.append(same(got, f"{r + 1}"))
        # an eager call on the default stream between replays
        outs, count = ck.filter_compact_columns(sel, cols)
        n = int(count)
        check(n == kept[-1] and all(torch.equal(o[:n], g[:n]) for o, g in
                                    zip(outs, got[0])),
              f"graph replay {r + 1}: the eager B1 call between replays "
              "differs")
    check(ck.LAUNCHES["filter_compact_chunks"] - before[
        "filter_compact_chunks"] == 2 * GRAPH_REPLAYS and
        ck.LAUNCHES["partition_histogram"] - before["partition_histogram"]
        == GRAPH_REPLAYS, f"graph replay: launches {ck.LAUNCHES}")
    replay_ms = cuda_ms(torch, graph.replay, 10)
    eager_ms = cuda_ms(torch, body, 10)
    print(f"graph replay phase: ONE graph of a B1 call ({cap} rows, 8, 4, "
          f"12 B) and a B4 + positions pair (P {P}, B {B}) replayed "
          f"{GRAPH_REPLAYS} times on new data, each replay's outputs equal "
          f"their plain versions (selected {kept}), an eager B1 call "
          f"between replays equal too; a replay {replay_ms:.4f} ms, the "
          f"same calls made eagerly {eager_ms:.4f} ms")
    return {"replays": GRAPH_REPLAYS, "launches_a_replay": graph.launches,
            "replay_ms": replay_ms, "eager_ms": eager_ms}


def q3_rows_agree(a, b, oracle, label: str) -> None:
    """Two Q3 Tables row for row: both against the numpy oracle
    (``check_q3``), their revenues within 1e-12 of each other at each
    place and their keys equal but at a tie the oracle allows."""
    check_q3(a, oracle, label)
    check_q3(b, oracle, label)
    ga, gb = (dict((c, t.batches[0].column(c).values[:10].cpu().numpy())
                   for c in ("l_orderkey", "o_date", "revenue"))
              for t in (a, b))
    tol = 1e-12 * np.abs(oracle["revenue"]) + 1e-12
    check(bool((np.abs(ga["revenue"] - gb["revenue"]) <= 2 * tol).all()),
          f"{label}: revenues differ row for row")
    tie = np.abs(oracle["all_revenue"][ga["l_orderkey"]] -
                 oracle["revenue"]) <= tol
    check(bool(((ga["l_orderkey"] == gb["l_orderkey"]) | tie).all()),
          f"{label}: keys differ row for row")


def driver_runs(torch, ck, fuse, run, label: str, drivers=PLAN_DRIVERS):
    """Each named driver of ``run(driver)``: a warm-up run, a timed run
    (ms and kernel launches, graph replays counted) and a run whose host
    reads are counted (``counted_syncs``; for the fused driver also its
    own reads, ``fuse.STATS``, and the graphs it captured and replayed).
    Returns ({driver: Table}, {driver: report})."""
    tables, report = {}, {}
    for d in drivers:
        run(d)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        run(d)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ck.LAUNCHES)
        fuse.reset_stats()
        tables[d], reads = counted_syncs(torch, lambda: run(d))
        st = dict(fuse.STATS)
        report[d] = {"ms": ms, "host_reads": reads,
                     "driver_reads": st["host_reads"],
                     "graphs": st["graphs"], "replays": st["replays"],
                     "fused_runs": st["fused"], "fallbacks": st["fallbacks"],
                     "launches": launches}
        print(f"{label} {d:5s}: {ms:10.3f} ms; host reads {reads} (the fused "
              f"driver's own {st['host_reads']}); graphs captured "
              f"{st['graphs']}, replayed {st['replays']}; fused runs "
              f"{st['fused']}, fallbacks {st['fallbacks']}; launches "
              f"{launches}")
    return tables, report


def write_avro_worker(root: str, scale_factor: float, seed: int) -> None:
    """Path 24's writer, run in a worker process (no card): TPC-H's orders
    at ``scale_factor`` as AVRO_FILES deflate Avro files under
    ``root``/files, and the numpy answer of the scan's plan over the same
    rows in ``root``/oracle.json."""
    import os
    from arrow_tpu_torch.entry import (AVRO_ORDERS_COLUMNS,
                                       avro_orders_numpy, write_avro_orders)
    from arrow_tpu_torch.utils.tpch import tpch_table
    t0 = time.time()
    source = tpch_table("orders", scale_factor, seed,
                        columns=AVRO_ORDERS_COLUMNS)
    t1 = time.time()
    paths = write_avro_orders(os.path.join(root, "files"), n_files=AVRO_FILES,
                              source=source)
    t2 = time.time()
    with open(os.path.join(root, "oracle.json"), "w") as f:
        json.dump({"answer": avro_orders_numpy(source),
                   "rows": source.num_rows, "generate_s": t1 - t0,
                   "write_s": t2 - t1,
                   "bytes": sum(os.path.getsize(p) for p in paths)}, f)


def q3_driver_paths(torch, ck, entry_mod, dev, tables, qcols, out6, oracle,
                    paths) -> dict:
    """Paths 23 (Q3 through Substrait) and 25 (Q3 through the three
    drivers, the unlearning of a learned route) on path 6's tables.
    Returns each counted run's launches."""
    from arrow_tpu_torch.acero import fuse
    from arrow_tpu_torch.engine import declaration_to_substrait, run_query
    from arrow_tpu_torch.ops import selection
    launches = {}
    # path 23: the plan serialized (protobuf, then JSON) and run by
    # run_query with the default driver
    for binary in (True, False):
        label = f"path 23 {'binary' if binary else 'JSON'}"
        t0 = time.perf_counter()
        plan, named = declaration_to_substrait(
            entry_mod.q3_declaration(*tables, Q3_MAX_GROUPS), binary=binary)
        ser_ms = (time.perf_counter() - t0) * 1e3
        size = len(plan) if binary else len(json.dumps(plan))
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_query(plan, named, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[label] = dict(ck.LAUNCHES)
        q3_rows_agree(got, out6, oracle, label)
        paths[label] = {"ms": ms, "serialize_ms": ser_ms, "plan_bytes": size}
        print(f"{label} (path 6's Q3 as a {size}-byte Substrait plan, "
              f"serialized in {ser_ms:.3f} ms, run by run_query on the "
              f"card, eager): {ms:.3f} ms (one run: the consumer's "
              f"capacities start from the options' defaults and grow); "
              f"the top 10 match the numpy oracle and path 6's Table row "
              f"for row; launches {launches[label]}")
        del got
    # path 25: the drivers side by side
    tabs, rep_ = driver_runs(torch, ck, fuse, lambda d: entry_mod.plan_driver(
        entry_mod.q3_declaration(*tables, Q3_MAX_GROUPS), d), "path 25 Q3")
    for d, t in tabs.items():
        q3_rows_agree(t, tabs["eager"], oracle, f"path 25 Q3 {d}")
        paths[f"path 25 Q3 {d}"] = {k: v for k, v in rep_[d].items()
                                    if k != "launches"}
        launches[f"path 25 Q3 {d}"] = rep_[d]["launches"]
    f = rep_["fused"]
    check(f["fused_runs"] == 1 and f["graphs"] >= 1 and f["replays"] >= 1
          and f["driver_reads"] == 1 and f["host_reads"] <= Q3_FUSED_SYNCS,
          f"path 25 Q3: the fused run {f}")
    # one more fused run: the B1 and B2 calls its graphs hold, against
    # their plain versions on the inputs of each graph's last replay
    t, checked = replayed_calls_agree(torch, ck, selection, lambda:
                                      entry_mod.plan_driver(
                                          entry_mod.q3_declaration(
                                              *tables, Q3_MAX_GROUPS),
                                          "fused"), "path 25 Q3 fused")
    q3_rows_agree(t, tabs["eager"], oracle, "path 25 Q3 fused, recorded")
    check(sum(checked.values()) >= 1, f"path 25 Q3: captured calls "
          f"{checked}")
    paths["path 25 Q3 fused"]["replayed_calls_checked"] = checked
    print(f"path 25 Q3 fused: the captured calls {checked}, each equal to "
          f"its plain version on its graph's last replay")
    del t
    # the unlearning (ROADMAP C2): the first lineitem batches and orders
    # with their keys spread past 30 bits; the route learned above
    # ("packed_u") is checked in the run, fires, is removed, and the next
    # run learns the sort route
    rows = Q3_UNLEARN_BATCHES * Q3_BATCH_ROWS
    li_np = {k: v[:rows] for k, v in qcols[0].items()}
    oracle_u = numpy_q3_oracle(li_np, qcols[1], qcols[2])
    li_u = dict(li_np, l_orderkey=li_np["l_orderkey"] * Q3_KEY_SPREAD)
    od_u = dict(qcols[1], o_orderkey=qcols[1]["o_orderkey"] * Q3_KEY_SPREAD)
    li_t = entry_mod.table_from_numpy(li_u, Q3_BATCH_ROWS, dev)
    od_t = entry_mod.table_from_numpy(od_u, Q3_BATCH_ROWS, dev)
    learned = dict(fuse._PLAN_IMPL)
    check("packed_u" in learned.values(), f"path 25: learned {learned}")
    runs = []
    for i in range(2):
        fuse.reset_stats()
        t, reads = counted_syncs(torch, lambda: entry_mod.plan_driver(
            entry_mod.q3_declaration(li_t, od_t, tables[2], Q3_MAX_GROUPS),
            "fused"))
        check_q3(t, oracle_u, f"path 25 unlearn {i}", Q3_KEY_SPREAD)
        runs.append(dict(fuse.STATS, host_reads_counted=reads))
        del t
    check(runs[0]["unlearned"] == 1 and runs[0]["fallbacks"] == 1 and
          runs[1]["fused"] == 1 and runs[1]["fallbacks"] == 0 and
          "sort" in fuse._PLAN_IMPL.values(),
          f"path 25 unlearn: {runs}, learned {fuse._PLAN_IMPL}")
    paths["path 25 unlearn"] = {"runs": runs}
    print(f"path 25 unlearn (the first {rows} lineitem rows, order keys "
          f"x {Q3_KEY_SPREAD}): the learned packed_u route's check fired, "
          f"the run fell back to the eager driver and matched the oracle, "
          f"the route was removed (unlearned {runs[0]['unlearned']}); the "
          f"next fused run bootstrapped and learned 'sort' (host reads "
          f"{runs[1]['host_reads_counted']}); {runs}")
    del li_t, od_t, tabs
    return launches


def q12_driver_paths(torch, ck, entry_mod, tables, want, paths) -> dict:
    """Path 25's Q12 on path 13's tables: the three drivers, each against
    pyarrow's answer, and one fused run whose deferred check fires (its
    aggregate's group table at one slot: TPC-H's order keys are unique, so
    the join takes the unique route, which has no fanout to overflow)."""
    from arrow_tpu_torch.acero import fuse
    tabs, rep_ = driver_runs(torch, ck, fuse, lambda d: entry_mod.plan_driver(
        entry_mod.q12_declaration(*tables), d), "path 25 Q12")
    launches = {}
    for d, t in tabs.items():
        check(t.to_pydict() == want, f"path 25 Q12 {d}: differs from "
              "pyarrow's")
        paths[f"path 25 Q12 {d}"] = {k: v for k, v in rep_[d].items()
                                     if k != "launches"}
        launches[f"path 25 Q12 {d}"] = rep_[d]["launches"]
    check(rep_["fused"]["fused_runs"] == 1, f"path 25 Q12: {rep_['fused']}")
    print(f"path 25 Q12 fused: {rep_['fused']['host_reads']} synchronising "
          f"operations against the driver's own "
          f"{rep_['fused']['driver_reads']}: a known departure from ONE "
          f"read a run (ROADMAP P13: ``is_in`` and the casts synchronise "
          f"inside each morsel), not checked")
    decl = entry_mod.q12_declaration(*tables)
    decl.inputs[0].options.max_groups = 1       # the aggregate's table
    fuse.reset_stats()
    t0 = time.perf_counter()
    got = entry_mod.plan_driver(decl, "fused")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(got.to_pydict() == want and fuse.STATS["fallbacks"] == 1,
          f"path 25 Q12 fallback: {fuse.STATS}")
    paths["path 25 Q12 fallback"] = {"ms": ms, **fuse.STATS}
    print(f"path 25 Q12 fallback (a one-slot group table): the fused run's "
          f"check fired, the eager driver re-ran the plan and matched "
          f"pyarrow's answer in {ms:.3f} ms in all; {fuse.STATS}")
    return launches


def avro_path(torch, ck, entry_mod, dev, root, writer, paths) -> dict:
    """Path 24: the Avro files the worker wrote, scanned through
    ``dataset`` into a scan -> filter -> aggregate plan on the card,
    against numpy on the same rows. Returns its launches."""
    from arrow_tpu_torch import dataset as ds_mod
    from arrow_tpu_torch.dataset.avro import read_avro
    t0 = time.time()
    rc = writer.wait(timeout=AVRO_WRITER_TIMEOUT)
    waited = time.time() - t0
    check(rc == 0, f"path 24: the Avro writer exited {rc}")
    with open(os.path.join(root, "oracle.json")) as f:
        info = json.load(f)
    files = sorted(os.listdir(os.path.join(root, "files")))
    check(len(files) == AVRO_FILES, f"path 24: files {files}")
    t0 = time.perf_counter()
    one = read_avro(os.path.join(root, "files", files[0]))
    decode_s = time.perf_counter() - t0
    ds = ds_mod.dataset(os.path.join(root, "files"))
    ds_mod.reset_stats()
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = entry_mod.avro_orders_declaration(ds, dev).to_table()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    got = out.to_pydict()
    want = info["answer"]
    check(sorted(got["o_orderstatus"]) == sorted(want), f"path 24: "
          f"statuses {got['o_orderstatus']}")
    for s_, n_, p_ in zip(got["o_orderstatus"], got["n"], got["price"]):
        wn, wp, wabs = want[s_]
        check(n_ == wn and abs(p_ - wp) <= 1e-12 * wabs + 1e-12,
              f"path 24 {s_}: {n_}, {p_} against {wn}, {wp}")
    check(launches["filter_compact_chunks"] > 0, "path 24: no B1 launch")
    st = dict(ds_mod.STATS)
    rows = info["rows"]
    paths["path 24"] = {"ms": secs * 1e3, "read_s": st["read_s"],
                        "decode_rows_per_s": one.num_rows / decode_s,
                        "rows": rows, "bytes": info["bytes"],
                        "writer_generate_s": info["generate_s"],
                        "writer_write_s": info["write_s"]}
    print(f"path 24 (TPC-H SF {AVRO_SF} orders, {rows} rows x 4 columns, "
          f"as {AVRO_FILES} deflate Avro files of {info['bytes']} B, "
          f"written by a worker in {info['generate_s']:.1f} + "
          f"{info['write_s']:.1f} s while paths 1-22 ran; {waited:.1f} s "
          f"waited for it): scan -> filter (1995) -> count and sum by "
          f"status in {secs:.3f} s, of which reading (the host's decode "
          f"and staging) {st['read_s']:.3f} s over {st['rows_read']} rows "
          f"in {st['read']} fragments and the rest (the card's filter and "
          f"aggregate, their dispatch) {secs - st['read_s']:.3f} s; the "
          f"decode alone {one.num_rows / decode_s:.6g} rows/s on the host "
          f"(one file, {one.num_rows} rows in {decode_s:.3f} s); "
          f"{len(want)} statuses match numpy; launches {launches}")
    return launches


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(n_bytes: int) -> float:
    """Least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def check_tile_compact(torch, ck, sel, label: str) -> float:
    """Kernel vs plain version: equal loc (zeros past each tile's count
    included) and equal counts. Returns the max abs difference."""
    loc, counts = ck.tile_compact_local(sel)
    ploc, pcounts = ck.tile_compact_local_plain(sel)
    err = 0.0
    if sel.shape[0]:
        err = float(max((loc - ploc).abs().max(),
                        (counts - pcounts).abs().max()))
    check(err == 0 and torch.equal(loc, ploc) and
          torch.equal(counts, pcounts),
          f"tile_compact_local {label}: loc or counts differ")
    print(f"tile_compact_local {label}: cap={sel.shape[0]} "
          f"selected={int(counts.sum())} equal")
    return err


def check_tile_stitch(torch, ck, sel, out_cap: int, label: str) -> float:
    """tile_stitch against its plain version on tile_compact_local's output
    for ``sel``: equal over all ``out_cap`` slots. Returns the max abs
    difference."""
    loc, counts = ck.tile_compact_local(sel)
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    got = ck.tile_stitch(loc, counts, starts, out_cap)
    want = ck.tile_stitch_plain(loc, counts, starts, out_cap)
    err = float((got - want).abs().max())
    check(err == 0 and got.dtype == torch.int32 and
          got.shape == (out_cap,), f"tile_stitch {label}: indices differ")
    print(f"tile_stitch {label}: cap={sel.shape[0]} out_cap={out_cap} "
          f"selected={int(starts[-1])} equal")
    return err


def selection_cases(torch, cap: int, gen, dev):
    """(label, sel) cases of a (cap,) selection, cap a multiple of 1024:
    none, all, half, and 30 % with every other stretch of 8 tiles empty."""
    yield "none", torch.zeros(cap, dtype=torch.bool, device=dev)
    yield "all", torch.ones(cap, dtype=torch.bool, device=dev)
    yield "half", torch.rand(cap, generator=gen, device=dev) < 0.5
    sel = torch.rand(cap, generator=gen, device=dev) < 0.3
    tile = torch.arange(cap, device=dev, dtype=torch.int32) // 1024
    yield "empty stretches", sel & ((tile // 8) % 2 == 1)


def check_take_indices(torch, selection, Array, bool_type, sel,
                       label: str) -> None:
    """get_take_indices (both kernels) vs torch.nonzero."""
    idx = selection.get_take_indices(Array(bool_type, sel))
    want = torch.nonzero(sel).flatten()
    n = want.shape[0]
    check(int(idx.length) == n, f"get_take_indices {label}: count")
    check(torch.equal(idx.values[:n].long(), want),
          f"get_take_indices {label}: indices")
    check(not bool(idx.values[n:].any()),
          f"get_take_indices {label}: padding rows")
    print(f"get_take_indices {label}: cap={sel.shape[0]} selected={n} "
          "equal to torch.nonzero")


def check_filter_chunks(torch, ck, sel, chunks, label: str) -> None:
    """The one-matrix form (``filter_compact_chunks``) vs its plain
    version: the same first count rows."""
    n = int(sel.sum())
    check(torch.equal(ck.filter_compact_chunks(sel, chunks)[:n],
                      ck.filter_compact_chunks_plain(sel, chunks)[:n]),
          f"filter_compact_chunks {label}: rows differ")
    print(f"filter_compact_chunks {label}: cap={sel.shape[0]} "
          f"C={chunks.shape[1]} selected={n} equal")


def check_partition_hist(torch, ck, dest, P: int, label: str) -> float:
    """Kernel vs plain version: equal counts. Returns the max abs
    difference (0 when equal)."""
    before = ck.LAUNCHES["partition_histogram"]
    got = ck.partition_histogram(dest, P)
    want = ck.partition_histogram_plain(dest, P)
    check(ck.LAUNCHES["partition_histogram"] - before ==
          (1 if dest.shape[0] else 0),
          f"partition_histogram {label}: launch count")
    err = float((got.long() - want.long()).abs().max())
    check(err == 0 and got.dtype == torch.int32 and got.shape == (P,),
          f"partition_histogram {label}: counts differ")
    print(f"partition_histogram {label}: n={dest.shape[0]} P={P} "
          f"counted={int(got.sum())} equal")
    return err


def partition_hist_cases(torch, n: int, P: int, gen, dev):
    """(label, dest) cases: uniform over [0, P), all one value, all out of
    range (P and -1), and Zipf(1.5)-skewed over [0, P)."""
    i32 = dict(dtype=torch.int32, device=dev)
    yield "uniform", torch.randint(0, P, (n,), generator=gen, **i32)
    yield "one value", torch.full((n,), P - 1, **i32)
    yield "all P", torch.full((n,), P, **i32)
    yield "all -1", torch.full((n,), -1, **i32)
    w = 1.0 / torch.arange(1, P + 1, dtype=torch.float64, device=dev) ** 1.5
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    yield "zipf", torch.searchsorted(cdf, u).clamp(max=P - 1).to(torch.int32)


def check_partition_segments(torch, ck, dests, P: int, B: int,
                             label: str) -> None:
    """Both exchange kernels over S segments against their plain versions:
    the counts, the tile offsets and every row's slot; one launch each
    (none without rows)."""
    before = dict(ck.LAUNCHES)
    counts, tiles = ck.partition_histogram_segments(dests, P)
    got = ck.partition_positions(dests, P, B, tiles)
    rows = sum(d.shape[0] for d in dests)
    for kname in ("partition_histogram", "partition_positions"):
        check(ck.LAUNCHES[kname] - before[kname] == (1 if rows else 0),
              f"{kname} {label}: launch count")
    want_counts, want_tiles = ck.partition_histogram_segments_plain(dests, P)
    check(torch.equal(counts, want_counts) and torch.equal(tiles, want_tiles),
          f"partition_histogram {label}: counts or tile offsets differ")
    want = ck.partition_positions_plain(dests, P, B)
    check(all(a.dtype == torch.int64 and torch.equal(a, b)
              for a, b in zip(got, want)),
          f"partition_positions {label}: slots differ")
    print(f"partition_histogram + partition_positions {label}: "
          f"{len(dests)} segments, {rows} rows, P={P} B={B} equal")


def bucket_sorts(torch, shuffle, fn):
    """Run fn counting the ``torch.sort`` calls made inside the exchange's
    ``_bucket_rows``. Returns (fn's result, that count)."""
    inner_bucket, inner_sort = shuffle._bucket_rows, torch.sort
    depth, n = [0], [0]

    def bucket(*a, **kw):
        depth[0] += 1
        try:
            return inner_bucket(*a, **kw)
        finally:
            depth[0] -= 1

    def sort(*a, **kw):
        n[0] += depth[0] > 0
        return inner_sort(*a, **kw)
    shuffle._bucket_rows, torch.sort = bucket, sort
    try:
        return fn(), n[0]
    finally:
        shuffle._bucket_rows, torch.sort = inner_bucket, inner_sort


def layer_ms(torch, mod, name, fn) -> float:
    """Run fn with ``mod.name`` bracketed by CUDA events on the current
    stream; the summed device ms between them over every call."""
    inner = getattr(mod, name)
    spans = []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return inner(*a, **kw)
        finally:
            end.record()
            spans.append((start, end))
    setattr(mod, name, timed)
    try:
        fn()
    finally:
        setattr(mod, name, inner)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans)


def measure_tile_compact(torch, ck, sel, label: str) -> dict:
    """tile_compact_local at the arguments a path gave it: compared with
    its plain version, then timed beside it, torch.nonzero (which gives the
    END result of both kernels) and the bound."""
    cap = sel.shape[0]
    m = {
        "max_abs_err": check_tile_compact(torch, ck, sel, label),
        "ms": cuda_ms(torch, lambda: ck.tile_compact_local(sel), 10),
        "plain_ms": cuda_ms(
            torch, lambda: ck.tile_compact_local_plain(sel), 3),
        # selection read once, loc and counts written once
        "bound_ms": bound_ms(cap + 4 * cap + 4 * (cap // ck.TILE_ROWS)),
        "library_ms": cuda_ms(torch, lambda: torch.nonzero(sel), 3)}
    print(f"tile_compact_local {label}: {m['ms']:.3f} ms, bound "
          f"{m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms, "
          f"torch.nonzero {m['library_ms']:.3f} ms")
    return m


def measure_tile_stitch(torch, ck, loc, counts, starts, out_cap: int,
                        label: str) -> dict:
    """tile_stitch at the arguments a path gave it: compared with its plain
    version over all ``out_cap`` slots, then timed beside it and the
    bound."""
    got = ck.tile_stitch(loc, counts, starts, out_cap)
    err = float((got - ck.tile_stitch_plain(loc, counts, starts,
                                            out_cap)).abs().max())
    check(err == 0 and got.dtype == torch.int32 and
          got.shape == (out_cap,), f"tile_stitch {label}: indices differ")
    del got
    m = {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: ck.tile_stitch(loc, counts, starts,
                                                    out_cap), 10),
        "plain_ms": cuda_ms(torch, lambda: ck.tile_stitch_plain(
            loc, counts, starts, out_cap), 3),
        # the live slots of loc, counts and starts read once; every index
        # written once
        "bound_ms": bound_ms(4 * int(starts[-1]) + 4 * counts.shape[0] +
                             4 * starts.shape[0] + 4 * out_cap),
        "library_ms": None}
    print(f"tile_stitch {label}: cap={loc.shape[0]} out_cap={out_cap} "
          f"selected={int(starts[-1])} equal; {m['ms']:.3f} ms, bound "
          f"{m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms")
    return m


def dg_compare(torch, ck, gid, inputs, kinds, G, label: str,
               valid=None) -> float:
    """Kernel vs plain version slot for slot: integers and f32 min/max
    exact (NaN equal to NaN), f32 sums within the stated tolerance.
    Returns the max abs error over the f32 sums (0 elsewhere)."""
    rows, outs = ck.dense_group_reduce(gid, inputs, kinds, G, valid=valid)
    prows, pouts = ck.dense_group_reduce_plain(gid, inputs, kinds, G, valid)
    check(torch.equal(rows, prows), f"dense_group_reduce {label}: rows")
    if isinstance(gid, ck.DenseKey):
        gid = ck.dense_key_gid(gid, G)
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()
    err = 0.0
    oi = ij = 0
    for k, kind in enumerate(kinds):
        ni, no = ck._DG_ARITY[kind]
        for j in range(no):
            a, b = outs[oi + j], pouts[oi + j]
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"dense_group_reduce {label}: {kind} output type")
            if kind == "sum":
                at = slot if valid is None or valid[k] is None else \
                    torch.where(valid[k], slot, G)
                absum = torch.zeros(G + 1, dtype=torch.float64,
                                    device=gid.device).index_add_(
                    0, at, inputs[ij].double().abs())[:G]
                finite = ~absum.isnan()         # a NaN slot: NaN in both
                check(torch.equal(a.isnan(), b.isnan()),
                      f"dense_group_reduce {label}: sum NaN slots")
                d = (a.double() - b.double()).abs()[finite & ~a.isnan()]
                if d.numel():
                    err = max(err, float(d.max()))
                check(bool((d <= (SUM_RTOL * absum + SUM_ATOL_KERNEL)[
                    finite & ~a.isnan()]).all()),
                      f"dense_group_reduce {label}: sum out of tolerance")
            else:
                same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                    if a.is_floating_point() else a == b
                check(bool(same.all()),
                      f"dense_group_reduce {label}: {kind} output {j}")
        oi += no
        ij += ni
    print(f"dense_group_reduce {label}: n={gid.shape[0]} G={G} "
          f"kinds={len(kinds)} equal (sum max |diff| {err:.3g})")
    return err


def synthetic_dg_inputs(torch, n: int, G: int, gen, dev):
    """Every kind of the TPU contract once; gid in [-1, G + 8): inactive
    rows, rows past G, one slot whose f32 inputs are all NaN and one
    where half of them are (min and max skip NaN)."""
    gid = torch.randint(-1, G + 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    kinds, inputs = [], []
    i32 = dict(dtype=torch.int32, device=dev, generator=gen)
    for kind in ("sum", "min", "max", "imin", "imax", "count", "sumc",
                 "imin64", "imax64"):
        kinds.append(kind)
        if kind in ("sum", "min", "max"):
            x = torch.randn(n, generator=gen, device=dev)
            if kind != "sum":
                x[gid == 3] = float("nan")
                x[(gid == 7) & (torch.rand(n, generator=gen, device=dev)
                                < 0.5)] = float("nan")
            inputs.append(x)
        elif kind == "sumc":
            inputs.append(torch.randint(0, 1 << 16, (n,), **i32))
        elif kind in ("imin64", "imax64"):
            inputs += [torch.randint(-(1 << 31), (1 << 31) - 1, (n,), **i32)
                       for _ in range(2)]
        else:
            inputs.append(torch.randint(-1000, 1000, (n,), **i32))
    return gid, tuple(inputs), tuple(kinds)


def synthetic_native_dg_inputs(torch, n: int, G: int, gen, dev, gid=None):
    """The card's native kinds over shared streams: first_row; sum, min and
    max of one f32 column (slot 3 all NaN, slot 7 half NaN); sum64, min64
    and max64 of one int64 column (the type's extremes, sums that wrap); a
    count. ``gid`` as
    in ``synthetic_dg_inputs`` unless given. Returns (gid, inputs, kinds,
    valid): each column with its own validity stream."""
    if gid is None:
        gid = torch.randint(-1, G + 8, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    v = torch.randn(n, generator=gen, device=dev)
    v[gid == 3] = float("nan")
    v[(gid == 7) & (torch.rand(n, generator=gen, device=dev) < 0.5)] = \
        float("nan")
    w = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev,
                      dtype=torch.int64)
    w[:n // 3] = torch.randint(-100, 100, (n // 3,), generator=gen,
                               device=dev, dtype=torch.int64)
    w[gid == 5] = (1 << 63) - 1 - torch.randint(
        0, 1000, (int((gid == 5).sum()),), generator=gen, device=dev,
        dtype=torch.int64)
    w[-1] = -(1 << 63)
    v_ok = torch.rand(n, generator=gen, device=dev) < 0.8
    w_ok = torch.rand(n, generator=gen, device=dev) < 0.8
    kinds = ("first_row", "sum", "min", "max", "sum64", "min64", "max64",
             "count")
    inputs = (v, v, v, w, w, w, w_ok.to(torch.int32))
    valid = (None, v_ok, v_ok, v_ok, w_ok, w_ok, w_ok, None)
    return gid, inputs, kinds, valid


def dg_bounds(torch, ck, gid, inputs, G, n_out_bytes: int, valid=None):
    """(bound_ms over the bytes this call's data needs, bound_ms with every
    stream read at every row): the gid read once, or of a ``DenseKey`` the
    key (and its validity) up to the length; each distinct input and
    validity stream read once at the active rows (slot in [0, G): the
    kernel needs no other row of them), or at every row; the outputs
    written once."""
    if isinstance(gid, ck.DenseKey):
        n = gid.values.shape[0]
        key_row = 8 + (0 if gid.validity is None else 1)
        slot_bytes, slot_bytes_all = key_row * int(gid.length), key_row * n
        gid = ck.dense_key_gid(gid, G)
    else:
        n = gid.shape[0]
        slot_bytes = slot_bytes_all = 4 * n
    streams = {x.data_ptr(): x.element_size() for x in inputs}
    streams.update({v.data_ptr(): 1 for v in valid or () if v is not None})
    per_row = sum(streams.values())
    active = int(((gid >= 0) & (gid < G)).sum())
    return (bound_ms(slot_bytes + active * per_row + n_out_bytes),
            bound_ms(slot_bytes_all + n * per_row + n_out_bytes))


def nine_kind_call(torch, gid, v, w):
    """The twelve 4-byte streams the earlier slices' ``consume_dense`` fed
    the kernel for path 1's query (the TPU caller's form): first row as an
    identity-masked iota under "imin", the valid counts of v and w, sum and
    min of v pre-masked, the int64 sum of w as four 16-bit limb streams of
    the sign-biased value, its int64 min as a (hi, biased lo) pair."""
    n = gid.shape[0]
    ok = gid >= 0
    i32max = (1 << 31) - 1
    iota = torch.arange(n, dtype=torch.int32, device=gid.device)
    u = w ^ (-(1 << 63))
    limbs = [torch.where(ok, (u >> (16 * k)) & 0xFFFF, 0).to(torch.int32)
             for k in range(4)]
    hi = torch.where(ok, (w >> 32).to(torch.int32), i32max)
    lo_b = torch.where(ok, ((w & 0xFFFFFFFF) - (1 << 31)).to(torch.int32),
                       i32max)
    count = ok.to(torch.int32)
    inputs = (torch.where(ok, iota, i32max), count, torch.where(ok, v, 0.0),
              torch.where(ok, v, float("inf")), count.clone(), *limbs, hi,
              lo_b)
    kinds = ("imin", "count", "sum", "min", "count", "sumc", "sumc", "sumc",
             "sumc", "imin64")
    return inputs, kinds


def check_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                     label: str, quiet: bool = False) -> float:
    """pack_key_lanes against its plain version: equal word for word.
    Returns the max abs difference."""
    got = ck.pack_key_lanes(lanes, lo, span, shift, active)
    want = ck.pack_key_lanes_plain(lanes, lo, span, shift, active)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(err == 0 and got.dtype == torch.int64 and got.shape == want.shape,
          f"pack_key_lanes {label}: packed keys differ")
    if not quiet:
        print(f"pack_key_lanes {label}: n={got.shape[0]} L={len(lanes)} "
              f"missed={int((got == ck.PACK_MISS).sum())} equal")
    return err


def measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                       label: str) -> dict:
    """pack_key_lanes at the arguments a path gave it: compared with its
    plain version, then timed beside it and the bound (every lane, and the
    active flags where given, read once; the keys written once)."""
    n = lanes[0].shape[0]

    def call(fn):
        return lambda: fn(lanes, lo, span, shift, active)
    m = {"max_abs_err": check_pack_lanes(torch, ck, lanes, lo, span, shift,
                                         active, label),
         "ms": cuda_ms(torch, call(ck.pack_key_lanes), 10),
         "plain_ms": cuda_ms(torch, call(ck.pack_key_lanes_plain), 3),
         "bound_ms": bound_ms(n * (8 * len(lanes) +
                                   (active is not None) + 8)),
         "library_ms": None}
    print(f"pack_key_lanes {label}: n={n} L={len(lanes)} {m['ms']:.3f} ms, "
          f"bound {m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms")
    return m


def kernel_launches(ck, kname: str, args) -> int:
    """The launches one call of a kernel's wrapper makes with ``args``:
    none for no rows; B1 one for each ``FC_MAX_COLUMNS`` columns; the
    exchange's kernels one for all their segments."""
    if kname == "filter_compact_chunks":
        sel, columns = args
        return max(1, -(-len(columns) // ck.FC_MAX_COLUMNS)) \
            if sel.shape[0] else 0
    if kname in ("partition_histogram", "partition_positions"):
        return 1 if sum(d.shape[0] for d in args[0]) else 0
    return 1 if args[0][0].shape[0] else 0


# the kernels the distributed paths launch, and the function each is
# recorded at where its name is not the kernel's
DIST_KERNELS = ("filter_compact_chunks", "partition_histogram",
                "partition_positions", "pack_key_lanes")
DIST_WRAPPER = {"filter_compact_chunks": "filter_compact_columns",
                "partition_histogram": "partition_histogram_segments"}


def recorded_dist_calls(torch, fn):
    """Run fn recording the arguments of every call of the distributed
    paths' kernels' wrappers (B1, B4, ``partition_positions``,
    ``pack_key_lanes``). Returns (fn's result, wrapper name -> the calls'
    arguments, the ``torch.sort`` calls inside the exchange's
    ``_bucket_rows``)."""
    from arrow_tpu_torch.ops import join as join_mod, selection
    from arrow_tpu_torch.parallel import shuffle
    calls = {}
    saved = [(m, n, getattr(m, n)) for m, n in (
        (selection, "filter_compact_columns"),
        (shuffle, "partition_histogram_segments"),
        (shuffle, "partition_positions"), (join_mod, "pack_key_lanes"))]

    def wrap(name, inner):
        def rec(*a):
            calls.setdefault(name, []).append(a)
            return inner(*a)
        return rec
    for m, n, inner in saved:
        setattr(m, n, wrap(n, inner))
    try:
        out, sorts = bucket_sorts(torch, shuffle, fn)
    finally:
        for m, n, inner in saved:
            setattr(m, n, inner)
    return out, calls, sorts


def check_dist_calls(torch, ck, label, calls, counts, n_shards) -> None:
    """Every recorded call of the distributed paths' kernels against its
    plain version; the launches those calls make against the counted
    run's ``counts``; each exchange kernel call over ``n_shards`` shards
    (one launch a shuffle over all the shards of the card)."""
    for kname in DIST_KERNELS:
        got = calls.get(DIST_WRAPPER.get(kname, kname), [])
        n = sum(kernel_launches(ck, kname, a) for a in got)
        check(n == counts[kname], f"{label}: {len(got)} recorded calls of "
              f"{kname} make {n} launches, the counted run {counts[kname]}")
        for a in got:
            if kname == "filter_compact_chunks":
                check_filter(torch, ck, *a, f"{label} call")
            elif kname == "partition_histogram":
                want = ck.partition_histogram_segments_plain(*a)
                check(all(torch.equal(g, w) for g, w in zip(
                    ck.partition_histogram_segments(*a), want)),
                    f"{label}: a partition_histogram call differs from its "
                    "plain version")
                check(len(a[0]) == n_shards, f"{label}: a "
                      f"partition_histogram call over {len(a[0])} shards")
            elif kname == "partition_positions":
                dests, P, B, _ = a
                check(all(torch.equal(g, w) for g, w in zip(
                    ck.partition_positions(*a),
                    ck.partition_positions_plain(dests, P, B))),
                    f"{label}: a partition_positions call differs from its "
                    "plain version")
            else:
                check_pack_lanes(torch, ck, *a, f"{label} call", True)
    print(f"{label}: " + ", ".join(
        f"{len(calls.get(DIST_WRAPPER.get(k, k), []))} {k}"
        for k in DIST_KERNELS) + " calls equal their plain versions")


def dist_case_hook(name, step):
    """``entry.dist_worker``'s hook in the worker processes of paths 3m
    and 3n: one case of the process. ``entry_distributed`` (path 3a's
    group-by) runs a warm-up, then the counted run (its launches, step ms,
    the bytes this process sent to others, the collectives' ms, peak
    device memory), then one more run recording every B1 / B4 /
    ``partition_positions`` / ``pack_key_lanes`` call; the other cases
    record their calls in their one counted run (no warm-up: their times
    are first runs). Every recorded call is held
    against its plain version, and the calls' launches against the counted
    run's. Prints one JSON line ``{"dist_case": ...}``; returns the counted
    run's result."""
    import torch
    import torch.distributed as dist
    from arrow_tpu_torch.ops import cuda_kernels as ck
    from arrow_tpu_torch.parallel import collective, multihost
    rank, world = dist.get_rank(), dist.get_world_size()
    n_local = len(multihost.global_context().devices)
    label = f"{name} (process {rank} of {world})"

    def counted(run):
        """``run()`` timed, its collectives timed by CUDA events recorded
        around each call on the current stream (no synchronization added:
        an NCCL call's events close when its transfer is done, a gloo
        call's when the host returns from it)."""
        events = []
        plain_run = collective._run

        def timed_run(fn, remote_bytes):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            plain_run(fn, remote_bytes)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        collective.reset_stats()
        collective._run = timed_run
        try:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            collective._run = plain_run
        return out, {"ms": secs * 1e3,
                     "bytes_remote": collective.STATS["bytes_remote"],
                     "collective_ms": sum(a.elapsed_time(b)
                                          for a, b in events),
                     "collective_calls": collective.STATS["calls"],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": dict(ck.LAUNCHES)}
    line = {"dist_case": name, "rank": rank, "world": world,
            "backend": dist.get_backend(), "shards": n_local}
    if name != "entry_distributed":
        (out, calls, sorts), line["counted"] = counted(
            lambda: recorded_dist_calls(torch, step))
    else:
        step()                  # warm-up
        out, line["counted"] = counted(step)
        launches = line["counted"]["launches"]
        for kname in ("partition_histogram", "partition_positions"):
            check(launches[kname] == 1, f"{label}: {launches[kname]} "
                  f"{kname} launches, not one for its one exchange")
        check(launches["filter_compact_chunks"] == n_local,
              f"{label}: one pre-filter launch per local shard")
        _, calls, sorts = recorded_dist_calls(torch, step)
    check(sorts == 0, f"{label}: {sorts} torch.sort calls in _bucket_rows")
    check_dist_calls(torch, ck, label, calls, line["counted"]["launches"],
                     n_local)
    print(json.dumps(line), flush=True)
    return out


def dist_lines(outputs) -> list:
    """The ``{"dist_case": ...}`` lines of the worker processes' outputs."""
    return [json.loads(ln) for out in outputs for ln in out.splitlines()
            if ln.startswith('{"dist_case"')]


def same_rows_as_3a(got, ref, oracle, label: str) -> bool:
    """A worker's ``entry_distributed`` arrays against path 3a's Table's
    (``table_host_arrays``): the same shards hold the same groups in the
    same order, keys, counts and mins exact; the f64 sums bit for bit or
    within the tolerance of the numpy oracle's. Returns whether the sums
    are bit for bit."""
    keys = [k for k in ref if k.startswith("entry_distributed.")]
    check(sorted(k for k in got if k.startswith("entry_distributed.")) ==
          sorted(keys), f"{label}: the result's columns")
    bits = True
    k = ref["entry_distributed.0.values"]
    for name in keys:
        a, b = got[name], ref[name]
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{label}: {name} is {a.dtype} {a.shape}, path 3a's "
              f"{b.dtype} {b.shape}")
        if a.dtype.kind == "f":
            if not np.array_equal(a, b):
                bits = False
                d = np.abs(a - oracle["v_sum"][k])
                check(bool((d <= SUM64_RTOL * oracle["v_abs"][k] +
                            SUM64_ATOL).all()),
                      f"{label}: {name} off by up to {d.max():.3g}")
        else:
            check(np.array_equal(a, b), f"{label}: {name} differs from "
                  "path 3a's")
    return bits


def check_q3_arrays(got, oracle, label: str) -> None:
    """``check_q3`` on a worker's ``q3`` arrays (``table_host_arrays``)."""
    check(got["q3.lengths"].tolist() == [10], f"{label}: "
          f"{got['q3.lengths'].tolist()} rows a batch")
    k, date, rev = (got[f"q3.{i}.values"] for i in range(3))
    check(all(bool(got[f"q3.{i}.validity"].all()) for i in range(3)),
          f"{label}: nulls")
    want = oracle["revenue"]
    tol = 1e-12 * want + 1e-12
    check(rev.dtype == np.float64 and bool((np.abs(rev - want) <= tol).all()),
          f"{label}: revenue differs from the oracle's")
    tie = np.abs(oracle["all_revenue"][k] - want) <= tol
    check(bool(((k == oracle["keys"]) | tie).all()),
          f"{label}: keys {k.tolist()}, the oracle's "
          f"{oracle['keys'].tolist()}")
    check(np.array_equal(date, oracle["all_o_date"][k]), f"{label}: o_date")


def first_appearance(k: np.ndarray, num_keys: int) -> np.ndarray:
    """The keys in [0, num_keys) that ``k`` holds, in the order of their
    first row (``np.minimum.at`` of the row numbers: no sort of the
    rows)."""
    first = np.full(num_keys, k.shape[0], np.int64)
    np.minimum.at(first, k, np.arange(k.shape[0]))
    present = np.flatnonzero(first < k.shape[0])
    return present[np.argsort(first[present], kind="stable")]


def numpy_oracle(cols, num_keys: int = NUM_KEYS):
    """Group-by of the slice computed independently with numpy: per key
    (first-appearance order) count, sums (float64 bincount), mins
    (``np.minimum.at``)."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    cnt = np.bincount(k, minlength=num_keys)
    v_sum = np.bincount(k, weights=v.astype(np.float64), minlength=num_keys)
    v_abs = np.bincount(k, weights=np.abs(v).astype(np.float64),
                        minlength=num_keys)
    w_sum = np.bincount(k, weights=w.astype(np.float64), minlength=num_keys)
    v_min = np.full(num_keys, np.inf, np.float32)
    np.minimum.at(v_min, k, v)
    w_min = np.full(num_keys, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(w_min, k, w)
    return dict(keys=first_appearance(k, num_keys), count=cnt, v_sum=v_sum,
                v_abs=v_abs, w_sum=np.rint(w_sum).astype(np.int64),
                v_min=v_min, w_min=np.where(cnt > 0, w_min, 0))


def check_slice(out, oracle) -> int:
    n = len(out)
    col = {name: out.column(name).values[:n].cpu().numpy()
           for name in out.column_names}
    keys = col["k"]
    check(np.array_equal(keys, oracle["keys"]),
          "slice: keys or their first-appearance order")
    check(np.array_equal(col["count_all"], oracle["count"][keys]),
          "slice: count_all")
    check(np.array_equal(col["w_sum"], oracle["w_sum"][keys]), "slice: w_sum")
    check(np.array_equal(col["w_min"], oracle["w_min"][keys]), "slice: w_min")
    check(np.array_equal(col["v_min"], oracle["v_min"][keys]), "slice: v_min")
    d = np.abs(col["v_sum"].astype(np.float64) - oracle["v_sum"][keys])
    check(bool((d <= SUM_RTOL * oracle["v_abs"][keys] + SUM_ATOL_SLICE)
               .all()), f"slice: v_sum off by up to {d.max():.3g}")
    for name in out.column_names:
        validity = out.column(name).validity
        check(validity is None or bool(validity[:n].all()),
              f"slice: nulls in {name}")
    return n


def numpy_oracle_generic(cols, num_keys: int):
    """Path 2's group-by computed independently with numpy: the present
    keys in first-appearance order (``first_appearance``), the mins by
    ``np.minimum.at``, bincount for counts and float64 sums."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    w_min = np.full(num_keys, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(w_min, k, w)
    count = np.bincount(k, minlength=num_keys)
    return dict(keys=first_appearance(k, num_keys), count=count,
                v_sum=np.bincount(k, weights=v, minlength=num_keys),
                v_abs=np.bincount(k, weights=np.abs(v), minlength=num_keys),
                w_min=np.where(count > 0, w_min, 0))


def check_slice_generic(out, oracle, label: str = "path 2",
                        keys=None) -> int:
    """``keys``: the groups' int64 keys, where the key column is not the
    int64 ``k`` (path 8 decodes them from its strings)."""
    n = len(out)
    col = {name: out.column(name).values[:n].cpu().numpy()
           for name in ("count_all", "w_min", "v_sum")}
    if keys is None:
        keys = out.column("k").values[:n].cpu().numpy()
    check(np.array_equal(keys, oracle["keys"]),
          f"{label}: keys or their first-appearance order")
    check(np.array_equal(col["count_all"], oracle["count"][keys]),
          f"{label}: count_all")
    check(np.array_equal(col["w_min"], oracle["w_min"][keys]),
          f"{label}: w_min")
    d = np.abs(col["v_sum"] - oracle["v_sum"][keys])
    check(bool((d <= SUM64_RTOL * oracle["v_abs"][keys] + SUM64_ATOL).all()),
          f"{label}: v_sum off by up to {d.max():.3g}")
    for name in out.column_names:
        validity = out.column(name).validity
        check(validity is None or bool(validity[:n].all()),
              f"{label}: nulls in {name}")
    return n


def decode_names(torch, names, prefix: bytes, digits: int) -> np.ndarray:
    """The int64 keys a column of ``prefix + "%0{digits}d"`` strings
    encodes; checks every row is exactly such a string."""
    n = len(names)
    width = len(prefix) + digits
    off = names.offsets[:n + 1].cpu().numpy().astype(np.int64)
    check(np.array_equal(off, np.arange(n + 1) * width),
          f"the {prefix!r} strings' offsets")
    mat = names.values[:n * width].cpu().numpy().reshape(n, width)
    check(bool((mat[:, :len(prefix)] ==
                np.frombuffer(prefix, np.uint8)).all()) and
          bool(((mat[:, len(prefix):] >= 48) &
                (mat[:, len(prefix):] <= 57)).all()),
          f"the {prefix!r} strings' bytes")
    keys = np.zeros(n, np.int64)
    for j in range(len(prefix), width):
        keys = keys * 10 + (mat[:, j] - 48)
    return keys


def numpy_sort_dict_oracle(cols):
    """Path 4d's stable sort permutation computed independently with numpy:
    ONE composite uint64 key per row (the null flag of ``s`` in the top
    bit, then its rank, which is its index: the values ``cat%04d`` lie in
    order, 0 where null, then ``i`` descending: 2^41 - 1 minus its biased
    value), sorted with numpy's stable sort."""
    valid = cols["s_valid"]
    rank = np.where(valid, cols["s_idx"], 0).astype(np.uint64)
    desc = np.uint64((1 << 41) - 1) - \
        (cols["i"] + (1 << 40)).astype(np.uint64)
    key = ((~valid).astype(np.uint64) << np.uint64(63)) | \
        (rank << np.uint64(41)) | desc
    return np.argsort(key, kind="stable")


def check_dist_group_by(np_, table, oracle, n_shards: int, shard_of,
                        key: str = "k", label: str = "path 3a") -> int:
    """Path 3a's Table against the numpy oracle: the groups as a set, every
    key once (so on exactly one shard) and on the shard its hash names,
    integers exact, f64 sums within tolerance. A dictionary ``key``
    column's codes are the oracle's keys."""
    check(len(table.batches) == n_shards, f"{label}: a shard has no groups")
    col = {name: [] for name in table.column_names}
    for s, b in enumerate(table.batches):
        n = len(b)
        for name in table.column_names:
            a = b.column(name)
            check(a.validity is None or bool(a.validity[:n].all()),
                  f"{label}: nulls in {name}")
            col[name].append(a.values[:n].cpu().numpy())
        check(bool((shard_of(b.column(key))[:n] == s).all()),
              f"{label}: a group of shard {s} hashes elsewhere")
    col = {name: np_.concatenate(v) for name, v in col.items()}
    keys = col[key].astype(np_.int64)
    check(np_.unique(keys).shape[0] == keys.shape[0],
          f"{label}: a group lies on more than one shard")
    check(np_.array_equal(np_.sort(keys), np_.sort(oracle["keys"])),
          f"{label}: the set of groups")
    check(np_.array_equal(col["count_all"], oracle["count"][keys]),
          f"{label}: count_all")
    check(np_.array_equal(col["w_min"], oracle["w_min"][keys]),
          f"{label}: w_min")
    d = np_.abs(col["v_sum"] - oracle["v_sum"][keys])
    check(bool((d <= SUM64_RTOL * oracle["v_abs"][keys] + SUM64_ATOL).all()),
          f"{label}: v_sum off by up to {d.max():.3g}")
    return keys.shape[0]


def numpy_dist_sort_dict_oracle(cols, num_values: int):
    """Path 7e's stable sort permutation computed independently with numpy:
    ONE composite uint64 key per row (``k1`` in the top bits, then the null
    flag of ``s``, then its descending rank: num_values - 1 minus its
    index, the values ``cat%04d`` lying in order, 0 where null), sorted
    with numpy's stable sort."""
    valid = cols["s_valid"]
    desc = np.where(valid, num_values - 1 - cols["s_idx"].astype(np.int64),
                    0).astype(np.uint64)
    key = (cols["k1"].astype(np.uint64) << np.uint64(32)) | \
        ((~valid).astype(np.uint64) << np.uint64(31)) | desc
    return np.argsort(key, kind="stable")


def numpy_sort_oracle(cols):
    """Path 4's stable sort permutation computed independently with numpy:
    ONE composite uint64 key per row (k1 in the top bits, then the null
    flag of k2, then k2 descending: its sign-biased bits inverted, 0 where
    null), sorted with numpy's stable sort."""
    k2 = (cols["k2"].astype(np.int64) + (1 << 31)).astype(np.uint64)
    desc = np.where(cols["k2_valid"], np.uint64(0xFFFFFFFF) - k2,
                    np.uint64(0))
    key = (cols["k1"].astype(np.uint64) << np.uint64(33)) | \
        ((~cols["k2_valid"]).astype(np.uint64) << np.uint64(32)) | desc
    return np.argsort(key, kind="stable")


def numpy_join_oracle(bcols, pcols, join_type: str):
    """The join's rows computed independently with numpy, as columns (k,
    k_valid, lv, lv_valid, rv, rv_valid): the build side sorted by key, a
    per-key (start, count) lookup table, every probe row expanded by its
    count (``np.repeat``). ``join_type``: inner, left outer, full outer,
    left semi or left anti (no rv column for the last two)."""
    bk, pk = bcols["k"], pcols["k"]
    nk = int(max(bk.max(), pk.max())) + 1
    order = np.argsort(bk, kind="stable")
    count = np.bincount(bk, minlength=nk)
    start = np.cumsum(count) - count
    c = count[pk]
    if join_type in ("left semi", "left anti"):
        keep = (c > 0) if join_type == "left semi" else (c == 0)
        n = int(keep.sum())
        ones = np.ones(n, bool)
        return dict(k=pk[keep], k_valid=ones, lv=pcols["lv"][keep],
                    lv_valid=ones, rv=None, rv_valid=None)
    emit = c if join_type == "inner" else np.maximum(c, 1)
    r = np.repeat(np.arange(pk.shape[0]), emit)
    first = np.cumsum(emit) - emit
    o = np.arange(r.shape[0]) - first[r]
    matched = o < c[r]
    brow = order[np.where(matched, start[pk[r]] + o, 0)]
    k, lv, rv = pk[r], pcols["lv"][r], bcols["rv"][brow]
    k_valid = lv_valid = np.ones(r.shape[0], bool)
    if join_type == "full outer":
        un = np.bincount(pk, minlength=nk)[bk] == 0     # unmatched build rows
        t = int(un.sum())
        k = np.concatenate([k, np.zeros(t, k.dtype)])
        lv = np.concatenate([lv, np.zeros(t, lv.dtype)])
        rv = np.concatenate([rv, bcols["rv"][un]])
        k_valid = lv_valid = np.concatenate([k_valid, np.zeros(t, bool)])
        matched = np.concatenate([matched, np.ones(t, bool)])
    return dict(k=k, k_valid=k_valid, lv=lv, lv_valid=lv_valid, rv=rv,
                rv_valid=matched)


def canonical_rows(torch, k, k_valid, lv, lv_valid, rv, rv_valid):
    """Join rows on the card in one canonical order, as int64 columns (key,
    lv bits, rv bits; a null as the smallest value): sorted by all three,
    so that two row multisets are equal iff the results are."""
    low = -(1 << 63)
    cols = [torch.where(k_valid, k, low) if k_valid is not None else k,
            lv.view(torch.int32).to(torch.int64)]
    if lv_valid is not None:
        cols[1] = torch.where(lv_valid, cols[1], low)
    if rv is not None:
        bits = rv.view(torch.int64)
        cols.append(bits if rv_valid is None
                    else torch.where(rv_valid, bits, low))
    perm = torch.argsort(cols[-1], stable=True)
    for c in cols[-2::-1]:
        perm = perm[torch.argsort(c[perm], stable=True)]
    return [c[perm] for c in cols]


def check_join(torch, dev, label: str, outs, oracle, wide_mul=None) -> int:
    """The join's output batches (probe output, finish output) against the
    numpy oracle's rows, as multisets. Returns the row count."""
    parts = {n: [] for n in ("k", "k_valid", "lv", "lv_valid", "rv",
                             "rv_valid")}
    has_rv = oracle["rv"] is not None
    for b in outs:
        if b is None:
            continue
        n = len(b)
        names = ["k", "lv"] + (["rv"] if has_rv else [])
        for name in names:
            a = b.column(name)
            parts[name].append(a.values[:n])
            parts[name + "_valid"].append(
                torch.ones(n, dtype=torch.bool, device=dev)
                if a.validity is None else a.validity[:n])
        if wide_mul is not None:        # the second key follows the first
            k2 = b.column("k2")
            check(bool((k2.values[:n] == b.column("k").values[:n] * wide_mul)
                       .all()), f"{label}: k2 does not follow k")
    got = {n: (torch.cat(v) if v else None) for n, v in parts.items()}
    n_rows = got["k"].shape[0]
    check(n_rows == oracle["k"].shape[0],
          f"{label}: {n_rows} rows, the oracle has {oracle['k'].shape[0]}")
    want = {n: (None if v is None else torch.from_numpy(v).to(dev))
            for n, v in oracle.items()}
    a = canonical_rows(torch, *[got[n] for n in parts])
    del got
    b = canonical_rows(torch, *[want[n] for n in parts])
    del want
    for x, y, name in zip(a, b, ("k", "lv", "rv")):
        check(torch.equal(x, y), f"{label}: column {name} of the sorted rows")
    return n_rows


def numpy_q3_oracle(li, od, cu):
    """Path 6's plan computed independently with numpy: the filters as
    masks; the joins as lookups (``o_orderkey`` and ``c_custkey`` are
    aranges, so a key is its row); ``rev`` in float64 as the engine types
    ``l_price * (1.0 - l_disc)``, summed per order by ``np.bincount``
    (``o_date`` is a function of the order); the top 10 by (revenue
    descending, l_orderkey ascending). Returns the top rows and every
    order's revenue (NaN for an order with no row) and date."""
    ok_o = (od["o_date"] < 25) & (cu["c_seg"][od["o_custkey"]] == 1)
    m = (li["l_ship"] > 40) & ok_o[li["l_orderkey"]]
    k = li["l_orderkey"][m]
    rev = li["l_price"][m].astype(np.float64) * \
        (1.0 - li["l_disc"][m].astype(np.float64))
    no = od["o_orderkey"].shape[0]
    revenue = np.bincount(k, weights=rev, minlength=no)
    present = np.bincount(k, minlength=no) > 0
    keys = np.flatnonzero(present)
    top = keys[np.lexsort((keys, -revenue[keys]))[:10]]
    return dict(keys=top, revenue=revenue[top], all_o_date=od["o_date"],
                all_revenue=np.where(present, revenue, np.nan),
                n_groups=keys.shape[0])


def check_q3(table, oracle, label: str = "path 6", scale: int = 1) -> int:
    """Path 6's (or 7b's) Table against the numpy oracle: 10 rows; o_date
    exact; revenue within 1e-12 * revenue + 1e-12 of the oracle's at each place
    (a sum of positive terms: its sum of |rev| is itself); keys exact but
    where a key's oracle revenue lies within that tolerance of the oracle's
    revenue at the place (a tie the summation order may break either way);
    with ``scale``, the Table's keys are the oracle's times ``scale``.
    Returns the oracle's group count."""
    check(len(table.batches) == 1, f"{label}: one result batch")
    b = table.batches[0]
    n = len(b)
    got = {c: b.column(c).values[:n].cpu().numpy()
           for c in ("l_orderkey", "o_date", "revenue")}
    for c in got:
        a = b.column(c)
        check(a.validity is None or bool(a.validity[:n].all()),
              f"{label}: nulls in {c}")
    check(bool((got["l_orderkey"] % scale == 0).all()),
          f"{label}: keys not multiples of {scale}")
    got["l_orderkey"] = got["l_orderkey"] // scale
    want = oracle["revenue"]
    tol = 1e-12 * want + 1e-12
    check(n == 10 and got["revenue"].dtype == np.float64,
          f"{label}: {n} rows of {got['revenue'].dtype}")
    check(bool((np.abs(got["revenue"] - want) <= tol).all()),
          f"{label}: revenue differs from the oracle's")
    k = got["l_orderkey"]
    tie = np.abs(oracle["all_revenue"][k] - want) <= tol
    check(bool(((k == oracle["keys"]) | tie).all()),
          f"{label}: keys {k.tolist()}, the oracle's "
          f"{oracle['keys'].tolist()}")
    check(np.array_equal(got["o_date"], oracle["all_o_date"][k]),
          f"{label}: o_date")
    return oracle["n_groups"]


def synthetic_bool_dg_inputs(torch, n: int, G: int, gen, dev, gid=None):
    """The bool kinds over one bool column, with its validity and without,
    beside first_row and a count: slots 0 and 1 all True and all False,
    the rest random. Returns (gid, inputs, kinds, valid)."""
    if gid is None:
        gid = torch.randint(-1, G + 8, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    f = torch.rand(n, generator=gen, device=dev) < 0.5
    f = torch.where(gid == 0, True, torch.where(gid == 1, False, f))
    ok = torch.rand(n, generator=gen, device=dev) < 0.9
    kinds = ("first_row", "any8", "all8", "count", "any8", "all8")
    inputs = (f, f, ok.to(torch.int32), f, f)
    valid = (None, ok, ok, None, None, None)
    return gid, inputs, kinds, valid


def numpy_any_all_oracle(cols, num_keys: int = NUM_KEYS):
    """Path 1c's group-by computed independently with numpy: per key of
    the rows with w > 0, the row count, the float64 sum and the sum of |v|
    of v, the min of w, and of f over its valid rows the count, the count
    of True and of False (any = some True, all = no False, both null where
    the count is 0)."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    f, fv = cols["f"][sel], cols["f_valid"][sel]
    # one stable sort of the keys as int16 (numpy's radix sort): the run
    # starts give the present keys, their first rows and the mins
    order = np.argsort(k.astype(np.int16) if num_keys <= 1 << 15 else k,
                       kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    keys = ks[starts][np.argsort(order[starts], kind="stable")]
    w_min = np.zeros(num_keys, np.int64)
    w_min[ks[starts]] = np.minimum.reduceat(w[order], starts)

    def count(x):
        return np.bincount(k, weights=x, minlength=num_keys).astype(np.int64)
    return dict(keys=keys, count=np.bincount(k, minlength=num_keys),
                v_sum=np.bincount(k, weights=v.astype(np.float64),
                                  minlength=num_keys),
                v_abs=np.bincount(k, weights=np.abs(v).astype(np.float64),
                                  minlength=num_keys),
                w_min=w_min, f_valid=count(fv), f_true=count(f & fv),
                f_false=count(~f & fv))


def check_any_all(out, oracle) -> int:
    """Path 1c's result against its oracle: keys in first-appearance
    order, count_all, w_min, f_any, f_all and their nulls exact, v_sum
    within the stated tolerance."""
    n = len(out)

    def col(name):
        return out.column(name).values[:n].cpu().numpy()
    keys = col("k")
    check(np.array_equal(keys, oracle["keys"]),
          "path 1c: keys or their first-appearance order")
    check(np.array_equal(col("count_all"), oracle["count"][keys]),
          "path 1c: count_all")
    check(np.array_equal(col("w_min"), oracle["w_min"][keys]),
          "path 1c: w_min")
    d = np.abs(col("v_sum").astype(np.float64) - oracle["v_sum"][keys])
    check(bool((d <= SUM_RTOL * oracle["v_abs"][keys] + SUM_ATOL_SLICE)
               .all()), f"path 1c: v_sum off by up to {d.max():.3g}")
    has = oracle["f_valid"][keys] > 0
    for name, want in (("f_any", oracle["f_true"][keys] > 0),
                       ("f_all", oracle["f_false"][keys] == 0)):
        a = out.column(name)
        valid = a.validity[:n].cpu().numpy()
        check(np.array_equal(valid, has), f"path 1c: {name} nulls")
        check(np.array_equal(col(name)[has], want[has]), f"path 1c: {name}")
    check(bool(col("f_any")[np.isin(keys, np.arange(0, NUM_KEYS, 4))].all())
          and not bool(col("f_all")[np.isin(keys, np.arange(
              1, NUM_KEYS, 4))].any()) and not col("f_all").all()
          and col("f_any").any(), "path 1c: any / all do not vary by group")
    return n


def numpy_q6_oracle(cols, k: int = Q6_K):
    """db-benchmark q6 computed independently with numpy: one stable
    argsort by the group code (id4, id5), then ``np.median`` and
    ``np.std(ddof=1)`` over each group's slice."""
    code = (cols["id4"].astype(np.int64) - 1) * k + (cols["id5"] - 1)
    # k^2 codes fit int16 at K = 100: numpy's stable sort is a radix sort
    order = np.argsort(code.astype(np.int16) if k * k <= 1 << 15 else code,
                       kind="stable")
    cs = code[order]
    v = cols["v3"][order]
    starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    ends = np.r_[starts[1:], len(cs)]
    med = np.array([np.median(v[s:e]) for s, e in zip(starts, ends)])
    sd = np.array([np.std(v[s:e], ddof=1) for s, e in zip(starts, ends)])
    return dict(code=cs[starts], median=med, sd=sd)


def check_q6(table, oracle, label: str, k: int = Q6_K) -> int:
    """A q6 result Table (one batch, or one per shard) against the numpy
    oracle, groups as a set: the median within Q6_MEDIAN_RTOL, the sd
    within Q6_SD_RTOL, relative; no nulls."""
    parts = {name: [] for name in ("id4", "id5", "median_v3", "sd_v3")}
    for b in table.batches:
        n = len(b)
        for name in parts:
            a = b.column(name)
            check(a.validity is None or bool(a.validity[:n].all()),
                  f"{label}: nulls in {name}")
            parts[name].append(a.values[:n].cpu().numpy())
    got = {name: np.concatenate(v) for name, v in parts.items()}
    code = (got["id4"].astype(np.int64) - 1) * k + (got["id5"] - 1)
    order = np.argsort(code)
    check(np.array_equal(code[order], oracle["code"]),
          f"{label}: the groups differ from the oracle's")
    for name, want, rtol in (("median_v3", oracle["median"], Q6_MEDIAN_RTOL),
                             ("sd_v3", oracle["sd"], Q6_SD_RTOL)):
        rel = np.abs(got[name][order] - want) / np.abs(want)
        check(bool((rel <= rtol).all()),
              f"{label}: {name} off by up to {rel.max():.3g} relative")
    return len(code)


def result_parts(a) -> list:
    """An Array (or a Batch: its columns) as the sweeps compare it, as
    bytes on the host: length, capacities, validity, and a varlen column's
    offsets and used bytes, a struct-layout column's children, or a
    fixed-width column's type and valid rows' values."""
    if hasattr(a, "arrays"):
        return [p for c in a.arrays for p in result_parts(c)]
    if a.children:
        ok = a.validity
        return [p for c in a.children
                for p in result_parts(c.with_validity(ok))]
    n = int(a.length)
    varlen = a.offsets is not None
    ok = a.validity_or_true()[:n].cpu()
    parts = [np.array([n, a.capacity, a.values.shape[0] if varlen else -1],
                      np.int64).tobytes(), ok.numpy().tobytes()]
    if varlen:
        off = a.offsets[:n + 1].cpu()
        parts += [off.numpy().tobytes(),
                  a.values[:int(off[-1])].cpu().numpy().tobytes()]
    else:
        parts += [str(a.type).encode(),
                  a.values[:n].cpu()[ok].numpy().tobytes()]
    return parts


def float_parts_close(got, want, tol, scale_of=None) -> bool:
    """The sweeps' float comparison: validity equal and, at the valid
    rows, ``("ulps", k)``: |got - want| <= k ulps of the larger magnitude
    (NaN equal to NaN); ``("sum", rtol)``: |got - want| <= rtol times
    ``scale_of`` (the running sum of |x| of the input) plus 1e-6 for a
    float32 result."""
    n = int(want.length)
    ok = want.validity_or_true()[:n].cpu().numpy()
    if not np.array_equal(got.validity_or_true()[:n].cpu().numpy(), ok):
        return False
    g = got.values[:n].cpu().numpy()[ok]
    w = want.values[:n].cpu().numpy()[ok]
    if g.dtype != w.dtype:
        return False
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    kind, k = tol
    with np.errstate(invalid="ignore", over="ignore"):
        if kind == "ulps":
            mag = np.maximum(np.abs(g), np.abs(w))
            close = np.abs(g - w) <= k * np.spacing(mag.astype(g.dtype))
        else:
            f32 = g.dtype == np.float32
            close = np.abs(g.astype(np.float64) - w) <= \
                k * scale_of[:n][ok] + (1e-6 if f32 else 0.0)
    return bool(np.all(same | close))


def device_nulls(t, name: str) -> int:
    """The nulls of a column over a Table's batches, counted on the
    card."""
    return int(sum((~b.column(name).validity_or_true()[:int(b.length)])
                   .sum() for b in t.batches)) if t.batches else 0


def out_of_core_paths(torch, ck, dev, source, q12_results, timed,
                      check_plan_calls, seen_calls, forget,
                      max_batch_rows: int = 1 << 22):
    """Paths 20-22 on SF 10's lineitem and orders (``source``, made for
    paths 10-19): the scan, the external sort and the Grace join of
    ``entry.entry_scan_q12``, ``entry_disk_sort`` and
    ``entry_partitioned_join``, each against its oracles; every call they
    make to B1, B2, the stitch, ``pack_key_lanes``, B4 and
    ``partition_positions`` against its plain version (``check_plan_calls``).
    Returns (each counted run's launches by label, B4's, the positions'
    and B1's measurements at paths 22's and 20's largest calls). The
    tables go in batches of ``max_batch_rows`` rows."""
    import os
    import shutil
    import tempfile
    import arrow_tpu_torch.entry as entry_mod
    from arrow_tpu_torch import dataset as dataset_mod
    from arrow_tpu_torch.acero import spill as spill_mod
    from arrow_tpu_torch.acero.spill import batch_device_bytes
    from arrow_tpu_torch.utils.cancel import CancelledError
    from arrow_tpu_torch.utils.tracing import metrics
    launches, measured = {}, {}
    oracles = ThreadPoolExecutor(max_workers=1)

    def allocated():
        """Device bytes held now (what a counted run's peak starts from:
        ``timed``'s warm-up result is gone by then)."""
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()
    metrics.reset()
    tmp = tempfile.gettempdir()
    print(f"paths 20-22: spill and dataset directory {tmp}, "
          f"{shutil.disk_usage(tmp).free} B free")

    def largest(name):
        """The recorded call of ``name`` with the most rows."""
        calls = seen_calls.get(name, [])
        check(bool(calls), f"no recorded call of {name}")
        return max(calls, key=lambda a: sum(
            x.shape[0] for x in (a[0] if isinstance(a[0], list) else
                                 [a[0]])))

    # path 20: TPC-H Q12 over scans of a hive-partitioned parquet lineitem
    t0 = time.time()
    step, (li, od) = entry_mod.entry_scan_q12(dev, TPCH_SF, TPCH_SEED,
                                              max_batch_rows, source)
    frags = li.fragments + od.fragments
    on_disk = sum(os.path.getsize(f.path) for f in frags)
    print(f"path 20 data: lineitem written as {len(li.fragments)} parquet "
          f"fragments by l_shipmode, orders as {len(od.fragments)}, "
          f"{on_disk} B in {time.time() - t0:.1f} s")
    try:
        out, secs, launches["path 20"], peak = timed(
            lambda: step(li, od), "path 20",
            ("filter_compact_chunks", "tile_compact_local"),
            before=dataset_mod.reset_stats)
        st = dict(dataset_mod.STATS)
        got = out.to_pydict()
        check(got == q12_results["port"] == q12_results["pyarrow"],
              f"path 20: Q12 over scans differs from path 13's or "
              f"pyarrow's: {got} {q12_results}")
        check(st["read"] == 3 and st["pruned"] == 5,
              f"path 20: fragments read / pruned {st}")
        print(f"path 20 (TPC-H Q12 over dataset scans at SF {TPCH_SF}): "
              f"{st['rows_read']} rows read in {secs * 1e3:.3f} ms; "
              f"{st['read']} fragments read ({st['bytes_read']} B), "
              f"{st['pruned']} pruned on the host; reading and staging "
              f"{st['read_s'] * 1e3:.3f} ms = "
              f"{100 * st['read_s'] / secs:.1f} % of the step; "
              f"{len(got['l_shipmode'])} ship modes equal path 13's and "
              f"pyarrow's; peak device memory {peak} B; launches "
              f"{launches['path 20']}")
        paths_entry = {"fragments_read": st["read"],
                       "fragments_pruned": st["pruned"],
                       "bytes_read": st["bytes_read"],
                       "read_ms": st["read_s"] * 1e3}
        del out
        check_plan_calls("path 20", lambda: step(li, od), launches["path 20"])
        measured["filter_compact_chunks"] = measure_filter(
            torch, ck, *largest("filter_compact_columns"), "path 20 call")
        forget()
    finally:
        step.cleanup()
    torch.cuda.empty_cache()

    # path 21: the external sort of SF 10's lineitem
    t0 = time.time()
    step, (rbs,) = entry_mod.entry_disk_sort(dev, TPCH_SF, TPCH_SEED,
                                             max_batch_rows, source)
    order = oracles.submit(entry_mod.disk_sort_order, step.source)
    n_li = step.source["lineitem"].num_rows
    names = ", ".join(step.source["lineitem"].column_names)
    print(f"path 21 data: {n_li} lineitem rows ({names}; l_shipmode a "
          f"plain string) in {len(rbs)} record batches on the host, "
          f"{step.input_bytes} B "
          f"once staged, budget {step.spill_bytes} B, made in "
          f"{time.time() - t0:.1f} s")
    # each run's peak is taken from the bytes held before it (the other
    # run's output), and holds its own output
    base_m = allocated()
    mem, secs_m, launches["path 21 in memory"], peak_m = timed(
        lambda: step(rbs, spill_bytes=None), "path 21 in memory", warm=False)
    base = allocated()
    out, secs, launches["path 21"], peak = timed(
        lambda: step(rbs), "path 21", warm=False,
        before=spill_mod.reset_stats)
    st = dict(spill_mod.STATS)
    check(st["runs"] >= 8 and st["run_rows"] == n_li,
          f"path 21: {st['runs']} runs of {st['run_rows']} rows")
    check(peak - base < peak_m - base_m, f"path 21: peak {peak - base} B "
          f"above what was held is not below the in-memory sort's "
          f"{peak_m - base_m} B")
    acct, acct_m = (entry_mod.table_device_bytes(t) for t in (out, mem))
    bad = entry_mod.same_rows(out, mem)
    check(not bad, f"path 21: {bad} differ from the in-memory sort's")
    del mem
    t1 = time.time()
    differ = oracles.submit(entry_mod.disk_sort_differ, out, step.source,
                            order.result())
    # the cancelled run, while the oracle compares
    spill_mod.reset_stats()
    try:
        step(rbs, stop_after=1)
        check(False, "path 21: the stopped sort did not raise")
    except CancelledError:
        pass
    run_dir = spill_mod.STATS["last_dir"]
    check(run_dir is not None and not os.path.exists(run_dir),
          f"path 21: the stopped sort left {run_dir}")
    bad = differ.result()
    check(not bad, f"path 21: {bad} differ from numpy's stable sort")
    print(f"path 21 (the external sort of SF {TPCH_SF}'s lineitem by "
          f"(l_shipdate, l_orderkey, l_linenumber), budget 1/8 of its "
          f"bytes): {n_li} rows in {secs * 1e3:.3f} ms = "
          f"{n_li / secs:.6g} rows/s; {st['runs']} runs, "
          f"{st['bytes_written']} B written and {st['bytes_read']} B read, "
          f"{st['write_s'] * 1e3:.3f} ms writing, {st['merge_s'] * 1e3:.3f} "
          f"ms merging; {shutil.disk_usage(tmp).free} B free; peak device "
          f"memory {peak - base} B above the {base} B held before it "
          f"against the in-memory sort's {peak_m - base_m} B above "
          f"{base_m} B ({secs_m * 1e3:.3f} ms); output {acct} against "
          f"the in-memory sort's {acct_m}; row for row equal to it and "
          f"to numpy's "
          f"stable sort (oracle {time.time() - t1:.1f} s); a stop after "
          f"the first merged batch raised CancelledError and removed "
          f"{run_dir}; launches {launches['path 21']}")
    paths_21 = {"runs": st["runs"], "bytes_written": st["bytes_written"],
                "bytes_read": st["bytes_read"],
                "write_ms": st["write_s"] * 1e3,
                "merge_ms": st["merge_s"] * 1e3}
    del out
    if any(launches["path 21"][k] for k in ck.LAUNCHES):
        check_plan_calls("path 21", lambda: step(rbs), launches["path 21"])
        forget()
    del step, rbs
    torch.cuda.empty_cache()

    # path 22: the Grace join of SF 10's orders and lineitem
    t0 = time.time()
    step, (li, od) = entry_mod.entry_partitioned_join(
        dev, TPCH_SF, TPCH_SEED, max_batch_rows, source)
    n_li = li.num_rows
    print(f"path 22 data: orders {od.num_rows} rows ({step.build_bytes} B, "
          f"the build side), lineitem {n_li} rows, staged in "
          f"{time.time() - t0:.1f} s; budget {step.spill_bytes} B")
    base_m = allocated()
    mem, secs_m, launches["path 22 in memory"], peak_m = timed(
        lambda: step(li, od, spill_bytes=None), "path 22 in memory")
    base = allocated()
    out, secs, launches["path 22"], peak = timed(
        lambda: step(li, od), "path 22",
        ("partition_histogram", "partition_positions"), warm=False,
        before=spill_mod.reset_stats)
    st = dict(spill_mod.STATS)
    check(peak - base < peak_m - base_m, f"path 22: peak {peak - base} B "
          f"above what was held is not below the in-memory join's "
          f"{peak_m - base_m} B")
    acct, acct_m = (entry_mod.table_device_bytes(t) for t in (out, mem))
    check(st["partition_files"] >= 16 * len(li.batches),
          f"path 22: {st['partition_files']} partition files")
    check(launches["path 22"]["partition_histogram"] ==
          launches["path 22"]["partition_positions"] ==
          len(li.batches) + len(od.batches),
          "path 22: not one B4 and one positions launch a batch")
    check(out.num_rows == n_li, f"path 22: {out.num_rows} rows")
    t1 = time.time()
    bad = entry_mod.tables_differ(out, mem, ["l_orderkey", "l_linenumber"])
    check(not bad, f"path 22: {bad} differ from the in-memory join's")
    rows = st["partition_rows"]
    print(f"path 22 (the Grace join of SF {TPCH_SF}'s orders and lineitem "
          f"on the order key, 16 partitions, budget 1/4 of the build "
          f"side): {n_li} probe rows in {secs * 1e3:.3f} ms = "
          f"{n_li / secs:.6g} rows/s; a partition's rows: build "
          f"{min(rows['build'])}-{max(rows['build'])}, probe "
          f"{min(rows['probe'])}-{max(rows['probe'])}; "
          f"{st['partition_files']} partition "
          f"files, {st['bytes_written']} B to disk, {st['bytes_read']} B "
          f"back; peak device memory {peak - base} B above the {base} B "
          f"held before it (the inputs, the in-memory join's output) "
          f"against the in-memory join's {peak_m - base_m} B above "
          f"{base_m} B ({secs_m * 1e3:.3f} ms); output {acct} against the "
          f"in-memory join's {acct_m}; sorted by "
          f"(l_orderkey, l_linenumber) on the card, equal column for "
          f"column to the in-memory join's (compare {time.time() - t1:.1f} "
          f"s); launches {launches['path 22']}")
    paths_22 = {"partition_rows": rows,
                "partition_files": st["partition_files"],
                "bytes_written": st["bytes_written"],
                "bytes_read": st["bytes_read"]}
    del out, mem
    check_plan_calls("path 22", lambda: step(li, od), launches["path 22"])
    dests, P = largest("partition_histogram_segments")
    measured["partition_histogram"] = measure_hist(
        torch, ck, dests, P, "path 22 lineitem batch")
    dests, P, B, _ = largest("partition_positions")
    measured["partition_positions"] = measure_positions(
        torch, ck, dests, P, B, "path 22 lineitem batch")
    del dests
    forget()
    # a left anti and a full outer join on about a tenth of each table
    ls, os_ = entry_mod.pjoin_slices(step.source, dev, max_batch_rows)
    budget = sum(batch_device_bytes(b) for b in os_.batches) // 4
    for jt, keys in (("left anti", ["l_orderkey", "l_linenumber"]),
                     ("full outer", ["l_orderkey", "l_linenumber",
                                     "o_orderkey"])):
        spill_mod.reset_stats()
        g = step(ls, os_, jt, budget)
        files = spill_mod.STATS["partition_files"]
        m = step(ls, os_, jt, None)
        bad = entry_mod.tables_differ(g, m, keys)
        check(files > 16 and not bad, f"path 22 {jt}: {files} partition "
              f"files, {bad} differ from the in-memory join's")
        what = f"{g.num_rows} lineitem rows without an order"
        if jt == "full outer":
            no_order = device_nulls(g, "o_orderkey")
            no_line = device_nulls(g, "l_orderkey")
            check(no_order > 0 and no_line > 0, f"path 22 {jt}: "
                  f"{no_order} / {no_line} rows without a match")
            what = (f"{g.num_rows} rows: {no_order} lineitem rows without "
                    f"an order, {no_line} orders without a lineitem")
        print(f"path 22 {jt} on {ls.num_rows} lineitem and {os_.num_rows} "
              f"orders rows: {what}; {files} partition files; equal to "
              f"the in-memory join's")
        del g, m
    del step, li, od, ls, os_
    oracles.shutdown()
    torch.cuda.empty_cache()
    print(json.dumps({"metrics": metrics.snapshot()}))
    print(json.dumps({"out_of_core": {"path 20": paths_entry,
                                      "path 21": paths_21,
                                      "path 22": paths_22}}))
    return launches, measured


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from arrow_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: arrow_tpu_torch not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from arrow_tpu_torch.entry import example_columns, \
        example_columns_generic
    import arrow_tpu_torch.entry as entry_mod
    from arrow_tpu_torch.core import datatype
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.ops import hash_aggregate, selection

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_all = time.time()

    # path 24's writer: a worker process (no card) writes the Avro files
    # while paths 1-22 run; stopped and its files removed at exit
    import atexit
    avro_root = tempfile.mkdtemp(prefix="arrow_tpu_avro_")
    writer = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.write_avro_worker(sys.argv[1], float(sys.argv[2]), "
         "int(sys.argv[3]))", avro_root, str(AVRO_SF), str(TPCH_SEED)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    def stop_writer():
        if writer.poll() is None:
            writer.kill()
            writer.wait()
        shutil.rmtree(avro_root, ignore_errors=True)
    atexit.register(stop_writer)

    t0 = time.time()
    path, log = ck.build()
    print(f"build: {time.time() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- B1 against its plain version ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sel_cases(cap):
        yield "half", torch.rand(cap, generator=gen, device=dev) < 0.5
        yield "none", torch.zeros(cap, dtype=torch.bool, device=dev)
        yield "all", torch.ones(cap, dtype=torch.bool, device=dev)

    def column(cap, dtype):
        """(cap,) random bits of a dtype (bool as 0 / 1)."""
        raw = torch.randint(-(1 << 62), 1 << 62, (cap,), generator=gen,
                            device=dev, dtype=torch.int64)
        if dtype == torch.bool:
            return raw > 0
        size = torch.empty((), dtype=dtype).element_size()
        return raw.view(torch.uint8).view(cap, 8)[:, :size].contiguous() \
            .view(dtype).reshape(cap)

    # the one-matrix form, the TPU function's contract
    for cap in (1000, 256 * 4096):
        chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                               dtype=torch.uint8)
        for name, sel in sel_cases(cap):
            check_filter_chunks(torch, ck, sel, chunks, name)
    # the column form: every width in one launch, caps that end mid tile
    fc_dtypes = (torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.float16, torch.int32, torch.uint32, torch.float32,
                 torch.int64, torch.uint64, torch.float64, torch.bool)
    for cap in (1, 4097, (1 << 20) + 3):
        cols = [column(cap, t) for t in fc_dtypes] + [torch.randint(
            0, 256, (cap, 20), generator=gen, device=dev,
            dtype=torch.uint8)]
        for name, sel in sel_cases(cap):
            before = ck.LAUNCHES["filter_compact_chunks"]
            check_filter(torch, ck, sel, cols, f"every width, {name}")
            check(ck.LAUNCHES["filter_compact_chunks"] == before + 1,
                  "filter_compact_columns: one launch for 13 columns")
    # views off the 16-byte grid and strided; more columns than a launch
    cap = (1 << 20) + 3
    base = torch.rand(cap + 16, generator=gen, device=dev) < 0.5
    mat = torch.randint(0, 256, (cap, 24), generator=gen, device=dev,
                        dtype=torch.uint8)
    wide = column(3 * cap + 16, torch.int64)
    check_filter(torch, ck, base[3:3 + cap],
                 [wide[3:3 + cap], wide[::3][:cap].view(torch.float64),
                  column(2 * cap, torch.int32)[1::2], mat[:, 3:11],
                  mat[:, 5], base[5:5 + cap]], "views")
    before = ck.LAUNCHES["filter_compact_chunks"]
    check_filter(torch, ck, base[:cap],
                 [column(cap, fc_dtypes[i % 12]) for i in range(70)],
                 "70 columns")
    check(ck.LAUNCHES["filter_compact_chunks"] == before + 3,
          "filter_compact_columns: 70 columns in 3 launches")
    del cols, base, mat, wide
    # the one-matrix form at 100M x 20 B
    cap = N_ROWS
    chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                           dtype=torch.uint8)
    for name, sel in sel_cases(cap):
        check_filter_chunks(torch, ck, sel, chunks, name)
        if name == "half":
            fc_matrix = measure_filter(torch, ck, sel, [chunks],
                                       "one matrix 100M x 20 B, half")
    del chunks, sel
    torch.cuda.empty_cache()

    # ---- tile_compact_local and tile_stitch against their plain versions
    padded = N_ROWS + (-N_ROWS) % ck.TILE_ROWS
    for cap in (1024, 1 << 20, padded):
        for name, sel in selection_cases(torch, cap, gen, dev):
            check_tile_compact(torch, ck, sel, name)
            check_tile_stitch(torch, ck, sel, cap, name)
        # a view that starts off the 16-byte grid is read as it is
        base = torch.rand(cap + 16, generator=gen, device=dev) < 0.5
        for off in (1, 4, 9):
            view = base[off:off + cap]
            check(view.data_ptr() % 16 != 0, "the view is aligned")
            check_tile_compact(torch, ck, view, f"view at byte {off}")
    # tiles with 0, 1, 1023 and 1024 selected rows; bytes other than 0 / 1
    sel = torch.zeros(4096, dtype=torch.bool, device=dev)
    sel[1024 + 5] = True
    sel[2048:3071] = True
    sel[3072:] = True
    check_tile_compact(torch, ck, sel, "0 / 1 / 1023 / 1024 a tile")
    check(ck.tile_compact_local(sel)[1].tolist() == [0, 1, 1023, 1024],
          "tile_compact_local: counts of the edge tiles")
    check_tile_stitch(torch, ck, sel, 4096, "0 / 1 / 1023 / 1024 a tile")
    check_tile_stitch(torch, ck, sel, 2048 + 3, "out_cap = the count + 3")
    raw = torch.randint(0, 256, (1 << 20,), generator=gen, device=dev,
                        dtype=torch.uint8)
    raw[torch.rand(1 << 20, generator=gen, device=dev) < 0.5] = 0
    loc, counts = ck.tile_compact_local(raw.view(torch.bool))
    ploc, pcounts = ck.tile_compact_local_plain(raw != 0)
    check(torch.equal(loc, ploc) and torch.equal(counts, pcounts),
          "tile_compact_local: a nonzero byte other than 1 is selected")
    del raw, loc, counts, ploc, pcounts, base, view
    for cap in (1000, N_ROWS):
        sel = torch.rand(cap, generator=gen, device=dev) < 0.5
        check_take_indices(torch, selection, Array, datatype.bool_, sel,
                           "half")
    del sel
    torch.cuda.empty_cache()

    # ---- dense_group_reduce against its plain version ------------------
    for G in (128, 1024, 4096):
        n = (1 << 20) + 3               # a last step of 3 rows
        gid, inputs, kinds = synthetic_dg_inputs(torch, n, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"TPU kinds G={G}")
        gid, inputs, kinds, valid = synthetic_native_dg_inputs(
            torch, n, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"native kinds G={G}",
                   valid)
        dg_compare(torch, ck, gid, inputs, kinds, G,
                   f"native kinds, no validity, G={G}")
        dg_compare(torch, ck, gid[1:], tuple(x[1:] for x in inputs), kinds,
                   G, f"native kinds, views off the 16-byte grid, G={G}",
                   tuple(x if x is None else x[1:] for x in valid))
        # the slots formed in the kernel from a key column: null keys,
        # keys outside the domain, rows past a length on the device
        lo = -(1 << 40)
        key = ck.DenseKey(gid.long() + lo, lo,
                          torch.tensor(n - n // 5, device=dev),
                          torch.rand(n, generator=gen, device=dev) < 0.9)
        check(int((ck.dense_key_gid(key, G) == G - 1).sum()) > n // 20,
              "dense_key_gid: the null-key slot")
        dg_compare(torch, ck, key, inputs, kinds, G,
                   f"native kinds, slots from the key column, G={G}", valid)
        dg_compare(torch, ck, ck.DenseKey(key.values[1:], lo, n // 2, None),
                   tuple(x[1:] for x in inputs), kinds, G,
                   f"native kinds, key view off the 16-byte grid, G={G}")
        # skew: every row in one slot; 60 % of the rows in one slot
        one = torch.full((n,), G - 1, dtype=torch.int32, device=dev)
        hot = torch.where(torch.rand(n, generator=gen, device=dev) < 0.6,
                          5, gid)
        for name, g in (("every row in one slot", one), ("60 % in one slot",
                                                         hot)):
            _, inputs, kinds, valid = synthetic_native_dg_inputs(
                torch, n, G, gen, dev, g)
            dg_compare(torch, ck, g, inputs, kinds, G,
                       f"native kinds, {name}, G={G}", valid)
        # the bool kinds: with and without validity, a view off the 4-byte
        # grid, every row in one slot, bytes other than 0 / 1
        gid, inputs, kinds, valid = synthetic_bool_dg_inputs(
            torch, n, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"bool kinds G={G}",
                   valid)
        dg_compare(torch, ck, gid[1:], tuple(x[1:] for x in inputs), kinds,
                   G, f"bool kinds, views off the 4-byte grid, G={G}",
                   tuple(x if x is None else x[1:] for x in valid))
        dg_compare(torch, ck, one, *synthetic_bool_dg_inputs(
            torch, n, G, gen, dev, one)[1:3], G,
            f"bool kinds, every row in one slot, G={G}")
        raw = torch.randint(0, 4, (n,), generator=gen, device=dev,
                            dtype=torch.uint8) * 85     # 0, 85, 170, 255
        got = ck.dense_group_reduce(gid, (raw.view(torch.bool),) * 2,
                                    ("any8", "all8"), G)
        want = ck.dense_group_reduce_plain(gid, (raw != 0,) * 2,
                                           ("any8", "all8"), G)
        check(all(torch.equal(x, y) for x, y in zip(
            [got[0]] + got[1], [want[0]] + want[1])),
            f"dense_group_reduce any8 / all8: a nonzero byte other than 1 "
            f"is not True, G={G}")
    del gid, inputs, valid, one, hot, g, key, raw, got, want

    # ---- partition_histogram against its plain version -----------------
    for n in (0, 1, 1000, 1 << 20, N_ROWS):
        for P in (1, 8, 128):
            for name, dest in partition_hist_cases(torch, n, P, gen, dev):
                check_partition_hist(torch, ck, dest, P, name)
    del dest
    # ... and both exchange kernels over segments of unequal lengths (every
    # other one a view off a 16-byte boundary), buckets that hold all, some
    # and none of the rows
    sizes = [0, 1, 8191, 8193, 1 << 19, (1 << 20) + 5, 3_125_000, 0]
    for P in (1, 8, 128):
        cases = {}
        for n in sizes:
            for name, dest in partition_hist_cases(torch, n + 1, P, gen, dev):
                cases.setdefault(name, []).append(
                    dest[1:] if len(cases.get(name, [])) % 2 else dest[:n])
        for name, dests in cases.items():
            for B in (max(sizes), 3_125_000 // (2 * P), 0):
                check_partition_segments(torch, ck, dests, P, B,
                                         f"{name}, 8 segments")
            check_partition_segments(torch, ck, dests[5:6], P, 1000,
                                     f"{name}, 1 segment")
    del cases, dests

    # ---- pack_key_lanes against its plain version ----------------------
    for n in (1, 1000, 1 << 20, N_ROWS):
        for L in (1, 3, 6):
            per = 30 // L
            lo = torch.randint(0, 1 << 32, (L,), generator=gen, device=dev)
            lo[0] = (1 << 32) - 3       # a window across the 2^32 wrap
            span = torch.full((L,), (1 << per) - 1, device=dev)
            shift = torch.arange(L - 1, -1, -1, device=dev) * per
            cols_ = [(int(lo[j]) + torch.randint(
                0, (1 << per) + 2, (n,), generator=gen, device=dev))
                % (1 << 32) for j in range(L)]
            active = torch.rand(n, generator=gen, device=dev) < 0.9
            check_pack_lanes(torch, ck, cols_, lo, span, shift, active,
                             "lanes of their own")
            if n <= 1 << 20:
                mat = torch.stack(cols_, dim=1)
                check_pack_lanes(torch, ck, mat.unbind(1), lo, span,
                                 shift + 9, None, "matrix columns, the top "
                                 "lane shifted out")
                del mat
            del cols_, active
    torch.cuda.empty_cache()

    # ---- the kernels under capture: one graph replayed on new data -------
    graph_phase = graph_replay_phase(torch, ck, dev, gen)
    torch.cuda.empty_cache()

    # ---- path 1: arrow_tpu_torch.entry.entry ----------------------------
    paths = {}      # each path's counted run: step ms and peak bytes
    paths["graph replay phase"] = graph_phase
    launches_dist = {}  # paths 3m / 3n: each process's counted launches
    t0 = time.time()
    cols = example_columns(N_ROWS, NUM_KEYS, args.seed)
    step, (b,) = entry_mod.entry(dev, N_ROWS, NUM_KEYS, args.seed)
    torch.cuda.synchronize()
    print(f"path 1 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 1
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("filter_compact_chunks", "dense_group_reduce"):
        check(launches[name] > 0, f"{name} was not launched on path 1's run")
    n_groups = check_slice(out, numpy_oracle(cols))
    print(f"path 1: {N_ROWS} rows in {secs * 1e3:.3f} ms = "
          f"{N_ROWS / secs:.6g} rows/s; {n_groups} groups match the numpy "
          f"oracle; peak device memory {peak} B; launches {launches}")
    paths["path 1"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del out, cols

    # one more run, recording the arguments each kernel gets on the path
    seen, seen_calls = {}, {}

    def recorded(mod, name, fn):
        """Run fn with mod.name wrapped to record its arguments: the last
        call's in ``seen``, every call's in ``seen_calls``."""
        inner = getattr(mod, name)

        def rec(*a):
            seen[name] = a
            seen_calls.setdefault(name, []).append(a)
            return inner(*a)
        setattr(mod, name, rec)
        try:
            return fn()
        finally:
            setattr(mod, name, inner)

    def forget():
        seen.clear()
        seen_calls.clear()

    # the function in ``selection`` that launches each kernel, where its
    # name is not the kernel's
    wrapper = {"filter_compact_chunks": "filter_compact_columns"}

    recorded(selection, "filter_compact_columns", lambda: recorded(
        hash_aggregate, "dense_group_reduce", lambda: step(b)))
    # and one with the filter layer (expression excluded) between events
    paths["path 1"]["filter_layer_ms"] = layer_ms(
        torch, entry_mod, "filter_batch", lambda: step(b))
    print(f"path 1 filter layer: {paths['path 1']['filter_layer_ms']:.3f} "
          "ms")
    del b, step

    # ---- path 1's kernels at its shapes: error, times, bound ------------
    sel, columns = seen["filter_compact_columns"]
    check(fc_widths(columns) == [8, 4, 8],
          f"path 1 gave B1 columns of {fc_widths(columns)} bytes, not its "
          "k, v and w as they are")
    fc = measure_filter(torch, ck, sel, columns, "path 1 shape")
    del sel, columns
    gid, inputs, kinds, G, valid = seen["dense_group_reduce"]
    check(isinstance(gid, ck.DenseKey) and
          kinds == ("first_row", "sum", "min", "sum64", "min64") and
          all(x is None for x in valid) and
          inputs[0] is inputs[1] and inputs[2] is inputs[3],
          f"path 1 gave dense_group_reduce {kinds} over {len(inputs)} "
          "streams: not the key and the columns themselves, each once")

    def measure_dg(gid, inputs, kinds, label):
        out_bytes = 4 * G + sum(ck._dg_acc_bytes(k, G) for k in kinds)
        bound, bound_all = dg_bounds(torch, ck, gid, inputs, G, out_bytes)
        m = {"max_abs_err": dg_compare(torch, ck, gid, inputs, kinds, G,
                                       label),
             "ms": cuda_ms(torch, lambda: ck.dense_group_reduce(
                 gid, inputs, kinds, G), 10),
             "plain_ms": cuda_ms(torch, lambda: ck.dense_group_reduce_plain(
                 gid, inputs, kinds, G), 3),
             "bound_ms": bound, "bound_ms_all_rows": bound_all,
             "library_ms": None}
        print(f"dense_group_reduce {label}: {m['ms']:.3f} ms, bound "
              f"{m['bound_ms']:.3f} ms ({m['bound_ms_all_rows']:.3f} with "
              f"every stream read at every row), plain "
              f"{m['plain_ms']:.3f} ms")
        return m

    dg = measure_dg(gid, inputs, kinds, "path 1 shape")
    # the same query as the earlier slices asked it: a gid built by
    # elementwise passes and twelve 32-bit streams
    v, w = inputs[0], inputs[2]
    del inputs
    gid = ck.dense_key_gid(gid, G)
    inputs9, kinds9 = nine_kind_call(torch, gid, v, w)
    dg9 = measure_dg(gid, inputs9, kinds9, "path 1 shape, nine-kind call")
    del gid, v, w, inputs9
    forget()
    torch.cuda.empty_cache()

    # ---- path 2: arrow_tpu_torch.entry.entry_generic --------------------
    t0 = time.time()
    cols = example_columns_generic(N_ROWS, NUM_KEYS_GENERIC, args.seed)
    step, (b,) = entry_mod.entry_generic(dev, N_ROWS, NUM_KEYS_GENERIC,
                                         args.seed, MAX_GROUPS_GENERIC)
    torch.cuda.synchronize()
    print(f"path 2 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 2
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches2 = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("tile_compact_local", "tile_stitch"):
        check(launches2[name] > 0,
              f"{name} was not launched on path 2's run")
    n_groups = check_slice_generic(
        out, numpy_oracle_generic(cols, NUM_KEYS_GENERIC))
    del out, cols

    # one more run, recording the kernels' arguments and the route taken
    routes = []
    probe_route = hash_aggregate.HashAggregate.probe_route

    def route_rec(self, batch, vals):
        routes.append(probe_route(self, batch, vals))
        return routes[-1]
    hash_aggregate.HashAggregate.probe_route = route_rec
    try:
        recorded(selection, "tile_compact_local", lambda: recorded(
            selection, "tile_stitch", lambda: step(b)))
    finally:
        hash_aggregate.HashAggregate.probe_route = probe_route
    check(len(routes) == 1, "path 2: one probe per step")
    route = routes[0][0]
    check(route in ("packed", "generic"), f"path 2 took route {route!r}")
    print(f"path 2: {N_ROWS} rows in {secs * 1e3:.3f} ms = "
          f"{N_ROWS / secs:.6g} rows/s; route {route}; {n_groups} groups "
          f"match the numpy oracle; peak device memory {peak} B; launches "
          f"{launches2}")
    paths["path 2"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del b, step

    # ---- path 2's kernels at its shape: error, times, bound -------------
    (sel,) = seen["tile_compact_local"]
    tc = measure_tile_compact(torch, ck, sel, "path 2 shape")
    # torch.nonzero gives the END result (both kernels), so the whole of
    # get_take_indices is timed beside it too
    mask = Array(datatype.bool_, sel[:N_ROWS])
    ti_ms = cuda_ms(torch, lambda: selection.get_take_indices(mask), 3)
    print(f"get_take_indices path 2 shape: {ti_ms:.3f} ms")
    cap = sel.shape[0]
    del sel, mask
    loc, counts, starts, out_cap = seen["tile_stitch"]
    check(out_cap == N_ROWS and loc.shape[0] == cap,
          f"path 2 stitched {loc.shape[0]} slots into {out_cap}")
    ts = measure_tile_stitch(torch, ck, loc, counts, starts, out_cap,
                             "path 2 shape")
    del loc, counts, starts
    forget()
    torch.cuda.empty_cache()

    # ---- path 3a: arrow_tpu_torch.entry.entry_distributed ---------------
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.ops.hashing import hash32
    from arrow_tpu_torch.parallel import dist_agg, shuffle
    t0 = time.time()
    cols = example_columns_generic(N_ROWS, NUM_KEYS_DIST, args.seed)
    # the step (it does not depend on the rows) over the columns made
    # above, staged as entry_distributed stages them
    step, _ = entry_mod.entry_distributed(
        dev, N_SHARDS, 1, NUM_KEYS_DIST, MAX_GROUPS_PER_SHARD, args.seed)
    b = batch_from_numpy(cols, device=dev)
    torch.cuda.synchronize()
    print(f"path 3 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    # exchanged per state row: key (8 B + 1 B validity), sum (8 + 8),
    # min (8 + 8), count_all (8) = 49 B; per shard a send buffer, a
    # received buffer and its compaction of P * G rows each
    xrows = N_SHARDS * MAX_GROUPS_PER_SHARD
    print(f"path 3a reckoned: exchange buffers {N_SHARDS} shards x 3 x "
          f"{xrows} rows x 49 B = {N_SHARDS * 3 * xrows * 49} B, input "
          f"{N_ROWS * 24} B")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 3a
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    table = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches3 = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3[kname] == 1,
              f"path 3a launched {kname} {launches3[kname]} times, not once "
              "for its one exchange on one card")
    check(launches3["filter_compact_chunks"] == N_SHARDS,
          "path 3a: one pre-filter kernel pass per shard")

    def shard_of(seed, n_shards):
        return lambda key: hash32([key], seed=seed) % n_shards

    oracle3a = numpy_oracle_generic(cols, NUM_KEYS_DIST)
    n_groups = check_dist_group_by(
        np, table, oracle3a, N_SHARDS,
        shard_of(dist_agg._STATE_EXCHANGE_SEED, N_SHARDS))
    print(f"path 3a: {N_ROWS} rows over {N_SHARDS} logical shards in "
          f"{secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; {n_groups} "
          f"groups match the numpy oracle, each on the one shard its hash "
          f"names; peak device memory {peak} B; launches {launches3}")
    paths["path 3a"] = {"ms": secs * 1e3, "peak_bytes": peak}
    # its result, row for row, for paths 3m and 3n
    ref3a = entry_mod.table_host_arrays({"entry_distributed": table})
    del table

    # one more run, recording what the kernels get (the last shard's
    # filter, the exchange's one call over all shards); then the kernels at
    # those arguments: error, times, bound
    _, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
        selection, "filter_compact_columns", lambda: recorded(
            shuffle, "partition_histogram_segments", lambda: recorded(
                shuffle, "partition_positions", lambda: step(b)))))
    check(sorts == 0, f"path 3a: {sorts} torch.sort calls in _bucket_rows")
    del step
    sel, columns = seen["filter_compact_columns"]
    check(sel.shape[0] >= N_ROWS // N_SHARDS and
          sum(fc_widths(columns)) == 24,
          f"path 3a: a shard's filter columns are {fc_widths(columns)} "
          f"bytes over {sel.shape[0]} rows")
    fc3a = measure_filter(torch, ck, sel, columns, "path 3a shape")
    del sel, columns
    dests, P = seen["partition_histogram_segments"]
    check(len(dests) == N_SHARDS and P == N_SHARDS and
          all(d.shape[0] == MAX_GROUPS_PER_SHARD for d in dests),
          f"path 3a: the exchange counts {len(dests)} segments over {P}")
    _, _, B, _ = seen["partition_positions"]
    ph = measure_hist(torch, ck, dests, P, "path 3a shape")
    pp = measure_positions(torch, ck, dests, P, B, "path 3a shape")
    del dests
    forget()
    torch.cuda.empty_cache()

    # ---- path 3b: the raw-row exchange (shuffle_batch) ------------------
    from arrow_tpu_torch.parallel import DistContext
    ctx = DistContext(devices=[dev] * N_SHARDS_RAW)
    sharded = ctx.shard_batch(b)
    bucket = 2 * sharded.local_capacity
    print(f"path 3b: {N_SHARDS_RAW} logical shards (8 would need "
          f"{2 * 8 * 2 * N_ROWS * 24} B for send buffers and results "
          f"alone), bucket capacity {bucket}, reckoned send + received + "
          f"result buffers {3 * N_SHARDS_RAW * 2 * N_ROWS * 24} B")

    def raw_exchange():
        return shuffle.shuffle_batch(sharded.shards, ["k"], ctx.devices,
                                     bucket_capacity=bucket)

    out = raw_exchange()        # warm-up
    torch.cuda.synchronize()
    del out

    # the timed, counted run of path 3b
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = raw_exchange()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches3b = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3b[kname] == 1,
              f"path 3b: {launches3b[kname]} {kname} launches, not one")
    check(not any(bool(err) for _, err in out), "path 3b: error flag set")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS_RAW)
    rows, k_sum, w_sum, v_sum = 0, 0, 0, 0.0
    for p, (rb, _) in enumerate(out):
        n = len(rb)
        rows += n
        k = rb.column("k")
        check(bool((place(k)[:n] == p).all()),
              f"path 3b: a row of shard {p} hashes elsewhere")
        k_sum += int(k.values[:n].sum())
        w_sum += int(rb.column("w").values[:n].sum())
        v_sum += float(rb.column("v").values[:n].sum())
        for name in rb.column_names:
            check(not bool(rb.column(name).values[n:].any()),
                  f"path 3b: {name} of shard {p} is not zero past its rows")
    check(rows == N_ROWS, f"path 3b: {rows} rows came out of {N_ROWS}")
    check(k_sum == int(cols["k"].sum()) and w_sum == int(cols["w"].sum()),
          "path 3b: integer column sums changed")
    check(abs(v_sum - float(cols["v"].sum())) <=
          1e-12 * float(np.abs(cols["v"]).sum()) + 1e-9,
          "path 3b: v column sum changed")
    print(f"path 3b: {N_ROWS} rows exchanged over {N_SHARDS_RAW} logical "
          f"shards in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; row "
          f"count and column sums kept, every row on shard hash(k) % "
          f"{N_SHARDS_RAW}, no error flag; peak device memory {peak} B; "
          f"launches {launches3b}")
    paths["path 3b"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del out, rb, k, cols
    torch.cuda.empty_cache()

    # ---- the exchange's kernels at path 3b's call (4 shards) ------------
    out, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
        shuffle, "partition_histogram_segments", lambda: recorded(
            shuffle, "partition_positions", raw_exchange)))
    check(sorts == 0, f"path 3b: {sorts} torch.sort calls in _bucket_rows")
    del out, sharded
    torch.cuda.empty_cache()
    (dests, P), (_, _, B, _) = (seen["partition_histogram_segments"],
                                seen["partition_positions"])
    check(len(dests) == N_SHARDS_RAW and P == N_SHARDS_RAW,
          f"path 3b: the exchange counts {len(dests)} segments over {P}")
    ph3b = measure_hist(torch, ck, dests, P, "path 3b shape")
    pp3b = measure_positions(torch, ck, dests, P, B, "path 3b shape")
    del dests
    forget()
    torch.cuda.empty_cache()

    # ---- one shard's send side of the exchange over 8 shards ------------
    # what 3b's cut leaves out on the send side: hash, dest, B4 and the
    # (8, B) send buffers of one 12.5M-row shard, B = 2 x its capacity
    shard = DistContext(devices=[dev] * N_SHARDS).shard_batch(b).shards[0]
    torch.cuda.reset_peak_memory_stats()
    before = dict(ck.LAUNCHES)
    send, counts, error = recorded(
        shuffle, "partition_histogram_segments",
        lambda: shuffle.partition_for_exchange(
            shard, ["k"], N_SHARDS, 2 * shard.capacity))
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(ck.LAUNCHES[kname] - before[kname] == 1,
              f"8-shard send: one shard alone launches {kname} once")
    (dest,), P = seen["partition_histogram_segments"]
    check(dest.shape[0] == N_ROWS // N_SHARDS and P == N_SHARDS,
          f"8-shard send: counted {dest.shape[0]} rows over {P}")
    check(int(counts.sum()) == len(shard) and not bool(error),
          "8-shard send: rows lost or error flag set")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS)(shard.column("k"))
    k_send = send[0]            # leaf 0: the values of column k, (P, B)
    for p in range(N_SHARDS):
        c = int(counts[p])
        check(torch.equal(k_send[p, :c],
                          shard.column("k").values[place == p]),
              f"8-shard send: bucket {p} does not hold its keys in order")
        check(not bool(k_send[p, c:].any()),
              f"8-shard send: bucket {p} is not zero past its rows")
    print(f"8-shard send side, one shard: {len(shard)} rows into "
          f"{N_SHARDS} buckets of {2 * shard.capacity}, each bucket its "
          f"keys in row order; peak device memory {peak} B")
    del send, k_send, place, shard, b
    torch.cuda.empty_cache()
    ph8 = measure_hist(torch, ck, [dest], P, "8-shard send shape")
    del dest
    forget()

    # ---- path 4: arrow_tpu_torch.entry.entry_sort (BASELINE #3) ---------
    from arrow_tpu_torch.entry import example_columns_join, \
        example_columns_sort
    from arrow_tpu_torch.ops import join as join_mod
    # path 5b's 100M Zipf probe keys, made once on the host in a thread
    # (numpy draws them with the GIL released) while paths 4 and 4d run
    data5b = ThreadPoolExecutor(1)
    cols5b = data5b.submit(example_columns_join, N_BUILD, N_ROWS, args.seed,
                           "zipf")

    def timed(fn, label, must_launch=(), warm=True, before=None):
        """Warm-up run (unless ``warm`` is False: an earlier path ran the
        same plan), then the timed, counted run of one path: (result,
        seconds, launches, peak bytes). ``before`` runs just before the
        counted run."""
        if warm:
            fn()
            torch.cuda.synchronize()
        if before is not None:
            before()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ck.LAUNCHES)
        for name in must_launch:
            check(counts[name] > 0,
                  f"{name} was not launched on {label}'s run")
        peak = torch.cuda.max_memory_allocated()
        paths[label] = {"ms": secs * 1e3, "peak_bytes": peak}
        return res, secs, counts, peak

    t0 = time.time()
    cols = example_columns_sort(N_ROWS, NUM_KEYS_SORT, args.seed)
    step, (b,) = entry_mod.entry_sort(dev, N_ROWS, args.seed, NUM_KEYS_SORT)
    torch.cuda.synchronize()
    print(f"path 4 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    # input 21 B a row; six int64 lanes and three sort words, the sort's
    # keys and indices, the permutation, the taken batch
    print(f"path 4 reckoned: input {N_ROWS * 21} B, lanes and sort words "
          f"{N_ROWS * 8 * 9} B, sort buffers {N_ROWS * 8 * 4} B, output "
          f"{N_ROWS * 29} B")
    (idx, out), secs, launches4, peak = timed(lambda: step(b), "path 4")
    # both sort oracles run in workers while paths 4d, 5a and 5b make their
    # data and run, and are checked after them (the script's time limit)
    from arrow_tpu_torch.entry import example_columns_sort_dict
    cols4d = example_columns_sort_dict(N_ROWS, args.seed, NUM_VALUES_DICT)
    sort_oracles = ThreadPoolExecutor(max_workers=2)
    want4 = sort_oracles.submit(numpy_sort_oracle, cols)
    want4d = sort_oracles.submit(numpy_sort_dict_oracle, cols4d)

    def check_path4(n, perm, got, cols, secs, peak, t0):
        """Path 4's permutation and taken columns, fetched to the host
        after its run, against numpy's."""
        want = want4.result()
        check(n == N_ROWS and perm.shape == (N_ROWS,),
              "path 4: the permutation's length")
        check(torch.equal(perm, torch.from_numpy(want)),
              "path 4: the permutation differs from numpy's stable sort")
        check(torch.equal(got["v"], torch.from_numpy(cols["v"][want])) and
              torch.equal(got["k1"], torch.from_numpy(cols["k1"][want])) and
              torch.equal(got["k2_valid"],
                          torch.from_numpy(cols["k2_valid"][want])),
              "path 4: the taken batch")
        print(f"path 4 (sort; second key int32, not a dictionary string): "
              f"{N_ROWS} rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} "
              f"rows/s; the permutation equals numpy's stable sort index "
              f"for index (oracle in a worker, checked "
              f"{time.time() - t0:.1f} s after the run); peak device memory "
              f"{peak} B; launches {launches4}")

    deferred = [(check_path4, (
        len(idx), idx.values.view(torch.int64).cpu(),
        {"v": out.column("v").values.cpu(),
         "k1": out.column("k1").values.cpu(),
         "k2_valid": out.column("k2").validity.cpu()},
        cols, secs, peak, time.time()))]
    del idx, out, cols, b, step
    torch.cuda.empty_cache()

    # ---- path 4d: BASELINE #3 with its dictionary-encoded string key ------
    t0 = time.time()
    step, (b,) = entry_mod.entry_sort_dict(dev, N_ROWS, args.seed,
                                           NUM_VALUES_DICT)
    torch.cuda.synchronize()
    print(f"path 4d data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    (idx, out), secs, launches4d, peak = timed(lambda: step(b), "path 4d")

    def check_path4d(n, perm, got, same_dict, cols, secs, peak, t0):
        """Path 4d's, as path 4's."""
        want = torch.from_numpy(want4d.result())
        check(n == N_ROWS and perm.shape == (N_ROWS,),
              "path 4d: the permutation's length")
        check(torch.equal(perm, want),
              "path 4d: the permutation differs from numpy's stable sort")
        check(torch.equal(got["i"], torch.from_numpy(cols["i"])[want]) and
              torch.equal(got["v"], torch.from_numpy(cols["v"])[want]) and
              torch.equal(got["s_valid"],
                          torch.from_numpy(cols["s_valid"])[want]) and
              torch.equal(got["s"], torch.from_numpy(np.where(
                  cols["s_valid"], cols["s_idx"], 0))[want]) and same_dict,
              "path 4d: the taken batch")
        print(f"path 4d (sort on a dictionary<int32, utf8> key and an "
              f"int64): {N_ROWS} rows in {secs * 1e3:.3f} ms = "
              f"{N_ROWS / secs:.6g} rows/s; the permutation equals numpy's "
              f"stable sort of the dictionary ranks index for index (oracle "
              f"in a worker, checked {time.time() - t0:.1f} s after the "
              f"run); peak device memory {peak} B; launches {launches4d}")

    s_out = out.column("s")
    deferred.append((check_path4d, (
        len(idx), idx.values.view(torch.int64).cpu(),
        {"i": out.column("i").values.cpu(), "v": out.column("v").values.cpu(),
         "s_valid": s_out.validity.cpu(), "s": s_out.values.cpu()},
        s_out.dictionary is b.column("s").dictionary, cols4d, secs, peak,
        time.time())))
    del idx, out, b, cols4d, step, s_out
    torch.cuda.empty_cache()

    # ---- paths 5a, 5b: arrow_tpu_torch.entry.entry_join (BASELINE #4) ---
    launches5 = {}
    for label, key_dist in (("path 5a", "uniform"), ("path 5b", "zipf")):
        t0 = time.time()
        if key_dist == "zipf":
            bcols, pcols = cols5b.result()
            data5b.shutdown()
        else:
            bcols, pcols = example_columns_join(N_BUILD, N_ROWS, args.seed,
                                                key_dist)
        # the step (the join's options do not depend on the probe rows)
        # over the columns made above, staged as entry_join stages them
        step, _ = entry_mod.entry_join(dev, N_BUILD, 1, args.seed, "inner",
                                       key_dist)
        bb = batch_from_numpy(bcols, device=dev)
        pb = batch_from_numpy(pcols, device=dev)
        torch.cuda.synchronize()
        print(f"{label} data: {N_BUILD} build and {N_ROWS} probe rows made "
              f"and staged in {time.time() - t0:.1f} s")
        # probe side: three key lanes, the packed key, the seg, take
        # indices, the left plane matrix and its gathered copy, the
        # payload gather, the output
        print(f"{label} reckoned: probe input {N_ROWS * 12} B, work arrays "
              f"{N_ROWS * (24 + 8 + 8 + 4 + 2 * 12 + 8)} B, output "
              f"{N_ROWS * 20} B")
        _, impl = entry_mod.join_routed(step.join, bb)
        check(impl == "packed_u", f"{label} took route {impl!r}")
        (out, tail), secs, counts, peak = timed(
            lambda: step(bb, pb), label,
            ("tile_compact_local", "tile_stitch"))
        launches5[label] = counts
        check(counts["pack_key_lanes"] == 3,
              f"{label}: pack_key_lanes launches (build rows, build segs, "
              f"probe rows): {counts['pack_key_lanes']}")
        check(tail is None, f"{label}: an inner join has no finish output")
        check(peak < 20e9, f"{label}: peak device memory {peak} B")
        t0 = time.time()
        n_out = check_join(torch, dev, label, (out,),
                           numpy_join_oracle(bcols, pcols, "inner"))
        print(f"{label} (inner join, {key_dist} probe keys, route {impl}): "
              f"{N_BUILD} x {N_ROWS} rows in {secs * 1e3:.3f} ms = "
              f"{N_ROWS / secs:.6g} probe rows/s; {n_out} output rows match "
              f"the numpy oracle as a multiset (oracle and compare "
              f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
              f"launches {counts}")
        del out, bcols, pcols
        if key_dist == "uniform":
            # one more run, recording what the probe gives pack_key_lanes;
            # then the kernel at those arguments: error, times, bound
            recorded(join_mod, "pack_key_lanes", lambda: step(bb, pb))
            lanes, lo, span, shift, active = seen["pack_key_lanes"]
            check(len(lanes) == 3 and lanes[0].shape[0] == N_ROWS and
                  active is not None,
                  f"path 5a packed {len(lanes)} lanes of "
                  f"{lanes[0].shape[0]} rows")
            pk = measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                                    "path 5a shape")
            del lanes, active
            forget()
        del bb, pb, step
        torch.cuda.empty_cache()

    # paths 4 and 4d against their oracles, computed in the meantime
    for fn, fn_args in deferred:
        fn(*fn_args)
    sort_oracles.shutdown()
    del deferred
    torch.cuda.empty_cache()

    # ---- path 5c: the other routes, 10M probe rows ----------------------
    wide_mul = 0x2545F4914F6CDD1D
    cases = (
        ("duplicate build keys", "inner", "packed",
         dict(build_keys=BUILD_KEYS_DUP,
              fanout_capacity=4 * N_PROBE_ROUTES), ()),
        ("two wide keys", "inner", "sort", dict(wide=True), ()),
        ("left semi", "left semi", "packed",
         dict(build_keys=BUILD_KEYS_DUP), ("filter_compact_chunks",)),
        ("left anti", "left anti", "packed",
         dict(build_keys=BUILD_KEYS_DUP), ("filter_compact_chunks",)),
        ("full outer + finish", "full outer", "packed",
         dict(build_keys=BUILD_KEYS_DUP,
              fanout_capacity=4 * N_PROBE_ROUTES),
         ("filter_compact_chunks",)),
        ("left anti, unique build keys", "left anti", "packed_u", {},
         ("tile_compact_local", "tile_stitch")),
    )
    shapes5c = []   # (kernel, label, call, numbers at that call's arguments)
    for name, join_type, want_impl, kw, must in cases:
        label = f"path 5c {name}"
        bcols, pcols = example_columns_join(
            N_BUILD, N_PROBE_ROUTES, args.seed, "uniform",
            kw.get("build_keys"), kw.get("wide", False))
        step, (bb, pb) = entry_mod.entry_join(
            dev, N_BUILD, N_PROBE_ROUTES, args.seed, join_type, **kw)
        _, impl = entry_mod.join_routed(step.join, bb)
        check(impl == want_impl, f"{label} took route {impl!r}")
        outs, secs, counts, peak = timed(lambda: step(bb, pb), label, must)
        launches5[label] = counts
        n_out = check_join(torch, dev, label, outs,
                           numpy_join_oracle(bcols, pcols, join_type),
                           wide_mul if kw.get("wide") else None)
        print(f"{label} ({join_type}, route {impl}): {N_BUILD} x "
              f"{N_PROBE_ROUTES} rows in {secs * 1e3:.3f} ms = "
              f"{N_PROBE_ROUTES / secs:.6g} probe rows/s; {n_out} output "
              f"rows match the numpy oracle as a multiset; peak device "
              f"memory {peak} B; launches {counts}")
        del outs, bcols, pcols
        # one more run, recording what this case gives each kernel it must
        # launch; then every such call's kernel at those arguments: error,
        # times, bound
        def run(names=must):
            if not names:
                return step(bb, pb)
            return recorded(selection, wrapper.get(names[0], names[0]),
                            lambda: run(names[1:]))
        run()
        del bb, pb, step
        for kname in must:
            calls = seen_calls[wrapper.get(kname, kname)]
            check(len(calls) == counts[kname],
                  f"{label}: {len(calls)} recorded calls of {kname}, "
                  f"{counts[kname]} launches")
            for i, a in enumerate(calls):
                at = f"{label} shape" + (f", call {i + 1}" if i else "")
                if kname == "filter_compact_chunks":
                    m = measure_filter(torch, ck, *a, at)
                elif kname == "tile_compact_local":
                    m = measure_tile_compact(torch, ck, *a, at)
                else:
                    m = measure_tile_stitch(torch, ck, *a, at)
                shapes5c.append((kname, label, i, m))
            del calls, a
        forget()
        torch.cuda.empty_cache()

    # ---- path 1b: path 1 on the sorted dense route ----------------------
    t0 = time.time()
    cols = example_columns(N_ROWS, NUM_KEYS_SORTED_DENSE, args.seed)
    step, (b,) = entry_mod.entry(dev, N_ROWS, NUM_KEYS_SORTED_DENSE,
                                 args.seed, MAX_GROUPS_SORTED_DENSE)
    torch.cuda.synchronize()
    print(f"path 1b data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    routes.clear()
    hash_aggregate.HashAggregate.probe_route = route_rec
    try:
        out, secs, launches1b, peak = timed(
            lambda: step(b), "path 1b", ("filter_compact_chunks",))
    finally:
        hash_aggregate.HashAggregate.probe_route = probe_route
    check(all(r[0] == "dense" and r[1]["impl"] == "sorted" for r in routes)
          and launches1b["dense_group_reduce"] == 0,
          f"path 1b took route {routes[-1]!r}")
    n_groups = check_slice(out, numpy_oracle(cols, NUM_KEYS_SORTED_DENSE))
    print(f"path 1b (sorted dense route, G {routes[-1][1]['G']}): {N_ROWS} "
          f"rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; "
          f"{n_groups} groups match the numpy oracle; peak device memory "
          f"{peak} B; launches {launches1b}")
    del out, cols, b, step
    torch.cuda.empty_cache()

    # ---- path 6: the Q3-shaped plan (BASELINE #5), entry_q3 ---------------
    from arrow_tpu_torch.acero import nodes as nodes_mod
    from arrow_tpu_torch.core.batch import Batch, Table
    from arrow_tpu_torch.entry import example_columns_q3
    from arrow_tpu_torch.entry import table_from_numpy as \
        table_from_numpy_dict
    from arrow_tpu_torch.profile_step import node_layers, node_times
    t0 = time.time()
    qcols = example_columns_q3(N_LINEITEM, args.seed)
    step, tables = entry_mod.entry_q3(dev, N_LINEITEM, args.seed,
                                      Q3_MAX_GROUPS, Q3_BATCH_ROWS)
    torch.cuda.synchronize()
    print(f"path 6 data: {N_LINEITEM} lineitem, "
          f"{tables[1].num_rows} orders, {tables[2].num_rows} customer rows "
          f"in {[len(t.batches) for t in tables]} batches, made and staged "
          f"in {time.time() - t0:.1f} s; input on the card "
          f"{sum(nodes_mod.batch_device_bytes(b) for t in tables for b in t.batches)} B")
    q3_kernels = ("filter_compact_chunks", "tile_compact_local", "tile_stitch",
                  "pack_key_lanes")
    out, secs, launches6, peak = timed(lambda: step(*tables), "path 6",
                                       q3_kernels)
    t0 = time.time()
    q3_oracle = numpy_q3_oracle(*qcols)
    n_groups = check_q3(out, q3_oracle)
    print(f"path 6 (Q3-shaped plan, one card, no dist=): {N_LINEITEM} "
          f"lineitem rows in {secs * 1e3:.3f} ms = {N_LINEITEM / secs:.6g} "
          f"rows/s; the top 10 of {n_groups} groups match the numpy oracle "
          f"(oracle {time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches6}; the eager driver, the default (the fused "
          f"driver's step: path 25 Q3)")
    # ---- paths 23 and 25 (Q3): Substrait, the three drivers ---------------
    launches_new = q3_driver_paths(torch, ck, entry_mod, dev, tables, qcols,
                                   out, q3_oracle, paths)
    print(f"path 6's step: eager {paths['path 6']['ms']:.3f} ms, fused "
          f"{paths['path 25 Q3 fused']['ms']:.3f} ms, lazy "
          f"{paths['path 25 Q3 lazy']['ms']:.3f} ms")
    torch.cuda.empty_cache()
    del out
    # one more run with each plan node's stream bracketed by CUDA events
    # and its host reads counted
    spans_, reads_, children_, restore = node_layers(torch, nodes_mod, Batch,
                                                     [])
    try:
        step(*tables)
        torch.cuda.synchronize()
    finally:
        restore()
    node_ms = node_times(spans_, reads_, children_)
    for name, m in node_ms.items():
        print(f"path 6 node {name:36s} own {m['own_ms']:10.3f} ms, "
              f"inclusive {m['inclusive_ms']:10.3f} ms, host reads "
              f"{m['host_reads']:.0f}")
    print(json.dumps({"path_6_nodes": node_ms}))
    # one more run, recording every call of the four kernels; each call
    # against its plain version, one full 2^22-row call of each timed
    forget()
    recorded(selection, "filter_compact_columns", lambda: recorded(
        selection, "tile_compact_local", lambda: recorded(
            selection, "tile_stitch", lambda: recorded(
                join_mod, "pack_key_lanes", lambda: step(*tables)))))
    for kname in q3_kernels:
        n_calls = len(seen_calls[wrapper.get(kname, kname)])
        check(n_calls == launches6[kname],
              f"path 6: {n_calls} recorded calls of {kname}, "
              f"{launches6[kname]} launches")
    for a in seen_calls["filter_compact_columns"]:
        check_filter(torch, ck, *a, "path 6 call")
    for (sel,) in seen_calls["tile_compact_local"]:
        check_tile_compact(torch, ck, sel, "path 6 call")
    for a in seen_calls["tile_stitch"]:
        check(torch.equal(ck.tile_stitch(*a), ck.tile_stitch_plain(*a)),
              "path 6: a tile_stitch call differs from its plain version")
    for a in seen_calls["pack_key_lanes"]:
        check_pack_lanes(torch, ck, *a, "path 6 call")

    def full(calls, rows_of):
        """The last call whose rows are a whole 2^22-row batch."""
        return [a for a in calls if rows_of(a) == Q3_BATCH_ROWS][-1]
    sel, columns = full(seen_calls["filter_compact_columns"],
                        lambda a: a[0].shape[0])
    fc6 = measure_filter(torch, ck, sel, columns, "path 6 shape")
    (sel,) = full(seen_calls["tile_compact_local"], lambda a: a[0].shape[0])
    tc6 = measure_tile_compact(torch, ck, sel, "path 6 shape")
    ts6 = measure_tile_stitch(torch, ck, *full(
        seen_calls["tile_stitch"], lambda a: a[0].shape[0]), "path 6 shape")
    lanes, lo, span, shift, active = full(
        [a for a in seen_calls["pack_key_lanes"] if a[4] is not None],
        lambda a: a[0][0].shape[0])
    pk6 = measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                             "path 6 shape")
    del sel, columns, lanes, active, step
    forget()
    torch.cuda.empty_cache()

    # ---- path 6s: path 6 with TPC-H's c_mktsegment, a dictionary string --
    # the step of entry_q3s (made at a small size: its tables are not the
    # ones run) on path 6's lineitem and orders and a customer table whose
    # c_mktsegment indices are path 6's c_seg codes
    step, _ = entry_mod.entry_q3s(dev, 768, args.seed, Q3_MAX_GROUPS,
                                  Q3_BATCH_ROWS)
    cu6s = table_from_numpy_dict(
        {"c_custkey": qcols[2]["c_custkey"],
         "c_mktsegment": qcols[2]["c_seg"]}, Q3_BATCH_ROWS, dev,
        {"c_mktsegment": np.array(entry_mod.SEGMENTS)})
    check(cu6s.schema.field("c_mktsegment").type.id ==
          "dictionary<values=string, indices=int32>",
          f"path 6s: c_mktsegment is {cu6s.schema.field('c_mktsegment').type}")
    tables6s = (tables[0], tables[1], cu6s)
    out, secs, launches6s, peak = timed(lambda: step(*tables6s), "path 6s",
                                        q3_kernels)
    check_q3(out, q3_oracle, "path 6s")
    print(f"path 6s (path 6 with c_mktsegment == 'BUILDING' on a dictionary "
          f"string): {N_LINEITEM} lineitem rows in {secs * 1e3:.3f} ms = "
          f"{N_LINEITEM / secs:.6g} rows/s; the top 10 match path 6's numpy "
          f"oracle; peak device memory {peak} B; launches {launches6s}")
    del out
    forget()
    recorded(selection, "filter_compact_columns", lambda: recorded(
        selection, "tile_compact_local", lambda: recorded(
            selection, "tile_stitch", lambda: recorded(
                join_mod, "pack_key_lanes", lambda: step(*tables6s)))))
    for kname in q3_kernels:
        n_calls = len(seen_calls[wrapper.get(kname, kname)])
        check(n_calls == launches6s[kname],
              f"path 6s: {n_calls} recorded calls of {kname}, "
              f"{launches6s[kname]} launches")
    for a in seen_calls["filter_compact_columns"]:
        check_filter(torch, ck, *a, "path 6s call")
    for (sel,) in seen_calls["tile_compact_local"]:
        check_tile_compact(torch, ck, sel, "path 6s call")
    for a in seen_calls["tile_stitch"]:
        check(torch.equal(ck.tile_stitch(*a), ck.tile_stitch_plain(*a)),
              "path 6s: a tile_stitch call differs from its plain version")
    for a in seen_calls["pack_key_lanes"]:
        check_pack_lanes(torch, ck, *a, "path 6s call")
    # the customer filter: its batch holds c_mktsegment's int32 indices
    # where the plan keeps the column
    n_cust = cu6s.num_rows
    cust = [a for a in seen_calls["filter_compact_columns"]
            if a[0].shape[0] == n_cust]
    check(len(cust) == 1, f"path 6s: {len(cust)} B1 calls of the customer "
          "filter's shape")
    fc6s = measure_filter(torch, ck, *cust[0], "path 6s customer filter")
    print(f"path 6s customer filter: B1 columns of widths "
          f"{fc_widths(cust[0][1])} B")
    del step, tables6s, cu6s, cust
    forget()
    torch.cuda.empty_cache()

    # ---- path 7b: the Q3 Declaration with dist= on path 6's tables -------
    from arrow_tpu_torch.parallel import DistContext
    dist_kernels = ("filter_compact_chunks", "partition_histogram",
                    "partition_positions", "pack_key_lanes")
    wrapper["partition_histogram"] = "partition_histogram_segments"

    def record_kernels(label, fn):
        """Run fn recording every call of the distributed paths' kernels
        (B1, B4, partition_positions and pack_key_lanes) in ``seen_calls``;
        checks that the exchange ran no torch.sort by destination."""
        _, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
            selection, "filter_compact_columns", lambda: recorded(
                shuffle, "partition_histogram_segments", lambda: recorded(
                    shuffle, "partition_positions", lambda: recorded(
                        join_mod, "pack_key_lanes", fn)))))
        check(sorts == 0, f"{label}: {sorts} torch.sort calls in "
              "_bucket_rows")

    def check_calls(label, counts):
        """Every recorded call of the distributed paths' kernels against
        its plain version; the launches those calls make against the path's
        counted run's."""
        for kname in dist_kernels:
            calls = seen_calls.get(wrapper.get(kname, kname), [])
            n = sum(kernel_launches(ck, kname, a) for a in calls)
            check(n == counts[kname], f"{label}: {len(calls)} recorded calls "
                  f"of {kname} make {n} launches, the counted run "
                  f"{counts[kname]}")
            for a in calls:
                if kname == "filter_compact_chunks":
                    check_filter(torch, ck, *a, f"{label} call")
                elif kname == "partition_histogram":
                    got = ck.partition_histogram_segments(*a)
                    want = ck.partition_histogram_segments_plain(*a)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"{label}: a partition_histogram call differs "
                          "from its plain version")
                    # one launch a shuffle over all the shards of the card
                    check(len(a[0]) == N_SHARDS, f"{label}: a "
                          f"partition_histogram call over {len(a[0])} shards")
                elif kname == "partition_positions":
                    dests, P, B, _ = a
                    check(all(torch.equal(g, w) for g, w in zip(
                        ck.partition_positions(*a),
                        ck.partition_positions_plain(dests, P, B))),
                          f"{label}: a partition_positions call differs "
                          "from its plain version")
                else:
                    check_pack_lanes(torch, ck, *a, f"{label} call", True)
        print(f"{label}: " + ", ".join(
            f"{len(seen_calls.get(wrapper.get(k, k), []))} {k}"
            for k in dist_kernels) + " calls equal their plain versions")

    # no shard's aggregate holds more groups than the whole table's (path
    # 6's max_groups, twice them); the groups each shard held are checked
    # after the run
    ctx7 = DistContext(devices=[dev] * N_SHARDS)

    def q3_dist():
        return entry_mod.q3_declaration(*tables, Q3_MAX_GROUPS,
                                        dist=ctx7).to_table()

    out, secs, launches7b, peak = timed(
        q3_dist, "path 7b", ("filter_compact_chunks", "partition_histogram",
                             "partition_positions"))
    check_q3(out, q3_oracle, "path 7b")
    print(f"path 7b (Q3-shaped plan, dist= over {N_SHARDS} logical shards "
          f"of one card, path 6's tables): {N_LINEITEM} lineitem rows in "
          f"{secs * 1e3:.3f} ms = {N_LINEITEM / secs:.6g} rows/s; the top 10 "
          f"match path 6's numpy oracle; peak device memory {peak} B; "
          f"launches {launches7b}")
    del out
    spans_, reads_, children_, restore = node_layers(torch, nodes_mod, Batch,
                                                     [])
    try:
        q3_dist()
        torch.cuda.synchronize()
    finally:
        restore()
    node_ms7 = node_times(spans_, reads_, children_)
    for name, m in node_ms7.items():
        print(f"path 7b node {name:36s} own {m['own_ms']:10.3f} ms, "
              f"inclusive {m['inclusive_ms']:10.3f} ms, host reads "
              f"{m['host_reads']:.0f}")
    print(json.dumps({"path_7b_nodes": node_ms7}))
    # one more run: every B1, B4 and pack_key_lanes call recorded and held
    # against its plain version, and the groups each shard's aggregate held
    forget()
    finalize_table = dist_agg.DistGroupBy.finalize_table
    held = []

    def finalize_rec(self, state):
        held.append([int(st[0].num_groups) for st in state])
        return finalize_table(self, state)
    dist_agg.DistGroupBy.finalize_table = finalize_rec
    try:
        record_kernels("path 7b", q3_dist)
    finally:
        dist_agg.DistGroupBy.finalize_table = finalize_table
    print(f"path 7b: groups a shard held {held[-1]}, max_groups "
          f"{Q3_MAX_GROUPS} a shard")
    check(max(held[-1]) * 2 <= Q3_MAX_GROUPS,
          f"path 7b: a shard held {max(held[-1])} groups")
    check_calls("path 7b", launches7b)
    sel, columns = full(seen_calls["filter_compact_columns"],
                        lambda a: a[0].shape[0])
    fc7b = measure_filter(torch, ck, sel, columns, "path 7b shape")
    hist_calls = seen_calls["partition_histogram_segments"]
    pos_calls = seen_calls["partition_positions"]
    check(len(hist_calls) == len(pos_calls) and all(
        h[0] is p[0] for h, p in zip(hist_calls, pos_calls)),
        "path 7b: each shuffle's positions call takes its histogram's dests")

    def fullest(i):
        """Of the shuffles whose shards hold ``rows`` rows each, the call
        whose dests send the most rows (a shard whose block of a batch is
        padding sends none)."""
        return max(i, key=lambda j: sum(int((d < hist_calls[j][1]).sum())
                                        for d in hist_calls[j][0]))
    # a lineitem batch's probe shuffle: 8 x 2^19 rows; the state-row
    # exchange: the last shuffle, 8 x 2^22 rows
    shape7b = {}
    for label, rows, idx in (
            ("path 7b lineitem shuffle", Q3_BATCH_ROWS // N_SHARDS,
             [j for j, a in enumerate(hist_calls)
              if a[0][0].shape[0] == Q3_BATCH_ROWS // N_SHARDS]),
            ("path 7b state rows", Q3_MAX_GROUPS, [len(hist_calls) - 1])):
        j = fullest(idx)
        dests, P = hist_calls[j]
        check(all(d.shape[0] == rows for d in dests),
              f"{label}: shards of {[d.shape[0] for d in dests]} rows")
        shape7b[label] = (measure_hist(torch, ck, dests, P, label),
                          measure_positions(torch, ck, dests, P,
                                            pos_calls[j][2], label))
    (ph7b, pp7b), (ph7b_state, pp7b_state) = shape7b.values()
    # one shard's build of the orders: its 25M-row accumulation's keys
    n_orders = tables[1].num_rows
    pk7b = measure_pack_lanes(torch, ck, *[
        a for a in seen_calls["pack_key_lanes"]
        if a[4] is None and a[0][0].shape[0] == n_orders][0],
        "path 7b orders build")
    del sel, columns, hist_calls, pos_calls, dests
    forget()

    # ---- paths 3m / 3n: path 3a's group-by across processes -------------
    # 3m: 2 processes x 4 logical shards of the card over gloo (the card's
    # tensors through pinned host buffers): path 3a's group-by at its full
    # size, dryrun_multichip's five checks and path 7b's Declaration on
    # the first Q3M_BATCHES of its lineitem batches; 3n: path 3a's
    # group-by in one process over 8 logical shards, the exchange through
    # a one-rank NCCL group. Both in worker processes (the parent's group
    # stays clean), each process's cases through ``dist_case_hook``.
    torch.cuda.empty_cache()
    params3m = dict(n_rows=N_ROWS_3M, num_keys=NUM_KEYS_DIST,
                    seed=args.seed, max_groups_per_shard=MAX_GROUPS_PER_SHARD,
                    n_lineitem=N_LINEITEM, q3_batches=Q3M_BATCHES,
                    q3_batch_rows=Q3_BATCH_ROWS, q3_max_groups=Q3_MAX_GROUPS)
    cut = Q3M_BATCHES * Q3_BATCH_ROWS
    with ThreadPoolExecutor(1) as pool:
        oracle3m = pool.submit(numpy_q3_oracle, {
            k: v[:cut] for k, v in qcols[0].items()}, *qcols[1:])
        t0 = time.time()
        got3m, outs3m = entry_mod.launch_dist_workers(
            2, [dev] * (N_SHARDS // 2), "gloo",
            ["entry_distributed", "dryrun", "q3"], params3m,
            hook="chip_smoke:dist_case_hook", timeout=DIST_TIMEOUT)
        secs3m = time.time() - t0
        oracle3m = oracle3m.result()
    lines3m = dist_lines(outs3m)
    check(len(got3m) == 2 and len(lines3m) == 6,
          f"path 3m: {len(got3m)} processes, {len(lines3m)} case lines")
    for r, got in enumerate(got3m):
        bits = same_rows_as_3a(got, ref3a, oracle3a, f"path 3m process {r}")
        check_q3_arrays(got, oracle3m, f"path 3m process {r} Q3")
        check(all(np.array_equal(got[k], got3m[0][k]) for k in got
                  if k.startswith("dryrun.")),
              f"path 3m: process {r}'s dry run differs from process 0's")
        print(f"path 3m process {r}: path 3a's {int(ref3a['entry_distributed.lengths'].sum())} "
              f"groups row for row (v_sum {'bit for bit' if bits else 'within tolerance'}), "
              f"the dry run's five checks, Q3 on {cut} lineitem rows "
              "against numpy")
    print(f"path 3m: 2 processes x {N_SHARDS // 2} shards over gloo in "
          f"{secs3m:.1f} s, worker start-up and data included")
    t0 = time.time()
    got3n, outs3n = entry_mod.launch_dist_workers(
        1, [dev] * N_SHARDS, "nccl", ["entry_distributed"], params3m,
        hook="chip_smoke:dist_case_hook", timeout=DIST_TIMEOUT)
    secs3n = time.time() - t0
    lines3n = dist_lines(outs3n)
    bits = same_rows_as_3a(got3n[0], ref3a, oracle3a, "path 3n")
    print(f"path 3n: one process x {N_SHARDS} shards, a one-rank NCCL "
          f"group, in {secs3n:.1f} s, worker start-up and data included; "
          f"path 3a's groups row for row (v_sum "
          f"{'bit for bit' if bits else 'within tolerance'})")
    for label, lines in (("path 3m", lines3m), ("path 3n", lines3n)):
        for ln in lines:
            c = ln["counted"]
            kl = {k: c["launches"][k] for k in DIST_KERNELS}
            print(f"{label} {ln['dist_case']} process {ln['rank']} of "
                  f"{ln['world']} ({ln['backend']}, {ln['shards']} shards): "
                  f"{c['ms']:.3f} ms, {c['bytes_remote']} B to other "
                  f"processes, collectives {c['collective_ms']:.3f} ms in "
                  f"{c['collective_calls']} calls, peak {c['peak_bytes']} "
                  f"B, launches {kl}")
    print(json.dumps({"path_3m_3n": {"3m": lines3m, "3n": lines3n,
                                     "3m_s": secs3m, "3n_s": secs3n}}))
    for label, lines in (("path 3m", lines3m), ("path 3n", lines3n)):
        for ln in lines:
            if ln["dist_case"] == "entry_distributed":
                key = f"{label} process {ln['rank']}"
                paths[key] = {"ms": ln["counted"]["ms"],
                              "peak_bytes": ln["counted"]["peak_bytes"]}
                launches_dist[key] = ln["counted"]["launches"]
    print(f"path 3n {lines3n[0]['counted']['ms']:.3f} ms beside path 3a "
          f"{paths['path 3a']['ms']:.3f} ms; path 3m "
          + ", ".join(f"{ln['counted']['ms']:.3f}" for ln in lines3m
                      if ln["dist_case"] == "entry_distributed") + " ms")
    del got3m, got3n, ref3a

    # ---- path 7s: path 7b with path 6s's string segment ------------------
    # the step of entry_q3_dist with segment= (made at a small size: its
    # tables are not the ones run) on the first N_LINEITEM_7S rows of path
    # 6's lineitem, its orders and path 6s's customer table (the script's
    # time limit); no warm-up: path 7b's runs were the same plan's
    step, _ = entry_mod.entry_q3_dist(dev, N_SHARDS, 768, args.seed,
                                      Q3_MAX_GROUPS, Q3_BATCH_ROWS,
                                      "BUILDING")
    cu7s = table_from_numpy_dict(
        {"c_custkey": qcols[2]["c_custkey"],
         "c_mktsegment": qcols[2]["c_seg"]}, Q3_BATCH_ROWS, dev,
        {"c_mktsegment": np.array(entry_mod.SEGMENTS)})
    n_li7s = -(-N_LINEITEM_7S // Q3_BATCH_ROWS) * Q3_BATCH_ROWS
    li7s = Table(tables[0].schema, tables[0].batches[:n_li7s //
                                                      Q3_BATCH_ROWS])
    tables7s = (li7s, tables[1], cu7s)
    oracle7s = numpy_q3_oracle({k: v[:n_li7s] for k, v in qcols[0].items()},
                               qcols[1], qcols[2])
    del tables, qcols, ctx7
    out, secs, launches7s, peak = timed(
        lambda: step(*tables7s), "path 7s",
        ("filter_compact_chunks", "partition_histogram",
         "partition_positions", "pack_key_lanes"), warm=False)
    check_q3(out, oracle7s, "path 7s")
    print(f"path 7s (path 7b with c_mktsegment == 'BUILDING' on a "
          f"dictionary string, cut to {n_li7s} lineitem rows): {n_li7s} "
          f"lineitem rows in {secs * 1e3:.3f} ms = {n_li7s / secs:.6g} "
          f"rows/s; the top 10 match numpy's oracle; peak device memory "
          f"{peak} B; launches {launches7s}")
    del out
    # one more run: every B1, B4 and pack_key_lanes call recorded and held
    # against its plain version (the dictionary c_mktsegment codes cross
    # the exchange here only)
    forget()
    record_kernels("path 7s", lambda: step(*tables7s))
    check_calls("path 7s", launches7s)
    del step, tables7s, cu7s, li7s
    forget()
    torch.cuda.empty_cache()

    # ---- path 6b: a Declaration whose join runs the Bloom pushdown -------
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       HashJoinNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.compute.expressions import field, literal
    from arrow_tpu_torch.entry import table_from_numpy
    bcols, pcols = example_columns_join(N_BUILD, N_PROBE_ROUTES, args.seed,
                                        "uniform", None, True)
    probe_t = table_from_numpy(pcols, Q3_BATCH_ROWS, dev)
    build_t = table_from_numpy(bcols, Q3_BATCH_ROWS, dev)
    keys = ["k", "k2"]

    def join_6b():
        return Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=keys, right_keys=keys,
            left_output=keys + ["lv"], right_output=["rv"],
            max_build_rows=N_BUILD), [
                Declaration.from_sequence([
                    Declaration("table_source",
                                TableSourceNodeOptions(probe_t)),
                    Declaration("filter", FilterNodeOptions(
                        field("lv") > literal(BLOOM_LV_MIN)))]),
                Declaration("table_source",
                            TableSourceNodeOptions(build_t))]).to_table()

    bloom_builds = []
    bloom_build = join_mod.HashJoin.bloom_build

    def counted_bloom(self, bs):
        bloom_builds.append(1)
        return bloom_build(self, bs)
    join_mod.HashJoin.bloom_build = counted_bloom
    try:
        table6b, secs, launches6b, peak = timed(join_6b, "path 6b",
                                                ("filter_compact_chunks",))
    finally:
        join_mod.HashJoin.bloom_build = bloom_build
    n_batches = len(probe_t.batches)
    check(len(bloom_builds) == 2, "path 6b: the Bloom bits were not built "
          "on each run")
    check(launches6b["filter_compact_chunks"] == 2 * n_batches,
          f"path 6b: {launches6b['filter_compact_chunks']} compaction "
          f"launches, not the filter's and the Bloom split's {n_batches} each")
    keep = pcols["lv"] > BLOOM_LV_MIN
    n_out = check_join(torch, dev, "path 6b", table6b.batches,
                       numpy_join_oracle(bcols, {n: v[keep] for n, v in
                                                 pcols.items()}, "inner"),
                       wide_mul)
    print(f"path 6b (filter -> hashjoin on two wide keys, route sort, Bloom "
          f"pushdown): {N_BUILD} x {N_PROBE_ROUTES} rows in {n_batches} "
          f"batches in {secs * 1e3:.3f} ms = {N_PROBE_ROUTES / secs:.6g} probe "
          f"rows/s; {n_out} output rows match the numpy oracle as a "
          f"multiset; peak device memory {peak} B; launches {launches6b}")
    del table6b, bcols, pcols
    recorded(selection, "filter_compact_columns", join_6b)
    calls = seen_calls["filter_compact_columns"]
    for a in calls:
        check_filter(torch, ck, *a, "path 6b call")
    # the calls alternate: a batch's filter, then its Bloom split
    fc6b = measure_filter(torch, ck, *calls[1], "path 6b Bloom split shape")
    del calls, probe_t, build_t
    forget()
    torch.cuda.empty_cache()

    # ---- path 7a: entry.dryrun_multichip over 8 logical shards ----------
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dry = entry_mod.dryrun_multichip(N_SHARDS, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches7a = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("filter_compact_chunks", "partition_histogram",
                 "partition_positions"):
        check(launches7a[name] > 0, f"{name} was not launched on path 7a")
    check(all(t.device.type == "cuda" for t in dry["q3"].batches),
          "path 7a: the Q3 result is not on the card")
    paths["path 7a"] = {"ms": secs * 1e3, "peak_bytes": peak}
    print(f"path 7a (dryrun_multichip({N_SHARDS}) on logical shards of the "
          f"card: group-by, join, sort, one hot key, Q3 with dist=): all five "
          f"checks pass in {secs * 1e3:.3f} ms (the first run: no warm-up); "
          f"peak device memory {peak} B; launches {launches7a}")
    del dry
    # one more run, every kernel call recorded and held against its plain
    # version
    record_kernels("path 7a",
                   lambda: entry_mod.dryrun_multichip(N_SHARDS, dev))
    check_calls("path 7a", launches7a)
    forget()

    # ---- path 7c: DistContext.join, BASELINE #4's shape cut to 25M -------
    t0 = time.time()
    bcols, pcols = example_columns_join(N_BUILD, N_PROBE_DIST, args.seed)
    step, (bb, pb) = entry_mod.entry_dist_join(dev, N_SHARDS, N_BUILD,
                                               N_PROBE_DIST, args.seed)
    torch.cuda.synchronize()
    print(f"path 7c data: {N_BUILD} build and {N_PROBE_DIST} probe rows "
          f"made and staged in {time.time() - t0:.1f} s")
    # probe side: send, stacked receive and compaction, 16 x the local
    # capacity rows a shard at 14 B (k, lv and their validity)
    print(f"path 7c reckoned: probe exchange buffers 3 x {2 * N_PROBE_DIST} "
          f"rows x 14 B = {3 * 2 * N_PROBE_DIST * 14} B (100M probe rows: "
          f"{3 * 2 * 100_000_000 * 14} B, with the build's and the "
          f"outputs more)")
    table7c, secs, launches7c, peak = timed(
        lambda: step(bb, pb), "path 7c", ("partition_histogram",
                                          "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches7c[kname] == 2,
              f"path 7c: {launches7c[kname]} {kname} launches, not one a "
              "side")
    check(len(table7c.batches) == N_SHARDS, "path 7c: a shard has no rows")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS)
    for p, rb in enumerate(table7c.batches):
        check(bool((place(rb.column("k"))[:len(rb)] == p).all()),
              f"path 7c: a row of shard {p} hashes elsewhere")
    t0 = time.time()
    n_out = check_join(torch, dev, "path 7c", table7c.batches,
                       numpy_join_oracle(bcols, pcols, "inner"))
    print(f"path 7c (DistContext.join inner over {N_SHARDS} logical shards, "
          f"route sort; probe cut to {N_PROBE_DIST} rows): {N_BUILD} x "
          f"{N_PROBE_DIST} rows in {secs * 1e3:.3f} ms = "
          f"{N_PROBE_DIST / secs:.6g} probe rows/s; {n_out} output rows match "
          f"the numpy oracle as a multiset (oracle {time.time() - t0:.1f} s), "
          f"each on the shard its key's hash names; peak device memory "
          f"{peak} B; launches {launches7c}")
    del table7c, bcols, pcols
    record_kernels("path 7c", lambda: step(bb, pb))
    check_calls("path 7c", launches7c)
    # the probe side's shuffle, the larger: 8 shards of 3,125,000 rows
    j = max(range(len(seen_calls["partition_positions"])),
            key=lambda i: seen_calls["partition_positions"][i][0][0].shape[0])
    dests, P, B, _ = seen_calls["partition_positions"][j]
    check(dests[0].shape[0] >= N_PROBE_DIST // N_SHARDS,
          f"path 7c: the probe shuffle's shards hold {dests[0].shape[0]} "
          "rows")
    ph7c = measure_hist(torch, ck, dests, P, "path 7c probe shuffle")
    pp7c = measure_positions(torch, ck, dests, P, B, "path 7c probe shuffle")
    del dests
    forget()
    del bb, pb, step
    torch.cuda.empty_cache()

    # ---- path 7d: DistContext.sort_by, BASELINE #3's columns cut to 25M --
    t0 = time.time()
    cols = example_columns_sort(N_SORT_DIST, NUM_KEYS_SORT, args.seed)
    step, (b,) = entry_mod.entry_dist_sort(dev, N_SHARDS, N_SORT_DIST,
                                           args.seed, NUM_KEYS_SORT,
                                           SORT_BUCKET_FACTOR)
    torch.cuda.synchronize()
    print(f"path 7d data: {N_SORT_DIST} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    print(f"path 7d reckoned: exchange buffers 3 x "
          f"{SORT_BUCKET_FACTOR * N_SORT_DIST} rows x 21 B = "
          f"{3 * SORT_BUCKET_FACTOR * N_SORT_DIST * 21} B (100M rows: "
          f"{3 * SORT_BUCKET_FACTOR * 100_000_000 * 21} B)")
    table7d, secs, launches7d, peak = timed(
        lambda: step(b), "path 7d", ("partition_histogram",
                                     "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches7d[kname] == 1,
              f"path 7d: {launches7d[kname]} {kname} launches, not one")
    t0 = time.time()
    want = torch.from_numpy(numpy_sort_oracle(cols))
    got = {c: torch.cat([x.column(c).values[:len(x)] for x in
                         table7d.batches]).cpu() for c in ("k1", "k2", "v")}
    got_valid = torch.cat([x.column("k2").validity[:len(x)]
                           for x in table7d.batches]).cpu()
    check(got["v"].shape[0] == N_SORT_DIST, "path 7d: the row count")
    check(torch.equal(got["k1"], torch.from_numpy(cols["k1"])[want]) and
          torch.equal(got["v"], torch.from_numpy(cols["v"])[want]) and
          torch.equal(got_valid, torch.from_numpy(cols["k2_valid"])[want]),
          "path 7d: the rows differ from numpy's stable sort's")
    ok = got_valid
    check(torch.equal(got["k2"][ok], torch.from_numpy(cols["k2"])[want][ok]),
          "path 7d: k2")
    lengths7d = [len(x) for x in table7d.batches]
    print(f"path 7d (DistContext.sort_by over {N_SHARDS} logical shards, "
          f"bucket factor {SORT_BUCKET_FACTOR}; cut to {N_SORT_DIST} rows): "
          f"{N_SORT_DIST} rows in {secs * 1e3:.3f} ms = "
          f"{N_SORT_DIST / secs:.6g} rows/s; the shards in order equal "
          f"numpy's stable sort row for row (oracle {time.time() - t0:.1f} "
          f"s); shard lengths {lengths7d}; peak device memory {peak} B; "
          f"launches {launches7d}")
    del table7d, got, got_valid, want, cols
    record_kernels("path 7d", lambda: step(b))
    check_calls("path 7d", launches7d)
    (dests, P), (_, _, B, _) = (seen["partition_histogram_segments"],
                                seen["partition_positions"])
    ph7d = measure_hist(torch, ck, dests, P, "path 7d sort shuffle")
    pp7d = measure_positions(torch, ck, dests, P, B, "path 7d sort shuffle")
    del dests
    forget()
    del b, step
    torch.cuda.empty_cache()

    # ---- path 7e: path 7d with path 4d's dictionary string key -----------
    from arrow_tpu_torch.entry import example_columns_sort_dist_dict
    t0 = time.time()
    cols = example_columns_sort_dist_dict(N_SORT_DIST, NUM_KEYS_SORT,
                                          args.seed, NUM_VALUES_DICT)
    step, (b,) = entry_mod.entry_dist_sort_dict(
        dev, N_SHARDS, N_SORT_DIST, args.seed, NUM_KEYS_SORT,
        NUM_VALUES_DICT, SORT_BUCKET_FACTOR)
    torch.cuda.synchronize()
    print(f"path 7e data: {N_SORT_DIST} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    table7e, secs, launches7e, peak = timed(
        lambda: step(b), "path 7e", ("partition_histogram",
                                     "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches7e[kname] == 1,
              f"path 7e: {launches7e[kname]} {kname} launches, not one")
    t0 = time.time()
    want = torch.from_numpy(numpy_dist_sort_dict_oracle(cols,
                                                        NUM_VALUES_DICT))
    vocab = b.column("s").dictionary
    check(all(x.column("s").dictionary is vocab for x in table7e.batches),
          "path 7e: a shard's s does not carry the input's dictionary")
    got = {c: torch.cat([x.column(c).values[:len(x)] for x in
                         table7e.batches]).cpu() for c in ("k1", "s", "v")}
    got_valid = torch.cat([x.column("s").validity[:len(x)]
                           for x in table7e.batches]).cpu()
    check(got["v"].shape[0] == N_SORT_DIST, "path 7e: the row count")
    check(torch.equal(got["k1"], torch.from_numpy(cols["k1"])[want]) and
          torch.equal(got["v"], torch.from_numpy(cols["v"])[want]) and
          torch.equal(got_valid, torch.from_numpy(cols["s_valid"])[want]),
          "path 7e: the rows differ from numpy's stable sort's")
    check(torch.equal(got["s"][got_valid],
                      torch.from_numpy(cols["s_idx"])[want][got_valid]),
          "path 7e: s")
    lengths7e = [len(x) for x in table7e.batches]
    print(f"path 7e (DistContext.sort_by on k1, then a dictionary<int32, "
          f"utf8> key descending, over {N_SHARDS} logical shards, bucket "
          f"factor {SORT_BUCKET_FACTOR}; cut to {N_SORT_DIST} rows): "
          f"{N_SORT_DIST} rows in {secs * 1e3:.3f} ms = "
          f"{N_SORT_DIST / secs:.6g} rows/s; the shards in order equal "
          f"numpy's stable sort row for row (oracle {time.time() - t0:.1f} "
          f"s); shard lengths {lengths7e}; peak device memory {peak} B; "
          f"launches {launches7e}")
    del table7e, got, got_valid, want, cols, vocab
    record_kernels("path 7e", lambda: step(b))
    check_calls("path 7e", launches7e)
    forget()
    del b, step
    torch.cuda.empty_cache()

    # ---- path 3s: path 3a keyed by a dictionary of C_NAME strings --------
    t0 = time.time()
    cols = example_columns_generic(N_ROWS, NUM_KEYS_DIST, args.seed)
    step, (b,) = entry_mod.entry_dist_dict(
        dev, N_SHARDS, N_ROWS, NUM_KEYS_DIST, MAX_GROUPS_PER_SHARD,
        args.seed)
    torch.cuda.synchronize()
    print(f"path 3s data: {N_ROWS} rows over a dictionary of "
          f"{NUM_KEYS_DIST} names made and staged in "
          f"{time.time() - t0:.1f} s")
    table3s, secs, launches3s, peak = timed(
        lambda: step(b), "path 3s", ("filter_compact_chunks",
                                     "partition_histogram",
                                     "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3s[kname] == 1,
              f"path 3s launched {kname} {launches3s[kname]} times, not "
              "once for its one exchange on one card")
    check(launches3s["filter_compact_chunks"] == N_SHARDS,
          "path 3s: one pre-filter kernel pass per shard")
    names = b.column("name").dictionary
    check(all(x.column("name").dictionary is names
              for x in table3s.batches),
          "path 3s: a shard's groups do not carry the input's dictionary")
    t0 = time.time()
    n_groups = check_dist_group_by(
        np, table3s, numpy_oracle_generic(cols, NUM_KEYS_DIST), N_SHARDS,
        shard_of(dist_agg._STATE_EXCHANGE_SEED, N_SHARDS), "name",
        "path 3s")
    print(f"path 3s (path 3a keyed by a dictionary<int32, utf8> of "
          f"{NUM_KEYS_DIST} C_NAME strings): {N_ROWS} rows over {N_SHARDS} "
          f"logical shards in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} "
          f"rows/s; {n_groups} groups match the numpy oracle by index "
          f"(oracle {time.time() - t0:.1f} s), each on the one shard its "
          f"content hash names; peak device memory {peak} B; launches "
          f"{launches3s}")
    del table3s, cols, names
    record_kernels("path 3s", lambda: step(b))
    check_calls("path 3s", launches3s)
    forget()
    del b, step
    torch.cuda.empty_cache()

    # ---- path 8: filter -> group-by on a raw string key ----------------
    from arrow_tpu_torch.entry import example_columns_strings
    t0 = time.time()
    cols = example_columns_strings(N_ROWS, NUM_KEYS_STRINGS, args.seed)
    step, (b,) = entry_mod.entry_strings(dev, N_ROWS, NUM_KEYS_STRINGS,
                                         args.seed, MAX_GROUPS_STRINGS)
    torch.cuda.synchronize()
    pool_bytes = b.column("name").values.shape[0]
    print(f"path 8 data: {N_ROWS} rows, a {pool_bytes}-byte string pool, "
          f"made and staged in {time.time() - t0:.1f} s")
    out, secs, launches8, peak = timed(lambda: step(b), "path 8",
                                       ("filter_compact_chunks",))
    check(launches8["filter_compact_chunks"] == 2,
          f"path 8: {launches8['filter_compact_chunks']} B1 launches, not "
          "the rows' and the pool's")
    check(peak < 40e9, f"path 8: peak device memory {peak} B")
    t0 = time.time()
    oracle8 = numpy_oracle_generic(
        {"k": cols["custkey"], "v": cols["v"], "w": cols["w"]},
        NUM_KEYS_STRINGS + 1)
    keys8 = decode_names(torch, out.column("name"), b"Customer#", 9)
    n_groups = check_slice_generic(out, oracle8, "path 8", keys8)
    print(f"path 8 (filter -> group-by on a raw 18-byte string key): "
          f"{N_ROWS} rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} "
          f"rows/s; {n_groups} groups match the numpy oracle by customer "
          f"key (oracle {time.time() - t0:.1f} s); peak device memory "
          f"{peak} B; launches {launches8}")
    del out, oracle8, keys8
    # the filter layer, and in it the pool compaction (the per-byte
    # selection and the second B1 launch)
    paths["path 8"]["filter_layer_ms"] = layer_ms(
        torch, entry_mod, "filter_batch", lambda: step(b))
    paths["path 8"]["pool_ms"] = layer_ms(torch, selection, "_filter_pool",
                                          lambda: step(b))
    print(f"path 8 filter layer {paths['path 8']['filter_layer_ms']:.3f} ms,"
          f" of it the pool compaction {paths['path 8']['pool_ms']:.3f} ms")
    forget()
    recorded(selection, "filter_compact_columns", lambda: step(b))
    calls8 = seen_calls["filter_compact_columns"]
    check(len(calls8) == 2 and calls8[1][0].shape[0] == pool_bytes,
          f"path 8: {len(calls8)} recorded B1 calls")
    fc8 = [measure_filter(torch, ck, *a, f"path 8 {what}")
           for a, what in zip(calls8, ("rows", "pool"))]
    del calls8
    # path 8's name column sorted, and compared row by row with itself in
    # that order: the peaks of the prefix-word lanes (4-byte windows of the
    # pool) and of the Array-vs-Array walk at a 1.8e9-byte pool. Names
    # order as their custkeys do, ties in row order.
    from arrow_tpu_torch.ops.selection import take_array
    from arrow_tpu_torch.ops.sorting import (SortKey, SortOptions,
                                             sort_indices_batch)
    from arrow_tpu_torch.ops.strings import compare_varlen
    keys_dev = torch.from_numpy(cols["custkey"]).to(dev)
    del cols
    perm8, secs, _, peak = timed(lambda: sort_indices_batch(
        b, SortOptions([SortKey("name", "ascending")])), "path 8 sort")
    perm = perm8.values.view(torch.int64)[:N_ROWS]
    check(torch.equal(perm, torch.sort(keys_dev, stable=True).indices),
          "path 8 sort: the permutation is not the custkeys' stable order")
    check(peak < 40e9, f"path 8 sort: peak device memory {peak} B")
    print(f"path 8 sort on the name column: {N_ROWS} rows in "
          f"{secs * 1e3:.3f} ms; the custkeys' stable order; peak device "
          f"memory {peak} B")
    name = b.column("name")
    name_sorted = take_array(name, perm8)
    less, secs, _, peak = timed(lambda: compare_varlen(
        "less", name, name_sorted), "path 8 compare")
    check(torch.equal(less[:N_ROWS], keys_dev < keys_dev[perm]),
          "path 8 compare: name < name[perm] differs from the custkeys'")
    check(peak < 40e9, f"path 8 compare: peak device memory {peak} B")
    print(f"path 8 compare name < name[perm] (Array vs Array): {N_ROWS} "
          f"rows in {secs * 1e3:.3f} ms; equal to the custkeys'; peak "
          f"device memory {peak} B")
    del perm8, perm, name, name_sorted, less, keys_dev, b, step
    forget()
    torch.cuda.empty_cache()

    # ---- path 1c: any / all on the dense kernel --------------------------
    from arrow_tpu_torch.entry import example_columns_any_all, \
        example_columns_q6
    t0 = time.time()
    cols = example_columns_any_all(N_ROWS, NUM_KEYS, args.seed)
    step, (b,) = entry_mod.entry_any_all(dev, N_ROWS, NUM_KEYS, args.seed)
    torch.cuda.synchronize()
    print(f"path 1c data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s; input {N_ROWS * 23} B (k, v, w, f "
          "and its validity)")
    out, secs, launches1c, peak = timed(lambda: step(b), "path 1c", (
        "filter_compact_chunks", "dense_group_reduce"))
    check(launches1c["filter_compact_chunks"] == 1 and
          launches1c["dense_group_reduce"] == 1,
          f"path 1c: launches {launches1c}, not B1 once and B3 once")
    t0 = time.time()
    n_groups = check_any_all(out, numpy_any_all_oracle(cols))
    print(f"path 1c (any / all on the dense kernel): {N_ROWS} rows in "
          f"{secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; {n_groups} "
          f"groups match the numpy oracle, any / all and their nulls "
          f"exactly (oracle {time.time() - t0:.1f} s); peak device memory "
          f"{peak} B; launches {launches1c}")
    del out, cols
    forget()
    recorded(hash_aggregate, "dense_group_reduce", lambda: step(b))
    del b, step
    gid, inputs, kinds, G1c, valid = seen["dense_group_reduce"]
    check(isinstance(gid, ck.DenseKey) and G1c == 1024 and
          {"any8", "all8"} <= set(kinds),
          f"path 1c gave dense_group_reduce kinds {kinds} at G={G1c}")
    ia = kinds.index("any8")
    f_col = inputs[sum(ck._DG_ARITY[kd][0] for kd in kinds[:ia])]
    f_ok = valid[ia]
    check(f_col.dtype == torch.bool and f_ok is not None,
          "path 1c: the bool kinds do not read the bool column and its "
          "validity as they lie")

    def measure_b3(kinds_, inputs_, valid_, label):
        out_bytes = 4 * G1c + sum(ck._dg_acc_bytes(k, G1c) for k in kinds_)
        m = {"max_abs_err": dg_compare(torch, ck, gid, inputs_, kinds_, G1c,
                                       label, valid_),
             "ms": cuda_ms(torch, lambda: ck.dense_group_reduce(
                 gid, inputs_, kinds_, G1c, valid_), 10),
             "plain_ms": cuda_ms(torch, lambda: ck.dense_group_reduce_plain(
                 gid, inputs_, kinds_, G1c, valid_), 3),
             "bound_ms": dg_bounds(torch, ck, gid, inputs_, G1c, out_bytes,
                                   valid_)[0]}
        print(f"dense_group_reduce {label}: {m['ms']:.3f} ms, bound "
              f"{m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms")
        return m

    dg1c = measure_b3(kinds, inputs, valid, "path 1c shape")
    # the two bool kinds alone, and the PyTorch call for one of them: a
    # scatter_reduce_ "amax" of an int32 copy of the column (nulls as 0)
    # into the slots, the copy timed beside it
    dg1c_aa = measure_b3(("any8", "all8"), (f_col, f_col), (f_ok, f_ok),
                         "path 1c shape, any8 + all8 alone")
    slot = ck.dense_key_gid(gid, G1c).long().clamp_(-1, G1c)
    slot = torch.where(slot < 0, G1c, slot)
    x32 = torch.where(f_ok, f_col, False).to(torch.int32)
    dg1c_aa["library_copy_ms"] = cuda_ms(
        torch, lambda: torch.where(f_ok, f_col, False).to(torch.int32), 10)
    dg1c_aa["library_ms"] = cuda_ms(torch, lambda: torch.zeros(
        G1c + 1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, slot, x32, "amax"), 10)
    rows, outs = ck.dense_group_reduce(gid, (f_col,), ("any8",), G1c,
                                       (f_ok,))
    lib = torch.zeros(G1c + 1, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, slot, x32, "amax")[:G1c]
    check(torch.equal(outs[0], lib), "path 1c: any8 differs from the "
          "scatter_reduce_ amax of the int32 copy")
    print(f"path 1c any8 + all8 alone: {dg1c_aa['ms']:.3f} ms; torch "
          f"scatter_reduce_ amax of an int32 copy (any alone) "
          f"{dg1c_aa['library_ms']:.3f} ms after a "
          f"{dg1c_aa['library_copy_ms']:.3f} ms copy")
    dg1c["library_ms"] = None
    del gid, inputs, valid, f_col, f_ok, slot, x32, rows, outs, lib
    forget()
    torch.cuda.empty_cache()

    # ---- path 9: db-benchmark groupby q6 on one card ---------------------
    from arrow_tpu_torch.acero import nodes as nodes_mod
    from arrow_tpu_torch.ops import aggregates, distinct
    t0 = time.time()
    cols = example_columns_q6(N_ROWS, args.seed, Q6_K)
    step, (t9,) = entry_mod.entry_groupby_q6(dev, N_ROWS, args.seed, Q6_K)
    torch.cuda.synchronize()
    staged = sum(nodes_mod.batch_device_bytes(x) for x in t9.batches)
    print(f"path 9 data: db-benchmark G1_1e8_1e2_0_0, {N_ROWS} rows x 9 "
          f"columns ({staged} B on the card) made and staged in "
          f"{time.time() - t0:.1f} s")
    # the sort route's buffers: key lanes and their packed word (8 B each
    # a row), the sort's indices, v3 in sorted order (8 B), the median's
    # buffer (12 B a row)
    print(f"path 9 reckoned: input {staged} B, grouping {N_ROWS * 8 * 4} B, "
          f"median buffer {N_ROWS * 12} B")
    out9, secs, launches9, peak = timed(lambda: step(t9), "path 9")
    t0 = time.time()
    oracle9 = numpy_q6_oracle(cols)
    n_groups = check_q6(out9, oracle9, "path 9")
    print(f"path 9 (db-benchmark groupby q6, median and sd of v3 by id4, "
          f"id5, through Table.group_by): {N_ROWS} rows in "
          f"{secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; {n_groups} "
          f"groups match numpy's median and std(ddof=1) (oracle "
          f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches9}")
    del out9, cols
    layers9 = {}
    for mod, name, label in (
            (hash_aggregate.HashAggregate, "probe_scalars", "route_probe"),
            (distinct, "_lexsort_perm", "sort"),
            (aggregates._GroupedMoments, "consume_grouped", "sd_consume"),
            (aggregates.GroupedTDigest, "consume_grouped", "median_consume"),
            (aggregates.GroupedTDigest, "finalize", "median_finalize")):
        layers9[label] = layer_ms(torch, mod, name, lambda: step(t9))
    paths["path 9"]["layers_ms"] = layers9
    print("path 9 layers (device ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers9.items()))
    del t9, step
    torch.cuda.empty_cache()

    # ---- path 3q: q6 over 4 logical shards (the raw-row exchange) --------
    t0 = time.time()
    step, (b,) = entry_mod.entry_dist_groupby_q6(dev, N_SHARDS_Q6, N_ROWS,
                                                 args.seed, Q6_K)
    torch.cuda.synchronize()
    recv = N_SHARDS_Q6 * 2 * (N_ROWS // N_SHARDS_Q6)
    print(f"path 3q data: {N_ROWS} rows of id4, id5, v3 staged in "
          f"{time.time() - t0:.1f} s; reckoned: exchange send and receive "
          f"buffers {N_SHARDS_Q6} shards x 2 x {recv} rows x 19 B = "
          f"{N_SHARDS_Q6 * 2 * recv * 19} B, median buffers "
          f"{N_SHARDS_Q6} x {recv} rows x 12 B = "
          f"{N_SHARDS_Q6 * recv * 12} B, one shard's grouping sort "
          f"{recv * 8 * 4} B")
    out3q, secs, launches3q, peak = timed(lambda: step(b), "path 3q", (
        "partition_histogram", "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3q[kname] == 1, f"path 3q launched {kname} "
              f"{launches3q[kname]} times, not once for its one exchange")
    check(peak < 72e9, f"path 3q: peak device memory {peak} B")
    t0 = time.time()
    n_groups = check_q6(out3q, oracle9, "path 3q")
    print(f"path 3q (q6 over {N_SHARDS_Q6} logical shards, "
          f"DistContext.group_by's raw-row exchange): {N_ROWS} rows in "
          f"{secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; {n_groups} "
          f"groups match path 9's oracle as a set (check "
          f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches3q}")
    del out3q, oracle9
    forget()
    out3q, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
        shuffle, "partition_histogram_segments", lambda: recorded(
            shuffle, "partition_positions", lambda: step(b))))
    check(sorts == 0, f"path 3q: {sorts} torch.sort calls in _bucket_rows")
    del out3q, b, step
    torch.cuda.empty_cache()
    (dests, P), (_, _, B, _) = (seen["partition_histogram_segments"],
                                seen["partition_positions"])
    check(len(dests) == N_SHARDS_Q6 and P == N_SHARDS_Q6,
          f"path 3q: the exchange counts {len(dests)} segments over {P}")
    ph3q = measure_hist(torch, ck, dests, P, "path 3q shape")
    pp3q = measure_positions(torch, ck, dests, P, B, "path 3q shape")
    del dests
    forget()
    torch.cuda.empty_cache()

    # ---- paths 10-12 and the sweep: the string family --------------------
    from arrow_tpu_torch.ops import strings_regex
    import pyarrow as pa
    from arrow_tpu_torch.utils.tpch import tpch_table
    from arrow_tpu_torch.acero import spill as spill_mod
    plan_kernels = ("filter_compact_chunks", "tile_compact_local",
                    "tile_stitch", "pack_key_lanes", "dense_group_reduce",
                    "partition_histogram", "partition_positions")
    # the Grace join's split calls the exchange's kernels from acero/spill
    plan_wrapper = dict(wrapper, partition_histogram=(
        "partition_histogram_segments"))

    def check_plan_calls(label, fn, counts):
        """One more run of fn recording every call of the kernels the
        plan paths 10-22 reach; each against its plain version, the
        calls' launches against the counted run's."""
        forget()
        out_ = recorded(selection, "filter_compact_columns", lambda: recorded(
            selection, "tile_compact_local", lambda: recorded(
                selection, "tile_stitch", lambda: recorded(
                    join_mod, "pack_key_lanes", lambda: recorded(
                        hash_aggregate, "dense_group_reduce", lambda: recorded(
                            spill_mod, "partition_histogram_segments",
                            lambda: recorded(spill_mod, "partition_positions",
                                             fn)))))))
        del out_
        for kname in plan_kernels:
            calls = seen_calls.get(plan_wrapper.get(kname, kname), [])
            n = sum(kernel_launches(ck, kname, a) for a in calls) \
                if kname in ("filter_compact_chunks", "pack_key_lanes",
                             "partition_histogram", "partition_positions") \
                else len(calls)
            check(n == counts[kname], f"{label}: {len(calls)} recorded "
                  f"calls of {kname} make {n} launches, the counted run "
                  f"{counts[kname]}")
            for a in calls:
                if kname == "filter_compact_chunks":
                    check_filter(torch, ck, *a, f"{label} call")
                elif kname == "tile_compact_local":
                    check_tile_compact(torch, ck, a[0], f"{label} call")
                elif kname == "tile_stitch":
                    check(torch.equal(ck.tile_stitch(*a),
                                      ck.tile_stitch_plain(*a)),
                          f"{label}: a tile_stitch call differs")
                elif kname == "pack_key_lanes":
                    check_pack_lanes(torch, ck, *a, f"{label} call", True)
                elif kname == "partition_histogram":
                    check(all(torch.equal(g, w) for g, w in zip(
                        ck.partition_histogram_segments(*a),
                        ck.partition_histogram_segments_plain(*a))),
                        f"{label}: a partition_histogram call differs from "
                        "its plain version")
                elif kname == "partition_positions":
                    dests, P, B, _ = a
                    check(all(torch.equal(g, w) for g, w in zip(
                        ck.partition_positions(*a),
                        ck.partition_positions_plain(dests, P, B))),
                        f"{label}: a partition_positions call differs from "
                        "its plain version")
                else:
                    gid, inputs, kinds, G, valid = a
                    dg_compare(torch, ck, gid, inputs, kinds, G,
                               f"{label} call", valid)
        print(f"{label}: " + ", ".join(
            f"{len(seen_calls.get(plan_wrapper.get(k, k), []))} {k}"
            for k in plan_kernels) + " calls equal their plain versions")

    t0 = time.time()
    source = {name: tpch_table(name, TPCH_SF, TPCH_SEED)
              for name in ("customer", "orders")}
    n_cust, n_orders = source["customer"].num_rows, source["orders"].num_rows
    comment_bytes = source["orders"]["o_comment"].nbytes
    print(f"TPC-H SF {TPCH_SF}: customer {n_cust} rows, orders {n_orders} "
          f"rows (o_comment {comment_bytes} B with offsets), generated in "
          f"{time.time() - t0:.1f} s")

    # ---- path 10: TPC-H Q13, its regex filter at the host hop -------------
    t0 = time.time()
    step, tables = entry_mod.entry_q13(dev, TPCH_SF, TPCH_SEED,
                                       source=source)
    torch.cuda.synchronize()
    print(f"path 10 data: customer and orders staged in "
          f"{time.time() - t0:.1f} s in {len(tables[1].batches)} orders "
          "batches")
    out, secs, launches10, peak = timed(
        lambda: step(*tables), "path 10", ("filter_compact_chunks",),
        before=strings_regex.reset_host_hops)
    hops10 = dict(strings_regex.HOST_HOPS)
    check(hops10 == {"direct": len(tables[1].batches)},
          f"path 10: host hops {hops10}, not one direct hop an orders batch")
    t0 = time.time()
    want = entry_mod.q13_pyarrow(step.source).to_pydict()
    got = out.to_pydict()
    check(got == want, f"path 10: Q13 differs from pyarrow's: {got} {want}")
    print(f"path 10 (TPC-H Q13 at SF {TPCH_SF}): {n_orders} orders rows in "
          f"{secs * 1e3:.3f} ms = {n_orders / secs:.6g} rows/s; "
          f"{len(got['c_count'])} c_count groups equal pyarrow's (oracle "
          f"{time.time() - t0:.1f} s); peak device memory {peak} B; host "
          f"hops {hops10}; launches {launches10}")
    paths["path 10"]["host_hops"] = hops10
    del out
    check_plan_calls("path 10", lambda: step(*tables), launches10)
    del step, tables
    forget()
    torch.cuda.empty_cache()

    # ---- path 11: TPC-H Q22, its substring on the device ------------------
    t0 = time.time()
    step, tables = entry_mod.entry_q22(dev, TPCH_SF, TPCH_SEED,
                                       source=source)
    torch.cuda.synchronize()
    print(f"path 11 data: staged in {time.time() - t0:.1f} s")
    out, secs, launches11, peak = timed(
        lambda: step(*tables), "path 11", ("filter_compact_chunks",),
        before=strings_regex.reset_host_hops)
    check(not strings_regex.HOST_HOPS,
          f"path 11: host hops {dict(strings_regex.HOST_HOPS)}")
    got = out.to_pydict()
    want = entry_mod.q22_pyarrow(step.source).to_pydict()
    check(got["cntrycode"] == want["cntrycode"]
          and got["numcust"] == want["numcust"],
          f"path 11: Q22 differs from pyarrow's: {got} {want}")
    g, w = np.array(got["totacctbal"]), np.array(want["totacctbal"])
    check(bool(np.all(np.abs(g - w) <= 1e-12 * np.abs(w) + 1e-12)),
          f"path 11: totacctbal {g} against pyarrow's {w}")
    print(f"path 11 (TPC-H Q22 at SF {TPCH_SF}): {n_cust} customer rows in "
          f"{secs * 1e3:.3f} ms = {n_cust / secs:.6g} rows/s; "
          f"{len(got['cntrycode'])} country codes equal pyarrow's, "
          f"totacctbal max |diff| {float(np.abs(g - w).max()):.3g}; peak "
          f"device memory {peak} B; launches {launches11}")
    del out
    check_plan_calls("path 11", lambda: step(*tables), launches11)
    del step, tables
    forget()
    torch.cuda.empty_cache()

    # ---- path 12: bench.py's host_boundary regex filter at 100M rows ------
    keep12, v_kept = entry_mod.host_boundary_numpy(N_ROWS, HB_SEED)
    codes12, _ = entry_mod.example_columns_host_boundary(N_ROWS, HB_SEED)
    fc12 = {}
    launches12 = {}
    for label, staging, branch in (("path 12d", "dictionary", "dictionary"),
                                   ("path 12p", "plain", "pushdown")):
        t0 = time.time()
        step, (b,) = entry_mod.entry_host_boundary(dev, N_ROWS, HB_SEED,
                                                   staging)
        torch.cuda.synchronize()
        print(f"{label} data: {N_ROWS} rows, s staged as {staging} "
              f"({b.column('s').values.shape[0]} B), made in "
              f"{time.time() - t0:.1f} s")
        out, secs, launches12[label], peak = timed(
            lambda: step(b), label, ("filter_compact_chunks",),
            before=strings_regex.reset_host_hops)
        hops = dict(strings_regex.HOST_HOPS)
        check(hops == {branch: 1}, f"{label}: host hops {hops}")
        n = len(out)
        check(n == int(keep12.sum()), f"{label}: kept {n} rows, the oracle "
              f"{int(keep12.sum())}")
        check(np.array_equal(out.column("v").values[:n].cpu().numpy(),
                             v_kept), f"{label}: the kept v differ")
        s = out.column("s")
        if staging == "dictionary":
            check(np.array_equal(s.values[:n].cpu().numpy(), codes12[keep12]),
                  f"{label}: the kept codes differ")
        else:
            kept = entry_mod.HB_WORDS[codes12[keep12]]
            lens = np.char.str_len(kept)
            off = np.concatenate([[0], np.cumsum(lens)])
            check(np.array_equal(s.offsets[:n + 1].cpu().numpy(), off) and
                  s.values[:off[-1]].cpu().numpy().tobytes() ==
                  "".join(kept.tolist()).encode(),
                  f"{label}: the kept strings differ")
        print(f"{label} (bench.py's host_boundary, s {staging}): {N_ROWS} "
              f"rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; "
              f"{n} kept rows equal the oracle's; peak device memory {peak} "
              f"B; host hops {hops}; launches {launches12[label]}")
        paths[label]["host_hops"] = hops
        del out, s
        check_plan_calls(label, lambda: step(b), launches12[label])
        calls = seen_calls["filter_compact_columns"]
        fc12[label] = [measure_filter(torch, ck, *a, f"{label} {what}")
                       for a, what in zip(calls, ("rows", "pool"))]
        del calls, step, b
        forget()
        torch.cuda.empty_cache()
    del keep12, v_kept, codes12

    # ---- paths 13 and 14: TPC-H Q12 and Q7, casts, dates and is_in ------
    t0 = time.time()
    li_cols = sorted(set(entry_mod.Q12_COLUMNS["lineitem"]) |
                     set(entry_mod.Q7_COLUMNS["lineitem"]) |
                     set(entry_mod.BASKETS_COLUMNS["lineitem"]) |
                     set(entry_mod.SMERGE_COLUMNS["lineitem"]) |
                     set(entry_mod.DECIMAL_Q1_COLUMNS["lineitem"]))
    source.update({name: tpch_table(name, TPCH_SF, TPCH_SEED, columns=cols)
                   for name, cols in (("lineitem", li_cols),
                                      ("supplier", None), ("nation", None))})
    n_li = source["lineitem"].num_rows
    print(f"TPC-H SF {TPCH_SF}: lineitem {n_li} rows ({len(li_cols)} "
          f"columns, no l_comment), supplier and nation generated in "
          f"{time.time() - t0:.1f} s")
    launches1314 = {}
    for label, make, oracle in (
            ("path 13", entry_mod.entry_q12, entry_mod.q12_pyarrow),
            ("path 14", entry_mod.entry_q7, entry_mod.q7_pyarrow)):
        t0 = time.time()
        step, tables = make(dev, TPCH_SF, TPCH_SEED, source=source)
        torch.cuda.synchronize()
        print(f"{label} data: {len(tables)} tables staged in "
              f"{time.time() - t0:.1f} s, lineitem in "
              f"{len(tables[0 if label == 'path 13' else 1].batches)} "
              "batches")
        out, secs, launches1314[label], peak = timed(
            lambda: step(*tables), label, ("filter_compact_chunks",))
        t0 = time.time()
        got, want = out.to_pydict(), oracle(step.source).to_pydict()
        if label == "path 13":
            check(got == want, f"{label}: Q12 differs from pyarrow's: "
                  f"{got} {want}")
            q12_results = {"port": got, "pyarrow": want}
            what = f"{len(got['l_shipmode'])} ship modes"
            launches_new.update(q12_driver_paths(torch, ck, entry_mod,
                                                 tables, want, paths))
        else:
            g, w = np.array(got.pop("revenue")), np.array(want.pop(
                "revenue"))
            check(got == want and len(g) == 4 and bool(np.all(
                np.abs(g - w) <= 1e-12 * np.abs(w))),
                f"{label}: Q7 differs from pyarrow's: {got} {g} {want} {w}")
            what = f"{len(g)} (nation, nation, year) groups"
        print(f"{label} ({'TPC-H Q12' if label == 'path 13' else 'TPC-H Q7'}"
              f" at SF {TPCH_SF}): {n_li} lineitem rows in "
              f"{secs * 1e3:.3f} ms = {n_li / secs:.6g} rows/s; {what} "
              f"equal pyarrow's (oracle {time.time() - t0:.1f} s); peak "
              f"device memory {peak} B; launches {launches1314[label]}")
        del out
        check_plan_calls(label, lambda: step(*tables), launches1314[label])
        del step, tables
        forget()
        torch.cuda.empty_cache()
    # ---- path 15: HiBench's WordCount over TPC-H's o_comment ------------
    t0 = time.time()
    step, tables = entry_mod.entry_wordcount(dev, TPCH_SF, TPCH_SEED,
                                             source=source)
    torch.cuda.synchronize()
    print(f"path 15 data: o_comment staged in {time.time() - t0:.1f} s in "
          f"{len(tables[0].batches)} batches")
    out, secs, launches15, peak = timed(
        lambda: step(*tables), "path 15", ("filter_compact_chunks",))
    t0 = time.time()
    got = out.to_pyarrow()
    want = entry_mod.wordcount_pyarrow(step.source)
    n_words = int(np.sum(want["count"].to_numpy()))
    check(got.equals(want), "path 15: the word counts differ from "
          f"pyarrow's: {got.slice(0, 5).to_pydict()} "
          f"{want.slice(0, 5).to_pydict()}")
    top = got.slice(0, 100).to_pydict()
    print(f"path 15 (WordCount over o_comment at SF {TPCH_SF}): "
          f"{n_orders} comments, {n_words} words in {secs * 1e3:.3f} ms = "
          f"{n_words / secs:.6g} words/s; {got.num_rows} distinct words "
          f"and their counts equal pyarrow's (oracle "
          f"{time.time() - t0:.1f} s), top 3 {list(zip(top['word'][:3], top['count'][:3]))}"
          f"; peak device memory {peak} B; launches {launches15}")
    paths["path 15"].update(words=n_words, distinct=got.num_rows)
    del out, got, want, top
    check_plan_calls("path 15", lambda: step(*tables), launches15)
    fc15 = measure_filter(torch, ck, *seen_calls["filter_compact_columns"][0],
                          "path 15 pool")
    del step, tables
    forget()
    torch.cuda.empty_cache()

    # ---- path 16: order baskets of lineitem (hash_list, pivot_wider) ----
    t0 = time.time()
    step, tables = entry_mod.entry_baskets(dev, TPCH_SF, TPCH_SEED,
                                           source=source)
    torch.cuda.synchronize()
    print(f"path 16 data: lineitem's four columns staged in "
          f"{time.time() - t0:.1f} s in {len(tables[0].batches)} batches")
    out, secs, launches16, peak = timed(
        lambda: step(*tables), "path 16",
        ("filter_compact_chunks", "tile_compact_local", "tile_stitch"))
    t0 = time.time()
    want = entry_mod.baskets_numpy(step.source)
    bad = entry_mod.baskets_differ(entry_mod.baskets_arrays(out), want)
    check(not bad, f"path 16: the baskets' {bad} differ from numpy's")
    print(f"path 16 (order baskets at SF {TPCH_SF}): {n_li} lineitem rows "
          f"in {secs * 1e3:.3f} ms = {n_li / secs:.6g} rows/s; "
          f"{len(want['l_orderkey'])} baskets of at least "
          f"{entry_mod.BASKET_MIN_PARTS} parts (lists, first, top 3, the "
          f"pivot by line number, q1) equal numpy's (oracle "
          f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches16}")
    paths["path 16"]["baskets"] = len(want["l_orderkey"])
    del out, want
    check_plan_calls("path 16", lambda: step(*tables), launches16)
    fc16 = measure_filter(torch, ck, *seen_calls["filter_compact_columns"][0],
                          "path 16 flat columns")
    tc16 = measure_tile_compact(torch, ck,
                                seen_calls["tile_compact_local"][0][0],
                                "path 16 nested columns")
    ts16 = measure_tile_stitch(torch, ck, *seen_calls["tile_stitch"][0],
                               "path 16 nested columns")
    del step, tables
    forget()
    torch.cuda.empty_cache()

    # ---- path 16r: run-end encoding of path 16's sorted l_orderkey -------
    t0 = time.time()
    step, tables = entry_mod.entry_ree_keys(dev, TPCH_SF, TPCH_SEED,
                                            source=source)
    torch.cuda.synchronize()
    print(f"path 16r data: l_orderkey staged in {time.time() - t0:.1f} s")
    res, secs, launches16r, peak = timed(
        lambda: step(*tables), "path 16r",
        ("tile_compact_local", "tile_stitch"))
    n_runs = 0
    for i, ((enc, dec), b) in enumerate(zip(res, tables[0].batches)):
        col = b.column("l_orderkey")
        n = len(col)
        check(int(dec.length) == n and torch.equal(dec.values[:n],
                                                   col.values[:n]),
              f"path 16r: batch {i} does not decode to its input")
        runs = entry_mod.ree_runs_numpy(col.values[:n].cpu().numpy())
        check(len(enc) == len(runs) and np.array_equal(
            enc.offsets[1:len(runs) + 1].cpu().numpy(), runs),
            f"path 16r: batch {i}'s run ends differ from numpy's")
        n_runs += len(runs)
    print(f"path 16r (run-end encode and decode of l_orderkey): {n_li} "
          f"rows, {n_runs} runs in {secs * 1e3:.3f} ms; every batch "
          f"decodes to its input and its run ends equal numpy's; peak "
          f"device memory {peak} B; launches {launches16r}")
    paths["path 16r"]["runs"] = n_runs
    del res
    check_plan_calls("path 16r", lambda: step(*tables), launches16r)
    tc16r = measure_tile_compact(torch, ck,
                                 seen_calls["tile_compact_local"][0][0],
                                 "path 16r")
    ts16r = measure_tile_stitch(torch, ck, *seen_calls["tile_stitch"][0],
                                "path 16r")
    del step, tables
    forget()
    torch.cuda.empty_cache()

    # ---- paths 17-19: the ordered nodes and the decimal columns --------
    # each path's numpy oracle runs in this worker while the card runs
    # the path's recording run (after its counted run, which it would slow)
    oracles = ThreadPoolExecutor(max_workers=1)

    # path 17: a merge of 8 sorted lineitem partitions (sorted_merge)
    t0 = time.time()
    step, tables = entry_mod.entry_sorted_merge(dev, TPCH_SF, TPCH_SEED,
                                                source=source)
    torch.cuda.synchronize()
    print(f"path 17 data: {len(tables)} sources, each sorted on the card, "
          f"in {sum(len(t.batches) for t in tables)} batches, staged in "
          f"{time.time() - t0:.1f} s")
    out, secs, launches17, peak = timed(lambda: step(*tables), "path 17")
    t0 = time.time()
    bad = oracles.submit(entry_mod.sorted_merge_differ, out, step.source)
    check_plan_calls("path 17", lambda: step(*tables), launches17)
    bad = bad.result()
    check(not bad, f"path 17: the merged lineitem's {bad} differ from its "
          "input's")
    print(f"path 17 (sorted_merge of {len(tables)} sorted lineitem "
          f"partitions at SF {TPCH_SF}): {n_li} rows in {secs * 1e3:.3f} ms "
          f"= {n_li / secs:.6g} rows/s; keys in order, the ids a "
          f"permutation of the input's, every payload its row's (oracle "
          f"and recording run {time.time() - t0:.1f} s); peak device "
          f"memory {peak} B; launches {launches17}")
    del out, step, tables
    forget()
    torch.cuda.empty_cache()

    # path 17g: TPC-H Q1 over the plan's own generator (tpch_gen)
    step, args17g = entry_mod.entry_tpch_gen_q1(dev, TPCH_GEN_SF, TPCH_SEED)
    out, secs, launches17g, peak = timed(
        lambda: step(*args17g), "path 17g", ("filter_compact_chunks",))
    got = out.to_pydict()
    t0 = time.time()
    q1_want = oracles.submit(lambda: entry_mod.q1_numpy(tpch_table(
        "lineitem", TPCH_GEN_SF, TPCH_SEED, columns=entry_mod.Q1_COLUMNS)))
    check_plan_calls("path 17g", lambda: step(*args17g), launches17g)
    bad = entry_mod.q1_differ(got, q1_want.result())
    check(not bad, f"path 17g: Q1's {bad} differ from numpy's: {got}")
    print(f"path 17g (TPC-H Q1 from tpch_gen at SF {TPCH_GEN_SF}, the "
          f"generator in the step): {sum(got['count_order'])} rows "
          f"aggregated in {secs * 1e3:.3f} ms; {len(got['count_order'])} "
          f"groups equal numpy's (sums within 1e-12 of the sums of |x|; "
          f"recording run and oracle {time.time() - t0:.1f} s); peak "
          f"device memory {peak} B; launches {launches17g}")
    del out, step
    forget()
    torch.cuda.empty_cache()

    # paths 18 and 18f: the trades-and-quotes as-of join (asofjoin)
    launches18 = {}
    for label, n_q, n_t, tol in (
            ("path 18", N_QUOTES, N_TRADES, ASOF_TOLERANCE),
            ("path 18f", N_QUOTES // 10, N_TRADES // 10, -ASOF_TOLERANCE)):
        t0 = time.time()
        step, tables = entry_mod.entry_asof(dev, n_q, n_t, TPCH_SEED, tol)
        torch.cuda.synchronize()
        quotes, trades = step.columns
        print(f"{label} data: {n_q} quotes, {n_t} trades made and staged "
              f"in {time.time() - t0:.1f} s")
        out, secs, launches18[label], peak = timed(
            lambda: step(*tables), label, ("filter_compact_chunks",))
        t0 = time.time()
        match = oracles.submit(entry_mod.asof_numpy, quotes, trades, tol)
        check_plan_calls(label, lambda: step(*tables), launches18[label])
        match = match.result()
        bad = entry_mod.asof_differ(out, quotes, match)
        check(not bad, f"{label}: the matched {bad} differ from numpy's")
        print(f"{label} (asofjoin on ts by sym, tolerance {tol} ns): "
              f"{n_t} trades against {n_q} quotes in {secs * 1e3:.3f} ms = "
              f"{(n_t + n_q) / secs:.6g} rows/s; {int((match >= 0).sum())} "
              f"matched, bid / ask and nulls equal numpy's (recording run "
              f"and oracle {time.time() - t0:.1f} s); peak device memory "
              f"{peak} B; launches {launches18[label]}")
        paths[label]["matched"] = int((match >= 0).sum())
        del out, step, tables, quotes, trades, match
        forget()
        torch.cuda.empty_cache()

    # path 19: Q1's sums on the spec's decimal(15, 2) columns
    t0 = time.time()
    step, tables = entry_mod.entry_decimal_q1(dev, TPCH_SF, TPCH_SEED,
                                              source=source)
    torch.cuda.synchronize()
    print(f"path 19 data: lineitem's four DECIMAL(15,2) columns and "
          f"l_extendedprice at decimal128(38, 2) staged in "
          f"{time.time() - t0:.1f} s in {len(tables[0].batches)} batches")
    out, secs, launches19, peak = timed(
        lambda: step(*tables), "path 19", ("filter_compact_chunks",))
    t0 = time.time()
    want19 = oracles.submit(entry_mod.decimal_q1_numpy, step.cents,
                            step.source)
    check_plan_calls("path 19", lambda: step(*tables), launches19)
    want19 = want19.result()
    bad = entry_mod.decimal_q1_differ(out, want19)
    check(not bad, f"path 19: {bad} differ from numpy's")
    print(f"path 19 (Q1's filter and decimal sums, a decimal filter, sort "
          f"and group-by at SF {TPCH_SF}): {n_li} lineitem rows in "
          f"{secs * 1e3:.3f} ms = {n_li / secs:.6g} rows/s; "
          f"{len(want19['q1']['count_order'])} Q1 groups, "
          f"{len(want19['rows'])} rows past {entry_mod.DECIMAL_PRICE_FLOOR} "
          f"in order and {len(want19['counts'])} discount groups equal "
          f"numpy's exactly (recording run and oracle "
          f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches19}")
    del out, step, tables, want19
    oracles.shutdown()
    forget()
    torch.cuda.empty_cache()

    # ---- paths 20-22: the out-of-core and dataset layer ------------------
    launches2022, m2022 = out_of_core_paths(
        torch, ck, dev, source, q12_results, timed, check_plan_calls,
        seen_calls, forget)

    # ---- path 24: an Avro scan (the files the worker wrote) --------------
    launches_new["path 24"] = avro_path(torch, ck, entry_mod, dev,
                                        avro_root, writer, paths)
    stop_writer()
    torch.cuda.empty_cache()

    shipdate = source["lineitem"]["l_shipdate"].slice(0, N_SWEEP) \
        .cast(pa.int32()).to_numpy()
    shipmode = source["lineitem"]["l_shipmode"].slice(0, N_SWEEP) \
        .combine_chunks().indices.to_numpy()
    for name in ("lineitem", "supplier", "nation"):
        del source[name]

    # ---- the string sweep: the family's 71 functions over 2^18 comments ---
    t0 = time.time()
    comments = source["orders"]["o_comment"].slice(0, N_SWEEP).to_pylist()
    a7c_comments = source["orders"]["o_comment"].slice(0, N_A7C) \
        .combine_chunks()
    col = entry_mod.sweep_column(comments, device=dev)
    col_cpu = entry_mod.sweep_column(comments, device="cpu")
    del source, comments
    check(result_parts(col) == result_parts(col_cpu),
          "sweep: the CPU's input rows differ from the card's")
    print(f"string sweep: {N_SWEEP} rows of path 10's o_comment, "
          f"one in 16 non-ASCII, one in 97 null ({col.values.shape[0]} B), "
          "made in "
          f"{time.time() - t0:.1f} s")
    host_fns = {"match_substring_regex", "count_substring_regex",
                "find_substring_regex", "replace_substring_regex",
                "binary_replace_slice", "utf8_replace_slice",
                "utf8_zero_fill", "utf8_normalize"}
    sweep = {}
    card_parts = {}
    for name, extra, kw in entry_mod.STRING_SWEEP:
        if name not in host_fns:
            entry_mod.sweep_call(name, extra, kw, col)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = entry_mod.sweep_call(name, extra, kw, col)
        end.record()
        torch.cuda.synchronize()
        sweep[name] = {"ms": start.elapsed_time(end),
                       "peak_bytes": torch.cuda.max_memory_allocated() - base}
        check(sweep[name]["peak_bytes"] < SWEEP_PEAK_BYTES,
              f"sweep {name}: peak {sweep[name]['peak_bytes']} B")
        card_parts[name] = result_parts(got)
        del got
    del col
    torch.cuda.empty_cache()
    # the CPU's results, once every card call is timed
    t0 = time.time()
    pool = ThreadPoolExecutor(SWEEP_CPU_WORKERS)
    try:
        wants = pool.map(lambda f: result_parts(entry_mod.sweep_call(
            *f, col_cpu)), entry_mod.STRING_SWEEP)
        for (name, _, _), want in zip(entry_mod.STRING_SWEEP, wants):
            check(card_parts.pop(name) == want,
                  f"sweep {name}: the card's result differs from the CPU's")
            print(f"sweep {name:26s} {sweep[name]['ms']:10.3f} ms, peak "
                  f"above the input {sweep[name]['peak_bytes']} B; equal "
                  "to the CPU's")
    finally:
        pool.shutdown(cancel_futures=True)
    cpu_s = time.time() - t0
    print(f"string sweep: {len(sweep)} functions equal the CPU's byte for "
          f"byte; card {sum(m['ms'] for m in sweep.values()):.1f} ms in "
          f"all, the CPU {cpu_s:.1f} s ({SWEEP_CPU_WORKERS} at a time)")
    del col_cpu

    # ---- the A7b sweep: 83 functions and every cast pair at 2^18 rows ----
    from arrow_tpu_torch.utils.errors import ArrowInvalid
    t0 = time.time()
    cols = entry_mod.a7b_sweep_columns(N_SWEEP, TPCH_SEED, shipdate,
                                       shipmode, device=dev)
    cols_cpu = entry_mod.a7b_sweep_columns(N_SWEEP, TPCH_SEED, shipdate,
                                           shipmode, device="cpu")
    for name, c in cols.items():
        check(result_parts(c) == result_parts(cols_cpu[name]),
              f"A7b sweep: the CPU's input {name} differs from the card's")
    print(f"A7b sweep: {len(cols)} columns of {N_SWEEP} rows (Q7's "
          f"l_shipdate and Q12's l_shipmode among them) made in "
          f"{time.time() - t0:.1f} s")
    a7b_host = {"strftime", "strptime"}
    n_a7b, a7b_ms = 0, 0.0
    card_got = {}
    for entry in entry_mod.A7B_SWEEP:
        label, fn, names, kw, tol = entry
        src = cols[names[0]].type
        host = fn in a7b_host or (fn == "cast" and (
            (src.is_floating and str(kw["target_type"]) == "string") or
            (str(src) == "string" and kw["target_type"].is_temporal) or
            (src.is_temporal and str(kw["target_type"]) == "string")))
        if not host:
            entry_mod.a7b_sweep_call(entry, cols)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = entry_mod.a7b_sweep_call(entry, cols)
        end.record()
        torch.cuda.synchronize()
        sweep[label] = {"ms": start.elapsed_time(end),
                        "peak_bytes": torch.cuda.max_memory_allocated() - base}
        a7b_ms += sweep[label]["ms"]
        check(sweep[label]["peak_bytes"] < SWEEP_PEAK_BYTES,
              f"A7b sweep {label}: peak {sweep[label]['peak_bytes']} B")
        card_got[label] = got
        del got
    # the CPU's results, once every card call is timed
    t1 = time.time()
    pool = ThreadPoolExecutor(SWEEP_CPU_WORKERS)
    try:
        wants = pool.map(lambda e: entry_mod.a7b_sweep_call(e, cols_cpu),
                         entry_mod.A7B_SWEEP)
        for entry, want in zip(entry_mod.A7B_SWEEP, wants):
            label, fn, names, kw, tol = entry
            got = card_got.pop(label)
            if tol is None and getattr(want, "offsets", 1) is None and \
                    not want.children and \
                    want.values.dtype.is_floating_point:
                tol = ("ulps", 0)   # NaN bits differ: the card's canonical
            if tol is None:
                same = result_parts(got) == result_parts(want)
            else:
                x = cols_cpu[names[0]]
                scale = np.cumsum(np.nan_to_num(np.abs(
                    x.values.numpy().astype(np.float64)) *
                    x.validity_or_true().numpy())) \
                    if tol[0] == "sum" else None
                same = float_parts_close(got, want, tol, scale)
            check(same, f"A7b sweep {label}: the card's result differs "
                  f"from the CPU's (tolerance {tol})")
            del got, want
            n_a7b += 1
    finally:
        pool.shutdown(cancel_futures=True)
    cpu_s = time.time() - t1
    # one call that wraps raises on both devices
    big = cols["c_a"].values.clone()
    big[7] = (1 << 63) - 1
    for d, c in ((dev, cols["c_a"]), ("cpu", cols_cpu["c_a"])):
        a = Array(c.type, big.to(d), c.validity, length=c.length)
        try:
            entry_mod.a7b_sweep_call(("", "add_checked", ("x", "x"), {},
                                      None), {"x": a})
            check(False, f"A7b sweep: add_checked past INT64_MAX on {d} "
                  "did not raise")
        except ArrowInvalid as e:
            check(str(e) == "overflow", f"A7b sweep: message {e!r}")
    print(f"A7b sweep: {n_a7b} entries ({len(set(e[1] for e in entry_mod.A7B_SWEEP))} "
          f"functions) equal the CPU's (exact, or within the stated "
          f"ulps / sums); add_checked past INT64_MAX raises on both "
          f"devices; card {a7b_ms:.1f} ms in all, the CPU {cpu_s:.1f} s "
          f"({SWEEP_CPU_WORKERS} at a time), {time.time() - t0:.1f} s in "
          "all")
    del cols, cols_cpu
    torch.cuda.empty_cache()

    # ---- the A7c sweep: nested layouts and their functions ---------------
    t0 = time.time()
    cols = entry_mod.a7c_sweep_columns(N_A7C, TPCH_SEED, a7c_comments,
                                       device=dev)
    cols_cpu = entry_mod.a7c_sweep_columns(N_A7C, TPCH_SEED, a7c_comments,
                                           device="cpu")
    print(f"A7c sweep: {N_A7C} rows of each layout (the comments path 10's "
          f"first o_comment rows), a {entry_mod.A7C_TENSOR_N}^2 matrix at "
          f"{entry_mod.A7C_TENSOR_DENSITY} made in {time.time() - t0:.1f} s")
    n_a7c, a7c_ms = 0, 0.0
    card_got = {}
    for label, host, tol, fn in entry_mod.A7C_SWEEP:
        if not host:
            fn(cols)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn(cols)
        end.record()
        torch.cuda.synchronize()
        key = f"a7c:{label}"
        sweep[key] = {"ms": start.elapsed_time(end),
                      "peak_bytes": torch.cuda.max_memory_allocated() - base}
        a7c_ms += sweep[key]["ms"]
        check(sweep[key]["peak_bytes"] < SWEEP_PEAK_BYTES,
              f"A7c sweep {label}: peak {sweep[key]['peak_bytes']} B")
        # other generators: one initializer's values again on the card
        card_got[label] = (got, fn(cols) if tol == "random" else None)
        del got
    # the CPU's results, once every card call is timed
    t1 = time.time()
    pool = ThreadPoolExecutor(SWEEP_CPU_WORKERS)
    try:
        wants = pool.map(lambda e: e[3](cols_cpu), entry_mod.A7C_SWEEP)
        for (label, _, tol, _), want in zip(entry_mod.A7C_SWEEP, wants):
            got, again = card_got.pop(label)
            key = f"a7c:{label}"
            if tol == "random":
                # the range, the type, the initializer's values again
                same = torch.equal(got.values, again.values) and \
                    got.values.dtype == want.values.dtype == \
                    torch.float64 and \
                    bool(((got.values >= 0) & (got.values < 1)).all())
            elif tol == "product":
                scale = entry_mod.a7c_product_scale(label, cols_cpu)
                same = bool(np.all(np.abs(got.cpu().numpy() -
                                          want.numpy())
                                   <= A7C_PRODUCT_RTOL * scale))
            else:
                same = entry_mod.nested_parts(got) == \
                    entry_mod.nested_parts(want)
            check(same, f"A7c sweep {label}: the card's result differs "
                  f"from the CPU's (tolerance {tol})")
            print(f"A7c sweep {label:28s} {sweep[key]['ms']:10.3f} ms, peak "
                  f"above the input {sweep[key]['peak_bytes']} B; equal to "
                  f"the CPU's")
            del got, again, want
            n_a7c += 1
    finally:
        pool.shutdown(cancel_futures=True)
    cpu_s = time.time() - t1
    print(f"A7c sweep: {n_a7c} entries equal the CPU's (exact; products "
          f"within {A7C_PRODUCT_RTOL} of |A| |x|; random by range and "
          f"seed); card {a7c_ms:.1f} ms in all, the CPU {cpu_s:.1f} s "
          f"({SWEEP_CPU_WORKERS} at a time), {time.time() - t0:.1f} s in "
          "all")
    print(json.dumps({"sweep": sweep}))
    del cols, cols_cpu, a7c_comments
    torch.cuda.empty_cache()

    def row(name, source, replaces, n_launches, m):
        return {"name": name, "route": "cuda",
                "source": f"arrow_tpu_torch/csrc/{source}",
                "replaces": f"arrow_tpu/{replaces}",
                "launches": n_launches, "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": m["library_ms"]}

    def also(kernel, suffix, m, n_launches=None):
        """The same numbers at a further path's arguments; the launches of
        that path's counted run, where it has one."""
        if n_launches is not None:
            kernel[f"launches_{suffix}"] = n_launches
        for key, value in m.items():
            kernel[f"{key}_{suffix}"] = value

    kernels = [
        row("filter_compact_chunks", "filter_compact.cu",
            "ops/pallas_kernels.py:492", launches["filter_compact_chunks"],
            fc),
        row("dense_group_reduce", "dense_group.cu",
            "ops/pallas_kernels.py:327", launches["dense_group_reduce"], dg),
        row("tile_compact_local", "tile_compact.cu",
            "ops/pallas_kernels.py:392", launches2["tile_compact_local"], tc),
        row("tile_stitch", "tile_compact.cu", "ops/selection.py:102",
            launches2["tile_stitch"], ts),
        row("partition_histogram", "partition_hist.cu",
            "ops/pallas_kernels.py:76", launches3["partition_histogram"], ph),
        row("pack_key_lanes", "pack_lanes.cu", "ops/join.py:157",
            launches5["path 5a"]["pack_key_lanes"], pk),
        # the stable sort by destination of the JAX exchange's send side
        row("partition_positions", "partition_hist.cu",
            "parallel/shuffle.py:155", launches3["partition_positions"], pp),
    ]
    kernels[1]["bound_ms_all_rows"] = dg["bound_ms_all_rows"]
    also(kernels[1], "nine_kinds", dg9)
    kernels[2]["take_indices_ms"] = ti_ms
    kernels[4]["host_ms"] = ph["host_ms"]
    also(kernels[0], "path_3a", fc3a, launches3["filter_compact_chunks"])
    also(kernels[0], "one_matrix_100M", fc_matrix)
    kernels[0]["filter_layer_ms_path_1"] = paths["path 1"]["filter_layer_ms"]
    also(kernels[4], "path_3b", ph3b, launches3b["partition_histogram"])
    also(kernels[4], "send_8_shards", ph8)
    kernels[6]["host_ms"] = pp["host_ms"]
    also(kernels[6], "path_3b", pp3b, launches3b["partition_positions"])
    def suffix_of(label):
        return label.replace(" ", "_").replace(",", "").replace("+", "and")

    # path 5c's kernels at its calls' arguments
    for kname, label, i, m in shapes5c:
        kernel = next(k for k in kernels if k["name"] == kname)
        also(kernel, suffix_of(label) + (f"_call_{i + 1}" if i else ""), m)
    # path 6's and 6b's kernels at their 2^22-row calls
    for kernel, m in ((kernels[0], fc6), (kernels[2], tc6), (kernels[3], ts6),
                      (kernels[5], pk6)):
        also(kernel, "path_6", m)
    also(kernels[0], "path_6b_bloom_split", fc6b)
    also(kernels[0], "path_6s_customer_filter", fc6s)
    also(kernels[0], "path_8_rows", fc8[0])
    also(kernels[0], "path_8_pool", fc8[1])
    also(kernels[0], "path_7b", fc7b)
    for kernel, suffix, m in (
            (kernels[4], "path_7b", ph7b), (kernels[6], "path_7b", pp7b),
            (kernels[4], "path_7b_state_rows", ph7b_state),
            (kernels[6], "path_7b_state_rows", pp7b_state),
            (kernels[4], "path_7c", ph7c), (kernels[6], "path_7c", pp7c),
            (kernels[4], "path_7d", ph7d), (kernels[6], "path_7d", pp7d)):
        also(kernel, suffix, m)
    also(kernels[5], "path_7b_orders_build", pk7b)
    also(kernels[1], "path_1c", dg1c, launches1c["dense_group_reduce"])
    also(kernels[1], "path_1c_any_all_alone", dg1c_aa)
    also(kernels[4], "path_3q", ph3q, launches3q["partition_histogram"])
    also(kernels[6], "path_3q", pp3q, launches3q["partition_positions"])
    also(kernels[0], "path_12d", fc12["path 12d"][0])
    also(kernels[0], "path_12p_rows", fc12["path 12p"][0])
    also(kernels[0], "path_12p_pool", fc12["path 12p"][1])
    also(kernels[0], "path_15_pool", fc15)
    also(kernels[0], "path_16_flat_columns", fc16)
    also(kernels[2], "path_16_nested_columns", tc16)
    also(kernels[3], "path_16_nested_columns", ts16)
    also(kernels[2], "path_16r", tc16r)
    also(kernels[3], "path_16r", ts16r)
    also(kernels[4], "path_22", m2022["partition_histogram"])
    also(kernels[6], "path_22", m2022["partition_positions"])
    also(kernels[0], "path_20", m2022["filter_compact_chunks"])
    # the launches of the join paths', path 1b's and path 6's counted runs
    for label, counts in list(launches5.items()) + [
            ("path 1b", launches1b), ("path 6", launches6),
            ("path 6s", launches6s), ("path 8", launches8),
            ("path 6b", launches6b), ("path 7a", launches7a),
            ("path 7b", launches7b), ("path 7c", launches7c),
            ("path 7d", launches7d), ("path 7s", launches7s),
            ("path 7e", launches7e), ("path 3s", launches3s),
            ("path 9", launches9), ("path 10", launches10),
            ("path 11", launches11)] + list(launches12.items()) + \
            list(launches1314.items()) + [
            ("path 15", launches15), ("path 16", launches16),
            ("path 16r", launches16r), ("path 17", launches17),
            ("path 17g", launches17g), ("path 19", launches19)] + \
            list(launches18.items()) + list(launches_dist.items()) + \
            list(launches2022.items()) + list(launches_new.items()):
        suffix = suffix_of(label)
        for kernel in kernels:
            if counts[kernel["name"]] and not (
                    label == "path 5a" and kernel["name"] == "pack_key_lanes"):
                kernel[f"launches_{suffix}"] = counts[kernel["name"]]
    print(f"chip_smoke: {time.time() - t_all:.1f} s in all, the build "
          "included")
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
