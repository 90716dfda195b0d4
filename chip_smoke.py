"""Smoke run of the PyTorch/CUDA port (pyarrowspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, PyTorch built for CUDA and nvcc; it imports
no JAX.  Phases (each one that fails makes the script exit non-zero):

  0. device and build: the card's name and power limit, torch and CUDA
     versions, and the nvcc time of each kernel library (one nvcc each,
     all started together); ptxas's registers and spills of
     K1, K2, K3, K5, K7 and K6 (K3's also by route, tensor-core or SIMT;
     K1's also by walk, symmetric and full; K2's
     and K7's also by route, csrc/tc_scan.cuh's tensor-core block with its
     queries resident or streamed, or SIMT; K6's also by route, narrow and
     wide, with its resident blocks an SM at k 15 and 260);
  1. K1 (csrc/knn.cu) against its plain version on a 313,841 x 384 unit
     corpus (eps 1.31, k 25): its one launch over the whole corpus, on the
     symmetric route (each of the N (N + 1) / 2 distinct pairs' products
     once: d(i, j) == d(j, i)) and on the full walk in turns, beside its
     bound, their lists bit for bit on every row, the route printed;
     2,048 random rows, distances within 1e-5
     and ids equal up to near-ties; d(i, j) == d(j, i) bitwise on 10,000
     kept mutual pairs; on the 16,384 timed rows K1's lists equal K1t's
     (csrc/knn_t.cu, on K1's product) bit for bit, and every distance K1
     returns equals K5's (csrc/gather_score.cu's SIMT route, the older
     product: compare.py::k5_distance) bit for bit; kernel and plain
     timed on those rows, with one torch.mm of the same fp32 product (TF32
     off) as a yardstick, and K1t timed on them; K1 on the last 9,416 rows
     (the extend's new-row scan: 74 row blocks, a split walk), bitwise the
     whole scan's rows; the same check at k 100 (the 4-word list) on
     2,048 rows; K1 at k 100 timed on the 16,384 rows, at k 200 (the wide
     route, csrc/knn_wide.cuh) on them and at k 1,024 on 2,048 rows in
     turns with its plain version, k 200 and k 1,024 beside their bounds
     and routes (narrow or wide, and the column splits);
  3. the main path: ArrowSpaceBuilder.build at 313,841 x 384 with the CVE
     graph params (a warm-up build, then a timed one), search_batch(
     mode="exact") over 8 batches of 4,096 queries, 3 single searches.
     Launch counts are reset just before the timed build and read just
     after the searches: both kernels must have run, K1 once, on the
     symmetric route.  The Laplacian must be exactly symmetric,
     every lambda finite in [0, 1], and no edge dropped; the warm-up and
     the timed build must give the same lambdas, centroids and lists bit
     for bit (the Lloyd sums use no float atomics);
  2. K2 (csrc/scan_topk.cu) against its plain version on the built index:
     4,096 queries, tau 0.62, k 15, scores within 1e-5; and k 200 on 1,024
     queries; at both, every (query, id, score) K2 returns equals bit for
     bit the blend (tile::blend's op order, in PyTorch) of K5's cosine
     for that id, K5 on float32 operands (its SIMT route, the fmaf chain
     K2 keeps: compare.py::k5_blend); the torch.mm yardstick beside K2's
     time; K2's wide lists (csrc/knn_wide.cuh's route with K2's epilogue)
     at k 200 on the 4,096 queries and at k 1,024 on 1,024 (within 1e-5 of
     the plain version there), each in turns with its plain version,
     beside its bound, its route (wide and the corpus splits), its wide
     launches in one call (at least one) and K2 at k 15 on the same
     queries; K2 over the index's rows rounded to bf16 (the as_serving
     view's) at k 200 on the 4,096 queries and at k 1,024 on 1,024, on its
     tensor-core route, each in turns with its plain version (within
     1e-5), its scores bit for bit k5_blend's on the route K2 took, beside
     its bf16 bound and its route;
  5. subtile serving on that index: search_batch(mode="subtile"), then
     mode="auto", over the same 8 batches, each after a warm-up, with the
     counts reset before each: K3, K4b, K5 and K4a must all have run, K3
     and K5 on their tensor-core route (the bf16 state; the route is
     printed), every K3 launch in clusters, each query's source row must
     rank first and the mean top-15 overlap with
     phase 3's exact results must be at least 0.99.  Those modes route in
     bf16, so a query may lose an item whose float32 score makes the top
     15 but whose bf16 score misses the pool; such queries are counted.
     The same serving step over a float32 scan state routes with K2's own
     scores, so there the ids must equal phase 3's outside near-ties of
     1e-5 for every query; then exact and subtile in turns (exact,
     subtile, subtile, exact) over the 8 batches, QPS each;
  6. K3 (csrc/subtile_max.cu), K4b and K4a (csrc/extract_topm.cu) and K5
     (csrc/gather_score.cu) against their plain versions at the shapes of
     phase 5 (maxima and cosines within 1e-5, ids identical), timed in
     turns (K4b and K4a by device time alone, _device_ms: their calls last
     tens of microseconds, under the host's launch overhead), each with
     its route (K3's with its cluster, and its launch counters: all, on
     the tensor cores, in clusters, in one-block clusters) and ptxas's
     registers and spills, K5 with its no-reuse read
     (each query reading its subtiles' rows itself, the old design's
     floor) beside its bound; the block-max check: for every query and
     each of its selected subtiles, the best of phase b's blended scores
     equals K3's maximum bit for bit; and K4b and K4a at m 1,024 against
     their plain versions and in turns with torch.topk;
  7. the north-star serving shape, 1,000,000 x 768 with batches of 16,384:
     a serving state made on the card (N(0, 1) rows from a seeded
     torch.Generator, the feature Laplacian of the first 65,536 rows with
     k_f 15, lambdas from the port's own synthesis) in an ArrowSpace;
     mode="subtile", mode="exact" and mode="int8" (its first call
     quantizes the corpus: 768 MB of int8) timed over 2 batches each, the
     subtile and int8 top-15 overlaps with exact on 1,024 queries at least
     0.99, K3 alone (a batch of 16,384), K4b on its maxima (16,384 x
     15,744 -> 16) and K4a on phase b's scores (16,384 x 1,024 -> 30), each
     with its ids against its plain version's on 1,024 queries, its bound
     and torch.topk in turns, K7 alone (a batch of 16,384, its route and
     bound; ids and scores bit for bit its plain version's on 1,024
     queries), K7 at a wide pool of 200 (past the 82 entries that fit
     beside its ring at F 768: the batch of 16,384 timed, and bit for bit
     and in turns with its plain version on 1,024 queries) and the peak
     device memory; exact and subtile in turns over the 2 batches;
  8. blocked-IVF and certified serving on phase 3's index: enable_ivf()
     (the build's own clustering), then search_batch(mode="ivf_block") and
     mode="certified" (n_probe 8) over phase 3's 8 batches, each after a
     warm-up, with the counts reset before each: K6 (csrc/ivf_scan.cu)
     must have run, and every certified query's ids must equal phase 3's
     exact ids outside near-ties of 1e-5.  The base certification rate
     and the widened and escalated queries are counted (the corpus is
     isotropic, so few queries certify; the results are exact anyway); K6
     against its plain version on the routed first batch, timed in turns,
     beside its bound over the real rows of the probed clusters, the
     tiles K6 walks (the 64-row tiles up to each probed cluster's last
     real row) and the first version's bound over every probed cap row;
     K6 at the wide pools of 260 and 1,040 (its staged merge) on the same
     batch, each against its plain version and in turns with it, with its
     wide launches and each query's merges; search_batch(mode="ivf_block",
     topk=300) over the 8 batches (QPS, one wide launch a batch, the
     first batch's overlap with exact);
  9. certified serving at 1,000,000 x 768, batches of 16,384, on a mixture
     corpus made on the card (4,096 centres, rows centre + 0.35 N(0, 1),
     queries a unit corpus row + 0.25 / sqrt(768) N(0, 1), as
     benchmarks/bench_serving.py makes them): enable_ivf(n_clusters=4096)
     clusters it, then mode="certified" over float32 and over bfloat16
     slabs and serving_stream(depth=4) over 4 batches (each batch equal to
     search_batch(mode="certified")); certified == exact (K2) on 1,024
     queries; the bf16 scan's scores within tau * (res_eps + 2F 2^-24) +
     1e-5 of float32 scores; K6 against its plain version, and at pools
     260 and 1,040 (and over bf16 slabs at 60) on the first batch (16,384
     routed queries, the plain version on the first 1,024); certified
     serving at topk 65 over bf16 slabs (pool 260; a refused query widens
     to 520, then 1,040): QPS, K6's share of the batches' time, and by
     pool the queries, launches and wide launches (the counts reset just
     before the batches; the wide route must have launched); the
     clustering time, K, cap, slab GiB, base
     certification rate, QPS and peak device memory;
  10. int8 serving on phase 3's index: search_batch(mode="int8") over
     phase 3's 8 batches after a warm-up, the counts reset before: K7
     (csrc/scan_int8.cu) must have run, on its tensor-core route; K7
     against its plain version on the first batch (ids identical, scores
     bit for bit), timed in turns, and its SIMT route (the same rows as a
     strided view) bit for bit its tensor-core route, timed; K7's wide
     pools of 200 and 400 (past the 130 entries that fit beside its ring
     at F 384) on the same batch, each bit for bit and in turns with its
     plain version, one wide launch each;
     the served ids equal phase 3's exact ids outside near-ties of 1e-5 on
     every query whose exact top-15 lies in K7's pool of 60;
  11. the bfloat16 serving view (as_serving) of that index: exact search
     over its 8 batches (K2 over bf16 rows must have run, every launch on
     its tensor-core route: csrc/tc_scan.cuh, the route printed), K2-bf16
     against its plain version on the first batch, timed in turns, with
     one torch.mm of the bf16 operands (float32 output) as a yardstick, and
     its scores bit for bit K5's blended on the route K2 took (k5_blend:
     K5's tensor-core route, whose sums K2's tensor-core route equals); the
     overlap with float32 exact (no rescore: at least 0.9);
  12. hybrid search and gather IVF (n_probe 8) over 2 batches, QPS and
     overlap with exact; build_energy on the same 313,841 rows
     (optical_tokens 40, the CVE graph params) with its phase seconds and
     search_energy_batch on 64 queries; a second build_energy, whose graph
     must equal the first bit for bit;
  13. lists past the old limit of 4,096: search_batch(topk=5000) on 64
     queries in exact (against K2's plain version), subtile (overlap with
     exact at least 0.99) and certified (== exact) modes; K1 at k 5,000 on
     8 rows, K4b and K4a at m 5,000, and K6 at F 4,096 (its query block
     staged a feature slab at a time), each against its plain version;
  14. the k-NN variants (ARROWSPACE_KNN_VARIANT): K1t (csrc/knn_t.cu) and
     K1's rotated walk (diagstart) and its permuted walk over the
     projection-sorted corpus (reorder), each against its plain version
     on 2,048 rows and bit for bit against phase 3's lists on the 16,384
     timed rows, timed in turns with its plain version and in turns with
     K1 on those rows (K1t also at k 100, its one-owner route); each
     against K1 in turns (and bit for bit) over a 65,536 x
     384 mixture corpus (4,096 centres); the 313,841 x 384 build under each
     of the four, whose lists, Laplacian and lambdas must be phase 3's bit
     for bit, with its build and knn seconds and its launches;
  15. the index lifecycle: ArrowSpaceBuilder.extend of phase 3's index by
     9,416 rows (N(0, 1) x 12, default_rng(43)), warm, against a rebuild of
     the 323,257 rows (lists, Laplacian, lambdas and tau* bit for bit: the
     extend's full walks witness the rebuild's symmetric one, the launches
     of each counted);
     seeded K1 against its plain version on 2,048 old rows and timed on
     16,384; save_index / load_index of the extended index in a temporary
     directory (MB, seconds; exact search on the loaded index bitwise the
     saved one's); suggest_graph_params and emit_build_suggestions at 313k;
  16. the build at the north-star shape, after phase 9's state is freed:
     ArrowSpaceBuilder.build of a 1,000,000 x 768 mixture corpus drawn on
     the card (phase 9's recipe) with the CVE graph params, its phase
     seconds, peak device memory, ell_width, nedges, n_dropped, tau* and
     the lambdas' mean and standard deviation printed beside the JAX
     package's TPU v5e record (TPU_1M_RECORD; not compared); the Laplacian
     exactly symmetric, K1 launched once, on the symmetric route, no NaN
     lambda, and edges dropped
     only where the union width bound passes the ELL budget's width cap;
     K1's launch over the whole corpus again, timed beside its bound, its
     lists the build's bit for bit; the build's lists against the plain
     version on 2,048 random rows, the first 1,024 (their lists all but
     from their own walks) and the last 1,024 (the largest offsets), and
     K5's distance bit for bit on them; the one-pass and the
     chunked symmetrize on the build's lists, in turns, each with its
     seconds and the device memory it adds, equal bit for bit (and to the
     build's graph), the one-pass op's bytes per directed entry held under
     the build's trigger constant; the native host engine
     (symmetrize_host) on phase 3's 313k lists, timed, equal to the
     one-pass op (ids, float32 weights, drops); and a build of phase 14's
     65,536-row mixture under ARROWSPACE_PROFILE, whose trace must hold the
     arrowspace:knn label and a device event of K1;
  17. the sharded path (parallel/), spawned from here twice on the one
     card: world 1 under NCCL and world 2 under gloo (both ranks on
     cuda:0; NCCL refuses two ranks on one device).  Each rank builds
     phase 3's corpus with build_sharded (a warm-up build, then a timed
     one, the counts reset just before it) and serves phase 3's first
     batch in exact, subtile and certified mode (each warm, then timed);
     every kernel of that path (K1, seeded K1 at world 2, K2, K3, K4b, K5,
     K4a, K6) must have launched on every rank.  The k-NN lists and L
     must be phase 3's bit for bit, the lambdas within LAMBDA_REL_BOUND
     (0 at world 1), the exact and certified ids phase 3's outside
     near-ties of 1e-5, subtile's top-15 overlap at least 0.99 (at world 1
     the one-device subtile result bit for bit).  Rank 0 of world 2 holds
     K1's ring step (rank 1's block: a nonzero col_start, 15 padding
     columns; also on 2,048 rows, a split walk, and at k 200, the wide
     route), K2, K3 and K6 on its shard against their plain versions,
     timed in turns; the collectives gloo ran through host memory are
     printed (the ring shift only);
  18. the trainers: DomainAdapter.fit (linear, mlp) on phase 3's rows at
     its defaults (hidden 192, batch 1,024, 306 steps) after a warm-up
     fit, seconds, steps a second, final loss; transform and a build of
     the adapted rows; TSDAEEncoder at its defaults (vocab 8,192, d_model
     384, 2 + 2 layers, 6 heads, max_len 128, batch 8) fitted on 8,192
     seeded sentences of a fixed 400-word list (1,024 steps), its loss
     falling, encode of the corpus and a build that serves its rows;
  4. reference parity on the card in float32: the README quickstart scores
     to 1e-6 and the four tests/data_test0.py orderings.

Phases 1, 2 and 6 also hold the wide lists (k 1,024) of K1, K2, K4b and
K4a against their plain versions and time them beside the narrow ones.

The line before the last is a JSON object with, for each kernel, its
launches on its main path (phase 3 for K1 and K2, phase 5's subtile run
for K3, K4a, K4b and K5, phase 8's certified run for K6, phase 10 for K7,
phase 11 for K2 over bf16 rows, phase 14's build under each variant for
K1t and K1's options, phase 15's extend for seeded K1; K1, K2, K3 and K6
also carry "sharded": phase 17's launches on rank 0 of world 2 and the
measures at that rank's shapes, each with its bound), its largest
difference from the plain version, the kernel's and the plain version's
times, its bound (the larger of its operations over the H100's peak for
their type and its bytes over 3.35 TB/s, from this run's shapes; K5 and
K6 count the rows this run's routing reads, K6 only the real rows of the
probed clusters, seeded K1 the new columns) and the time
of torch.topk where one PyTorch call computes the same function (K4a,
K4b; null elsewhere).  K1's rows and K1t's carry kernel_route (K1:
"narrow" or "wide" and "/S" with the column splits; K1t: "owners2",
"owners1" or K1's wide route), and K1's its wide lists (k 200 on 16,384
rows, k 1,024 on 2,048, each with its bound and route).  K4a, K4b, K6
and K7 carry kernel_route (K4:
"narrow", "radix" or "device" and, for the first two, how a row comes
in, "bulk" or "scalar"; K7: "tensor-core" or "simt"; K6: "narrow" or
"wide"), K7 simt_ms (its SIMT route on the same rows), and K6 its wide
lists ("wide": pools 260 and 1,040 at 313k and at 1M over float32 and
bfloat16 slabs, and pool 60 over bfloat16, each with its time, plain
time, bound, the wide route's list read-back beside the bound, and the
launches of its route at that length on a main-path serving run, counted
after a reset: phase 8's ivf_block topk 300 at 313k (lists of 300, the
pools' route; no 313k run scans 260 or 1,040), phase 9's certified runs
at 1M by list length (topk 65 over bfloat16 for 260 and 1,040, topk 15
over each slab type for the rest; a length that no such run reaches gets
0), with launches_run naming the run).  K2 over bf16 rows carries its
route (kernel_route) and its wide lists (k 200 and 1,024, each with its
route and launches).  K1 and K2 also carry product_ms:
one torch.mm of their fp32 product (TF32 off; K2 over bf16 rows: of the
bf16 operands, float32 output), a yardstick of the card's
library matmul on the same operands that the port never calls (it is not
the same function: no mask, blend or top-k, and another summation order),
and K1 its whole-corpus launches (full_ms on full_route, the symmetric
one, full_walk_ms on the full walk, in turns, full_bound_ms at 313k;
sym_launches, the symmetric launches of phase 3's main-path run; phase
16's full_1m_ms, full_1m_bound_ms, full_1m_launches at 1M).  The last line
is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cards N

runs phase 3's build on cuda:0 and then phase 17 at world N under NCCL,
rank r on cuda:r (N cards), with all of phase 17's checks against phase
3, and prints its numbers as JSON.

    python3 chip_smoke.py --against DIR [DIR ...]

compares other checkouts of the repository (a parent's tree unpacked with
git archive, say) with this one on the same card, instead of the phases:
each tree's package runs this script's phases 0-3, 6b, 6c and 11 (with
their checks) in a process of its own, in turns (the others, this tree,
this tree, the others reversed), and each turn prints what those phases
measured: K1 over the whole corpus, over 16,384 rows, over the last 9,416
rows and at k 100, 200 and 1,024, K1t at k 25 over 16,384 rows, K2 at Q
4,096 over float32 and bfloat16 rows and at k 200 and
1,024 (both over float32 and bfloat16 rows), the build seconds with the knn phase, exact QPS, K3 and K5 at
phase 6's shapes, K3 over a 1,000,000 x 768 bf16 corpus made from a
seeded generator with 16,384 queries (each K3 held against its plain
version on 1,024 queries, and its maxima, at phase 6's shapes and (a
digest) at 1M, against this tree's bits) and K2 over those
bf16 rows at k 15 in turns with K3 (its ids held against its plain
version on the first 1,024 queries), the bf16 view's QPS, K4b and K4a at
phase 6's shapes and on that corpus's maxima and phase b (each in turns
with torch.topk) and at m 1,024 (in turns with their plain versions), K7
on phase 10's first batch (pools 60, 200 and 400) and over a
seeded 1,000,000 x 768 int8 corpus with 16,384 queries (pools 60 and
200), and K6 on phase
8's routed first batch and on phase 9's 1M mixture over float32 and
bfloat16 slabs at k 15 and at pools 260 and 1,040 (and 60 over bfloat16;
each held against its plain version).  Then every run's
k-NN lists (phase 3's, and phase 1's K1t lists at k 25 and K1's over the
last 9,416 rows and at k 200 and 1,024), lambdas, exact top-k ids, K2's
lists over float32 rows at k 200 and 1,024 (its lists over bf16 rows are
held to its plain version and to k5_blend in each turn, not across trees:
the routes sum in other orders), K4b and K4a ids and K6 and K7 outputs (ids and
scores) and K3's maxima must equal this tree's bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

N, F = 313_841, 384
GP = {"eps": 1.31, "k": 25, "topk": 15, "p": 2.0, "sigma": 0.535}
TOL = 1e-5            # kernel vs plain version: summation order differs
Q_BATCH, N_BATCHES, TAU = 4096, 8, 0.62
K1_CHECK_ROWS, K1_TIME_ROWS = 2048, 16_384
K1_WIDE, K2_WIDE, K2_WIDE_QUERIES = 100, 200, 1024
K1_DEVICE_LIST = 200  # a K1 list past 128, in device memory: timed
K_WIDEST = 1024       # the longest lists timed (K1, K2, K4a, K4b)
K7_WIDE_POOLS = (200, 400)   # K7's wide pools (topk 50 and 100)
# K6's wide pools: certified serving's rescored pool of topk 65 and its
# second widening round; K6's pool of topk 15 over bf16 slabs.
K6_WIDE_POOLS, K6_POOL_BF16 = (260, 1040), 60
K6_TOPK_CERT, K6_TOPK_IVF = 65, 300   # phase 9's certified, 8's ivf_block
MIN_OVERLAP = 0.99
N1M, F1M, Q1M, Q1M_CHECK = 1_000_000, 768, 16_384, 1024
N_PROBE, MIX_CLUSTERS, MIX_NOISE, Q_NOISE = 8, 4096, 0.35, 0.25
K_LONG, Q_LONG, K1_LONG_ROWS = 5000, 64, 8   # lists past the old 4,096
F_WIDE = 4096                                 # K6's query block per slab
# The JAX package's record of its 1M x 768 build on a TPU v5e (phase 16
# prints its numbers beside this card's; they are not compared).
TPU_1M_RECORD = "benchmarks/recorded/1787157379_build_1m/build_1m_results.json"
N_MIX, N_EXTEND = 65_536, 9_416   # the variants' mixture corpus; a 3% append
OTHER_BATCHES, ENERGY_QUERIES, ENERGY_TOKENS = 2, 64, 40
MIN_BF16_OVERLAP = 0.9   # the bf16 view has no float32 rescore
SPIN_CYCLES = 2_000_000   # _device_ms's spin, ~1 ms: longer than the enqueue
KERNEL_SOURCES = ("knn", "knn_t", "scan_topk", "subtile_max", "extract_topm",
                  "gather_score", "ivf_scan", "scan_int8")
# The H100 SXM's published peaks at 700 W (dense): float32 outside the
# tensor cores, bf16 and int8 tensor cores, and HBM3.
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
README_ITEMS = np.array([[0.1, 0.2, 0.3], [0.0, 0.5, 0.1], [0.9, 0.1, 0.0]])
README_GP = {"eps": 1.0, "k": 6, "topk": 3, "p": 2.0, "sigma": 1.0}
README_QUERY = np.array([0.05, 0.2, 0.25])
README_EXPECTED = [(0, 0.989743318610787), (1, 0.7565344158360029),
                   (2, 0.22151940739207396)]


def _events_ms(fn, torch) -> float:
    """Device time of one call of fn in ms (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _in_turns(plain, kernel, torch) -> tuple[float, float]:
    """Mean ms of plain and kernel timed in turns: plain, kernel, kernel,
    plain (both already warm)."""
    p1 = _events_ms(plain, torch)
    k1 = _events_ms(kernel, torch)
    k2 = _events_ms(kernel, torch)
    p2 = _events_ms(plain, torch)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _device_ms(fn, torch, reps: int = 10) -> float:
    """Device time of one call of fn in ms: the mean of reps calls (warm)
    enqueued behind a spin of the card (torch.cuda._sleep), so that the
    host's launch overhead is not counted, as it is by _events_ms; for the
    selects, whose calls last tens of microseconds."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_turns(plain, kernel, torch) -> tuple[float, float]:
    """_in_turns with _device_ms: (kernel ms, plain ms)."""
    p1 = _device_ms(plain, torch)
    k1 = _device_ms(kernel, torch)
    k2 = _device_ms(kernel, torch)
    p2 = _device_ms(plain, torch)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _select_route(extract, score, m) -> str:
    """K4's route and way in for [rows, len] -> m ("simt" for a package
    that has one route)."""
    if not hasattr(extract, "route_name"):
        return "simt"
    route = extract.route_name(score.shape[1], m)
    return route if route == "device" else f"{route}/{extract.load_name(score)}"


def _bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time the card could take for a function: the larger of
    its operations over the peak rate of their type and the bytes it must
    move (each input read once, each output written once) over HBM's
    rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _product_ms(torch, a, b) -> float:
    """ms of one torch.mm(a, b.T) in float32 with TF32 off (warm): the
    yardstick of K1's and K2's product, never called by the port."""
    assert not torch.backends.cuda.matmul.allow_tf32
    out = torch.empty((a.shape[0], b.shape[0]), device=a.device)
    torch.mm(a, b.T, out=out)
    ms = _events_ms(lambda: torch.mm(a, b.T, out=out), torch)
    del out
    return ms


def _product_bf16_ms(torch, a, b) -> tuple[float, str]:
    """(ms, output dtype) of one torch.mm(a, b.T) of bf16 operands with
    float32 output (bf16 output where this torch's mm takes no out_dtype)
    (warm): the yardstick of K2's product over bf16 rows, never called by
    the port."""
    try:
        fn = lambda: torch.mm(a, b.T, out_dtype=torch.float32)  # noqa: E731
        out = fn()
    except (TypeError, RuntimeError):
        fn = lambda: torch.mm(a, b.T)  # noqa: E731
        out = fn()
    kind = str(out.dtype).split(".")[-1]
    del out
    return _events_ms(fn, torch), kind


def _k2_route(scan_topk, xu, qn, k, dev):
    """K2's route for a launch over the corpus xu for queries qn with lists
    of k (route_of where the package has one; else route_name and the
    product's loader)."""
    qs = qn.to(xu.dtype).contiguous()
    if hasattr(scan_topk, "route_of"):
        return scan_topk.route_of(xu, qs, k)
    return _route(scan_topk, xu.shape[0], qn.shape[0], k, dev, xu, qs)


def _bits_equal(torch, a, b) -> bool:
    """Two float32 (or int32) tensors equal in every bit."""
    view = (lambda t: t.view(torch.int32)
            if t.dtype == torch.float32 else t)
    return a.shape == b.shape and torch.equal(view(a), view(b))


def _own_compare():
    """This checkout's ops/cuda/compare.py (topk_disagreements, k5_blend),
    loaded by path: with --measure the package imported is another
    checkout's, and its kernels are held to this checkout's checks."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pyarrowspace_tpu_torch", "ops", "cuda", "compare.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_compare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k1_pairs(rows: int, n: int) -> float:
    """Distinct pairs of ``rows`` corpus rows with all ``n`` rows: d(i, j)
    == d(j, i) bit for bit, so a pair whose two rows are both among the
    scanned ones needs its product once."""
    return rows * n - rows * (rows - 1) / 2


def _route(mod, rows: int, n: int, k: int, device, *tensors) -> str:
    """K1's, K1t's or K2's route for a launch over rows of an [n, F] corpus
    ("single" for a package whose scans have one route), with the product's
    loader when ``tensors`` (the launch's operands) are given and the
    package has two."""
    fn = getattr(mod, "route_name", None)
    route = fn(rows, n, k, device) if fn else "single"
    loader = _loader(*tensors) if tensors else None
    return f"{route}/{loader}" if loader else route


def _loader(*tensors):
    """The product's loader for these operands ("tma" or "regs"), or None
    for a package with one loader (a parent's)."""
    try:
        from pyarrowspace_tpu_torch.ops.cuda import ffma_tile
    except ImportError:
        return None
    return ffma_tile.loader_of(*tensors)


def _last_route(mod):
    """The route the wrapper's last launch took, its loader included (None
    for a package that does not record it)."""
    return getattr(mod, "LAST_ROUTE", None)


def _ring_of(entry: str):
    """The ring of a K1, K1t or K2 kernel: "tma<S> <type>" or "regs
    <type>" (None for other entries)."""
    import re
    if "tcscan" in entry or not re.search(
            r"knn_kernel|knn_t_kernel|scan_kernel", entry):
        return None
    m = re.search(r"(TmaRing|RegRing)I(f|13__nv_bfloat16)(?:Li(\d)E)?",
                  entry)
    if not m:
        return "one loader"
    kind = "f32" if m.group(2) == "f" else "bf16"
    return (f"tma{m.group(3)} {kind}" if m.group(1) == "TmaRing"
            else f"regs {kind}")


def _has_sym(knn) -> bool:
    """The package's K1 has the symmetric route (a parent's may not)."""
    return hasattr(knn, "SYM_LAUNCHES")


def _full_walk(knn) -> dict:
    """knn_scan's keywords for K1's full walk over a whole corpus."""
    return {"symmetric": False} if _has_sym(knn) else {}


def _reset_launches() -> None:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 ivf_scan, knn, knn_t,
                                                 scan_int8, scan_topk,
                                                 subtile_max)
    for mod in (knn, knn_t, scan_topk, subtile_max, gather_score, ivf_scan,
                scan_int8):
        mod.LAUNCHES = 0
    ivf_scan.WIDE_LAUNCHES = 0
    subtile_max.TC_LAUNCHES = gather_score.TC_LAUNCHES = 0
    if hasattr(subtile_max, "CLUSTER_LAUNCHES"):
        subtile_max.CLUSTER_LAUNCHES = 0
    scan_int8.TC_LAUNCHES = 0
    extract.IDS_LAUNCHES = extract.POOL_LAUNCHES = 0
    knn.SEEDED_LAUNCHES = knn.DIAG_START_LAUNCHES = knn.PERM_LAUNCHES = 0
    knn.SPLIT_LAUNCHES = knn_t.SPLIT_LAUNCHES = 0
    if _has_sym(knn):
        knn.SYM_LAUNCHES = 0
    for mod in (knn, knn_t, scan_topk):
        if hasattr(mod, "TMA_LAUNCHES"):
            mod.TMA_LAUNCHES = 0
    if hasattr(scan_topk, "TC_LAUNCHES"):
        scan_topk.TC_LAUNCHES = 0


def _launches() -> dict:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 ivf_scan, knn, knn_t,
                                                 scan_int8, scan_topk,
                                                 subtile_max)
    return {"knn": knn.LAUNCHES, "knn_t": knn_t.LAUNCHES,
            "knn_seeded": knn.SEEDED_LAUNCHES,
            "knn_diagstart": knn.DIAG_START_LAUNCHES,
            "knn_reorder": knn.PERM_LAUNCHES,
            "knn_split": getattr(knn, "SPLIT_LAUNCHES", 0),
            "knn_sym": getattr(knn, "SYM_LAUNCHES", 0),
            "knn_tma": getattr(knn, "TMA_LAUNCHES", 0),
            "knn_t_tma": getattr(knn_t, "TMA_LAUNCHES", 0),
            "scan_topk_tma": getattr(scan_topk, "TMA_LAUNCHES", 0),
            "knn_t_split": getattr(knn_t, "SPLIT_LAUNCHES", 0),
            "scan_topk": scan_topk.LAUNCHES,
            "scan_topk_tc": getattr(scan_topk, "TC_LAUNCHES", 0),
            "subtile_max": subtile_max.LAUNCHES,
            "subtile_max_tc": getattr(subtile_max, "TC_LAUNCHES", 0),
            "subtile_max_cluster": getattr(subtile_max, "CLUSTER_LAUNCHES",
                                           0),
            "extract_ids": extract.IDS_LAUNCHES,
            "extract_pool": extract.POOL_LAUNCHES,
            "gather_score": gather_score.LAUNCHES,
            "gather_score_tc": getattr(gather_score, "TC_LAUNCHES", 0),
            "ivf_scan": ivf_scan.LAUNCHES,
            "ivf_scan_wide": getattr(ivf_scan, "WIDE_LAUNCHES", 0),
            "scan_int8": scan_int8.LAUNCHES,
            "scan_int8_tc": getattr(scan_int8, "TC_LAUNCHES", 0)}


def _overlap(ids_a: np.ndarray, ids_b: np.ndarray) -> float:
    """Mean share of each row's ids that both top-k lists hold."""
    same = (ids_a[:, :, None] == ids_b[:, None, :]).any(axis=2)
    return float(same.mean())


def _exact_vs_subtile(torch, aspace, batches, kw: dict) -> dict:
    """QPS of search_batch in exact and in subtile mode over the batches,
    timed in turns (exact, subtile, subtile, exact; both warm), each turn
    ending with the results on the host."""
    gl = kw.get("gl")
    extra = {k: v for k, v in kw.items() if k != "gl"}

    def qps(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            aspace.search_batch(b, gl, TAU, mode=mode, **extra)
        return sum(b.shape[0] for b in batches) / (time.perf_counter() - t0)

    e1, s1, s2, e2 = (qps(m) for m in ("exact", "subtile", "subtile",
                                       "exact"))
    return {"exact": (e1 + e2) / 2, "subtile": (s1 + s2) / 2}


def _ell_symmetric(nbr_idx: np.ndarray, nbr_w: np.ndarray) -> bool:
    """Every stored (i, j, w) has its (j, i, w) partner, bitwise."""
    n, m = nbr_idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), m)
    cols = nbr_idx.reshape(-1).astype(np.int64)
    w = nbr_w.reshape(-1)
    keep = cols >= 0
    rows, cols, w = rows[keep], cols[keep], w[keep]
    fwd = rows * n + cols
    order = np.argsort(fwd, kind="stable")
    fwd_sorted, w_sorted = fwd[order], w[order]
    rev = cols * n + rows
    pos = np.searchsorted(fwd_sorted, rev)
    pos = np.minimum(pos, fwd_sorted.size - 1)
    return bool(np.all(fwd_sorted[pos] == rev)
                and np.array_equal(w_sorted[pos].view(np.uint32)
                                   if w.dtype == np.float32 else w_sorted[pos],
                                   w.view(np.uint32)
                                   if w.dtype == np.float32 else w))


def _phase_subtile_serving(torch, aspace, gl, batches, src, outs_exact,
                           card, results) -> None:
    """Phase 5: search_batch(mode="subtile") and mode="auto" on the phase-3
    index, against phase 3's exact results."""
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    from pyarrowspace_tpu_torch.ops.subtile_scan import build_subtile_state
    topk = GP["topk"]
    exact_ids = np.concatenate([o[0] for o in outs_exact])
    checks = {}
    for mode in ("subtile", "auto"):
        aspace.search_batch(batches[-1], gl, TAU, mode=mode)    # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        got = [aspace.search_batch(b, gl, TAU, mode=mode) for b in batches]
        t_search = time.perf_counter() - t0
        launches = _launches()
        if mode == "subtile":
            results["launches_subtile"] = launches
        qps = Q_BATCH * N_BATCHES / t_search
        ids = np.concatenate([o[0] for o in got])
        overlap = _overlap(ids, exact_ids)
        bad = sum(len(topk_disagreements(o[1], o[0], e[1], e[0], TOL))
                  for o, e in zip(got, outs_exact))
        top1 = all(np.array_equal(o[0][:, 0], s_) for o, s_ in zip(got, src))
        print(f"phase 5: search_batch {mode}: {qps:.1f} QPS over "
              f"{N_BATCHES} x {Q_BATCH} queries, {t_search:.3f} s (exact "
              f"{results['exact_qps']:.1f} QPS) N={N} F={F} topk={topk} "
              f"{card}")
        print(f"phase 5: {mode}: launches {launches}; top-{topk} overlap "
              f"with exact {overlap:.6f}, queries differing beyond "
              f"near-ties {bad}; each source row first: {top1}")
        for name in ("subtile_max", "extract_ids", "gather_score",
                     "extract_pool"):
            checks[f"{mode}: {name} launched"] = launches[name] > 0
        for name in ("subtile_max", "gather_score"):
            checks[f"{mode}: {name} on the tensor-core route"] = (
                launches[f"{name}_tc"] == launches[name] > 0)
        checks[f"{mode}: subtile_max in clusters"] = (
            launches["subtile_max_cluster"] == launches["subtile_max"])
        checks[f"{mode}: source row first"] = top1
        checks[f"{mode}: overlap >= {MIN_OVERLAP}"] = overlap >= MIN_OVERLAP
        checks[f"{mode}: result shapes"] = all(
            o[0].shape == (Q_BATCH, topk) and np.all(np.isfinite(o[1]))
            for o in got)
    # A float32 scan state: routing scores are K2's scores bit for bit, so
    # the block-max bound makes the served ids the exact ones.
    f32 = torch.float32
    st = build_subtile_state(aspace._data_unit, aspace._lambdas,
                             scan_dtype=f32)
    bad32 = 0
    for b, e in zip(batches, outs_exact):
        i32, v32 = search_ops.fused_query_pipeline_subtile(
            st["xu_scan"], st["xu_f32"], st["lambdas"], st["n_real"],
            aspace._lap_f, aspace._w_f, aspace._tau_star, b, TAU, topk=topk,
            rayleigh_normalized=aspace._rayleigh_normalized,
            tau_mix=aspace._tau_mix)
        bad32 += len(topk_disagreements(v32.cpu().numpy(), i32.cpu().numpy(),
                                        e[1], e[0], TOL))
    print(f"phase 5: float32 scan state: queries differing from exact "
          f"beyond near-ties of {TOL:g}: {bad32} of {N_BATCHES * Q_BATCH}")
    checks["float32 scan: ids equal outside near-ties"] = bad32 == 0
    del st
    turns = _exact_vs_subtile(torch, aspace, batches, dict(gl=gl))
    results["turns_313k"] = turns
    print(f"phase 5: in turns (exact, subtile, subtile, exact) over "
          f"{N_BATCHES} x {Q_BATCH} queries: exact {turns['exact']:.1f} QPS, "
          f"subtile {turns['subtile']:.1f} QPS {card}")
    if not all(checks.values()):
        raise AssertionError(f"subtile checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_subtile_kernels(torch, aspace, batches, card, results) -> None:
    """Phase 6: K3, K4b, K5 and K4a against their plain versions on the
    first batch at the shapes of phase 5, timed in turns, and the bitwise
    block-max check."""
    from pyarrowspace_tpu_torch.ops import subtile_scan
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 subtile_max)
    from pyarrowspace_tpu_torch.ops.cuda.compare import max_abs_err
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    f32 = torch.float32
    st = aspace._subtile
    xs, lam, n_real = st["xu_scan"], st["lambdas"], st["n_real"]
    qb = batches[0].to(f32)
    lamq = _query_lambdas32(torch, aspace, qb)
    qs = unit_normalize(qb).to(xs.dtype).contiguous()
    topk = GP["topk"]
    s_keep = subtile_scan.subtiles_kept(topk, xs.shape[0] // 64)
    m_pool = 2 * topk
    real = -(-n_real // 64)
    tau32 = torch.tensor(TAU, dtype=f32)
    q = qs.shape[0]

    sub = subtile_max.subtile_max(xs, lam, qs, lamq, TAU, n_real)
    sub_p = subtile_max.subtile_max_plain(xs, lam, qs, lamq, TAU, n_real)
    err3 = max_abs_err(sub[:, :real].cpu().numpy(),
                       sub_p[:, :real].cpu().numpy())
    sentinels = torch.equal(sub[:, real:], sub_p[:, real:])
    sel = extract.extract_ids(sub, s_keep)
    sel_same = torch.equal(sel, extract.extract_ids_plain(sub, s_keep))
    cos = gather_score.gather_score(xs, qs, sel)
    err5 = max_abs_err(cos.cpu().numpy(), gather_score.gather_score_plain(
        xs, qs, sel).cpu().numpy())
    score_b, cand = subtile_scan.phase_b_scores(cos, sel, lam, lamq, tau32,
                                                n_real)
    pool = extract.extract_pool(score_b, cand, m_pool)
    pool_same = torch.equal(pool, extract.extract_pool_plain(score_b, cand,
                                                             m_pool))
    # The block-max guarantee: phase b's best score in each selected
    # subtile (with a real row) is K3's maximum for it, bit for bit.
    best = score_b.view(q, s_keep, 64).amax(dim=2)
    routed = torch.gather(sub, 1, sel.to(torch.int64))
    has_real = sel.to(torch.int64) * 64 < n_real
    bitwise = torch.equal(best[has_real].view(torch.int32),
                          routed[has_real].view(torch.int32))
    n_checked = int(has_real.sum())

    times = {
        "subtile_max": _in_turns(
            lambda: subtile_max.subtile_max_plain(xs, lam, qs, lamq, TAU,
                                                  n_real),
            lambda: subtile_max.subtile_max(xs, lam, qs, lamq, TAU, n_real),
            torch),
        "extract_ids": _device_turns(
            lambda: extract.extract_ids_plain(sub, s_keep),
            lambda: extract.extract_ids(sub, s_keep), torch),
        "gather_score": _in_turns(
            lambda: gather_score.gather_score_plain(xs, qs, sel),
            lambda: gather_score.gather_score(xs, qs, sel), torch),
        "extract_pool": _device_turns(
            lambda: extract.extract_pool_plain(score_b, cand, m_pool),
            lambda: extract.extract_pool(score_b, cand, m_pool), torch),
    }
    errs = {"subtile_max": err3, "extract_ids": 0.0 if sel_same else 1.0,
            "gather_score": err5, "extract_pool": 0.0 if pool_same else 1.0}
    # One PyTorch call computes the selects' function (torch.topk); none
    # computes a blended max per subtile or a gather-and-score.
    library = {"subtile_max": None, "gather_score": None}
    library["extract_ids"] = _device_ms(
        lambda: torch.topk(sub, s_keep, dim=1), torch)
    library["extract_pool"] = _device_ms(
        lambda: torch.topk(score_b, m_pool, dim=1), torch)
    n_pad, f = xs.shape
    n_sub, elt = n_pad // 64, xs.element_size()
    kind = "bf16" if xs.dtype == torch.bfloat16 else "fp32"
    rows_read = int(torch.unique(sel).numel()) * 64
    width_b = score_b.shape[1]
    # K3 multiplies only the real subtiles' rows; the rest get a sentinel.
    rows_k3 = real * 64
    bounds = {
        "subtile_max": _bound(2.0 * q * rows_k3 * f, kind,
                              rows_k3 * (f * elt + 4) + q * (f * elt + 4)
                              + q * n_sub * 4),
        "extract_ids": _bound(q * n_sub, "fp32",
                              q * n_sub * 4 + q * s_keep * 4),
        "gather_score": _bound(2.0 * q * s_keep * 64 * f, kind,
                               rows_read * f * elt + q * f * elt
                               + q * s_keep * 4 + q * s_keep * 64 * 4),
        "extract_pool": _bound(q * width_b, "fp32",
                               q * width_b * 8 + q * m_pool * 4)}
    # K5's old design read each query's subtiles itself: its floor.
    no_reuse_ms = (q * s_keep * 64 * f * elt) / HBM_BYTES_PER_S * 1e3
    route = subtile_max.route_name(xs, qs)
    routes = {"subtile_max": subtile_max.LAST_ROUTE, "gather_score": route,
              "extract_ids": _select_route(extract, sub, s_keep),
              "extract_pool": _select_route(extract, score_b, m_pool)}
    from pyarrowspace_tpu_torch import _build
    for name, (k_ms, p_ms) in times.items():
        results[name] = dict(max_abs_err=errs[name], ms=k_ms, plain_ms=p_ms,
                             library_ms=library[name], **bounds[name])
        if name.startswith("extract"):
            results[name]["kernel_route"] = routes[name]
        src = "extract_topm" if name.startswith("extract") else name
        print(f"phase 6: {name} Q={q} N_pad={xs.shape[0]} F={xs.shape[1]} "
              f"{xs.dtype}: {routes[name]} route, kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
              f"({bounds[name]['bound_by']}); ptxas csrc/{src}.cu: "
              f"{_ptxas_summary(_build, src)} {card}")
    print(f"phase 6: K5 reads {rows_read} distinct rows once; each query "
          f"reading its {s_keep} subtiles itself would move "
          f"{q * s_keep * 64 * f * elt / 1e9:.3f} GB ({no_reuse_ms:.3f} ms "
          f"at 3.35 TB/s, the old design's floor) {card}")
    print(f"phase 6: K3 launches {subtile_max.LAUNCHES}, on the tensor "
          f"cores {subtile_max.TC_LAUNCHES}, in clusters "
          f"{subtile_max.CLUSTER_LAUNCHES}; last route "
          f"{subtile_max.LAST_ROUTE}")
    print(f"phase 6: K3 max_abs_err {err3:.3e} over {real} real subtiles, "
          f"sentinels equal {sentinels}; K4b ids identical {sel_same} "
          f"(S={s_keep}); K5 max_abs_err {err5:.3e}; K4a ids identical "
          f"{pool_same} (m={m_pool}); block max bitwise equal {bitwise} on "
          f"{n_checked} selected subtiles")
    # The wide lists (m > 256), in place in device memory: K4b and K4a at
    # m 1,024 over the K3 maxima (K4a with a random permutation as ids).
    gen = torch.Generator(device=sub.device)
    gen.manual_seed(3)
    cand = torch.argsort(torch.rand(sub.shape, generator=gen,
                                    device=sub.device), dim=1)
    cand = cand.to(torch.int32)
    wide_same = {
        "extract_ids": torch.equal(extract.extract_ids(sub, K_WIDEST),
                                   extract.extract_ids_plain(sub, K_WIDEST)),
        "extract_pool": torch.equal(
            extract.extract_pool(sub, cand, K_WIDEST),
            extract.extract_pool_plain(sub, cand, K_WIDEST))}
    wide_times = {
        "extract_ids": _device_turns(
            lambda: extract.extract_ids_plain(sub, K_WIDEST),
            lambda: extract.extract_ids(sub, K_WIDEST), torch),
        "extract_pool": _device_turns(
            lambda: extract.extract_pool_plain(sub, cand, K_WIDEST),
            lambda: extract.extract_pool(sub, cand, K_WIDEST), torch)}
    wide_topk = {
        "extract_ids": _device_turns(
            lambda: torch.topk(sub, K_WIDEST, dim=1),
            lambda: extract.extract_ids(sub, K_WIDEST), torch),
        "extract_pool": _device_turns(
            lambda: torch.topk(sub, K_WIDEST, dim=1),
            lambda: extract.extract_pool(sub, cand, K_WIDEST), torch)}
    narrow = {"extract_ids": _device_ms(
                  lambda: extract.extract_ids(sub, s_keep), torch),
              "extract_pool": _device_ms(
                  lambda: extract.extract_pool(sub, cand, m_pool), torch)}
    for name, (k_ms, p_ms) in wide_times.items():
        k2_ms, topk_ms = wide_topk[name]
        results.setdefault("wide", {})[name] = dict(
            k=K_WIDEST, ms=k_ms, plain_ms=p_ms, narrow_ms=narrow[name],
            library_ms=topk_ms, library_turn_ms=k2_ms,
            kernel_route=_select_route(extract, sub, K_WIDEST))
        print(f"phase 6: {name} at m={K_WIDEST} on {tuple(sub.shape)} "
              f"({_select_route(extract, sub, K_WIDEST)} route): ids "
              f"identical {wide_same[name]}; kernel {k_ms:.3f} ms (narrow "
              f"{narrow[name]:.3f} ms), plain {p_ms:.3f} ms; in turns with "
              f"torch.topk: kernel {k2_ms:.3f} ms, torch.topk {topk_ms:.3f} "
              f"ms {card}")
    if not (err3 <= TOL and sentinels and sel_same and err5 <= TOL
            and pool_same and bitwise and n_checked == q * s_keep
            and all(wide_same.values()) and route == "tensor-core"):
        raise AssertionError("subtile kernels disagree with their plain "
                             "versions or the block-max check failed")


def _phase_subtile_ab(torch, aspace, gl, batches, dev, card,
                      results) -> None:
    """Phase 6b (--measure only): K3 and K5 of the tree under measure at
    phase 6's shapes, and K3 over a 1,000,000 x 768 bf16 corpus made from
    a seeded generator against 16,384 queries, each timed twice and held
    against its plain version (at 1M on the first 1,024 queries); K4b and
    K4a (device times, _device_ms) at phase 6's shapes and on that 1M
    corpus's maxima and phase b, each in turns with torch.topk, and at m
    1,024 in turns with their plain versions, their ids held against the
    plain versions and kept for the comparison across trees."""
    from pyarrowspace_tpu_torch.ops import subtile_scan
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 subtile_max)
    from pyarrowspace_tpu_torch.ops.cuda.compare import max_abs_err
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    f32, bf16 = torch.float32, torch.bfloat16
    aspace.search_batch(batches[0], gl, TAU, mode="subtile")    # the state
    st = aspace._subtile
    xs, lam, n_real = st["xu_scan"], st["lambdas"], st["n_real"]
    qb = batches[0].to(f32)
    lamq = _query_lambdas32(torch, aspace, qb)
    qs = unit_normalize(qb).to(xs.dtype).contiguous()
    s_keep = subtile_scan.subtiles_kept(GP["topk"], xs.shape[0] // 64)
    real = -(-n_real // 64)
    sub = subtile_max.subtile_max(xs, lam, qs, lamq, TAU, n_real)
    sub_p = subtile_max.subtile_max_plain(xs, lam, qs, lamq, TAU, n_real)
    err3 = max_abs_err(sub[:, :real].cpu().numpy(),
                       sub_p[:, :real].cpu().numpy())
    sel = extract.extract_ids(sub, s_keep)
    err5 = max_abs_err(gather_score.gather_score(xs, qs, sel).cpu().numpy(),
                       gather_score.gather_score_plain(xs, qs, sel)
                       .cpu().numpy())
    k3_ms = sum(_events_ms(lambda: subtile_max.subtile_max(
        xs, lam, qs, lamq, TAU, n_real), torch) for _ in range(2)) / 2
    k3_route = getattr(subtile_max, "LAST_ROUTE",
                       subtile_max.route_name(xs, qs))
    k5_ms = sum(_events_ms(lambda: gather_score.gather_score(xs, qs, sel),
                           torch) for _ in range(2)) / 2
    # The selects at phase 6's shapes, K4b and K4a each in turns with
    # torch.topk (the library call, their yardstick), and at m 1,024 in
    # turns with their plain versions (one stable torch.sort).
    tau32 = torch.tensor(TAU, dtype=f32)
    score_b, cand = subtile_scan.phase_b_scores(
        gather_score.gather_score(xs, qs, sel), sel, lam, lamq, tau32, n_real)
    m_pool = 2 * GP["topk"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    perm = torch.argsort(torch.rand(sub.shape, generator=gen, device=dev),
                         dim=1).to(torch.int32)
    # K3's maxima, kept for the comparison across trees: every tree's
    # tensor-core K3 gives the same bits.
    k4, dump, same = {}, {"k3_maxima": sub.cpu().numpy()}, {}

    def k4_turns(name, kernel, other, plain):
        out = kernel()
        dump[f"{name}_ids"] = out.cpu().numpy()
        same[name] = torch.equal(out, plain())
        k4[f"{name}_ms"], k4[f"{name}_{other[0]}_ms"] = _device_turns(
            other[1], kernel, torch)

    k4_turns("k4b", lambda: extract.extract_ids(sub, s_keep),
             ("topk", lambda: torch.topk(sub, s_keep, dim=1)),
             lambda: extract.extract_ids_plain(sub, s_keep))
    k4_turns("k4a", lambda: extract.extract_pool(score_b, cand, m_pool),
             ("topk", lambda: torch.topk(score_b, m_pool, dim=1)),
             lambda: extract.extract_pool_plain(score_b, cand, m_pool))
    k4_turns("k4b_k1024", lambda: extract.extract_ids(sub, K_WIDEST),
             ("plain", lambda: extract.extract_ids_plain(sub, K_WIDEST)),
             lambda: extract.extract_ids_plain(sub, K_WIDEST))
    k4_turns("k4a_k1024", lambda: extract.extract_pool(sub, perm, K_WIDEST),
             ("plain", lambda: extract.extract_pool_plain(sub, perm,
                                                          K_WIDEST)),
             lambda: extract.extract_pool_plain(sub, perm, K_WIDEST))
    gen.manual_seed(5)
    n_pad = -(-N1M // 8192) * 8192
    x1 = unit_normalize(torch.randn((n_pad, F1M), generator=gen,
                                    device=dev)).to(bf16)
    lam1 = torch.rand(n_pad, generator=gen, device=dev)
    q1 = unit_normalize(torch.randn((Q1M, F1M), generator=gen,
                                    device=dev)).to(bf16)
    lq1 = torch.rand(Q1M, generator=gen, device=dev)
    subtile_max.subtile_max(x1, lam1, q1, lq1, TAU, N1M)            # warm
    k3_1m_ms = sum(_events_ms(lambda: subtile_max.subtile_max(
        x1, lam1, q1, lq1, TAU, N1M), torch) for _ in range(2)) / 2
    qc, lc = q1[:Q1M_CHECK].contiguous(), lq1[:Q1M_CHECK].contiguous()
    real1 = -(-N1M // 64)
    err1m = max_abs_err(
        subtile_max.subtile_max(x1, lam1, qc, lc, TAU, N1M)[:, :real1]
        .cpu().numpy(),
        subtile_max.subtile_max_plain(x1, lam1, qc, lc, TAU, N1M)[:, :real1]
        .cpu().numpy())
    # K2 over the same bf16 rows at Q 16,384, k 15 (exact serving at the
    # north-star shape), in turns with K3 over them, its ids held against
    # the plain version on the first 1,024 queries.
    from pyarrowspace_tpu_torch.ops.cuda import scan_topk
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    topk = GP["topk"]
    x1r, lam1r, q1f = x1[:N1M], lam1[:N1M], q1.float()
    scan_topk.lambda_search(x1r, lam1r, q1f, lq1, TAU, topk)         # warm
    k2_1m_route = _last_route(scan_topk) or _k2_route(scan_topk, x1r, q1f,
                                                       topk, dev)
    k2_1m_ms, k3_1m_turns_ms = _in_turns(
        lambda: subtile_max.subtile_max(x1, lam1, q1, lq1, TAU, N1M),
        lambda: scan_topk.lambda_search(x1r, lam1r, q1f, lq1, TAU, topk),
        torch)
    q1c = q1f[:Q1M_CHECK].contiguous()
    i2, s2 = scan_topk.lambda_search(x1r, lam1r, q1c, lc, TAU, topk)
    i2p, s2p = scan_topk.scan_plain(x1r, lam1r, q1c, lc, TAU, topk)
    bad2 = topk_disagreements(s2.cpu().numpy(), i2.cpu().numpy(),
                              s2p.cpu().numpy(), i2p.cpu().numpy(), TOL)
    del i2, s2, i2p, s2p, q1f, q1c
    k2_1m_bound = _bound(2.0 * Q1M * N1M * F1M, "bf16",
                         N1M * (2 * F1M + 4)
                         + Q1M * ((F1M + 1) * 4 + topk * 8))
    # The selects at the 1M shape, on this corpus's K3 maxima and phase b.
    sub1 = subtile_max.subtile_max(x1, lam1, q1, lq1, TAU, N1M)
    dump["k3_maxima_1m_sha256"] = np.frombuffer(hashlib.sha256(
        sub1.cpu().numpy().tobytes()).digest(), np.uint8)
    s1 = subtile_scan.subtiles_kept(GP["topk"], sub1.shape[1])
    sel1 = extract.extract_ids(sub1, s1)
    score1, cand1 = subtile_scan.phase_b_scores(
        gather_score.gather_score(x1, q1, sel1), sel1, lam1, lq1, tau32, N1M)
    k4_turns("k4b_1m", lambda: extract.extract_ids(sub1, s1),
             ("topk", lambda: torch.topk(sub1, s1, dim=1)),
             lambda: extract.extract_ids_plain(sub1, s1))
    k4_turns("k4a_1m", lambda: extract.extract_pool(score1, cand1, m_pool),
             ("topk", lambda: torch.topk(score1, m_pool, dim=1)),
             lambda: extract.extract_pool_plain(score1, cand1, m_pool))
    del x1, q1, sub1, score1, cand1
    results["subtile_ab"] = dict(k3_ms=k3_ms, k5_ms=k5_ms, k3_1m_ms=k3_1m_ms,
                                 k2_bf16_1m_ms=k2_1m_ms,
                                 k3_1m_turns_ms=k3_1m_turns_ms, **k4)
    results.setdefault("ab_dump", {}).update(dump)
    for name in ("k4b", "k4a", "k4b_1m", "k4a_1m"):
        print(f"phase 6b: {name} {k4[name + '_ms']:.4f} ms, torch.topk "
              f"{k4[name + '_topk_ms']:.4f} ms in turns; ids identical to "
              f"the plain version's: {same[name]} {card}")
    for name in ("k4b_k1024", "k4a_k1024"):
        print(f"phase 6b: {name} {k4[name + '_ms']:.4f} ms, plain "
              f"{k4[name + '_plain_ms']:.4f} ms in turns; ids identical: "
              f"{same[name]} {card}")
    print(f"phase 6b: K3 ({k3_route} route) {k3_ms:.3f} ms, K5 "
          f"{k5_ms:.3f} ms at Q={qs.shape[0]} "
          f"N_pad={xs.shape[0]} F={xs.shape[1]} (max_abs_err {err3:.3e} / "
          f"{err5:.3e}); K3 {N1M}x{F1M} bf16, Q={Q1M}: {k3_1m_ms:.3f} ms "
          f"(max_abs_err {err1m:.3e} on {Q1M_CHECK} queries) {card}")
    print(f"phase 6b: K2 over bf16 rows {N1M}x{F1M}, Q={Q1M}, k={topk} "
          f"(route {k2_1m_route}): {k2_1m_ms:.3f} ms in turns with K3's "
          f"{k3_1m_turns_ms:.3f} ms over the same rows; bound "
          f"{k2_1m_bound['bound_ms']:.3f} ms ({k2_1m_bound['bound_by']}); "
          f"disagreeing queries with the plain version on {Q1M_CHECK}: "
          f"{len(bad2)} {card}")
    if max(err3, err5, err1m) > TOL or not all(same.values()) or bad2:
        raise AssertionError(f"K3 / K5 disagree with their plain versions: "
                             f"{err3} {err5} {err1m}, or K4: {same}, or K2 "
                             f"at 1M: {bad2[:10]}")


def _twice_ms(torch, fn) -> float:
    """Mean ms of two calls of fn (warm)."""
    return sum(_events_ms(fn, torch) for _ in range(2)) / 2


def _phase_scans_ab(torch, aspace, gl, batches, dev, card, results) -> None:
    """Phase 6c (--measure only): K7 and K6 of the tree under measure, each
    timed twice, their outputs kept for the bitwise comparison across
    trees: K7 on phase 10's first batch (the phase-3 index quantized, pool
    60) and over a 1,000,000 x 768 int8 corpus made from a seeded generator
    with 16,384 queries; K6 on phase 8's routed first batch and on phase
    9's 1M mixture (its clustering, float32 and bfloat16 slabs, 16,384
    routed queries, n_probe 8) at k 15 and at the wide pools of 260 and
    1,040 (and 60 over bf16 slabs; the long lists compared by a sha256
    of their bits), each held against its plain version (K7 bit for bit;
    K6 within TOL, on the first 1,024 queries)."""
    import inspect
    from pyarrowspace_tpu_torch.ops import ivf_scan as tis
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    from pyarrowspace_tpu_torch.ops.cuda import scan_int8
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.ops.quantize import quantize_rows
    f32 = torch.float32
    topk, m = GP["topk"], 4 * GP["topk"]
    out, dump, ok = {}, {}, True
    route = getattr(scan_int8, "route_name", lambda x, q: "simt")

    def k7(name, args):
        nonlocal ok
        i, sc = scan_int8.scan_int8(*args)
        n_chk = min(args[3].shape[0], Q1M_CHECK)
        chk = args[:3] + tuple(a[:n_chk] for a in args[3:6]) + args[6:]
        ip, sp = scan_int8.scan_int8_plain(*chk)
        same = (_bits_equal(torch, i[:n_chk], ip)
                and _bits_equal(torch, sc[:n_chk], sp))
        ok &= same
        out[f"{name}_ms"] = _twice_ms(
            torch, lambda: scan_int8.scan_int8(*args))
        dump[f"{name}_ids"], dump[f"{name}_scores"] = (i.cpu().numpy(),
                                                       sc.cpu().numpy())
        print(f"phase 6c: {name} ({route(args[0], args[3])} route) "
              f"{out[name + '_ms']:.3f} ms, Q={args[3].shape[0]} "
              f"N={args[0].shape[0]} F={args[0].shape[1]}; bit for bit the "
              f"plain version on {n_chk} queries: {same} {card}")

    aspace.search_batch(batches[-1], gl, TAU, mode="int8")    # quantizes
    xq, scales = aspace._quantized
    qb = batches[0]
    qq, qs = quantize_rows(unit_normalize(qb))
    args = (xq, scales.to(f32).contiguous(),
            aspace._lambdas.to(f32).contiguous(), qq, qs,
            _query_lambdas32(torch, aspace, qb), TAU)
    k7("k7", args + (m,))
    for pool in K7_WIDE_POOLS:
        k7(f"k7_pool{pool}", args + (pool,))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x1, s1 = quantize_rows(unit_normalize(torch.randn(
        (N1M, F1M), generator=gen, device=dev)))
    lam1 = torch.rand(N1M, generator=gen, device=dev)
    q1, qs1 = quantize_rows(unit_normalize(torch.randn(
        (Q1M, F1M), generator=gen, device=dev)))
    lq1 = torch.rand(Q1M, generator=gen, device=dev)
    k7("k7_1m", (x1, s1, lam1, q1, qs1, lq1, TAU, m))
    k7(f"k7_1m_pool{K7_WIDE_POOLS[0]}",
       (x1, s1, lam1, q1, qs1, lq1, TAU, K7_WIDE_POOLS[0]))
    del x1, q1

    has_tiles = "tiles" in inspect.signature(k6.ivf_scan).parameters

    def k6_scan(name, ivf, space, queries, pools):
        nonlocal ok
        q32 = queries.to(f32)
        lamq = _query_lambdas32(torch, space, q32)
        r = tis.route(ivf, unit_normalize(q32), lamq, tis._f32(TAU), qb=16,
                      n_probe=N_PROBE, use_bound=True)
        args = (ivf.slabs, ivf.slab_lambdas, ivf.slab_ids, r.qn_pad,
                r.lamq_pad, r.probe_tbl, TAU)
        n_chk = min(r.qn_pad.shape[0], Q1M_CHECK)
        chk = args[:3] + (r.qn_pad[:n_chk], r.lamq_pad[:n_chk],
                          r.probe_tbl[:n_chk // 16], TAU)
        for k in pools:
            key = name if k == topk else f"{name}_pool{k}"
            kw = dict(k=k, q_block=16, cap=ivf.cap)
            kw_k = dict(kw, tiles=ivf.slab_tiles) if has_tiles else kw
            s_k, i_k = k6.ivf_scan(*args, **kw_k)
            s_p, i_p = k6.ivf_scan_plain(*chk, **kw)
            bad = topk_disagreements(s_k[:n_chk].cpu().numpy(),
                                     i_k[:n_chk].cpu().numpy(),
                                     s_p.cpu().numpy(), i_p.cpu().numpy(),
                                     TOL)
            ok &= not bad
            out[f"{key}_ms"] = _twice_ms(torch,
                                         lambda: k6.ivf_scan(*args, **kw_k))
            i_np, s_np = i_k.cpu().numpy(), s_k.cpu().numpy()
            if k == topk:
                dump[f"{key}_ids"], dump[f"{key}_scores"] = i_np, s_np
            else:   # the long lists by their digest, every bit of both
                dump[f"{key}_digest"] = np.frombuffer(hashlib.sha256(
                    i_np.tobytes() + s_np.tobytes()).digest(), np.uint8)
            print(f"phase 6c: {key} {out[key + '_ms']:.3f} ms "
                  f"({_k6_route(k6, k)} route), "
                  f"{r.qn_pad.shape[0]} routed queries x {N_PROBE} probes x "
                  f"cap {ivf.cap} x F {r.qn_pad.shape[1]} {ivf.slabs.dtype}, "
                  f"k {k}; disagreeing with the plain version on {n_chk} "
                  f"queries: {len(bad)} {card}")

    pools = (topk,) + K6_WIDE_POOLS
    aspace.enable_ivf()
    k6_scan("k6", aspace._ensure_ivf_blocked(), aspace, batches[0], pools)
    space, _, _, queries = _mixture_space(torch, dev)
    space.enable_ivf(n_clusters=MIX_CLUSTERS)
    k6_scan("k6_1m_f32", space._ensure_ivf_blocked(), space, queries[0],
            pools)
    space.enable_ivf(slab_dtype=torch.bfloat16)
    k6_scan("k6_1m_bf16", space._ensure_ivf_blocked(), space, queries[0],
            (topk, K6_POOL_BF16) + K6_WIDE_POOLS)
    del space, queries
    results["scans_ab"] = out
    results.setdefault("ab_dump", {}).update(dump)
    if not ok:
        raise AssertionError("K6 / K7 disagree with their plain versions")


def _phase_north_star(torch, dev, card, results) -> None:
    """Phase 7: subtile and exact serving at 1,000,000 x 768, batches of
    16,384, from a serving state made on the card (no graph build)."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph.feature import build_feature_laplacian
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops import subtile_scan
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 scan_int8, subtile_max)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.ops.quantize import quantize_rows
    from pyarrowspace_tpu_torch.ops.rayleigh import (dispersion_batch,
                                                     rayleigh_batch)
    from pyarrowspace_tpu_torch.spectral.taumode import (
        TAU_MIX, derive_tau_star, synthesize)
    topk = GP["topk"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((N1M, F1M), generator=gen, device=dev)
    xu = unit_normalize(x)
    w_f, lap_f, _ = build_feature_laplacian(x[:65536], k_f=15)
    e = rayleigh_batch(x, lap_f, normalized=False)
    tau_star = derive_tau_star(e, pt.TauMode.MEDIAN)
    lams = synthesize(e, dispersion_batch(x, w_f, e), tau_star, TAU_MIX)
    del x
    params = pt.GraphParams(eps=GP["eps"], k=GP["k"], topk=topk, p=GP["p"],
                            sigma=GP["sigma"])
    aspace = pt.ArrowSpace._from_build(
        data=xu, data_unit=xu, lambdas=lams, e_raw=e, lap_f=lap_f, w_f=w_f,
        tau_star=tau_star, params=params)
    queries = [torch.randn((Q1M, F1M), generator=gen, device=dev)
               for _ in range(3)]
    torch.cuda.synchronize()
    print(f"phase 7: serving state {N1M}x{F1M} made in "
          f"{time.perf_counter() - t0:.3f} s, tau* {float(tau_star):.6g}")
    # search_batch reads the graph only for its default topk.
    served, qps = {}, {}
    for mode in ("subtile", "exact"):
        aspace.search_batch(queries[2], None, TAU, topk=topk, mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served[mode] = [aspace.search_batch(b, None, TAU, topk=topk,
                                            mode=mode) for b in queries[:2]]
        qps[mode] = 2 * Q1M / (time.perf_counter() - t0)
        print(f"phase 7: search_batch {mode}: {qps[mode]:.1f} QPS over 2 x "
              f"{Q1M} queries, N={N1M} F={F1M} topk={topk} {card}")
    # The int8 mode: its first call quantizes the corpus (768 MB of int8).
    t0 = time.perf_counter()
    aspace.search_batch(queries[2], None, TAU, topk=topk, mode="int8")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    served["int8"] = [aspace.search_batch(b, None, TAU, topk=topk,
                                          mode="int8") for b in queries[:2]]
    qps["int8"] = 2 * Q1M / (time.perf_counter() - t0)
    overlap_int8 = _overlap(served["int8"][0][0][:Q1M_CHECK],
                            served["exact"][0][0][:Q1M_CHECK])
    print(f"phase 7: search_batch int8: {qps['int8']:.1f} QPS over 2 x "
          f"{Q1M} queries (first call with quantization {t_first:.3f} s); "
          f"top-{topk} overlap with exact on {Q1M_CHECK} queries "
          f"{overlap_int8:.6f} {card}")
    overlap = _overlap(served["subtile"][0][0][:Q1M_CHECK],
                       served["exact"][0][0][:Q1M_CHECK])
    st = aspace._subtile
    qb = queries[0]
    lamq = search_ops.query_lambdas(qb, lap_f, w_f, tau_star,
                                    rayleigh_normalized=False,
                                    tau_mix=TAU_MIX).contiguous()
    qs = unit_normalize(qb).to(st["xu_scan"].dtype).contiguous()
    sub = subtile_max.subtile_max(st["xu_scan"], st["lambdas"], qs, lamq,
                                  TAU, st["n_real"])
    k3_ms = _events_ms(lambda: subtile_max.subtile_max(
        st["xu_scan"], st["lambdas"], qs, lamq, TAU, st["n_real"]), torch)
    route = subtile_max.LAST_ROUTE
    k4 = _selects_1m(torch, extract, gather_score, subtile_scan, st, qs,
                     lamq, sub, card)
    del sub
    # K7 alone at 1M, its route, its bound; held against its plain version
    # (ids identical, scores bit for bit) on the first Q1M_CHECK queries.
    xq, scales = aspace._quantized
    lam32 = aspace._lambdas.to(torch.float32).contiguous()
    sc32 = scales.to(torch.float32).contiguous()
    qq, qsc = quantize_rows(unit_normalize(qb))
    m = 4 * topk
    k7_args = (xq, sc32, lam32, qq, qsc, lamq, TAU, m)
    scan_int8.scan_int8(*k7_args)
    k7_ms = _events_ms(lambda: scan_int8.scan_int8(*k7_args), torch)
    chk = (xq, sc32, lam32, qq[:Q1M_CHECK], qsc[:Q1M_CHECK],
           lamq[:Q1M_CHECK], TAU, m)
    k7_same = _bits_equal(torch, scan_int8.scan_int8(*chk)[0],
                          scan_int8.scan_int8_plain(*chk)[0]) and \
        _bits_equal(torch, scan_int8.scan_int8(*chk)[1],
                    scan_int8.scan_int8_plain(*chk)[1])
    k7_route = scan_int8.route_name(xq, qq)
    k7_bound = _bound(2.0 * Q1M * N1M * F1M, "int8",
                      N1M * (F1M + 8) + Q1M * (F1M + 8) + Q1M * m * 8)
    print(f"phase 7: K7 alone ({k7_route} route) {k7_ms:.3f} ms a batch of "
          f"{Q1M}, pool {m}, bound {k7_bound['bound_ms']:.3f} ms "
          f"({k7_bound['bound_by']}); ids and scores bit for bit the plain "
          f"version's on {Q1M_CHECK} queries: {k7_same} {card}")
    # A wide pool at 1M (past the 82 entries that fit beside the ring at F
    # 768): against its plain version on the first Q1M_CHECK queries.
    pool = K7_WIDE_POOLS[0]
    k7w = _k7_wide(torch, scan_int8, k7_args[:-1] + (pool,),
                   chk[:-1] + (pool,), f"phase 7: K7 pool {pool}", card)
    k7w["narrow_ms"] = k7_ms
    results["wide_int8_1m"] = k7w
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    turns = _exact_vs_subtile(torch, aspace, queries[:2], dict(topk=topk))
    results["north_star"] = dict(qps=qps, overlap=overlap,
                                 overlap_int8=overlap_int8, k3_ms=k3_ms,
                                 k7_ms=k7_ms, k7_route=k7_route,
                                 k7_bound_ms=k7_bound["bound_ms"],
                                 peak_gib=peak, turns=turns, **k4)
    # The real subtiles' rows only, as in phase 6.
    rows_k3 = -(-st["n_real"] // 64) * 64
    k3_bound = _bound(2.0 * Q1M * rows_k3 * F1M, "bf16", 0.0)
    print(f"phase 7: top-{topk} overlap subtile vs exact on {Q1M_CHECK} "
          f"queries {overlap:.6f}; K3 alone ({route} route) {k3_ms:.3f} ms "
          f"a batch of {Q1M}, bound "
          f"{k3_bound['bound_ms']:.3f} ms; peak device memory {peak:.3f} GiB "
          f"{card}")
    print(f"phase 7: in turns (exact, subtile, subtile, exact) over 2 x "
          f"{Q1M} queries: exact {turns['exact']:.1f} QPS, subtile "
          f"{turns['subtile']:.1f} QPS {card}")
    ok = all(np.all(np.isfinite(v)) and i.shape == (Q1M, topk)
             and i.min() >= 0 and i.max() < N1M
             for outs in served.values() for i, v in outs)
    del aspace, st, queries, xq, qq
    if not ok or overlap < MIN_OVERLAP or overlap_int8 < MIN_OVERLAP \
            or not k7_same or k7_route != "tensor-core" \
            or not (k7w["bitwise"] and k7w["launches"] == 1) \
            or not (k4["k4b_same"] and k4["k4a_same"]):
        raise AssertionError(f"1M serving check failed: results ok {ok}, "
                             f"overlap {overlap}, int8 {overlap_int8}, K7 "
                             f"bitwise {k7_same} on the {k7_route} route, "
                             f"pool {pool} {k7w['bitwise']}, "
                             f"K4b / K4a ids {k4['k4b_same']} / "
                             f"{k4['k4a_same']}")


def _selects_1m(torch, extract, gather_score, subtile_scan, st, qs, lamq,
                sub, card) -> dict:
    """Phase 7's K4b (the top-S select over K3's maxima [Q, n_sub]) and
    K4a (the pool cut over phase b's scores [Q, S x 64]) at the 1M shape:
    ids against the plain version on the first Q1M_CHECK queries, device
    times in turns with torch.topk, and the bounds."""
    q, n_sub = sub.shape
    topk = GP["topk"]
    s_keep = subtile_scan.subtiles_kept(topk, n_sub)
    m_pool = 2 * topk
    sel = extract.extract_ids(sub, s_keep)
    k4b_same = torch.equal(sel[:Q1M_CHECK], extract.extract_ids_plain(
        sub[:Q1M_CHECK].contiguous(), s_keep))
    k4b_ms, k4b_topk = _device_turns(
        lambda: torch.topk(sub, s_keep, dim=1),
        lambda: extract.extract_ids(sub, s_keep), torch)
    cos = gather_score.gather_score(st["xu_scan"], qs, sel)
    score_b, cand = subtile_scan.phase_b_scores(
        cos, sel, st["lambdas"], lamq, torch.tensor(TAU, dtype=torch.float32),
        st["n_real"])
    del cos
    pool = extract.extract_pool(score_b, cand, m_pool)
    k4a_same = torch.equal(pool[:Q1M_CHECK], extract.extract_pool_plain(
        score_b[:Q1M_CHECK].contiguous(), cand[:Q1M_CHECK].contiguous(),
        m_pool))
    k4a_ms, k4a_topk = _device_turns(
        lambda: torch.topk(score_b, m_pool, dim=1),
        lambda: extract.extract_pool(score_b, cand, m_pool), torch)
    width = score_b.shape[1]
    k4b_bound = _bound(q * n_sub, "fp32", q * n_sub * 4 + q * s_keep * 4)
    k4a_bound = _bound(q * width, "fp32", q * width * 8 + q * m_pool * 4)
    print(f"phase 7: K4b ({_select_route(extract, sub, s_keep)} route) "
          f"{k4b_ms:.4f} ms on {tuple(sub.shape)} -> {s_keep}, torch.topk "
          f"{k4b_topk:.4f} ms in turns, bound {k4b_bound['bound_ms']:.4f} ms "
          f"({k4b_bound['bound_by']}); ids identical to the plain version's "
          f"on {Q1M_CHECK} queries: {k4b_same} {card}")
    print(f"phase 7: K4a ({_select_route(extract, score_b, m_pool)} route) "
          f"{k4a_ms:.4f} ms on {tuple(score_b.shape)} -> {m_pool}, torch.topk "
          f"{k4a_topk:.4f} ms in turns, bound {k4a_bound['bound_ms']:.4f} ms "
          f"({k4a_bound['bound_by']}); ids identical to the plain version's "
          f"on {Q1M_CHECK} queries: {k4a_same} {card}")
    return dict(k4b_ms=k4b_ms, k4b_topk_ms=k4b_topk,
                k4b_bound_ms=k4b_bound["bound_ms"], k4b_same=k4b_same,
                k4a_ms=k4a_ms, k4a_topk_ms=k4a_topk,
                k4a_bound_ms=k4a_bound["bound_ms"], k4a_same=k4a_same)


class _CertifiedCounts:
    """Counts what certified serving did with its queries: those refused at
    the base n_probe, those a widening round certified, and those
    escalated to the exact scan.  It wraps the two splice functions of
    ops/ivf_scan.py, which core/space.py calls through the module, for the
    duration of a with block."""

    def __init__(self):
        from pyarrowspace_tpu_torch.ops import ivf_scan as tis
        self._mod = tis
        self.queries = self.widened = self.escalated = 0

    def __enter__(self):
        tis = self._mod
        self._orig = (tis.widen_refusals, tis.escalate_uncertified)
        widen, escalate = self._orig

        def counted_widen(idx, vals, cert, run, topk, n_probe, n_max):
            out = widen(idx, vals, cert, run, topk, n_probe, n_max)
            self.widened += int(out[2].sum() - np.asarray(cert).sum())
            return out

        def counted_escalate(idx, vals, cert, run, topk):
            cert = np.asarray(cert)
            self.queries += cert.size
            self.escalated += (cert.size if idx.shape[1] < topk
                               else int((~cert).sum()))
            return escalate(idx, vals, cert, run, topk)

        tis.widen_refusals, tis.escalate_uncertified = (counted_widen,
                                                        counted_escalate)
        return self

    def __exit__(self, *exc):
        self._mod.widen_refusals, self._mod.escalate_uncertified = self._orig

    def summary(self) -> dict:
        refused = self.widened + self.escalated
        return {"queries": self.queries,
                "base_cert_rate": 1.0 - refused / max(1, self.queries),
                "widened": self.widened, "escalated": self.escalated}


class _K6Record:
    """Records K6 on the serving path for the duration of a with block, by
    list length: the wrapper's calls (ops/ivf_scan.py calls it through
    the module), their routed queries, the kernel launches and wide
    launches the CUDA wrapper counted during each call (its counters,
    which the caller resets before the block), and the calls' device time
    (CUDA events around each, read after the block)."""

    def __init__(self, torch):
        from pyarrowspace_tpu_torch.ops import ivf_scan as tis
        from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
        self._mod, self._k6, self._torch, self.calls = tis, k6, torch, []

    def __enter__(self):
        self._orig = scan = self._mod.ivf_scan
        torch, k6 = self._torch, self._k6

        def recorded(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            launches, wide = k6.LAUNCHES, k6.WIDE_LAUNCHES
            start.record()
            out = scan(*args, **kw)
            stop.record()
            self.calls.append((kw["k"], int(args[3].shape[0]),
                               k6.LAUNCHES - launches,
                               k6.WIDE_LAUNCHES - wide, start, stop))
            return out

        self._mod.ivf_scan = recorded
        return self

    def __exit__(self, *exc):
        self._mod.ivf_scan = self._orig

    def summary(self) -> dict:
        """{k: {calls, queries, launches, wide_launches, ms}}."""
        self._torch.cuda.synchronize()
        by_k: dict = {}
        for k, q, n, n_wide, start, stop in self.calls:
            row = by_k.setdefault(k, dict(calls=0, queries=0, launches=0,
                                          wide_launches=0, ms=0.0))
            row["calls"] += 1
            row["queries"] += q
            row["launches"] += n
            row["wide_launches"] += n_wide
            row["ms"] += start.elapsed_time(stop)
        return by_k


def _k6_bound(torch, ivf, r, k) -> tuple[dict, dict, int, int]:
    """K6's bound on the routed batch r: the function's least work, the
    real rows (id >= 0) of each block's probed clusters, 2 F operations
    for each of them and each query of the block, and the bytes of the
    real rows of the distinct probed clusters read once, and the lists
    written once (on either route: the wide route's merges read its lists
    back, traffic of the route, not of the function; _k6_pools reports
    it beside the bound).  Returns (bound, the bound over every probed
    cap row, the first version's count, the real rows over all blocks,
    the rows K6 walks: the 64-row tiles up to each probed cluster's last
    real row)."""
    q_pad, f = r.qn_pad.shape
    n_blocks, n_probe = r.probe_tbl.shape
    qb = q_pad // n_blocks
    probe = r.probe_tbl.to(torch.int64)
    probed = torch.unique(probe)
    real = (ivf.slab_ids.view(-1, ivf.cap) >= 0).sum(1)
    rows = int(real[probe].sum())                    # over all blocks
    distinct = int(real[probed].sum())
    walked = int(ivf.slab_tiles.to(torch.int64)[probe].sum()) * 64
    elt = ivf.slabs.element_size()
    rest = q_pad * (f * 4 + 4) + probe.numel() * 4 + q_pad * k * 8
    bound = _bound(2.0 * qb * rows * f, "fp32",
                   distinct * (f * elt + 8) + rest)
    over_cap = _bound(2.0 * q_pad * n_probe * ivf.cap * f, "fp32",
                      int(probed.numel()) * ivf.cap * (f * elt + 8) + rest)
    return bound, over_cap, rows, walked


def _k6_routed(torch, ivf, aspace, qb):
    """The routing of the certified path (bound-ordered, blocks of 16) of
    the batch qb, and K6's arguments on it."""
    from pyarrowspace_tpu_torch.ops import ivf_scan as tis
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    q32 = qb.to(torch.float32)
    lamq = _query_lambdas32(torch, aspace, q32)
    r = tis.route(ivf, unit_normalize(q32), lamq, tis._f32(TAU), qb=16,
                  n_probe=N_PROBE, use_bound=True)
    args = (ivf.slabs, ivf.slab_lambdas, ivf.slab_ids, r.qn_pad, r.lamq_pad,
            r.probe_tbl, TAU)
    return r, args


def _k6_route(k6, k) -> str:
    """K6's route for lists of k ("simt" for a package with one route)."""
    fn = getattr(k6, "route_name", None)
    return fn(k) if fn else "simt"


def _k6_against_plain(torch, ivf, aspace, qb, k, label, card) -> tuple:
    """K6 against its plain version on the routed batch qb (the routing of
    the certified path: bound-ordered, blocks of 16), timed in turns.
    Returns (max_abs_err, kernel ms, plain ms, bound)."""
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    r, args = _k6_routed(torch, ivf, aspace, qb)
    kw = dict(k=k, q_block=16, cap=ivf.cap)
    kw_k = dict(kw, tiles=ivf.slab_tiles)
    s_k, i_k = k6.ivf_scan(*args, **kw_k)
    s_p, i_p = k6.ivf_scan_plain(*args, **kw)
    s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
    s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
    err = max_abs_err(s_k, s_p)
    bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
    k_ms, p_ms = _in_turns(lambda: k6.ivf_scan_plain(*args, **kw),
                           lambda: k6.ivf_scan(*args, **kw_k), torch)
    q_pad, f = r.qn_pad.shape
    bound, over_cap, rows, walked = _k6_bound(torch, ivf, r, k)
    cap_rows = q_pad // 16 * N_PROBE * ivf.cap
    print(f"{label}: K6 ({_k6_route(k6, k)} route) vs plain on {q_pad} "
          f"routed queries x {N_PROBE} probes x cap {ivf.cap} x F {f} "
          f"{ivf.slabs.dtype}, k {k}: max_abs_err {err:.3e}, disagreeing "
          f"queries {len(bad)}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}; the "
          f"{rows} real rows the probe table names, {rows / cap_rows:.3f} "
          f"of the probed cap rows; K6 walks {walked // 64} tiles, "
          f"{walked / cap_rows:.3f} of them; over every cap row, as "
          f"before: {over_cap['bound_ms']:.3f} ms) {card}")
    if bad or err > TOL:
        raise AssertionError(f"K6 disagrees with its plain version: queries "
                             f"{bad[:10]}, err {err}")
    return err, k_ms, p_ms, bound


def _k6_pools(torch, ivf, aspace, qb, pools, label, card, main) -> dict:
    """K6 on the routed batch qb at each list length of pools: its launch
    over the whole batch (each query's merges counted), held against its
    plain version on the first Q1M_CHECK queries (all of them at 313k)
    within TOL, both timed there in turns, and the whole batch timed (at
    1M), beside the bound and, on the wide route, the lists' read-back by
    the merges (at least once: Q k 8 bytes), which the bound leaves out.
    main: {k: (launches, run)}, the launches of K6's route for lists of k
    on a main-path serving run of this corpus and slabs (run names it),
    counted there after a reset; a list length that no such run reaches
    gets (0, None)."""
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    r, args = _k6_routed(torch, ivf, aspace, qb)
    q_pad, f = r.qn_pad.shape
    n_chk = min(q_pad, Q1M_CHECK) if q_pad > Q_BATCH else q_pad
    chk = args[:3] + (r.qn_pad[:n_chk], r.lamq_pad[:n_chk],
                      r.probe_tbl[:n_chk // 16], TAU)
    out, bad_pools = {}, []
    for k in pools:
        kw = dict(k=k, q_block=16, cap=ivf.cap)
        kw_k = dict(kw, tiles=ivf.slab_tiles)
        route = k6.route_name(k)
        merges = (torch.zeros(q_pad, dtype=torch.int32, device=r.qn_pad.device)
                  if route == "wide" else None)
        s_k, i_k = k6.ivf_scan(*args, **kw_k, merges=merges)
        launches, run = main.get(k, (0, None))
        s_p, i_p = k6.ivf_scan_plain(*chk, **kw)
        s_k, i_k = s_k[:n_chk].cpu().numpy(), i_k[:n_chk].cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        err = max_abs_err(s_k, s_p)
        bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        ms, plain_ms = _in_turns(lambda: k6.ivf_scan_plain(*chk, **kw),
                                 lambda: k6.ivf_scan(*chk, **kw_k), torch)
        bound = _k6_bound(torch, ivf, r, k)[0]
        row = dict(k=k, queries=q_pad, plain_queries=n_chk, ms=ms,
                   plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                   disagreeing=len(bad), kernel_route=route,
                   launches=launches, launches_run=run,
                   blocks_per_sm=k6.blocks_per_sm(k, 16, ivf.slabs.dtype,
                                                  r.qn_pad.device), **bound)
        if n_chk != q_pad:
            row["full_ms"] = _twice_ms(torch,
                                       lambda: k6.ivf_scan(*args, **kw_k))
            row["full_bound_ms"] = row["bound_ms"]
            row.update(_bound_at(torch, ivf, r, k, n_chk))
        if merges is not None:
            m = merges.to(torch.float64)
            row.update(merges_mean=float(m.mean()), merges_max=int(m.max()),
                       list_readback_bytes=n_chk * k * 8,
                       list_readback_ms=n_chk * k * 8 / HBM_BYTES_PER_S
                       * 1e3)
        out[f"pool{k}"] = row
        if bad or err > TOL:
            bad_pools.append(k)
        print(f"{label}: K6 pool {k} ({route} route, "
              f"{row['blocks_per_sm']} blocks an SM"
              + (f", merges a query {row['merges_mean']:.2f} mean, "
                 f"{row['merges_max']} max, lists read back by the merges "
                 f"at least {row['list_readback_ms']:.4f} ms beside the "
                 f"bound" if merges is not None else "")
              + f"; {launches} launches of the route at this length on "
              f"{run or 'no main-path run'}) on {n_chk} of {q_pad} routed "
              f"queries x {N_PROBE} probes x cap {ivf.cap} x F {f} "
              f"{ivf.slabs.dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms in turns, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']})"
              + (f"; all {q_pad}: {row['full_ms']:.3f} ms, bound "
                 f"{row['full_bound_ms']:.3f} ms" if n_chk != q_pad else "")
              + f"; max_abs_err {err:.3e}, disagreeing queries {len(bad)} "
              f"{card}")
    if bad_pools:
        raise AssertionError(f"K6 disagrees with its plain version at pools "
                             f"{bad_pools}")
    return out


def _bound_at(torch, ivf, r, k, n_chk) -> dict:
    """K6's bound on the first n_chk routed queries of r (the plain
    version's share of a 1M batch)."""
    from types import SimpleNamespace
    part = SimpleNamespace(qn_pad=r.qn_pad[:n_chk],
                           probe_tbl=r.probe_tbl[:n_chk // 16])
    bound = _k6_bound(torch, ivf, part, k)[0]
    return {"bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def _phase_certified(torch, aspace, gl, batches, outs_exact, card,
                     results) -> None:
    """Phase 8: blocked-IVF and certified serving on the phase-3 index,
    against phase 3's exact results."""
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    topk = GP["topk"]
    t0 = time.perf_counter()
    aspace.enable_ivf()
    ivf = aspace._ensure_ivf_blocked()
    torch.cuda.synchronize()
    print(f"phase 8: enable_ivf + slabs in {time.perf_counter() - t0:.3f} s: "
          f"K {ivf.n_clusters} (the build's clustering), cap {ivf.cap}, slab "
          f"rows {ivf.slabs.shape[0]} ({ivf.slabs.numel() * 4 / 2 ** 30:.3f} "
          f"GiB float32) {card}")
    got, qps = {}, {}
    for mode in ("ivf_block", "certified"):
        aspace.search_batch(batches[-1], gl, TAU, mode=mode, n_probe=N_PROBE)
        torch.cuda.synchronize()
        _reset_launches()
        with _CertifiedCounts() as counts:
            t0 = time.perf_counter()
            got[mode] = [aspace.search_batch(b, gl, TAU, mode=mode,
                                             n_probe=N_PROBE)
                         for b in batches]
            qps[mode] = Q_BATCH * N_BATCHES / (time.perf_counter() - t0)
        launches = _launches()
        print(f"phase 8: search_batch {mode} n_probe {N_PROBE}: "
              f"{qps[mode]:.1f} QPS over {N_BATCHES} x {Q_BATCH} queries "
              f"(exact {results['exact_qps']:.1f}); launches {launches} "
              f"{card}")
        if mode == "certified":
            results["launches_certified"] = launches
            summary = counts.summary()
            print(f"phase 8: certified: {summary}")
    exact_ids = np.concatenate([o[0] for o in outs_exact])
    overlap = _overlap(np.concatenate([o[0] for o in got["ivf_block"]]),
                       exact_ids)
    bad = sum(len(topk_disagreements(o[1], o[0], e[1], e[0], TOL))
              for o, e in zip(got["certified"], outs_exact))
    print(f"phase 8: ivf_block top-{topk} overlap with exact {overlap:.6f}; "
          f"certified queries differing from exact beyond near-ties of "
          f"{TOL:g}: {bad} of {N_BATCHES * Q_BATCH}")
    err, k_ms, p_ms, bound = _k6_against_plain(torch, ivf, aspace, batches[0],
                                               topk, "phase 8", card)
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    # ivf_block at topk 300: lists past 256 on the serving path.
    kw = dict(topk=K6_TOPK_IVF, mode="ivf_block", n_probe=N_PROBE)
    aspace.search_batch(batches[-1], gl, TAU, **kw)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    wide_out = [aspace.search_batch(b, gl, TAU, **kw) for b in batches]
    qps_wide = Q_BATCH * N_BATCHES / (time.perf_counter() - t0)
    wide_launches = _launches()
    # The wide pools' launches: this run's (its lists of 300 take the
    # route of pools 260 and 1,040; no 313k serving run scans those).
    run = f"phase 8 ivf_block topk {K6_TOPK_IVF} (lists of {K6_TOPK_IVF})"
    pools = _k6_pools(torch, ivf, aspace, batches[0], K6_WIDE_POOLS,
                      "phase 8", card,
                      {k: (wide_launches["ivf_scan_wide"], run)
                       for k in K6_WIDE_POOLS})
    results["ivf_scan"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
        kernel_route=k6.route_name(topk), **bound,
        wide={f"313k_{key}": v for key, v in pools.items()})
    exact300 = aspace.search_batch(batches[0], gl, TAU, topk=K6_TOPK_IVF,
                                   mode="exact")
    overlap300 = _overlap(wide_out[0][0], exact300[0])
    print(f"phase 8: search_batch ivf_block topk {K6_TOPK_IVF} n_probe "
          f"{N_PROBE}: {qps_wide:.1f} QPS over {N_BATCHES} x {Q_BATCH} "
          f"queries; K6 launches {wide_launches['ivf_scan']} (wide "
          f"{wide_launches['ivf_scan_wide']}); top-{K6_TOPK_IVF} overlap "
          f"with exact on the first batch {overlap300:.6f} {card}")
    results["certified_313k"] = dict(qps=qps, overlap=overlap, **summary,
                                     ivf_block_topk300_qps=qps_wide,
                                     ivf_block_topk300_overlap=overlap300)
    checks = {
        "K6 launched on the certified path":
            results["launches_certified"]["ivf_scan"] > 0,
        "K6's wide route launched by ivf_block topk 300":
            wide_launches["ivf_scan_wide"] == N_BATCHES,
        "ivf_block topk 300 shapes": all(
            o[0].shape == (Q_BATCH, K6_TOPK_IVF) and np.all(np.isfinite(o[1]))
            for o in wide_out),
        "certified == exact outside near-ties": bad == 0,
        "result shapes": all(o[0].shape == (Q_BATCH, topk)
                             and np.all(np.isfinite(o[1]))
                             for outs in got.values() for o in outs),
    }
    if not all(checks.values()):
        raise AssertionError(f"certified checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _mixture_rows(torch, dev, seed: int, n: int, f: int):
    """n rows of the mixture law drawn on the card: 4,096 N(0, 1) centres,
    each row a random centre + 0.35 N(0, 1), from a torch.Generator seeded
    with seed (as benchmarks/bench_serving.py makes them).  Returns (rows,
    the generator, to draw more from the same stream)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centres = torch.randn((MIX_CLUSTERS, f), generator=gen, device=dev)
    mix = torch.randint(0, MIX_CLUSTERS, (n,), generator=gen, device=dev)
    x = centres[mix] + MIX_NOISE * torch.randn((n, f), generator=gen,
                                               device=dev)
    return x, gen


def _mixture_space(torch, dev):
    """Phase 9's serving state: a 1,000,000 x 768 mixture corpus made on
    the card (4,096 centres, rows centre + 0.35 N(0, 1)) in an ArrowSpace,
    and 4 batches of 16,384 in-distribution queries (a unit corpus row +
    0.25 / sqrt(768) N(0, 1)), as benchmarks/bench_serving.py makes them.
    Returns (aspace, xu, lambdas, queries)."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph.feature import build_feature_laplacian
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.ops.rayleigh import (dispersion_batch,
                                                     rayleigh_batch)
    from pyarrowspace_tpu_torch.spectral.taumode import (
        TAU_MIX, derive_tau_star, synthesize)
    x, gen = _mixture_rows(torch, dev, 1, N1M, F1M)
    xu = unit_normalize(x)
    w_f, lap_f, _ = build_feature_laplacian(x[:65536], k_f=15)
    e = rayleigh_batch(x, lap_f, normalized=False)
    tau_star = derive_tau_star(e, pt.TauMode.MEDIAN)
    lams = synthesize(e, dispersion_batch(x, w_f, e), tau_star, TAU_MIX)
    del x
    params = pt.GraphParams(eps=GP["eps"], k=GP["k"], topk=GP["topk"],
                            p=GP["p"], sigma=GP["sigma"])
    aspace = pt.ArrowSpace._from_build(
        data=xu, data_unit=xu, lambdas=lams, e_raw=e, lap_f=lap_f, w_f=w_f,
        tau_star=tau_star, params=params)
    queries = []
    for _ in range(4):
        rows = torch.randint(0, N1M, (Q1M,), generator=gen, device=dev)
        queries.append(xu[rows] + (Q_NOISE / F1M ** 0.5) * torch.randn(
            (Q1M, F1M), generator=gen, device=dev))
    return aspace, xu, lams, queries


def _phase_certified_1m(torch, dev, card, results) -> None:
    """Phase 9: certified serving at 1,000,000 x 768, batches of 16,384, on
    a mixture corpus made on the card, over float32 and bfloat16 slabs,
    and the serving stream."""
    from pyarrowspace_tpu_torch.ops import ivf_scan as tis
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.spectral.taumode import TAU_MIX
    topk = GP["topk"]
    f32 = torch.float32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    aspace, xu, lams, queries = _mixture_space(torch, dev)
    torch.cuda.synchronize()
    print(f"phase 9: mixture serving state {N1M}x{F1M} ({MIX_CLUSTERS} "
          f"centres) made in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    aspace.enable_ivf(n_clusters=MIX_CLUSTERS)
    torch.cuda.synchronize()
    t_cluster = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = aspace._ensure_ivf_blocked()
    torch.cuda.synchronize()
    t_slabs = time.perf_counter() - t0
    sizes = torch.bincount(aspace._assignments.long())
    out = {"cluster_s": t_cluster, "k": ivf.n_clusters, "cap": ivf.cap,
           "max_cluster": int(sizes.max())}
    print(f"phase 9: enable_ivf(n_clusters={MIX_CLUSTERS}) in "
          f"{t_cluster:.3f} s: K {ivf.n_clusters} after tightening, largest "
          f"cluster {out['max_cluster']}, planned cap "
          f"{aspace._ivf_cap_plan}, cap {ivf.cap} {card}")
    err, k_ms, p_ms, bound = _k6_against_plain(torch, ivf, aspace, queries[0],
                                               topk, "phase 9", card)
    out["k6"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, **bound)
    results["ivf_scan"]["max_abs_err"] = max(results["ivf_scan"][
        "max_abs_err"], err)
    ok = True
    for name, dtype in (("f32", f32), ("bf16", torch.bfloat16)):
        if dtype != f32:
            aspace.enable_ivf(slab_dtype=dtype)
            t0 = time.perf_counter()
            ivf = aspace._ensure_ivf_blocked()
            torch.cuda.synchronize()
            t_slabs = time.perf_counter() - t0
        gib = ivf.slabs.numel() * ivf.slabs.element_size() / 2 ** 30
        aspace.search_batch(queries[3], None, TAU, topk=topk,
                            mode="certified", n_probe=N_PROBE)
        torch.cuda.synchronize()
        _reset_launches()
        with _CertifiedCounts() as counts, _K6Record(torch) as k6_rec:
            t0 = time.perf_counter()
            got = [aspace.search_batch(b, None, TAU, topk=topk,
                                       mode="certified", n_probe=N_PROBE)
                   for b in queries]
            qps = 4 * Q1M / (time.perf_counter() - t0)
        run = f"phase 9 certified topk {topk}, {name} slabs"
        main = {k: (v["launches"], run) for k, v in k6_rec.summary().items()}
        exact = aspace.search_batch(queries[0][:Q1M_CHECK], None, TAU,
                                    topk=topk, mode="exact")
        bad = topk_disagreements(got[0][1][:Q1M_CHECK], got[0][0][:Q1M_CHECK],
                                 exact[1], exact[0], TOL)
        row = dict(qps=qps, slab_gib=gib, slab_build_s=t_slabs,
                   differing=len(bad), **counts.summary())
        print(f"phase 9: certified {name} slabs ({gib:.3f} GiB, built in "
              f"{t_slabs:.3f} s): {qps:.1f} QPS over 4 x {Q1M} queries, "
              f"n_probe {N_PROBE}; {counts.summary()}; queries of "
              f"{Q1M_CHECK} differing from exact beyond near-ties "
              f"{len(bad)} {card}")
        ok &= not bad and all(i.shape == (Q1M, topk) and i.min() >= 0
                              and np.all(np.isfinite(v)) for i, v in got)
        if name == "f32":
            stream = aspace.serving_stream(None, TAU, topk=topk,
                                           n_probe=N_PROBE, depth=4)
            t0 = time.perf_counter()
            for b in queries:
                stream.submit(b)
            streamed = stream.finish()
            row["stream_qps"] = 4 * Q1M / (time.perf_counter() - t0)
            changed = bool(stream.escalated_at) or stream.degraded
            same = all(
                (np.array_equal(si, gi) and np.array_equal(sv, gv))
                if not changed else
                not topk_disagreements(sv, si, gv, gi, TOL)
                for (si, sv, _r), (gi, gv) in zip(streamed, got))
            print(f"phase 9: serving_stream depth 4: "
                  f"{row['stream_qps']:.1f} QPS, base rates "
                  f"{[round(r, 6) for r in stream.base_cert_rates]}, "
                  f"escalated at {stream.escalated_at}, degraded "
                  f"{stream.degraded}; each batch equal to search_batch("
                  f"mode='certified'): {same} {card}")
            ok &= same
        else:
            # The rescored certificate's bound: K6's bf16 scan scores
            # against float32 scores of the same items.
            qs = queries[0][:256]
            kid, kscore = tis.blocked_ivf_search_fused(
                ivf, qs, aspace._lap_f, aspace._w_f, aspace._tau_star, TAU,
                topk, n_probe=N_PROBE, tau_mix=TAU_MIX)
            lamq = search_ops.query_lambdas(
                qs, aspace._lap_f, aspace._w_f, aspace._tau_star,
                rayleigh_normalized=False, tau_mix=TAU_MIX).to(f32)
            safe = torch.clamp_min(kid, 0).long()
            true = TAU * torch.einsum("qkf,qf->qk", xu[safe],
                                      unit_normalize(qs))
            true = true + (1.0 - TAU) / (1.0 + torch.abs(lams[safe]
                                                         - lamq[:, None]))
            dev_max = float(torch.where(kid >= 0, (kscore - true).abs(),
                                        0.0).max())
            res_max = float(tis._res_eps_vector(ivf).max())
            bound = TAU * (res_max + 2.0 * F1M * 2.0 ** -24) + 1e-5
            row.update(scan_dev=dev_max, scan_bound=bound)
            print(f"phase 9: bf16 scan error: max |bf16 scan - f32| "
                  f"{dev_max:.3e} vs bound {bound:.3e} (res_eps max "
                  f"{res_max:.3e}) -> {'HOLDS' if dev_max <= bound else 'VIOLATED'}")
            ok &= dev_max <= bound
            ok &= _certified_topk65(torch, aspace, queries, row, card)
            run = f"phase 9 certified topk {K6_TOPK_CERT}, bf16 slabs"
            main.update({int(k): (v["launches"], run) for k, v in
                         row["certified_topk65"]["by_pool"].items()})
        pools = ((K6_POOL_BF16,) if name == "bf16" else ()) + K6_WIDE_POOLS
        row["k6_pools"] = _k6_pools(torch, ivf, aspace, queries[0], pools,
                                    f"phase 9 ({name} slabs)", card, main)
        results["ivf_scan"]["wide"].update(
            {f"1m_{name}_{key}": v for key, v in row["k6_pools"].items()})
        out[name] = row
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    results["certified_1m"] = out
    print(f"phase 9: peak device memory {out['peak_gib']:.3f} GiB {card}")
    del aspace, ivf, queries, xu
    if not ok:
        raise AssertionError("1M certified serving checks failed")


def _certified_topk65(torch, aspace, queries, row, card) -> bool:
    """Phase 9's certified serving at topk 65 over the bf16 slabs (K6's
    rescored pool of 260, widening rounds at 520 and 1,040): QPS over the
    4 batches after a warm-up, K6's share of the batches' time, its calls,
    routed queries, launches and wide launches by pool (the counts reset
    just before the batches), the widened and escalated queries; the
    wide route must have launched; the first batch equal to exact outside
    near-ties on Q1M_CHECK queries.  Adds the numbers to row; returns
    whether the checks hold."""
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    kw = dict(topk=K6_TOPK_CERT, mode="certified", n_probe=N_PROBE)
    aspace.search_batch(queries[3], None, TAU, **kw)
    torch.cuda.synchronize()
    _reset_launches()
    with _CertifiedCounts() as counts, _K6Record(torch) as k6_rec:
        t0 = time.perf_counter()
        got = [aspace.search_batch(b, None, TAU, **kw) for b in queries]
        secs = time.perf_counter() - t0
    launches = _launches()
    by_k = k6_rec.summary()
    k6_ms = sum(v["ms"] for v in by_k.values())
    exact = aspace.search_batch(queries[0][:Q1M_CHECK], None, TAU,
                                topk=K6_TOPK_CERT, mode="exact")
    bad = topk_disagreements(got[0][1][:Q1M_CHECK], got[0][0][:Q1M_CHECK],
                             exact[1], exact[0], TOL)
    row["certified_topk65"] = dict(
        qps=4 * Q1M / secs, k6_share=k6_ms / (secs * 1e3), k6_ms=k6_ms,
        launches=launches["ivf_scan"],
        wide_launches=launches["ivf_scan_wide"],
        by_pool={str(k): v for k, v in by_k.items()},
        differing=len(bad), **counts.summary())
    print(f"phase 9: certified topk {K6_TOPK_CERT} bf16 slabs: "
          f"{4 * Q1M / secs:.1f} QPS over 4 x {Q1M} queries, n_probe "
          f"{N_PROBE}; K6 {k6_ms:.3f} ms of {secs * 1e3:.3f} "
          f"({k6_ms / (secs * 1e3):.3f}); K6 launches {launches['ivf_scan']}"
          f" (wide {launches['ivf_scan_wide']}); by pool: "
          f"{row['certified_topk65']['by_pool']}; {counts.summary()}; "
          f"queries of {Q1M_CHECK} differing from exact beyond near-ties "
          f"{len(bad)} {card}")
    recorded = sum(v["wide_launches"] for v in by_k.values())
    return (not bad and launches["ivf_scan_wide"] > 0
            and recorded == launches["ivf_scan_wide"]
            and all(i.shape == (Q1M, K6_TOPK_CERT) and i.min() >= 0
                    and np.all(np.isfinite(v)) for i, v in got))


def _peak_run(torch, fn):
    """(fn's result, its seconds, the peak device memory it added over what
    was allocated before it, in bytes), synchronised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - before)


def _phase_build_1m(torch, dev, aspace, gl, card, results) -> None:
    """Phase 16: ArrowSpaceBuilder.build at 1,000,000 x 768 with the CVE
    graph params on a mixture corpus made on the card; the one-pass and the
    chunked symmetrize on its lists; the host engine on phase 3's lists;
    and a build under ARROWSPACE_PROFILE."""
    import tempfile
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph import build as build_mod
    from pyarrowspace_tpu_torch.io import native
    from pyarrowspace_tpu_torch.ops.cuda import knn
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import kernel_weights
    from pyarrowspace_tpu_torch.ops.symmetrize import (
        symmetrize_to_ell, symmetrize_to_ell_chunked, union_width_bound)
    k, eps = GP["k"], GP["eps"]
    failed = []
    record_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               TPU_1M_RECORD)
    with open(record_path) as fh:
        tpu = json.load(fh)
    x, _ = _mixture_rows(torch, dev, 1, N1M, F1M)
    _reset_launches()
    (a1m, g1m), t_build, added = _peak_run(
        torch, lambda: pt.ArrowSpaceBuilder.build(GP, x))
    peak = torch.cuda.max_memory_allocated()
    phases = pt.get_phase_timings()
    launches = _launches()
    del x
    i, d = a1m._knn_idx, a1m._knn_dist
    width = g1m.neighbor_indices.shape[1]
    lam = a1m._lambdas
    out = dict(build_s=t_build, phases=phases, peak_gib=peak / 2 ** 30,
               added_gib=added / 2 ** 30, ell_width=width,
               nedges=g1m.nedges, n_dropped=g1m.n_dropped_edges,
               tau_star=a1m.tau_star, lambda_mean=float(lam.mean()),
               lambda_std=float(lam.std()))
    tg = tpu["graph"]
    print(f"phase 16: build {N1M}x{F1M} (mixture, {MIX_CLUSTERS} centres) "
          f"{t_build:.3f} s, peak device memory {out['peak_gib']:.3f} GiB "
          f"(the process's, the {N1M * F1M * 4 / 2 ** 30:.3f} GiB corpus "
          f"and earlier phases' state included; {out['added_gib']:.3f} GiB "
          f"added by the build) {card}; "
          f"TPU v5e record ({TPU_1M_RECORD}, not this card's): "
          f"{tpu['value']} s")
    print(f"phase 16: build phases (s) "
          f"{json.dumps({kk: round(v, 4) for kk, v in phases.items()})} "
          f"{card}; TPU v5e record's: {json.dumps(tpu['phases_s'])}")
    print(f"phase 16: ell_width {width}, nedges {g1m.nedges}, n_dropped "
          f"{g1m.n_dropped_edges}, tau* {a1m.tau_star:.9g}, lambda mean "
          f"{out['lambda_mean']:.9g} std {out['lambda_std']:.9g}; TPU v5e "
          f"record's (another draw of the corpus, jax.random): ell_width "
          f"{tg['ell_width']}, nedges {tg['nedges']}, n_dropped "
          f"{tg['n_dropped']}, tau* {tpu['tau_star']:.9g}, lambda mean "
          f"{tpu['lambda_stats']['mean']:.9g} std "
          f"{tpu['lambda_stats']['std']:.9g}")
    print(f"phase 16: launches during the build {launches}")
    bound = union_width_bound(i)
    budget = int(os.environ.get("ARROWSPACE_ELL_BUDGET_BYTES",
                                build_mod._ELL_BUDGET_BYTES))
    width_cap = min(N1M - 1, max(2 * k, budget // (8 * N1M)))
    sym = _ell_symmetric(g1m.neighbor_indices.cpu().numpy(),
                         g1m.neighbor_weights.cpu().numpy())
    print(f"phase 16: L exactly symmetric: {sym}; union width bound "
          f"{bound}, the ELL budget's width cap {width_cap}")
    if not sym:
        failed.append("L symmetric")
    if launches["knn"] != 1:
        failed.append("K1 launched once")
    if launches["knn_sym"] != 1 and _has_sym(knn):
        failed.append("K1 on the symmetric route")
    if bool(torch.isnan(lam).any()):
        failed.append("no NaN lambda")
    if g1m.n_dropped_edges > 0 and bound <= width_cap:
        failed.append("edges dropped under the width cap")

    # K1's launch over the whole corpus again, timed: the build's bits.
    xu = a1m._data_unit
    got = {}
    k1_ms = _events_ms(lambda: got.update(di=knn.knn_scan(xu, k, eps)),
                       torch)
    same = _bits_equal(torch, got["di"][0], d) and torch.equal(
        got["di"][1], i)
    del got
    k1_bound = _bound(2.0 * _k1_pairs(N1M, N1M) * F1M, "fp32",
                      N1M * F1M * 4 + N1M * k * 8)
    results["knn"].update(full_1m_ms=k1_ms,
                          full_1m_bound_ms=k1_bound["bound_ms"],
                          full_1m_launches=launches["knn"])
    print(f"phase 16: K1 over all {N1M} rows x {F1M} k={k} "
          f"({_route(knn, N1M, N1M, k, dev)}): {k1_ms:.3f} ms, bound "
          f"{k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}); the "
          f"build's lists bit for bit: {same} {card}")
    if not same:
        failed.append("K1 at 1M deterministic")
    # The build's lists against the plain version on K1_CHECK_ROWS random
    # rows, the first 1,024 (the symmetric walk's first 8 row blocks: their
    # lists all but from their own walks) and the last 1,024, whose offsets
    # into the corpus are the largest (N * F passes 2^31 bytes), and K5's
    # distance bit for bit.
    rows = np.union1d(np.random.default_rng(0).choice(
        N1M, K1_CHECK_ROWS, replace=False),
        np.r_[np.arange(1024), np.arange(N1M - 1024, N1M)])
    rows_t = torch.as_tensor(rows, device=dev)
    dp, ip = (t.cpu().numpy() for t in knn.knn_plain(xu, k, eps,
                                                      rows=rows_t))
    d_r, i_r = d[rows_t], i[rows_t]
    bad = topk_disagreements(d_r.cpu().numpy(), i_r.cpu().numpy(), dp, ip,
                             TOL)
    err = max_abs_err(d_r.cpu().numpy(), dp)
    keep = i_r >= 0
    k5 = _own_compare().k5_distance(xu, rows_t, i_r)
    witness_k5 = bool(keep.any()) and torch.equal(
        d_r.view(torch.int32)[keep], k5.view(torch.int32)[keep])
    del dp, ip, d_r, i_r, keep, k5
    results["knn"].update(
        full_1m_max_abs_err=err,
        max_abs_err=max(results["knn"].get("max_abs_err", 0.0), err))
    print(f"phase 16: K1 vs plain on {rows.size} rows of {N1M} (the first "
          f"and the last 1,024 among them): max_abs_err {err:.3e}, "
          f"disagreeing rows "
          f"{len(bad)}; K1 == K5 distance bit for bit: {witness_k5}")
    if bad or err > TOL:
        failed.append(f"K1 at 1M vs plain (rows {bad[:10]}, err {err})")
    if not witness_k5:
        failed.append("K1 at 1M == K5 distance")

    # The one-pass and the chunked symmetrize on the build's lists, in
    # turns, each with the device memory it adds.
    w = kernel_weights(d, GP["sigma"], GP["p"])
    w = torch.where(i >= 0, w, 0.0)
    del a1m, d, xu
    ops = {"one_pass": lambda: symmetrize_to_ell(i, w, width),
           "chunked": lambda: symmetrize_to_ell_chunked(i, w, width)}
    runs = {name: [] for name in ops}
    for name in ("one_pass", "chunked", "chunked", "one_pass"):
        runs[name].append(_peak_run(torch, ops[name]))
    one, chk = runs["one_pass"][0][0], runs["chunked"][0][0]
    bitwise = (all(_bits_equal(torch, a, b) for a, b in zip(one[:3], chk[:3]))
               and one[3] == chk[3] and chk[4] == 0)
    build_same = (torch.equal(one[0], g1m.neighbor_indices)
                  and _bits_equal(torch, one[1], g1m.neighbor_weights))
    entries = N1M * k
    out_bytes = N1M * width * (4 + w.element_size())
    added = {name: max(r[2] for r in rs) for name, rs in runs.items()}
    per_entry = (added["one_pass"] - out_bytes) / entries
    fits = build_mod.one_pass_fits(N1M, k, width, w.element_size(), dev)
    free, total = torch.cuda.mem_get_info(dev)
    sym_out = {name: dict(s=sum(r[1] for r in rs) / len(rs),
                          peak_gib=added[name] / 2 ** 30)
               for name, rs in runs.items()}
    out.update(symmetrize=sym_out, bytes_per_entry=per_entry,
               one_pass_fits=fits)
    for name, r in sym_out.items():
        print(f"phase 16: symmetrize {name} at {N1M} x k {k}, width {width}:"
              f" {r['s']:.3f} s (mean of 2, in turns), peak added "
              f"{r['peak_gib']:.3f} GiB {card}")
    print(f"phase 16: one-pass == chunked bit for bit (ids, weights, "
          f"degrees, drops; no overflow): {bitwise}; == the build's graph: "
          f"{build_same}; one-pass peak beside its {out_bytes / 2 ** 30:.3f}"
          f" GiB output: {per_entry:.1f} B per directed entry (the "
          f"trigger's _ONE_PASS_BYTES_PER_ENTRY "
          f"{build_mod._ONE_PASS_BYTES_PER_ENTRY}); card free "
          f"{free / 2 ** 30:.3f} of {total / 2 ** 30:.3f} GiB now: "
          f"one_pass_fits {fits}")
    if not (bitwise and build_same):
        failed.append("one-pass == chunked at 1M")
    if per_entry > build_mod._ONE_PASS_BYTES_PER_ENTRY:
        failed.append("the trigger's bytes per entry under the measured")
    del runs, one, chk, ops, i, w, g1m

    # The host engine on phase 3's 313k lists against the one-pass op.
    i3 = aspace._knn_idx
    w3 = kernel_weights(aspace._knn_dist, GP["sigma"], GP["p"])
    w3 = torch.where(i3 >= 0, w3, 0.0)
    m3 = gl.neighbor_indices.shape[1]
    ref = symmetrize_to_ell(i3, w3, m3)
    i3h, w3h = i3.cpu().numpy(), w3.cpu().double().numpy()
    t0 = time.perf_counter()
    host = native.symmetrize_host(i3h, w3h, m3)
    t_host = time.perf_counter() - t0
    host_same = host is not None and (
        np.array_equal(host[0], ref[0].cpu().numpy())
        and np.array_equal(host[1].astype(np.float32).view(np.uint32),
                           ref[1].cpu().numpy().view(np.uint32))
        and host[2] == ref[3])
    out["host_s"] = t_host
    print(f"phase 16: symmetrize_host (native engine, {os.cpu_count()} "
          f"CPUs) on phase 3's {N}x{k} lists, width {m3}: {t_host:.3f} s; "
          f"== the one-pass op (ids, float32 weights, drops): {host_same}")
    if not host_same:
        failed.append("host == one-pass at 313k")
    del ref, w3

    # ARROWSPACE_PROFILE: a build of phase 14's 65,536-row mixture traced.
    xm = _mixture_rows(torch, dev, 3, N_MIX, F)[0]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ARROWSPACE_PROFILE"] = tmp
        try:
            t0 = time.perf_counter()
            pt.ArrowSpaceBuilder.build(GP, xm)
            t_prof = time.perf_counter() - t0
        finally:
            del os.environ["ARROWSPACE_PROFILE"]
        traces = [f for f in os.listdir(tmp) if f.endswith(".trace.json")]
        events = []
        for f in traces:
            with open(os.path.join(tmp, f)) as fh:
                events += json.load(fh)["traceEvents"]
    labels = any(e.get("name") == "arrowspace:knn" for e in events)
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "knn_kernel" in e.get("name", "")]
    out["profile"] = dict(build_s=t_prof, traces=len(traces),
                          k1_us=[e.get("dur") for e in k1_events])
    print(f"phase 16: build {N_MIX}x{F} under ARROWSPACE_PROFILE: "
          f"{t_prof:.3f} s, {len(traces)} trace(s), arrowspace:knn "
          f"{labels}, K1 kernel events {len(k1_events)} (device us "
          f"{out['profile']['k1_us']}) {card}")
    if len(traces) != 1 or not labels or not k1_events:
        failed.append("profile trace")
    results["build_1m"] = out
    if failed:
        raise AssertionError(f"1M build checks failed: {failed}")


def _query_lambdas32(torch, aspace, qb):
    """float32 query lambdas of a batch, as the serving paths make them."""
    from pyarrowspace_tpu_torch.ops import search as search_ops
    f32 = torch.float32
    return search_ops.query_lambdas(
        qb.to(f32), aspace._lap_f.to(f32), aspace._w_f.to(f32),
        aspace._tau_star.to(f32),
        rayleigh_normalized=aspace._rayleigh_normalized,
        tau_mix=aspace._tau_mix).to(f32).contiguous()


def _k7_wide(torch, scan_int8, args, chk, label, card) -> dict:
    """K7 with a wide pool: its launches in one call on ``args``, its ids
    and scores bit for bit the plain version's on ``chk`` (the same pool,
    the first queries), and the two timed in turns on ``chk``; at 1M the
    kernel also on all of ``args``."""
    before = scan_int8.WIDE_LAUNCHES
    i, sc = scan_int8.scan_int8(*args)
    launches = scan_int8.WIDE_LAUNCHES - before
    q, q_chk = args[3].shape[0], chk[3].shape[0]
    ip, sp = scan_int8.scan_int8_plain(*chk)
    same = (_bits_equal(torch, i[:q_chk], ip)
            and _bits_equal(torch, sc[:q_chk], sp))
    ms, plain_ms = _in_turns(lambda: scan_int8.scan_int8_plain(*chk),
                             lambda: scan_int8.scan_int8(*chk), torch)
    xq, m = args[0], args[-1]
    n, f = xq.shape
    out = dict(k=m, queries=q, plain_queries=q_chk, ms=ms, plain_ms=plain_ms,
               library_ms=None, launches=launches, bitwise=same,
               max_abs_err=float((sc[:q_chk].double() - sp.double()).abs()
                                 .max()),
               kernel_route=scan_int8.route_name(xq, args[3]),
               lists=scan_int8.lists_name(xq, args[3], m),
               **_bound(2.0 * q_chk * n * f, "int8",
                        n * (f + 8) + q_chk * (f + 8 + m * 8)))
    if q != q_chk:
        out["full_ms"] = _events_ms(lambda: scan_int8.scan_int8(*args),
                                    torch)
        out["full_bound_ms"] = _bound(
            2.0 * q * n * f, "int8",
            n * (f + 8) + q * (f + 8 + m * 8))["bound_ms"]
    print(f"{label} ({out['kernel_route']}, {out['lists']}, {launches} wide "
          f"launch) Q={q_chk} N={n} F={f}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms in turns, bound {out['bound_ms']:.3f} ms; "
          + (f"Q={q}: {out['full_ms']:.3f} ms, bound "
             f"{out['full_bound_ms']:.3f} ms; " if q != q_chk else "")
          + f"bit for bit the plain version: {same} {card}")
    return out


def _phase_int8(torch, aspace, gl, batches, outs_exact, card,
                results) -> None:
    """Phase 10: search_batch(mode="int8") on the phase-3 index over phase
    3's batches; K7 against its plain version on the first batch (ids
    identical, scores bit for bit); the served ids against phase 3's exact
    ids on every query whose exact top-15 lies in K7's pool."""
    from pyarrowspace_tpu_torch.ops.cuda import scan_int8
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.ops.quantize import quantize_rows
    topk = GP["topk"]
    m = min(4 * topk, N)
    t0 = time.perf_counter()
    aspace.search_batch(batches[-1], gl, TAU, mode="int8")      # warm-up
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    _reset_launches()
    t0 = time.perf_counter()
    got = [aspace.search_batch(b, gl, TAU, mode="int8") for b in batches]
    qps = Q_BATCH * N_BATCHES / (time.perf_counter() - t0)
    launches = _launches()
    results["launches_int8"] = launches
    xq, scales = aspace._quantized
    lam = aspace._lambdas
    qb = batches[0]
    lamq = _query_lambdas32(torch, aspace, qb)
    qq, qs = quantize_rows(unit_normalize(qb))
    args = (xq, scales, lam, qq, qs, lamq, TAU, m)
    i_k, s_k = scan_int8.scan_int8(*args)
    i_p, s_p = scan_int8.scan_int8_plain(*args)
    same_ids = torch.equal(i_k, i_p)
    err = float((s_k.double() - s_p.double()).abs().max())
    same_bits = _bits_equal(torch, s_k, s_p)
    k_ms, p_ms = _in_turns(lambda: scan_int8.scan_int8_plain(*args),
                           lambda: scan_int8.scan_int8(*args), torch)
    # The SIMT route (the first version's __dp4a kernel) on the same rows,
    # as a view whose row stride is not F: bit for bit the tensor cores'.
    route = scan_int8.route_name(xq, qq)
    wide = torch.zeros((N, F + 16), dtype=torch.int8, device=xq.device)
    wide[:, :F] = xq
    simt_args = (wide[:, :F],) + args[1:]
    simt_route = scan_int8.route_name(simt_args[0], qq)
    i_s, s_s = scan_int8.scan_int8(*simt_args)
    simt_same = _bits_equal(torch, i_s, i_k) and _bits_equal(torch, s_s, s_k)
    simt_ms = sum(_events_ms(lambda: scan_int8.scan_int8(*simt_args), torch)
                  for _ in range(2)) / 2
    del wide, simt_args, i_s, s_s
    bound = _bound(2.0 * Q_BATCH * N * F, "int8",
                   N * (F + 8) + Q_BATCH * (F + 8) + Q_BATCH * m * 8)
    results["scan_int8"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                library_ms=None, kernel_route=route,
                                simt_ms=simt_ms, **bound)
    # Wide pools (past the 130 entries that fit beside the ring at F 384),
    # each bit for bit and in turns with its plain version.
    for pool in K7_WIDE_POOLS:
        args_w = args[:-1] + (pool,)
        results.setdefault("wide_int8", {})[f"pool{pool}"] = dict(
            _k7_wide(torch, scan_int8, args_w, args_w,
                     f"phase 10: K7 pool {pool}", card), narrow_ms=k_ms)
    bad_pools = [key for key, v in results["wide_int8"].items()
                 if not (v["bitwise"] and v["launches"] == 1)]
    # Served == exact wherever the exact top-15 is in the K7 pool.
    covered = bad = 0
    for b, o, e in zip(batches, got, outs_exact):
        pool, _ = scan_int8.lambda_search_quantized(
            xq, scales, lam, unit_normalize(b),
            _query_lambdas32(torch, aspace, b), TAU, m)
        pool = pool.cpu().numpy()
        inside = (e[0][:, :, None] == pool[:, None, :]).any(axis=2).all(
            axis=1)
        covered += int(inside.sum())
        bad += len(topk_disagreements(o[1][inside], o[0][inside],
                                      e[1][inside], e[0][inside], TOL))
    overlap = _overlap(np.concatenate([o[0] for o in got]),
                       np.concatenate([e[0] for e in outs_exact]))
    results["int8_313k"] = dict(qps=qps, overlap=overlap, covered=covered,
                                first_call_s=t_first)
    print(f"phase 10: search_batch int8: {qps:.1f} QPS over {N_BATCHES} x "
          f"{Q_BATCH} queries (exact {results['exact_qps']:.1f}); first "
          f"call with quantization {t_first:.3f} s; launches {launches} "
          f"{card}")
    print(f"phase 10: K7 Q={Q_BATCH} N={N} F={F} k={m} ({route} route): "
          f"ids identical {same_ids}, scores max |diff| {err:.3e}, bit for "
          f"bit {same_bits}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}); the "
          f"{simt_route} route on the same rows {simt_ms:.3f} ms, bit for "
          f"bit the {route} route's: {simt_same} {card}")
    print(f"phase 10: top-{topk} overlap with exact {overlap:.6f}; exact "
          f"top-{topk} inside the pool of {m} for {covered} of "
          f"{N_BATCHES * Q_BATCH} queries, of which served != exact beyond "
          f"near-ties: {bad}")
    checks = {
        "K7 launched on the int8 path": launches["scan_int8"] > 0,
        "K7 on its tensor-core route there": (
            route == "tensor-core"
            and launches["scan_int8_tc"] == launches["scan_int8"]),
        "K7 ids == plain": same_ids,
        "K7 scores == plain": err == 0.0 and same_bits,
        "K7's SIMT route == its tensor-core route":
            simt_same and simt_route == "simt",
        "K7's wide pools == plain, one wide launch each": not bad_pools,
        "served == exact where the pool holds it": bad == 0,
        "result shapes": all(o[0].shape == (Q_BATCH, topk)
                             and np.all(np.isfinite(o[1])) for o in got)}
    if not all(checks.values()):
        raise AssertionError(f"int8 checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_bf16_view(torch, aspace, gl, batches, outs_exact, card,
                     results) -> None:
    """Phase 11: exact search over the bfloat16 serving view (as_serving):
    K2 over bf16 rows (on its tensor-core route where the package has one:
    every launch of the 8 batches) against its plain version and, bit for
    bit, K5's blended cosine on the route K2 took; QPS and the overlap with
    phase 3's float32 exact results."""
    from pyarrowspace_tpu_torch.ops.cuda import scan_topk
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    topk = GP["topk"]
    view = aspace.as_serving()
    view.search_batch(batches[-1], gl, TAU)                     # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    got = [view.search_batch(b, gl, TAU) for b in batches]
    qps = Q_BATCH * N_BATCHES / (time.perf_counter() - t0)
    launches = _launches()
    results["launches_bf16"] = launches
    overlap = _overlap(np.concatenate([o[0] for o in got]),
                       np.concatenate([e[0] for e in outs_exact]))
    xb, lam = view._data_unit, view._lambdas
    qb = batches[0]
    lamq = _query_lambdas32(torch, aspace, qb)
    qn = unit_normalize(qb).contiguous()
    i_k, s_k = scan_topk.lambda_search(xb, lam, qn, lamq, TAU, topk)
    route = _last_route(scan_topk) or _k2_route(scan_topk, xb, qn, topk,
                                                 xb.device)
    witness = _bits_equal(torch, s_k, _own_compare().k5_blend(
        xb, lam, qn, lamq, TAU, i_k, tensor_core=route.startswith("tc/")))
    i_p, s_p = scan_topk.scan_plain(xb, lam, qn, lamq, TAU, topk)
    s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
    bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
    err = max_abs_err(s_k, s_p)
    k_ms, p_ms = _in_turns(
        lambda: scan_topk.scan_plain(xb, lam, qn, lamq, TAU, topk),
        lambda: scan_topk.lambda_search(xb, lam, qn, lamq, TAU, topk), torch)
    mm_ms, mm_out = _product_bf16_ms(torch, qn.to(xb.dtype), xb)
    bound = _bound(2.0 * Q_BATCH * N * F, "bf16",
                   N * (2 * F + 4) + Q_BATCH * ((F + 1) * 4 + topk * 8))
    results["scan_topk_bf16"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                     library_ms=None, kernel_route=route,
                                     product_ms=mm_ms, **bound)
    results["bf16_313k"] = dict(qps=qps, overlap=overlap)
    print(f"phase 11: as_serving bf16 exact: {qps:.1f} QPS over {N_BATCHES} "
          f"x {Q_BATCH} queries (float32 exact {results['exact_qps']:.1f}); "
          f"top-{topk} overlap with float32 exact {overlap:.6f}; launches "
          f"{launches} {card}")
    print(f"phase 11: K2 over bf16 rows (route {route}) vs plain: "
          f"max_abs_err {err:.3e}, disagreeing queries {len(bad)}; kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), K2 / bound "
          f"{k_ms / bound['bound_ms']:.3f}; yardstick torch.mm "
          f"[{Q_BATCH},{F}]x[{F},{N}] bf16, {mm_out} output (not called "
          f"by the port) {mm_ms:.3f} ms {card}")
    print(f"phase 11: K2 over bf16 rows == K5 + blend bit for bit on "
          f"{Q_BATCH} queries x {topk}, K5 on the route K2 took "
          f"({route}): {witness}")
    checks = {"K2 launched on the bf16 path": launches["scan_topk"] > 0,
              "K2 bf16 == plain": not bad and err <= TOL,
              "K2 bf16 == K5 + blend bitwise": witness,
              f"overlap >= {MIN_BF16_OVERLAP}": overlap >= MIN_BF16_OVERLAP,
              "result shapes": all(o[0].shape == (Q_BATCH, topk)
                                   and np.all(np.isfinite(o[1]))
                                   for o in got)}
    if hasattr(scan_topk, "TC_LAUNCHES"):
        checks["every bf16 launch on the tensor-core route"] = (
            launches["scan_topk_tc"] == launches["scan_topk"] == N_BATCHES
            and route.startswith("tc/"))
    del view
    if not all(checks.values()):
        raise AssertionError(f"bf16 view checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_other_modes(torch, aspace, gl, items, batches, src, outs_exact,
                       card, results) -> None:
    """Phase 12: hybrid batches and gather IVF (n_probe 8) on the phase-3
    index, then build_energy on the same rows (optical_tokens 40, the CVE
    graph params) and search_energy_batch."""
    import pyarrowspace_tpu_torch as pt
    topk = GP["topk"]
    use = batches[:OTHER_BATCHES]
    out = {}
    checks = {}
    for name, run in (
            ("hybrid", lambda b: aspace.search_hybrid_batch(b, gl, TAU)),
            ("ivf", lambda b: aspace.search_batch(b, gl, TAU, mode="ivf",
                                                  n_probe=N_PROBE))):
        run(batches[-1])                                        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [run(b) for b in use]
        qps = Q_BATCH * len(use) / (time.perf_counter() - t0)
        overlap = _overlap(np.concatenate([o[0] for o in got]),
                           np.concatenate([e[0] for e in outs_exact[:len(use)]]))
        top1 = all(np.array_equal(o[0][:, 0], s_) for o, s_ in zip(got, src))
        out[name] = dict(qps=qps, overlap=overlap)
        if name == "hybrid":
            checks["hybrid: source row first"] = top1
        print(f"phase 12: {name}: {qps:.1f} QPS over {len(use)} x {Q_BATCH} "
              f"queries; top-{topk} overlap with exact {overlap:.6f}; each "
              f"source row first: {top1} {card}")
        checks[f"{name}: result shapes"] = all(
            o[0].shape == (Q_BATCH, topk) and np.all(np.isfinite(o[1]))
            for o in got)
    t0 = time.perf_counter()
    ea, eg = pt.ArrowSpaceBuilder.build_energy(
        items, {"optical_tokens": ENERGY_TOKENS}, GP)
    t_energy = time.perf_counter() - t0
    phases = pt.get_phase_timings()
    qe = batches[0][:ENERGY_QUERIES]
    ea.search_energy_batch(qe, eg, topk)                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ei, ev = ea.search_energy_batch(qe, eg, topk)
    t_search = time.perf_counter() - t0
    routed = ea._search_energy_routed(qe, *ea._energy_query(qe), 1.0, 0.5,
                                      topk)
    routed_full = bool((routed[0] >= 0).all())
    out["energy"] = dict(build_s=t_energy, phases=phases,
                         nodes=int(ea._energy_maps.nodes.shape[0]),
                         search_s=t_search, routed=routed_full)
    results["other_modes"] = out
    print(f"phase 12: build_energy {N}x{F} (optical_tokens {ENERGY_TOKENS}) "
          f"in {t_energy:.3f} s: {out['energy']['nodes']} energy nodes, "
          f"graph nnodes {eg.nnodes}, nedges {eg.nedges}; phases (s) "
          f"{json.dumps({kk: round(v, 4) for kk, v in phases.items()})} "
          f"{card}")
    print(f"phase 12: search_energy_batch {ENERGY_QUERIES} queries, k "
          f"{topk}: {t_search:.3f} s (routed pool full: {routed_full}) "
          f"{card}")
    checks["energy: results"] = (ei.shape == (ENERGY_QUERIES, topk)
                                 and ei.min() >= 0 and ei.max() < N
                                 and bool(np.all(np.isfinite(ev))))
    checks["energy: lambdas finite"] = bool(np.all(np.isfinite(
        ea.lambdas())))
    ea2, eg2 = pt.ArrowSpaceBuilder.build_energy(
        items, {"optical_tokens": ENERGY_TOKENS}, GP)
    energy_diff = _same(torch, [
        ("nbr_idx", eg.neighbor_indices, eg2.neighbor_indices),
        ("nbr_w", eg.neighbor_weights, eg2.neighbor_weights),
        ("nodes", ea._energy_maps.nodes, ea2._energy_maps.nodes),
        ("lambdas", ea._lambdas, ea2._lambdas)])
    print(f"phase 12: a second build_energy: {eg2.nedges} edges, differing "
          f"from the first in {energy_diff}")
    checks["energy: two builds bitwise equal"] = not energy_diff
    del ea, eg, ea2, eg2
    if not all(checks.values()):
        raise AssertionError(f"other-mode checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_long_lists(torch, aspace, gl, xu, batches, card, results) -> None:
    """Phase 13: lists past the old limit of 4,096 and K6 past F 3,434:
    search_batch(topk=5000) in exact, subtile and certified modes (exact
    against K2's plain version; certified == exact; subtile's overlap), K1
    at k 5,000 and K4b / K4a at m 5,000 against their plain versions, and
    K6 at F 4,096 against its plain version."""
    from pyarrowspace_tpu_torch.ops.cuda import extract, ivf_scan, knn, \
        scan_topk
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    qb = batches[0][:Q_LONG]
    checks, secs = {}, {}
    served = {}
    for mode in ("exact", "subtile", "certified"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served[mode] = aspace.search_batch(qb, gl, TAU, topk=K_LONG,
                                           mode=mode, n_probe=N_PROBE)
        secs[mode] = time.perf_counter() - t0
        checks[f"{mode}: shapes"] = (
            served[mode][0].shape == (Q_LONG, K_LONG)
            and np.all(np.isfinite(served[mode][1])))
    lamq = _query_lambdas32(torch, aspace, qb)
    i_p, s_p = scan_topk.scan_plain(aspace._data_unit, aspace._lambdas,
                                    unit_normalize(qb), lamq, TAU, K_LONG)
    bad_exact = topk_disagreements(served["exact"][1], served["exact"][0],
                                   s_p.cpu().numpy(), i_p.cpu().numpy(), TOL)
    bad_cert = topk_disagreements(served["certified"][1],
                                  served["certified"][0],
                                  served["exact"][1], served["exact"][0], TOL)
    overlap = _overlap(served["subtile"][0], served["exact"][0])
    checks["exact k 5000 == plain K2"] = not bad_exact
    checks["certified k 5000 == exact"] = not bad_cert
    checks[f"subtile k 5000 overlap >= {MIN_OVERLAP}"] = overlap >= MIN_OVERLAP
    print(f"phase 13: search_batch topk={K_LONG} on {Q_LONG} queries: exact "
          f"{secs['exact']:.3f} s (vs plain K2: disagreeing {len(bad_exact)})"
          f", subtile {secs['subtile']:.3f} s (overlap {overlap:.6f}), "
          f"certified {secs['certified']:.3f} s (vs exact: disagreeing "
          f"{len(bad_cert)}) {card}")
    t0 = time.perf_counter()
    d, i = knn.knn_scan(xu, K_LONG, GP["eps"], 0, K1_LONG_ROWS)
    torch.cuda.synchronize()
    t_k1 = time.perf_counter() - t0
    dp, ip = knn.knn_plain(xu, K_LONG, GP["eps"],
                           rows=slice(0, K1_LONG_ROWS))
    bad_k1 = topk_disagreements(d.cpu().numpy(), i.cpu().numpy(),
                                dp.cpu().numpy(), ip.cpu().numpy(), TOL)
    checks["K1 k 5000 == plain"] = not bad_k1
    gen = torch.Generator(device=xu.device)
    gen.manual_seed(5)
    score = torch.randint(0, 64, (Q_LONG, 16_384), generator=gen,
                          device=xu.device).float() / 8.0
    cand = torch.argsort(torch.rand(score.shape, generator=gen,
                                    device=xu.device), dim=1).to(torch.int32)
    ids_same = torch.equal(extract.extract_ids(score, K_LONG),
                           extract.extract_ids_plain(score, K_LONG))
    pool_same = torch.equal(extract.extract_pool(score, cand, K_LONG),
                            extract.extract_pool_plain(score, cand, K_LONG))
    checks["K4b / K4a m 5000 == plain"] = ids_same and pool_same
    print(f"phase 13: K1 k={K_LONG} on {K1_LONG_ROWS} rows of {N}: "
          f"{t_k1:.3f} s, disagreeing rows {len(bad_k1)}; K4b / K4a at "
          f"m={K_LONG} over {tuple(score.shape)} "
          f"({_select_route(extract, score, K_LONG)} route): ids identical "
          f"{ids_same} / {pool_same} {card}")
    # K6 at F 4,096: the query block no longer fits beside the tiles.
    n_clusters, cap, qblk, n_probe, n_blocks = 16, 256, 16, 4, 8
    slabs = unit_normalize(torch.randn((n_clusters * cap, F_WIDE),
                                       generator=gen, device=xu.device))
    slab_lam = torch.rand(n_clusters * cap, generator=gen, device=xu.device)
    slab_ids = torch.randperm(n_clusters * cap, generator=gen,
                              device=xu.device).to(torch.int32)
    qn = unit_normalize(torch.randn((n_blocks * qblk, F_WIDE), generator=gen,
                                    device=xu.device))
    lq = torch.rand(n_blocks * qblk, generator=gen, device=xu.device)
    probe = torch.stack([torch.randperm(n_clusters, generator=gen,
                                        device=xu.device)[:n_probe]
                         for _ in range(n_blocks)]).to(torch.int32)
    args = (slabs, slab_lam, slab_ids, qn, lq, probe, TAU)
    kw = dict(k=GP["topk"], q_block=qblk, cap=cap)
    s_k, i_k = ivf_scan.ivf_scan(*args, **kw,
                                 tiles=ivf_scan.slab_tiles(slab_ids, cap))
    s_p, i_p = ivf_scan.ivf_scan_plain(*args, **kw)
    s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
    err6 = max_abs_err(s_k, s_p)
    bad6 = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
    checks["K6 F 4096 == plain"] = not bad6 and err6 <= TOL
    print(f"phase 13: K6 at F={F_WIDE} ({n_blocks} blocks of {qblk} "
          f"queries x {n_probe} probes x cap {cap}): max_abs_err {err6:.3e}, "
          f"disagreeing queries {len(bad6)} {card}")
    results["long_lists"] = dict(seconds=secs, subtile_overlap=overlap,
                                 k1_s=t_k1, k6_f4096_err=err6)
    if not all(checks.values()):
        raise AssertionError(f"long-list checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _variant_scans(torch, x):
    """The k-NN variants' kernels on the unit corpus x, each with its plain
    version: name -> (kernel, plain, rows_of), where kernel(R) and plain(R)
    scan rows [0, R) and rows_of(R) names the result rows that hold them.
    The reorder variant scans rows of the projection-sorted corpus and
    returns [N, k] lists by original row.  Also the seconds of reorder's
    projection, sort and gather."""
    from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t
    from pyarrowspace_tpu_torch.ops.distance import projection_order
    k, eps = GP["k"], GP["eps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = projection_order(x)
    xp = x[perm].contiguous()
    torch.cuda.synchronize()
    t_perm = time.perf_counter() - t0

    def head(rows):
        return torch.arange(rows, device=x.device)

    def plain(rows):
        return knn.knn_plain(x, k, eps, slice(0, rows))

    return t_perm, {
        "knn_t": (lambda r: knn_t.knn_scan_t(x, k, eps, 0, r), plain, head),
        "knn_diagstart": (lambda r: knn.knn_scan(x, k, eps, 0, r,
                                                 diag_start=True),
                          plain, head),
        "knn_reorder": (lambda r: knn.knn_scan(xp, k, eps, 0, r,
                                               diag_start=True, perm=perm),
                        lambda r: knn.knn_plain(xp, k, eps, slice(0, r),
                                                perm=perm),
                        lambda r: perm[:r]),
    }


def _same(torch, pairs) -> list[str]:
    """The names of the (name, a, b) tensor pairs that differ."""
    return [name for name, a, b in pairs if not torch.equal(a, b)]


def _phase_variants(torch, items, xu, aspace, gl, card, results) -> None:
    """Phase 14: the k-NN variants.  Each kernel against its plain version
    on 2,048 rows and bit for bit against phase 3's K1 lists on the 16,384
    timed rows, timed in turns with its plain version; the same kernels
    against K1 in turns on a 65,536 x 384 mixture corpus; the 313,841 x
    384 build under each variant, bitwise phase 3's."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    k, eps = GP["k"], GP["eps"]
    ref_d, ref_i = aspace._knn_dist, aspace._knn_idx
    failed = []
    t_perm, scans = _variant_scans(torch, xu)
    print(f"phase 14: reorder's projection, sort and gather at {N}x{F}: "
          f"{t_perm * 1e3:.3f} ms {card}")
    for name, (kernel, plain, rows_of) in scans.items():
        rows = rows_of(K1_CHECK_ROWS)
        d, i = (t[rows].cpu().numpy() for t in kernel(K1_CHECK_ROWS))
        dp, ip = (t[rows].cpu().numpy() for t in plain(K1_CHECK_ROWS))
        bad = topk_disagreements(d, i, dp, ip, TOL)
        err = max_abs_err(d, dp)
        rows = rows_of(K1_TIME_ROWS)
        d, i = kernel(K1_TIME_ROWS)
        diff = _same(torch, [("d", d[rows], ref_d[rows]),
                             ("i", i[rows], ref_i[rows])])
        del d, i
        k_ms, p_ms = _in_turns(lambda: plain(K1_TIME_ROWS),
                               lambda: kernel(K1_TIME_ROWS), torch)
        v_ms, k1_ms = _in_turns(
            lambda: knn.knn_scan(xu, k, eps, 0, K1_TIME_ROWS),
            lambda: kernel(K1_TIME_ROWS), torch)
        route = _route(knn_t if name == "knn_t" else knn, K1_TIME_ROWS, N, k,
                       xu.device)
        results[name] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * _k1_pairs(K1_TIME_ROWS, N) * F, "fp32",
                     N * F * 4 + K1_TIME_ROWS * k * 8),
            kernel_route=route, turns_ms=v_ms, k1_ms=k1_ms)
        print(f"phase 14: {name} on {K1_CHECK_ROWS} rows vs plain: "
              f"max_abs_err {err:.3e}, disagreeing rows {len(bad)}; on "
              f"{K1_TIME_ROWS} rows: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bitwise K1: {not diff}; in turns with K1 "
              f"{v_ms:.3f} ms against {k1_ms:.3f} ms ({v_ms / k1_ms:.3f}x), "
              f"route {route} {card}")
        if bad or err > TOL or diff:
            failed.append(name)
    del scans
    # K1t's one-owner route (k 65 to 128) at k 100, in turns with K1.
    dt, it = knn_t.knn_scan_t(xu, K1_WIDE, eps, 0, K1_TIME_ROWS)
    d1, i1 = knn.knn_scan(xu, K1_WIDE, eps, 0, K1_TIME_ROWS)
    same = not _same(torch, [("d", dt, d1), ("i", it, i1)])
    del dt, it, d1, i1
    t_ms, k1_ms = _in_turns(
        lambda: knn.knn_scan(xu, K1_WIDE, eps, 0, K1_TIME_ROWS),
        lambda: knn_t.knn_scan_t(xu, K1_WIDE, eps, 0, K1_TIME_ROWS), torch)
    route = _route(knn_t, K1_TIME_ROWS, N, K1_WIDE, xu.device)
    results["knn_t"].update(k100_ms=t_ms, k1_k100_ms=k1_ms,
                            k100_route=route)
    print(f"phase 14: knn_t at k={K1_WIDE} on {K1_TIME_ROWS} rows: {t_ms:.3f}"
          f" ms against K1's {k1_ms:.3f} ms in turns ({t_ms / k1_ms:.3f}x), "
          f"route {route}, bitwise K1: {same} {card}")
    if not same:
        failed.append(f"knn_t k {K1_WIDE}")

    # A clustered corpus: the regime the locality variants were built for.
    xm = unit_normalize(_mixture_rows(torch, xu.device, 3, N_MIX, F)[0]
                        ).contiguous()
    t_perm, scans = _variant_scans(torch, xm)

    def k1():
        return knn.knn_scan(xm, k, eps)

    d1, i1 = k1()
    mixture = {"projection_ms": t_perm * 1e3}
    for name, (kernel, _plain, _rows_of) in scans.items():
        d, i = kernel(N_MIX)
        same = not _same(torch, [("d", d, d1), ("i", i, i1)])
        del d, i
        v_ms, k1_ms = _in_turns(k1, lambda: kernel(N_MIX), torch)
        mixture[name] = dict(ms=v_ms, k1_ms=k1_ms, bitwise_k1=same)
        print(f"phase 14: {name} on the {N_MIX}x{F} mixture corpus: "
              f"{v_ms:.3f} ms against K1's {k1_ms:.3f} ms in turns, "
              f"bitwise K1: {same} {card}")
        if not same:
            failed.append(f"{name} (mixture)")
    print(f"phase 14: reorder's projection, sort and gather at {N_MIX}x{F}: "
          f"{t_perm * 1e3:.3f} ms")
    results["variants_mixture"] = mixture
    del scans, xm, d1, i1

    builds = {}
    for variant, path in (("transposed", "launches_transposed"),
                          ("subtile", "launches_sub"),
                          ("diagstart", "launches_diagstart"),
                          ("reorder", "launches_reorder")):
        os.environ["ARROWSPACE_KNN_VARIANT"] = variant
        try:
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            va, vg = pt.ArrowSpaceBuilder.build(GP, items)
            t_build = time.perf_counter() - t0
        finally:
            del os.environ["ARROWSPACE_KNN_VARIANT"]
        results[path] = _launches()
        phases = pt.get_phase_timings()
        diff = _same(torch, [
            ("knn_dist", va._knn_dist, ref_d), ("knn_idx", va._knn_idx, ref_i),
            ("nbr_idx", vg.neighbor_indices, gl.neighbor_indices),
            ("nbr_w", vg.neighbor_weights, gl.neighbor_weights),
            ("lambdas", va._lambdas, aspace._lambdas)])
        builds[variant] = dict(build_s=t_build, knn_s=phases["knn"],
                               differing=diff)
        print(f"phase 14: build {N}x{F} under ARROWSPACE_KNN_VARIANT="
              f"{variant}: {t_build:.3f} s, knn phase {phases['knn']:.3f} s; "
              f"launches {results[path]}; differing from phase 3: {diff} "
              f"{card}")
        if diff:
            failed.append(f"build {variant}")
        del va, vg
    results["variant_builds"] = builds
    if failed:
        raise AssertionError(f"variant checks failed: {failed}")


def _phase_lifecycle(torch, items, aspace, gl, batches, card,
                     results) -> None:
    """Phase 15: extend phase 3's index by N_EXTEND rows against a rebuild
    of the concatenated corpus (bit for bit), seeded K1 against its plain
    version, save / load of the extended index, and the parameter
    suggestions at 313k."""
    import tempfile

    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph.suggest import (emit_build_suggestions,
                                                      suggest_graph_params)
    from pyarrowspace_tpu_torch.io import load_index, save_index
    from pyarrowspace_tpu_torch.ops.cuda import knn
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    k, eps = GP["k"], GP["eps"]
    new = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (N_EXTEND, F), dtype=np.float32) * 12.0).to(items.device)
    pt.ArrowSpaceBuilder.extend(aspace, gl, new)              # warm-up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ea, eg = pt.ArrowSpaceBuilder.extend(aspace, gl, new)
    t_extend = time.perf_counter() - t0
    results["launches_extend"] = _launches()
    ext_phases = pt.get_phase_timings()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra, rg = pt.ArrowSpaceBuilder.build(GP, torch.cat([items, new]))
    t_rebuild = time.perf_counter() - t0
    rb_phases = pt.get_phase_timings()
    rb_launches = _launches()
    # The extend's K1 launches walk their rows in full, the rebuild's one
    # launch symmetrically: equal lists witness the symmetric walk.
    walks = {"extend_sym": results["launches_extend"]["knn_sym"],
             "rebuild_k1": rb_launches["knn"],
             "rebuild_sym": rb_launches["knn_sym"]}
    walks_ok = walks["extend_sym"] == 0 and walks["rebuild_k1"] == 1 and (
        walks["rebuild_sym"] == 1 or not _has_sym(knn))
    diff = _same(torch, [
        ("knn_dist", ea._knn_dist, ra._knn_dist),
        ("knn_idx", ea._knn_idx, ra._knn_idx),
        ("nbr_idx", eg.neighbor_indices, rg.neighbor_indices),
        ("nbr_w", eg.neighbor_weights, rg.neighbor_weights),
        ("lambdas", ea._lambdas, ra._lambdas),
        ("tau_star", ea._tau_star, ra._tau_star)])
    print(f"phase 15: extend {N}x{F} by {N_EXTEND} rows: {t_extend:.3f} s "
          f"(knn_extend {ext_phases['knn_extend']:.3f} s); rebuild of "
          f"{N + N_EXTEND} rows {t_rebuild:.3f} s (knn "
          f"{rb_phases['knn']:.3f} s); launches {results['launches_extend']};"
          f" K1 by walk {walks}; differing: {diff} {card}")
    print(f"phase 15: extend phases (s) "
          f"{json.dumps({kk: round(v, 4) for kk, v in ext_phases.items()})}")
    del ra, rg

    # Seeded K1: the old rows against the new columns, from their lists.
    xu_all = ea._data_unit

    def seeded(rows):
        return knn.knn_scan(xu_all, k, eps, 0, rows, col_start=N,
                            seed=(aspace._knn_dist[:rows],
                                  aspace._knn_idx[:rows]))

    def seeded_plain(rows):
        return knn.knn_plain(xu_all, k, eps, slice(0, rows), N,
                             (aspace._knn_dist[:rows],
                              aspace._knn_idx[:rows]))

    d, i = (t.cpu().numpy() for t in seeded(K1_CHECK_ROWS))
    dp, ip = (t.cpu().numpy() for t in seeded_plain(K1_CHECK_ROWS))
    bad = topk_disagreements(d, i, dp, ip, TOL)
    err = max_abs_err(d, dp)
    k_ms, p_ms = _in_turns(lambda: seeded_plain(K1_TIME_ROWS),
                           lambda: seeded(K1_TIME_ROWS), torch)
    results["knn_seeded"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
        **_bound(2.0 * K1_TIME_ROWS * N_EXTEND * F, "fp32",
                 N_EXTEND * F * 4 + K1_TIME_ROWS * (F * 4 + 2 * k * 8)),
        kernel_route=_route(knn, K1_TIME_ROWS, N_EXTEND, k, xu_all.device))
    print(f"phase 15: seeded K1 on {K1_CHECK_ROWS} old rows vs plain: "
          f"max_abs_err {err:.3e}, disagreeing rows {len(bad)}; on "
          f"{K1_TIME_ROWS} rows x {N_EXTEND} new columns: kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms {card}")

    life = dict(extend_s=t_extend, rebuild_s=t_rebuild,
                knn_extend_s=ext_phases["knn_extend"],
                rebuild_knn_s=rb_phases["knn"], differing=diff)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        served = ea.search_batch(batches[0], eg, TAU, mode="exact")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_index(path, ea, eg)
        life["save_s"] = time.perf_counter() - t0
        life["file_mb"] = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        la, lg = load_index(path)
        torch.cuda.synchronize()
        life["load_s"] = time.perf_counter() - t0
        again = la.search_batch(batches[0], lg, TAU, mode="exact")
        life["served_same"] = (np.array_equal(served[0], again[0])
                               and np.array_equal(served[1], again[1])
                               and la.device.type == "cuda")
        print(f"phase 15: save_index {life['file_mb']:.1f} MB in "
              f"{life['save_s']:.3f} s, load_index in {life['load_s']:.3f} s;"
              f" exact search on the loaded index bitwise the saved one's: "
              f"{life['served_same']} {card}")
        del la, lg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = suggest_graph_params(items)
        life["suggest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        emit_build_suggestions(items, aspace._params, tmp)
        life["emit_s"] = time.perf_counter() - t0
    print(f"phase 15: suggest_graph_params at {N}x{F}: {life['suggest_s']:.3f}"
          f" s -> eps {rec['eps']}, sigma {rec['sigma']}, k {rec['k']}, "
          f"intrinsic dim {rec['intrinsic_dim']}; emit_build_suggestions "
          f"{life['emit_s']:.3f} s {card}")
    results["lifecycle"] = life
    del ea, eg
    if diff or bad or err > TOL or not life["served_same"] or not walks_ok:
        raise AssertionError(f"lifecycle checks failed: differing {diff}, "
                             f"K1 by walk {walks}, "
                             f"seeded rows {bad[:10]} err {err}, served "
                             f"same {life['served_same']}")


# -- phases 17-18: the sharded path and the trainers -----------------------------
SHARDED_RUNS = (("nccl", 1), ("gloo", 2))   # (backend, world size), one card
SHARDED_TIMEOUT_S = 420
LAMBDA_REL_BOUND = 1e-5   # world 2: the Lloyd sums in rank order move the
#                           centroids by ulps; world 1 must be bit for bit
TSDAE_SENTENCES, TSDAE_WORDS = 8192, 400


def _sharded_rank(rank: int, world: int, backend: str, init_file: str,
                  out_dir: str, src0, per_card: bool) -> None:
    """One rank of phase 17 (spawned): the sharded build of phase 3's
    corpus, search_batch over phase 3's first batch in exact, subtile and
    certified mode (each warm, then timed), the kernels' launches on that
    path, and on rank 0 of world 2 the ring's K1 step (a padded visiting
    block at a nonzero col_start) and K2, K3 and K6 on the shard against
    their plain versions.  Writes rank{r}.npz (the rank's lists) and
    rank{r}.json.  per_card: rank r on cuda:r (--cards), else all on
    cuda:0."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", rank if per_card else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        _sharded_rank_body(torch, dev, rank, world, backend, out_dir, src0)
    finally:
        dist.destroy_process_group()


def _sharded_rank_body(torch, dev, rank, world, backend, out_dir,
                       src0) -> None:
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.parallel import build_sharded, make_mesh
    from pyarrowspace_tpu_torch.parallel import sharded as sh
    assert "jax" not in sys.modules, "the port must not import jax"
    mesh = make_mesh(device=dev, backend=backend)
    gp = pt.parse_graph_params(GP)
    items_host = np.random.default_rng(42).standard_normal(
        (N, F), dtype=np.float32) * 12.0
    queries = torch.from_numpy(items_host[src0]).to(dev) * 1.01
    build_sharded(items_host, gp, mesh)                 # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    sspace, gl = build_sharded(items_host, gp, mesh)
    build_s = time.perf_counter() - t0
    stages = pt.get_phase_timings()
    t0 = time.perf_counter()
    sspace._ensure_ivf_block_state()
    sspace._ensure_subtile_state()
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    got, qps = {}, {}
    for mode in ("exact", "subtile", "certified"):
        sspace.search_batch(queries, TAU, mode=mode, n_probe=N_PROBE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[mode] = sspace.search_batch(queries, TAU, mode=mode,
                                        n_probe=N_PROBE)
        qps[mode] = Q_BATCH / (time.perf_counter() - t0)
    launches = _launches()
    info = dict(rank=rank, world=world, backend=backend, build_s=build_s,
                stages=stages, state_s=state_s, qps=qps, launches=launches,
                host_copied=sorted(sspace.comm.host_copied),
                fallbacks=sh.SYMMETRIZE_FALLBACKS, n_loc=sspace._n_loc,
                rows=sspace._rows, tau_star=sspace.tau_star)
    lam = sspace.lambdas()
    arrays = dict(knn_d=sspace.knn[0].cpu().numpy(),
                  knn_i=sspace.knn[1].cpu().numpy())
    if rank == 0:
        arrays.update(lambdas=lam,
                      nbr_idx=gl.neighbor_indices.cpu().numpy(),
                      nbr_w=gl.neighbor_weights.cpu().numpy(),
                      **{f"{m}_{part}": np.asarray(got[m][j])
                         for m in got for j, part in enumerate(("i", "v"))})
    if world > 1 and rank == 0:
        info["kernels"] = _shard_kernels(torch, sspace, items_host, queries,
                                         dev)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)


def _shard_kernels(torch, sspace, items_host, queries, dev) -> dict:
    """K1's ring step, K2, K3 and K6 at rank 0's shapes of world 2, each
    against its plain version (max_abs_err, ids up to near-ties of TOL)
    and timed in turns.  Launches made here are not the path's."""
    from pyarrowspace_tpu_torch.ops.cuda import knn, scan_topk, subtile_max
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    out = {}
    k, eps = GP["k"], GP["eps"]
    n_loc, rows = sspace._n_loc, sspace._rows
    # K1: rank 0's ring step over rank 1's block (ids from n_loc, its
    # padding rows masked by n_real), seeded with the self step's lists.
    nxt = unit_normalize(torch.from_numpy(items_host[n_loc:2 * n_loc]).to(
        dev))
    cols = nxt.shape[0]
    buf = torch.cat([sspace._xu_loc, sspace._xu_loc])
    buf[n_loc:n_loc + cols] = nxt
    buf[n_loc + cols:] = 0.0
    r = K1_TIME_ROWS
    seed = knn.knn_visit(sspace._xu_loc, n_loc, r, rows, k, eps, row_id0=0,
                         col_id0=0)

    def kern():
        return knn.knn_visit(buf, n_loc, r, cols, k, eps, row_id0=0,
                             col_id0=n_loc, seed=seed)

    def plain():
        return knn.visit_plain(buf, n_loc, r, cols, k, eps, row_id0=0,
                               col_id0=n_loc, seed=seed)

    (dk, ik), (dp, ip) = kern(), plain()
    bad = topk_disagreements(dk.cpu().numpy(), ik.cpu().numpy(),
                             dp.cpu().numpy(), ip.cpu().numpy(), TOL)
    k_ms, p_ms = _in_turns(plain, kern, torch)
    out["knn"] = dict(rows=r, cols=cols, col_start=n_loc + n_loc,
                      padded_cols=n_loc - cols,
                      max_abs_err=max_abs_err(dk.cpu().numpy(),
                                              dp.cpu().numpy()),
                      disagreeing=len(bad), ms=k_ms, plain_ms=p_ms,
                      route=_route(knn, r, cols, k, dev),
                      **_bound(2.0 * r * cols * F, "fp32",
                               (r + cols) * F * 4 + 2 * r * k * 8))
    # The same step on 2,048 rows (a split walk) and at k 200 (the wide
    # route, its splits merged into the seed lists) against the plain
    # version.
    for kk in (k, K1_DEVICE_LIST):
        rr = K1_CHECK_ROWS
        sd = knn.knn_visit(sspace._xu_loc, n_loc, rr, rows, kk, eps,
                           row_id0=0, col_id0=0)
        got = [t.cpu().numpy() for t in knn.knn_visit(
            buf, n_loc, rr, cols, kk, eps, row_id0=0, col_id0=n_loc,
            seed=sd)]
        ref = [t.cpu().numpy() for t in knn.visit_plain(
            buf, n_loc, rr, cols, kk, eps, row_id0=0, col_id0=n_loc,
            seed=sd)]
        bad = topk_disagreements(got[0], got[1], ref[0], ref[1], TOL)
        err = max_abs_err(got[0], ref[0])
        out["knn"][f"k{kk}_rows{rr}"] = dict(
            route=_route(knn, rr, cols, kk, dev), disagreeing=len(bad),
            max_abs_err=err)
        out["knn"]["disagreeing"] += len(bad)
        out["knn"]["max_abs_err"] = max(out["knn"]["max_abs_err"], err)
    # K2 on the shard's real rows.
    topk = GP["topk"]
    xs, lams = sspace._xu_loc[:rows], sspace._lambdas_loc[:rows]
    qn = unit_normalize(queries).contiguous()
    lam_q = sspace.prepare_queries(queries)
    i_k, s_k = scan_topk.lambda_search(xs, lams, qn, lam_q, TAU, topk)
    i_p, s_p = scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk)
    bad = topk_disagreements(s_k.cpu().numpy(), i_k.cpu().numpy(),
                             s_p.cpu().numpy(), i_p.cpu().numpy(), TOL)
    k_ms, p_ms = _in_turns(
        lambda: scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk),
        lambda: scan_topk.lambda_search(xs, lams, qn, lam_q, TAU, topk),
        torch)
    out["scan_topk"] = dict(rows=rows, queries=Q_BATCH,
                            max_abs_err=max_abs_err(s_k.cpu().numpy(),
                                                    s_p.cpu().numpy()),
                            disagreeing=len(bad), ms=k_ms, plain_ms=p_ms,
                            **_bound(2.0 * Q_BATCH * rows * F, "fp32",
                                     rows * (F + 1) * 4
                                     + Q_BATCH * ((F + 1) * 4 + topk * 8)))
    # K3 on the shard's subtile state.
    st = sspace._ensure_subtile_state()
    lamq32 = lam_q.to(torch.float32).contiguous()
    q_scan = qn.to(torch.float32).to(st["xu_scan"].dtype).contiguous()
    args = (st["xu_scan"], st["lambdas"], q_scan, lamq32, TAU, st["n_real"])
    m_k = subtile_max.subtile_max(*args)
    m_p = subtile_max.subtile_max_plain(*args)
    k_ms, p_ms = _in_turns(lambda: subtile_max.subtile_max_plain(*args),
                           lambda: subtile_max.subtile_max(*args), torch)
    rows_k3 = -(-rows // 64) * 64     # the subtiles with a real row
    out["subtile_max"] = dict(
        rows=st["xu_scan"].shape[0], queries=Q_BATCH,
        max_abs_err=max_abs_err(m_k.cpu().numpy(), m_p.cpu().numpy()),
        ms=k_ms, plain_ms=p_ms,
        route=subtile_max.route_name(st["xu_scan"], q_scan),
        **_bound(2.0 * Q_BATCH * rows_k3 * F, "bf16",
                 rows_k3 * (F * 2 + 4) + Q_BATCH * (F * 2 + 4)
                 + m_k.numel() * 4))
    # K6 on the shard's clusters.
    ivf = sspace._ensure_ivf_block_state()
    err, k_ms, p_ms, bound = _k6_against_plain(
        torch, ivf, sspace, queries, topk,
        f"phase 17 (world {sspace.comm.size}, rank 0)",
        f"[{_smi()}]")
    out["ivf_scan"] = dict(clusters=ivf.n_clusters, cap=ivf.cap,
                           max_abs_err=err, disagreeing=0, ms=k_ms,
                           plain_ms=p_ms, **bound)
    return out


def _cards(n_cards: int) -> int:
    """--cards N: phase 3's build on cuda:0, then phase 17 at world N under
    NCCL with rank r on cuda:r, every check of phase 17 against phase 3;
    prints the cards, the phase's lines and its numbers as JSON."""
    import torch
    if torch.cuda.device_count() < n_cards:
        print(f"chip_smoke: --cards {n_cards} needs {n_cards} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch import _build
    assert "jax" not in sys.modules, "the port must not import jax"
    card = f"[{_smi()} x {n_cards}]"
    print(card)
    _build.load_all(KERNEL_SOURCES)
    dev = torch.device("cuda", 0)
    items = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (N, F), dtype=np.float32) * 12.0).to(dev)
    aspace, gl = pt.ArrowSpaceBuilder.build(GP, items)
    rng_q = np.random.default_rng(7)
    src = [rng_q.choice(N, Q_BATCH) for _ in range(N_BATCHES)]
    batches = [items[torch.as_tensor(src[0], device=dev)] * 1.01]
    outs = [aspace.search_batch(batches[0], gl, TAU)]
    results = {name: {} for name in ("knn", "scan_topk", "subtile_max",
                                     "ivf_scan")}
    try:
        _phase_sharded(torch, aspace, gl, batches, src, outs, card, results,
                       runs=(("nccl", n_cards),), per_card=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED phase 17 (--cards)", file=sys.stderr)
        return 1
    print(json.dumps({k: results[k] for k in results}))
    return 0


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _run_ranks(world: int, backend: str, src0,
               per_card: bool) -> tuple[list, list]:
    """Spawn phase 17's ranks on the card, wait for them (killing them past
    SHARDED_TIMEOUT_S), and return their (json, npz) results by rank."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="arrowspace-ranks-") as tmp:
        init = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_sharded_rank,
                             args=(r, world, backend, init, tmp, src0,
                                   per_card))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise RuntimeError(f"{backend} world {world}: rank exit codes "
                               f"{codes} ({len(hung)} killed at the time "
                               "limit)")
        infos, arrays = [], []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                infos.append(json.load(fh))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
    return infos, arrays


def _phase_sharded(torch, aspace, gl, batches, src, outs, card, results,
                   runs=SHARDED_RUNS, per_card: bool = False) -> None:
    """Phase 17: the sharded build and serving of phase 3's corpus, at
    world 1 under NCCL and at world 2 under gloo (both ranks on the one
    card), each spawned from here; every check against phase 3.  With
    --cards, ``runs`` is one NCCL run with a rank a card."""
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    ref_d = aspace._knn_dist.cpu().numpy()
    ref_i = aspace._knn_idx.cpu().numpy()
    ref_lam = aspace.lambdas()
    ref_idx = gl.neighbor_indices.cpu().numpy()
    ref_w = gl.neighbor_weights.cpu().numpy()
    exact_i, exact_v = outs[0]
    sub_i, sub_v = aspace.search_batch(batches[0], gl, TAU, mode="subtile")
    checks = {}
    for backend, world in runs:
        t0 = time.perf_counter()
        infos, arrays = _run_ranks(world, backend, src[0], per_card)
        wall = time.perf_counter() - t0
        tag = f"world {world} ({backend})"
        r0, a0 = infos[0], arrays[0]
        d = np.concatenate([a["knn_d"] for a in arrays])[:N]
        i = np.concatenate([a["knn_i"] for a in arrays])[:N]
        lists_same = (np.array_equal(d.view(np.int32), ref_d.view(np.int32))
                      and np.array_equal(i, ref_i))
        lap_same = (np.array_equal(a0["nbr_idx"], ref_idx)
                    and np.array_equal(a0["nbr_w"].view(np.int32),
                                       ref_w.view(np.int32)))
        sym = _ell_symmetric(a0["nbr_idx"], a0["nbr_w"])
        lam_err = float(np.max(np.abs(a0["lambdas"] - ref_lam)
                               / np.maximum(np.abs(ref_lam), 1e-30)))
        bad_exact = topk_disagreements(a0["exact_v"], a0["exact_i"],
                                       exact_v, exact_i, TOL)
        bad_cert = topk_disagreements(a0["certified_v"], a0["certified_i"],
                                      exact_v, exact_i, TOL)
        bad_sub = topk_disagreements(a0["subtile_v"], a0["subtile_i"],
                                     exact_v, exact_i, TOL)
        sub_overlap = _overlap(a0["subtile_i"], exact_i)
        sub_same = (np.array_equal(a0["subtile_i"], sub_i)
                    and np.array_equal(a0["subtile_v"].view(np.int32),
                                       sub_v.view(np.int32)))
        stages = {k: round(v, 4) for k, v in r0["stages"].items()}
        print(f"phase 17: {tag}: ranks done in {wall:.3f} s (spawn "
              f"included); build {r0['build_s']:.3f} s, stages (s) "
              f"{json.dumps(stages)}; serving state (slabs, subtile) "
              f"{r0['state_s']:.3f} s; QPS on phase 3's first batch of "
              f"{Q_BATCH}: " + ", ".join(f"{m} {q:.1f}" for m, q in
                                        r0["qps"].items()) + f" {card}")
        print(f"phase 17: {tag}: lists bit for bit phase 3's: "
              f"{lists_same}; L bit for bit phase 3's: {lap_same}, exactly "
              f"symmetric: {sym}; lambda max relative error "
              f"{lam_err:.3e} (bound {'0' if world == 1 else LAMBDA_REL_BOUND}"
              f"); tau* {r0['tau_star']:.9g} (phase 3: "
              f"{aspace.tau_star:.9g}); queries differing from phase 3's "
              f"exact beyond near-ties of {TOL:g}: exact {len(bad_exact)}, "
              f"certified {len(bad_cert)}, subtile {len(bad_sub)} (bf16 "
              f"routing; top-{GP['topk']} overlap {sub_overlap:.6f}; equal "
              f"to the one-device subtile bit for bit: {sub_same}); "
              f"symmetrize fallbacks {r0['fallbacks']}")
        for info in infos:
            print(f"phase 17: {tag}: rank {info['rank']} ({info['rows']} "
                  f"real of {info['n_loc']} rows): launches "
                  f"{info['launches']}; collectives through host memory: "
                  f"{info['host_copied'] or 'none'}")
        for name, v in (r0.get("kernels") or {}).items():
            print(f"phase 17: {tag}: rank 0's shape, {name}: "
                  + ", ".join(f"{k} {x:.4g}" if isinstance(x, float)
                              else f"{k} {x}" for k, x in v.items())
                  + f" {card}")
        paths = ("knn", "scan_topk", "subtile_max", "extract_ids",
                 "gather_score", "extract_pool", "ivf_scan")
        launched = all(info["launches"][k] > 0 for info in infos
                       for k in paths)
        if world > 1:
            launched = launched and all(info["launches"]["knn_seeded"] > 0
                                        for info in infos)
            for name, v in r0["kernels"].items():
                results[name]["sharded"] = dict(
                    v, launches=r0["launches"][name],
                    world=world, backend=backend)
        checks.update({
            f"{tag}: lists": lists_same,
            f"{tag}: L": lap_same and sym,
            f"{tag}: lambdas": lam_err <= (0.0 if world == 1
                                           else LAMBDA_REL_BOUND),
            f"{tag}: exact": not bad_exact,
            f"{tag}: certified": not bad_cert,
            f"{tag}: subtile": sub_overlap >= MIN_OVERLAP
            and (world > 1 or sub_same),
            f"{tag}: every kernel of the path launched on every rank":
                launched,
            f"{tag}: ring through host memory only for gloo":
                all(set(info["host_copied"])
                    <= ({"ring_shift"} if backend == "gloo" else set())
                    for info in infos),
            f"{tag}: shard kernels vs plain": all(
                v["max_abs_err"] <= TOL and v.get("disagreeing", 0) == 0
                for v in (r0.get("kernels") or {}).values()),
        })
        results[f"sharded_w{world}"] = dict(
            build_s=r0["build_s"], stages=r0["stages"], qps=r0["qps"],
            lambda_max_rel_err=lam_err, host_copied=r0["host_copied"])
    if not all(checks.values()):
        raise AssertionError(f"sharded checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _tsdae_corpus(n: int, seed: int = 5) -> list[str]:
    """n sentences of 6-20 words drawn (Zipf weights) from a fixed list of
    TSDAE_WORDS two- and three-syllable words."""
    syll = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    rng = np.random.default_rng(seed)
    words = sorted({"".join(rng.choice(syll, size=rng.integers(2, 4)))
                    for _ in range(4 * TSDAE_WORDS)})[:TSDAE_WORDS]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(6, 21), p=p))
            for _ in range(n)]


def _phase_trainers(torch, items, card, results) -> None:
    """Phase 18: DomainAdapter.fit (linear and mlp) on phase 3's rows at
    its defaults, transform and a build of the adapted rows; TSDAEEncoder
    at its defaults fitted on a seeded corpus of TSDAE_SENTENCES
    sentences, its loss falling, and encode of the corpus into an index."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.models import (DomainAdapter, TSDAEConfig,
                                               TSDAEEncoder)
    out, checks = {}, {}
    # The process's first fit loads the backward and optimizer kernels
    # (seconds); a fit on 4,096 rows first keeps that out of the timings.
    t0 = time.perf_counter()
    for arch in ("linear", "mlp"):
        DomainAdapter(arch=arch).fit(items[:4096])
    torch.cuda.synchronize()
    out["adapter_warmup_s"] = time.perf_counter() - t0
    print(f"phase 18: warm-up fits (linear, mlp; 4,096 rows, 4 steps) "
          f"{out['adapter_warmup_s']:.3f} s {card}")
    for arch in ("linear", "mlp"):
        ad = DomainAdapter(arch=arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ad.fit(items)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = ad.epochs * (N // ad.batch_size)
        out[f"adapter_{arch}"] = dict(s=secs, steps=steps,
                                      steps_per_s=steps / secs,
                                      loss=ad.losses_[-1])
        print(f"phase 18: DomainAdapter({arch}) fit on {N}x{F}: hidden "
              f"{ad.w_enc.shape[1]}, batch {ad.batch_size}, {steps} steps "
              f"in {secs:.3f} s ({steps / secs:.1f} steps/s), final loss "
              f"{ad.losses_[-1]:.6f} {card}")
        checks[f"adapter {arch} loss finite"] = bool(
            np.isfinite(ad.losses_[-1]))
        if arch == "linear":
            t0 = time.perf_counter()
            adapted = ad.transform(items)
            t_tr = time.perf_counter() - t0
            t0 = time.perf_counter()
            a2, g2 = pt.ArrowSpaceBuilder.build(GP, adapted)
            t_b = time.perf_counter() - t0
            lam = a2.lambdas()
            sym = _ell_symmetric(g2.neighbor_indices.cpu().numpy(),
                                 g2.neighbor_weights.cpu().numpy())
            print(f"phase 18: transform {t_tr:.3f} s; build of the adapted "
                  f"rows {t_b:.3f} s, tau* {a2.tau_star:.6g}, L exactly "
                  f"symmetric: {sym}, lambdas finite: "
                  f"{bool(np.all(np.isfinite(lam)))} {card}")
            out["adapted_build_s"] = t_b
            checks["adapted build"] = sym and bool(np.all(np.isfinite(lam)))
            del a2, g2, adapted
    texts = _tsdae_corpus(TSDAE_SENTENCES)
    cfg = TSDAEConfig()
    enc = TSDAEEncoder(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc.fit(texts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps = len(enc.losses_)
    first = float(np.mean(enc.losses_[:64]))
    last = float(np.mean(enc.losses_[-64:]))
    t0 = time.perf_counter()
    emb = enc.encode(texts)
    t_enc = time.perf_counter() - t0
    a3, g3 = pt.ArrowSpaceBuilder.build(GP, emb)
    rows = np.arange(0, TSDAE_SENTENCES, TSDAE_SENTENCES // 64)
    ids, _ = a3.search_batch(emb[rows], g3, TAU)
    self_first = float(np.mean(ids[:, 0] == rows))
    print(f"phase 18: TSDAEEncoder (vocab {cfg.vocab}, d_model "
          f"{cfg.d_model}, {cfg.n_layers} + {cfg.n_layers} layers, "
          f"{cfg.heads} heads, max_len {cfg.max_len}, batch "
          f"{cfg.batch_size}) fit on {len(texts)} sentences: {steps} steps "
          f"in {secs:.3f} s ({steps / secs:.1f} steps/s); loss first 64 "
          f"steps {first:.4f}, last 64 {last:.4f}; encode {t_enc:.3f} s; "
          f"index {emb.shape[0]}x{emb.shape[1]}: tau* {a3.tau_star:.6g}, "
          f"source row first for {self_first:.3f} of {rows.size} queries "
          f"{card}")
    out["tsdae"] = dict(s=secs, steps=steps, steps_per_s=steps / secs,
                        loss_first=first, loss_last=last, encode_s=t_enc,
                        self_first=self_first)
    checks["TSDAE loss falls"] = last < first
    checks["TSDAE index serves its rows"] = self_first >= 0.9
    results["trainers"] = out
    if not all(checks.values()):
        raise AssertionError(f"trainer checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _ptxas_summary(build, name: str) -> str:
    """Registers and spill stores of the kernels of csrc/<name>.cu, from
    ptxas's report that the build keeps beside the library (none when the
    build keeps no report)."""
    log = build.library_path(name).with_suffix(".ptxas.txt")
    if not log.exists():
        return "no report"
    regs, spills = [], []
    for line in log.read_text().splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used ")[1].split()[0]))
        elif "spill stores" in line:
            spills.append(int(line.split("bytes stack frame, ")[1].split()[0]))
    return (f"{len(regs)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, spill stores up to "
            f"{max(spills, default=0)} B")


def _ptxas_routes(build, name: str, route_of) -> str:
    """Registers and spill stores of csrc/<name>.cu's kernels by route, from
    ptxas's report: route_of(mangled entry name) names an entry's route,
    or None for an entry left out."""
    import re
    log = build.library_path(name).with_suffix(".ptxas.txt")
    if not log.exists():
        return "no report"
    routes: dict = {}
    entry = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            route = route_of(m.group(1))
            entry = routes.setdefault(route, {"regs": [], "spills": []}) \
                if route else None
        elif entry is not None and "Used" in line and "registers" in line:
            entry["regs"].append(int(line.split("Used ")[1].split()[0]))
        elif entry is not None and "spill stores" in line:
            entry["spills"].append(
                int(line.split("bytes stack frame, ")[1].split()[0]))
    return "; ".join(
        f"{route} route: {len(r['regs'])} kernels, registers "
        f"{min(r['regs'], default=0)}-{max(r['regs'], default=0)}, spill "
        f"stores up to {max(r['spills'], default=0)} B"
        for route, r in sorted(routes.items()))


def _k6_route_of(entry: str):
    """K6's narrow kernels (lists of 2, 4 or 8 words a lane) and its wide
    ones (the staged merge), told apart by the W template argument."""
    import re
    w = re.search(r"ivf_kernelI.*?Li\d+ELi(\d+)ELb[01]E", entry)
    return ("wide" if w.group(1) == "0" else "narrow") if w else None


def _tc_route_of(entry: str):
    """The scans of K2 and K7 by route: csrc/tc_scan.cuh's tensor-core
    block (its queries resident or streamed), or the SIMT kernels."""
    import re
    if "tcscan" in entry:
        stream = re.search(r"ELi\d+ELb([01])E", entry)
        return "tc/stream" if stream and stream.group(1) == "1" else "tc"
    return "simt" if re.search(r"scan_kernel|scan_int8_kernel",
                               entry) else None


def _k3_route_of(entry: str):
    """K3's kernels by route: the tensor-core kernel or the SIMT ones."""
    return ("tc" if "subtile_max_tc_kernel" in entry else
            "simt" if "subtile_max_kernel" in entry else None)


def _k1_route_of(entry: str):
    """K1's narrow kernels by walk: the symmetric route (SYM true) or the
    full walk."""
    if "knn_kernel" not in entry:
        return None
    return "sym" if "ELb1EE" in entry else "full-walk"


def _measures(results: dict) -> dict:
    """The numbers --against compares, as this run's phases took them."""
    wide = results["wide"]
    return {"k1_full_ms": results["knn"]["full_ms"],
            "k1_full_walk_ms": results["knn"]["full_walk_ms"],
            "k1_ms": results["knn"]["ms"],
            "k1t_ms": results["knn"]["k1t_ms"],
            "k1_9416_rows_ms": results["knn"]["tail_ms"],
            "k1_k100_ms": wide["knn_k100"]["ms"],
            "k1_k200_ms": wide["knn_k200"]["ms"],
            "k1_k1024_ms": wide["knn"]["ms"],
            "k2_ms": results["scan_topk"]["ms"],
            "k2_k200_ms": wide["scan_topk_k200"]["ms"],
            "k2_k1024_ms": wide["scan_topk"]["ms"],
            "k2_bf16_ms": results["scan_topk_bf16"]["ms"],
            "k2_bf16_k200_ms": wide["scan_topk_bf16_k200"]["ms"],
            "k2_bf16_k1024_ms": wide["scan_topk_bf16_k1024"]["ms"],
            "build_s": results["build_s"],
            "knn_phase_s": results["knn_phase_s"],
            "exact_qps": results["exact_qps"],
            "bf16_qps": results["bf16_313k"]["qps"],
            **results["subtile_ab"], **results["scans_ab"]}


def _turn_line(line: str) -> bool:
    """The lines of a --measure run that --against prints for its turn:
    the kernels' build seconds (a tree's first turn builds, its second
    finds the libraries), ptxas's reports, and the phases' launches with
    their routes (and the product's loader, where the tree has two)."""
    return "ptxas" in line or line.startswith(
        ("phase 6b: K2", "phase 6b: K3", "phase 0: built",
         "phase 0: all kernels")) or (
        line.startswith(("phase 1:", "phase 2:", "phase 11:"))
        and ("route" in line or "(narrow/" in line or "(wide/" in line))


def _against(trees: list[str]) -> int:
    """--against: each tree's package through this script's phases 0-3, 6b and
    11, in turns, then every run's k-NN lists, lambdas and exact top-k ids
    against this tree's."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    trees = [os.path.abspath(t) for t in trees]
    order = trees + [root, root] + trees[::-1]
    runs, same = [], True
    with tempfile.TemporaryDirectory() as tmp:
        for turn, tree in enumerate(order):
            out = os.path.join(tmp, f"{turn}.npz")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 tree, out], capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:])
                return 1
            if turn == 0:
                print(lines[0])                        # the card
            for line in lines:
                if _turn_line(line):
                    print(f"turn {turn}: {line}")
            runs.append(json.loads(lines[-1]))
            print(f"turn {turn} {tree}: {json.dumps(runs[-1])}", flush=True)
        ref = np.load(os.path.join(tmp, f"{len(trees)}.npz"))
        for turn, tree in enumerate(order):
            got = np.load(os.path.join(tmp, f"{turn}.npz"))
            diff = [key for key in ref.files
                    if not np.array_equal(got[key].view(np.uint8),
                                          ref[key].view(np.uint8))]
            same &= not diff
            print(f"turn {turn} {tree}: differing from this tree: {diff}")
    for tree in dict.fromkeys(order):
        mine = [r for r, t in zip(runs, order) if t == tree]
        print(f"mean {tree}: " + json.dumps(
            {key: sum(r[key] for r in mine) / len(mine) for key in mine[0]}))
    return 0 if same else 1


def main(tree: str | None = None, dump: str | None = None) -> int:
    """Every phase; or, with ``tree`` (--measure), the package of that
    checkout through phases 0-3, 6b and 11 only, phase 3's k-NN lists, lambdas
    and exact top-k ids saved to ``dump`` (npz) and the measures printed as
    the last line."""
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    sys.path.insert(0, os.path.abspath(tree or root))
    try:
        import pyarrowspace_tpu_torch as pt
        from data_test0 import (EXPECTED_ORDERINGS, GRAPH_PARAMS_TEST0,
                                ITEMS_5X24)
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    from pyarrowspace_tpu_torch import _build
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops.cuda import knn, knn_t, scan_topk
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize

    assert "jax" not in sys.modules, "the port must not import jax"
    assert pt.__file__.startswith(os.path.abspath(tree or root) + os.sep)
    dev = torch.device("cuda")
    failed: list[str] = []
    results: dict = {}

    # -- phase 0: device and build -------------------------------------------
    smi = _smi()
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name, secs in _build.load_all(KERNEL_SOURCES).items():
        print(f"phase 0: built csrc/{name}.cu in {secs:.3f} s {card}")
    print(f"phase 0: all kernels built in {time.perf_counter() - t0:.3f} s")
    for name in ("knn", "knn_t", "scan_topk", "subtile_max", "gather_score",
                 "scan_int8", "ivf_scan"):
        print(f"phase 0: ptxas csrc/{name}.cu: {_ptxas_summary(_build, name)}")
    print(f"phase 0: ptxas csrc/subtile_max.cu by route: "
          f"{_ptxas_routes(_build, 'subtile_max', _k3_route_of)}")
    print(f"phase 0: ptxas csrc/knn.cu's narrow kernels by walk: "
          f"{_ptxas_routes(_build, 'knn', _k1_route_of)}")
    for name in ("knn", "knn_t", "scan_topk"):
        print(f"phase 0: ptxas csrc/{name}.cu's product kernels by ring: "
              f"{_ptxas_routes(_build, name, _ring_of)}")
    for name in ("scan_topk", "scan_int8"):
        print(f"phase 0: ptxas csrc/{name}.cu's scans by route (tc_scan.cuh"
              f"'s block, its queries resident or streamed, or SIMT): "
              f"{_ptxas_routes(_build, name, _tc_route_of)}")
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    if hasattr(k6, "blocks_per_sm"):
        occ = {(k, str(dt).split(".")[-1]): k6.blocks_per_sm(k, 16, dt, dev)
               for k in (15, 260) for dt in (torch.float32, torch.bfloat16)}
        print(f"phase 0: ptxas csrc/ivf_scan.cu by route: "
              f"{_ptxas_routes(_build, 'ivf_scan', _k6_route_of)}; the wide "
              f"route (k > 256) sorts "
              f"in the ring's free stage, no list memory; blocks an SM at "
              f"qb 16 by (k, slabs): {occ}")

    rng = np.random.default_rng(42)
    items_host = rng.standard_normal((N, F), dtype=np.float32) * 12.0
    items = torch.from_numpy(items_host).to(dev)
    xu = unit_normalize(items).contiguous()

    # -- phase 1: K1 against its plain version --------------------------------
    try:
        k, eps = GP["k"], GP["eps"]
        # The whole corpus on its route (symmetric) and on the full walk:
        # the same bits on every row, then both timed in turns.
        full_route = _route(knn, N, N, k, dev, xu)
        d, i = knn.knn_scan(xu, k, eps)
        full_route = _last_route(knn) or full_route
        d_f, i_f = knn.knn_scan(xu, k, eps, **_full_walk(knn))
        walks_same = _bits_equal(torch, d, d_f) and torch.equal(i, i_f)
        del d_f, i_f
        full_ms, full_walk_ms = _in_turns(
            lambda: knn.knn_scan(xu, k, eps, **_full_walk(knn)),
            lambda: knn.knn_scan(xu, k, eps), torch)
        rows = np.sort(np.random.default_rng(0).choice(
            N, K1_CHECK_ROWS, replace=False))
        rows_t = torch.as_tensor(rows, device=dev)
        dp, ip = knn.knn_plain(xu, k, eps, rows=rows_t)
        d_np, i_np = d.cpu().numpy(), i.cpu().numpy()
        bad = topk_disagreements(d_np[rows], i_np[rows], dp.cpu().numpy(),
                                 ip.cpu().numpy(), TOL)
        err = max_abs_err(d_np[rows], dp.cpu().numpy())
        # Bitwise symmetry on kept mutual pairs.
        srng = np.random.default_rng(1)
        r = srng.integers(0, N, 400_000)
        s = srng.integers(0, k, 400_000)
        j = i_np[r, s]
        r, s, j = r[j >= 0], s[j >= 0], j[j >= 0]
        back = i_np[j] == r[:, None]
        mutual = back.any(axis=1)
        r, s, j = r[mutual][:10_000], s[mutual][:10_000], j[mutual][:10_000]
        t = back[mutual][:10_000].argmax(axis=1)
        sym = np.array_equal(d_np[r, s].view(np.uint32),
                             d_np[j, t].view(np.uint32))
        # The witnesses: K1t's lists, and K5's cosine (its SIMT route keeps
        # tile_common.cuh's product) for every id of K1's lists.
        dt, it = knn_t.knn_scan_t(xu, k, eps, 0, K1_TIME_ROWS)
        witness = (_bits_equal(torch, d[:K1_TIME_ROWS], dt)
                   and _bits_equal(torch, i[:K1_TIME_ROWS], it))
        k1_dump = {"k1t_d": dt.cpu().numpy(), "k1t_i": it.cpu().numpy()}
        del dt, it
        keep = i[:K1_TIME_ROWS] >= 0
        k5 = _own_compare().k5_distance(xu, slice(0, K1_TIME_ROWS),
                                        i[:K1_TIME_ROWS])
        witness_k5 = bool(keep.any()) and torch.equal(
            d[:K1_TIME_ROWS].view(torch.int32)[keep],
            k5.view(torch.int32)[keep])
        del k5, keep
        k_ms, p_ms = _in_turns(
            lambda: knn.knn_plain(xu, k, eps, rows=slice(0, K1_TIME_ROWS)),
            lambda: knn.knn_scan(xu, k, eps, 0, K1_TIME_ROWS), torch)
        k1t_ms = sum(_events_ms(lambda: knn_t.knn_scan_t(
            xu, k, eps, 0, K1_TIME_ROWS), torch) for _ in range(2)) / 2
        # The extend's new-row scan shape: 9,416 rows (74 row blocks).
        tail = slice(N - N_EXTEND, N)
        dtl, itl = knn.knn_scan(xu, k, eps, N - N_EXTEND, N_EXTEND)
        k1_dump.update(k1_tail_d=dtl.cpu().numpy(),
                       k1_tail_i=itl.cpu().numpy())
        tail_same = (_bits_equal(torch, dtl, d[tail])
                     and _bits_equal(torch, itl, i[tail]))
        del dtl, itl
        tail_ms = sum(_events_ms(lambda: knn.knn_scan(
            xu, k, eps, N - N_EXTEND, N_EXTEND), torch) for _ in range(2)) / 2
        mm_ms = _product_ms(torch, xu[:K1_TIME_ROWS], xu)
        full_bound = _bound(2.0 * _k1_pairs(N, N) * F, "fp32",
                            N * F * 4 + N * k * 8)
        results["knn"] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * _k1_pairs(K1_TIME_ROWS, N) * F, "fp32",
                     N * F * 4 + K1_TIME_ROWS * k * 8),
            kernel_route=_route(knn, K1_TIME_ROWS, N, k, dev, xu),
            product_ms=mm_ms, full_ms=full_ms, full_route=full_route,
            full_walk_ms=full_walk_ms, full_walk_same=walks_same,
            full_bound_ms=full_bound["bound_ms"], k1t_ms=k1t_ms,
            tail_ms=tail_ms, tail_rows=N_EXTEND,
            tail_route=_route(knn, N_EXTEND, N, k, dev, xu),
            tail_bound_ms=_bound(2.0 * _k1_pairs(N_EXTEND, N) * F, "fp32",
                                 N * F * 4 + N_EXTEND * k * 8)["bound_ms"])
        print(f"phase 1: K1 full corpus {N}x{F} k={k}: route {full_route} "
              f"{full_ms:.3f} ms, the full walk {full_walk_ms:.3f} ms (in "
              f"turns), bound {full_bound['bound_ms']:.3f} ms "
              f"({full_bound['bound_by']}); the two walks' lists bit for "
              f"bit on all {N} rows: {walks_same} {card}")
        print(f"phase 1: K1 on {K1_TIME_ROWS} rows "
              f"({results['knn']['kernel_route']}): kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{results['knn']['bound_ms']:.3f} ms; yardstick torch.mm "
              f"[{K1_TIME_ROWS},{F}]x[{F},{N}] fp32 (not called by the "
              f"port) {mm_ms:.3f} ms; K1 / torch.mm "
              f"{k_ms / mm_ms:.3f}, K1 / bound "
              f"{k_ms / results['knn']['bound_ms']:.3f}, torch.mm / bound "
              f"{mm_ms / results['knn']['bound_ms']:.3f} {card}")
        print(f"phase 1: K1 == K1t bit for bit on {K1_TIME_ROWS} rows: "
              f"{witness}; K1 == K5 distance bit for bit: {witness_k5}; K1t "
              f"{k1t_ms:.3f} ms ({_route(knn_t, K1_TIME_ROWS, N, k, dev, xu)}); K1"
              f" on the {N_EXTEND} last rows {tail_ms:.3f} ms "
              f"({results['knn']['tail_route']}), bitwise the whole scan's: "
              f"{tail_same} {card}")
        print(f"phase 1: K1 vs plain on {K1_CHECK_ROWS} rows: "
              f"max_abs_err {err:.3e}, disagreeing rows {len(bad)}; "
              f"bitwise d(i,j)==d(j,i) on {r.size} mutual pairs: {sym}")
        dw, iw = knn.knn_scan(xu, K1_WIDE, eps, 0, K1_CHECK_ROWS)
        dwp, iwp = knn.knn_plain(xu, K1_WIDE, eps,
                                 rows=slice(0, K1_CHECK_ROWS))
        bad_w = topk_disagreements(dw.cpu().numpy(), iw.cpu().numpy(),
                                   dwp.cpu().numpy(), iwp.cpu().numpy(), TOL)
        err_w = max_abs_err(dw.cpu().numpy(), dwp.cpu().numpy())
        k_wide_ms = sum(_events_ms(lambda: knn.knn_scan(
            xu, K1_WIDE, eps, 0, K1_TIME_ROWS), torch) for _ in range(2)) / 2
        print(f"phase 1: K1 at k={K1_WIDE} vs plain on {K1_CHECK_ROWS} rows: "
              f"max_abs_err {err_w:.3e}, disagreeing rows {len(bad_w)}; on "
              f"{K1_TIME_ROWS} rows {k_wide_ms:.3f} ms (k={k}: {k_ms:.3f} ms)"
              f" {card}")
        # The wide route (k > 128) at k 1,024 on 2,048 rows: a split walk.
        dx, ix = knn.knn_scan(xu, K_WIDEST, eps, 0, K1_CHECK_ROWS)
        dxp, ixp = knn.knn_plain(xu, K_WIDEST, eps,
                                 rows=slice(0, K1_CHECK_ROWS))
        bad_x = topk_disagreements(dx.cpu().numpy(), ix.cpu().numpy(),
                                   dxp.cpu().numpy(), ixp.cpu().numpy(), TOL)
        err_x = max_abs_err(dx.cpu().numpy(), dxp.cpu().numpy())
        wide_ms, wide_plain_ms = _in_turns(
            lambda: knn.knn_plain(xu, K_WIDEST, eps,
                                  rows=slice(0, K1_CHECK_ROWS)),
            lambda: knn.knn_scan(xu, K_WIDEST, eps, 0, K1_CHECK_ROWS), torch)
        narrow_ms = _events_ms(
            lambda: knn.knn_scan(xu, k, eps, 0, K1_CHECK_ROWS), torch)
        d2, i2 = knn.knn_scan(xu, K1_DEVICE_LIST, eps, 0, K1_TIME_ROWS)
        k1_dump.update(k1_k200_d=d2.cpu().numpy(),
                       k1_k200_i=i2.cpu().numpy(),
                       k1_k1024_d=dx.cpu().numpy(),
                       k1_k1024_i=ix.cpu().numpy())
        del d2, i2
        k_device_ms, k200_plain_ms = _in_turns(
            lambda: knn.knn_plain(xu, K1_DEVICE_LIST, eps,
                                  rows=slice(0, K1_TIME_ROWS)),
            lambda: knn.knn_scan(xu, K1_DEVICE_LIST, eps, 0, K1_TIME_ROWS),
            torch)
        bound_200 = _bound(2.0 * _k1_pairs(K1_TIME_ROWS, N) * F, "fp32",
                           N * F * 4 + K1_TIME_ROWS * K1_DEVICE_LIST * 8)
        bound_x = _bound(2.0 * _k1_pairs(K1_CHECK_ROWS, N) * F, "fp32",
                         N * F * 4 + K1_CHECK_ROWS * K_WIDEST * 8)
        results["wide"] = {
            "knn": dict(k=K_WIDEST, rows=K1_CHECK_ROWS, ms=wide_ms,
                        plain_ms=wide_plain_ms, narrow_ms=narrow_ms,
                        kernel_route=_route(knn, K1_CHECK_ROWS, N, K_WIDEST,
                                            dev, xu), **bound_x),
            "knn_k100": dict(k=K1_WIDE, rows=K1_TIME_ROWS, ms=k_wide_ms),
            "knn_k200": dict(k=K1_DEVICE_LIST, rows=K1_TIME_ROWS,
                             ms=k_device_ms, plain_ms=k200_plain_ms,
                             k25_ms=k_ms,
                             kernel_route=_route(knn, K1_TIME_ROWS, N,
                                                 K1_DEVICE_LIST, dev, xu),
                             **bound_200)}
        print(f"phase 1: K1 at k={K1_DEVICE_LIST} on {K1_TIME_ROWS} rows "
              f"{k_device_ms:.3f} ms ({k_device_ms / k_ms:.3f}x K1 at k={k})"
              f", plain {k200_plain_ms:.3f} ms, bound "
              f"{bound_200['bound_ms']:.3f} ms "
              f"({bound_200['bound_by']}), route "
              f"{results['wide']['knn_k200']['kernel_route']} {card}")
        print(f"phase 1: K1 at k={K_WIDEST} vs plain on {K1_CHECK_ROWS} "
              f"rows: max_abs_err {err_x:.3e}, disagreeing rows "
              f"{len(bad_x)}; kernel {wide_ms:.3f} ms (k={k}: "
              f"{narrow_ms:.3f} ms), plain {wide_plain_ms:.3f} ms, bound "
              f"{bound_x['bound_ms']:.3f} ms ({bound_x['bound_by']}), route "
              f"{results['wide']['knn']['kernel_route']} {card}")
        results["k1_dump"] = k1_dump
        results["knn"]["max_abs_err"] = max(err, err_w, err_x)
        if bad or err > TOL or not sym or r.size < 10_000 or bad_w \
                or err_w > TOL or bad_x or err_x > TOL or not witness \
                or not witness_k5 or not tail_same or not walks_same:
            raise AssertionError(f"K1 check failed: rows {bad[:10]}, "
                                 f"err {err}, symmetric {sym}, walks "
                                 f"{walks_same}, K1t {witness}, "
                                 f"K5 {witness_k5}, tail {tail_same}, "
                                 f"pairs {r.size}, k={K1_WIDE} rows "
                                 f"{bad_w[:10]} err {err_w}, k={K_WIDEST} "
                                 f"rows {bad_x[:10]} err {err_x}")
        del d, i, dp, ip, dw, iw, dwp, iwp, dx, ix, dxp, ixp
    except Exception:
        traceback.print_exc()
        failed.append("phase 1 (K1 vs plain)")

    # -- phase 3: the main path -----------------------------------------------
    aspace = gl = batches = src = outs = None
    try:
        t0 = time.perf_counter()
        warm, _ = pt.ArrowSpaceBuilder.build(GP, items)
        t_warm = time.perf_counter() - t0
        _reset_launches()
        t0 = time.perf_counter()
        aspace, gl = pt.ArrowSpaceBuilder.build(GP, items)
        t_build = time.perf_counter() - t0
        phases = pt.get_phase_timings()
        k1_build = knn.LAUNCHES
        sym_build = getattr(knn, "SYM_LAUNCHES", 0)
        # Two builds of the same rows: the same bits (no float atomics).
        repeat_diff = _same(torch, [
            ("lambdas", warm._lambdas, aspace._lambdas),
            ("centroids", warm._centroids, aspace._centroids),
            ("assignments", warm._assignments, aspace._assignments),
            ("knn_idx", warm._knn_idx, aspace._knn_idx)])
        del warm
        rng_q = np.random.default_rng(7)
        src = [rng_q.choice(N, Q_BATCH) for _ in range(N_BATCHES)]
        batches = [items[torch.as_tensor(s_, device=dev)] * 1.01
                   for s_ in src]
        aspace.search_batch(batches[-1], gl, TAU)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [aspace.search_batch(b, gl, TAU) for b in batches]
        t_search = time.perf_counter() - t0
        singles = [int(x) for x in src[0][:3]]
        hits = [aspace.search(items_host[x] * 1.01, gl, TAU)
                for x in singles]
        launches = _launches()
        qps = Q_BATCH * N_BATCHES / t_search
        results.update(exact_qps=qps, build_s=t_build,
                       knn_phase_s=phases["knn"])
        print(f"phase 3: build {N}x{F}: warm-up {t_warm:.3f} s, timed "
              f"{t_build:.3f} s {card}")
        print(f"phase 3: build phases (s) "
              f"{json.dumps({kk: round(v, 4) for kk, v in phases.items()})}"
              f" {card}")
        print(f"phase 3: search_batch exact: {qps:.1f} QPS over "
              f"{N_BATCHES} x {Q_BATCH} queries, {t_search:.3f} s, "
              f"N={N} F={F} topk={GP['topk']} {card}")
        print(f"phase 3: launches on the main path {launches} "
              f"(K1 during the timed build: {k1_build}, on the symmetric "
              f"route: {sym_build})")
        results["launches"] = launches
        if "knn" in results:
            results["knn"]["sym_launches"] = launches["knn_sym"]
        top1 = all(int(o[0][row, 0]) == int(s_[row])
                   for o, s_ in zip(outs, src) for row in range(Q_BATCH))
        single_ok = all(h[0][0] == x and len(h) == GP["topk"]
                        for h, x in zip(hits, singles))
        single_same = all(
            [hh[0] for hh in h] == outs[0][0][row].tolist()
            for row, h in enumerate(hits))
        lam = aspace.lambdas()
        nbr_idx = gl.neighbor_indices.cpu().numpy()
        nbr_w = gl.neighbor_weights.cpu().numpy()
        sym = _ell_symmetric(nbr_idx, nbr_w)
        print(f"phase 3: nedges {gl.nedges}, ell width {nbr_idx.shape[1]}, "
              f"dropped {gl.n_dropped_edges}, tau* {aspace.tau_star:.6g}, "
              f"lambda range [{lam.min():.6f}, {lam.max():.6f}]; "
              f"L exactly symmetric: {sym}; each query's source row first: "
              f"{top1}; single searches agree with the batch: {single_same};"
              f" warm-up and timed builds differing in {repeat_diff}")
        checks = {
            "K1 launched on the main path": launches["knn"] > 0,
            "K1 once a build, on the symmetric route": k1_build == 1 and (
                sym_build == 1 or not _has_sym(knn)),
            "K2 launched on the main path": launches["scan_topk"] > 0,
            "K1 and K2 staged by TMA on the main path": not hasattr(
                knn, "TMA_LAUNCHES") or (
                launches["knn_tma"] == launches["knn"]
                and launches["scan_topk_tma"] == launches["scan_topk"]),
            "L exactly symmetric": sym,
            "lambdas finite in [0, 1]": bool(
                np.all(np.isfinite(lam)) and lam.min() >= 0
                and lam.max() <= 1),
            "no dropped edges": gl.n_dropped_edges == 0,
            "source row ranks first": top1 and single_ok,
            "single search == batch row": single_same,
            "two builds bitwise equal": not repeat_diff,
            "result shapes": all(o[0].shape == (Q_BATCH, GP["topk"])
                                 and np.all(np.isfinite(o[1]))
                                 for o in outs),
        }
        if not all(checks.values()):
            raise AssertionError(f"main-path checks failed: "
                                 f"{[c for c, ok in checks.items() if not ok]}")
    except Exception:
        traceback.print_exc()
        failed.append("phase 3 (main path)")

    # -- phase 2: K2 against its plain version --------------------------------
    try:
        if aspace is None:
            raise RuntimeError("no index: phase 3 failed")
        qb = batches[0]
        lam_q = search_ops.query_lambdas(
            qb, aspace._lap_f, aspace._w_f, aspace._tau_star,
            rayleigh_normalized=aspace._rayleigh_normalized,
            tau_mix=aspace._tau_mix)
        qn = unit_normalize(qb).contiguous()
        topk = GP["topk"]
        xs, lams = aspace._data_unit, aspace._lambdas
        i_k, s_k = scan_topk.lambda_search(xs, lams, qn, lam_q, TAU, topk)
        witness = _bits_equal(torch, s_k, _own_compare().k5_blend(
            xs, lams, qn, lam_q, TAU, i_k))
        i_p, s_p = scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err = max_abs_err(s_k, s_p)
        k_ms, p_ms = _in_turns(
            lambda: scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk),
            lambda: scan_topk.lambda_search(xs, lams, qn, lam_q, TAU, topk),
            torch)
        mm_ms = _product_ms(torch, qn, xs)
        results["scan_topk"] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * Q_BATCH * N * F, "fp32",
                     N * (F + 1) * 4 + Q_BATCH * ((F + 1) * 4 + topk * 8)),
            product_ms=mm_ms)
        results["scan_topk"]["kernel_route"] = _route(
            scan_topk, N, Q_BATCH, topk, dev, xs, qn)
        print(f"phase 2: K2 Q={Q_BATCH} N={N} F={F} k={topk} "
              f"({results['scan_topk']['kernel_route']}): kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{results['scan_topk']['bound_ms']:.3f} ms; yardstick "
              f"torch.mm [{Q_BATCH},{F}]x[{F},{N}] fp32 (not called by the "
              f"port) {mm_ms:.3f} ms; K2 / torch.mm {k_ms / mm_ms:.3f}, "
              f"K2 / bound {k_ms / results['scan_topk']['bound_ms']:.3f}, "
              f"torch.mm / bound "
              f"{mm_ms / results['scan_topk']['bound_ms']:.3f} {card}")
        print(f"phase 2: K2 vs plain: max_abs_err {err:.3e}, disagreeing "
              f"queries {len(bad)}")
        qw, lw = qn[:K2_WIDE_QUERIES], lam_q[:K2_WIDE_QUERIES]
        i_k, s_k = scan_topk.lambda_search(xs, lams, qw, lw, TAU, K2_WIDE)
        witness_w = _bits_equal(torch, s_k, _own_compare().k5_blend(
            xs, lams, qw, lw, TAU, i_k))
        i_p, s_p = scan_topk.scan_plain(xs, lams, qw, lw, TAU, K2_WIDE)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad_w = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err_w = max_abs_err(s_k, s_p)
        # K2's wide lists (k > 128), each timed in turns with its plain
        # version: k 200 over the whole batch, k 1,024 over 1,024 queries;
        # the launches are the wide route's in one call.
        wide = results.setdefault("wide", {})
        for key, k_w, qv, lv in (("scan_topk_k200", K2_WIDE, qn, lam_q),
                                 ("scan_topk", K_WIDEST, qw, lw)):
            before = getattr(scan_topk, "WIDE_LAUNCHES", 0)
            i_f, s_f = scan_topk.lambda_search(xs, lams, qv, lv, TAU, k_w)
            launches_w = getattr(scan_topk, "WIDE_LAUNCHES", 0) - before
            ms_w, plain_w = _in_turns(
                lambda: scan_topk.scan_plain(xs, lams, qv, lv, TAU, k_w),
                lambda: scan_topk.lambda_search(xs, lams, qv, lv, TAU, k_w),
                torch)
            q_w = qv.shape[0]
            narrow_w = k_ms if q_w == Q_BATCH else _events_ms(
                lambda: scan_topk.lambda_search(xs, lams, qv, lv, TAU, topk),
                torch)
            wide[key] = dict(
                k=k_w, queries=q_w, ms=ms_w, plain_ms=plain_w,
                narrow_ms=narrow_w, library_ms=None, launches=launches_w,
                lists=_route(scan_topk, N, q_w, k_w, dev, xs, qv),
                **_bound(2.0 * q_w * N * F, "fp32",
                         N * (F + 1) * 4 + q_w * ((F + 1) * 4 + k_w * 8)))
            results.setdefault("ab_dump", {}).update(
                {f"k2_k{k_w}_ids": i_f.cpu().numpy(),
                 f"k2_k{k_w}_scores": s_f.cpu().numpy()})
            print(f"phase 2: K2 at k={k_w} ({wide[key]['lists']}, "
                  f"{launches_w} wide launch) Q={q_w}: kernel {ms_w:.3f} "
                  f"ms, plain {plain_w:.3f} ms in turns; k={topk} on the "
                  f"same queries {narrow_w:.3f} ms; bound "
                  f"{wide[key]['bound_ms']:.3f} ms {card}")
        wide["scan_topk_k200"]["max_abs_err"] = err_w
        print(f"phase 2: K2 at k={K2_WIDE} vs plain on {K2_WIDE_QUERIES} "
              f"queries: max_abs_err {err_w:.3e}, disagreeing queries "
              f"{len(bad_w)}")
        print(f"phase 2: K2 == K5 + blend bit for bit: {witness} at k="
              f"{topk} on {Q_BATCH} queries, {witness_w} at k={K2_WIDE} on "
              f"{K2_WIDE_QUERIES}")
        i_k, s_k = scan_topk.lambda_search(xs, lams, qw, lw, TAU, K_WIDEST)
        i_p, s_p = scan_topk.scan_plain(xs, lams, qw, lw, TAU, K_WIDEST)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad_x = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err_x = max_abs_err(s_k, s_p)
        wide["scan_topk"]["max_abs_err"] = err_x
        print(f"phase 2: K2 at k={K_WIDEST} vs plain on {K2_WIDE_QUERIES} "
              f"queries: max_abs_err {err_x:.3e}, disagreeing queries "
              f"{len(bad_x)}")
        results["scan_topk"]["max_abs_err"] = max(err, err_w, err_x)
        no_wide = hasattr(scan_topk, "WIDE_LAUNCHES") and not all(
            wide[key]["launches"] for key in ("scan_topk_k200", "scan_topk"))
        # K2 over bf16 rows (the as_serving view's) at k 200 over the batch
        # and k 1,024 over 1,024 queries, on its tensor-core route where the
        # package has one: each held to its plain version and, bit for bit,
        # to K5 on the route K2 took, and timed in turns with the plain
        # version (its lists are not compared across trees: the routes sum
        # in other orders).
        xb = xs.to(torch.bfloat16)
        bf16_bad = []
        for key, k_w, qv, lv in (("scan_topk_bf16_k200", K2_WIDE, qn, lam_q),
                                 ("scan_topk_bf16_k1024", K_WIDEST, qw, lw)):
            before = getattr(scan_topk, "WIDE_LAUNCHES", 0)
            i_b, s_b = scan_topk.lambda_search(xb, lams, qv, lv, TAU, k_w)
            launches_w = getattr(scan_topk, "WIDE_LAUNCHES", 0) - before
            route_b = _last_route(scan_topk) or _k2_route(
                scan_topk, xb, qv, k_w, dev)
            wit_b = _bits_equal(torch, s_b, _own_compare().k5_blend(
                xb, lams, qv, lv, TAU, i_b,
                tensor_core=route_b.startswith("tc/")))
            i_bp, s_bp = scan_topk.scan_plain(xb, lams, qv, lv, TAU, k_w)
            s_b, i_b = s_b.cpu().numpy(), i_b.cpu().numpy()
            s_bp, i_bp = s_bp.cpu().numpy(), i_bp.cpu().numpy()
            bad_b = topk_disagreements(s_b, i_b, s_bp, i_bp, TOL)
            err_b = max_abs_err(s_b, s_bp)
            ms_b, plain_b = _in_turns(
                lambda: scan_topk.scan_plain(xb, lams, qv, lv, TAU, k_w),
                lambda: scan_topk.lambda_search(xb, lams, qv, lv, TAU, k_w),
                torch)
            q_w = qv.shape[0]
            wide[key] = dict(
                k=k_w, queries=q_w, ms=ms_b, plain_ms=plain_b,
                library_ms=None, launches=launches_w, lists=route_b,
                max_abs_err=err_b,
                **_bound(2.0 * q_w * N * F, "bf16",
                         N * (2 * F + 4) + q_w * ((F + 1) * 4 + k_w * 8)))
            print(f"phase 2: K2 over bf16 rows at k={k_w} Q={q_w} (route "
                  f"{route_b}, {launches_w} wide launch): kernel {ms_b:.3f} "
                  f"ms, plain {plain_b:.3f} ms in turns; bound "
                  f"{wide[key]['bound_ms']:.3f} ms; vs plain max_abs_err "
                  f"{err_b:.3e}, disagreeing queries {len(bad_b)}; == K5 + "
                  f"blend bit for bit: {wit_b} {card}")
            if bad_b or err_b > TOL or not wit_b:
                bf16_bad.append(key)
        del xb
        if bad or err > TOL or bad_w or err_w > TOL or bad_x or err_x > TOL \
                or not (witness and witness_w) or no_wide or bf16_bad:
            raise AssertionError(f"K2 check failed: queries {bad[:10]}, "
                                 f"err {err}, K5 {witness} / {witness_w}, "
                                 f"bf16 {bf16_bad}, "
                                 f"k={K2_WIDE} queries "
                                 f"{bad_w[:10]} err {err_w}, k={K_WIDEST} "
                                 f"queries {bad_x[:10]} err {err_x}")
    except Exception:
        traceback.print_exc()
        failed.append("phase 2 (K2 vs plain)")

    # -- phases 5-7: subtile serving ------------------------------------------
    for label, phase in (
            ("phase 5 (subtile serving)",
             lambda: _phase_subtile_serving(torch, aspace, gl, batches, src,
                                            outs, card, results)),
            ("phase 6 (subtile kernels vs plain)",
             lambda: _phase_subtile_kernels(torch, aspace, batches, card,
                                            results)),
            ("phase 7 (1M x 768 serving)",
             lambda: _phase_north_star(torch, dev, card, results)),
            ("phase 8 (certified serving)",
             lambda: _phase_certified(torch, aspace, gl, batches, outs,
                                      card, results)),
            ("phase 10 (int8 serving)",
             lambda: _phase_int8(torch, aspace, gl, batches, outs, card,
                                 results)),
            ("phase 6b (subtile kernels, --measure)",
             lambda: _phase_subtile_ab(torch, aspace, gl, batches, dev, card,
                                       results)),
            ("phase 6c (K7 and K6, --measure)",
             lambda: _phase_scans_ab(torch, aspace, gl, batches, dev, card,
                                     results)),
            ("phase 11 (bf16 serving view)",
             lambda: _phase_bf16_view(torch, aspace, gl, batches, outs, card,
                                      results)),
            ("phase 12 (hybrid, gather IVF, energy)",
             lambda: _phase_other_modes(torch, aspace, gl, items, batches,
                                        src, outs, card, results)),
            ("phase 13 (lists of 5,000; K6 at F 4,096)",
             lambda: _phase_long_lists(torch, aspace, gl, xu, batches, card,
                                       results)),
            ("phase 14 (k-NN variants)",
             lambda: _phase_variants(torch, items, xu, aspace, gl, card,
                                     results)),
            ("phase 15 (extend, save / load, suggestions)",
             lambda: _phase_lifecycle(torch, items, aspace, gl, batches,
                                      card, results)),
            ("phase 9 (1M x 768 certified serving)",
             lambda: _phase_certified_1m(torch, dev, card, results)),
            ("phase 16 (1M x 768 build)",
             lambda: _phase_build_1m(torch, dev, aspace, gl, card,
                                     results)),
            ("phase 17 (sharded build and serving)",
             lambda: _phase_sharded(torch, aspace, gl, batches, src, outs,
                                    card, results)),
            ("phase 18 (trainers)",
             lambda: _phase_trainers(torch, items, card, results))):
        # --measure runs phases 6b, 6c and 11 only; a full run all but 6b
        # and 6c.
        ab_only = ("phase 6b ", "phase 6c ")
        if (label.startswith(ab_only) if tree is None
                else not label.startswith(ab_only + ("phase 11 ",))):
            continue
        try:
            if aspace is None:
                raise RuntimeError("no index: phase 3 failed")
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(label)

    if tree is not None:
        if failed:
            print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
            return 1
        np.savez(dump, knn_dist=aspace._knn_dist.cpu().numpy(),
                 knn_idx=aspace._knn_idx.cpu().numpy(),
                 lambdas=aspace._lambdas.cpu().numpy(),
                 ids=np.stack([o[0] for o in outs]), **results["ab_dump"],
                 **results["k1_dump"])
        print(json.dumps(_measures(results)))
        return 0

    # -- phase 4: reference parity on the card in float32 ---------------------
    try:
        a, g = pt.ArrowSpaceBuilder.build(README_GP, README_ITEMS)
        hits = a.search(README_QUERY, g, 1.0)
        readme_ok = ([h[0] for h in hits] == [e[0] for e in README_EXPECTED]
                     and all(abs(h[1] - e[1]) <= 1e-6
                             for h, e in zip(hits, README_EXPECTED)))
        a, g = pt.ArrowSpaceBuilder.build(GRAPH_PARAMS_TEST0, ITEMS_5X24)
        query = ITEMS_5X24[2] * 1.05
        got = {tau: [h[0] for h in a.search(query, g, tau)]
               for tau in EXPECTED_ORDERINGS}
        test0_ok = got == EXPECTED_ORDERINGS
        print(f"phase 4: README quickstart on {a.device}: {hits} -> "
              f"{readme_ok}; test_0 orderings {got} -> {test0_ok}")
        if not (readme_ok and test0_ok):
            raise AssertionError("reference parity failed")
    except Exception:
        traceback.print_exc()
        failed.append("phase 4 (reference parity)")

    print(f"chip_smoke: total {time.perf_counter() - t_start:.3f} s")
    paths = ("launches", "launches_subtile", "launches_certified",
             "launches_int8", "launches_bf16", "launches_transposed",
             "launches_sub", "launches_diagstart", "launches_reorder",
             "launches_extend")
    if failed or not all(key in results for key in paths):
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    pallas = "pyarrowspace_tpu/ops/pallas/"
    table = (  # name, source, TPU kernel, the path whose launches count,
        #        its counter
        ("knn", "knn.cu", "knn.py:247", "launches", "knn"),
        ("scan_topk", "scan_topk.cu", "scan_topk.py:75", "launches",
         "scan_topk"),
        ("scan_topk_bf16", "scan_topk.cu", "scan_topk.py:75",
         "launches_bf16", "scan_topk"),
        ("subtile_max", "subtile_max.cu", "subtile_scan.py:59",
         "launches_subtile", "subtile_max"),
        ("extract_ids", "extract_topm.cu", "subtile_scan.py:266",
         "launches_subtile", "extract_ids"),
        ("extract_pool", "extract_topm.cu", "subtile_scan.py:220",
         "launches_subtile", "extract_pool"),
        ("gather_score", "gather_score.cu", "subtile_scan.py:131",
         "launches_subtile", "gather_score"),
        ("ivf_scan", "ivf_scan.cu", "ivf_scan.py:231", "launches_certified",
         "ivf_scan"),
        ("scan_int8", "scan_int8.cu", "scan_topk.py:113", "launches_int8",
         "scan_int8"),
        ("knn_t", "knn_t.cu", "knn.py:153", "launches_transposed", "knn_t"),
        ("knn_diagstart", "knn.cu", "knn.py:288", "launches_diagstart",
         "knn_diagstart"),
        ("knn_reorder", "knn.cu", "knn.py:408", "launches_reorder",
         "knn_reorder"),
        ("knn_seeded", "knn.cu", "knn.py:247", "launches_extend",
         "knn_seeded"),
    )
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"pyarrowspace_tpu_torch/csrc/{source}",
         "replaces": pallas + tpu, "launches": results[path][counter],
         **results[name]}
        for name, source, tpu, path, counter in table]
    # The wide lists of K1, K2 and K7, each entry its own timing.
    by_name = {kern["name"]: kern for kern in kernels}
    wide_src = "pyarrowspace_tpu_torch/csrc/knn_wide.cuh"
    for name, entries, source in (
            ("knn", (results["wide"]["knn_k200"], results["wide"]["knn"]),
             wide_src),
            ("scan_topk", (results["wide"]["scan_topk_k200"],
                           results["wide"]["scan_topk"]), wide_src),
            ("scan_topk_bf16", (results["wide"]["scan_topk_bf16_k200"],
                                results["wide"]["scan_topk_bf16_k1024"]),
             "pyarrowspace_tpu_torch/csrc/tc_scan.cuh"),
            ("scan_int8", (*results["wide_int8"].values(),
                           results["wide_int8_1m"]),
             by_name["scan_int8"]["source"])):
        by_name[name]["wide_lists"] = {
            f"k{v['k']}_q{v['queries']}" if name == "scan_int8"
            else f"k{v['k']}": {**v, "source": source} for v in entries}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--against"] and len(sys.argv) > 2:
        sys.exit(_against(sys.argv[2:]))
    if sys.argv[1:2] == ["--measure"] and len(sys.argv) == 4:
        sys.exit(main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--cards"] and len(sys.argv) == 3:
        sys.exit(_cards(int(sys.argv[2])))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
