"""Smoke run of the PyTorch/CUDA port (pyarrowspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, PyTorch built for CUDA and nvcc; it imports
no JAX.  Phases (each one that fails makes the script exit non-zero):

  0. device and build: the card's name and power limit, torch and CUDA
     versions, and the nvcc time of each kernel library (one nvcc each,
     all started together);
  1. K1 (csrc/knn.cu) against its plain version on a 313,841 x 384 unit
     corpus (eps 1.31, k 25): 2,048 random rows, distances within 1e-5 and
     ids equal up to near-ties; d(i, j) == d(j, i) bitwise on 10,000 kept
     mutual pairs; kernel and plain timed on the same 16,384 rows; the
     same check at k 100 (a list wider than 64) on 2,048 rows;
  3. the main path: ArrowSpaceBuilder.build at 313,841 x 384 with the CVE
     graph params (a warm-up build, then a timed one), search_batch(
     mode="exact") over 8 batches of 4,096 queries, 3 single searches.
     Launch counts are reset just before and read just after: both
     kernels must have run.  The Laplacian must be exactly symmetric,
     every lambda finite in [0, 1], and no edge dropped; the warm-up and
     the timed build must give the same lambdas, centroids and lists bit
     for bit (the Lloyd sums use no float atomics);
  2. K2 (csrc/scan_topk.cu) against its plain version on the built index:
     4,096 queries, tau 0.62, k 15, scores within 1e-5; and k 200 on 1,024
     queries;
  5. subtile serving on that index: search_batch(mode="subtile"), then
     mode="auto", over the same 8 batches, each after a warm-up, with the
     counts reset before each: K3, K4b, K5 and K4a must all have run, each
     query's source row must rank first and the mean top-15 overlap with
     phase 3's exact results must be at least 0.99.  Those modes route in
     bf16, so a query may lose an item whose float32 score makes the top
     15 but whose bf16 score misses the pool; such queries are counted.
     The same serving step over a float32 scan state routes with K2's own
     scores, so there the ids must equal phase 3's outside near-ties of
     1e-5 for every query;
  6. K3 (csrc/subtile_max.cu), K4b and K4a (csrc/extract_topm.cu) and K5
     (csrc/gather_score.cu) against their plain versions at the shapes of
     phase 5 (maxima and cosines within 1e-5, ids identical), timed in
     turns; and the block-max check: for every query and each of its
     selected subtiles, the best of phase b's blended scores equals K3's
     maximum bit for bit;
  7. the north-star serving shape, 1,000,000 x 768 with batches of 16,384:
     a serving state made on the card (N(0, 1) rows from a seeded
     torch.Generator, the feature Laplacian of the first 65,536 rows with
     k_f 15, lambdas from the port's own synthesis) in an ArrowSpace;
     mode="subtile", mode="exact" and mode="int8" (its first call
     quantizes the corpus: 768 MB of int8) timed over 2 batches each, the
     subtile and int8 top-15 overlaps with exact on 1,024 queries at least
     0.99, K3's time and the peak device memory;
  8. blocked-IVF and certified serving on phase 3's index: enable_ivf()
     (the build's own clustering), then search_batch(mode="ivf_block") and
     mode="certified" (n_probe 8) over phase 3's 8 batches, each after a
     warm-up, with the counts reset before each: K6 (csrc/ivf_scan.cu)
     must have run, and every certified query's ids must equal phase 3's
     exact ids outside near-ties of 1e-5.  The base certification rate
     and the widened and escalated queries are counted (the corpus is
     isotropic, so few queries certify; the results are exact anyway); K6
     against its plain version on the routed first batch, timed in turns;
  9. certified serving at 1,000,000 x 768, batches of 16,384, on a mixture
     corpus made on the card (4,096 centres, rows centre + 0.35 N(0, 1),
     queries a unit corpus row + 0.25 / sqrt(768) N(0, 1), as
     benchmarks/bench_serving.py makes them): enable_ivf(n_clusters=4096)
     clusters it, then mode="certified" over float32 and over bfloat16
     slabs and serving_stream(depth=4) over 4 batches (each batch equal to
     search_batch(mode="certified")); certified == exact (K2) on 1,024
     queries; the bf16 scan's scores within tau * (res_eps + 2F 2^-24) +
     1e-5 of float32 scores; K6 against its plain version; the clustering
     time, K, cap, slab GiB, base certification rate, QPS and peak device
     memory;
  10. int8 serving on phase 3's index: search_batch(mode="int8") over
     phase 3's 8 batches after a warm-up, the counts reset before: K7
     (csrc/scan_int8.cu) must have run; K7 against its plain version on
     the first batch (ids identical, scores bit for bit), timed in turns;
     the served ids equal phase 3's exact ids outside near-ties of 1e-5 on
     every query whose exact top-15 lies in K7's pool of 60;
  11. the bfloat16 serving view (as_serving) of that index: exact search
     over its 8 batches (K2 over bf16 rows must have run), K2-bf16 against
     its plain version on the first batch, timed in turns; the overlap with
     float32 exact (no rescore: at least 0.9);
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
     projection-sorted corpus (reorder), each against its plain version on 2,048 rows and bit for bit against phase
     3's lists on the 16,384 timed rows, timed in turns with its plain
     version; each against K1 in turns (and bit for bit) over a 65,536 x
     384 mixture corpus (4,096 centres); the 313,841 x 384 build under each
     of the four, whose lists, Laplacian and lambdas must be phase 3's bit
     for bit, with its build and knn seconds and its launches;
  15. the index lifecycle: ArrowSpaceBuilder.extend of phase 3's index by
     9,416 rows (N(0, 1) x 12, default_rng(43)), warm, against a rebuild of
     the 323,257 rows (lists, Laplacian, lambdas and tau* bit for bit);
     seeded K1 against its plain version on 2,048 old rows and timed on
     16,384; save_index / load_index of the extended index in a temporary
     directory (MB, seconds; exact search on the loaded index bitwise the
     saved one's); suggest_graph_params and emit_build_suggestions at 313k;
  4. reference parity on the card in float32: the README quickstart scores
     to 1e-6 and the four tests/data_test0.py orderings.

Phases 1, 2 and 6 also hold the wide lists (k 1,024) of K1, K2, K4b and
K4a against their plain versions and time them beside the narrow ones.

The line before the last is a JSON object with, for each kernel, its
launches on its main path (phase 3 for K1 and K2, phase 5's subtile run
for K3, K4a, K4b and K5, phase 8's certified run for K6, phase 10 for K7,
phase 11 for K2 over bf16 rows, phase 14's build under each variant for
K1t and K1's options, phase 15's extend for seeded K1), its largest
difference from the plain version, the kernel's and the plain version's
times, its bound (the larger of its operations over the H100's peak for
their type and its bytes over 3.35 TB/s, from this run's shapes; K5 and
K6 count the rows this run's routing reads, seeded K1 the new columns)
and the time of torch.topk where one PyTorch call computes the same
function (K4a, K4b; null elsewhere); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

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
K_WIDEST = 1024       # lists past 256: kept in place in device memory
MIN_OVERLAP = 0.99
N1M, F1M, Q1M, Q1M_CHECK = 1_000_000, 768, 16_384, 1024
N_PROBE, MIX_CLUSTERS, MIX_NOISE, Q_NOISE = 8, 4096, 0.35, 0.25
K_LONG, Q_LONG, K1_LONG_ROWS = 5000, 64, 8   # lists past the old 4,096
F_WIDE = 4096                                 # K6's query block per slab
N_MIX, N_EXTEND = 65_536, 9_416   # the variants' mixture corpus; a 3% append
OTHER_BATCHES, ENERGY_QUERIES, ENERGY_TOKENS = 2, 64, 40
MIN_BF16_OVERLAP = 0.9   # the bf16 view has no float32 rescore
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


def _bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time the card could take for a function: the larger of
    its operations over the peak rate of their type and the bytes it must
    move (each input read once, each output written once) over HBM's
    rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _reset_launches() -> None:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 ivf_scan, knn, knn_t,
                                                 scan_int8, scan_topk,
                                                 subtile_max)
    for mod in (knn, knn_t, scan_topk, subtile_max, gather_score, ivf_scan,
                scan_int8):
        mod.LAUNCHES = 0
    extract.IDS_LAUNCHES = extract.POOL_LAUNCHES = 0
    knn.SEEDED_LAUNCHES = knn.DIAG_START_LAUNCHES = knn.PERM_LAUNCHES = 0


def _launches() -> dict:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 ivf_scan, knn, knn_t,
                                                 scan_int8, scan_topk,
                                                 subtile_max)
    return {"knn": knn.LAUNCHES, "knn_t": knn_t.LAUNCHES,
            "knn_seeded": knn.SEEDED_LAUNCHES,
            "knn_diagstart": knn.DIAG_START_LAUNCHES,
            "knn_reorder": knn.PERM_LAUNCHES,
            "scan_topk": scan_topk.LAUNCHES,
            "subtile_max": subtile_max.LAUNCHES,
            "extract_ids": extract.IDS_LAUNCHES,
            "extract_pool": extract.POOL_LAUNCHES,
            "gather_score": gather_score.LAUNCHES,
            "ivf_scan": ivf_scan.LAUNCHES,
            "scan_int8": scan_int8.LAUNCHES}


def _overlap(ids_a: np.ndarray, ids_b: np.ndarray) -> float:
    """Mean share of each row's ids that both top-k lists hold."""
    same = (ids_a[:, :, None] == ids_b[:, None, :]).any(axis=2)
    return float(same.mean())


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
        "extract_ids": _in_turns(
            lambda: extract.extract_ids_plain(sub, s_keep),
            lambda: extract.extract_ids(sub, s_keep), torch),
        "gather_score": _in_turns(
            lambda: gather_score.gather_score_plain(xs, qs, sel),
            lambda: gather_score.gather_score(xs, qs, sel), torch),
        "extract_pool": _in_turns(
            lambda: extract.extract_pool_plain(score_b, cand, m_pool),
            lambda: extract.extract_pool(score_b, cand, m_pool), torch),
    }
    errs = {"subtile_max": err3, "extract_ids": 0.0 if sel_same else 1.0,
            "gather_score": err5, "extract_pool": 0.0 if pool_same else 1.0}
    # One PyTorch call computes the selects' function (torch.topk); none
    # computes a blended max per subtile or a gather-and-score.
    library = {"subtile_max": None, "gather_score": None}
    torch.topk(sub, s_keep, dim=1)
    library["extract_ids"] = _events_ms(
        lambda: torch.topk(sub, s_keep, dim=1), torch)
    torch.topk(score_b, m_pool, dim=1)
    library["extract_pool"] = _events_ms(
        lambda: torch.topk(score_b, m_pool, dim=1), torch)
    n_pad, f = xs.shape
    n_sub, elt = n_pad // 64, xs.element_size()
    kind = "bf16" if xs.dtype == torch.bfloat16 else "fp32"
    rows_read = int(torch.unique(sel).numel()) * 64
    width_b = score_b.shape[1]
    bounds = {
        "subtile_max": _bound(2.0 * q * n_pad * f, kind,
                              n_pad * (f * elt + 4) + q * (f * elt + 4)
                              + q * n_sub * 4),
        "extract_ids": _bound(q * n_sub, "fp32",
                              q * n_sub * 4 + q * s_keep * 4),
        "gather_score": _bound(2.0 * q * s_keep * 64 * f, kind,
                               rows_read * f * elt + q * f * elt
                               + q * s_keep * 4 + q * s_keep * 64 * 4),
        "extract_pool": _bound(q * width_b, "fp32",
                               q * width_b * 8 + q * m_pool * 4)}
    for name, (k_ms, p_ms) in times.items():
        results[name] = dict(max_abs_err=errs[name], ms=k_ms, plain_ms=p_ms,
                             library_ms=library[name], **bounds[name])
        print(f"phase 6: {name} Q={q} N_pad={xs.shape[0]} F={xs.shape[1]} "
              f"{xs.dtype}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms {card}")
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
        "extract_ids": _in_turns(
            lambda: extract.extract_ids_plain(sub, K_WIDEST),
            lambda: extract.extract_ids(sub, K_WIDEST), torch),
        "extract_pool": _in_turns(
            lambda: extract.extract_pool_plain(sub, cand, K_WIDEST),
            lambda: extract.extract_pool(sub, cand, K_WIDEST), torch)}
    narrow = {"extract_ids": _events_ms(
                  lambda: extract.extract_ids(sub, s_keep), torch),
              "extract_pool": _events_ms(
                  lambda: extract.extract_pool(sub, cand, m_pool), torch)}
    for name, (k_ms, p_ms) in wide_times.items():
        results.setdefault("wide", {})[name] = dict(
            k=K_WIDEST, ms=k_ms, plain_ms=p_ms, narrow_ms=narrow[name])
        print(f"phase 6: {name} at m={K_WIDEST} on {tuple(sub.shape)}: ids "
              f"identical {wide_same[name]}; kernel {k_ms:.3f} ms (narrow "
              f"{narrow[name]:.3f} ms), plain {p_ms:.3f} ms {card}")
    if not (err3 <= TOL and sentinels and sel_same and err5 <= TOL
            and pool_same and bitwise and n_checked == q * s_keep
            and all(wide_same.values())):
        raise AssertionError("subtile kernels disagree with their plain "
                             "versions or the block-max check failed")


def _phase_north_star(torch, dev, card, results) -> None:
    """Phase 7: subtile and exact serving at 1,000,000 x 768, batches of
    16,384, from a serving state made on the card (no graph build)."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph.feature import build_feature_laplacian
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops.cuda import subtile_max
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
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
    subtile_max.subtile_max(st["xu_scan"], st["lambdas"], qs, lamq, TAU,
                            st["n_real"])
    k3_ms = _events_ms(lambda: subtile_max.subtile_max(
        st["xu_scan"], st["lambdas"], qs, lamq, TAU, st["n_real"]), torch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    results["north_star"] = dict(qps=qps, overlap=overlap,
                                 overlap_int8=overlap_int8, k3_ms=k3_ms,
                                 peak_gib=peak)
    print(f"phase 7: top-{topk} overlap subtile vs exact on {Q1M_CHECK} "
          f"queries {overlap:.6f}; K3 alone {k3_ms:.3f} ms a batch of "
          f"{Q1M}; peak device memory {peak:.3f} GiB {card}")
    ok = all(np.all(np.isfinite(v)) and i.shape == (Q1M, topk)
             and i.min() >= 0 and i.max() < N1M
             for outs in served.values() for i, v in outs)
    del aspace, st, queries
    if not ok or overlap < MIN_OVERLAP or overlap_int8 < MIN_OVERLAP:
        raise AssertionError(f"1M serving check failed: results ok {ok}, "
                             f"overlap {overlap}, int8 {overlap_int8}")


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


def _k6_against_plain(torch, ivf, aspace, qb, k, label, card) -> tuple:
    """K6 against its plain version on the routed batch qb (the routing of
    the certified path: bound-ordered, blocks of 16), timed in turns.
    Returns (max_abs_err, kernel ms, plain ms, bound)."""
    from pyarrowspace_tpu_torch.ops import ivf_scan as tis
    from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    q32 = qb.to(torch.float32)
    lamq = _query_lambdas32(torch, aspace, q32)
    r = tis.route(ivf, unit_normalize(q32), lamq, tis._f32(TAU), qb=16,
                  n_probe=N_PROBE, use_bound=True)
    args = (ivf.slabs, ivf.slab_lambdas, ivf.slab_ids, r.qn_pad, r.lamq_pad,
            r.probe_tbl, TAU)
    kw = dict(k=k, q_block=16, cap=ivf.cap)
    s_k, i_k = k6.ivf_scan(*args, **kw)
    s_p, i_p = k6.ivf_scan_plain(*args, **kw)
    s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
    s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
    err = max_abs_err(s_k, s_p)
    bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
    k_ms, p_ms = _in_turns(lambda: k6.ivf_scan_plain(*args, **kw),
                           lambda: k6.ivf_scan(*args, **kw), torch)
    q_pad, f = r.qn_pad.shape
    probed = int(torch.unique(r.probe_tbl).numel())
    bound = _bound(2.0 * q_pad * N_PROBE * ivf.cap * f, "fp32",
                   probed * ivf.cap * (f * ivf.slabs.element_size() + 8)
                   + q_pad * (f * 4 + 4) + r.probe_tbl.numel() * 4
                   + q_pad * k * 8)
    print(f"{label}: K6 vs plain on {q_pad} routed queries x "
          f"{N_PROBE} probes x cap {ivf.cap} x F {f} "
          f"{ivf.slabs.dtype}, k {k}: max_abs_err {err:.3e}, disagreeing "
          f"queries {len(bad)}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
          f"{probed} distinct slabs probed) {card}")
    if bad or err > TOL:
        raise AssertionError(f"K6 disagrees with its plain version: queries "
                             f"{bad[:10]}, err {err}")
    return err, k_ms, p_ms, bound


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
    results["ivf_scan"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                               library_ms=None, **bound)
    results["certified_313k"] = dict(qps=qps, overlap=overlap, **summary)
    checks = {
        "K6 launched on the certified path":
            results["launches_certified"]["ivf_scan"] > 0,
        "certified == exact outside near-ties": bad == 0,
        "result shapes": all(o[0].shape == (Q_BATCH, topk)
                             and np.all(np.isfinite(o[1]))
                             for outs in got.values() for o in outs),
    }
    if not all(checks.values()):
        raise AssertionError(f"certified checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_certified_1m(torch, dev, card, results) -> None:
    """Phase 9: certified serving at 1,000,000 x 768, batches of 16,384, on
    a mixture corpus made on the card, over float32 and bfloat16 slabs,
    and the serving stream."""
    import pyarrowspace_tpu_torch as pt
    from pyarrowspace_tpu_torch.graph.feature import build_feature_laplacian
    from pyarrowspace_tpu_torch.ops import ivf_scan as tis
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.ops.rayleigh import (dispersion_batch,
                                                     rayleigh_batch)
    from pyarrowspace_tpu_torch.spectral.taumode import (
        TAU_MIX, derive_tau_star, synthesize)
    topk = GP["topk"]
    f32 = torch.float32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    centres = torch.randn((MIX_CLUSTERS, F1M), generator=gen, device=dev)
    mix = torch.randint(0, MIX_CLUSTERS, (N1M,), generator=gen, device=dev)
    x = centres[mix] + MIX_NOISE * torch.randn((N1M, F1M), generator=gen,
                                               device=dev)
    del centres, mix
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
    queries = []
    for _ in range(4):
        rows = torch.randint(0, N1M, (Q1M,), generator=gen, device=dev)
        queries.append(xu[rows] + (Q_NOISE / F1M ** 0.5) * torch.randn(
            (Q1M, F1M), generator=gen, device=dev))
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
        with _CertifiedCounts() as counts:
            t0 = time.perf_counter()
            got = [aspace.search_batch(b, None, TAU, topk=topk,
                                       mode="certified", n_probe=N_PROBE)
                   for b in queries]
            qps = 4 * Q1M / (time.perf_counter() - t0)
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
        out[name] = row
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    results["certified_1m"] = out
    print(f"phase 9: peak device memory {out['peak_gib']:.3f} GiB {card}")
    del aspace, ivf, queries, xu
    if not ok:
        raise AssertionError("1M certified serving checks failed")


def _query_lambdas32(torch, aspace, qb):
    """float32 query lambdas of a batch, as the serving paths make them."""
    from pyarrowspace_tpu_torch.ops import search as search_ops
    f32 = torch.float32
    return search_ops.query_lambdas(
        qb.to(f32), aspace._lap_f.to(f32), aspace._w_f.to(f32),
        aspace._tau_star.to(f32),
        rayleigh_normalized=aspace._rayleigh_normalized,
        tau_mix=aspace._tau_mix).to(f32).contiguous()


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
    k_ms, p_ms = _in_turns(lambda: scan_int8.scan_int8_plain(*args),
                           lambda: scan_int8.scan_int8(*args), torch)
    bound = _bound(2.0 * Q_BATCH * N * F, "int8",
                   N * (F + 8) + Q_BATCH * (F + 8) + Q_BATCH * m * 8)
    results["scan_int8"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                library_ms=None, **bound)
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
    print(f"phase 10: K7 Q={Q_BATCH} N={N} F={F} k={m}: ids identical "
          f"{same_ids}, scores max |diff| {err:.3e}; kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}) {card}")
    print(f"phase 10: top-{topk} overlap with exact {overlap:.6f}; exact "
          f"top-{topk} inside the pool of {m} for {covered} of "
          f"{N_BATCHES * Q_BATCH} queries, of which served != exact beyond "
          f"near-ties: {bad}")
    checks = {
        "K7 launched on the int8 path": launches["scan_int8"] > 0,
        "K7 ids == plain": same_ids, "K7 scores == plain": err == 0.0,
        "served == exact where the pool holds it": bad == 0,
        "result shapes": all(o[0].shape == (Q_BATCH, topk)
                             and np.all(np.isfinite(o[1])) for o in got)}
    if not all(checks.values()):
        raise AssertionError(f"int8 checks failed: "
                             f"{[c for c, ok in checks.items() if not ok]}")


def _phase_bf16_view(torch, aspace, gl, batches, outs_exact, card,
                     results) -> None:
    """Phase 11: exact search over the bfloat16 serving view (as_serving):
    K2 over bf16 rows against its plain version, QPS and the overlap with
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
    i_p, s_p = scan_topk.scan_plain(xb, lam, qn, lamq, TAU, topk)
    s_k, i_k, s_p, i_p = (t.cpu().numpy() for t in (s_k, i_k, s_p, i_p))
    bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
    err = max_abs_err(s_k, s_p)
    k_ms, p_ms = _in_turns(
        lambda: scan_topk.scan_plain(xb, lam, qn, lamq, TAU, topk),
        lambda: scan_topk.lambda_search(xb, lam, qn, lamq, TAU, topk), torch)
    bound = _bound(2.0 * Q_BATCH * N * F, "bf16",
                   N * (2 * F + 4) + Q_BATCH * ((F + 1) * 4 + topk * 8))
    results["scan_topk_bf16"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                     library_ms=None, **bound)
    results["bf16_313k"] = dict(qps=qps, overlap=overlap)
    print(f"phase 11: as_serving bf16 exact: {qps:.1f} QPS over {N_BATCHES} "
          f"x {Q_BATCH} queries (float32 exact {results['exact_qps']:.1f}); "
          f"top-{topk} overlap with float32 exact {overlap:.6f}; launches "
          f"{launches} {card}")
    print(f"phase 11: K2 over bf16 rows vs plain: max_abs_err {err:.3e}, "
          f"disagreeing queries {len(bad)}; kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}) {card}")
    checks = {"K2 launched on the bf16 path": launches["scan_topk"] > 0,
              "K2 bf16 == plain": not bad and err <= TOL,
              f"overlap >= {MIN_BF16_OVERLAP}": overlap >= MIN_BF16_OVERLAP,
              "result shapes": all(o[0].shape == (Q_BATCH, topk)
                                   and np.all(np.isfinite(o[1]))
                                   for o in got)}
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
          f"m={K_LONG} over {tuple(score.shape)}: ids identical {ids_same} / "
          f"{pool_same} {card}")
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
    s_k, i_k = ivf_scan.ivf_scan(*args, **kw)
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
    from pyarrowspace_tpu_torch.ops.cuda import knn
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
        results[name] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * K1_TIME_ROWS * N * F, "fp32",
                     N * F * 4 + K1_TIME_ROWS * k * 8))
        print(f"phase 14: {name} on {K1_CHECK_ROWS} rows vs plain: "
              f"max_abs_err {err:.3e}, disagreeing rows {len(bad)}; on "
              f"{K1_TIME_ROWS} rows: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bitwise K1: {not diff} {card}")
        if bad or err > TOL or diff:
            failed.append(name)
    del scans

    # A clustered corpus: the regime the locality variants were built for.
    gen = torch.Generator(device=xu.device)
    gen.manual_seed(3)
    centres = torch.randn((MIX_CLUSTERS, F), generator=gen, device=xu.device)
    mix = torch.randint(0, MIX_CLUSTERS, (N_MIX,), generator=gen,
                        device=xu.device)
    xm = unit_normalize(centres[mix] + MIX_NOISE * torch.randn(
        (N_MIX, F), generator=gen, device=xu.device)).contiguous()
    del centres, mix
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra, rg = pt.ArrowSpaceBuilder.build(GP, torch.cat([items, new]))
    t_rebuild = time.perf_counter() - t0
    rb_phases = pt.get_phase_timings()
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
          f" differing: {diff} {card}")
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
                 N_EXTEND * F * 4 + K1_TIME_ROWS * (F * 4 + 2 * k * 8)))
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
    if diff or bad or err > TOL or not life["served_same"]:
        raise AssertionError(f"lifecycle checks failed: differing {diff}, "
                             f"seeded rows {bad[:10]} err {err}, served "
                             f"same {life['served_same']}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
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
    from pyarrowspace_tpu_torch.ops.cuda import knn, scan_topk
    from pyarrowspace_tpu_torch.ops.cuda.compare import (max_abs_err,
                                                         topk_disagreements)
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize

    assert "jax" not in sys.modules, "the port must not import jax"
    dev = torch.device("cuda")
    failed: list[str] = []
    results: dict = {}

    # -- phase 0: device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    for name, secs in _build.load_all(KERNEL_SOURCES).items():
        print(f"phase 0: built csrc/{name}.cu in {secs:.3f} s {card}")
    print(f"phase 0: all kernels built in {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(42)
    items_host = rng.standard_normal((N, F), dtype=np.float32) * 12.0
    items = torch.from_numpy(items_host).to(dev)
    xu = unit_normalize(items).contiguous()

    # -- phase 1: K1 against its plain version --------------------------------
    try:
        k, eps = GP["k"], GP["eps"]
        out = {}
        full_ms = _events_ms(
            lambda: out.update(di=knn.knn_scan(xu, k, eps)), torch)
        d, i = out.pop("di")
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
        k_ms, p_ms = _in_turns(
            lambda: knn.knn_plain(xu, k, eps, rows=slice(0, K1_TIME_ROWS)),
            lambda: knn.knn_scan(xu, k, eps, 0, K1_TIME_ROWS), torch)
        results["knn"] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * K1_TIME_ROWS * N * F, "fp32",
                     N * F * 4 + K1_TIME_ROWS * k * 8))
        print(f"phase 1: K1 full corpus {N}x{F} k={k}: {full_ms:.3f} ms; "
              f"{K1_TIME_ROWS} rows: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms {card}")
        print(f"phase 1: K1 vs plain on {K1_CHECK_ROWS} rows: "
              f"max_abs_err {err:.3e}, disagreeing rows {len(bad)}; "
              f"bitwise d(i,j)==d(j,i) on {r.size} mutual pairs: {sym}")
        dw, iw = knn.knn_scan(xu, K1_WIDE, eps, 0, K1_CHECK_ROWS)
        dwp, iwp = knn.knn_plain(xu, K1_WIDE, eps,
                                 rows=slice(0, K1_CHECK_ROWS))
        bad_w = topk_disagreements(dw.cpu().numpy(), iw.cpu().numpy(),
                                   dwp.cpu().numpy(), iwp.cpu().numpy(), TOL)
        err_w = max_abs_err(dw.cpu().numpy(), dwp.cpu().numpy())
        print(f"phase 1: K1 at k={K1_WIDE} vs plain on {K1_CHECK_ROWS} rows: "
              f"max_abs_err {err_w:.3e}, disagreeing rows {len(bad_w)}")
        # The wide list (k > 256), in place in the output rows.
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
        results["wide"] = {"knn": dict(k=K_WIDEST, ms=wide_ms,
                                       plain_ms=wide_plain_ms,
                                       narrow_ms=narrow_ms)}
        print(f"phase 1: K1 at k={K_WIDEST} vs plain on {K1_CHECK_ROWS} "
              f"rows: max_abs_err {err_x:.3e}, disagreeing rows "
              f"{len(bad_x)}; kernel {wide_ms:.3f} ms (k={k}: "
              f"{narrow_ms:.3f} ms), plain {wide_plain_ms:.3f} ms {card}")
        results["knn"]["max_abs_err"] = max(err, err_w, err_x)
        if bad or err > TOL or not sym or r.size < 10_000 or bad_w \
                or err_w > TOL or bad_x or err_x > TOL:
            raise AssertionError(f"K1 check failed: rows {bad[:10]}, "
                                 f"err {err}, symmetric {sym}, "
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
        _reset_launches()
        t0 = time.perf_counter()
        warm, _ = pt.ArrowSpaceBuilder.build(GP, items)
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        aspace, gl = pt.ArrowSpaceBuilder.build(GP, items)
        t_build = time.perf_counter() - t0
        phases = pt.get_phase_timings()
        k1_build = knn.LAUNCHES
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
        results["exact_qps"] = qps
        print(f"phase 3: build {N}x{F}: warm-up {t_warm:.3f} s, timed "
              f"{t_build:.3f} s {card}")
        print(f"phase 3: build phases (s) "
              f"{json.dumps({kk: round(v, 4) for kk, v in phases.items()})}"
              f" {card}")
        print(f"phase 3: search_batch exact: {qps:.1f} QPS over "
              f"{N_BATCHES} x {Q_BATCH} queries, {t_search:.3f} s, "
              f"N={N} F={F} topk={GP['topk']} {card}")
        print(f"phase 3: launches on the main path {launches} "
              f"(K1 during the builds: {k1_build})")
        results["launches"] = launches
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
            "K2 launched on the main path": launches["scan_topk"] > 0,
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
        i_p, s_p = scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err = max_abs_err(s_k, s_p)
        k_ms, p_ms = _in_turns(
            lambda: scan_topk.scan_plain(xs, lams, qn, lam_q, TAU, topk),
            lambda: scan_topk.lambda_search(xs, lams, qn, lam_q, TAU, topk),
            torch)
        results["scan_topk"] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            **_bound(2.0 * Q_BATCH * N * F, "fp32",
                     N * (F + 1) * 4 + Q_BATCH * ((F + 1) * 4 + topk * 8)))
        print(f"phase 2: K2 Q={Q_BATCH} N={N} F={F} k={topk}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms {card}")
        print(f"phase 2: K2 vs plain: max_abs_err {err:.3e}, disagreeing "
              f"queries {len(bad)}")
        qw, lw = qn[:K2_WIDE_QUERIES], lam_q[:K2_WIDE_QUERIES]
        i_k, s_k = scan_topk.lambda_search(xs, lams, qw, lw, TAU, K2_WIDE)
        i_p, s_p = scan_topk.scan_plain(xs, lams, qw, lw, TAU, K2_WIDE)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad_w = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err_w = max_abs_err(s_k, s_p)
        print(f"phase 2: K2 at k={K2_WIDE} vs plain on {K2_WIDE_QUERIES} "
              f"queries: max_abs_err {err_w:.3e}, disagreeing queries "
              f"{len(bad_w)}")
        i_k, s_k = scan_topk.lambda_search(xs, lams, qw, lw, TAU, K_WIDEST)
        i_p, s_p = scan_topk.scan_plain(xs, lams, qw, lw, TAU, K_WIDEST)
        s_k, i_k = s_k.cpu().numpy(), i_k.cpu().numpy()
        s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        bad_x = topk_disagreements(s_k, i_k, s_p, i_p, TOL)
        err_x = max_abs_err(s_k, s_p)
        wide_ms, wide_plain_ms = _in_turns(
            lambda: scan_topk.scan_plain(xs, lams, qw, lw, TAU, K_WIDEST),
            lambda: scan_topk.lambda_search(xs, lams, qw, lw, TAU, K_WIDEST),
            torch)
        narrow_ms = _events_ms(
            lambda: scan_topk.lambda_search(xs, lams, qw, lw, TAU, topk),
            torch)
        results.setdefault("wide", {})["scan_topk"] = dict(
            k=K_WIDEST, ms=wide_ms, plain_ms=wide_plain_ms,
            narrow_ms=narrow_ms)
        print(f"phase 2: K2 at k={K_WIDEST} vs plain on {K2_WIDE_QUERIES} "
              f"queries: max_abs_err {err_x:.3e}, disagreeing queries "
              f"{len(bad_x)}; kernel {wide_ms:.3f} ms (k={topk}: "
              f"{narrow_ms:.3f} ms), plain {wide_plain_ms:.3f} ms {card}")
        results["scan_topk"]["max_abs_err"] = max(err, err_w, err_x)
        if bad or err > TOL or bad_w or err_w > TOL or bad_x or err_x > TOL:
            raise AssertionError(f"K2 check failed: queries {bad[:10]}, "
                                 f"err {err}, k={K2_WIDE} queries "
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
             lambda: _phase_certified_1m(torch, dev, card, results))):
        try:
            if aspace is None:
                raise RuntimeError("no index: phase 3 failed")
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(label)

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
