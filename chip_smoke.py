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
     every lambda finite in [0, 1], and no edge dropped;
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
     mode="subtile" and mode="exact" timed over 2 batches each, their
     top-15 overlap on 1,024 queries at least 0.99, K3's time and the
     peak device memory;
  4. reference parity on the card in float32: the README quickstart scores
     to 1e-6 and the four tests/data_test0.py orderings.

The line before the last is a JSON object with each kernel's launches on
its main path (phase 3 for K1 and K2, phase 5's subtile run for the
others), its largest difference from the plain version, and both times;
the last line is {"ok": true, "device": {...}}.
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
MIN_OVERLAP = 0.99
N1M, F1M, Q1M, Q1M_CHECK = 1_000_000, 768, 16_384, 1024
KERNEL_SOURCES = ("knn", "scan_topk", "subtile_max", "extract_topm",
                  "gather_score")
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


def _reset_launches() -> None:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score, knn,
                                                 scan_topk, subtile_max)
    for mod in (knn, scan_topk, subtile_max, gather_score):
        mod.LAUNCHES = 0
    extract.IDS_LAUNCHES = extract.POOL_LAUNCHES = 0


def _launches() -> dict:
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score, knn,
                                                 scan_topk, subtile_max)
    return {"knn": knn.LAUNCHES, "scan_topk": scan_topk.LAUNCHES,
            "subtile_max": subtile_max.LAUNCHES,
            "extract_ids": extract.IDS_LAUNCHES,
            "extract_pool": extract.POOL_LAUNCHES,
            "gather_score": gather_score.LAUNCHES}


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
    from pyarrowspace_tpu_torch.ops import search as search_ops
    from pyarrowspace_tpu_torch.ops import subtile_scan
    from pyarrowspace_tpu_torch.ops.cuda import (extract, gather_score,
                                                 subtile_max)
    from pyarrowspace_tpu_torch.ops.cuda.compare import max_abs_err
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    f32 = torch.float32
    st = aspace._subtile
    xs, lam, n_real = st["xu_scan"], st["lambdas"], st["n_real"]
    qb = batches[0].to(f32)
    lamq = search_ops.query_lambdas(
        qb, aspace._lap_f.to(f32), aspace._w_f.to(f32),
        aspace._tau_star.to(f32),
        rayleigh_normalized=aspace._rayleigh_normalized,
        tau_mix=aspace._tau_mix).to(f32).contiguous()
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
    for name, (k_ms, p_ms) in times.items():
        results[name] = dict(max_abs_err=errs[name], ms=k_ms, plain_ms=p_ms)
        print(f"phase 6: {name} Q={q} N_pad={xs.shape[0]} F={xs.shape[1]} "
              f"{xs.dtype}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms {card}")
    print(f"phase 6: K3 max_abs_err {err3:.3e} over {real} real subtiles, "
          f"sentinels equal {sentinels}; K4b ids identical {sel_same} "
          f"(S={s_keep}); K5 max_abs_err {err5:.3e}; K4a ids identical "
          f"{pool_same} (m={m_pool}); block max bitwise equal {bitwise} on "
          f"{n_checked} selected subtiles")
    if not (err3 <= TOL and sentinels and sel_same and err5 <= TOL
            and pool_same and bitwise and n_checked == q * s_keep):
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
    results["north_star"] = dict(qps=qps, overlap=overlap, k3_ms=k3_ms,
                                 peak_gib=peak)
    print(f"phase 7: top-{topk} overlap subtile vs exact on {Q1M_CHECK} "
          f"queries {overlap:.6f}; K3 alone {k3_ms:.3f} ms a batch of "
          f"{Q1M}; peak device memory {peak:.3f} GiB {card}")
    ok = all(np.all(np.isfinite(v)) and i.shape == (Q1M, topk)
             and i.min() >= 0 and i.max() < N1M
             for outs in served.values() for i, v in outs)
    del aspace, st, queries
    if not ok or overlap < MIN_OVERLAP:
        raise AssertionError(f"1M serving check failed: results ok {ok}, "
                             f"overlap {overlap}")


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
        results["knn"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
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
        results["knn"]["max_abs_err"] = max(err, err_w)
        if bad or err > TOL or not sym or r.size < 10_000 or bad_w \
                or err_w > TOL:
            raise AssertionError(f"K1 check failed: rows {bad[:10]}, "
                                 f"err {err}, symmetric {sym}, "
                                 f"pairs {r.size}, k={K1_WIDE} rows "
                                 f"{bad_w[:10]} err {err_w}")
        del d, i, dp, ip, dw, iw, dwp, iwp
    except Exception:
        traceback.print_exc()
        failed.append("phase 1 (K1 vs plain)")

    # -- phase 3: the main path -----------------------------------------------
    aspace = gl = batches = src = outs = None
    try:
        _reset_launches()
        t0 = time.perf_counter()
        pt.ArrowSpaceBuilder.build(GP, items)
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        aspace, gl = pt.ArrowSpaceBuilder.build(GP, items)
        t_build = time.perf_counter() - t0
        phases = pt.get_phase_timings()
        k1_build = knn.LAUNCHES
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
              f"{top1}; single searches agree with the batch: {single_same}")
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
        results["scan_topk"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
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
        results["scan_topk"]["max_abs_err"] = max(err, err_w)
        print(f"phase 2: K2 at k={K2_WIDE} vs plain on {K2_WIDE_QUERIES} "
              f"queries: max_abs_err {err_w:.3e}, disagreeing queries "
              f"{len(bad_w)}")
        if bad or err > TOL or bad_w or err_w > TOL:
            raise AssertionError(f"K2 check failed: queries {bad[:10]}, "
                                 f"err {err}, k={K2_WIDE} queries "
                                 f"{bad_w[:10]} err {err_w}")
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
             lambda: _phase_north_star(torch, dev, card, results))):
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
    if failed or "launches" not in results or "launches_subtile" not in results:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    pallas = "pyarrowspace_tpu/ops/pallas/"
    table = (  # name, source, TPU kernel, the path whose launches count
        ("knn", "knn.cu", "knn.py:247", "launches"),
        ("scan_topk", "scan_topk.cu", "scan_topk.py:75", "launches"),
        ("subtile_max", "subtile_max.cu", "subtile_scan.py:59",
         "launches_subtile"),
        ("extract_ids", "extract_topm.cu", "subtile_scan.py:266",
         "launches_subtile"),
        ("extract_pool", "extract_topm.cu", "subtile_scan.py:220",
         "launches_subtile"),
        ("gather_score", "gather_score.cu", "subtile_scan.py:131",
         "launches_subtile"),
    )
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"pyarrowspace_tpu_torch/csrc/{source}",
         "replaces": pallas + tpu, "launches": results[path][name],
         **results[name]}
        for name, source, tpu, path in table]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
