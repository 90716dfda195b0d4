"""Smoke run of the PyTorch/CUDA port (pyarrowspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, PyTorch built for CUDA and nvcc; it imports
no JAX.  Phases (each one that fails makes the script exit non-zero):

  0. device and build: the card's name and power limit, torch and CUDA
     versions, and the nvcc build time of each kernel;
  1. K1 (csrc/knn.cu) against its plain version on a 313,841 x 384 unit
     corpus (eps 1.31, k 25): 2,048 random rows, distances within 1e-5 and
     ids equal up to near-ties; d(i, j) == d(j, i) bitwise on 10,000 kept
     mutual pairs; kernel and plain timed on the same 16,384 rows;
  3. the main path: ArrowSpaceBuilder.build at 313,841 x 384 with the CVE
     graph params (a warm-up build, then a timed one), search_batch(
     mode="exact") over 8 batches of 4,096 queries, 3 single searches.
     Launch counts are reset just before and read just after: both
     kernels must have run.  The Laplacian must be exactly symmetric,
     every lambda finite in [0, 1], and no edge dropped;
  2. K2 (csrc/scan_topk.cu) against its plain version on the built index:
     4,096 queries, tau 0.62, k 15, scores within 1e-5;
  4. reference parity on the card in float32: the README quickstart scores
     to 1e-6 and the four tests/data_test0.py orderings.

The line before the last is a JSON object with each kernel's launches on
the main path, its largest difference from the plain version, and both
times; the last line is {"ok": true, "device": {...}}.
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


def main() -> int:
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
    for name in ("knn", "scan_topk"):
        t0 = time.perf_counter()
        _build.load(name)
        print(f"phase 0: built csrc/{name}.cu in "
              f"{time.perf_counter() - t0:.3f} s {card}")

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
        if bad or err > TOL or not sym or r.size < 10_000:
            raise AssertionError(f"K1 check failed: rows {bad[:10]}, "
                                 f"err {err}, symmetric {sym}, "
                                 f"pairs {r.size}")
        del d, i, dp, ip
    except Exception:
        traceback.print_exc()
        failed.append("phase 1 (K1 vs plain)")

    # -- phase 3: the main path -----------------------------------------------
    aspace = gl = batches = None
    try:
        knn.LAUNCHES = 0
        scan_topk.LAUNCHES = 0
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
        launches = {"knn": knn.LAUNCHES, "scan_topk": scan_topk.LAUNCHES}
        qps = Q_BATCH * N_BATCHES / t_search
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
        if bad or err > TOL:
            raise AssertionError(f"K2 check failed: queries {bad[:10]}, "
                                 f"err {err}")
    except Exception:
        traceback.print_exc()
        failed.append("phase 2 (K2 vs plain)")

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

    if failed or "launches" not in results:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "knn", "route": "cuda",
         "source": "pyarrowspace_tpu_torch/csrc/knn.cu",
         "replaces": "pyarrowspace_tpu/ops/pallas/knn.py:247",
         "launches": results["launches"]["knn"], **results["knn"]},
        {"name": "scan_topk", "route": "cuda",
         "source": "pyarrowspace_tpu_torch/csrc/scan_topk.cu",
         "replaces": "pyarrowspace_tpu/ops/pallas/scan_topk.py:75",
         "launches": results["launches"]["scan_topk"],
         **results["scan_topk"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
