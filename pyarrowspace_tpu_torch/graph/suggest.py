"""Graph-parameter recommendation (eps / sigma / k) from data statistics
(port of pyarrowspace_tpu/graph/suggest.py).

Dimension-aware graph-consistency rates driven by the TwoNN intrinsic
dimension d,

    eps(n)   ~ (log n / n)^(2/(d+2))
    sigma(n) ~ (log n / n)^(1/(d+2))
    s(n)     ~ (n / log n)^(1/d)          (neighbour-count rate)

calibrated to the corpus's own rectified-cosine neighbour distances: eps
is the 90th percentile of the sampled k-th-NN distance at the recommended
k, sigma keeps the reference's observed sigma/eps ratio (0.535/1.31), and
k is the clamped neighbour rate.  The sample is the reference's
``default_rng(seed)`` draw; the k-th distances are values only, so no tie
order is involved.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ops.distance import unit_normalize
from ..reduction.pipeline import (SAMPLING_KEEP_RATE, k_search_range,
                                  twonn_intrinsic_dim)
from ..utils.logging import get_logger
from .build import resolve_device

log = get_logger("suggest")

SIGMA_EPS_RATIO = 0.41  # observed recommendation ratio (0.535 / 1.31)


def _rows(items, device) -> torch.Tensor:
    """The rows on the device ``resolve_device`` picks: the explicit one,
    else a tensor's own, else the card (raises without one)."""
    dev = resolve_device(items, device)
    if not isinstance(items, torch.Tensor):
        items = torch.as_tensor(np.asarray(items))
    return items.to(dev)


def suggest_graph_params(items, sample: int = 4096, seed: int = 42,
                         device=None) -> dict:
    """Recommend {eps, sigma, k, topk, p, intrinsic_dim, rates, n,
    nfeatures} for a corpus (a tensor or array-like).  Samples up to
    ``sample`` rows; O(sample^2) pairwise work on ``device`` (default: a
    tensor's own device, else the card; ``device="cpu"`` for the CPU)."""
    x = _rows(items, device)
    n, f = x.shape
    rng = np.random.default_rng(seed)
    if n > sample:
        sel = np.sort(rng.choice(n, size=sample, replace=False))
        x = x[torch.as_tensor(sel, device=x.device)]
    m = x.shape[0]

    idim, _ = twonn_intrinsic_dim(x, seed=seed)
    log_n = math.log(max(n, 3))
    rate_eps = (log_n / n) ** (2.0 / (idim + 2))
    rate_sigma = (log_n / n) ** (1.0 / (idim + 2))
    rate_k = (n / log_n) ** (1.0 / max(idim, 1))
    k_rec = int(np.clip(round(rate_k * 0.85), 4, 64))

    # Calibrate eps on the sampled k-th-NN rectified-cosine distances.
    xu = unit_normalize(x)
    d = 1.0 - torch.clamp_min(xu @ xu.T, 0.0)
    d = d.masked_fill(torch.eye(m, dtype=torch.bool, device=x.device),
                      math.inf)
    kk = min(k_rec, m - 1)
    kth = torch.topk(d, kk, dim=1, largest=False).values[:, -1]
    eps_rec = float(np.quantile(kth.cpu().numpy(), 0.90))
    sigma_rec = eps_rec * SIGMA_EPS_RATIO

    # topk ~ 0.6k mirrors the reference protocols' pairings (CVE and
    # MS MARCO both use k=25/topk=15); p=2.0 is the documented default.
    # The dict is directly buildable: ArrowSpaceBuilder.build(rec, x).
    rec = {
        "eps": round(eps_rec, 4),
        "sigma": round(sigma_rec, 4),
        "k": k_rec,
        "topk": max(2, int(round(k_rec * 0.6))),
        "p": 2.0,
        "intrinsic_dim": idim,
        "rates": {"eps": rate_eps, "sigma": rate_sigma, "k": rate_k},
        "n": n,
        "nfeatures": f,
    }
    log.info("suggested params for N=%d F=%d ID=%d: eps=%.4g sigma=%.4g "
             "k=%d", n, f, idim, eps_rec, sigma_rec, k_rec)
    return rec


def _ratio(cur, rec) -> str:
    if cur in (None, 0):
        return "(new)"
    return f"{rec / cur:.2f}x"


def format_suggestions_md(rec: dict, current: dict | None = None,
                          avg_norm: float | None = None,
                          build_log: list[str] | None = None) -> str:
    """Render a recommendation document in the reference's per-build
    suggested_eps.md layout: build-log header, current-vs-recommended
    table, dimension-aware rate insights, magnitude scenario table,
    warnings, action items."""
    cur = current or {}
    n, f, d = rec["n"], rec["nfeatures"], rec["intrinsic_dim"]
    log_n = math.log(max(n, 3))
    r = rec["rates"]
    lines = ["# what is the suggested eps and sigma for the graph "
             "described by these stats?", ""]
    for ln in build_log or []:
        lines.append(ln)
    if build_log:
        lines.append("")
    lines += [
        f"Based on your ArrowSpace configuration with **N={n:,} items**, "
        f"**F={f} features**, and **estimated intrinsic dimension={d}**, "
        "here are the recommended parameters:", "",
        "## Recommended Parameters", "",
        "| Parameter | Current | Recommended | Ratio |",
        "| :-- | :-- | :-- | :-- |",
        f"| **eps** | {cur.get('eps', 'None')} | **{rec['eps']}** | "
        f"{_ratio(cur.get('eps'), rec['eps'])} |",
        f"| **sigma** | {cur.get('sigma', 'None')} | **{rec['sigma']}** | "
        f"{_ratio(cur.get('sigma'), rec['sigma'])} |",
        f"| **k** | {cur.get('k', 'None')} | **{rec['k']}** | "
        f"{_ratio(cur.get('k'), rec['k'])} |",
        "| sampling | 0.6 | 0.6 | OK |", "",
        "## Key Insights", "",
        f"The Two-NN intrinsic dimension estimate is **{d}**: the "
        f"{f}-dimensional embeddings concentrate on a {d}-dimensional "
        "manifold, so the dimension-aware graph-consistency rates apply:",
        "",
        f"- eps(n) ~ (log n / n)^(2/(d+2)) = ({log_n:.2f}/{n})"
        f"^{2.0 / (d + 2):.3g} = {r['eps']:.4g}",
        f"- sigma(n) ~ (log n / n)^(1/(d+2)) = ({log_n:.2f}/{n})"
        f"^{1.0 / (d + 2):.3g} = {r['sigma']:.4g}",
        f"- s(n) ~ (n / log n)^(1/d) = ({n}/{log_n:.2f})"
        f"^(1/{max(d, 1)}) = {r['k']:.4g}",
        "",
        "The recommended eps is the rate calibrated to the corpus's own "
        "sampled k-NN rectified-cosine distances (90th percentile of the "
        f"k-th neighbor distance at k={rec['k']}); sigma keeps the "
        f"observed sigma/eps recommendation ratio {SIGMA_EPS_RATIO}.", "",
        "## Scenario Adjustments", "",
        "Parameters track data magnitude (normalise=false); recommended "
        "values per average L2 norm:", "",
        "| Data Type | avg_norm | eps | sigma | Notes |",
        "| :-- | :-- | :-- | :-- | :-- |",
    ]
    base_norm = avg_norm if avg_norm else 0.7
    for label, nrm, note in [
            ("This corpus" if avg_norm else "L2-normalized", base_norm,
             "Recommended baseline"),
            ("Unit vectors", 1.0, "If pre-normalized"),
            ("Unnormalized typical", 2.0, "May need rescaling"),
            ("Raw features", 5.0, "Definitely rescale")]:
        s = nrm / base_norm
        lines.append(f"| {label} | {nrm:.2g} | {rec['eps'] * s:.3g} | "
                     f"{rec['sigma'] * s:.3g} | {note} |")
    lines += ["", "## Warnings", ""]
    if cur.get("eps") is not None and cur["eps"] < 0.85 * rec["eps"]:
        lines.append(
            f"- Current eps={cur['eps']} is LOW: with {n:,} items on a "
            f"{d}D manifold, eps~{rec['eps']} maintains connectivity as "
            "neighborhoods shrink.")
    if cur.get("eps") is not None and cur["eps"] > 1.5 * rec["eps"]:
        lines.append(
            f"- Current eps={cur['eps']} is HIGH: the eps ball admits "
            "far neighbors and the graph over-connects; expect flatter "
            "lambdas.")
    if cur.get("k") is not None and cur["k"] < rec["k"]:
        lines.append(
            f"- Current k={cur['k']} is LOW: theory recommends "
            f"k ~ 2 log(n) = {rec['k']} for connected graphs with high "
            "probability.")
    if lines[-1] == "":
        lines.append("- No parameter warnings for this configuration.")
    lines += [
        "", "## Action Items", "",
        "1. Compute the average L2 norm of the data to pick the scenario "
        "row that applies.",
        "2. If avg_norm < 0.1 or > 10, rescale the data first: taumode "
        "lambdas collapse to 0.0 on magnitude/eps mismatch.",
        f"3. Set eps = {rec['eps']} (conservative floor: "
        f"{0.88 * rec['eps']:.3g}).",
        f"4. Set sigma = {rec['sigma']} for the Gaussian kernel edge "
        "weighting.",
        f"5. Set k = {rec['k']} (resource-constrained floor: "
        f"{max(4, int(rec['k'] * 0.7))}).", "",
    ]
    return "\n".join(lines)


def emit_build_suggestions(items, gp, out_dir: str,
                           build_log: list[str] | None = None,
                           device=None) -> str:
    """Write the per-build suggested_eps.md artifact (opt-in via
    ARROWSPACE_SUGGEST_DIR; called from the standard build pipeline), with
    the work on ``device`` as in ``suggest_graph_params``.  Returns the
    written path."""
    x = _rows(items, device)
    rec = suggest_graph_params(x)
    head = x[: min(4096, x.shape[0])].cpu().numpy()
    norms = np.linalg.norm(head, axis=1)
    current = {"eps": gp.eps, "sigma": gp.sigma, "k": gp.k}
    # Clustering-stage trace in the artifact header, like the reference's
    # build-log lines (sampler keep rate, TwoNN ID, the K range tested).
    n_keep = max(2, int(round(x.shape[0] * SAMPLING_KEEP_RATE)))
    k_lo, k_hi = k_search_range(n_keep, rec["intrinsic_dim"], gp.eps)
    trace = [
        f"Simple random sampler with keep rate {SAMPLING_KEEP_RATE:.0%}",
        "Auto-computing optimal clustering parameters",
        f"Computing optimal K for clustering: N={x.shape[0]}, "
        f"F={x.shape[1]}",
        f"Intrinsic dimension estimate: {rec['intrinsic_dim']}",
        f"Testing K in range [{k_lo}, {k_hi}] with step 1",
    ]
    doc = format_suggestions_md(rec, current=current,
                                avg_norm=float(norms.mean()),
                                build_log=(build_log or []) + trace)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "suggested_eps.md")
    with open(path, "w") as fh:
        fh.write(doc)
    log.info("wrote %s", path)
    return path
