"""The build loop: ``ArrowSpaceBuilder.build`` on the device-resident corpus,
back to back, each build after the last one's index is freed.

Traffic keys: "warmup" (builds in set-up), "warmup_rows" (the rows of each
warm-up build: the first rows of the corpus, at the cell's width; on an
H100 the first full build of a process is ~1.4 s slower than the next ones,
and a first build of 65,536 rows takes that cost instead),
"check_pairs" (the row-to-corpus distances that the check of the
last build's k-NN lists may compute: every row where that covers them,
else whole 128-row blocks, the last one always among them) and "ell_rows"
(rows of those whose ELL rows are held to the reference).
"""

from __future__ import annotations

from dataclasses import dataclass

from harness import checks, corpus
from harness.trace import STEP, record

GIB = float(1 << 30)


@dataclass
class State:
    ctx: object
    x: object
    last: object = None
    kept: dict = None


def _sync(ctx):
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)


def shapes(ctx) -> dict:
    cfg = ctx.config
    n, f = int(cfg["n_items"]), int(cfg["n_features"])
    k = int(cfg["graph_params"]["k"])
    return {"n": n, "f": f, "k": max(1, min(k, n - 1))}


def setup(ctx) -> State:
    x, _ = corpus.make_corpus(ctx.torch, ctx.device, ctx.config, ctx.seed)
    st = State(ctx=ctx, x=x)
    warm = State(ctx=ctx, x=x[:int(ctx.traffic["warmup_rows"])])
    for _ in range(int(ctx.traffic["warmup"])):
        step(warm)
    del warm
    _sync(ctx)
    return st


def step(st: State) -> dict:
    ctx, torch = st.ctx, st.ctx.torch
    st.last = None                      # the index of the step before
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    with record(STEP):
        index = ctx.program.ArrowSpaceBuilder.build(
            ctx.config["graph_params"], st.x)
        _sync(ctx)
    st.last = index
    return {"builds": 1,
            "peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                           if cuda else 0),
            "phases": ctx.program.get_phase_timings()}


def end_to_end(win) -> dict:
    return {"build_s": win.seconds / len(win.records),
            "build_peak_gib": max(r["peak_bytes"] for r in win.records) / GIB}


def counts(win) -> tuple[int, int]:
    """(attempted, failed): builds started and builds that gave no index."""
    return len(win.records), 0


def finish(st: State) -> None:
    """Keep of the last build what the check reads (its lists, the sampled
    rows' distances and ELL rows, the width, the lambdas) and free the
    rest of the program's state."""
    torch, ctx = st.ctx.torch, st.ctx
    aspace, gl = st.last
    n = aspace.nitems
    tr = ctx.traffic
    rows = torch.as_tensor(checks.block_rows(n, float(tr["check_pairs"]),
                                             ctx.seed), device=ctx.device)
    ell_rows = rows[torch.as_tensor(
        checks.sample_rows(rows.shape[0], int(tr["ell_rows"]), ctx.seed + 1),
        device=ctx.device)]
    st.kept = {
        "rows": rows, "ell_rows": ell_rows,
        "lists": aspace._knn_idx.clone(),
        "dists": aspace._knn_dist[rows].clone(),
        "ell_idx": gl.neighbor_indices[ell_rows].clone(),
        "ell_w": gl.neighbor_weights[ell_rows].clone(),
        "lambdas": aspace._lambdas.clone(),
    }
    st.last = None
    st.x = None
    del aspace, gl
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def numbers(st: State, control: bool = False) -> dict:
    """The check's numbers: the kept outputs of the last build against the
    reference.  With ``control`` the reference in TF32 stands in the
    program's place (its lists, ELL weights and lambdas)."""
    import reference.graph as rg
    from reference import spectral
    ctx, torch = st.ctx, st.ctx.torch
    cfg, kept = ctx.config, st.kept
    gp = cfg["graph_params"]
    k, eps, p = int(gp["k"]), float(gp["eps"]), float(gp["p"])
    sigma = gp["sigma"] if gp.get("sigma") is not None else eps * 0.5
    x, _ = corpus.make_corpus(torch, ctx.device, cfg, ctx.seed)
    xu64 = rg.unit_rows(x, torch.float64)
    rows, ell_rows = kept["rows"], kept["ell_rows"]
    if control:
        with checks.tf32(torch, True):
            xu32 = rg.unit_rows(x, torch.float32)
            d_prog, i_prog = rg.knn_rows(xu32, rows, k, eps)
            want = rg.ell_rows(kept["lists"], ell_rows,
                               kept["ell_idx"].shape[1], xu32, sigma, p)
            lam = spectral.index_state(x, gp, final_dtype=torch.float32)[
                "lambdas"]
            del xu32
        ell_idx = torch.full_like(kept["ell_idx"], -1)
        ell_w = torch.zeros_like(kept["ell_w"])
        for t, (cols, ws) in enumerate(want):
            ell_idx[t, :cols.numel()] = cols.to(ell_idx.dtype)
            ell_w[t, :cols.numel()] = ws.to(ell_w.dtype)
    else:
        d_prog, i_prog = kept["dists"], kept["lists"][rows]
        ell_idx, ell_w, lam = kept["ell_idx"], kept["ell_w"], kept["lambdas"]
    dist_gap, id_gap = checks.knn_gaps(torch, xu64, rows, k, eps, d_prog,
                                       i_prog)
    out = {"knn_dist_gap": dist_gap, "knn_id_gap": id_gap,
           "ell_gap": checks.ell_gap(torch, kept["lists"], ell_rows, ell_idx,
                                     ell_w, xu64, sigma, p)}
    del xu64
    ref = spectral.index_state(x, gp)
    out["lambda_gap"] = checks.lambda_gap(torch, lam, ref["lambdas"])
    return out
