"""The serve_energy loop: a closed loop of ``ArrowSpace.search_energy_batch``
calls over the energy index that set-up built
(``ArrowSpaceBuilder.build_energy`` with the config's "energy_params"), one
batch of queries at a time, the next batch sent when the last one's results
are on the host as numpy.

Traffic keys: "batch" (queries a call), "batches" (distinct batches made
from the seed, sent in turn), "check_rows" (rows of each batch whose
answers are kept and held to the reference), "batch_source" (where the
batch size comes from; not read).  The search's k and weights are the
config's "search".  Each step also reports ``routed_items``, the items in
its batch's routed pools (the work of the scan), counted once a distinct
batch in set-up from the index's own energy maps by the reference's
routing, so that it reads any version of the program.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from harness import checks, corpus
from harness.trace import STEP, record
from harness.window import percentile, rate
from reference import energy as ref_energy
from reference.serve import topk as ref_topk

# A query's candidate_m-th and next energy node whose reference distances
# lie within 64 float32 ulps of 1 of each other (the distances lie in [0,
# w_l + w_d]) could fall either way in the program's float32 routing: such
# a row is held to both pools.
ROUTE_TIE = 64 * 2.0 ** -23


@dataclass
class State:
    ctx: object
    aspace: object = None
    gl: object = None
    queries: list = None
    keep: list = None
    routed: list = None
    turn: int = 0
    kept: list = field(default_factory=list)


def _search_params(ctx):
    s = ctx.config["search"]
    return int(s["k"]), float(s["w_lambda"]), float(s["w_dirichlet"])


def shapes(ctx) -> dict:
    cfg = ctx.config
    n, f = int(cfg["n_items"]), int(cfg["n_features"])
    n_keys = int(cfg["energy_params"]["optical_tokens"]) + 1
    return {"n": n, "f": f, "q": int(ctx.traffic["batch"]),
            "topk": min(_search_params(ctx)[0], n),
            "bitmap_bytes": -(-n_keys // 8)}


def _probe(ctx, n_nodes: int) -> int:
    return min(int(ctx.config["energy_params"]["candidate_m"]), n_nodes)


def _program_state(aspace) -> dict:
    """The routing terms of the program's index, as reference/energy.py's
    state names them."""
    em = aspace._energy_maps
    return dict(nodes=em.nodes, node_lambda=em.node_lambda,
                node_e=em.node_dirichlet, node_centroid=em.node_centroid,
                lap_f=aspace._lap_f, w_f=aspace._w_f,
                tau_star=aspace._tau_star,
                n_centroids=int(aspace._centroids.shape[0]))


def setup(ctx) -> State:
    torch, dev, cfg, tr = ctx.torch, ctx.device, ctx.config, ctx.traffic
    x, centres = corpus.make_corpus(torch, dev, cfg, ctx.seed)
    st = State(ctx=ctx)
    st.aspace, st.gl = ctx.program.ArrowSpaceBuilder.build_energy(
        x, cfg["energy_params"], cfg["graph_params"])
    st.queries = corpus.make_queries(torch, dev, cfg, ctx.seed, x, centres,
                                     int(tr["batches"]), int(tr["batch"]))
    del x, centres
    st.keep = [checks.sample_rows(int(tr["batch"]), int(tr["check_rows"]),
                                  ctx.seed + 1 + b)
               for b in range(len(st.queries))]
    ps = _program_state(st.aspace)
    keys = ref_energy.route_keys(st.aspace._assignments, ps["n_centroids"])
    _, w_l, w_d = _search_params(ctx)
    probe = _probe(ctx, int(ps["nodes"].shape[0]))
    st.routed = [ref_energy.routed_items(qb, ps, keys, w_l, w_d, probe)
                 for qb in st.queries]
    _search(st, 0)       # the batches' one shape, and the search's state
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def _search(st: State, b: int):
    k, w_l, w_d = _search_params(st.ctx)
    return st.aspace.search_energy_batch(st.queries[b], st.gl, k, w_l, w_d)


def step(st: State) -> dict:
    b = st.turn % len(st.queries)
    st.turn += 1
    with record(STEP):
        ids, scores = _search(st, b)
    ids, scores = np.asarray(ids), np.asarray(scores)
    q = st.queries[b].shape[0]
    rows = st.keep[b]
    got = rows < ids.shape[0]
    k = shapes(st.ctx)["topk"]
    kid = np.full((rows.shape[0], k), -1, dtype=np.int64)
    ksc = np.full((rows.shape[0], k), np.nan, dtype=np.float64)
    w = min(k, ids.shape[1]) if ids.ndim == 2 else 0
    kid[got, :w] = ids[rows[got], :w]
    ksc[got, :w] = scores[rows[got], :w]
    st.kept.append((b, kid, ksc))
    return {"queries": q, "answered": int(min(q, ids.shape[0])),
            "routed_items": st.routed[b]}


def end_to_end(win) -> dict:
    return {"qps": rate(win.total("answered"), win.seconds),
            "batch_p95_ms": percentile(win.latencies(), 95) * 1e3}


def counts(win) -> tuple[int, int]:
    """(attempted, failed): queries sent and queries with no answer."""
    sent = int(win.total("queries"))
    return sent, sent - int(win.total("answered"))


def finish(st: State) -> None:
    """Free the program's state; the kept answers stay."""
    st.aspace = st.gl = None
    if st.ctx.device.type == "cuda":
        st.ctx.torch.cuda.empty_cache()


def _pool_masks(torch, state, keys, lam_q, e_q, ql, k: int, probe: int,
                w_l: float, w_d: float, batch_short: bool):
    """([Q, n] admitted items of each query's pool, [Q, n] of the pool with
    its candidate_m-th and next nodes swapped, [Q] rows where those two lie
    within ROUTE_TIE).  ``batch_short``: some query of the batch has a pool
    short of k, and every query scans every item."""
    dist = ref_energy.node_distances(lam_q, e_q, ql, state, w_l, w_d)
    d_sorted, order = torch.sort(dist, dim=1, stable=True)
    nq, m = dist.shape
    n_cent = state["n_centroids"]
    if batch_short:
        every = torch.ones((nq, keys.shape[0]), dtype=torch.bool,
                           device=keys.device)
        return every, every, torch.zeros(nq, dtype=torch.bool,
                                         device=keys.device)
    hit = ref_energy.pools(order, state["node_centroid"], n_cent, probe)
    if probe < m:
        tie = (d_sorted[:, probe] - d_sorted[:, probe - 1]) <= ROUTE_TIE
        alt = order.clone()
        alt[:, [probe - 1, probe]] = order[:, [probe, probe - 1]]
        hit_alt = ref_energy.pools(alt, state["node_centroid"], n_cent,
                                   probe)
    else:
        tie = torch.zeros(nq, dtype=torch.bool, device=keys.device)
        hit_alt = hit
    return hit[:, keys], hit_alt[:, keys], tie


def _row_numbers(torch, full, pool, r, ids_t, sc_t, k: int):
    """Per answer row (answer j to unique query r[j]) against the
    reference scores ``full`` [U, n] over ``pool`` [U, n]: (bad, score
    gap, rank gap, hits), each [A]."""
    n = full.shape[1]
    best, best_ids = ref_topk(torch.where(pool, full, -torch.inf), k)
    valid = (ids_t >= 0) & (ids_t < n)
    safe = torch.clamp(ids_t, 0, n - 1)
    rows = r[:, None]
    inside = valid & pool[rows, safe]
    s = torch.sort(ids_t, dim=1).values
    rep = (s[:, 1:] == s[:, :-1]).any(dim=1)
    bad = (~inside).any(dim=1) | rep | (ids_t.shape[1] < k)
    at = torch.where(inside, full[rows, safe], -torch.inf)
    g = torch.where(inside, (sc_t - at).abs(), 0.0)
    score_gap = torch.nan_to_num(g, nan=checks.BIG).max(dim=1).values
    w = ids_t.shape[1]
    lag = torch.where(inside, torch.clamp_min(best[r][:, :w] - at, 0.0), 0.0)
    hits = (ids_t[:, :, None] == best_ids[r][:, None, :]).any(dim=2).sum(
        dim=1)
    return bad, score_gap, lag.max(dim=1).values, hits


def numbers(st: State, control: bool = False) -> dict:
    """The check's numbers: every kept answer against the float64
    reference's energy top-k of the query's routed pool (a row whose
    routing is a near-tie at its candidate_m-th node, against whichever of
    its two pools it fits better).  With ``control`` the reference in
    float32 with TF32 products (its own routing, the same discrete build
    choices) answers each kept query once, in the program's place."""
    ctx, torch = st.ctx, st.ctx.torch
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    k, w_l, w_d = _search_params(ctx)
    k = min(k, int(cfg["n_items"]))
    x, centres = corpus.make_corpus(torch, dev, cfg, ctx.seed)
    qs = corpus.make_queries(torch, dev, cfg, ctx.seed, x, centres,
                             int(tr["batches"]), int(tr["batch"]))
    gp, ep = cfg["graph_params"], cfg["energy_params"]
    with checks.tf32(torch, False):
        _, choices = ref_energy.build(x, gp, ep, torch.float32)
        ref, _ = ref_energy.build(x, gp, ep, torch.float64, choices)
    keys = ref_energy.route_keys(ref["assignments"], ref["n_centroids"])
    counts = torch.bincount(keys, minlength=ref["n_centroids"] + 1)
    probe = _probe(ctx, int(ref["nodes"].shape[0]))
    uq, masks, ties = [], [], 0
    for b, qb in enumerate(qs):
        lam_q, e_q, ql = ref_energy.query_terms(qb, ref)
        order = torch.sort(ref_energy.node_distances(
            lam_q, e_q, ql, ref, w_l, w_d), dim=1, stable=True).indices
        pool_n = (ref_energy.pools(order, ref["node_centroid"],
                                   ref["n_centroids"], probe)
                  * counts).sum(dim=1)
        rows = torch.as_tensor(st.keep[b], device=dev)
        uq.append(qb[rows])
        masks.append(_pool_masks(torch, ref, keys, lam_q[rows], e_q[rows],
                                 ql[rows], k, probe, w_l, w_d,
                                 bool((pool_n < k).any())))
    uq = torch.cat(uq)
    pool_a = torch.cat([m[0] for m in masks])
    pool_b = torch.cat([m[1] for m in masks])
    tie = torch.cat([m[2] for m in masks])
    del masks
    base = np.cumsum([0] + [len(r) for r in st.keep])
    if control:
        with checks.tf32(torch, True):
            c32, _ = ref_energy.build(x, gp, ep, torch.float32, choices)
            ids, scs = [], []
            for s in range(0, uq.shape[0], 64):
                lam_q, e_q, ql = ref_energy.query_terms(uq[s:s + 64], c32)
                order = torch.sort(ref_energy.node_distances(
                    lam_q, e_q, ql, c32, w_l, w_d), dim=1,
                    stable=True).indices
                hit = ref_energy.pools(order, c32["node_centroid"],
                                       c32["n_centroids"], probe)[:, keys]
                sc = ref_energy.scores(x, c32, lam_q, e_q, ql, w_l, w_d)
                v, i = ref_topk(torch.where(hit, sc, -torch.inf), k)
                ids.append(i.cpu().numpy())
                scs.append(v.double().cpu().numpy())
        del c32
        which = np.arange(uq.shape[0])
        ids, scs = np.concatenate(ids), np.concatenate(scs)
    else:
        which = np.concatenate([base[b] + np.arange(kid.shape[0])
                                for b, kid, _ in st.kept])
        ids = np.concatenate([kid for _, kid, _ in st.kept])
        scs = np.concatenate([ksc for _, _, ksc in st.kept])
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    sc_t = torch.as_tensor(scs, device=dev).to(torch.float64)
    which_t = torch.as_tensor(which, dtype=torch.int64, device=dev)
    bad = score_gap = rank_gap = 0.0
    hits = 0.0
    second = 0
    for b0 in range(0, uq.shape[0], 64):
        sel = (which_t >= b0) & (which_t < b0 + 64)
        if not bool(sel.any()):
            continue
        lam_q, e_q, ql = ref_energy.query_terms(uq[b0:b0 + 64], ref)
        full = ref_energy.scores(x, ref, lam_q, e_q, ql, w_l, w_d)
        r = which_t[sel] - b0
        got = [_row_numbers(torch, full, pool[b0:b0 + 64], r, ids_t[sel],
                            sc_t[sel], k) for pool in (pool_a, pool_b)]
        # The second pool serves a tied row where it fits better.
        use_b = tie[b0:b0 + 64][r] & (
            (got[1][0].to(torch.int8) < got[0][0].to(torch.int8))
            | ((got[1][0] == got[0][0]) & (got[1][2] < got[0][2])))
        pick = [torch.where(use_b, vb, va) for va, vb in zip(*got)]
        second += int(use_b.sum())
        bad += float(pick[0].sum())
        score_gap = max(score_gap, checks.finite(pick[1].max()))
        rank_gap = max(rank_gap, checks.finite(pick[2].max()))
        hits += float(pick[3].sum())
    n_tie = int(tie.sum())
    print(f"perfbench serve_energy: {n_tie} of {tie.shape[0]} kept queries "
          f"route within {ROUTE_TIE:.3g} of their candidate_m-th node, held "
          f"to both pools; {second} of {ids_t.shape[0]} kept answers fit the "
          f"second pool better", file=sys.stderr)
    answers = max(1, ids_t.shape[0])
    return {"bad_ids": bad, "score_gap": score_gap, "rank_gap": rank_gap,
            "recall": hits / (answers * k), "route_ties": float(n_tie)}
