"""The serve loop: a closed loop of ``ArrowSpace.search_batch`` calls, one
batch of queries at a time over the index that set-up built, the next
batch sent when the last one's results are on the host as numpy.

Traffic keys: "mode", "batch" (queries a call), "batches" (distinct
batches made from the seed, sent in turn), "topk" (None: the config's),
"check_rows" (rows of each batch whose answers are kept and held to the
reference), "batch_source" (where the batch size comes from; not read).
The queries are made on the device from the config's query law.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from harness import checks, corpus
from harness.trace import STEP, record
from harness.window import percentile, rate

SUBTILE, PAD_ROWS = 64, 8192   # the subtile layout's rows, as the port's


@dataclass
class State:
    ctx: object
    aspace: object = None
    gl: object = None
    queries: list = None
    keep: list = None
    turn: int = 0
    kept: list = field(default_factory=list)


def _sync(ctx):
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize(ctx.device)


def _topk(ctx) -> int:
    t = ctx.traffic.get("topk")
    return int(ctx.config["graph_params"]["topk"] if t is None else t)


def shapes(ctx) -> dict:
    cfg = ctx.config
    n, f = int(cfg["n_items"]), int(cfg["n_features"])
    return {"n": n, "f": f, "q": int(ctx.traffic["batch"]),
            "topk": min(_topk(ctx), n), "subtile": SUBTILE,
            "real_rows": -(-n // SUBTILE) * SUBTILE,
            "n_pad": -(-n // PAD_ROWS) * PAD_ROWS}


def setup(ctx) -> State:
    torch, dev, cfg, tr = ctx.torch, ctx.device, ctx.config, ctx.traffic
    x, centres = corpus.make_corpus(torch, dev, cfg, ctx.seed)
    st = State(ctx=ctx)
    st.aspace, st.gl = ctx.program.ArrowSpaceBuilder.build(
        cfg["graph_params"], x)
    st.queries = corpus.make_queries(torch, dev, cfg, ctx.seed, x, centres,
                                     int(tr["batches"]), int(tr["batch"]))
    del x, centres
    st.keep = [checks.sample_rows(int(tr["batch"]), int(tr["check_rows"]),
                                  ctx.seed + 1 + b)
               for b in range(len(st.queries))]
    for b in range(len(st.queries)):     # each batch's shapes, and the
        _search(st, b)                    # mode's state made at first use
    _sync(ctx)
    return st


def _search(st: State, b: int):
    ctx = st.ctx
    return st.aspace.search_batch(st.queries[b], st.gl,
                                  float(ctx.config["tau"]),
                                  topk=_topk(ctx), mode=ctx.traffic["mode"])


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
    return {"queries": q, "answered": int(min(q, ids.shape[0]))}


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


def _reference(st: State, tf32: bool):
    """(unit corpus, item lambdas, unique queries [U, F], their lambdas,
    (batch, row) -> unique query) of the reference in float64, or with
    ``tf32`` in float32 with TF32 products."""
    import reference.graph as rg
    from reference import serve, spectral
    ctx, torch = st.ctx, st.ctx.torch
    cfg = ctx.config
    x, centres = corpus.make_corpus(torch, ctx.device, cfg, ctx.seed)
    qs = corpus.make_queries(torch, ctx.device, cfg, ctx.seed, x, centres,
                             int(ctx.traffic["batches"]),
                             int(ctx.traffic["batch"]))
    uq = torch.cat([qs[b][torch.as_tensor(st.keep[b], device=ctx.device)]
                    for b in range(len(qs))])
    del qs, centres
    dt = torch.float32 if tf32 else torch.float64
    with checks.tf32(torch, tf32):
        state = spectral.index_state(x, cfg["graph_params"], final_dtype=dt)
        lam_q = serve.query_lambdas(uq, state)
        xu = rg.unit_rows(x, dt)
    del x
    base = np.cumsum([0] + [len(r) for r in st.keep])
    return xu, state["lambdas"], uq, lam_q, base


def numbers(st: State, control: bool = False) -> dict:
    """The check's numbers: every kept answer against the float64
    reference.  With ``control`` the reference in TF32 answers each kept
    query once, in the program's place."""
    from reference import serve
    ctx, torch = st.ctx, st.ctx.torch
    tau, k = float(ctx.config["tau"]), shapes(ctx)["topk"]
    xu, lam, uq, lam_q, base = _reference(st, tf32=False)
    if control:
        cx, clam, cuq, clam_q, _ = _reference(st, tf32=True)
        ids, scs = [], []
        with checks.tf32(torch, True):
            for s in range(0, cuq.shape[0], 64):
                v, i = serve.topk(serve.scores(cx, clam, cuq[s:s + 64],
                                               clam_q[s:s + 64], tau), k)
                ids.append(i.cpu().numpy())
                scs.append(v.double().cpu().numpy())
        del cx
        which = np.arange(uq.shape[0])
        ids, scs = np.concatenate(ids), np.concatenate(scs)
    else:
        which = np.concatenate([base[b] + np.arange(kid.shape[0])
                                for b, kid, _ in st.kept])
        ids = np.concatenate([kid for _, kid, _ in st.kept])
        scs = np.concatenate([ksc for _, _, ksc in st.kept])
    return checks.serve_numbers(torch, xu, lam, uq, lam_q, tau, k, which,
                                ids, scs)
