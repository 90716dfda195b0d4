"""Rank processes for the port's sharded tests (tests/test_torch_sharded.py).

``RankPool(world, tmpdir)`` spawns ``world`` processes that join one gloo
group on the CPU (``init_method="file://..."``, one thread each) and then
run the scenario functions below on request, each on every rank, with the
same arguments; ``run`` returns every rank's result in rank order.  This
module imports torch, numpy and the port, never jax: the ranks run
without it (each asserts so)."""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import traceback


def _rank_main(rank: int, world: int, init_file: str, inbox, outbox):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    from pyarrowspace_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    while True:
        msg = inbox.get()
        if msg is None:
            break
        name, kwargs = msg
        try:
            assert "jax" not in sys.modules, "a rank imported jax"
            outbox.put((rank, True, globals()[name](mesh, **kwargs)))
        except Exception:           # reported to the test, which fails
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo rank processes serving scenario calls."""

    def __init__(self, world: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._outbox = ctx.Queue()
        init_file = os.path.join(tmpdir, f"gloo-{world}")
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, init_file,
                                         self._inboxes[r], self._outbox),
                                   daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, name: str, timeout: float = 120.0, **kwargs) -> list:
        for box in self._inboxes:
            box.put((name, kwargs))
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, value = self._outbox.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{name}: a rank did not answer in "
                                   f"{timeout} s")
            if not ok:
                self.close()
                raise RuntimeError(f"{name} failed on rank {rank}:\n{value}")
            out[rank] = value
        return out

    def close(self) -> None:
        for box in self._inboxes:
            box.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


# -- scenarios (run on every rank) ----------------------------------------------
def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def build_and_serve(mesh, items, gp, queries, tau, k_energy=8):
    """build_sharded, then every serving mode that needs no IVF state."""
    from pyarrowspace_tpu_torch.core.params import parse_graph_params
    from pyarrowspace_tpu_torch.parallel import build_sharded

    sspace, gl = build_sharded(items, parse_graph_params(gp), mesh)
    out = dict(lambdas=sspace.lambdas(), tau_star=sspace.tau_star,
               lap=gl.to_dense(), n_dropped=gl._n_dropped,
               knn_d=_np(sspace.knn[0]), knn_i=_np(sspace.knn[1]),
               n_loc=int(sspace._xu_loc.shape[0]))
    for mode in ("exact", "subtile", "auto"):
        out[mode] = sspace.search_batch(queries, tau, mode=mode)
    out["hybrid"] = sspace.search_hybrid_batch(queries, 0.8)
    out["energy"] = sspace.search_energy_batch(queries, k_energy)
    anti = -queries[:4] * 1.5           # real cosine scores below zero
    out["anti"] = {mode: sspace.search_batch(anti, 0.05, mode=mode)
                   for mode in ("exact", "subtile")}
    out["anti_hybrid"] = sspace.search_hybrid_batch(anti, 0.05)
    try:
        sspace.search_batch(queries, tau, mode="warp")
        out["bad_mode"] = None
    except ValueError as e:
        out["bad_mode"] = str(e)
    out["centroids"] = _np(sspace._centroids)
    return out


def ivf_serving(mesh, items, gp, n_clusters, queries, tau, stream_batches):
    """A one-device index with enable_ivf, sharded by from_local; then
    ivf_block (with and without certificates), certified, the probe
    ceiling, and serving_stream."""
    from pyarrowspace_tpu_torch import ArrowSpaceBuilder
    from pyarrowspace_tpu_torch.parallel import ShardedArrowSpace

    aspace, gl = ArrowSpaceBuilder.build(gp, items, device="cpu")
    aspace.enable_ivf(n_clusters=n_clusters)
    sspace = ShardedArrowSpace.from_local(aspace, gl, mesh)
    out = dict(
        ivf16=sspace.search_batch(queries, tau, mode="ivf_block",
                                  n_probe=16),
        ivf_full=sspace.search_batch(queries, tau, mode="ivf_block",
                                     n_probe=n_clusters),
        cert_full=sspace.search_batch(queries, tau, mode="ivf_block",
                                      n_probe=n_clusters, certify=True),
        cert2=sspace.search_batch(queries, tau, mode="ivf_block", n_probe=2,
                                  certify=True),
        certified=sspace.search_batch(queries, tau, mode="certified",
                                      n_probe=4),
        exact=sspace.search_batch(queries, tau, mode="exact"))

    # The ladder's probe lists at n_widen 0 and 2 (ROADMAP fault 1).
    seen = []
    real = sspace._ivf_block

    def spy(q, tau_, topk, n_probe, certify, margin=0.0):
        seen.append(int(n_probe))
        return real(q, tau_, topk, n_probe, certify, margin)

    sspace._ivf_block = spy
    out["certified_w0"] = sspace.search_batch(queries, tau, mode="certified",
                                              n_probe=1, n_widen=0)
    out["probes_w0"] = list(seen)
    seen.clear()
    out["certified_w2"] = sspace.search_batch(queries, tau, mode="certified",
                                              n_probe=1, n_widen=2)
    out["probes_w2"] = list(seen)
    sspace._ivf_block = real
    out["ceiling"] = sspace._structural_ceiling()

    stream = sspace.serving_stream(tau, n_probe=4, depth=2)
    for qb in stream_batches:
        stream.submit(qb)
    res = stream.finish()
    out["stream"] = [(i, v) for i, v, _ in res]
    out["stream_sync"] = [sspace.search_batch(qb, tau, mode="certified",
                                              n_probe=4)
                          for qb in stream_batches]
    out["stream_escalated"] = stream.escalated_at
    collapse = sspace.serving_stream(tau, n_probe=1, depth=1, cert_floor=1.01,
                                     floor_patience=1, fallback_mode="exact",
                                     probe_escalations=1)
    for qb in stream_batches:
        collapse.submit(qb)
    res = collapse.finish()
    out["collapse"] = dict(escalated_at=collapse.escalated_at,
                           degraded_at=collapse.degraded_at,
                           ids=[i for i, _, _ in res])
    out["exact_batches"] = [sspace.search_batch(qb, tau, mode="exact")[0]
                            for qb in stream_batches]
    return out


def slab_plan(mesh, items, gp, path):
    """save -> load -> from_local carries the slab layout plan; the sharded
    layout's cap is the one-device one; to_local keeps the plan."""
    from pyarrowspace_tpu_torch import ArrowSpaceBuilder
    from pyarrowspace_tpu_torch.io import load_index, save_index
    from pyarrowspace_tpu_torch.parallel import ShardedArrowSpace

    aspace, gl = ArrowSpaceBuilder.build(gp, items, device="cpu")
    aspace.enable_ivf(n_clusters=8, capacity_factor=1.5)
    if mesh.get_rank() == 0:
        save_index(path, aspace, gl)
    import torch.distributed as dist
    dist.barrier()
    loaded, gl2 = load_index(path, device="cpu")
    sspace = ShardedArrowSpace.from_local(loaded, gl2, mesh)
    shard = sspace._ensure_ivf_block_state()
    back = sspace.to_local()
    return dict(plan=sspace._ivf_cap_plan, factor=sspace._ivf_cap_factor,
                local_plan=aspace._ivf_cap_plan,
                local_cap=aspace._ensure_ivf_blocked().cap,
                sharded_cap=shard.cap, back_plan=back._ivf_cap_plan,
                back_factor=back._ivf_cap_factor)


def roundtrip(mesh, path, queries, tau):
    """load_index -> from_local -> search -> to_local."""
    from pyarrowspace_tpu_torch.io import load_index
    from pyarrowspace_tpu_torch.parallel import ShardedArrowSpace

    loaded, gl = load_index(path, device="cpu")
    sspace = ShardedArrowSpace.from_local(loaded, gl, mesh)
    back = sspace.to_local()
    return dict(search=sspace.search_batch(queries, tau),
                back_lambdas=back.lambdas(),
                back_search=back.search(queries[0], gl, tau),
                normalized=sspace._rayleigh_normalized,
                back_normalized=back._rayleigh_normalized)


def normalized_build(mesh, items, gp, queries, tau):
    """BuildConfig(rayleigh_normalized=True) carried through from_local."""
    from pyarrowspace_tpu_torch.core.params import parse_graph_params
    from pyarrowspace_tpu_torch.graph.build import BuildConfig, build_standard
    from pyarrowspace_tpu_torch.parallel import ShardedArrowSpace

    aspace, gl = build_standard(items, parse_graph_params(gp),
                                BuildConfig(rayleigh_normalized=True),
                                device="cpu")
    sspace = ShardedArrowSpace.from_local(aspace, gl, mesh)
    return dict(carried=sspace._rayleigh_normalized,
                search=sspace.search_batch(queries, tau),
                local=aspace.search_batch(queries, gl, tau),
                back=sspace.to_local()._rayleigh_normalized)


def ingest(mesh, arr):
    """ingest_sharded moves only this rank's rows: every host-to-tensor
    conversion it makes is at most one shard."""
    import torch
    from pyarrowspace_tpu_torch.parallel.mesh import Comm
    from pyarrowspace_tpu_torch.parallel.sharded import ingest_sharded

    rows = []
    real = torch.from_numpy

    def spy(a):
        rows.append(int(a.shape[0]))
        return real(a)

    torch.from_numpy = spy
    try:
        x, n_pad = ingest_sharded(arr, Comm(mesh), torch.float64)
    finally:
        torch.from_numpy = real
    return dict(rows=rows, x=_np(x), n_pad=n_pad)


def symmetrize(mesh, idx, w, m, n_real):
    """sharded_symmetrize over this rank's rows of padded lists; the
    bucket overflow's fallback count."""
    import torch
    from pyarrowspace_tpu_torch.parallel import sharded
    from pyarrowspace_tpu_torch.parallel.mesh import Comm

    comm = Comm(mesh)
    n_loc = idx.shape[0] // comm.size
    lo = comm.rank * n_loc
    before = sharded.SYMMETRIZE_FALLBACKS
    got = sharded.sharded_symmetrize(
        comm, torch.from_numpy(idx[lo:lo + n_loc]),
        torch.from_numpy(w[lo:lo + n_loc]), m, n_real)
    return dict(nbr_idx=_np(got[0]), nbr_w=_np(got[1]), degrees=_np(got[2]),
                n_dropped=int(got[3]),
                fallbacks=sharded.SYMMETRIZE_FALLBACKS - before)


def synthesis_modes(mesh, items, gp, modes):
    """lambdas and tau* under each (TauMode name, tau_fixed)."""
    import dataclasses
    from pyarrowspace_tpu_torch.core.params import TauMode, \
        parse_graph_params
    from pyarrowspace_tpu_torch.parallel import build_sharded

    out = {}
    for name, tf in modes:
        g = dataclasses.replace(parse_graph_params(gp),
                                synthesis=TauMode[name], tau_fixed=tf)
        sspace, _ = build_sharded(items, g, mesh)
        out[name] = (sspace.lambdas(), sspace.tau_star)
    return out


def reduction_build(mesh, items, gp, queries, tau):
    """A build large enough for the reduction stage (the sharded Lloyd)."""
    import dataclasses
    from pyarrowspace_tpu_torch.core.params import parse_graph_params
    from pyarrowspace_tpu_torch.parallel import build_sharded

    g = dataclasses.replace(parse_graph_params(gp), dims_reduction=True,
                            seed=42)
    sspace, gl = build_sharded(items, g, mesh)
    return dict(lambdas=sspace.lambdas(), tau_star=sspace.tau_star,
                centroids=_np(sspace._centroids),
                assignments=_np(sspace._assignments),
                exact=sspace.search_batch(queries, tau))


def dp_tp(mesh, x, lap_f, w_f, n_real, shape):
    """lambdas_dp_tp on a (data, model) mesh over the same ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from pyarrowspace_tpu_torch.parallel.tp import lambdas_dp_tp

    mesh2 = DeviceMesh("cpu", torch.arange(mesh.size()).reshape(shape),
                       mesh_dim_names=("data", "model"))
    n_loc = x.shape[0] // shape[0]
    r = mesh2.get_local_rank("data")
    lam, e, ts = lambdas_dp_tp(torch.from_numpy(x[r * n_loc:(r + 1) * n_loc]),
                               torch.from_numpy(lap_f),
                               torch.from_numpy(w_f), mesh=mesh2,
                               n_real=n_real)
    return dict(data_rank=r, lam=_np(lam), e=_np(e), tau_star=float(ts))


def ring_lists(mesh, items, k, eps):
    """ring_knn's lists of this rank's rows (the plain ring steps on the
    CPU, lexicographic merges of seeds of any ids)."""
    import torch
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    from pyarrowspace_tpu_torch.parallel.mesh import Comm
    from pyarrowspace_tpu_torch.parallel.sharded import (ingest_sharded,
                                                         ring_knn)

    comm = Comm(mesh)
    x, _ = ingest_sharded(items, comm, torch.float64)
    d, i = ring_knn(comm, unit_normalize(x).contiguous(), k, eps,
                    items.shape[0])
    return dict(d=_np(d), i=_np(i))
