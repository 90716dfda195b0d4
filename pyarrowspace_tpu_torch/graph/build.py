"""Standard index-build pipeline (port of pyarrowspace_tpu/graph/build.py).

Stages:
  1. validate items
  2. unit-normalize items (the item graph is cosine-based)
  3. exact eps/k-NN over the FULL corpus — kernel K1 on CUDA (or K1t, or
     a K1 option, under ARROWSPACE_KNN_VARIANT; every one bitwise K1)
  4. kernel weights, then symmetrize into a padded-ELL Laplacian
  5. [dims reduction] sample -> TwoNN ID -> K-means centroids
  6. F x F feature-space spectral Laplacian from the signals matrix
  7. per-item taumode lambda synthesis (Median tau* by default)

Dtype policy: on CPU, float64 when the input is float64, else float32; on
CUDA, float32.  Every phase runs on the build's device and is timed by
``utils.debug.phase``.  With ARROWSPACE_SUGGEST_DIR set, a build also
writes the parameter recommendation ``suggested_eps.md`` there
(graph/suggest.py); with ARROWSPACE_PROFILE=<dir>, a ``torch.profiler``
trace of the build.  ARROWSPACE_SYMMETRIZE picks the symmetrize op
(``_run_symmetrize``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core.laplacian import GraphLaplacian
from ..core.params import GraphParams
from ..core.space import ArrowSpace
from ..ops.distance import (kernel_weights, knn_graph_candidates,
                            knn_variant, unit_normalize)
from ..ops.rayleigh import dispersion_batch, rayleigh_batch
from ..ops.symmetrize import (symmetrize_to_ell, symmetrize_to_ell_chunked,
                              union_width_bound)
from ..reduction.pipeline import SAMPLING_KEEP_RATE, reduce_corpus
from ..spectral.taumode import TAU_MIX, derive_tau_star, synthesize
from ..utils.debug import (dbg_println, debug_enabled, phase, profile_trace,
                           reset_phase_timings)
from ..utils.logging import get_logger
from .feature import build_feature_laplacian

log = get_logger("builder")

# The ELL arrays auto-widen may grow to (weights + int32 indices), unless
# ARROWSPACE_ELL_BUDGET_BYTES says otherwise (read at each build).
_ELL_BUDGET_BYTES = 2 << 30

# The one-pass symmetrize's peak device memory beside the ELL rows it
# writes, in bytes per directed k-NN entry (n * k): 225.5 measured at
# 1,000,000 x 768, k 25, width 268 on an H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 16, which fails if it measures more than this
# constant), rounded up, so it bounds the need from above.  When the need
# passes the memory the card has free, auto / device mode takes the chunked
# op (the same bits, 28% less peak at 1M, 1.63x the time).
_ONE_PASS_BYTES_PER_ENTRY = 256
_HOST_HINT = ("set ARROWSPACE_SYMMETRIZE=host to symmetrize on the host with "
              "the native engine")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Engine-internal knobs; the defaults reproduce the reference's
    observed outputs."""

    # e_raw = x^T L x (False) vs x^T L x / x^T x (True).
    rayleigh_normalized: bool = False
    # Mixing weight between bounded energy and dispersion; None -> TAU_MIX.
    tau_mix: Optional[float] = None
    # Feature-graph k; None -> graph_params.topk.
    feature_k: Optional[int] = None
    # Reduction only runs at this corpus size and above.
    reduction_min_n: int = 4096
    # Sampling keep-rate for the reduction stage; None -> 0.6.
    sampling_rate: Optional[float] = None
    # Padded-ELL row width of the symmetrized Laplacian; None -> 2k.
    ell_width: Optional[int] = None
    # Re-symmetrize at wider rows while the cap drops edges; None -> on
    # iff ell_width was not set explicitly.
    ell_auto_widen: Optional[bool] = None


DEFAULT_BUILD_CONFIG = BuildConfig()


def validate_items(items):
    """Ingest validation with reference-identical error text
    (reference src/helpers.rs:24-46).  Tensors pass through as they are;
    anything else becomes a numpy array."""
    arr = items if isinstance(items, torch.Tensor) else np.asarray(items)
    if arr.ndim != 2 or arr.shape[0] == 0 or arr.shape[1] == 0:
        raise ValueError("items must be non-empty 2D array")
    n, d = arr.shape
    dbg_println(f"items shape: ({n}, {d})")
    if debug_enabled():
        t = torch.as_tensor(arr)
        dbg_println(f"items[0][:5]: {t[0][:5].double().tolist()}")
        dbg_println(f"NaNs: {int(torch.isnan(t).sum())}, "
                    f"Infs: {int(torch.isinf(t).sum())}")
    return arr


def resolve_device(items, device=None) -> torch.device:
    """The build's device: the explicit one, else the device of a tensor
    input, else CUDA.  Without a card it raises rather than fall back to
    the CPU, which runs only when asked for (``device="cpu"`` or a CPU
    tensor)."""
    if device is not None:
        return torch.device(device)
    if isinstance(items, torch.Tensor):
        return items.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (or a CPU "
                           "tensor) to build on the CPU")
    return torch.device("cuda")


def _pick_dtype(arr, device: torch.device) -> torch.dtype:
    """float32 on CUDA; on CPU float64 for float64 input, else float32
    (the reference is f64 end-to-end, src/helpers.rs:24)."""
    is64 = (arr.dtype == torch.float64 if isinstance(arr, torch.Tensor)
            else arr.dtype == np.float64)
    return torch.float64 if device.type == "cpu" and is64 else torch.float32


def one_pass_fits(n: int, k: int, ell_width: int, itemsize: int,
                  device: torch.device) -> bool:
    """Whether the one-pass symmetrize's temporaries and output fit in the
    memory the card has free (the allocator's cached blocks count as free);
    always True on the CPU."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    need = n * (k * _ONE_PASS_BYTES_PER_ENTRY + ell_width * (4 + itemsize))
    return need <= free


def _run_symmetrize(i: torch.Tensor, w: torch.Tensor, ell_width: int):
    """The symmetrize stage under ARROWSPACE_SYMMETRIZE (reference
    graph/build.py:122-198):

      auto / device (the default; any other value too): the one-pass op,
        or the chunked op (bit for bit the same) when the one-pass op would
        not fit on the card (``one_pass_fits``); a chunk's overflow retries
        at a higher capacity, then raises MemoryError.
      device_fused: always the one-pass op.
      host: the native OpenMP engine (io/native.symmetrize_host).

    Unlike the reference, a device OOM or the chunk ladder's MemoryError
    is not caught and rerun on the host engine: it raises, naming the host
    mode."""
    mode = os.environ.get("ARROWSPACE_SYMMETRIZE", "auto")
    if mode == "host":
        from ..io.native import symmetrize_host
        dbg_println("symmetrize: ARROWSPACE_SYMMETRIZE=host -> native host "
                    "engine")
        host = symmetrize_host(i.cpu().numpy(),
                               w.cpu().to(torch.float64).numpy(), ell_width)
        if host is None:
            raise RuntimeError(
                "ARROWSPACE_SYMMETRIZE=host but the native engine is "
                "unavailable (no compiler / build failure)")
        h_idx, h_w, n_dropped = host
        nbr_idx = torch.from_numpy(h_idx).to(i.device)
        nbr_w = torch.from_numpy(h_w).to(device=w.device, dtype=w.dtype)
        return nbr_idx, nbr_w, nbr_w.sum(dim=1), int(n_dropped)

    n, k = i.shape
    try:
        if mode != "device_fused" and not one_pass_fits(
                n, k, ell_width, w.element_size(), w.device):
            # Overflow means a row range held more entries than its window
            # (a hub-row problem), so the retry raises the capacity: more
            # chunks would shrink each window in proportion.
            for n_chunks, cap_factor in ((16, 3), (16, 12)):
                nbr_idx, nbr_w, degrees, n_dropped, n_over = \
                    symmetrize_to_ell_chunked(i, w, ell_width,
                                              n_chunks=n_chunks,
                                              cap_factor=cap_factor)
                if n_over == 0:
                    return nbr_idx, nbr_w, degrees, n_dropped
                log.warning("chunked symmetrize overflow at n_chunks=%d "
                            "cap_factor=%d (%d entries); retrying",
                            n_chunks, cap_factor, n_over)
            raise MemoryError("chunked symmetrize overflow (hub-heavy graph "
                              f"exceeds per-chunk capacity): {_HOST_HINT}")
        return symmetrize_to_ell(i, w, ell_width)
    except torch.cuda.OutOfMemoryError as e:
        raise torch.cuda.OutOfMemoryError(
            f"symmetrize ran out of device memory "
            f"({str(e).splitlines()[0][:120]}): {_HOST_HINT}") from e


def symmetrize_auto_widen(run, config: BuildConfig, gp: GraphParams, *,
                          n: int, weight_itemsize: int,
                          width_bound_fn=None):
    """Run a symmetrize stage with the hub-cap escalation policy (reference
    parity: its CSR keeps EVERY union edge, GRAPH_VARIABLES.md:7-10).

    ``run(width)`` -> (nbr_idx, nbr_w, degrees, n_dropped).  At defaults,
    ``width_bound_fn()`` (an upper bound on the max union row degree)
    pre-sizes the width to a k-multiple so the stage runs once; a doubling
    loop is the backstop, bounded by an ELL memory budget, with a warning
    for edges still dropped at the cap."""
    auto_widen = (config.ell_auto_widen
                  if config.ell_auto_widen is not None
                  else config.ell_width is None)
    budget = int(os.environ.get("ARROWSPACE_ELL_BUDGET_BYTES",
                                _ELL_BUDGET_BYTES))
    bytes_per = weight_itemsize + 4                   # weight + idx
    width_cap = min(max(n - 1, 1),
                    max(2 * gp.k, budget // (bytes_per * n)))
    ell_width = (config.ell_width if config.ell_width is not None
                 else 2 * gp.k)
    ell_width = min(ell_width, max(n - 1, 1))
    if auto_widen and width_bound_fn is not None:
        need = int(width_bound_fn())
        if need > ell_width:
            step = max(gp.k, 8)
            sized = min(width_cap, -(-need // step) * step)
            if sized > ell_width:
                dbg_println(f"hub presize: union degree bound {need} > "
                            f"ell_width {ell_width}; sizing to {sized}")
                ell_width = sized
    nbr_idx, nbr_w, degrees, n_dropped = run(ell_width)
    if auto_widen and n_dropped > 0:
        while n_dropped > 0 and ell_width < width_cap:
            new_width = min(2 * ell_width, width_cap)
            msg = (f"hub cap dropped {int(n_dropped)} edges at "
                   f"ell_width={ell_width}; widening to {new_width}")
            dbg_println(msg)
            log.info(msg)
            ell_width = new_width
            nbr_idx, nbr_w, degrees, n_dropped = run(ell_width)
        if n_dropped > 0:
            log.warning(
                "hub cap still drops %d edges at the ELL budget cap "
                "(ell_width=%d, ARROWSPACE_ELL_BUDGET_BYTES=%d): the "
                "Laplacian is narrower than the reference's unbounded union "
                "graph; raise the budget or pass BuildConfig(ell_width=...) "
                "explicitly",
                int(n_dropped), ell_width, budget)
    return nbr_idx, nbr_w, degrees, n_dropped


def build_standard(items, gp: GraphParams,
                   config: BuildConfig = DEFAULT_BUILD_CONFIG,
                   device=None) -> tuple[ArrowSpace, GraphLaplacian]:
    """Full standard build: (ArrowSpace, GraphLaplacian).  With
    ARROWSPACE_PROFILE=<dir> set, the build runs under ``profile_trace``,
    which writes a Chrome trace into <dir>."""
    profile_dir = os.environ.get("ARROWSPACE_PROFILE")
    if profile_dir:
        dev = resolve_device(items, device)
        with profile_trace(profile_dir, cuda=dev.type == "cuda"):
            return _build_standard_inner(items, gp, config, device)
    return _build_standard_inner(items, gp, config, device)


def _build_standard_inner(items, gp: GraphParams, config: BuildConfig,
                          device) -> tuple[ArrowSpace, GraphLaplacian]:
    reset_phase_timings()
    arr = validate_items(items)
    dev = resolve_device(items, device)
    dtype = _pick_dtype(arr, dev)
    variant = knn_variant()
    with phase("ingest", dev):
        x = torch.as_tensor(arr).to(device=dev, dtype=dtype).contiguous()
    n, f = x.shape
    sigma = gp.sigma_resolved
    cfg_line = (
        f"Build configuration: eps={gp.eps}, k={gp.k}, p={gp.p}, "
        f"sigma={sigma}, normalise={str(gp.normalise).lower()}, "
        f"synthesis={gp.synthesis.name.capitalize()}")
    dbg_println(cfg_line)
    log.debug(cfg_line)

    suggest_dir = os.environ.get("ARROWSPACE_SUGGEST_DIR")
    if suggest_dir:
        # Per-build parameter-recommendation artifact (the reference
        # engine's suggested_eps.md).
        from .suggest import emit_build_suggestions
        emit_build_suggestions(
            x, gp, suggest_dir,
            build_log=[cfg_line,
                       f"ArrowSpace created with {n} items and {f} "
                       "features"])

    with phase("normalize", dev):
        xu = unit_normalize(x).contiguous()
    stored = xu if gp.normalise else x

    with phase("knn", dev):
        d, i = knn_graph_candidates(xu, gp.k, gp.eps, variant=variant)

    return _assemble_from_knn(stored, xu, d, i, gp, config)


def _assemble_from_knn(stored, xu, d, i, gp: GraphParams,
                       config: BuildConfig
                       ) -> tuple[ArrowSpace, GraphLaplacian]:
    """Everything downstream of the k-NN candidate scan: weights ->
    symmetrize -> reduction -> feature Laplacian -> lambdas.  Shared by the
    standard build and the incremental extend (graph/extend.py), so the
    two cannot drift."""
    n, f = stored.shape
    dev = stored.device
    with phase("weights", dev):
        w = kernel_weights(d, gp.sigma_resolved, gp.p)
        w = torch.where(i >= 0, w, 0.0)

    with phase("symmetrize", dev):
        nbr_idx, nbr_w, degrees, n_dropped = symmetrize_auto_widen(
            lambda width: _run_symmetrize(i, w, width),
            config, gp, n=n, weight_itemsize=w.element_size(),
            width_bound_fn=lambda: union_width_bound(i))
    gl = GraphLaplacian._from_ell(nbr_idx, nbr_w, degrees, gp,
                                  n_dropped=n_dropped)

    centroids = None
    assignments = None
    signals = stored
    if gp.dims_reduction and n >= config.reduction_min_n:
        with phase("reduction", dev):
            keep = (config.sampling_rate if config.sampling_rate is not None
                    else SAMPLING_KEEP_RATE)
            # The reference threads eps into the reduction stage
            # (with_dims_reduction(true, Some(eps)), src/lib.rs:283).
            red = reduce_corpus(stored, seed=gp.seed, keep_rate=keep,
                                eps_hint=gp.eps)
            centroids, assignments = red.centroids, red.assignments
            signals = centroids

    with phase("feature_laplacian", dev):
        k_f = config.feature_k if config.feature_k is not None else gp.topk
        # Reduction path: eps-kernel feature weights, clamped so small-eps
        # protocols keep nonzero weights; raw-signal path: binary.
        sig_scale = (float(np.clip(gp.eps / 10.0, 0.25, 4.0))
                     if centroids is not None else None)
        w_f, lap_f, _ = build_feature_laplacian(signals, k_f=k_f,
                                                sigma_scale=sig_scale)

    tau_mix = TAU_MIX if config.tau_mix is None else config.tau_mix
    with phase("lambdas", dev):
        e_un = rayleigh_batch(stored, lap_f, normalized=False)
        e_raw = (rayleigh_batch(stored, lap_f, normalized=True)
                 if config.rayleigh_normalized else e_un)
        tau_star = derive_tau_star(e_raw, gp.synthesis, gp.tau_fixed)
        g = dispersion_batch(stored, w_f, e_un)
        lambdas = synthesize(e_raw, g, tau_star, tau_mix)

    aspace = ArrowSpace._from_build(
        data=stored, data_unit=xu, lambdas=lambdas, e_raw=e_raw,
        lap_f=lap_f, w_f=w_f, tau_star=tau_star, params=gp,
        rayleigh_normalized=config.rayleigh_normalized, tau_mix=tau_mix,
        centroids=centroids, assignments=assignments,
        knn_dist=d, knn_idx=i)
    dbg_println(
        f"built ArrowSpace: nitems={aspace.nitems}, "
        f"nfeatures={aspace.nfeatures}, lambdas_len={aspace.nitems}")
    return aspace, gl
