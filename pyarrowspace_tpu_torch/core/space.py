"""ArrowSpace — the built index: item data, per-item synthetic lambdas, and
the stored feature-space spectral state used to score queries.

API parity with the reference's `PyArrowSpace` wrapper (reference
src/lib.rs:64-263): builder-only construction; `nitems`, `nfeatures`,
`get_item(idx) -> (np.ndarray float64, float)`, `lambdas() -> np.ndarray`,
`search(query, gl, tau)`, `search_hybrid(query, gl, tau)`,
`search_energy(query, gl, k, w_lambda=None, w_dirichlet=None)` — each a
list of (index, score) by descending score — and the JAX package's
extras: `search_batch` in every mode ("auto", "exact", "int8", "subtile",
"ivf", "ivf_block", "certified"), `search_hybrid_batch`,
`search_energy_batch`, `enable_ivf`, `serving_stream`, `as_serving`,
`spectral_summary`, `data` and `feature_laplacian`.  State lives as torch
tensors on the build's device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .laplacian import GraphLaplacian
from .params import GraphParams
from ..ops import ivf_scan as ivf_ops
from ..ops import search as search_ops
from ..ops.cuda import scan_topk
from ..ops.distance import unit_normalize
from ..ops.ivf import IVFIndex, build_ivf, ivf_lambda_search
from ..ops.quantize import quantize_rows
from ..ops.rayleigh import rayleigh_batch
from ..ops.subtile_scan import build_subtile_state
from ..utils.debug import dbg_println, span
from ..utils.logging import get_logger

log = get_logger("serving")

_BUILDER_TOKEN = object()

# mode="auto" serves an index of at least this many items with "subtile",
# a smaller one with "exact" (the reference's rule).
AUTO_SUBTILE_MIN_ITEMS = 131_072

# Certified serving: below this base certification rate, widening is
# skipped and refusals escalate straight to the exact scan (re-probing a
# nearly fully refused batch through doubled probe lists costs more than
# the scan it tries to avoid).
_WIDEN_MIN_CERT_RATE = 0.25

# ARROWSPACE_IVF_SLABS's values (reference core/space.py:285-305).
_SLAB_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "f16": torch.float16, "float16": torch.float16,
                "f32": torch.float32, "float32": torch.float32}
_MODES = ("auto", "exact", "int8", "subtile", "ivf", "ivf_block",
          "certified")


def _to_host(*tensors) -> tuple:
    """A search's results on the host as numpy arrays.  The copy of the
    first waits for the work the call queued on its device, so the
    ``search.to_host`` range holds that wait too."""
    with span("search.to_host"):
        return tuple(t.cpu().numpy() for t in tensors)


class ArrowItem:
    """A single (features, lambda) pair (reference core::ArrowItem)."""

    __slots__ = ("item", "lambda_")

    def __init__(self, item: np.ndarray, lambda_: float):
        self.item = np.asarray(item, dtype=np.float64)
        self.lambda_ = float(lambda_)


class ArrowSpace:
    def __init__(self, *args, **kwargs):
        # Parity: reference src/lib.rs:71-76 rejects direct construction.
        if kwargs.get("_token") is not _BUILDER_TOKEN:
            raise ValueError(
                "ArrowSpace cannot be constructed directly; "
                "use ArrowSpaceBuilder.build"
            )
        self._data: torch.Tensor = kwargs["data"]            # [N, F]
        self._data_unit: torch.Tensor = kwargs["data_unit"]  # [N, F] unit rows
        self._lambdas: torch.Tensor = kwargs["lambdas"]      # [N]
        self._e_raw: torch.Tensor = kwargs["e_raw"]          # [N]
        # [N] RAW x^T L_f x when _e_raw holds normalized Rayleigh quotients
        # (rayleigh_normalized=True); the energy searches need the raw ones.
        self._e_un: Optional[torch.Tensor] = kwargs.get("e_un")
        self._lap_f: torch.Tensor = kwargs["lap_f"]          # [F, F]
        self._w_f: torch.Tensor = kwargs["w_f"]              # [F, F]
        self._tau_star: torch.Tensor = kwargs["tau_star"]    # 0-dim
        self._params: GraphParams = kwargs["params"]
        self._rayleigh_normalized: bool = kwargs.get("rayleigh_normalized",
                                                     False)
        from ..spectral.taumode import TAU_MIX
        self._tau_mix: float = kwargs.get("tau_mix", TAU_MIX)
        # Reduction artifacts and the directed k-NN candidates of the build.
        self._centroids: Optional[torch.Tensor] = kwargs.get("centroids")
        self._assignments: Optional[torch.Tensor] = kwargs.get("assignments")
        self._knn_dist: Optional[torch.Tensor] = kwargs.get("knn_dist")
        self._knn_idx: Optional[torch.Tensor] = kwargs.get("knn_idx")
        # Padded serving layout of mode="subtile", the int8 corpus and row
        # scales of mode="int8", each made at its first use.
        self._subtile: Optional[dict] = None
        self._quantized: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        # Energy-built spaces: the energy-node table (energy/maps.py) and
        # the bucket table of its routed search, made at first use.
        self._energy_maps = None
        self._energy_routing_cache = None
        self._spectral_cache: Optional[dict] = None
        # Blocked-IVF serving state (enable_ivf, _ensure_ivf_blocked): the
        # postings, the slab layout, its capacity factor and planned cap
        # (with the cluster count it was planned for), and the slab dtype.
        self._ivf: Optional[IVFIndex] = None
        self._ivf_blocked: Optional[ivf_ops.BlockedIVF] = None
        self._ivf_cap_factor: Optional[float] = None
        self._ivf_cap_plan: Optional[int] = None
        self._ivf_plan_k: Optional[int] = None
        self._ivf_slab_choice: Optional[torch.dtype] = None

    @classmethod
    def _from_build(cls, **kwargs) -> "ArrowSpace":
        return cls(_token=_BUILDER_TOKEN, **kwargs)

    # -- reference API --------------------------------------------------------
    @property
    def nitems(self) -> int:
        return int(self._data.shape[0])

    @property
    def nfeatures(self) -> int:
        return int(self._data.shape[1])

    @property
    def device(self) -> torch.device:
        return self._data.device

    def get_item(self, idx: int) -> tuple[np.ndarray, float]:
        """(features float64, lambda) for item idx
        (parity: reference src/lib.rs:100-124, ValueError on out-of-range)."""
        if idx >= self.nitems or idx < 0:
            raise ValueError(f"index {idx} out of range [0, {self.nitems})")
        feats = self._data[idx].cpu().numpy().astype(np.float64)
        return feats, float(self._lambdas[idx])

    def lambdas(self) -> np.ndarray:
        """Per-item synthetic lambdas as float64 (reference lib.rs:126-128)."""
        return self._lambdas.cpu().numpy().astype(np.float64)

    def _as_queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries).to(device=self.device,
                                           dtype=self._data.dtype)

    def _batch_queries(self, queries) -> torch.Tensor:
        q = self._as_queries(queries)
        if q.dim() != 2 or q.shape[1] != self.nfeatures:
            raise ValueError(f"queries must be [Q, {self.nfeatures}], got "
                             f"{tuple(q.shape)}")
        return q

    def _query_lambdas(self, q: torch.Tensor) -> torch.Tensor:
        return search_ops.query_lambdas(
            q, self._lap_f, self._w_f, self._tau_star,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix)

    def prepare_query_item(self, query, gl: GraphLaplacian) -> float:
        """Synthetic lambda of a query vector against the stored feature
        Laplacian (reference engine `prepare_query_item`)."""
        q = self._as_queries(query).reshape(1, -1)
        return float(self._query_lambdas(q)[0])

    def _check_query(self, query) -> np.ndarray:
        if isinstance(query, torch.Tensor):
            query = query.cpu()
        v = np.asarray(query, dtype=np.float64).reshape(-1)
        if v.shape[0] != self.nfeatures:
            raise ValueError(
                f"query length {v.shape[0]} must match nfeatures "
                f"{self.nfeatures}")
        return v

    def search(self, query, gl: GraphLaplacian, tau: float
               ) -> list[tuple[int, float]]:
        """Lambda-aware search (parity: reference src/lib.rs:132-174).

        Returns graph_params.topk results as (index, score) descending.
        tau is the blend: score = tau*cos + (1-tau)*lambda-proximity.  On
        CUDA the scan is kernel K2 with one query; on CPU the plain
        ``lambda_aware_topk``.
        """
        v = self._check_query(query)
        lam_q = self.prepare_query_item(v, gl)
        # Loud-failure parity (reference lib.rs:156-159): a degenerate
        # query lambda or an edgeless signal graph.  An explicit raise, not
        # an assert, so the check survives `python -O`.
        if lam_q == 0.0 or gl.nedges == 0:
            raise AssertionError(
                "The lambdas are zero, check the magnitude of items "
                "and eps.")
        dbg_println(f"search: qlen={v.shape[0]}, lambda_q={lam_q:.6f}")
        topk = min(gl.params.topk, self.nitems)
        dt = self._data.dtype
        q = torch.as_tensor(v, dtype=dt, device=self.device)
        lam_t = torch.as_tensor(lam_q, dtype=dt, device=self.device)
        if self.device.type == "cuda":
            idx, vals = scan_topk.lambda_search(
                self._data_unit, self._lambdas, unit_normalize(q)[None, :],
                lam_t.reshape(1), float(tau), topk)
            idx, vals = idx[0], vals[0]
        else:
            idx, vals = search_ops.lambda_aware_topk(
                self._data_unit, self._lambdas, q, lam_t,
                torch.as_tensor(tau, dtype=dt), topk)
        return [(int(i), float(s)) for i, s in zip(idx.tolist(),
                                                   vals.tolist())]

    def search_hybrid(self, query, gl: GraphLaplacian, tau: float
                      ) -> list[tuple[int, float]]:
        """Hybrid lambda-aware search, cos * (tau + (1 - tau) * prox)
        (reference src/lib.rs:182-219; no zero-lambda assert on this path,
        matching the reference)."""
        v = self._check_query(query)
        lam_q = self.prepare_query_item(v, gl)
        topk = min(gl.params.topk, self.nitems)
        dt = self._data.dtype
        idx, vals = search_ops.hybrid_topk(
            self._data_unit, self._lambdas,
            torch.as_tensor(v, dtype=dt, device=self.device),
            torch.as_tensor(lam_q, dtype=dt, device=self.device),
            torch.as_tensor(tau, dtype=dt, device=self.device), topk)
        return [(int(i), float(s)) for i, s in zip(idx.tolist(),
                                                   vals.tolist())]

    def search_hybrid_batch(self, queries, gl: GraphLaplacian, tau: float,
                            topk: Optional[int] = None):
        """Batched hybrid search: queries [Q, F] -> (indices [Q, topk]
        np.int32, scores [Q, topk])."""
        q = self._batch_queries(queries)
        topk = min(gl.params.topk if topk is None else int(topk),
                   self.nitems)
        lam_q = self._query_lambdas(q)
        idx, vals = search_ops.hybrid_topk_batch(
            self._data_unit, self._lambdas, q, lam_q,
            torch.as_tensor(tau, dtype=self._data.dtype), topk)
        return idx.cpu().numpy(), vals.cpu().numpy()

    # -- energy-only search ----------------------------------------------------
    def _energies_raw(self) -> torch.Tensor:
        """Per-item RAW Dirichlet energies x^T L_f x, which the residual
        identity D(q, x) = e_q + e_x - 2 q^T L x of every energy search
        needs: _e_raw itself, or with rayleigh_normalized=True the stored
        e_un, else computed once here."""
        if not self._rayleigh_normalized:
            return self._e_raw
        if self._e_un is None:
            self._e_un = rayleigh_batch(self._data, self._lap_f,
                                        normalized=False)
        return self._e_un

    def _energy_query(self, q: torch.Tensor):
        """(lam_q [Q], e_q [Q]) of a query batch: the lambda from the
        items' energy convention, e_q the RAW energy."""
        return (self._query_lambdas(q),
                rayleigh_batch(q, self._lap_f, normalized=False))

    def _energy_routing(self):
        """The centroid -> member bucket table of the routed energy search
        (ops/ivf.py's layout at capacity factor 2.0), built at first use."""
        if self._energy_routing_cache is None:
            ivf = build_ivf(self._centroids, self._assignments, self.nitems,
                            capacity_factor=2.0)
            self._energy_routing_cache = (ivf.buckets, ivf.tail)
        return self._energy_routing_cache

    def _search_energy_routed(self, q, lam_q, e_q, w_l: float, w_d: float,
                              k_eff: int):
        """The candidate-pool routed energy search (reference
        src/lib.rs:311-323), or None when the space has no energy maps.
        Queries go in chunks whose [chunk, pool, F] gather stays near
        search_ops.GATHER_BYTES."""
        emaps = self._energy_maps
        if emaps is None or self._assignments is None:
            return None
        buckets, tail = self._energy_routing()
        # candidate_m counts NODES; the dedup to centroids is inside.
        probe = min(emaps.candidate_m, int(emaps.nodes.shape[0]))
        m_pool = probe * int(buckets.shape[1]) + int(tail.shape[0])
        qc = max(1, search_ops.GATHER_BYTES // max(1, m_pool
                                                   * self.nfeatures * 4))
        dt = self._data.dtype
        outs = [search_ops.energy_routed_topk_batch(
                    self._data, self._lambdas, self._energies_raw(),
                    emaps.nodes, emaps.node_lambda, emaps.node_dirichlet,
                    emaps.node_centroid, self._lap_f, self._tau_star,
                    buckets, tail, q[s:s + qc], lam_q[s:s + qc],
                    e_q[s:s + qc], torch.as_tensor(w_l, dtype=dt),
                    torch.as_tensor(w_d, dtype=dt), probe=probe, topk=k_eff)
                for s in range(0, q.shape[0], qc)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def search_energy(self, query, gl: GraphLaplacian, k: int,
                      w_lambda: Optional[float] = None,
                      w_dirichlet: Optional[float] = None
                      ) -> list[tuple[int, float]]:
        """Energy-only search, no cosine (parity: reference
        src/lib.rs:221-262; defaults w_lambda=1.0, w_dirichlet=0.5).  An
        energy-built space routes through its energy maps when the routed
        pool fills all k results; otherwise the exact energy scan runs."""
        v = self._check_query(query)
        w_l = 1.0 if w_lambda is None else float(w_lambda)
        w_d = 0.5 if w_dirichlet is None else float(w_dirichlet)
        dbg_println(
            f"search_energy: qlen={v.shape[0]}, k={k}, w_λ={w_l:.2f}, "
            f"w_D={w_d:.2f}")
        dt = self._data.dtype
        q = torch.as_tensor(v, dtype=dt, device=self.device).reshape(1, -1)
        lam_q, e_q = self._energy_query(q)
        k_eff = min(int(k), self.nitems)
        routed = self._search_energy_routed(q, lam_q, e_q, w_l, w_d, k_eff)
        # The width check first: a routed pool narrower than k gives
        # fewer results, which the id check alone would accept.
        if (routed is not None and routed[0].shape[1] >= k_eff
                and bool(torch.all(routed[0][0, :k_eff] >= 0))):
            idx, vals = routed[0][0], routed[1][0]
        else:
            idx, vals = search_ops.energy_topk(
                self._data, self._lambdas, self._energies_raw(),
                self._lap_f, q[0], lam_q[0], e_q[0], self._tau_star,
                torch.as_tensor(w_l, dtype=dt),
                torch.as_tensor(w_d, dtype=dt), k_eff)
        return [(int(i), float(s)) for i, s in zip(idx.tolist(),
                                                   vals.tolist())]

    def search_energy_batch(self, queries, gl: GraphLaplacian, k: int,
                            w_lambda: Optional[float] = None,
                            w_dirichlet: Optional[float] = None):
        """Batched energy-only search: (indices [Q, k] np.int32, scores).
        The routed search serves the batch when it fills every query's k
        results; otherwise the exact energy scan serves it."""
        q = self._batch_queries(queries)
        w_l = 1.0 if w_lambda is None else float(w_lambda)
        w_d = 0.5 if w_dirichlet is None else float(w_dirichlet)
        lam_q, e_q = self._energy_query(q)
        k_eff = min(int(k), self.nitems)
        routed = self._search_energy_routed(q, lam_q, e_q, w_l, w_d, k_eff)
        if (routed is not None and routed[0].shape[1] >= k_eff
                and bool(torch.all(routed[0][:, :k_eff] >= 0))):
            idx, vals = routed
        else:
            dt = self._data.dtype
            idx, vals = search_ops.energy_topk_batch(
                self._data, self._lambdas, self._energies_raw(),
                self._lap_f, q, lam_q, e_q, self._tau_star,
                torch.as_tensor(w_l, dtype=dt),
                torch.as_tensor(w_d, dtype=dt), k_eff)
        return idx.cpu().numpy(), vals.cpu().numpy()

    # -- blocked IVF and certified serving -------------------------------------
    def enable_ivf(self, n_clusters: Optional[int] = None,
                   capacity_factor: Optional[float] = None, slab_dtype=None,
                   slab_capacity_factor: Optional[float] = None) -> IVFIndex:
        """Build the IVF routing state of mode="ivf_block"/"certified".

        Reuses the build's reduction clustering when it has one and
        n_clusters is None; otherwise clusters now (reduce_corpus with
        reseeding at keep_rate 1.0, then lloyd_tighten in unit space to a
        covering radius of 0.75 and at most the planned slab cap members
        a cluster, so the slab layout is spill-free).

        slab_dtype (torch.float32, torch.bfloat16, torch.float16) sets the
        slab precision: bf16 halves the probe bytes, approximate for
        ivf_block and still exact for certified serving (the rescored
        certificate); without it, ARROWSPACE_IVF_SLABS decides at search
        time.  slab_capacity_factor sizes the [K * cap, F] slabs;
        when None it follows min(2.0, capacity_factor) for an explicit
        capacity_factor (default 3.0, the postings' factor), else keeps
        the current factor, default 2.0.

        Unlike the reference, a new slab factor always reaches the layout:
        when the clustering is kept, the planned cap is re-planned for the
        new factor and the clustering re-tightened to it, so a leaner
        factor gives a smaller cap and the layout stays spill-free (the
        reference keeps the old plan as a floor, ROADMAP.md §3)."""
        from ..reduction import pipeline as rp

        if slab_capacity_factor is not None:
            slab_cf = float(slab_capacity_factor)
        elif capacity_factor is not None:
            slab_cf = min(2.0, float(capacity_factor))
        else:
            slab_cf = float(self._ivf_cap_factor or 2.0)
        if capacity_factor is None:
            capacity_factor = 3.0
        factor_changed = slab_cf != self._ivf_cap_factor
        if factor_changed:
            self._ivf_blocked = None   # slab layout follows the factor
        self._ivf_cap_factor = slab_cf
        if slab_dtype is not None:
            if slab_dtype != self._ivf_slab_choice:
                self._ivf_blocked = None
            self._ivf_slab_choice = slab_dtype

        if self._centroids is None or n_clusters is not None:
            red = rp.reduce_corpus(self._data, seed=self._params.seed,
                                   keep_rate=1.0, k_clusters=n_clusters,
                                   reseed_empty=True)
            cents_u = unit_normalize(red.centroids.to(self._data.dtype))
            self._ivf_plan_k = int(cents_u.shape[0])
            self._ivf_cap_plan = rp.planned_slab_cap(
                self.nitems, self._ivf_plan_k, capacity_factor=slab_cf)
            self._centroids, self._assignments = rp.lloyd_tighten(
                self._data_unit, cents_u, max_size=self._ivf_cap_plan)
            self._ivf_blocked = None   # slab layout follows the clustering
        elif factor_changed and self._ivf_cap_plan is not None:
            self._ivf_cap_plan = rp.planned_slab_cap(
                self.nitems, self._ivf_plan_k, capacity_factor=slab_cf)
            self._centroids, self._assignments = rp.lloyd_tighten(
                self._data_unit, self._centroids,
                max_size=self._ivf_cap_plan)
        self._ivf = build_ivf(self._centroids, self._assignments,
                              self.nitems, capacity_factor)
        return self._ivf

    def _resolve_slab_dtype(self) -> torch.dtype:
        """The blocked slabs' dtype: an explicit enable_ivf(slab_dtype=...)
        wins, then ARROWSPACE_IVF_SLABS (bf16|f16|f32), else float32.  An
        unknown value of the variable raises: a silent float32 would serve
        another precision than the deployment asked for."""
        if self._ivf_slab_choice is not None:
            return self._ivf_slab_choice
        env = os.environ.get("ARROWSPACE_IVF_SLABS", "").strip().lower()
        if not env:
            return torch.float32
        if env not in _SLAB_DTYPES:
            raise ValueError(
                f"ARROWSPACE_IVF_SLABS={env!r} is not a known slab dtype; "
                "expected one of bf16|bfloat16|f16|float16|f32|float32")
        return _SLAB_DTYPES[env]

    def _ensure_ivf_blocked(self) -> ivf_ops.BlockedIVF:
        """The cluster-contiguous slab index of mode="ivf_block" /
        "certified", built at first use and rebuilt when the slab dtype
        (``_resolve_slab_dtype``, read at each search) changed."""
        if self._ivf is None:
            self.enable_ivf()
        want = self._resolve_slab_dtype()
        if (self._ivf_blocked is not None
                and self._ivf_blocked.slabs.dtype != want):
            self._ivf_blocked = None
        if self._ivf_blocked is None:
            self._ivf_blocked = ivf_ops.build_blocked_ivf(
                self._data_unit, self._lambdas, self._centroids,
                self._assignments,
                capacity_factor=self._ivf_cap_factor or 2.0,
                min_cap=self._ivf_cap_plan,
                slab_dtype=None if want == torch.float32 else want)
        return self._ivf_blocked

    def _ivf_block_dispatch(self, q: torch.Tensor, tau: float, topk: int,
                            n_probe: int, certify: bool, m_pool,
                            q_block=None, pack_out: bool = False):
        """Query lambdas + routing + scan (+ certificate), on the device;
        pack_out (certify only) returns one packed tensor."""
        ivf = self._ensure_ivf_blocked()
        kw = {}
        if certify and ivf.slabs.dtype != torch.float32:
            kw = dict(rescore_corpus=self._data_unit.to(torch.float32),
                      rescore_lambdas=self._lambdas.to(torch.float32))
        return ivf_ops.blocked_ivf_search_fused(
            ivf, q, self._lap_f, self._w_f, self._tau_star, tau, topk,
            n_probe=n_probe, q_block=q_block,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix, certify=certify, m_pool=m_pool,
            pack_out=pack_out and certify, **kw)

    def _certified_finalize(self, queries: torch.Tensor, out, gl, tau,
                            topk_eff: int, n_probe: int, n_widen: int,
                            base_m: int, q_block=None):
        """Widen, then escalate, a certified ivf_block result to exact
        results (shared by search_batch(mode="certified") and
        serving_stream).  Returns (idx, vals, base_cert_rate).

        Refusals first re-probe at doubled n_probe (at most n_widen
        rounds, m_pool doubling with the probe list), still certified;
        what no round certifies escalates to mode="exact" (never "auto":
        certified serving's contract is float32-exact).  Below a base rate
        of _WIDEN_MIN_CERT_RATE widening is skipped."""
        if isinstance(out, tuple):   # search_batch(mode="ivf_block")'s
            idx, vals, cert = out
        else:                        # a packed dispatch (serving_stream)
            idx, vals, cert = ivf_ops.unpack_certified(out, topk_eff)
        rate0 = float(cert.mean()) if cert.size else 1.0

        def take(sel):
            return queries[torch.as_tensor(sel, device=queries.device)]

        if rate0 >= _WIDEN_MIN_CERT_RATE:
            ivf = self._ivf_blocked
            n_probe_max = min(ivf.n_clusters,
                              self.nitems // max(1, 2 * ivf.cap),
                              n_probe << n_widen)
            idx, vals, cert = ivf_ops.widen_refusals(
                idx, vals, cert,
                lambda sel, np2: self._search_batch(
                    take(sel), gl, tau, topk=topk_eff, mode="ivf_block",
                    n_probe=np2, certify=True,
                    m_pool=base_m * max(1, np2 // n_probe), q_block=q_block),
                topk_eff, n_probe, n_probe_max)
        idx, vals = ivf_ops.escalate_uncertified(
            idx, vals, cert,
            lambda sel: self._search_batch(take(sel), gl, tau,
                                           topk=topk_eff, mode="exact"),
            topk_eff)
        return idx, vals, rate0

    def _warn_volatile_nprobe(self, n_probe: int) -> None:
        """Certified serving with a shallow probe list at large N is
        throughput-volatile (results stay exact): a bad clustering or batch
        mix refuses most queries and every batch widens."""
        if n_probe <= 4 and self.nitems >= 262_144:
            log.warning(
                "certified serving with n_probe=%d at N=%d is throughput-"
                "volatile (a collapsed certificate widens every batch); "
                "deploy n_probe>=8", n_probe, self.nitems)

    def serving_stream(self, gl: GraphLaplacian, tau: float,
                       topk: Optional[int] = None, n_probe: int = 8,
                       n_widen: int = 2, m_pool: Optional[int] = None,
                       depth: int = 4, cert_floor: float = 0.35,
                       floor_patience: int = 2,
                       fallback_mode: Optional[str] = "auto",
                       q_block: Optional[int] = None,
                       probe_escalations: int = 2):
        """Pipelined certified serving for batch streams: a
        serving.CertifiedStream whose submit(queries) keeps up to `depth`
        certified dispatches in flight.  Each batch's packed result starts
        its copy to pinned host memory at dispatch, and finalize waits on
        that copy's CUDA event.  Per-batch results equal
        search_batch(mode="certified"); finish() returns
        [(idx, vals, base_cert_rate)] in submission order.

        On certificate collapse (base rate under cert_floor for
        floor_patience batches dispatched at the current setting) the
        stream doubles n_probe for later batches, up to probe_escalations
        times, then reroutes later batches to fallback_mode: "exact",
        "auto" (subtile at AUTO_SUBTILE_MIN_ITEMS items or more, else
        exact) or None (keep certifying)."""
        from ..serving import CertifiedStream

        topk_eff = min(gl.params.topk if topk is None else int(topk),
                       self.nitems)
        base_m = (m_pool if m_pool is not None
                  else max(4 * topk_eff, topk_eff + 6))
        self._warn_volatile_nprobe(n_probe)
        self._ensure_ivf_blocked()
        # Dispatch knobs the escalation hook bumps; each in-flight batch is
        # finalized with the values it was dispatched with.
        state = {"n_probe": int(n_probe), "m": int(base_m),
                 "rungs": max(0, int(probe_escalations))}

        def dispatch(queries):
            q = self._batch_queries(queries)
            np_cur, m_cur = state["n_probe"], state["m"]
            out = self._ivf_block_dispatch(q, float(tau), topk_eff, np_cur,
                                           True, m_cur, q_block=q_block,
                                           pack_out=True)
            done = None
            if out.is_cuda:
                out = out.to("cpu", non_blocking=True)   # pinned
                done = torch.cuda.Event()
                done.record()
            return q, out, done, np_cur, m_cur

        def finalize(_queries, boxed):
            q, out, done, np_used, m_used = boxed
            if done is not None:
                done.synchronize()
            return self._certified_finalize(q, out, gl, tau, topk_eff,
                                            np_used, n_widen, m_used,
                                            q_block=q_block)

        def on_collapse() -> bool:
            ivf = self._ivf_blocked
            np_max = min(ivf.n_clusters,
                         max(1, self.nitems // max(1, 2 * ivf.cap)))
            np_cur = state["n_probe"]
            if state["rungs"] <= 0 or np_cur >= np_max:
                return False
            state["rungs"] -= 1
            state["n_probe"] = min(2 * np_cur, np_max)
            state["m"] = base_m * max(1, state["n_probe"] // int(n_probe))
            log.warning(
                "certification collapsed at n_probe=%d: escalating the "
                "probe list to n_probe=%d (%d rung(s) left) before any "
                "fallback", np_cur, state["n_probe"], state["rungs"])
            return True

        fb = fb_fin = None
        if fallback_mode is not None:
            if fallback_mode not in ("auto", "exact"):
                raise ValueError("fallback_mode must be 'auto', 'exact', "
                                 f"or None, got {fallback_mode!r}")
            eff_mode = ("subtile" if fallback_mode == "auto"
                        and self.nitems >= AUTO_SUBTILE_MIN_ITEMS
                        else "exact")

            def fb(queries):
                return self.search_batch(queries, gl, tau, topk=topk_eff,
                                         mode=eff_mode)

            def fb_fin(_queries, out):
                return out

        return CertifiedStream(dispatch, finalize, fallback=fb,
                               finalize_fallback=fb_fin, depth=depth,
                               cert_floor=cert_floor,
                               floor_patience=floor_patience,
                               on_collapse=on_collapse)

    def search_batch(self, queries, gl: GraphLaplacian, tau: float,
                     topk: Optional[int] = None, mode: str = "exact",
                     n_probe: int = 8, certify: bool = False,
                     n_widen: int = 2, m_pool: Optional[int] = None,
                     q_block: Optional[int] = None):
        """Batched lambda-aware search: queries [Q, F] ->
        (indices [Q, topk] np.int32, scores [Q, topk]).

        mode "exact" scans the full corpus: query-lambda synthesis, then
        the blended scan with a running top-k (kernel K2 on CUDA).
        mode "int8" scans an int8 copy of the corpus (per-row absmax
        scales, made at its first use) for a pool of min(4 topk, N)
        candidates (kernel K7 on CUDA) and rescores the pool in float32:
        the exact scan's results whenever its top-k is in the pool.
        mode "ivf" scores the members of each query's n_probe nearest
        clusters and the spill tail (gather-routed; approximate).
        mode "subtile" routes through the subtile maxima (kernels K3, K4b,
        K5 and K4a on CUDA; ops/subtile_scan.py) over a padded bf16 copy
        of the corpus made at its first use, and rescores a 2 x topk pool
        in float32.  mode "auto" is "subtile" for an index of
        AUTO_SUBTILE_MIN_ITEMS items or more, else "exact".

        mode "ivf_block" routes query blocks of q_block (default 16; 8 for
        certified serving at n_probe < 8) to n_probe cluster slabs each
        and scans them (kernel K6 on CUDA; ops/ivf_scan.py), approximate;
        certify=True (ivf_block only) adds a per-query bool [Q]: True
        means the served top-k provably equals the exact blended-scan
        top-k.  mode "certified" serves the EXACT top-k for every query:
        ivf_block with certificates, refusals re-probed at doubled n_probe
        (up to n_widen rounds, m_pool doubling with it over reduced-
        precision slabs) and the rest escalated to mode "exact".
        enable_ivf() runs on demand for the ivf modes.

        Under ``torch.profiler`` a call is one ``arrowspace:search`` range
        holding, in order, ``search.query_lambda`` (query lambdas and unit
        queries), ``search.scan``, ``search.rescore`` (the float32 rescore
        of a pool: modes int8 and subtile) and ``search.to_host``;
        certified serving's inner calls nest in its one range."""
        with span("search"):
            return self._search_batch(queries, gl, tau, topk=topk, mode=mode,
                                      n_probe=n_probe, certify=certify,
                                      n_widen=n_widen, m_pool=m_pool,
                                      q_block=q_block)

    def _search_batch(self, queries, gl: GraphLaplacian, tau: float,
                      topk: Optional[int] = None, mode: str = "exact",
                      n_probe: int = 8, certify: bool = False,
                      n_widen: int = 2, m_pool: Optional[int] = None,
                      q_block: Optional[int] = None):
        """search_batch without its ``search`` range."""
        if certify and mode != "ivf_block":
            raise ValueError("certify=True requires mode='ivf_block'")
        if mode not in _MODES:
            raise ValueError(f"unknown search mode {mode!r}; expected "
                             "'auto', 'exact', 'int8', 'subtile', 'ivf', "
                             "'ivf_block', or 'certified'")
        if mode == "certified":
            self._warn_volatile_nprobe(n_probe)
            q = self._as_queries(queries)
            topk_eff = min(gl.params.topk if topk is None else int(topk),
                           self.nitems)
            base_m = (m_pool if m_pool is not None
                      else max(4 * topk_eff, topk_eff + 6))
            out = self._search_batch(q, gl, tau, topk=topk_eff,
                                     mode="ivf_block", n_probe=n_probe,
                                     certify=True, m_pool=base_m,
                                     q_block=q_block)
            idx, vals, _ = self._certified_finalize(
                q, out, gl, tau, topk_eff, n_probe, n_widen, base_m,
                q_block=q_block)
            return idx, vals
        if mode == "auto":
            mode = ("subtile" if self.nitems >= AUTO_SUBTILE_MIN_ITEMS
                    else "exact")
        q = self._batch_queries(queries)
        topk = gl.params.topk if topk is None else int(topk)
        topk = min(topk, self.nitems)
        f32 = torch.float32
        if mode == "int8":
            if self._quantized is None:
                self._quantized = quantize_rows(self._data_unit.to(f32))
            xq, scales = self._quantized
            idx, vals = search_ops.fused_query_pipeline_quantized(
                self._data_unit.to(f32), xq, scales, self._lambdas.to(f32),
                self._lap_f.to(f32), self._w_f.to(f32),
                self._tau_star.to(f32), q.to(f32), float(tau), topk=topk,
                rescore_m=min(4 * topk, self.nitems),
                rayleigh_normalized=self._rayleigh_normalized,
                tau_mix=self._tau_mix)
            return _to_host(idx, vals)
        if mode == "ivf":
            if self._ivf is None:
                self.enable_ivf()
            with span("search.query_lambda"):
                qn = unit_normalize(q)
                lam_q = self._query_lambdas(q)
            with span("search.scan"):
                idx, vals = ivf_lambda_search(
                    self._data_unit, self._lambdas, self._ivf, qn, lam_q,
                    torch.as_tensor(tau, dtype=self._data.dtype,
                                    device=self.device),
                    n_probe=n_probe, topk=topk)
            return _to_host(idx, vals)
        if mode == "subtile":
            if self._subtile is None:
                self._subtile = build_subtile_state(
                    self._data_unit.to(f32), self._lambdas.to(f32))
            st = self._subtile
            idx, vals = search_ops.fused_query_pipeline_subtile(
                st["xu_scan"], st["xu_f32"], st["lambdas"], st["n_real"],
                self._lap_f.to(f32), self._w_f.to(f32),
                self._tau_star.to(f32), q.to(f32), float(tau), topk=topk,
                rayleigh_normalized=self._rayleigh_normalized,
                tau_mix=self._tau_mix)
            return _to_host(idx, vals)
        if mode == "ivf_block":
            out = self._ivf_block_dispatch(q, float(tau), topk, n_probe,
                                           certify, m_pool, q_block=q_block,
                                           pack_out=certify)
            if certify:
                return ivf_ops.unpack_certified(_to_host(out)[0], topk)
            return _to_host(out[0], out[1])
        tau_arg = (float(tau) if self.device.type == "cuda"
                   else torch.as_tensor(tau, dtype=self._data.dtype))
        idx, vals = search_ops.fused_query_pipeline(
            self._data_unit, self._lambdas, self._lap_f, self._w_f,
            self._tau_star, q, tau_arg, topk=topk,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix)
        return _to_host(idx, vals)

    def as_serving(self, dtype=None) -> "ArrowSpace":
        """A serving view: the scanned unit rows cast to ``dtype`` (default
        bfloat16; kernel K2 reads them as they are, with the queries
        rounded to bfloat16 and float32 sums).  Rankings can differ from
        float32 only on near-ties; build state and lambdas keep full
        precision, and the subtile, int8 and IVF modes cast to float32
        where the JAX package does."""
        dtype = dtype or torch.bfloat16
        clone = ArrowSpace._from_build(
            data=self._data, data_unit=self._data_unit.to(dtype),
            lambdas=self._lambdas, e_raw=self._e_raw, e_un=self._e_un,
            lap_f=self._lap_f, w_f=self._w_f, tau_star=self._tau_star,
            params=self._params,
            rayleigh_normalized=self._rayleigh_normalized,
            tau_mix=self._tau_mix, centroids=self._centroids,
            assignments=self._assignments)
        clone._energy_maps = self._energy_maps
        return clone

    @property
    def data(self) -> np.ndarray:
        return self._data.cpu().numpy()

    @property
    def tau_star(self) -> float:
        return float(self._tau_star)

    def spectral_summary(self) -> dict:
        """Eigen-summary of the F x F feature Laplacian: spectral gap,
        algebraic connectivity, spectral radius, the number of zero
        eigenvalues and the full spectrum (cached)."""
        if self._spectral_cache is None:
            evals = torch.linalg.eigvalsh(self._lap_f).cpu().numpy()
            evals = np.maximum(evals, 0.0)
            nonzero = evals[evals > 1e-10]
            self._spectral_cache = {
                "eigenvalues": evals,
                "spectral_radius": float(evals[-1]),
                "algebraic_connectivity": float(nonzero[0])
                if nonzero.size else 0.0,
                "spectral_gap": float(nonzero[0]) if nonzero.size else 0.0,
                "n_components": int((evals <= 1e-10).sum()),
            }
        return self._spectral_cache

    @property
    def feature_laplacian(self) -> np.ndarray:
        return self._lap_f.cpu().numpy()

    def __repr__(self) -> str:
        return (f"ArrowSpace(nitems={self.nitems}, "
                f"nfeatures={self.nfeatures}, tau_star={self.tau_star:.6g})")
