"""Pipelined certified serving for batch streams (port of
pyarrowspace_tpu/serving.py).

``search_batch(mode="certified")`` is synchronous per call: it dispatches
the certified scan, brings the per-query certificates to the host (the
only way to decide widening and escalation), and only then returns.
``CertifiedStream`` keeps up to ``depth`` certified dispatches in flight,
so while batch i's certificates travel to the host, batches i+1.. are
already running on the device; widening and exact escalation are the only
work left on the critical path.

It also carries the guardrail for certificate collapse (a bad clustering
or an out-of-distribution query mix can refuse every batch, and widening
every batch costs far more than the exact scan): when the base
certification rate stays under ``cert_floor`` for ``floor_patience``
consecutive batches, the stream first tries an escalation rung
(``on_collapse``, e.g. a doubled n_probe) and, when none is left, reroutes
later batches to an exact ``fallback``.  Results stay exact either way.

Unlike the reference, a batch dispatched before the last escalation took
effect counts toward neither the streak nor a rung nor the degradation:
its rate describes the old setting.  (The reference's ladder can spend a
second rung, and then degrade, on batches that were already in flight at
the old n_probe when the first rung fired; ROADMAP.md §3.)
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

from .utils.logging import get_logger

_log = get_logger("serving")


class CertifiedStream:
    """Bounded-depth software pipeline over certified search dispatches.

    Parameters
    ----------
    dispatch : (queries) -> out
        Start the certified search of one batch without waiting for it.
    finalize : (queries, out) -> (idx, vals, base_cert_rate)
        Wait for the certificate, widen/escalate refusals, and return the
        exact results and the base certification rate (before widening).
    fallback : (queries) -> fut, finalize_fallback : (queries, fut) -> (idx, vals)
        The exact serving path after certificate collapse.  Without them
        the stream keeps certifying.
    depth : int
        Most batches in flight; depth=1 is the synchronous behaviour.
    cert_floor / floor_patience
        Collapse: the base rate under ``cert_floor`` for ``floor_patience``
        consecutive batches dispatched at the current setting.
    on_collapse : () -> bool, optional
        Escalation rung tried before degrading; True means the caller
        changed the certified dispatch (the streak restarts, and batches
        dispatched before it no longer count).  Batch indices where a rung
        fired are in ``escalated_at``.
    """

    def __init__(self, dispatch: Callable, finalize: Callable,
                 fallback: Optional[Callable] = None,
                 finalize_fallback: Optional[Callable] = None,
                 depth: int = 4, cert_floor: float = 0.35,
                 floor_patience: int = 2,
                 on_collapse: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if (fallback is None) != (finalize_fallback is None):
            raise ValueError("fallback and finalize_fallback must be "
                             "given together")
        self._dispatch = dispatch
        self._finalize = finalize
        self._fallback = fallback
        self._finalize_fallback = finalize_fallback
        self._depth = int(depth)
        self._cert_floor = float(cert_floor)
        self._floor_patience = int(floor_patience)
        self._on_collapse = on_collapse
        self._inflight: deque = deque()
        self._results: list = []
        self._low_streak = 0
        # Escalations so far; each certified batch carries the value at its
        # dispatch, so a rung only counts batches dispatched after it.
        self._setting = 0
        self.degraded_at: Optional[int] = None   # batch index, or None
        self.escalated_at: list = []             # batch indices
        self.base_cert_rates: list = []

    @property
    def degraded(self) -> bool:
        return self.degraded_at is not None

    def submit(self, queries) -> None:
        """Dispatch one batch; blocks only when the pipeline is full (then
        it finalizes the oldest in-flight batch)."""
        if self.degraded and self._fallback is not None:
            entry = ("fallback", queries, self._fallback(queries), None)
        else:
            entry = ("certified", queries, self._dispatch(queries),
                     self._setting)
        self._inflight.append(entry)
        while len(self._inflight) >= self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        kind, queries, out, setting = self._inflight.popleft()
        if kind == "fallback":
            idx, vals = self._finalize_fallback(queries, out)
            # The fallback is the exact scan: its results satisfy certified
            # serving's contract by construction.
            self._results.append((idx, vals, 1.0))
            return
        idx, vals, rate = self._finalize(queries, out)
        self.base_cert_rates.append(float(rate))
        self._results.append((idx, vals, float(rate)))
        if ((self._fallback is None and self._on_collapse is None)
                or self.degraded or setting != self._setting):
            return
        self._low_streak = (self._low_streak + 1
                            if rate < self._cert_floor else 0)
        if self._low_streak < self._floor_patience:
            return
        self._low_streak = 0
        if self._on_collapse is not None and self._on_collapse():
            # An escalation rung (e.g. a deeper probe list): keep
            # certifying at the new setting.
            self.escalated_at.append(len(self._results) - 1)
            self._setting += 1
            return
        if self._fallback is None:
            # Nothing left to degrade to: keep certifying and stop calling
            # the exhausted escalation hook.
            self._on_collapse = None
            return
        self.degraded_at = len(self._results) - 1
        _log.warning(
            "certification collapsed (base rate < %.2f for %d consecutive "
            "batches, last %.3f): rerouting subsequent batches to the "
            "exact fallback path", self._cert_floor, self._floor_patience,
            rate)

    def finish(self) -> list:
        """Finalize every in-flight batch and return the accumulated
        [(idx, vals, base_cert_rate)] in submission order."""
        while self._inflight:
            self._drain_one()
        out, self._results = self._results, []
        return out
