"""Parameter-sweep runner with per-config failure isolation.

The reference's sweep harnesses tolerate per-config build failures: the
failing config is recorded as FAILED with its error and the sweep continues
(reference tests/test_5_msmarco_eps_sweep.py:181-216,
test_8_CVE_db_sweep.py:293-295).  This generalizes that contract.
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable, Iterable, Mapping

from ..utils.logging import get_logger

log = get_logger("sweep")


def run_sweep(configs: Iterable[Mapping[str, Any]],
              run_one: Callable[[Mapping[str, Any]], Mapping[str, Any]],
              stop_on_error: bool = False) -> list[dict[str, Any]]:
    """Run `run_one(config)` for each config, isolating failures.

    Returns one row per config: the config keys + run_one's result keys +
    {"status": "OK"|"FAILED", "elapsed_s": float, ["error": repr]}.
    """
    rows: list[dict[str, Any]] = []
    for config in configs:
        row: dict[str, Any] = dict(config)
        t0 = time.perf_counter()
        try:
            result = run_one(config)
            row.update(result or {})
            row["status"] = "OK"
        except Exception as e:
            row["status"] = "FAILED"
            row["error"] = repr(e)
            log.warning("sweep config %s FAILED: %r", dict(config), e)
            if stop_on_error:
                row["elapsed_s"] = time.perf_counter() - t0
                rows.append(row)
                raise
            traceback.print_exc()
        row["elapsed_s"] = time.perf_counter() - t0
        rows.append(row)
    return rows


def grid(**axes: Iterable[Any]) -> list[dict[str, Any]]:
    """Cartesian product of named axes -> list of config dicts."""
    import itertools
    keys = list(axes)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(axes[k] for k in keys))]
