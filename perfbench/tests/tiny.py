"""Tiny cells for the CPU tests: the benchmark's own cells with the corpus
and the batches cut to sizes a test run holds."""

import copy

SIZES = {
    "cve313k.build": dict(n_items=4500, n_features=16),
    "msmarco1m.build": dict(n_items=4500, n_features=24),
    "cve313k.serve_exact": dict(n_items=3000, n_features=16),
    "msmarco1m.serve_auto": dict(n_items=3000, n_features=24),
}
TRAFFIC = {"batch": 192, "batches": 2, "check_rows": 24}


def cell(name: str, **traffic):
    """The cell ``name`` of BENCHMARK.json at a tiny size (serve cells in
    mode subtile where they run auto: auto is exact below 131,072 items)."""
    from harness import spec
    c = spec.find_cell(spec.load_benchmark(), name)
    c.config = dict(copy.deepcopy(c.config), **SIZES[name])
    if c.config["corpus"]["law"] == "mixture":
        c.config["corpus"]["centres"] = 64
    if c.traffic["loop"] == "serve":
        c.traffic = dict(c.traffic, **TRAFFIC)
        if c.traffic["mode"] == "auto":
            c.traffic["mode"] = "subtile"
    c.traffic = dict(c.traffic, **traffic)
    return c


def run(c, seed=7, seconds=0.2, trace=False, trace_path=None):
    """One run of the tiny cell on the CPU, past the check for a CUDA device."""
    import time

    import torch

    import pyarrowspace_tpu_torch as program
    from harness import runner
    return runner.execute(c, torch=torch, device=torch.device("cpu"),
                          program=program, seed=seed, seconds=seconds,
                          trace=trace, trace_path=trace_path,
                          t_start=time.perf_counter())
