"""One run of one cell, after the check for a CUDA device: set-up, the
measured window (traced or not), the metrics, the check, and the result
line.

``execute`` takes the device and the program's module as arguments, so the
same run drives a tiny cell on the CPU in the tests.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

from harness import checks
from harness.trace import WINDOW, profile_to, record
from harness.window import run_window

# Top-level module names that must not be loaded in the process that
# prints the result: the JAX package and JAX itself (the port's name begins
# with the JAX package's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "pyarrowspace_tpu")


def forbidden_modules(modules) -> list:
    """The top-level names among ``modules`` (sys.modules' keys) that are
    forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def execute(cell, *, torch, device, program, seed: int, seconds: float,
            trace: bool, trace_path: str, t_start: float) -> dict:
    """Run ``cell`` once and return its result (the last line's object)."""
    loop = cell.loop
    ctx = SimpleNamespace(torch=torch, device=device, program=program,
                          config=cell.config, traffic=cell.traffic,
                          seed=int(seed))
    cuda = device.type == "cuda"
    st = loop.setup(ctx)
    setup_s = time.perf_counter() - t_start

    def window():
        with record(WINDOW):
            return run_window(lambda: loop.step(st), seconds)

    tr = None
    if trace:
        win, tr = profile_to(window, trace_path, cuda)
    else:
        win = window()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = loop.counts(win)

    if trace:
        mctx = SimpleNamespace(records=win.records, trace=tr,
                               shapes=loop.shapes(ctx))
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(mctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(loop.end_to_end(win), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}

    loop.finish(st)
    numbers = loop.numbers(st)
    ok, compared = checks.judge(numbers, cell.limits)
    ok = ok and failed == 0 and attempted > 0
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    limit_w = power_limit_w() if cuda else None
    if limit_w is not None:
        dev["power_limit_w"] = limit_w
    out = {"correct": bool(ok), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        out["breakdown"] = tr.breakdown()
    out["compared"] = compared
    return out


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi (None if it cannot
    be read)."""
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(p.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def compared_lines(compared: dict) -> list:
    """One line a number: its name, value and limit."""
    out = []
    for name, v in compared.items():
        op, lim = ("<=", v["max"]) if "max" in v else (">=", v["min"])
        out.append(f"perfbench compared: {name} {v['value']!r} {op} {lim!r}")
    return out


def trace_file(root: str, workload: str) -> str:
    """The fixed path of a traced run's Chrome trace, inside the checkout's
    ignored build directory."""
    d = os.path.join(root, "build", "perfbench")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{workload}.trace.json")
