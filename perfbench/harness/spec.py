"""Finding a cell's parts by name: everything a run needs comes from
``BENCHMARK.json`` and from files named after its entries, so a new cell,
traffic mix, configuration or per-layer metric is new files and entries,
and no existing file changes.

  configs[].file                  the deployment (sizes, parameters, laws)
  perfbench/traffic/<mix>.json    the traffic mix; its "loop" names
  perfbench/loops/<loop>.py       the general generator that drives it
  perfbench/metrics/<metric>.py   one per-layer metric's reader
  perfbench/limits/<cell>.json    the limits of the cell's ``correct``
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents, with its "name"
    loop: object          # the loop module
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # BENCHMARK.json entries reported with --trace 1
    readers: dict         # per-layer metric name -> reader module
    limits: dict          # compared number -> {"max": x} or {"min": x}


def load_module(path: str, name: str):
    """Import the Python file at ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed under its
    "workloads", or, without that key, in every cell (an end-to-end
    metric) or every cell that reports the metric it moves (a per-layer
    one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell called ``name`` with its configuration, traffic mix, loop
    and per-layer readers, each found by its name."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(work))})")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, confs[w["config"]]["file"])) as fh:
        config = json.load(fh)
    bench_dir = os.path.join(root, "perfbench")
    traffic_file = os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")
    with open(traffic_file) as fh:
        traffic = dict(json.load(fh), name=w["traffic"])
    loop = load_module(os.path.join(bench_dir, "loops",
                                    f"{traffic['loop']}.py"),
                       f"perfbench_loop_{traffic['loop']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    readers = {m["name"]: load_module(
        os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
        "perfbench_metric_" + m["name"].replace(".", "_"))
        for m in per_layer}
    with open(os.path.join(bench_dir, "limits", f"{name}.json")) as fh:
        limits = json.load(fh)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, loop=loop, end_to_end=e2e,
                per_layer=per_layer, readers=readers, limits=limits)
