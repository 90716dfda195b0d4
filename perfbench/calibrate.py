"""The readings that the limits of ``correct`` are set from: for each
cell, the numbers of sound runs of the program on many seeds, and the
numbers of the control (the reference in TF32 put in the program's place)
on some of them, all in one process.

    python3 perfbench/calibrate.py --workload cve313k.build --seeds 1 2 3 \
        --control 3 [--out calibrate.jsonl]

Each seed runs the cell's timed path at the cell's own sizes, without a
measured window: one build (the build loop), or each distinct batch once
(the serve loop), then the same check as a run.  Prints one JSON line a
seed and program or control, and the largest reading of each number over
the program's seeds and the smallest over the control's.
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, torch, device, program, seed: int, control: bool):
    loop = cell.loop
    ctx = SimpleNamespace(torch=torch, device=device, program=program,
                          config=cell.config,
                          traffic=dict(cell.traffic, warmup=0), seed=seed)
    st = loop.setup(ctx)
    if cell.traffic["loop"] == "build":
        loop.step(st)
    else:
        for _ in range(int(cell.traffic["batches"])):
            loop.step(st)
    loop.finish(st)
    out = {"program": loop.numbers(st)}
    if control:
        out["control"] = loop.numbers(st, control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="the control runs on the first CONTROL seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch
    import pyarrowspace_tpu_torch as program
    from harness import spec
    from pyarrowspace_tpu_torch import _build
    bench = spec.load_benchmark(ROOT)
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for name in args.workload:
            cell = spec.find_cell(bench, name, ROOT)
            _build.load_all(cell.traffic["libraries"])
            worst, least = {}, {}
            for t, seed in enumerate(args.seeds):
                t0 = time.perf_counter()
                r = readings(cell, torch, device, program, seed,
                             t < args.control)
                line = dict(workload=name, seed=seed,
                            seconds=time.perf_counter() - t0, **r)
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
                for k, v in r["program"].items():
                    worst[k] = max(worst.get(k, v), v) if k != "recall" \
                        else min(worst.get(k, v), v)
                for k, v in r.get("control", {}).items():
                    least[k] = min(least.get(k, v), v) if k != "recall" \
                        else max(least.get(k, v), v)
            summary = dict(workload=name, seeds=len(args.seeds),
                           program_worst=worst, control_best=least)
            print(json.dumps(summary), flush=True)
            if sink:
                sink.write(json.dumps(summary) + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
