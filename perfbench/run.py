"""Run one cell of the benchmark of pyarrowspace_tpu_torch once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  The run builds the cell's CUDA libraries into the
checkout's ``build/`` (only the first run in a checkout compiles), makes
the inputs on the device from ``--seed``, warms up the cell's shapes, then
measures a closed loop for ``--seconds`` (with ``--trace 1`` under
``torch.profiler``), checks what the timed path produced against the
plain reference in ``perfbench/reference/``, prints each compared number
beside its limit as the last lines of standard error, and prints one JSON
object as the last line of standard output.  It exits non-zero, with no
result, when there is no such device, when the program is not in the
checkout, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment() -> None:
    """Every cache of the program in fixed directories of the checkout, and
    none of the program's ARROWSPACE_* switches taken from outside."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    for key in [k for k in os.environ if k.startswith("ARROWSPACE_")]:
        del os.environ[key]


def _fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, HERE)
    from harness import runner, spec

    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA device", 2)
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} CUDA devices, "
                     f"found {torch.cuda.device_count()}", 2)
    sys.path.insert(0, ROOT)
    try:
        import pyarrowspace_tpu_torch as program
        from pyarrowspace_tpu_torch import _build
    except ImportError as e:
        return _fail(f"the program is not in this checkout: {e}", 2)
    if not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
        return _fail(f"pyarrowspace_tpu_torch loaded from outside the "
                     f"checkout: {program.__file__}", 2)
    torch.set_num_threads(4)
    _build.load_all(cell.traffic["libraries"])
    result = runner.execute(
        cell, torch=torch, device=torch.device("cuda", 0), program=program,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        trace_path=runner.trace_file(ROOT, args.workload), t_start=T_START)
    bad = runner.forbidden_modules(list(sys.modules))
    if bad:
        return _fail(f"forbidden modules loaded: {', '.join(bad)}", 3)
    for line in runner.compared_lines(result["compared"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
