"""Nothing that a run loads is JAX or the JAX package: every module that
perfbench/run.py and the reference load, compared by whole top-level names
(the port's name begins with the JAX package's), and a reference that loads
nothing of the port."""

import os
import subprocess
import sys

from harness import runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

_RUN = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import run                  # perfbench/run.py, as the command loads it
import tiny
for name in sorted(tiny.SIZES):
    tiny.run(tiny.cell(name))        # every loop, reader and the reference
    tiny.run(tiny.cell(name), trace=True, trace_path={trace!r})
print(json.dumps(sorted(sys.modules)))
"""

_REF = r"""
import json, sys
sys.path[:0] = [{bench!r}]
import reference.graph, reference.serve, reference.spectral
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_whole_names_are_compared():
    assert runner.forbidden_modules(["pyarrowspace_tpu_torch",
                                     "pyarrowspace_tpu_torch.ops"]) == []
    assert runner.forbidden_modules(["pyarrowspace_tpu.core", "jaxlib.x",
                                     "flax", "jaxtyping"]) == [
        "flax", "jaxlib", "pyarrowspace_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    mods = _modules(_RUN.format(bench=BENCH, root=ROOT,
                                tests=os.path.join(BENCH, "tests"),
                                trace=str(tmp_path / "t.json")))
    assert "pyarrowspace_tpu_torch" in mods
    assert runner.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_either_package():
    mods = _modules(_REF.format(bench=BENCH))
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "pyarrowspace_tpu",
                       "pyarrowspace_tpu_torch", "harness"}
