"""On the card: the control (the plain reference in TF32, the precision
below the configuration's float32, put in the program's place) comes out
not correct, and the program comes out correct, on three seeds, at a size
a test run holds (65,536 rows at each configuration's width; batches of
1,024 queries).  perfbench/calibrate.py takes the same readings at the
cells' own sizes, which the limits are set from.

    python -m pytest -p no:cacheprovider -m gpu perfbench/tests
"""

import copy

import pytest

from harness import checks, spec

pytestmark = pytest.mark.gpu

SEEDS = (2_147_483_659, 7, 31)


def _cell(name):
    c = spec.find_cell(spec.load_benchmark(), name)
    c.config = dict(copy.deepcopy(c.config), n_items=65_536)
    if c.traffic["loop"] == "serve":
        c.traffic = dict(c.traffic, batch=1024, check_rows=128)
        if c.traffic["mode"] == "auto":     # auto is exact below 131,072
            c.traffic["mode"] = "subtile"
    return c


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cve313k.build", "msmarco1m.build",
                                  "msmarco1m.serve_auto",
                                  "cve313k.serve_exact"])
def test_control_fails_and_program_passes(name, seed, cuda):
    import torch

    import calibrate
    import pyarrowspace_tpu_torch as program
    from pyarrowspace_tpu_torch import _build
    c = _cell(name)
    _build.load_all(c.traffic["libraries"])
    r = calibrate.readings(c, torch, cuda, program, seed, control=True)
    ok_prog, got = checks.judge(r["program"], c.limits)
    ok_ctrl, _ = checks.judge(r["control"], c.limits)
    assert ok_prog, got
    assert not ok_ctrl, r["control"]
