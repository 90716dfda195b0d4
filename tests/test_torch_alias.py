"""The `arrowspace_torch` alias: tests/test_compat_and_sweep.py's
drop-in case, pointed at the PyTorch port (on the CPU)."""

import sys

import numpy as np
import pytest


def test_arrowspace_torch_alias_is_drop_in():
    # A reference user's import lines work with the one name changed.
    from arrowspace_torch import ArrowSpaceBuilder, GraphLaplacian, set_debug
    items = np.array([[0.1, 0.2, 0.3], [0.0, 0.5, 0.1], [0.9, 0.1, 0.0]])
    gp = {"eps": 1.0, "k": 6, "topk": 3, "p": 2.0, "sigma": 1.0}
    aspace, gl = ArrowSpaceBuilder.build(gp, items, device="cpu")
    hits = aspace.search(np.array([0.05, 0.2, 0.25]), gl, 1.0)
    assert hits[0][0] == 0
    with pytest.raises(ValueError):
        GraphLaplacian()
    set_debug(False)


def test_arrowspace_torch_reexports_the_port():
    import arrowspace_torch
    import pyarrowspace_tpu_torch as pt
    for name in arrowspace_torch.__all__:
        assert getattr(arrowspace_torch, name) is getattr(pt, name), name
    assert arrowspace_torch.__version__ == pt.__version__
    assert "pyarrowspace_tpu_torch" in sys.modules
