"""The port's spans (utils/debug.py::span): under ``torch.profiler`` each
search_batch call is one ``arrowspace:search`` range holding its stages in
order, and the build's reduction holds its four steps; with no profiler a
span enters no ``record_function``; ``phase`` keeps its names, its timing
table and its closing synchronise; and the spans change no result."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.utils import debug

GP = {"eps": 1.0, "k": 6, "topk": 5, "p": 2.0, "sigma": 0.3}
TAU = 0.62
# Past the build's reduction_min_n (4,096), so the reduction runs.
N_ITEMS = 4200

STAGES = {
    "exact": ["query_lambda", "scan", "to_host"],
    "subtile": ["query_lambda", "scan", "rescore", "to_host"],
    "int8": ["query_lambda", "scan", "rescore", "to_host"],
    "ivf": ["query_lambda", "scan", "to_host"],
    "ivf_block": ["query_lambda", "scan", "to_host"],
}


def _ranges(prof, prefix="arrowspace:"):
    """(name, start, end) of the profile's ranges named ``prefix``..., in
    the order they opened."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def traced_build():
    """A small index built under the profiler: (aspace, gl, its ranges)."""
    items = np.random.default_rng(5).normal(size=(N_ITEMS, 12))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aspace, gl = pt.ArrowSpaceBuilder.build(GP, items, device="cpu")
    return aspace, gl, _ranges(prof), items


def _queries(items):
    return items[:16] + 0.01


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_search_batch_is_one_range_with_its_stages_in_order(traced_build,
                                                            mode):
    aspace, gl, _, items = traced_build
    aspace.search_batch(_queries(items), gl, TAU, mode=mode)   # state made
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aspace.search_batch(_queries(items), gl, TAU, mode=mode)
    ranges = _ranges(prof)
    roots = [r for r in ranges if r[0] == "arrowspace:search"]
    assert len(roots) == 1
    kids = [r for r in ranges if r[0] != "arrowspace:search"]
    assert [r[0] for r in kids] == [f"arrowspace:search.{s}"
                                    for s in STAGES[mode]]
    assert all(_inside(k, roots[0]) for k in kids)
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


def test_certified_inner_calls_nest_under_one_range(traced_build):
    """Certified serving's ivf_block call and its escalations open no
    second ``arrowspace:search``: the call counts once."""
    aspace, gl, _, items = traced_build
    aspace.search_batch(_queries(items), gl, TAU, mode="certified")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aspace.search_batch(_queries(items), gl, TAU, mode="certified")
    ranges = _ranges(prof)
    roots = [r for r in ranges if r[0] == "arrowspace:search"]
    assert len(roots) == 1
    kids = [r for r in ranges if r[0] != "arrowspace:search"]
    assert [r[0] for r in kids[:3]] == [
        "arrowspace:search.query_lambda", "arrowspace:search.scan",
        "arrowspace:search.to_host"]
    assert all(_inside(k, roots[0]) for k in kids)


def test_the_reduction_steps_nest_in_its_phase(traced_build):
    ranges = traced_build[2]
    red = [r for r in ranges if r[0] == "arrowspace:reduction"]
    assert len(red) == 1
    steps = [r for r in ranges if r[0].startswith("arrowspace:reduction.")]
    assert [r[0] for r in steps] == [
        "arrowspace:reduction.twonn", "arrowspace:reduction.select_k",
        "arrowspace:reduction.lloyd", "arrowspace:reduction.assign"]
    assert all(_inside(s, red[0]) for s in steps)
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))


def test_no_profiler_enters_no_record_function(traced_build, monkeypatch):
    aspace, gl, _, items = traced_build

    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert debug.span("search") is debug.span("search.scan")
    with debug.phase("probe"):
        pass
    for mode in ("exact", "subtile", "int8", "ivf_block", "certified"):
        aspace.search_batch(_queries(items), gl, TAU, mode=mode)
    pt.ArrowSpaceBuilder.build(GP, items[:600], device="cpu")


def test_phase_keeps_its_name_table_and_synchronise(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    debug.reset_phase_timings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with debug.phase("probe", "cuda"):
            pass
    assert synced == ["cuda"]
    assert [r[0] for r in _ranges(prof)] == ["arrowspace:probe"]
    assert set(debug.get_phase_timings()) == {"probe"}
    with debug.phase("probe_cpu", "cpu"):
        pass
    assert synced == ["cuda"]
    assert set(debug.get_phase_timings()) == {"probe", "probe_cpu"}


@pytest.mark.parametrize("mode", ["exact", "subtile", "int8", "ivf_block",
                                  "certified"])
def test_spans_change_no_result(traced_build, mode):
    aspace, gl, _, items = traced_build
    ids0, sc0 = aspace.search_batch(_queries(items), gl, TAU, mode=mode)
    with profile(activities=[ProfilerActivity.CPU]):
        ids1, sc1 = aspace.search_batch(_queries(items), gl, TAU, mode=mode)
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_array_equal(np.ascontiguousarray(sc1).view(np.uint8),
                                  np.ascontiguousarray(sc0).view(np.uint8))
