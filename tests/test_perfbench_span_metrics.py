"""The benchmark's readers of the port's spans (perfbench/metrics/
search.idle_ms, search.to_host_ms, query_lambda_ms, rescore_ms,
reduction.idle_ms), loaded by path as the harness loads them, on
hand-made Chrome-trace events; and, on the tiny CPU cells, their device-time
metrics left out of a traced run's line."""

import os
import sys
from types import SimpleNamespace

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import spec  # noqa: E402
from harness.trace import Trace  # noqa: E402

DEVICE_TIME = ("search.idle_ms", "query_lambda_ms", "rescore_ms",
               "reduction.idle_ms")
READERS = DEVICE_TIME + ("search.to_host_ms",)


def _reader(name):
    return spec.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                            "perfbench_metric_" + name.replace(".", "_"))


def _ev(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _kernel(ts, dur, corr, launch_ts):
    """A kernel and the runtime call that launched it."""
    return [_ev("k", "kernel", ts, dur, corr),
            _ev("cudaLaunchKernel", "cuda_runtime", launch_ts, 2, corr)]


def _ctx(events):
    return SimpleNamespace(trace=Trace(events), records=[], shapes={})


def _read(name, events):
    return _reader(name).read(_ctx(events))


WINDOW = [_ev("perfbench:window", "user_annotation", 0, 1000)]
# Busy 0-100, 300-500, 800-1000 us: idle 100-300 and 500-800.
BUSY = (_kernel(0, 100, 1, 0) + _kernel(300, 200, 2, 290)
        + _kernel(800, 200, 3, 790))


@pytest.mark.parametrize("name,span", [
    ("search.idle_ms", "arrowspace:search"),
    ("reduction.idle_ms", "arrowspace:reduction")])
def test_idle_clipped_to_spans_over_their_number(name, span):
    # The first span holds 150-300 of the gap 100-300 and none of 500-800;
    # the second straddles the gap 500-800 from 450 to 600: 100 us of it.
    # The idle time outside both (100-150, 600-800) is not theirs.
    spans = [_ev(span, "user_annotation", 150, 250),
             _ev(span, "user_annotation", 450, 150)]
    got = _read(name, WINDOW + BUSY + spans)
    assert got == pytest.approx((150 + 100) * 1e-3 / 2)


@pytest.mark.parametrize("name,span", [
    ("search.idle_ms", "arrowspace:search"),
    ("reduction.idle_ms", "arrowspace:reduction")])
def test_idle_counts_a_gap_under_nested_spans_once(name, span):
    spans = [_ev(span, "user_annotation", 100, 700),
             _ev(span, "user_annotation", 200, 50),
             _ev(f"{span}.step", "user_annotation", 120, 100)]
    got = _read(name, WINDOW + BUSY + spans)
    assert got == pytest.approx((200 + 300) * 1e-3 / 2)


@pytest.mark.parametrize("name,span", [
    ("query_lambda_ms", "arrowspace:search.query_lambda"),
    ("rescore_ms", "arrowspace:search.rescore")])
def test_device_time_launched_within_by_correlation(name, span):
    # Kernel 7 is launched inside the first span and runs after it ends;
    # kernel 8 runs inside it but was launched before it: only 7 counts.
    # Kernel 9 is launched inside the second span.
    events = (WINDOW + [_ev(span, "user_annotation", 100, 50),
                        _ev(span, "user_annotation", 600, 50)]
              + _kernel(400, 40, 7, 120) + _kernel(110, 30, 8, 90)
              + _kernel(700, 20, 9, 610))
    assert _read(name, events) == pytest.approx((40 + 20) * 1e-3 / 2)


def test_to_host_is_the_spans_mean_duration():
    spans = [_ev("arrowspace:search.to_host", "user_annotation", 100, 300),
             _ev("arrowspace:search.to_host", "user_annotation", 600, 100)]
    assert _read("search.to_host_ms", WINDOW + spans) == pytest.approx(0.2)


@pytest.mark.parametrize("name", DEVICE_TIME)
def test_device_time_is_none_without_device_operations(name):
    span = {"search.idle_ms": "arrowspace:search",
            "reduction.idle_ms": "arrowspace:reduction",
            "query_lambda_ms": "arrowspace:search.query_lambda",
            "rescore_ms": "arrowspace:search.rescore"}[name]
    spans = [_ev(span, "user_annotation", 100, 300)]
    host = [_ev("aten::mm", "cpu_op", 120, 50)]
    assert _read(name, WINDOW + spans + host) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans_or_trace(name):
    assert _read(name, WINDOW + BUSY) is None
    assert _reader(name).read(SimpleNamespace(trace=None, records=[],
                                              shapes={})) is None


@pytest.mark.parametrize("cell", ["cve313k.build", "msmarco1m.build",
                                  "cve313k.serve_exact",
                                  "msmarco1m.serve_auto"])
def test_tiny_cpu_cells_leave_device_time_out(cell, tmp_path):
    """No device on the CPU: the readers of device time find nothing and
    their metrics are left out, never reported as 0 or as a CPU number;
    the host span's metric is read in the serve cells."""
    tiny = spec.load_module(os.path.join(BENCH, "tests", "tiny.py"),
                            "perfbench_tiny")
    c = tiny.cell(cell)
    out = tiny.run(c, trace=True, trace_path=str(tmp_path / "t.json"))
    assert out["correct"] is True
    assert not set(DEVICE_TIME) & set(out["metrics"])
    if c.traffic["loop"] == "serve":
        assert out["metrics"]["search.to_host_ms"]["value"] > 0
    else:
        assert "search.to_host_ms" not in out["metrics"]
