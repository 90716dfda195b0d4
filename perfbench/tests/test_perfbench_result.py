"""The result line's schema, from runs of the tiny cells on the CPU past
the check for a CUDA device: the keys a result must carry, the cell's
end-to-end metrics with --trace 0 and per-layer ones with --trace 1,
numbers that JSON holds, and the compared numbers last."""

import json

import pytest

import tiny
from harness import runner, spec

CELLS = sorted(tiny.SIZES)


def _check_common(out, c):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["count"] == c.chips
    for name, v in out["compared"].items():
        assert name in c.limits
        assert set(v) in ({"value", "max"}, {"value", "min"})
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_the_cells_end_to_end_metrics(name):
    c = tiny.cell(name)
    out = tiny.run(c)
    _check_common(out, c)
    want = {m["name"]: m["unit"] for m in c.end_to_end}
    assert "setup_s" in want
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for k, v in out["metrics"].items()
               if k != "build_peak_gib")      # no device memory on the CPU


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics_and_breakdown(name, tmp_path):
    c = tiny.cell(name)
    out = tiny.run(c, trace=True, trace_path=str(tmp_path / "t.json"))
    _check_common(out, c)
    names = {m["name"] for m in c.per_layer}
    assert set(out["metrics"]) <= names
    # No device on the CPU: the readers of device time find nothing and
    # their metrics are left out, never reported as 0.
    assert not any(k.endswith("roofline_pct") or k.startswith("idle_pct")
                   for k in out["metrics"])
    if c.traffic["loop"] == "build":
        assert {"knn_s", "graph_s", "spectral_s"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    bd = out["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_compared_lines_name_each_number_and_limit():
    lines = runner.compared_lines({"a": {"value": 1.5, "max": 2.0},
                                   "b": {"value": 0.995, "min": 0.99}})
    assert lines == ["perfbench compared: a 1.5 <= 2.0",
                     "perfbench compared: b 0.995 >= 0.99"]


def test_every_workload_is_found_with_its_parts():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.find_cell(bench, w["name"])
        assert c.end_to_end and c.per_layer
        assert "setup_s" in {m["name"] for m in c.end_to_end}
        assert set(c.readers) == {m["name"] for m in c.per_layer}
