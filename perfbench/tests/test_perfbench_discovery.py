"""A later change adds a cell, a traffic mix, a configuration and a
per-layer metric as new files and entries alone: the harness finds each by
its name, and no file that was there changes."""

import hashlib
import json
import os
import shutil

import tiny
from harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

READER = '''"""steps_seen: the window's steps (a test metric)."""


def read(ctx):
    return float(len(ctx.records)) if ctx.records else None
'''


def _hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _hashes(root)

    cfg = json.loads((root / "perfbench/configs/cve-313k-384.json")
                     .read_text())
    cfg.update(name="small-gauss", n_items=2500, n_features=8)
    (root / "perfbench/configs/small-gauss.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/serve_exact.json")
                     .read_text())
    mix.update(batch=64, batches=3, check_rows=16, topk=7)
    (root / "perfbench/traffic/serve_small.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/steps_seen.py").write_text(READER)
    (root / "perfbench/limits/small.serve_small.json").write_text(
        (root / "perfbench/limits/cve313k.serve_exact.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small-gauss",
                             "source": "https://example.org/small",
                             "file": "perfbench/configs/small-gauss.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "small.serve_small",
                               "config": "small-gauss",
                               "traffic": "serve_small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("qps", "batch_p95_ms", "idle_pct.serve"):
            m["workloads"].append("small.serve_small")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["small.serve_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _hashes(root)
    changed = [p for p in before if after[p] != before[p]]
    assert changed == ["BENCHMARK.json"]     # entries added, no file edited
    assert set(after) - set(before) == {
        "perfbench/configs/small-gauss.json",
        "perfbench/traffic/serve_small.json", "perfbench/metrics/steps_seen.py",
        "perfbench/limits/small.serve_small.json"}

    c = spec.find_cell(spec.load_benchmark(str(root)), "small.serve_small",
                       str(root))
    assert c.config["n_items"] == 2500 and c.traffic["topk"] == 7
    assert c.traffic["name"] == "serve_small"
    assert [m["name"] for m in c.per_layer] == ["idle_pct.serve",
                                                "steps_seen"]
    assert {m["name"] for m in c.end_to_end} == {"qps", "batch_p95_ms",
                                                 "setup_s"}
    out = tiny.run(c, trace=True, trace_path=str(tmp_path / "t.json"))
    assert out["correct"] is True
    assert out["metrics"]["steps_seen"]["value"] >= 1
    assert out["metrics"]["steps_seen"]["unit"] == "steps"
    # The existing cells are found as before.
    for w in ("cve313k.build", "msmarco1m.serve_auto"):
        assert spec.find_cell(spec.load_benchmark(str(root)), w, str(root))
