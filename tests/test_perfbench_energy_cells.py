"""The benchmark's energy and int8 serving cells: the readers k8.roofline_pct
and energy_route_ms (perfbench/metrics/, loaded by path as the harness loads
them) on hand-made Chrome-trace events; the routing keys and pool counts of
perfbench/reference/energy.py against the port's; and the cells
cve313k.serve_energy and msmarco1m.serve_int8 run whole at tiny sizes on
the CPU, correct, with their device-time metrics left out of a traced
run's line."""

import copy
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import pyarrowspace_tpu_torch as pt  # noqa: E402
from harness import roofline, runner, spec  # noqa: E402
from harness.trace import Trace  # noqa: E402
from reference import energy as ref_energy  # noqa: E402


def _reader(name):
    return spec.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                            "perfbench_metric_" + name.replace(".", "_"))


def _ev(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _kernel(name, ts, dur, corr, launch_ts):
    return [_ev(name, "kernel", ts, dur, corr),
            _ev("cudaLaunchKernel", "cuda_runtime", launch_ts, 2, corr)]


WINDOW = [_ev("perfbench:window", "user_annotation", 0, 10_000)]
K8_NARROW = "void narrow::scan_kernel<x, 2, (anonymous namespace)::EnergyEpi>"
SHAPES = {"n": 1000, "f": 64, "q": 100, "topk": 20, "bitmap_bytes": 6}


def test_k8_roofline_reads_its_kernels_in_the_scan_span():
    """K8's kernels launched inside search.scan count (after the range's
    end too); a kernel of another name there, or one of K8's names
    launched outside the span, does not."""
    events = (WINDOW
              + [_ev("arrowspace:search.scan", "user_annotation", 100, 50),
                 _ev("arrowspace:search.scan", "user_annotation", 5000, 50)]
              + _kernel("void narrow::scan_kernel<regtile::TmaRing<float, 4>, "
                        "2, (anonymous namespace)::EnergyEpi>", 200, 1000, 1,
                        110)
              + _kernel("void tile::merge_splits<2>", 1300, 100, 2, 140)
              + _kernel("void at::native::where_kernel", 1400, 500, 3, 145)
              + _kernel(K8_NARROW,
                        5100, 900, 4, 5010)
              + _kernel(K8_NARROW,
                        7000, 800, 5, 6900))
    records = [{"routed_items": 40_000}, {"routed_items": 60_000}]
    ctx = SimpleNamespace(trace=Trace(events), records=records,
                          shapes=SHAPES)
    got = _reader("k8.roofline_pct").read(ctx)
    least = 0.0
    for v in (40_000, 60_000):
        ops, nbytes = _reader("k8.roofline_pct").k8_counts(v, 100, 1000, 64,
                                                           20, 6)
        least += roofline.least_s(ops, "fp32", nbytes)
    assert got == pytest.approx(100 * least / 2000e-6)


def test_k8_roofline_counts_the_routed_work():
    """At the CVE cell's shape the routed items bound it by operations:
    2 F routed_items at 67 TFLOP/s."""
    m = _reader("k8.roofline_pct")
    ops, nbytes = m.k8_counts(0.57 * 10_000 * 313_841, 10_000, 313_841, 384,
                              20, 6)
    assert ops == pytest.approx(2 * 384 * 0.57 * 10_000 * 313_841)
    assert roofline.least_s(ops, "fp32", nbytes) == pytest.approx(ops / 67e12)


@pytest.mark.parametrize("records,events", [
    ([{"routed_items": 5}], WINDOW),
    ([{"queries": 1}], WINDOW + _kernel(K8_NARROW, 10, 5, 1, 1)),
])
def test_k8_roofline_none_without_kernels_or_counts(records, events):
    ctx = SimpleNamespace(trace=Trace(events), records=records,
                          shapes=SHAPES)
    assert _reader("k8.roofline_pct").read(ctx) is None
    assert _reader("k8.roofline_pct").read(SimpleNamespace(
        trace=None, records=records, shapes=SHAPES)) is None


def test_energy_route_ms_is_device_time_launched_in_route_over_ranges():
    events = (WINDOW
              + [_ev("arrowspace:search.route", "user_annotation", 100, 50),
                 _ev("arrowspace:search.route", "user_annotation", 900, 50)]
              + _kernel("sort", 200, 30, 1, 110)
              + _kernel("scatter", 240, 10, 2, 120)
              + _kernel("sort", 1000, 20, 3, 910)
              + _kernel(K8_NARROW, 1100, 500, 4, 990))
    ctx = SimpleNamespace(trace=Trace(events), records=[], shapes={})
    got = _reader("energy_route_ms").read(ctx)
    assert got == pytest.approx((30 + 10 + 20) * 1e-3 / 2)
    assert _reader("energy_route_ms").read(SimpleNamespace(
        trace=Trace(WINDOW), records=[], shapes={})) is None


def test_reference_route_keys_and_pools_are_the_ports():
    rng = np.random.default_rng(2)
    items = rng.normal(size=(3000, 32)) * 12
    ep = {"optical_tokens": 12, "candidate_m": 6, "eta": 0.05}
    aspace, _ = pt.ArrowSpaceBuilder.build_energy(items, ep, {
        "eps": 1.31, "k": 25, "topk": 15, "p": 2.0, "sigma": 0.535},
        device="cpu")
    keys, counts = aspace._energy_routing()
    n_cent = int(aspace._centroids.shape[0])
    want = ref_energy.route_keys(aspace._assignments, n_cent)
    assert torch.equal(keys.to(torch.int64), want)
    q = torch.from_numpy(items[:30] + rng.normal(size=(30, 32)))
    lam_q, e_q, ql = aspace._energy_terms(q)
    _, _, pool = aspace._energy_route(ql, lam_q, e_q, 1.0, 0.5)
    em = aspace._energy_maps
    state = dict(nodes=em.nodes, node_lambda=em.node_lambda,
                 node_e=em.node_dirichlet, node_centroid=em.node_centroid,
                 lap_f=aspace._lap_f, w_f=aspace._w_f,
                 tau_star=aspace._tau_star, n_centroids=n_cent)
    assert ref_energy.routed_items(q, state, want, 1.0, 0.5, 6) == int(
        pool.sum())


# -- the cells at tiny sizes on the CPU ------------------------------------
SIZES = {
    "cve313k.serve_energy": dict(n_items=3000, n_features=16),
    "msmarco1m.serve_int8": dict(n_items=3000, n_features=24),
}


def _cell(name):
    c = spec.find_cell(spec.load_benchmark(), name)
    c.config = dict(copy.deepcopy(c.config), **SIZES[name])
    if c.config["corpus"]["law"] == "mixture":
        c.config["corpus"]["centres"] = 64
    if "energy_params" in c.config:
        c.config["energy_params"].update(optical_tokens=8, candidate_m=4)
    c.traffic = dict(c.traffic, batch=192, batches=2, check_rows=24)
    return c


def _run(c, **kw):
    return runner.execute(c, torch=torch, device=torch.device("cpu"),
                          program=pt, seed=2_147_483_659, seconds=0.2,
                          t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_tiny_cell_untraced_is_correct(name):
    c = _cell(name)
    out = _run(c, trace=False, trace_path=None)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    assert set(out["compared"]) == set(c.limits)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_tiny_cell_traced_leaves_device_metrics_out(name, tmp_path):
    c = _cell(name)
    out = _run(c, trace=True, trace_path=str(tmp_path / "t.json"))
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
    assert not any(k.endswith("roofline_pct") or k.endswith("_ms")
                   and k != "search.to_host_ms" or k.startswith("idle_pct")
                   for k in out["metrics"])
    assert "search.to_host_ms" in out["metrics"]


def test_energy_check_catches_a_wrong_answer():
    """A kept answer outside the query's pool, or a score off by 1e-3,
    fails the energy cell's check."""
    c = _cell("cve313k.serve_energy")
    loop = c.loop
    ctx = SimpleNamespace(torch=torch, device=torch.device("cpu"),
                          program=pt, config=c.config, traffic=c.traffic,
                          seed=5)
    st = loop.setup(ctx)
    loop.step(st)
    loop.finish(st)
    ok = loop.numbers(st)
    assert ok["bad_ids"] == 0 and ok["score_gap"] < 1e-6
    b, kid, ksc = st.kept[0]
    ksc = ksc.copy()
    ksc[0, 0] += 1e-3
    st.kept[0] = (b, kid, ksc)
    assert loop.numbers(st)["score_gap"] >= 1e-3 - 1e-9
    kid = kid.copy()
    kid[1, 0] = kid[1, 1]
    st.kept[0] = (b, kid, ksc)
    assert loop.numbers(st)["bad_ids"] >= 1
