"""The port's sharded build and serving (pyarrowspace_tpu_torch/parallel) on
gloo rank processes on the CPU, at world sizes 2 and 4, against the JAX
package's ``build_sharded`` on ``make_mesh(n)`` (conftest's 8 virtual
devices) and against the port's one-device build, in float64.

Tolerances (tests/test_sharded.py's): lambdas rtol 1e-8, tau* rel 1e-10,
the Laplacian atol 1e-10, exact scores rtol 1e-8, subtile rtol 1e-5,
hybrid / energy rtol 1e-12, dp x tp lambdas rtol 1e-10; ivf_block scores
rtol 1e-6 (float32 slabs on both sides: the tolerance of K6's plain
version against the Pallas kernel, tests/test_torch_ivf_tiles.py), its
ids and certificates equal.
Against the port's one-device build the k-NN lists and the graph are held
bit for bit.  The ranks (tests/_torch_ranks.py) are spawned once per
module and world size and import no jax."""

import dataclasses

import numpy as np
import pytest
import torch

from pyarrowspace_tpu import ArrowSpaceBuilder as JaxBuilder
from pyarrowspace_tpu.core.params import parse_graph_params as jax_gp
from pyarrowspace_tpu.parallel import (ShardedArrowSpace as JaxSharded,
                                       build_sharded as jax_build_sharded,
                                       make_mesh as jax_mesh)
from pyarrowspace_tpu_torch import ArrowSpaceBuilder
from pyarrowspace_tpu_torch.ops.symmetrize import symmetrize_to_ell

from _torch_ranks import RankPool

GP = {"eps": 0.8, "k": 6, "topk": 9, "p": 2.0, "sigma": 0.3}
IVF_GP = {"eps": 0.9, "k": 6, "topk": 10, "p": 2.0, "sigma": 0.3}
TAU = 0.62
WORLDS = (2, 4)


def _items():
    return np.random.default_rng(0).normal(size=(333, 48)) + 0.3


def _ivf_items():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(40, 32))
    items = np.repeat(base, 50, axis=0) + 0.15 * rng.normal(size=(2000, 32))
    queries = np.concatenate([items[rng.choice(2000, 12, replace=False)]
                              * 1.02, rng.normal(size=(4, 32))])
    batches = [items[rng.choice(2000, 12, replace=False)] * 1.02
               for _ in range(3)]
    return items, queries, batches


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread in this process too, as in the ranks: the tensors
    are small, and the suite runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gloo"))
    made = {w: RankPool(w, tmp) for w in WORLDS}
    yield made
    for p in made.values():
        p.close()


@pytest.fixture(scope="module")
def pool8(tmp_path_factory):
    """Eight ranks: a bucket overflow needs d > 4 (a bucket holds 4 L k / d
    entries, and a rank sends L k)."""
    made = RankPool(8, str(tmp_path_factory.mktemp("gloo8")))
    yield made
    made.close()


@pytest.fixture(scope="module")
def built(pools):
    items = _items()
    queries = items[:5] * 1.03
    return {w: pools[w].run("build_and_serve", items=items, gp=GP,
                            queries=queries, tau=TAU) for w in WORLDS}


@pytest.fixture(scope="module")
def local():
    """The port's one-device build and the JAX package's."""
    items = _items()
    aspace, gl = ArrowSpaceBuilder.build(GP, items, device="cpu")
    jaspace, jgl = JaxBuilder.build(GP, items)
    return aspace, gl, jaspace, jgl


@pytest.fixture(scope="module")
def jax_sharded():
    items = _items()
    return {w: jax_build_sharded(items, jax_gp(GP), jax_mesh(w))
            for w in WORLDS}


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    parts = first if isinstance(first, tuple) else (first,)
    for o in outs[1:]:
        other = o[key] if isinstance(first, tuple) else (o[key],)
        for a, b in zip(parts, other):
            np.testing.assert_array_equal(a, b)
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_lambdas_tau_and_laplacian(built, local, jax_sharded, world):
    outs = built[world]
    aspace, gl, _, _ = local
    sspace, sgl = jax_sharded[world]
    lam = _same_on_every_rank(outs, "lambdas")
    tau = _same_on_every_rank(outs, "tau_star")
    lap = _same_on_every_rank(outs, "lap")
    np.testing.assert_allclose(lam, sspace.lambdas(), rtol=1e-8)
    np.testing.assert_allclose(lam, aspace.lambdas(), rtol=1e-8)
    assert tau == pytest.approx(sspace.tau_star, rel=1e-10)
    assert tau == pytest.approx(aspace.tau_star, rel=1e-10)
    np.testing.assert_allclose(lap, sgl.to_dense(), atol=1e-10)
    np.testing.assert_array_equal(lap, gl.to_dense())      # bit for bit
    assert np.array_equal(lap, lap.T)
    assert outs[0]["n_dropped"] == gl._n_dropped == 0


@pytest.mark.parametrize("world", WORLDS)
def test_ring_knn_lists_bitwise_one_device(built, local, world):
    """The ring's lists (a seeded K1 step per visiting block) are the
    one-device scan's bit for bit, padding rows empty."""
    outs = built[world]
    aspace = local[0]
    n = aspace.nitems
    d = np.concatenate([o["knn_d"] for o in outs])
    i = np.concatenate([o["knn_i"] for o in outs])
    assert d.shape[0] == outs[0]["n_loc"] * world >= n
    np.testing.assert_array_equal(d[:n].view(np.int64),
                                  aspace._knn_dist.numpy().view(np.int64))
    np.testing.assert_array_equal(i[:n], aspace._knn_idx.numpy())
    assert np.all(i[n:] == -1) and np.all(d[n:] == 2.0)


@pytest.mark.parametrize("world", WORLDS)
def test_search_modes(built, local, jax_sharded, world):
    outs = built[world]
    aspace, gl, _, _ = local
    sspace, _ = jax_sharded[world]
    queries = _items()[:5] * 1.03
    ei, ev = _same_on_every_rank(outs, "exact")
    ji, jv = sspace.search_batch(queries, TAU)
    ai, av = aspace.search_batch(queries, gl, TAU)
    np.testing.assert_array_equal(ei, ji)
    np.testing.assert_array_equal(ei, ai)
    np.testing.assert_allclose(ev, jv, rtol=1e-8)
    np.testing.assert_allclose(ev, av, rtol=1e-8)

    si, sv = _same_on_every_rank(outs, "subtile")
    jsi, jsv = sspace.search_batch(queries, TAU, mode="subtile")
    ui, _ = aspace.search_batch(queries, gl, TAU, mode="subtile")
    np.testing.assert_array_equal(si, jsi)
    np.testing.assert_array_equal(si, ui)
    np.testing.assert_allclose(sv, jsv, rtol=1e-5)

    oi, ov = _same_on_every_rank(outs, "auto")     # exact at this size
    np.testing.assert_array_equal(oi, ei)
    np.testing.assert_allclose(ov, ev, rtol=1e-12)
    assert "unknown search mode" in outs[0]["bad_mode"]


@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_and_energy(built, local, jax_sharded, world):
    outs = built[world]
    aspace, gl, _, _ = local
    sspace, _ = jax_sharded[world]
    queries = _items()[:5] * 1.03
    hi, hv = _same_on_every_rank(outs, "hybrid")
    jhi, jhv = sspace.search_hybrid_batch(queries, 0.8)
    ahi, ahv = aspace.search_hybrid_batch(queries, gl, 0.8)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(hi, ahi)
    np.testing.assert_allclose(hv, jhv, rtol=1e-12)
    np.testing.assert_allclose(hv, ahv, rtol=1e-12)
    ei, ev = _same_on_every_rank(outs, "energy")
    jei, jev = sspace.search_energy_batch(queries, 8)
    aei, aev = aspace.search_energy_batch(queries, gl, 8)
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_array_equal(ei, aei)
    np.testing.assert_allclose(ev, jev, rtol=1e-12)
    np.testing.assert_allclose(ev, aev, rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_padding_rows_never_served(built, local, world):
    """An anti-aligned query at tau 0.05: an unmasked zero padding row
    would outrank every real item."""
    outs = built[world]
    aspace, gl, _, _ = local
    n = aspace.nitems
    anti = -(_items()[:5] * 1.03)[:4] * 1.5     # as build_and_serve makes
    ref, _ = aspace.search_batch(anti, gl, 0.05)
    for mode in ("exact", "subtile"):
        si, _ = outs[0]["anti"][mode]
        assert si.max() < n, mode
        np.testing.assert_array_equal(si, ref)
    hi, _ = outs[0]["anti_hybrid"]
    assert hi.max() < n
    np.testing.assert_array_equal(hi, aspace.search_hybrid_batch(
        anti, gl, 0.05)[0])


@pytest.fixture(scope="module")
def ivf_runs(pools):
    items, queries, batches = _ivf_items()
    return {w: pools[w].run("ivf_serving", items=items, gp=IVF_GP,
                            n_clusters=40, queries=queries, tau=TAU,
                            stream_batches=batches, timeout=240)
            for w in WORLDS}


@pytest.fixture(scope="module")
def jax_ivf():
    items, queries, _ = _ivf_items()
    aspace, gl = JaxBuilder.build(IVF_GP, items)
    aspace.enable_ivf(n_clusters=40)
    exact, _ = aspace.search_batch(queries, gl, TAU)
    out = {}
    for w in WORLDS:
        ss = JaxSharded.from_local(aspace, gl, jax_mesh(w))
        out[w] = (ss.search_batch(queries, TAU, mode="ivf_block", n_probe=16),
                  ss.search_batch(queries, TAU, mode="ivf_block", n_probe=2,
                                  certify=True))
    return exact, out


@pytest.mark.parametrize("world", WORLDS)
def test_ivf_block_and_certified(ivf_runs, jax_ivf, world):
    """ivf_block equals the JAX package's sharded ivf_block (the same slab
    partition, K6 per rank, the merge); the certificate equals its psum-ed
    one; full probes and certified serving give the exact top-k sets."""
    outs = ivf_runs[world]
    exact, jax_out = jax_ivf
    (ji, jv), (jci, jcv, jcert) = jax_out[world]
    i16, v16 = _same_on_every_rank(outs, "ivf16")
    np.testing.assert_array_equal(i16, ji)
    np.testing.assert_allclose(v16, jv, rtol=1e-6)   # float32 slabs
    ci, cv, cert = _same_on_every_rank(outs, "cert2")
    np.testing.assert_array_equal(cert, jcert)
    np.testing.assert_array_equal(ci, jci)
    assert not cert.all()
    ei, _ = outs[0]["exact"]
    np.testing.assert_array_equal(ei, exact)
    fi, _ = outs[0]["ivf_full"]
    _, _, cert_full = outs[0]["cert_full"]
    assert cert_full.all()
    for r in range(len(exact)):
        assert set(fi[r]) == set(exact[r]), r
        if cert[r]:
            assert set(ci[r]) == set(exact[r]), r
    qi, _ = _same_on_every_rank(outs, "certified")
    for r in range(len(exact)):
        assert set(qi[r]) == set(exact[r]), r


@pytest.mark.parametrize("world", WORLDS)
def test_probe_ceiling_bounded_at_n_widen_0(ivf_runs, world):
    """ROADMAP fault 1, a divergence kept on purpose: the reference's
    sharded ladder widens up to the shard ceiling at n_widen=0
    (sharded.py:871-880); the port bounds it by n_probe << n_widen, as the
    one-device ladder does, and the results stay exact."""
    out = ivf_runs[world][0]
    assert out["probes_w0"] == [1]               # no widening round
    assert max(out["probes_w2"]) <= min(out["ceiling"], 1 << 2)
    exact, _ = out["exact"]
    for key in ("certified_w0", "certified_w2"):
        got, _ = out[key]
        for r in range(len(exact)):
            assert set(got[r]) == set(exact[r]), (key, r)


@pytest.mark.parametrize("world", WORLDS)
def test_serving_stream(ivf_runs, world):
    out = ivf_runs[world][0]
    for (i, v), (si, sv) in zip(out["stream"], out["stream_sync"]):
        np.testing.assert_array_equal(i, si)
        np.testing.assert_array_equal(v, sv)
    assert out["stream_escalated"] == []
    col = out["collapse"]
    assert col["degraded_at"] is not None
    for ids, ex in zip(col["ids"], out["exact_batches"]):
        for r in range(len(ex)):
            assert set(ids[r]) == set(ex[r])


def test_slab_plan_and_roundtrip(pools, tmp_path):
    """save -> load -> from_local -> to_local at world 4: the slab layout
    plan rides along, the sharded cap is the one-device cap, search equals
    the saved index's, lambdas come back."""
    from pyarrowspace_tpu_torch.io import save_index
    rng = np.random.default_rng(56)
    items = rng.normal(size=(256, 24)) + 0.3
    out = pools[4].run("slab_plan", items=items, gp=GP,
                       path=str(tmp_path / "plan.npz"))[0]
    assert out["plan"] == out["local_plan"] == out["back_plan"]
    assert out["factor"] == out["back_factor"] == 1.5
    assert out["sharded_cap"] == out["local_cap"]

    items = np.random.default_rng(55).normal(size=(200, 24)) + 0.3
    aspace, gl = ArrowSpaceBuilder.build(GP, items, device="cpu")
    path = str(tmp_path / "idx.npz")
    save_index(path, aspace, gl)
    queries = items[:4] * 1.02
    outs = pools[2].run("roundtrip", path=path, queries=queries, tau=TAU)
    si, sv = _same_on_every_rank(outs, "search")
    ai, av = aspace.search_batch(queries, gl, TAU)
    np.testing.assert_array_equal(si, ai)
    np.testing.assert_allclose(sv, av, rtol=1e-8)
    np.testing.assert_allclose(outs[0]["back_lambdas"], aspace.lambdas(),
                               rtol=1e-12)
    assert outs[0]["back_search"] == aspace.search(queries[0], gl, TAU)


def test_rayleigh_normalized_carried(pools):
    items = np.random.default_rng(13).normal(size=(160, 24)) + 0.3
    queries = items[:4] * 1.02
    out = pools[4].run("normalized_build", items=items, gp=GP,
                       queries=queries, tau=TAU)[0]
    assert out["carried"] and out["back"]
    np.testing.assert_array_equal(out["search"][0], out["local"][0])
    np.testing.assert_allclose(out["search"][1], out["local"][1], rtol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_ingest_holds_only_its_rows(pools, world):
    arr = np.random.default_rng(0).normal(size=(1000, 32))
    outs = pools[world].run("ingest", arr=arr)
    n_pad = outs[0]["n_pad"]
    assert n_pad % (world * 128) == 0
    n_loc = n_pad // world
    ref = np.zeros((n_pad, 32))
    ref[:1000] = arr
    for r, o in enumerate(outs):
        assert o["rows"] and max(o["rows"]) <= n_loc, o["rows"]
        assert o["x"].shape == (n_loc, 32)
        np.testing.assert_array_equal(o["x"], ref[r * n_loc:(r + 1) * n_loc])


def _sym_inputs(seed, n, k, eps):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 24)) + 0.3
    xu = x / np.linalg.norm(x, axis=1, keepdims=True)
    d = 1.0 - np.maximum(xu @ xu.T, 0.0)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dd = np.take_along_axis(d, idx, 1)
    keep = dd <= eps
    i = np.where(keep, idx, -1).astype(np.int32)
    w = 1.0 / (1.0 + (np.where(keep, dd, 2.0) / 0.3) ** 2)
    return i, np.where(i >= 0, w, 0.0)


def _padded(i, w, world):
    n, k = i.shape
    block = world * 128
    n_pad = -(-n // block) * block
    ip = np.full((n_pad, k), -1, dtype=np.int32)
    ip[:n] = i
    wp = np.zeros((n_pad, k))
    wp[:n] = w
    return ip, wp


@pytest.mark.parametrize("seed,n,k,eps,world", [
    (0, 333, 6, 0.9, 2), (3, 777, 9, 1.2, 4), (5, 400, 12, 1.9, 4),
    (6, 513, 7, 0.05, 2)])
def test_sharded_symmetrize_bitwise(pools, seed, n, k, eps, world):
    """The all_to_all symmetrize equals the one-device op bit for bit
    across densities (eps 1.9: every pair within eps; 0.05: nearly
    edgeless)."""
    i, w = _sym_inputs(seed, n, k, eps)
    ref = symmetrize_to_ell(torch.from_numpy(i), torch.from_numpy(w), 2 * k)
    ip, wp = _padded(i, w, world)
    outs = pools[world].run("symmetrize", idx=ip, w=wp, m=2 * k, n_real=n)
    for o in outs:
        np.testing.assert_array_equal(o["nbr_idx"], ref[0].numpy())
        np.testing.assert_array_equal(o["nbr_w"], ref[1].numpy())
        np.testing.assert_array_equal(o["degrees"], ref[2].numpy())
        assert o["n_dropped"] == ref[3]
        assert o["fallbacks"] == 0


def test_sharded_symmetrize_overflow_routes_to_one_device_op(pool8):
    """Every row's neighbours in block 0 overflow the off-diagonal
    buckets: the stage runs the replicated one-device op (counted) and
    keeps its bits."""
    n, k = 1024, 6
    rng = np.random.default_rng(1)
    i = np.tile(np.arange(k, dtype=np.int32), (n, 1))
    for r in range(k):
        i[r] = np.arange(1, k + 1, dtype=np.int32)
    w = rng.uniform(0.2, 1.0, size=(n, k))
    ref = symmetrize_to_ell(torch.from_numpy(i), torch.from_numpy(w), 2 * k)
    outs = pool8.run("symmetrize", idx=i, w=w, m=2 * k, n_real=n)
    for o in outs:
        assert o["fallbacks"] == 1
        np.testing.assert_array_equal(o["nbr_idx"], ref[0].numpy())
        np.testing.assert_array_equal(o["nbr_w"], ref[1].numpy())
        assert o["n_dropped"] == ref[3]


def test_synthesis_modes(pools):
    """tau* dispatches on gp.synthesis (MEAN / MAX / FIXED) as the
    one-device build does."""
    from pyarrowspace_tpu_torch.core.params import TauMode, \
        parse_graph_params
    from pyarrowspace_tpu_torch.graph.build import build_standard
    items = np.random.default_rng(11).normal(size=(96, 16)) + 0.3
    gp = {"eps": 0.9, "k": 4, "topk": 5, "p": 2.0, "sigma": 0.3}
    modes = [("MEAN", None), ("MAX", None), ("FIXED", 0.37)]
    out = pools[4].run("synthesis_modes", items=items, gp=gp, modes=modes)[0]
    for name, tf in modes:
        g = dataclasses.replace(parse_graph_params(gp),
                                synthesis=TauMode[name], tau_fixed=tf)
        aspace, _ = build_standard(items, g, device="cpu")
        lam, tau = out[name]
        np.testing.assert_allclose(lam, aspace.lambdas(), rtol=1e-8,
                                   err_msg=name)
        assert tau == pytest.approx(aspace.tau_star, rel=1e-10)


def test_reduction_build(pools):
    """At 4,608 items the reduction stage runs on the sharded rows: the
    centroids, lambdas and tau* stay within the rank-order rounding of the
    one-device build's (JAX's own sharded bound: rtol 1e-8) and the
    exact top-k is the same."""
    rng = np.random.default_rng(9)
    items = rng.normal(size=(4608, 24)) + 0.3
    gp = {"eps": 0.8, "k": 4, "topk": 5, "p": 2.0, "sigma": 0.3}
    queries = items[:3] * 1.03
    out = pools[2].run("reduction_build", items=items, gp=gp,
                       queries=queries, tau=TAU, timeout=240)
    aspace, gl = ArrowSpaceBuilder.build(gp, items, device="cpu")
    o = out[0]
    np.testing.assert_array_equal(o["centroids"], out[1]["centroids"])
    np.testing.assert_allclose(o["centroids"], aspace._centroids.numpy(),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(o["assignments"],
                                  aspace._assignments.numpy())
    np.testing.assert_allclose(o["lambdas"], aspace.lambdas(), rtol=1e-8)
    assert o["tau_star"] == pytest.approx(aspace.tau_star, rel=1e-10)
    np.testing.assert_array_equal(o["exact"][0],
                                  aspace.search_batch(queries, gl, TAU)[0])


def test_dp_tp_lambdas_match_single_device(pools):
    """A 2 x 2 (data, model) mesh: the column-parallel contractions and
    the gathered median reproduce the one-device lambda stage."""
    import jax.numpy as jnp
    from pyarrowspace_tpu.core.params import TauMode
    from pyarrowspace_tpu.graph.feature import build_feature_laplacian
    from pyarrowspace_tpu.ops.rayleigh import dispersion_batch, rayleigh_batch
    from pyarrowspace_tpu.spectral.taumode import (TAU_MIX, derive_tau_star,
                                                   synthesize)
    rng = np.random.default_rng(44)
    n, f = 128, 64
    x = rng.normal(size=(n, f)) + 0.3
    w_f, lap_f, _ = build_feature_laplacian(jnp.asarray(x), k_f=4)
    e = rayleigh_batch(jnp.asarray(x), lap_f, normalized=False)
    ts = derive_tau_star(e, TauMode.MEDIAN)
    lam_ref = np.asarray(synthesize(e, dispersion_batch(jnp.asarray(x), w_f,
                                                        e), ts, TAU_MIX))
    outs = pools[4].run("dp_tp", x=x, lap_f=np.asarray(lap_f),
                        w_f=np.asarray(w_f), n_real=n, shape=(2, 2))
    for o in outs:
        r = o["data_rank"]
        np.testing.assert_allclose(o["lam"], lam_ref[r * 64:(r + 1) * 64],
                                   rtol=1e-10)
        np.testing.assert_allclose(o["e"], np.asarray(e)[r * 64:(r + 1) * 64],
                                   rtol=1e-10)
        assert o["tau_star"] == pytest.approx(float(ts), rel=1e-12)


def test_mesh_needs_a_card_or_cpu():
    from pyarrowspace_tpu_torch.parallel import make_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="gloo"):
        make_mesh(device="cpu", backend="nccl")


@pytest.mark.parametrize("world,k", [(2, 150), (4, 150), (4, 3)])
def test_ring_lists_any_k(pools, world, k):
    """The ring's lists past 128 entries (the wide route's k on the card)
    and on tied data (duplicated rows: equal distances across blocks) are
    the one-device scan's bit for bit."""
    from pyarrowspace_tpu_torch.ops.cuda.knn import knn_scan
    from pyarrowspace_tpu_torch.ops.distance import unit_normalize
    rng = np.random.default_rng(21)
    items = rng.normal(size=(300, 16)) + 0.2
    items[150:200] = items[:50]                 # exact ties across shards
    outs = pools[world].run("ring_lists", items=items, k=k, eps=1.5)
    d = np.concatenate([o["d"] for o in outs])[:300]
    i = np.concatenate([o["i"] for o in outs])[:300]
    rd, ri = knn_scan(unit_normalize(torch.from_numpy(items)).contiguous(),
                      k, 1.5)
    np.testing.assert_array_equal(d.view(np.int64),
                                  rd.numpy().view(np.int64))
    np.testing.assert_array_equal(i, ri.numpy())
