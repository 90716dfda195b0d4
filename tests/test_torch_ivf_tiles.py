"""The tiles K6 walks (ops/cuda/ivf_scan.py::slab_tiles), on the CPU.

A padded slab row scores -3e38 with id -1, so it never displaces an
unfilled slot (-3e38, -1) of a query's list: the probe scan walks, in each
probed cluster, only the 64-row tiles up to the cluster's last real row.
``slab_tiles`` counts them from the slab ids; ``build_blocked_ivf`` keeps
the counts on the layout.  Here the count is held against a numpy count
(overflow items may sit in any free slot, so the last real row counts, not
the number of real rows), against layouts that the JAX package's
``build_blocked_ivf`` makes, and the plain scan restricted to those tiles
against the plain scan over whole slabs (bit for bit) and the JAX
package's Pallas scan in interpret mode (within 1e-6, the tolerance of
tests/test_torch_ivf.py: float32 products summed in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyarrowspace_tpu.ops.pallas.ivf_scan as jis
from pyarrowspace_tpu_torch.ops import ivf_scan as tis
from pyarrowspace_tpu_torch.ops.cuda import ivf_scan as k6
from pyarrowspace_tpu_torch.ops.cuda.compare import topk_disagreements

TOL = 1e-6
TAU = 0.62


def _numpy_tiles(ids: np.ndarray, cap: int) -> np.ndarray:
    """ceil((last real row + 1) / 64) per cluster, by a loop."""
    out = []
    for c in range(ids.size // cap):
        real = np.flatnonzero(ids[c * cap:(c + 1) * cap] >= 0)
        out.append(0 if real.size == 0 else -(-(real[-1] + 1) // 64))
    return np.array(out, dtype=np.int32)


def _ids_with(cap: int, rows: dict) -> np.ndarray:
    """A layout of len(rows) clusters: cluster c holds items in the slots
    rows[c], padding (-1) elsewhere."""
    ids = np.full(len(rows) * cap, -1, dtype=np.int32)
    nxt = 0
    for c, slots in rows.items():
        for s in slots:
            ids[c * cap + s] = nxt
            nxt += 1
    return ids


# Cluster layouts: one real row at the front; one in the last slot; none;
# a full slab; a run then an overflow item placed in a tail slot; real rows
# ending exactly on a tile edge and one past it.
_LAYOUTS = {
    "one_row": {0: [0]},
    "last_slot_only": {0: [127]},
    "empty": {0: []},
    "full": {0: list(range(128))},
    "overflow_in_tail": {0: list(range(40)) + [119]},
    "tile_edge": {0: list(range(64)), 1: list(range(65))},
    "mixed": {0: [0, 1, 2], 1: [], 2: [63, 64], 3: list(range(128))},
}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_slab_tiles_matches_numpy(name):
    cap = 128
    ids = _ids_with(cap, _LAYOUTS[name])
    got = k6.slab_tiles(torch.from_numpy(ids), cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _numpy_tiles(ids, cap))


def test_slab_tiles_named_cases():
    cap = 256
    ids = _ids_with(cap, {0: [0], 1: [255], 2: [], 3: [63], 4: [64],
                          5: list(range(10)) + [200]})
    assert k6.slab_tiles(torch.from_numpy(ids), cap).tolist() == \
        [1, 4, 0, 1, 2, 4]


@pytest.mark.parametrize("seed", range(4))
def test_slab_tiles_random_layouts(seed):
    rng = np.random.default_rng(seed)
    cap = 64 * int(rng.integers(1, 9))
    k = int(rng.integers(1, 30))
    ids = rng.permutation(k * cap).astype(np.int32)
    ids[rng.uniform(size=k * cap) < rng.uniform(0.2, 0.99)] = -1
    np.testing.assert_array_equal(
        k6.slab_tiles(torch.from_numpy(ids), cap).numpy(),
        _numpy_tiles(ids, cap))


def _skewed(seed, n, f, k, share):
    """Most items in cluster 0, so the layout spills (the cases of
    tests/test_torch_ivf.py, from tests/test_ivf.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    xu = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    lams = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    assign = np.where(rng.uniform(size=n) < share, 0,
                      rng.integers(1, k, size=n)).astype(np.int32)
    cents = rng.normal(size=(k, f)).astype(np.float32)
    return xu, lams, assign, cents


_CASES = [(11, 1500, 16, 12, 0.85), (81, 1200, 16, 8, 0.7),
          (5, 900, 8, 20, 0.3)]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("dt", [None, "bf16"])
def test_build_blocked_ivf_keeps_the_tiles(case, dt):
    """The counts build_blocked_ivf keeps equal the numpy count over the
    JAX package's layout of the same inputs (the layouts are equal, as
    tests/test_torch_ivf.py shows), spilled items included."""
    xu, lams, assign, cents = _skewed(*case)
    jb = jis.build_blocked_ivf(jnp.asarray(xu), jnp.asarray(lams), cents,
                               assign, slab_dtype=dt and jnp.bfloat16)
    tb = tis.build_blocked_ivf(torch.from_numpy(xu), torch.from_numpy(lams),
                               torch.tensor(cents), assign,
                               slab_dtype=dt and torch.bfloat16)
    jids = np.array(jb.slab_ids)
    want = _numpy_tiles(jids, jb.cap)
    assert tb.slab_tiles.dtype == torch.int32
    np.testing.assert_array_equal(tb.slab_tiles.numpy(), want)
    np.testing.assert_array_equal(
        k6.slab_tiles(torch.from_numpy(jids), jb.cap).numpy(), want)
    # Padding is about half of the slabs: the walk skips whole tiles.
    assert want.sum() * 64 < jids.size


def _scan_inputs(seed, dt, n_clusters=12, cap=128, f=24, qb=8, n_blocks=3,
                 n_probe=4, fill=None):
    """Slabs with real rows only in the first fill[c] slots of cluster c
    and one overflow item in a tail slot of cluster 1, plus an empty
    cluster that the blocks probe."""
    rng = np.random.default_rng(seed)
    rows = n_clusters * cap
    x = rng.standard_normal((rows, f)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    lam = rng.uniform(0.05, 0.3, rows).astype(np.float32)
    qn = rng.standard_normal((n_blocks * qb, f)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    lamq = rng.uniform(0.05, 0.3, n_blocks * qb).astype(np.float32)
    fill = fill if fill is not None else rng.integers(0, cap // 2, n_clusters)
    slot = np.tile(np.arange(cap), n_clusters)
    ids = np.where(slot < np.repeat(fill, cap),
                   rng.permutation(rows).astype(np.int32), -1)
    ids[1 * cap + cap - 3] = rows + 7             # an overflow item
    ids[2 * cap:3 * cap] = -1                     # an empty cluster
    lam[ids < 0] = np.inf
    probe = np.stack([np.concatenate([[2, 1], rng.permutation(
        [c for c in range(n_clusters) if c not in (1, 2)])[:n_probe - 2]])
        for _ in range(n_blocks)]).astype(np.int32)
    if dt == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, lam, ids.astype(np.int32), qn, lamq, probe


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [5, 15, 200])
def test_plain_scan_over_the_tiles_equals_whole_slabs(dt, k):
    cap, qb = 128, 8
    x, lam, ids, qn, lamq, probe = _scan_inputs(k, dt, cap=cap, qb=qb)
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(lam),
            torch.from_numpy(ids), torch.from_numpy(qn),
            torch.from_numpy(lamq), torch.from_numpy(probe), TAU)
    kw = dict(k=k, q_block=qb, cap=cap)
    tiles = k6.slab_tiles(args[2], cap)
    assert tiles[2] == 0 and tiles[1] == 2        # empty; overflow in tail
    s_all, i_all = k6.ivf_scan_plain(*args, **kw)
    s_t, i_t = k6.ivf_scan_plain(*args, **kw, tiles=tiles)
    s_w, i_w = k6.ivf_scan(*args, **kw, tiles=tiles)   # CPU: plain
    assert torch.equal(i_t, i_all) and torch.equal(i_w, i_all)
    assert torch.equal(s_t.view(torch.int32), s_all.view(torch.int32))
    assert torch.equal(s_w.view(torch.int32), s_all.view(torch.int32))
    # A count one tile short drops the overflow item: the walk must reach
    # the last real row, not the count of real rows.
    short = tiles.clone()
    short[1] -= 1
    _, i_short = k6.ivf_scan_plain(*args, **kw, tiles=short)
    assert not (i_short == int(ids[cap + cap - 3])).any()
    n_blocks, n_probe = probe.shape
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    js, ji = jis._ivf_scan(
        jnp.asarray(x, jdt), jnp.asarray(lam)[None, :],
        jnp.asarray(ids)[None, :], jnp.asarray(qn),
        jnp.broadcast_to(jnp.asarray(lamq)[:, None], (len(lamq), 128)),
        jnp.asarray(probe), TAU, k=k, q_block=qb, cap=cap, n_probe=n_probe,
        interpret=True)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(s_t.numpy(), js, rtol=0, atol=TOL)
    assert topk_disagreements(s_t.numpy(), i_t.numpy(), js, ji, TOL) == []


def test_plain_scan_one_real_row_in_the_last_tile():
    """A cluster whose only item sits in its last slot: its last tile is
    walked, the rows before it are not needed."""
    cap, qb = 256, 8
    fill = np.zeros(12, dtype=np.int64)
    x, lam, ids, qn, lamq, probe = _scan_inputs(3, "f32", cap=cap, qb=qb,
                                                fill=fill)
    ids[5 * cap + cap - 1] = 999_999
    lam[5 * cap + cap - 1] = 0.2
    probe[:] = [2, 1, 5, 0]                       # distinct clusters
    args = (torch.from_numpy(x), torch.from_numpy(lam), torch.from_numpy(ids),
            torch.from_numpy(qn), torch.from_numpy(lamq),
            torch.from_numpy(probe), TAU)
    tiles = k6.slab_tiles(args[2], cap)
    assert tiles[5] == cap // 64
    s_all, i_all = k6.ivf_scan_plain(*args, k=8, q_block=qb, cap=cap)
    s_t, i_t = k6.ivf_scan_plain(*args, k=8, q_block=qb, cap=cap,
                                 tiles=tiles)
    assert torch.equal(i_t, i_all)
    assert torch.equal(s_t.view(torch.int32), s_all.view(torch.int32))
    # Two items are probed (this one and cluster 1's overflow item): every
    # list holds both, then unfilled slots.
    assert (i_all == 999_999).any(dim=1).all()
    assert (i_all[:, 2:] == -1).all()
