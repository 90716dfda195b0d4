"""Near-ties between the port's k-NN lists and the JAX package's, pinned.

On tests/test_graph.py's clustered corpus (12 centres, 500 x 32 rows of
centre + 0.3 N(0, 1), float32) at k >= 129, the two packages' lists may
order entries whose distances lie within the rounding of their float32
products differently, or keep a different one at the kth slot.  This test
bounds that, against the JAX package's XLA scan and its Pallas kernel (in
interpret mode).  Both packages get the same float32 unit rows, so a pair's
two distances differ only by the rounding of two float32 dot products of F
terms summed in different orders.  With u = 2^-24 and gamma_F = F u / (1 -
F u), each computed dot s of unit rows x, y lies within gamma_F sum_i
|x_i y_i| <= gamma_F |x| |y| of the exact one, and d = 1 - max(0, s) adds
at most u more; so the two distances of one pair differ by at most DELTA =
2 (gamma_F |x| |y| + u).  Then, for every row:

  * position by position, the two sorted lists' distances differ by at most
    DELTA (the s-th smallest of two sets whose members differ by <= DELTA);
  * an id only one list holds lies within DELTA of the other list's kth
    distance (it missed that list's cut by a near-tie);
  * two ids both lists hold in opposite orders lie within 2 DELTA of each
    other (a swap).

Exact ties fall under the bound too: the Pallas kernel keeps a different
id among equal distances at the kth slot (ROADMAP.md §3, kept on purpose).
The tie-free comparisons stay in tests/test_torch_knn_wide.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyarrowspace_tpu.ops.distance import knn_graph_candidates as jax_knn
from pyarrowspace_tpu.ops.pallas.knn import knn_graph_candidates_pallas
from pyarrowspace_tpu_torch.ops.distance import knn_graph_candidates

U = 2.0 ** -24
EPS = 1.31   # above the largest distance (1.0): nothing masked


@pytest.fixture(scope="module")
def clustered():
    """tests/test_graph.py:203's corpus, unit rows in float32."""
    rng = np.random.default_rng(61)
    cents = rng.normal(size=(12, 32))
    x = (cents[rng.integers(0, 12, size=500)]
         + 0.3 * rng.normal(size=(500, 32))).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _delta(xu: np.ndarray) -> float:
    f = xu.shape[1]
    gamma = f * U / (1.0 - f * U)
    norm = float(np.linalg.norm(xu.astype(np.float64), axis=1).max())
    return 2.0 * (gamma * norm * norm + U)


@pytest.mark.parametrize("k", [129, 200])
@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_lists_differ_only_by_near_tie_swaps(clustered, k, path):
    delta = _delta(clustered)
    td, ti = (t.numpy() for t in knn_graph_candidates(
        torch.from_numpy(clustered), k, EPS))
    xu = jnp.asarray(clustered)
    jd, ji = (np.asarray(t) for t in (
        jax_knn(xu, k, EPS) if path == "xla"
        else knn_graph_candidates_pallas(xu, k, EPS, interpret=True)))
    assert td.dtype == jd.dtype == np.float32
    assert (ti >= 0).all() and (ji >= 0).all()
    for r in range(clustered.shape[0]):
        np.testing.assert_array_less(
            np.abs(td[r].astype(np.float64) - jd[r]), delta + 1e-12,
            err_msg=f"row {r}: positionwise distances")
        if np.array_equal(ti[r], ji[r]):
            continue
        dt = dict(zip(ti[r].tolist(), td[r].astype(np.float64).tolist()))
        dj = dict(zip(ji[r].tolist(), jd[r].astype(np.float64).tolist()))
        for a in dt.keys() - dj.keys():       # only the port keeps it
            assert jd[r, -1] - delta <= dt[a] <= td[r, -1], (r, a)
        for b in dj.keys() - dt.keys():       # only the reference keeps it
            assert td[r, -1] - delta <= dj[b] <= jd[r, -1], (r, b)
        common = [c for c in ti[r].tolist() if c in dj]
        rank_j = {c: n for n, c in enumerate(c for c in ji[r].tolist()
                                             if c in dt)}
        for n, a in enumerate(common):
            for b in common[n + 1:]:
                if rank_j[a] > rank_j[b]:     # a swap
                    assert abs(dt[a] - dt[b]) <= 2 * delta, (r, a, b)
                    assert abs(dj[a] - dj[b]) <= 2 * delta, (r, a, b)
