"""A run with the timed path broken underneath comes out not correct: the
harness past its check for a CUDA device, on the tiny cells on the CPU,
once for each fault a cell can have (an answer altered where it is
produced, and half of the work left out).  The cells run on one chip:
there is no exchange between chips to leave out, and no state that a step
carries."""

import numpy as np
import pytest

import tiny
import pyarrowspace_tpu_torch as pt
from harness import checks
from pyarrowspace_tpu_torch.core.space import ArrowSpace
from pyarrowspace_tpu_torch.graph import build as build_mod

BUILDS = ["cve313k.build", "msmarco1m.build"]
SERVES = ["cve313k.serve_exact", "msmarco1m.serve_auto"]


@pytest.mark.parametrize("name", BUILDS + SERVES)
def test_sound_run_is_correct(name):
    assert tiny.run(tiny.cell(name))["correct"] is True


@pytest.mark.parametrize("name", BUILDS)
def test_sound_run_after_a_smaller_warm_up_is_correct(name):
    out = tiny.run(tiny.cell(name, warmup_rows=1000))
    assert out["correct"] is True and out["attempted"] >= 1


@pytest.mark.parametrize("name", BUILDS)
def test_build_with_a_lambda_altered(name, monkeypatch):
    real = pt.ArrowSpaceBuilder.build

    def build(gp, x, device=None):
        aspace, gl = real(gp, x, device=device)
        aspace._lambdas[len(aspace._lambdas) // 3] += 1e-3
        return aspace, gl
    monkeypatch.setattr(pt.ArrowSpaceBuilder, "build", staticmethod(build))
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False
    assert out["compared"]["lambda_gap"]["value"] > 5e-4


@pytest.mark.parametrize("name", BUILDS)
def test_build_with_a_neighbour_altered(name, monkeypatch):
    real = build_mod.knn_graph_candidates

    def knn(xu, k, eps, variant=None):
        d, i = real(xu, k, eps, variant=variant)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % xu.shape[0]      # every row's nearest
        return d, i
    monkeypatch.setattr(build_mod, "knn_graph_candidates", knn)
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False
    assert out["compared"]["knn_id_gap"]["value"] > 1e-3


@pytest.mark.parametrize("n,pairs,blocks", [
    (4500, 4500 * 4500, 36),            # covered: every row
    (4500, 4500 * 128 * 5.5, 5),        # the last block and four drawn
    (1_000_000, 1e11, 781), (313_841, 1e11, 2452)])
def test_checked_rows_are_whole_blocks(n, pairs, blocks):
    rows = checks.block_rows(n, pairs, seed=2_147_483_659)
    assert np.array_equal(rows, np.unique(rows))
    got = np.unique(rows // 128)
    assert got.shape[0] == blocks and got[-1] == -(-n // 128) - 1
    for b in got:                                  # each block whole
        assert np.count_nonzero(rows // 128 == b) == min(128, n - 128 * b)
    assert np.array_equal(rows, checks.block_rows(n, pairs, 2_147_483_659))
    assert float(rows.shape[0]) * n <= max(pairs, n * 128.0)


@pytest.mark.parametrize("name", BUILDS)
def test_build_with_the_last_block_altered(name, monkeypatch):
    """A fault confined to the k-NN kernel's last, partial row block is
    seen where the check draws only two blocks."""
    real = build_mod.knn_graph_candidates

    def knn(xu, k, eps, variant=None):
        d, i = real(xu, k, eps, variant=variant)
        i = i.clone()
        last = (xu.shape[0] - 1) // 128 * 128
        i[last:, 0] = (i[last:, 0] + 1) % xu.shape[0]
        return d, i
    monkeypatch.setattr(build_mod, "knn_graph_candidates", knn)
    c = tiny.cell(name, check_pairs=4500 * 128 * 2)
    out = tiny.run(c)
    assert out["correct"] is False
    assert out["compared"]["knn_id_gap"]["value"] > 1e-3


@pytest.mark.parametrize("name", BUILDS)
def test_build_over_half_the_columns(name, monkeypatch):
    """The k-NN scan leaves half of the corpus out."""
    real = build_mod.knn_graph_candidates

    def knn(xu, k, eps, variant=None):
        half = xu.clone()
        half[xu.shape[0] // 2:] = 0.0            # zero rows: distance 1
        return real(half, k, eps, variant=variant)
    monkeypatch.setattr(build_mod, "knn_graph_candidates", knn)
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False


@pytest.mark.parametrize("name", SERVES)
def test_serve_with_an_answer_altered(name, monkeypatch):
    real = ArrowSpace.search_batch

    def search(self, q, gl, tau, **kw):
        ids, scores = real(self, q, gl, tau, **kw)
        ids = np.array(ids)
        ids[:, [0, -1]] = ids[:, [-1, 0]]        # best and last swapped
        return ids, scores
    monkeypatch.setattr(ArrowSpace, "search_batch", search)
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False


@pytest.mark.parametrize("name", SERVES)
def test_serve_with_half_the_batch_left_out(name, monkeypatch):
    """Only the first half of each batch is searched; the second half gets
    the first half's answers."""
    real = ArrowSpace.search_batch

    def search(self, q, gl, tau, **kw):
        h = q.shape[0] // 2
        ids, scores = real(self, q[:h], gl, tau, **kw)
        return (np.concatenate([ids, ids[:q.shape[0] - h]]),
                np.concatenate([scores, scores[:q.shape[0] - h]]))
    monkeypatch.setattr(ArrowSpace, "search_batch", search)
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False


@pytest.mark.parametrize("name", SERVES)
def test_serve_with_rows_missing(name, monkeypatch):
    real = ArrowSpace.search_batch

    def search(self, q, gl, tau, **kw):
        ids, scores = real(self, q, gl, tau, **kw)
        return ids[: q.shape[0] // 2], scores[: q.shape[0] // 2]
    monkeypatch.setattr(ArrowSpace, "search_batch", search)
    out = tiny.run(tiny.cell(name))
    assert out["correct"] is False and out["failed"] > 0
