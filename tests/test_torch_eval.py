"""The port's numpy copies of eval/, data/ and models/encoders.py: the
cases of tests/test_eval_metrics.py, the non-slow CVE cases of
tests/test_loaders.py on tests/fixtures/cve/ (the end-to-end one building
with the port on the CPU), test_models.py's hash_embed and offline
embed_texts cases and test_compat_and_sweep.py's sweep isolation, all
pointed at the port.  Nothing here downloads."""

import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

import pyarrowspace_tpu_torch as pt
from pyarrowspace_tpu_torch.data import (extract_cve_text, iter_cve_json,
                                         load_cve_corpus)
from pyarrowspace_tpu_torch.eval.ir import (average_precision, dcg_at_k,
                                            evaluate_run, mrr, ndcg_at_k,
                                            paired_t_test, precision_at_k,
                                            rank_agreement, recall_at_k,
                                            tail_analysis)
from pyarrowspace_tpu_torch.eval.sweep import grid, run_sweep
from pyarrowspace_tpu_torch.eval.topology import (build_topology_graph,
                                                  compute_modularity_delta,
                                                  compute_topology_factor,
                                                  g_rbp, it_err, mrr_topo,
                                                  rbo_stability, sqi, td_ndcg)
from pyarrowspace_tpu_torch.models import embed_texts, hash_embed

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "cve"


def test_recall_precision_mrr():
    retrieved = [5, 3, 9, 1, 7]
    relevant = {3, 1, 100}
    assert recall_at_k(retrieved, relevant, 5) == pytest.approx(2 / 3)
    assert recall_at_k(retrieved, relevant, 2) == pytest.approx(1 / 3)
    assert precision_at_k(retrieved, relevant, 5) == pytest.approx(2 / 5)
    assert mrr(retrieved, relevant) == pytest.approx(1 / 2)
    assert mrr(retrieved, {42}) == 0.0


def test_average_precision():
    # hits at ranks 1 and 3 of 2 relevant: AP = (1/1 + 2/3)/2
    assert average_precision([1, 2, 3], {1, 3}) == pytest.approx(
        (1.0 + 2 / 3) / 2)


def test_ndcg_known_value():
    # binary relevance, hit at ranks 1 and 3, two relevant total
    got = ndcg_at_k([1, 2, 3], {1, 3}, 3)
    dcg = 1 / math.log2(2) + 1 / math.log2(4)
    idcg = 1 / math.log2(2) + 1 / math.log2(3)
    assert got == pytest.approx(dcg / idcg)
    assert ndcg_at_k([9, 8], {1}, 2) == 0.0
    # perfect ranking => 1.0
    assert ndcg_at_k([1, 3], {1, 3}, 2) == pytest.approx(1.0)


def test_dcg():
    assert dcg_at_k([3, 2, 1], 2) == pytest.approx(3 + 2 / math.log2(3))


def test_paired_t_test():
    a = [0.5, 0.6, 0.7, 0.4, 0.55]
    b = [x + 0.1 for x in a]
    t, p = paired_t_test(a, b)
    assert p < 0.01 and t < 0
    t, p = paired_t_test(a, a)
    assert p == 1.0


def test_rank_agreement_perfect():
    out = rank_agreement([1, 2, 3, 4], [2, 4, 6, 8])
    assert out["spearman"] == pytest.approx(1.0)
    assert out["kendall"] == pytest.approx(1.0)


def test_tail_analysis():
    scores = np.exp(-np.linspace(0, 5, 100))
    out = tail_analysis(scores)
    assert out["head_mean"] > out["tail_mean"]
    assert 0 <= out["tail_head_ratio"] < 1
    assert out["decay_rate"] < 0


def test_evaluate_run_aggregates():
    out = evaluate_run([[1, 2], [3, 4]], [{1}, {9}], k=2)
    assert out["mean_recall@k"] == pytest.approx(0.5)
    assert out["mean_mrr"] == pytest.approx(0.5)
    assert out["n_queries"] == 2


def test_rbo():
    assert rbo_stability([1, 2, 3], [1, 2, 3]) == pytest.approx(
        (1 - 0.9) * (1 + 0.9 + 0.81))
    assert rbo_stability([1, 2], [3, 4]) == 0.0


def test_topology_metrics_smoke():
    rng = np.random.default_rng(0)
    # two well-separated clusters
    emb = np.vstack([rng.normal(0, 0.1, size=(20, 8)) + 1,
                     rng.normal(0, 0.1, size=(20, 8)) - 1])
    g, n2c = build_topology_graph(emb, knn_k=5)
    assert g.number_of_nodes() == 40
    # a result set inside one cluster has high community purity
    assert compute_modularity_delta({0, 1, 2, 3}, n2c) == 1.0
    tf = compute_topology_factor(g, 0, [1, 2, 21], n2c)
    assert len(tf) == 3
    assert all(0 <= t <= 1.5 for t in tf)
    rel = [1.0, 0.0, 1.0]
    assert g_rbp(rel, tf, k=3) > 0
    assert 0 <= td_ndcg(rel, tf, k=3) <= 1.0 + 1e-9
    assert it_err(rel, tf, k=3) > 0
    assert mrr_topo(rel, tf) == pytest.approx(tf[0] / 1)
    assert sqi(g, [1, 2, 3], 0, n2c) > 0


def test_mrr_topo_no_relevant():
    assert mrr_topo([0, 0], [0.5, 0.5]) == 0.0


def test_iter_cve_json_skips_malformed_and_filters_years():
    recs = dict(iter_cve_json(str(FIXTURES)))
    ids = {r.get("cveMetadata", {}).get("cveId") for r in recs.values()}
    # 6 parseable fixtures; CVE-2023-90006.json is malformed and skipped.
    assert len(recs) == 6, sorted(recs)
    assert "CVE-2021-90001" in ids and "CVE-2023-90005" in ids
    # year filter: only 2021 records when the range excludes 2023
    recs21 = dict(iter_cve_json(str(FIXTURES), start=2021, end=2021))
    assert len(recs21) == 4
    assert all("2021" in p for p in recs21)


def test_extract_cve_text_fields():
    path = FIXTURES / "2021" / "CVE-2021-90001.json"
    cid, title, text = extract_cve_text(json.loads(path.read_text()))
    assert cid == "CVE-2021-90001"
    assert title == "Heap overflow in image parser"
    # " | "-joined field order: id, title, description, CWE, CVSS, products
    parts = text.split(" | ")
    assert parts[0] == cid and parts[1] == title
    assert "heap buffer" in parts[2]
    assert parts[3] == "CWE-122"
    assert parts[4].startswith("CVSS:3.1/")
    assert parts[5] == "examplesoft imagelib"


def test_extract_cve_text_minimal_record():
    path = FIXTURES / "2021" / "CVE-2021-90007.json"
    cid, title, text = extract_cve_text(json.loads(path.read_text()))
    assert cid == "CVE-2021-90007"
    assert title == "(no title)"   # reference placeholder behavior
    assert "Minimal record description." in text


def test_cve_fixture_end_to_end_hash_embed():
    """Fixture tree -> extract -> hash_embed -> x12 scale -> build ->
    search at the protocol taus: the full raw-text path of bench_2."""
    ids, titles, texts = load_cve_corpus(str(FIXTURES))
    assert len(ids) == 6 and all(texts)
    emb = hash_embed(texts, dim=384).astype(np.float64) * 12.0
    assert emb.shape == (6, 384)
    gp = {"eps": 1.31, "k": 4, "topk": 3, "p": 2.0, "sigma": 0.535}
    aspace, gl = pt.ArrowSpaceBuilder.build(gp, emb, device="cpu")
    hits = aspace.search(emb[0] * 1.02, gl, 0.62)
    assert hits[0][0] == 0    # a near-copy query retrieves its record
    assert len(hits) == 3


def test_iter_cve_json_year_in_root_dir_does_not_defeat_filter(tmp_path):
    """r3 review regression: the year filter used to substring-match the
    WHOLE path, so a year-like token in root_dir (e.g. .../cve_2023_dump)
    satisfied any range and the [start, end] filter was a no-op."""
    root = tmp_path / "cve_2023_dump"
    shutil.copytree(FIXTURES, root)
    recs = dict(iter_cve_json(str(root), start=1999, end=2001))
    assert len(recs) == 0, sorted(recs)
    recs21 = dict(iter_cve_json(str(root), start=2021, end=2021))
    assert len(recs21) == 4
    # flat layout: the year comes from the CVE id in the filename
    flat = tmp_path / "flat"
    flat.mkdir()
    for p in (FIXTURES / "2021").glob("*.json"):
        shutil.copy(p, flat / p.name)
    assert len(dict(iter_cve_json(str(flat), start=2021, end=2021))) == 4
    assert len(dict(iter_cve_json(str(flat), start=2023, end=2023))) == 0


def test_hash_embed_properties():
    texts = ["the quick brown fox", "the quick brown foxes",
             "completely unrelated text about databases"]
    emb = hash_embed(texts, dim=256)
    assert emb.shape == (3, 256)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-6)
    sim_close = emb[0] @ emb[1]
    sim_far = emb[0] @ emb[2]
    assert sim_close > sim_far  # lexical similarity preserved
    # determinism
    np.testing.assert_array_equal(emb, hash_embed(texts, dim=256))


def test_embed_texts_falls_back_offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    emb = embed_texts(["hello world", "goodbye world"],
                      model_name="definitely/not-a-local-model")
    assert emb.shape == (2, 384)
    assert np.all(np.isfinite(emb))


def test_sweep_isolation():
    configs = grid(eta=[0.1, 0.2], steps=[1, 2])
    assert len(configs) == 4

    def run_one(cfg):
        if cfg["eta"] == 0.2 and cfg["steps"] == 2:
            raise RuntimeError("boom")
        return {"score": cfg["eta"] * cfg["steps"]}

    rows = run_sweep(configs, run_one)
    assert len(rows) == 4
    statuses = [r["status"] for r in rows]
    assert statuses.count("OK") == 3 and statuses.count("FAILED") == 1
    failed = next(r for r in rows if r["status"] == "FAILED")
    assert "boom" in failed["error"]

    with pytest.raises(RuntimeError):
        run_sweep(configs, run_one, stop_on_error=True)
