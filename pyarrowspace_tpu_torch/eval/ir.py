"""IR evaluation metrics — the parity yardstick.

The reference defines parity through its harness metrics (SURVEY.md §5):
recall@k / MRR / MAP / nDCG@k with paired t-tests (reference
tests/test_3_beir.py:224-381, test_8:112-157), Spearman/Kendall rank
agreement and tail analysis (test_2:159-243).  These are standard formulas,
implemented here from their definitions with the reference's conventions
(binary relevance unless graded qrels given; log2 discounts; ideal DCG over
the query's own relevant set).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np


def recall_at_k(retrieved: Sequence[int], relevant: set, k: int) -> float:
    """|top-k ∩ relevant| / |relevant| (reference test_3_beir.py
    `recall_at_k`)."""
    if not relevant:
        return 0.0
    return len(set(retrieved[:k]) & set(relevant)) / len(relevant)


def precision_at_k(retrieved: Sequence[int], relevant: set, k: int) -> float:
    if k == 0:
        return 0.0
    return len(set(retrieved[:k]) & set(relevant)) / k


def mrr(retrieved: Sequence[int], relevant: set) -> float:
    """Reciprocal rank of the first relevant hit (reference `mrr_score`,
    `compute_mrr`)."""
    for i, doc in enumerate(retrieved):
        if doc in relevant:
            return 1.0 / (i + 1)
    return 0.0


def average_precision(retrieved: Sequence[int], relevant: set,
                      k: int | None = None) -> float:
    """AP@k (reference test_8 `compute_map`)."""
    if not relevant:
        return 0.0
    if k is None:
        k = len(retrieved)
    hits, score = 0, 0.0
    for i, doc in enumerate(retrieved[:k]):
        if doc in relevant:
            hits += 1
            score += hits / (i + 1)
    return score / min(len(relevant), k)


def dcg_at_k(gains: Sequence[float], k: int) -> float:
    """DCG with log2(i+2) discount (reference test_3 `dcg_at_k`)."""
    return float(sum(g / math.log2(i + 2) for i, g in enumerate(gains[:k])))


def ndcg_at_k(retrieved: Sequence[int],
              relevance: Mapping[int, float] | set, k: int,
              exp_gain: bool = False) -> float:
    """nDCG@k.  relevance: either a {doc: grade} mapping or a set (binary).
    exp_gain=True uses (2^grade - 1) gains (graded qrels convention)."""
    if isinstance(relevance, set):
        grades = {d: 1.0 for d in relevance}
    else:
        grades = dict(relevance)
    if not grades:
        return 0.0

    def gain(g):
        return (2.0 ** g - 1.0) if exp_gain else g

    actual = [gain(grades.get(d, 0.0)) for d in retrieved[:k]]
    ideal = sorted((gain(g) for g in grades.values()), reverse=True)[:k]
    idcg = dcg_at_k(ideal, k)
    return dcg_at_k(actual, k) / idcg if idcg > 0 else 0.0


def paired_t_test(a: Sequence[float], b: Sequence[float]):
    """Paired t-test (reference test_3:224-381 compares per-query metric
    vectors of two methods).  Returns (t_stat, p_value)."""
    from scipy import stats
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if len(a) < 2 or np.allclose(a, b):
        return 0.0, 1.0
    t, p = stats.ttest_rel(a, b)
    return float(t), float(p)


def rank_agreement(scores_a: Sequence[float], scores_b: Sequence[float]):
    """Spearman and Kendall correlations between two score vectors
    (reference test_2 `compute_ranking_metrics`)."""
    from scipy import stats
    rho, rho_p = stats.spearmanr(scores_a, scores_b)
    tau, tau_p = stats.kendalltau(scores_a, scores_b)
    return {"spearman": float(rho), "spearman_p": float(rho_p),
            "kendall": float(tau), "kendall_p": float(tau_p)}


def tail_analysis(sorted_scores: Sequence[float],
                  head_frac: float = 0.1, tail_frac: float = 0.5):
    """Tail-distribution diagnostics of a descending score list (reference
    test_2 `analyze_tail_distribution`): head/tail means, tail/head ratio,
    coefficient of variation, exponential decay rate."""
    s = np.asarray(sorted_scores, dtype=float)
    n = len(s)
    if n == 0:
        return {}
    n_head = max(1, int(n * head_frac))
    n_tail = max(1, int(n * tail_frac))
    head = s[:n_head]
    tail = s[-n_tail:]
    mean = float(s.mean())
    cv = float(s.std() / mean) if mean != 0 else 0.0
    # Decay rate: least-squares slope of log(score - min + eps) vs rank.
    shifted = s - s.min() + 1e-12
    ranks = np.arange(n, dtype=float)
    slope = float(np.polyfit(ranks, np.log(shifted), 1)[0]) if n > 1 else 0.0
    return {
        "head_mean": float(head.mean()),
        "tail_mean": float(tail.mean()),
        "tail_head_ratio": float(tail.mean() / head.mean())
        if head.mean() != 0 else 0.0,
        "cv": cv,
        "decay_rate": slope,
    }


def evaluate_run(per_query_retrieved: Sequence[Sequence[int]],
                 per_query_relevant: Sequence[set], k: int = 10):
    """Aggregate a retrieval run: per-query and mean recall@k / MRR / nDCG@k
    (the test_3/test_4/test_5 protocol's summary block)."""
    recalls, mrrs, ndcgs = [], [], []
    for retrieved, relevant in zip(per_query_retrieved, per_query_relevant):
        recalls.append(recall_at_k(retrieved, relevant, k))
        mrrs.append(mrr(retrieved, relevant))
        ndcgs.append(ndcg_at_k(list(retrieved), set(relevant), k))
    return {
        "recall@k": recalls, "mrr": mrrs, "ndcg@k": ndcgs,
        "mean_recall@k": float(np.mean(recalls)) if recalls else 0.0,
        "mean_mrr": float(np.mean(mrrs)) if mrrs else 0.0,
        "mean_ndcg@k": float(np.mean(ndcgs)) if ndcgs else 0.0,
        "k": k, "n_queries": len(recalls),
    }
