"""Topology-aware IR metrics (reference tests/test_6_beir_new_score.py:330-406).

Six graph-aware metrics computed over an independently built cosine k-NN
graph with greedy-modularity communities: G-RBP, TD-nDCG, IT-ERR, MRR-Topo,
SQI@k, RBO-S.  The per-rank topology factor blends personalized PageRank,
conductance, and community purity with the reference's weights
(lambda = {ppr .4, cond .3, mod .3}; mu = {cond .4, mod .3, ppr .3} —
test_6:52-53).  Implemented from the metric definitions; graph primitives
use networkx like the reference harness.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np

LAMBDA_WEIGHTS = {"ppr": 0.4, "cond": 0.3, "mod": 0.3}
MU_WEIGHTS = {"cond": 0.4, "mod": 0.3, "ppr": 0.3}
RBP_P = 0.9


def build_topology_graph(embeddings: np.ndarray, knn_k: int = 15):
    """Cosine k-NN graph + greedy-modularity communities (the reference's
    independent ground-truth structure, test_6:240-263)."""
    import networkx as nx
    from sklearn.neighbors import NearestNeighbors

    nbrs = NearestNeighbors(n_neighbors=knn_k + 1, metric="cosine")
    nbrs.fit(embeddings)
    distances, indices = nbrs.kneighbors(embeddings)
    g = nx.Graph()
    g.add_nodes_from(range(len(embeddings)))
    for i in range(len(embeddings)):
        for j_pos, j in enumerate(indices[i][1:]):
            weight = 1.0 - distances[i][j_pos + 1]
            if weight > 0:
                g.add_edge(i, int(j), weight=weight)
    from networkx.algorithms.community import greedy_modularity_communities
    communities = list(greedy_modularity_communities(g, weight="weight"))
    node_to_community = {}
    for ci, comm in enumerate(communities):
        for node in comm:
            node_to_community[node] = ci
    return g, node_to_community


def compute_ppr(g, query_node: int, nodes_set: set, alpha: float = 0.85,
                max_iter: int = 100) -> dict:
    """Personalized PageRank from the query node, restricted to nodes_set."""
    import networkx as nx
    if query_node not in g or not nodes_set:
        return {n: 1.0 / max(len(nodes_set), 1) for n in nodes_set}
    personalization = {n: 0.0 for n in g.nodes()}
    personalization[query_node] = 1.0
    try:
        ppr = nx.pagerank(g, alpha=alpha, personalization=personalization,
                          max_iter=max_iter, weight="weight")
        return {n: ppr.get(n, 0.0) for n in nodes_set}
    except Exception:
        return {n: 1.0 / len(nodes_set) for n in nodes_set}


def compute_conductance(g, nodes_set: set) -> float:
    import networkx as nx
    if not nodes_set:
        return 1.0
    complement = set(g.nodes()) - set(nodes_set)
    if not complement:
        return 0.0
    try:
        return nx.conductance(g, nodes_set, complement, weight="weight")
    except Exception:
        return 1.0


def compute_modularity_delta(nodes_set: set,
                             node_to_community: Mapping[int, int]) -> float:
    """Community purity of the result set: largest same-community fraction."""
    if not nodes_set:
        return 0.0
    counts = defaultdict(int)
    for node in nodes_set:
        counts[node_to_community.get(node, -1)] += 1
    return max(counts.values()) / len(nodes_set)


def compute_topology_factor(g, query_node: int,
                            result_indices: Sequence[int],
                            node_to_community,
                            weights: Mapping[str, float] = LAMBDA_WEIGHTS
                            ) -> list[float]:
    """Per-rank factor T_i over growing result prefixes (test_6:306-327)."""
    factors = []
    for i, node in enumerate(result_indices):
        prefix = set(result_indices[: i + 1])
        ppr_score = compute_ppr(g, query_node, prefix).get(node, 0.0)
        cond_score = 1.0 - compute_conductance(g, prefix)
        mod_score = compute_modularity_delta(prefix, node_to_community)
        factors.append(weights["ppr"] * ppr_score
                       + weights["cond"] * cond_score
                       + weights["mod"] * mod_score)
    return factors


def g_rbp(relevances: Sequence[float], topology_factors: Sequence[float],
          p: float = RBP_P, k: int = 10) -> float:
    """Graph-aware Rank-Biased Precision."""
    return float(sum((1 - p) * relevances[i] * (p ** i) * topology_factors[i]
                     for i in range(min(k, len(relevances)))))


def td_ndcg(relevances: Sequence[float], topology_factors: Sequence[float],
            k: int = 10) -> float:
    """Topology-Discounted nDCG."""
    dcg = sum(((2.0 ** relevances[i] - 1.0) * topology_factors[i])
              / math.log2(i + 2) for i in range(min(k, len(relevances))))
    ideal = sorted(relevances[:k], reverse=True)
    max_t = max(topology_factors[:k]) if topology_factors else 1.0
    idcg = sum((2.0 ** r - 1.0) * max_t / math.log2(i + 2)
               for i, r in enumerate(ideal))
    return float(dcg / idcg) if idcg > 0 else 0.0


def it_err(relevances: Sequence[float], topology_factors: Sequence[float],
           k: int = 10, max_grade: float = 3.0) -> float:
    """Intent- and Topology-aware Expected Reciprocal Rank."""
    err, prob_stop = 0.0, 0.0
    for i in range(min(k, len(relevances))):
        r_t = (relevances[i] / max_grade) * topology_factors[i]
        err += (1 - prob_stop) * r_t / (i + 1)
        prob_stop += (1 - prob_stop) * r_t
    return float(err)


def mrr_topo(relevances: Sequence[float],
             topology_factors: Sequence[float]) -> float:
    """Topology-weighted reciprocal rank of the first relevant hit."""
    for i, rel in enumerate(relevances):
        if rel > 0:
            return float(topology_factors[i] / (i + 1))
    return 0.0


def sqi(g, result_indices: Sequence[int], query_node: int,
        node_to_community, mus: Mapping[str, float] = MU_WEIGHTS,
        k: int = 10) -> float:
    """Subgraph Quality Index of the top-k result set."""
    result_set = set(result_indices[:k])
    cond = compute_conductance(g, result_set)
    mod = compute_modularity_delta(result_set, node_to_community)
    ppr_sum = sum(compute_ppr(g, query_node, result_set).values())
    return float(mus["cond"] * (1 - cond) + mus["mod"] * mod
                 + mus["ppr"] * ppr_sum)


def rbo_stability(rank_a: Sequence[int], rank_b: Sequence[int],
                  p: float = RBP_P) -> float:
    """Rank-Biased Overlap between two rankings."""
    depth = min(len(rank_a), len(rank_b))
    score = 0.0
    for d in range(1, depth + 1):
        overlap = len(set(rank_a[:d]) & set(rank_b[:d]))
        score += (p ** (d - 1)) * (overlap / d)
    return float((1 - p) * score)
