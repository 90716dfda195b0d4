"""HuggingFace dataset loaders (optional-import ports of the reference
harness's dataset stages).

Zero-egress environments never reach the network: both loaders raise
ImportError/RuntimeError cleanly when `datasets` is missing or offline,
and the benchmark scripts fall back to fixtures/synthetic corpora.

The row-processing semantics (id mapping, positive-pair construction,
dataset/query splits) mirror the reference scripts so that runs against
the real datasets are comparable:
  - Quora duplicate questions: tests/test_1_quora_questions.py:31-75
  - BeIR/MS MARCO corpus+queries+qrels: tests/test_3_beir.py:24-82
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def load_quora_duplicates(sample: int = 10000, n_queries: int = 1000,
                          seed: int = 42):
    """Quora duplicate-question retrieval split.

    Builds the unique-question corpus with duplicate-pair positives, then
    a random `sample`-question dataset subset and a disjoint query set
    restricted to questions with at least one in-dataset duplicate (the
    reference's eligibility rule, test_1_quora_questions.py:50-75).

    Returns (corpus_texts: list[str], dataset_idx [S], query_ids [Q],
    positives: dict global_id -> set of global ids).
    """
    from datasets import load_dataset  # optional dep

    ds = load_dataset("quora", split="train", trust_remote_code=True)
    corpus: list[str] = []
    qid: dict[str, int] = {}
    positives: dict[int, set[int]] = defaultdict(set)

    def get_id(text: str) -> int:
        if text not in qid:
            qid[text] = len(corpus)
            corpus.append(text)
        return qid[text]

    for row in ds:
        t1, t2 = row["questions"]["text"]
        i1, i2 = get_id(t1), get_id(t2)
        if bool(row["is_duplicate"]):
            positives[i1].add(i2)
            positives[i2].add(i1)

    rng = np.random.default_rng(seed)
    n = len(corpus)
    dataset_idx = rng.choice(n, size=min(sample, n), replace=False)
    in_ds = set(dataset_idx.tolist())
    pool = [g for g, pos in positives.items()
            if g not in in_ds and any(p in in_ds for p in pos)]
    if not pool:
        raise RuntimeError(
            "no queries have duplicates inside the dataset subset; "
            "re-seed or enlarge the sample")
    query_ids = rng.choice(np.array(pool),
                           size=min(n_queries, len(pool)), replace=False)
    return corpus, dataset_idx, query_ids, positives


def load_beir_msmarco(corpus_size: int = 200000):
    """BeIR/MS MARCO passages + queries + validation qrels.

    Passage text is `title + " " + text` when a title exists
    (test_3_beir.py:56-60); only queries with at least one positive
    inside the capped corpus are kept.

    Returns (corpus_texts, query_texts, relevant: list[set[int]] per
    kept query, graded: list[dict[int, int]]).
    """
    from datasets import load_dataset  # optional dep

    corpus_ds = load_dataset("BeIR/msmarco", "corpus", split="corpus")
    queries_ds = load_dataset("BeIR/msmarco", "queries", split="queries")
    qrels_ds = load_dataset("BeIR/msmarco-qrels", split="validation")

    corpus, cid2idx = [], {}
    for i, row in enumerate(corpus_ds):
        if i >= corpus_size:
            break
        text = (f"{row['title']} {row['text']}" if row.get("title")
                else row["text"])
        cid2idx[row["_id"]] = len(corpus)
        corpus.append(text)

    queries, qid2idx = [], {}
    for row in queries_ds:
        qid2idx[row["_id"]] = len(queries)
        queries.append(row["text"])

    positives = defaultdict(set)
    graded = defaultdict(dict)
    for row in qrels_ds:
        q, c, s = row["query-id"], row["corpus-id"], int(row["score"])
        if s > 0 and str(q) in qid2idx and str(c) in cid2idx:
            positives[qid2idx[str(q)]].add(cid2idx[str(c)])
            graded[qid2idx[str(q)]][cid2idx[str(c)]] = s

    kept = sorted(positives)
    return (corpus, [queries[i] for i in kept],
            [positives[i] for i in kept], [graded[i] for i in kept])
