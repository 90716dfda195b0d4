from . import ir, topology
from .ir import (average_precision, dcg_at_k, evaluate_run, mrr, ndcg_at_k,
                 paired_t_test, precision_at_k, rank_agreement, recall_at_k,
                 tail_analysis)
