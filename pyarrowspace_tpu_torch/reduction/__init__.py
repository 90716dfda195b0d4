from .pipeline import ReductionResult, reduce_corpus, twonn_intrinsic_dim

__all__ = ["ReductionResult", "reduce_corpus", "twonn_intrinsic_dim"]
