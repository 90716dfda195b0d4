from .build import BuildConfig, build_standard
from .feature import build_feature_laplacian, laplacian_from_sq_dists

__all__ = ["BuildConfig", "build_standard", "build_feature_laplacian",
           "laplacian_from_sq_dists"]
