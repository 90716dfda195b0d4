"""Medians with NumPy's even-count rule.

``torch.median`` / ``torch.nanmedian`` return the LOWER of the two middle
values of an even count; ``numpy.median`` and ``jax.numpy.median`` return
their mean.  τ* (median energy) and the feature graph's kept-distance
medians need the latter.
"""

from __future__ import annotations

import torch


def median(x: torch.Tensor, dim: int | None = None,
           ignore_nan: bool = False) -> torch.Tensor:
    """Median over ``dim`` (all elements when None): the mean of the two
    middle values of an even count, computed as (low + high) * 0.5.  With
    ``ignore_nan`` NaNs are left out (an all-NaN slice gives NaN)."""
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    s = torch.sort(x, dim=dim).values          # NaNs sort last
    size = s.shape[dim]
    if ignore_nan:
        count = (~torch.isnan(s)).sum(dim=dim, keepdim=True)
    else:
        count = torch.full_like(s.narrow(dim, 0, 1), size, dtype=torch.int64)
    half = (count - 1).clamp_min(0)
    low = torch.gather(s, dim, half // 2)
    high = torch.gather(s, dim, (half + 1) // 2)
    return ((low + high) * 0.5).squeeze(dim)
