"""Medians with NumPy's even-count rule, and segment sums in a fixed order.

``torch.median`` / ``torch.nanmedian`` return the LOWER of the two middle
values of an even count; ``numpy.median`` and ``jax.numpy.median`` return
their mean.  τ* (median energy) and the feature graph's kept-distance
medians need the latter.

``index_add_`` on a CUDA tensor sums with float atomics, in an order that
changes from run to run, so two builds of the same rows would differ in
the last bits of every centroid; ``segment_sum`` uses no atomics, so its
order is fixed.
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


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """sum of values[r] over the rows r of each segment, [n_seg, ...].

    The rows are sorted stably by segment and each segment is reduced by
    ``torch.segment_reduce``, with no atomics: the same bits on every run.
    On the CPU that reduction adds each segment's rows in row order from
    zero, which gives ``index_add_``'s bits; on CUDA its order is fixed
    too, though not always row order (1-D sums go through CUB's segmented
    reduce)."""
    seg = seg.to(torch.int64)
    order = torch.sort(seg, stable=True).indices
    lengths = torch.bincount(seg, minlength=n_seg)
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0, unsafe=True)
