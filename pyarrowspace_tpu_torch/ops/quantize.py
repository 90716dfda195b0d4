"""Per-row symmetric int8 quantization of the serving corpus (port of
pyarrowspace_tpu/ops/quantize.py).

    xq[i] = round(x[i] / s_i),   s_i = max|x[i]| / 127
    cos(q, x_i) ~= (qq . xq[i]) * s_q * s_i

The int8 scan (kernel K7, ops/cuda/scan_int8.py) is a candidate generator:
it keeps a pool of 4 x topk per query, and ops/search.rescore_candidates
rescores the pool against the float32 corpus, so the served top-k is the
exact scan's whenever the exact top-k lies in the pool.
"""

from __future__ import annotations

import torch


def quantize_rows(xu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, F] float rows -> ([N, F] int8, [N] float32 per-row scales).

    Absmax per row; rows of zeros are scaled as if their absmax were 1,
    so the dequantized row is exactly zero.  ``torch.round`` rounds half
    to even, as ``jnp.round`` does, so the int8 values equal the JAX
    package's bit for bit."""
    x = xu.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    safe = torch.where(absmax > 0, absmax, 1.0)
    # XLA compiles the reference's `safe / 127.0` to a multiply by
    # float32(1 / 127), which differs from the division in ~5% of rows.
    # The factor stays a CPU scalar: made on the device it would be a copy
    # from pageable memory, which waits for the stream to drain.
    scale = safe * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    xq = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return xq, scale[..., 0]
