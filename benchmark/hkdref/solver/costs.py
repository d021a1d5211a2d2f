"""The relaxed-barrier (ReB) value and derivatives of the HKD problem's
path constraints — from the port's `solver/costs.py`, frozen (the cost
terms themselves are the horizon-minor entries of `ops/hkd_tminor.py`).
Every function is elementwise. Parity: the relaxed barrier
(ConstraintsBase.h:204-263).
"""

from __future__ import annotations

import torch


def reb_value(g, delta, eps):
    """eps * B_delta(g), elementwise. B(g) = -log g for g > delta, quadratic
    extension below."""
    g_safe = torch.clamp(g, min=1e-30)  # guard log of masked/negative rows
    quad = 0.5 * (((g - 2 * delta) / delta) ** 2 - 1.0) - torch.log(delta)
    return eps * torch.where(g > delta, -torch.log(g_safe), quad)


def reb_derivs(g, delta, eps):
    """(eps*B', eps*B'') elementwise."""
    g_safe = torch.where(g > delta, g, torch.ones_like(g))
    d1 = torch.where(g > delta, -1.0 / g_safe, (g - 2 * delta) / (delta * delta))
    d2 = torch.where(g > delta, 1.0 / (g_safe * g_safe),
                     1.0 / (delta * delta))
    return eps * d1, eps * d2
