"""Tensors of host constants, made once per (device, dtype).

A tensor made from host data (`torch.tensor`, `torch.as_tensor` of a list
or an array) is a copy from host memory: on the card it waits for the
stream, and inside a CUDA graph capture it is not allowed at all. A module
that needs such a constant keeps a `Consts` of its values and asks it for
the tensor on the device and in the dtype at hand; the first request makes
it (outside any capture: the capture's warm-up run makes every constant the
captured body asks for), later ones return the same tensor.
"""

from __future__ import annotations

import torch


class Consts:
    """Named host values, each made into a tensor once per (device,
    dtype)."""

    def __init__(self, **values):
        self._values = values
        self._made = {}

    def get(self, name: str, dtype: torch.dtype, device) -> torch.Tensor:
        key = (name, dtype, torch.device(device))
        t = self._made.get(key)
        if t is None:
            t = torch.as_tensor(self._values[name], dtype=dtype,
                                device=device)
            self._made[key] = t
        return t


def scale(v, dtype: torch.dtype):
    """A step size that scales tensors: a tensor in `dtype`, or a Python
    number as it is (a number needs no tensor to scale with)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return float(v)


def per_scenario(v, nb: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A per-scenario value as an (nb,) tensor: a tensor broadcast, a
    number filled on the device (no copy from the host)."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(dtype), (nb,))
    return torch.full((nb,), float(v), dtype=dtype, device=device)
