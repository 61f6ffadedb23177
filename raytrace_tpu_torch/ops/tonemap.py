"""Tone mapping and 8-bit quantisation (port of
``raytrace_tpu/ops/tonemap.py``): exposure 1 -> 1 - exp(-c) -> gamma 1/2.2
-> clamp to [0, 1] -> *255 truncated, as Go's uint8() truncates."""

from __future__ import annotations

import torch


def tonemap(color: torch.Tensor, exposure: float = 1.0,
            gamma: float = 2.2) -> torch.Tensor:
    c = 1.0 - torch.exp(-(color * exposure))
    c = torch.pow(torch.clamp(c, min=0.0), 1.0 / gamma)
    return torch.clamp(c, 0.0, 1.0)


def to_rgb8(mapped: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(mapped, 0.0, 1.0) * 255.0).to(torch.uint8)


def tonemap_rgb8(linear: torch.Tensor) -> torch.Tensor:
    """Linear radiance (...,3) -> uint8 display values."""
    return to_rgb8(tonemap(linear))
