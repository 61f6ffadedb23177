"""Float32 helpers that round the way the JAX package and the kernels do.

PyTorch's vectorised CPU ``sqrt`` for float32 is not correctly rounded
(about 0.6% of inputs come out one ulp off), while XLA's and CUDA's
``sqrtf`` are. The square root of a float32 computed in float64 and
rounded once to float32 is the correctly rounded result, so the port takes
every float32 square root through float64.

On a CUDA tensor, PyTorch divides by a Python scalar as a multiply by its
float32 reciprocal, which can differ by an ulp from the division that the
CPU, XLA and the kernels do; ``div`` divides by a tensor instead.

``sqrt_grad_safe`` is ``sqrt`` with the gradient of the JAX package's
double-where: its value is the same bit for bit, and where the input is 0
its gradient is cut instead of infinite (sqrt's derivative at 0 times a
zero cotangent is NaN, which reverse mode would carry into every
parameter upstream).
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def sqrt_grad_safe(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)``, bit for bit, whose gradient is sqrt's where x > 0 and
    cut where it is not; the same tensor as ``sqrt`` when autograd does
    not record ``x``."""
    if not x.requires_grad:
        return sqrt(x)
    pos = x.detach() > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, torch.ones_like(x))),
                       sqrt(x.detach()))


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one float32 division on every device."""
    return x / torch.full_like(x, d)
