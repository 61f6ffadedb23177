"""Where the port runs: on the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """Entry points default to CUDA and never fall back to the CPU.

    ``device=None`` means ``"cuda"``; asking for CUDA on a machine without
    a usable GPU raises instead of quietly running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:  # name the card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
