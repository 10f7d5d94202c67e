"""Resolution of the ``device=`` argument every entry point takes."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent.

    There is no silent move to the CPU: only an explicit ``device="cpu"``
    runs the plain PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
