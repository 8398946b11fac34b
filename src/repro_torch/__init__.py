"""TINA on PyTorch and CUDA: the port of the JAX/Pallas package ``repro``
to an NVIDIA H100.

Module names mirror the reference's, so ``repro_torch.core.pfb`` is the
counterpart of ``repro.core.pfb``.  Every lowering of the reference has
a twin here: ``native`` and ``conv`` are plain torch, and ``kernel``
(the reference's ``pallas``) runs the hand-written CUDA kernels of
:mod:`repro_torch.kernels`.  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``; asking for CUDA without a card raises.

This package imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; RuntimeError when CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device", "__version__"]
