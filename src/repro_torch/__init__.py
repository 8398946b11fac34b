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

import functools

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; RuntimeError when CUDA is asked for and there is no card.
    A card is always indexed (``"cuda"`` is the current card, so a plan,
    its cache key and a service's streams name one card, not whichever
    is current when they are used)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Made:
    """State made once on the current CUDA stream and then read from any
    stream (the DFM's kernel forms, a plan's consts and weight packs):
    the value (a tensor, or a tuple or list of them) and an event
    recorded after it was made.  :meth:`get` orders the reader's current
    stream after that event on the card, so a kernel on another stream (a
    service's, say) never reads it half made, and no host thread waits
    for the stream that made it.  Once the event has passed, reads cost
    one attribute check.  Off the card there is no event."""

    __slots__ = ("value", "_event", "_device")

    def __init__(self, value):
        self.value = value
        parts = value if isinstance(value, (tuple, list)) else (value,)
        self._device = next((t.device for t in parts
                             if isinstance(t, torch.Tensor) and t.is_cuda),
                            None)
        self._event = None
        if self._device is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._device))

    def get(self):
        ev = self._event
        if ev is not None:
            if ev.query():
                self._event = None       # made: no reader waits again
            else:
                torch.cuda.current_stream(self._device).wait_event(ev)
        return self.value


def made_once(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes state
    read from any stream: each value is kept as a :class:`Made` and each
    call returns it through :meth:`Made.get`.  ``cache_clear`` is the
    cache's."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(
            lambda *a, **k: Made(fn(*a, **k)))

        @functools.wraps(fn)
        def get(*args, **kwargs):
            return cached(*args, **kwargs).get()

        get.cache_clear = cached.cache_clear
        return get
    return wrap


__all__ = ["resolve_device", "Made", "made_once", "__version__"]
