"""Per-kernel block-size tuning spaces for the hand-written CUDA kernels.

A :class:`TuneSpace` is a kernel's own declaration of what is tunable:

  * ``params``      the block-size kwarg names the kernel wrapper accepts
  * ``candidates``  shape-aware candidate configs
  * ``valid``       the CUDA kernel's HARD limits (compiled tile shapes,
                    shared memory per block, threads per block) so a bad
                    config raises ``ValueError`` at the wrapper instead
                    of failing at launch
  * ``default``     the config the public wrapper uses when none is given

Spaces are declared next to each kernel (``pfb.TUNE_SPACE``, ...) and
registered here; :func:`space` is the lookup the ops wrappers share.
``ctx`` dicts carry the shape facts a space needs (tap count, branch
count, rows -- see each kernel's declaration).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# Hopper (sm_90): shared memory one block may use, as dynamic shared
# memory after cudaFuncSetAttribute (227 KB of the SM's 256 KB).
SMEM_BUDGET = 232_448
MAX_THREADS = 1024   # threads per block
WARP = 32


def leading_rows(shape) -> int:
    """Flattened row count of an array viewed as 2-D: product of every
    dim but the last (1 for 0-D/1-D) -- the ``rows`` every ctx uses."""
    out = 1
    for d in shape[:-1]:
        out *= int(d)
    return out


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    kernel: str                                  # registry key
    params: tuple[str, ...]                      # tunable kwarg names
    candidates: Callable[[dict], tuple]          # ctx -> candidate cfgs
    valid: Callable[[dict, dict], bool]          # (cfg, ctx) -> ok?
    default: Callable[[dict], dict]              # ctx -> default cfg

    def check(self, cfg: dict, ctx: dict) -> dict:
        """Merge ``cfg`` over the defaults and validate -- the kernel
        boundary's input check.  Raises ValueError on an unknown param
        or an invalid explicit config; an empty cfg is the default and
        is trusted as such."""
        unknown = set(cfg) - set(self.params)
        if unknown:
            raise ValueError(
                f"{self.kernel}: unknown block param(s) {sorted(unknown)}; "
                f"tunable: {list(self.params)}")
        full = {**self.default(ctx),
                **{k: (v if isinstance(v, str) else int(v))
                   for k, v in cfg.items()}}
        if cfg and not self.valid(full, ctx):
            raise ValueError(
                f"{self.kernel}: invalid block config {full} for {ctx}")
        return full

    def configs(self, ctx: dict) -> tuple[dict, ...]:
        """Valid candidate configs for ``ctx``: default first, then the
        declared candidates, deduplicated."""
        out, seen = [], set()
        for cfg in (self.default(ctx), *self.candidates(ctx)):
            key = tuple(sorted(cfg.items()))
            if key in seen:
                continue
            seen.add(key)
            if self.valid(cfg, ctx):
                out.append(dict(cfg))
        return tuple(out)


SPACES: dict[str, TuneSpace] = {}


def register(sp: TuneSpace) -> TuneSpace:
    SPACES[sp.kernel] = sp
    return sp


def space(kernel: str) -> TuneSpace | None:
    """Look up a kernel's TuneSpace (importing the kernel modules so
    their declarations have run)."""
    from repro_torch.kernels import (dft, elementwise, fir,  # noqa: F401
                                     matmul, pfb, unfold)
    return SPACES.get(kernel)


__all__ = ["TuneSpace", "SPACES", "register", "space", "leading_rows",
           "SMEM_BUDGET", "MAX_THREADS", "WARP"]
