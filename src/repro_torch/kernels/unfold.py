"""Unfold and overlap-add kernels: TINA §4.4 and its adjoint as pure data
movement.

The CUDA kernels are in ``csrc/unfold.cu`` (``tina_unfold`` replaces the
JAX reference's ``kernels/unfold.py:unfold``, ``tina_overlap_add`` its
``overlap_add``; the source says what bounds them and how).
:func:`unfold` and :func:`overlap_add` launch them for a CUDA tensor and
run :func:`unfold_plain` / :func:`overlap_add_plain` for a CPU tensor.
Unlike the TPU kernels they need no padded axes and no halo rule
(J − 1 ≤ bt, K − 1 ≤ bt): each block loads its own halo and masks its
ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune

LAUNCHES = 0      # unfold launches since the last reset (plain excluded)
OLA_LAUNCHES = 0  # overlap_add launches since the last reset


def smem_bytes(bt: int, bj: int, j: int) -> int:
    """Dynamic shared memory one unfold block asks for: the samples its
    (bt frames x min(bj, J) columns) tile reads."""
    return 4 * (bt + min(bj, j) - 1)


def _unfold_ok(cfg: dict, ctx: dict) -> bool:
    bt, bj, j = cfg["bt"], cfg["bj"], ctx["j"]
    return (bt >= 1 and bj >= 1 and bt * min(bj, j) <= 1 << 30
            and -(-j // bj) <= 65535
            and smem_bytes(bt, bj, j) <= tune.SMEM_BUDGET)


# ctx: {"j": window, "n": signal length, "rows"}.  A block writes bt
# frames by bj columns; the hard limits are the samples it stages in
# shared memory and the grid's column dimension.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="unfold",
    params=("bt", "bj"),
    candidates=lambda ctx: tuple(
        {"bt": max(1, elems // min(bj, ctx["j"])), "bj": bj}
        for bj in (256, 1024) for elems in (4096, 8192, 16384)),
    valid=_unfold_ok,
    default=lambda ctx: {"bt": max(1, 8192 // min(1024, ctx["j"])),
                         "bj": 1024},
))

# ctx: {"j", "hop", "k": j // hop, "t": frames, "rows"}.  One thread per
# output sample in a grid-stride loop: the threads per block are the one
# tunable.
OLA_TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="overlap_add",
    params=("threads",),
    candidates=lambda ctx: tuple({"threads": t} for t in (128, 256, 512)),
    valid=lambda cfg, ctx: (0 < cfg["threads"] <= tune.MAX_THREADS
                            and cfg["threads"] % tune.WARP == 0),
    default=lambda ctx: {"threads": 256},
))


def unfold_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """y[r, t, j] = x[r, t + j] in plain torch: a strided view of every
    window, copied out whole."""
    rows, n = x.shape
    xc = x.contiguous()
    return xc.as_strided((rows, n - window + 1, window),
                         (xc.stride(0), 1, 1)).contiguous()


def overlap_add_plain(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """The overlap-add kernel's arithmetic in plain torch: from zero, the
    K overlapping frame slices added in ascending m."""
    rows, t, j = frames.shape
    k = j // hop
    nt = t - k + 1
    fk = frames.reshape(rows, t, k, hop)
    acc = torch.zeros((rows, nt, hop), dtype=frames.dtype,
                      device=frames.device)
    for m in range(k):
        acc = acc + fk[:, m:m + nt, k - 1 - m, :]
    return acc.reshape(rows, nt * hop)


def _check(what: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: input must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def unfold(x: torch.Tensor, window: int, *, bt: int = 8,
           bj: int = 1024) -> torch.Tensor:
    """x (R, N) -> (R, N − J + 1, J), y[r, t, j] = x[r, t + j], exact.

    A CPU tensor runs :func:`unfold_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    rows, n = x.shape
    j = int(window)
    if not 1 <= j <= n:
        raise ValueError(f"unfold: window {j} outside [1, {n}]")
    dev = x.device
    if dev.type == "cpu":
        return unfold_plain(x, j)
    if dev.type != "cuda":
        raise ValueError(f"unfold: no kernel for device {dev}")
    _check("unfold", x)
    if not _unfold_ok({"bt": bt, "bj": bj}, {"j": j}):
        raise ValueError(f"unfold: tile bt={bt} bj={bj} invalid for J={j}")
    out = torch.empty((rows, n - j + 1, j), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_unfold(
        x.data_ptr(), out.data_ptr(), rows, n, j, bt, bj,
        torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "unfold")
    return out


def overlap_add(frames: torch.Tensor, hop: int, *,
                threads: int = 256) -> torch.Tensor:
    """frames (R, T, J), hop | J -> (R, (T − K + 1) · hop), K = J / hop:
    out[r, s] = Σ_{m<K} frames[r, s // hop + m, (K − 1 − m)·hop + s % hop],
    summed in ascending m (bit-identical to the reference's native form).

    A CPU tensor runs :func:`overlap_add_plain`; a CUDA tensor launches
    the kernel on the current stream or raises."""
    rows, t, j = frames.shape
    if hop <= 0 or j % hop or t < j // hop:
        raise ValueError(f"overlap_add: hop {hop} must divide J={j} and "
                         f"T={t} >= J/hop")
    dev = frames.device
    if dev.type == "cpu":
        return overlap_add_plain(frames, hop)
    if dev.type != "cuda":
        raise ValueError(f"overlap_add: no kernel for device {dev}")
    _check("overlap_add", frames)
    if not (0 < threads <= tune.MAX_THREADS and threads % tune.WARP == 0):
        raise ValueError(f"overlap_add: threads={threads}")
    out = torch.empty((rows, (t - j // hop + 1) * hop), device=dev,
                      dtype=torch.float32)
    code = _build.lib().tina_overlap_add(
        frames.data_ptr(), out.data_ptr(), rows, t, j, hop, threads,
        torch.cuda.current_stream(dev).cuda_stream)
    global OLA_LAUNCHES
    OLA_LAUNCHES += 1
    _build.check(code, "overlap_add")
    return out


__all__ = ["unfold", "unfold_plain", "overlap_add", "overlap_add_plain",
           "TUNE_SPACE", "OLA_TUNE_SPACE", "LAUNCHES", "OLA_LAUNCHES",
           "smem_bytes"]
