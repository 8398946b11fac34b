"""Counts of the ``pfb_power`` pipeline at f32: the ``pfb`` op (FIR bank
at the fp32 pipe, then the real input's DFT at TF32), the |.|^2 chain,
and the whole pipeline as one step."""
from __future__ import annotations

from counts import Work

F32, C64 = 4, 8     # bytes of a float32 and of a complex64


def pfb(rows: int, n: int, p: int, m: int) -> Work:
    """x (rows, n) float32 and taps (M, P) in; z (rows, T, P) complex64
    out.  FIR: M multiply-adds a frame sample.  DFT of a real input:
    columns 0..P/2, each a real-by-complex product of P terms."""
    t = n // p - m + 1
    frames = rows * t
    fir = 2.0 * m * p * frames
    dft = 4.0 * p * (p // 2 + 1) * frames
    return Work(rows * n * F32 + m * p * F32 + frames * p * C64,
                (("fp32", fir), ("tf32", dft)))


def chain(rows: int, n: int, p: int, m: int) -> Work:
    """|z|^2: z (rows, T, P) complex64 in, float32 out; three operations
    an element at the fp32 pipe."""
    elems = rows * (n // p - m + 1) * p
    return Work(elems * (C64 + F32), (("fp32", 3.0 * elems),))


def pipeline(rows: int, n: int, p: int, m: int) -> Work:
    """The whole step as one: x and the taps read once, the power written
    once, every operation of both nodes.  It bounds any fusion of them."""
    t = n // p - m + 1
    elems = rows * t * p
    a, b = pfb(rows, n, p, m), chain(rows, n, p, m)
    return Work(rows * n * F32 + m * p * F32 + elems * F32,
                (a + b).ops)


def call(cfg: dict, rows: int, n: int) -> dict[str, Work]:
    """The counts of one call on an input window of (rows, n)."""
    p, m = cfg["n_branches"], cfg["n_taps"]
    return {"pfb": pfb(rows, n, p, m), "chain": chain(rows, n, p, m),
            "pipeline": pipeline(rows, n, p, m)}
