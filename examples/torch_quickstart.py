"""TINA quickstart on PyTorch: every Table-1 mapping in a few lines, the
twin of ``examples/quickstart.py`` on the port (``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Shows the three lowerings of each op: ``native`` (plain torch), ``conv``
(the paper-faithful NN-layer form), ``kernel`` (the hand-written CUDA
kernels; on the CPU their plain torch versions) — all numerically
identical.  The signal functions and the PFB run at the ``kernel``
lowering, so the DFT, FIR, unfold and PFB kernels run too (the original
runs them at its default, ``native``, which the port's tests cover).
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (dft, elementwise_add, elementwise_mult, fir,
                              idft, matmul, pfb_full, pfb_window, summation,
                              unfold)

LOWERING = "kernel"   # the signal functions' and the PFB's


def show(name, got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    ok = np.allclose(got, want, rtol=1e-3, atol=1e-3)
    print(f"  {name:24s} -> {tuple(np.shape(got))!s:18s} "
          f"{'OK' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(f"quickstart: {name} does not match numpy")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    print("== TINA arithmetic functions (paper §3) ==")
    xn = rng.standard_normal((8, 8)).astype(np.float32)
    yn = rng.standard_normal((8, 8)).astype(np.float32)
    x, y = t(xn), t(yn)
    for lowering in ("native", "conv", "kernel"):
        print(f" lowering={lowering}")
        show("elementwise_mult", elementwise_mult(x, y, lowering=lowering),
             xn * yn)
        show("elementwise_add", elementwise_add(x, y, lowering=lowering),
             xn + yn)
        show("matmul", matmul(x, y, lowering=lowering), xn @ yn)
    show("summation", summation(x.reshape(-1)), xn.sum())

    print("== TINA signal functions (paper §4) ==")
    sn = rng.standard_normal((4, 64)).astype(np.float32)
    sig = t(sn)
    show("dft", dft(sig, lowering=LOWERING), np.fft.fft(sn))
    show("idft(dft(x)) == x",
         idft(dft(sig, lowering=LOWERING), lowering=LOWERING).real, sn)
    tn = rng.standard_normal(9).astype(np.float32)
    show("fir", fir(sig, t(tn), lowering=LOWERING),
         np.stack([np.convolve(r, tn, "valid") for r in sn]))
    show("unfold", unfold(sig[0], 6, lowering=LOWERING),
         np.lib.stride_tricks.sliding_window_view(sn[0], 6))

    print("== PFB use case (paper §5.2) ==")
    P, M = 16, 8
    w = t(pfb_window(P, M))
    z = pfb_full(t(rng.standard_normal(P * 64)), w, lowering=LOWERING)
    print(f"  pfb: {P} channels x {z.shape[-2]} frames, dtype={z.dtype}")
    print("quickstart: all mappings verified")


if __name__ == "__main__":
    main()
