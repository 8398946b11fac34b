"""Paper §5.2 use case feeding a real model, on PyTorch: a TINA PFB
channelizer produces spectral frame features for a HuBERT-style encoder,
which then runs one masked-prediction training step; the twin of
``examples/pfb_features.py``.

    PYTHONPATH=src python examples/torch_pfb_features.py               # card
    PYTHONPATH=src python examples/torch_pfb_features.py --device cpu

Raw signal -> polyphase filter bank (TINA standard-conv + pointwise-conv
mapping; the ``kernel`` lowering, so the hand-written PFB kernel) ->
log-magnitude spectrogram -> transformer encoder, end to end on one
device.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core import pfb_full, pfb_window
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw, constant

LOWERING = "kernel"   # the PFB's

def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_pfb_features")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- 1. synthesize a multi-tone signal batch ----------------------------
    P_BRANCH, N_TAPS = 64, 8                       # 64 freq channels
    B, N_FRAMES = 2, 256
    n_samples = P_BRANCH * (N_FRAMES + N_TAPS - 1)
    t = np.arange(n_samples)
    sig = sum(np.sin(2 * np.pi * f * t + p)
              for f, p in [(0.031, 0.0), (0.125, 1.0), (0.307, 2.0)])
    sig = torch.as_tensor(sig + 0.1 * rng.standard_normal((B, n_samples)),
                          dtype=torch.float32, device=dev)

    # --- 2. TINA PFB channelizer (the paper's use case) ---------------------
    taps = torch.as_tensor(pfb_window(P_BRANCH, N_TAPS), dtype=torch.float32,
                           device=dev)
    spectra = pfb_full(sig, taps, lowering=LOWERING)  # (B, frames, P)
    logmag = torch.log1p(spectra.abs()).float()
    print(f"PFB channelizer: {tuple(sig.shape)} samples -> "
          f"{tuple(logmag.shape)} (frames x channels)")

    # --- 3. encoder consumes PFB features (frame features = 512-d stub) -----
    cfg = get_reduced("hubert_xlarge")
    feat_dim = M.AUDIO_FEAT_DIM
    reps = int(np.ceil(feat_dim / P_BRANCH))
    frames = logmag.repeat(1, 1, reps)[..., :feat_dim].contiguous()

    params = convert.stack_params(M.init_model(cfg, seed=0, device=dev))
    targets = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           frames.shape[:2]),
                              dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.random(frames.shape[:2]) < 0.3, device=dev)
    batch = {"frames": frames, "targets": targets, "mask": mask}

    with torch.no_grad():
        loss, metrics = M.loss_fn(convert.unstack_views(params), batch, cfg)
    print(f"masked-prediction loss over PFB features: {float(loss):.4f} "
          f"({int(metrics['tokens'])} masked frames)")

    # --- 4. one training step -------------------------------------------------
    opt = adamw(constant(1e-3))
    state = opt.init(params)
    loss1, _, grads = step_lib.value_and_grad(params, batch, cfg)
    params, state = opt.update(grads, state, params)
    with torch.no_grad():
        loss2, _ = M.loss_fn(convert.unstack_views(params), batch, cfg)
    print(f"one step: {float(loss1):.4f} -> {float(loss2):.4f} (decreased: "
          f"{bool(loss2 < loss1)})")


if __name__ == "__main__":
    main()
