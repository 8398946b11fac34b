"""Batched serving example on PyTorch: prefill a batch of prompts, then
decode tokens lock-step with caches written in place — the port's
serving path (``repro_torch.launch.serve``) on a reduced model, the twin
of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch olmo_1b
    PYTHONPATH=src python examples/torch_serve_batched.py --arch rwkv6_3b
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

On the card by default, at the ``kernel`` lowering in bf16 compute (the
full configs' dtype), so every linear runs the hand-written bf16 GEMM:
the path the port serves on (the other lowerings and dtypes are the
tests' to cover).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as M

LOWERING, COMPUTE_DTYPE = "kernel", "bfloat16"

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_serve_batched")
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch).scaled(tina_lowering=LOWERING,
                                        compute_dtype=COMPUTE_DTYPE)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch: no decode")
    dev = resolve_device(args.device)
    max_len = args.prompt_len + args.new_tokens
    params = M.prepare(M.init_model(cfg, seed=0, device=dev), cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_batch(cfg, args.batch, args.prompt_len).items()}

    with torch.no_grad():
        # prefill
        caches = M.init_caches(cfg, args.batch, max_len, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches, _ = M.forward(params, batch, cfg, caches=caches,
                                      remat=False)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        # decode: the caches are written in place
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            lg, caches = M.decode_step(params, tok, caches, cfg)
            tok = torch.argmax(lg, -1).to(torch.int32)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    gen = torch.stack(out, 1).cpu().numpy()
    if not np.all((gen >= 0) & (gen < cfg.vocab_size)):
        raise SystemExit("decode produced token ids outside the vocabulary")
    tps = args.batch * (args.new_tokens - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name}  prefill {args.batch}x{args.prompt_len}: "
          f"{t_prefill * 1e3:.1f} ms")
    print(f"decode {args.new_tokens - 1} steps: {t_decode * 1e3:.1f} ms "
          f"({tps:.0f} tok/s on {dev.type}, {cfg.tina_lowering} lowering, "
          f"{cfg.compute_dtype})")
    print("sample generations (token ids):")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {gen[b][:12].tolist()} ...")


if __name__ == "__main__":
    main()
