"""Serving launcher for the model zoo: batched prefill + lock-step greedy
decode, on the card unless ``--device cpu``; the port of the reference's
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \\
        --batch 4 --steps 32

runs the reduced config; ``--full`` runs the full config on the one
card (the reference's production mesh belongs to the LM's distributed
stack, not yet ported).  Every decoder family serves: the dense
decoders, the MoE ones (kimi-k2, arctic), recurrentgemma, rwkv6 and the
vlm (internvl2, whose prompt is ``num_patches`` patch embeddings then
tokens, ``--prompt-len`` counting both); hubert is encoder-only and
exits, as in the reference.  ``--layers N`` runs the first N layers (the
full MoE configs fit one card only so cut).  The server packs
``--batch`` prompts (``make_batch``), prefills them in one call that
writes the preallocated caches in place, then decodes lock-step.
``--temperature`` is parsed and unused, as in the reference, which
decodes greedily.  ``--lowering`` sets the config's ``tina_lowering``
(default ``kernel``: the hand-written GEMM kernels); the weights are
random, from seed 0, as the reference's ``PRNGKey(0)``.

``main`` returns a summary dict for callers that run it in process.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get, get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import step as step_lib
from repro_torch.models import model as model_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32, help="tokens to decode")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the first N layers (a full MoE config does "
                    "not fit one card: arctic 2, kimi 1)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lowering", default="kernel",
                    choices=["native", "conv", "kernel"])
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get(args.arch) if args.full else get_reduced(args.arch)
    if cfg.family == "audio":
        raise SystemExit("hubert is encoder-only: no decode serving")
    if cfg.family == "vlm" and args.prompt_len <= cfg.num_patches:
        raise SystemExit(f"{cfg.name}: --prompt-len {args.prompt_len} leaves "
                         f"no token after its {cfg.num_patches} patches")
    cfg = cfg.scaled(tina_lowering=args.lowering,
                     n_layers=args.layers or cfg.n_layers)
    dev = resolve_device(args.device)
    max_len = args.prompt_len + args.steps

    prefill = step_lib.make_prefill_step(cfg, batch_size=args.batch,
                                         seq_len=args.prompt_len)
    decode = step_lib.make_decode_step(cfg, batch_size=args.batch,
                                       cache_len=max_len)
    params = model_lib.prepare(
        model_lib.init_model(cfg, seed=0, device=dev), cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_batch(cfg, args.batch, args.prompt_len).items()}
    caches = model_lib.init_caches(cfg, args.batch, max_len, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    # prefill writes into the max_len caches directly
    logits, caches = prefill(params, batch, caches)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        tok, logits, caches = decode(params, tok, caches)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out_tokens, 1).cpu()
    rate = (args.steps - 1) * args.batch / max(t_decode, 1e-9)
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill:.3f}s")
    print(f"decode : {args.steps - 1} steps x {args.batch} seqs in "
          f"{t_decode:.3f}s ({rate:.1f} tok/s)")
    print("generated token ids (first sequence):", gen[0][:16].tolist(),
          "...")
    return {"arch": cfg.name, "full": args.full, "layers": cfg.n_layers,
            "device": str(dev),
            "lowering": cfg.tina_lowering, "batch": args.batch,
            "prompt_len": args.prompt_len, "steps": args.steps,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tokens_per_s": rate, "generated": gen.tolist()}


if __name__ == "__main__":
    main()
