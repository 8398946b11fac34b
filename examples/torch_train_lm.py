"""End-to-end training on PyTorch: train a small LM for a few
hundred steps with the port's training stack (the train step,
checkpointing, resume, straggler detection, metrics log) on one device;
the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py                 # card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

Presets:
  tiny — 4L/256d  (~6M params)  default
  100m — 12L/768d (~100M params) the assignment's reference size

The same Trainer runs the full configs on the card via
``python -m repro_torch.launch.train --arch <id> --full``.
"""
import argparse

from repro_torch.configs import get
from repro_torch.runtime.trainer import Trainer, TrainerConfig

PRESETS = {
    "tiny": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                 d_ff=1024, vocab_size=8192, head_dim=64),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 d_ff=3072, vocab_size=32768, head_dim=64),
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_train_lm")
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get("olmo_1b").scaled(**PRESETS[args.preset],
                                remat=False, compute_dtype="float32")
    tcfg = TrainerConfig(total_steps=args.steps, batch_size=args.batch_size,
                         seq_len=args.seq_len, ckpt_every=100,
                         log_every=20, lr=1e-3, warmup_steps=50)
    workdir = args.workdir or f"runs/train_lm_{args.preset}"
    tr = Trainer(cfg, tcfg, workdir=workdir, device=args.device)
    final = tr.run()
    print(f"\ntrained {args.preset} for {args.steps} steps: "
          f"final loss {final['loss']:.4f} "
          f"(metrics in {workdir}/metrics.jsonl)")


if __name__ == "__main__":
    main()
