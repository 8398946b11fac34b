"""Training launcher, the port of the reference's ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --device cpu --steps 20 --workdir runs/olmo

Defaults run the *reduced* config, so the whole loop (the train step,
checkpoint and resume, straggler detection, the metrics log) runs on
one host; ``--full`` takes the full config on the one card.  The run
resumes from the latest checkpoint in ``--workdir`` when there is one.
On the card unless ``--device cpu``; ``--multi-pod`` (a mesh across
pods) belongs to the multi-device stack, not ported.

``main`` returns the last step's metrics for callers that run it in
process.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get, get_reduced
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--workdir", default="runs/default")
    ap.add_argument("--full", action="store_true",
                    help="the full config, on the one card")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the multi-device stack (mesh, sharded steps) is "
            "not ported yet (ROADMAP.md, item 20)")
    cfg = get(args.arch) if args.full else get_reduced(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, ckpt_every=args.ckpt_every, lr=args.lr,
        microbatch=args.microbatch,
    )
    trainer = Trainer(cfg, tcfg, workdir=args.workdir, device=args.device)
    final = trainer.run()
    print(f"final: {final}")
    return final


if __name__ == "__main__":
    main()
