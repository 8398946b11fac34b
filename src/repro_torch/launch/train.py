"""Training launcher, the port of the reference's ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --device cpu --steps 20 --workdir runs/olmo

Defaults run the *reduced* config, so the whole loop (the train step,
checkpoint and resume, straggler detection, the metrics log) runs on
one host; ``--full`` takes the full config.  The run resumes from the
latest checkpoint in ``--workdir`` when there is one.  On the card
unless ``--device cpu``.

``--mesh 4,2`` (data, model) or ``--mesh 2,2,2`` (pod, data, model)
runs the sharded step of any arch (``--layout tp|fsdp|sp``; ``sp``
splits the sequence over ``model``): over distinct cards for
``--device cuda``, over logical shards of one device for ``--device
cpu`` or an indexed card (``--device cuda:0``).  ``--multi-pod`` takes
the reference's (2, 16, 16) production mesh: 512 distinct cards on
``--device cuda`` (fewer raise ValueError, naming the count visible), or
512 logical shards of ``--device cpu`` or of an indexed card.

``main`` returns the last step's metrics for callers that run it in
process.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get, get_reduced
from repro_torch.launch.mesh import mesh_from_args
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod 2, data 16, model 16) production mesh")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="data,model or pod,data,model sizes")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "sp"])
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    mesh = mesh_from_args(args.mesh, args.device, multi_pod=args.multi_pod)
    cfg = get(args.arch) if args.full else get_reduced(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, ckpt_every=args.ckpt_every, lr=args.lr,
        microbatch=args.microbatch,
    )
    trainer = Trainer(cfg, tcfg, workdir=args.workdir, device=args.device,
                      mesh=mesh, layout=args.layout)
    final = trainer.run()
    print(f"final: {final}")
    return final


if __name__ == "__main__":
    main()
