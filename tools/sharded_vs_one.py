"""How far a sharded train step lies from the one-device step, at each
compute precision, on an NVIDIA card (or the CPU).

One config at its published widths (``--layers`` cuts the depth), one
batch from ``SyntheticDataset(seed=0)``, random weights from
``--seed``: for each ``--dtypes`` entry (parameters and compute in that
dtype, except ``bfloat16``: f32 parameters, bf16 compute), one train
step (no wire) on one device and one on ``--mesh`` logical shards at
``--layout``, from the same weights.  Prints one JSON line a dtype: the
loss, the grad norm, and each step's distance from the one-device step
(loss and grad norm relative, AdamW's first moments of each leaf's
largest), and from the one-device step at the widest dtype given; and
the card's name and power limit as ``nvidia-smi`` gives them.  Where
the sharded and one-device steps agree at float64 but not at float32,
what parts them is the model's own sensitivity to the order of f32
sums, not the sharding.

    python3 tools/sharded_vs_one.py --arch rwkv6_3b --layers 4 \\
        --dtypes float64 float32 bfloat16
    python3 tools/sharded_vs_one.py --arch rwkv6_3b --reduced \\
        --device cpu --seq 32 --dtypes float64 float32
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="2,2", help="data,model")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "sp"])
    ap.add_argument("--dtypes", nargs="+", default=["float32"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU check of the tool)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import get, get_reduced
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import step as step_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as model_lib
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.tree import flatten_with_path, map_tree

    dev = torch.device(args.device)
    base = get_reduced(args.arch) if args.reduced else get(args.arch)
    base = base.scaled(n_layers=args.layers or base.n_layers)
    shape = tuple(int(n) for n in args.mesh.split(","))
    mesh = make_mesh(shape, ("data", "model"), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticDataset(
        base, args.batch, args.seq, seed=0)[0].items()}
    lr = constant(1e-3)
    init = convert.stack_params(model_lib.init_model(
        base, seed=args.seed, device=dev))
    host = map_tree(lambda t: t.to("cpu", copy=True), init)
    del init
    first = None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.type == "cuda" \
        else "cpu"

    def moments(st):
        return {k: v.to("cpu", torch.float64)
                for k, v in flatten_with_path(st) if k.startswith("m/")}

    def dist(a, b):
        (ma, sa), (mb, sb) = a, b
        out = {k: abs(ma[k] - mb[k]) / abs(mb[k]) for k in ("loss",
                                                            "grad_norm")}
        out["first_moment"] = max(float((sa[k] - w).abs().max()
                                        / w.abs().max())
                                  for k, w in sb.items())
        return out

    for dt in args.dtypes:
        pdt = "float32" if dt == "bfloat16" else dt
        cfg = base.scaled(compute_dtype=dt, param_dtype=pdt)
        params = map_tree(lambda t: t.to(dev, getattr(torch, pdt)), host)
        fb = {k: (v.to(getattr(torch, pdt)) if v.is_floating_point()
                  else v) for k, v in batch.items()}
        opt = make_optimizer(cfg, lr)
        one, _ = step_lib.make_train_step(cfg, batch_size=args.batch,
                                          seq_len=args.seq, lr_fn=lr,
                                          grad_wire="none", device=dev,
                                          donate=False)
        _, st, m = one(params, opt.init(params), fb)
        ref = ({k: float(v) for k, v in m.items()}, moments(st))
        del st, one
        fn, specs = step_lib.make_train_step(
            cfg, mesh=mesh, batch_size=args.batch, seq_len=args.seq,
            lr_fn=lr, grad_wire="none", layout=args.layout)
        ps = convert.shard_params(params, mesh, specs.params_sh)
        del params
        _, st, m = fn(ps, [opt.init(p) for p in ps], fb)
        got = ({k: float(v) for k, v in m.items()}, moments(
            convert.unshard(st, mesh, specs.opt_state_sh, device="cpu")))
        del ps, st, fn
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        first = first or ref
        print(json.dumps({
            "arch": cfg.name, "layers": cfg.n_layers, "dtype": dt,
            "mesh": mesh.shape, "layout": args.layout,
            "batch": args.batch, "seq": args.seq, "loss": ref[0]["loss"],
            "grad_norm": ref[0]["grad_norm"],
            "sharded_vs_one_device": dist(got, ref),
            "one_device_vs_" + args.dtypes[0]: dist(ref, first),
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
