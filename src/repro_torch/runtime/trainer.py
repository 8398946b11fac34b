"""Fault-tolerant training loop, the port of the reference's
``repro.runtime.trainer``: on one device, or over a mesh
(``Trainer(..., mesh=)``: the sharded step, its state one tree a mesh
position, checkpoints as global arrays, so a run resumes on any mesh).

Contract:
  * auto-resume: on start, restore the latest complete checkpoint (the
    atomic-rename format guarantees completeness) and continue from its
    step; a run killed at any instant replays to bitwise-identical
    state, because a step's batch is a pure function of the step
    (``SyntheticDataset``) and the step itself draws no random numbers;
  * a checkpoint every ``ckpt_every`` steps and at the end, keep-N
    rotation, the host copy made before the next (in-place) step;
  * straggler detection on the step-time stream (policy: log and
    checkpoint at once);
  * failure injection (``fail_at_step``) for the kill/resume tests;
  * ``metrics.jsonl`` in the workdir, one line a step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.distributed import step as step_lib
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime.straggler import StragglerDetector


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    ckpt_every: int = 50
    keep_n: int = 3
    async_save: bool = True
    log_every: int = 10
    lr: float = 3e-4
    warmup_steps: int = 100
    straggler_threshold: float = 3.0
    fail_at_step: Optional[int] = None    # failure injection (tests)
    microbatch: Optional[int] = None
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *,
                 workdir: str, device=None,
                 log_fn: Callable[[str], None] = print, mesh=None,
                 layout: str = "tp"):
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        self.workdir = workdir
        self.log = log_fn
        os.makedirs(workdir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(workdir, "ckpt"),
                                      keep_n=tcfg.keep_n,
                                      async_save=tcfg.async_save)
        self.lr_fn = warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                   tcfg.total_steps)
        self.step_fn, self.specs = step_lib.make_train_step(
            cfg, batch_size=tcfg.batch_size, seq_len=tcfg.seq_len,
            lr_fn=self.lr_fn, microbatch=tcfg.microbatch,
            device=self.device, mesh=mesh, layout=layout)
        self.detector = StragglerDetector(
            threshold=tcfg.straggler_threshold,
            on_straggler=self._on_straggler)
        self.data = SyntheticDataset(cfg, tcfg.batch_size, tcfg.seq_len,
                                     seed=tcfg.seed)
        self._params = None
        self._opt_state = None
        self._step = 0
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def _on_straggler(self, ev):
        self.log(f"[straggler] step {ev.step}: {ev.step_time:.3f}s = "
                 f"{ev.ratio:.1f}x EMA {ev.ema:.3f}s -> checkpointing")
        if self._params is not None:
            self._save(metadata={"reason": "straggler"})

    def _state_tree(self):
        if self.mesh is None:
            return {"params": self._params, "opt_state": self._opt_state}
        return [{"params": p, "opt_state": o}
                for p, o in zip(self._params, self._opt_state)]

    def _shard_specs(self):
        return {"params": self.specs.params_sh,
                "opt_state": self.specs.opt_state_sh}

    def _save(self, metadata: dict) -> None:
        if self.mesh is None:
            self.ckpt.save(self._step, self._state_tree(),
                           metadata=metadata)
        else:
            self.ckpt.save(self._step, self._state_tree(),
                           metadata=metadata, mesh=self.mesh,
                           specs=self._shard_specs())

    # ------------------------------------------------------------------
    def init_or_restore(self):
        target = {"params": self.specs.params,
                  "opt_state": self.specs.opt_state}
        if self.mesh is None:
            tree, meta = self.ckpt.restore(target, device=self.device)
        else:
            tree, meta = self.ckpt.restore(target, mesh=self.mesh,
                                           specs=self._shard_specs())
        if tree is not None:
            if self.mesh is None:
                self._params = tree["params"]
                self._opt_state = tree["opt_state"]
            else:
                self._params = [t["params"] for t in tree]
                self._opt_state = [t["opt_state"] for t in tree]
            self._step = int(meta["step"])
            self.log(f"[resume] restored step {self._step} from "
                     f"{self.ckpt.path(self._step)}")
            return
        params = convert.stack_params(model_lib.init_model(
            self.cfg, seed=self.tcfg.seed, device=self.device))
        opt = make_optimizer(self.cfg, self.lr_fn)
        if self.mesh is None:
            self._params, self._opt_state = params, opt.init(params)
        else:
            self._params = convert.shard_params(params, self.mesh,
                                                self.specs.params_sh)
            del params
            self._opt_state = [opt.init(p) for p in self._params]
        self._step = 0
        self.log("[init] fresh parameters")

    # ------------------------------------------------------------------
    def run(self) -> dict:
        if self._params is None:
            self.init_or_restore()
        t = self.tcfg
        while self._step < t.total_steps:
            if t.fail_at_step is not None and self._step == t.fail_at_step:
                raise RuntimeError(f"injected failure at step {self._step}")
            batch = {k: torch.from_numpy(v) for k, v in
                     self.data[self._step].items()}
            if self.mesh is None:
                batch = {k: v.to(self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            self._params, self._opt_state, metrics = self.step_fn(
                self._params, self._opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._step += 1
            self.detector.record(self._step, dt)
            metrics.update(step=self._step, step_time=dt)
            self.metrics_log.append(metrics)
            if self._step % t.log_every == 0 or self._step == t.total_steps:
                self.log(f"[step {self._step:6d}] loss={metrics['loss']:.4f} "
                         f"gnorm={metrics['grad_norm']:.3f} {dt:.3f}s")
            if self._step % t.ckpt_every == 0 or self._step == t.total_steps:
                self._save(metadata={"loss": metrics["loss"]})
        self.ckpt.wait()
        with open(os.path.join(self.workdir, "metrics.jsonl"), "w") as f:
            for m in self.metrics_log:
                f.write(json.dumps(m) + "\n")
        return self.metrics_log[-1] if self.metrics_log else {}

    # convenience for tests --------------------------------------------------
    @property
    def params(self):
        """The parameters (one tree a mesh position over a mesh)."""
        return self._params

    @property
    def step(self):
        return self._step


def run_with_auto_restart(make_trainer: Callable[[], Trainer], *,
                          max_restarts: int = 3) -> dict:
    """Supervisor: restart the training loop on failure; each restart
    resumes from the latest complete checkpoint (the fault-tolerance
    loop a cluster scheduler would drive)."""
    last = {}
    for attempt in range(max_restarts + 1):
        tr = make_trainer()
        try:
            last = tr.run()
            return last
        except RuntimeError as e:
            tr.log(f"[restart {attempt + 1}/{max_restarts}] {e}")
            if attempt == max_restarts:
                raise
    return last


__all__ = ["TrainerConfig", "Trainer", "run_with_auto_restart"]
