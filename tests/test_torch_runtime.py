"""The port's training runtime (``repro_torch.runtime``) and train
launcher on the CPU: the twins of ``tests/test_runtime.py``'s tests.

The reference's own kill/resume and auto-restart tests fail on this JAX
(its train step raises under ``make_local_mesh``), so the port holds
that contract alone: a run killed after a checkpoint and resumed ends
with the parameters of an uninterrupted run, bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import train as train_launch
from repro_torch.runtime import (StragglerDetector, Trainer, TrainerConfig,
                                 run_with_auto_restart)
from repro_torch.tree import leaves


def _mk(workdir, **over):
    cfg = get_reduced("olmo_1b").scaled(n_layers=2, remat=False)
    tc = dict(total_steps=6, batch_size=2, seq_len=16, ckpt_every=2,
              log_every=100, async_save=False)
    tc.update(over)
    return Trainer(cfg, TrainerConfig(**tc), workdir=str(workdir),
                   device="cpu", log_fn=lambda s: None)


def _params_flat(tr):
    return np.concatenate([x.detach().float().numpy().ravel()
                           for x in leaves(tr.params)])


def test_kill_resume_bitwise_identical(tmp_path):
    t_ref = _mk(tmp_path / "ref")
    t_ref.run()
    ref = _params_flat(t_ref)
    # killed at step 5 (after the step-4 checkpoint), then resumed
    with pytest.raises(RuntimeError):
        _mk(tmp_path / "killed", fail_at_step=5).run()
    resumed = _mk(tmp_path / "killed")
    resumed.run()
    assert resumed.step == 6
    np.testing.assert_array_equal(_params_flat(resumed), ref)
    # the optimizer state too, and the metrics of the steps both ran
    for a, b in zip(leaves(resumed._opt_state), leaves(t_ref._opt_state)):
        assert torch.equal(a, b)
    assert resumed.metrics_log[-1]["loss"] == t_ref.metrics_log[-1]["loss"]


def test_kill_resume_async_save_bitwise(tmp_path):
    """The same with async saves (the default): the host copy made
    before the next in-place step keeps every checkpoint whole."""
    t_ref = _mk(tmp_path / "ref", async_save=True)
    t_ref.run()
    with pytest.raises(RuntimeError):
        _mk(tmp_path / "killed", async_save=True, fail_at_step=3).run()
    resumed = _mk(tmp_path / "killed", async_save=True)
    resumed.run()
    np.testing.assert_array_equal(_params_flat(resumed), _params_flat(t_ref))


def test_auto_restart_supervisor(tmp_path):
    calls = {"n": 0}

    def make():
        calls["n"] += 1
        # first attempt fails at step 3; the retry has no injection
        return _mk(tmp_path / "sup",
                   fail_at_step=3 if calls["n"] == 1 else None)

    final = run_with_auto_restart(make, max_restarts=2)
    assert calls["n"] == 2
    assert final["step"] == 6
    ref = _mk(tmp_path / "ref")
    ref.run()
    tr = make()
    tr.init_or_restore()
    assert tr.step == 6
    np.testing.assert_array_equal(_params_flat(tr), _params_flat(ref))


def test_straggler_detector_flags_slow_step():
    det = StragglerDetector(threshold=2.0, warmup_steps=2)
    for i in range(8):
        det.record(i, 1.0)
    ev = det.record(9, 5.0)
    assert ev is not None and ev.ratio > 2.0
    assert det.record(10, 1.0) is None          # EMA not poisoned
    assert len(det.events) == 1


def test_straggler_triggers_checkpoint(tmp_path):
    tr = _mk(tmp_path / "s", total_steps=3, straggler_threshold=2.0)
    tr.init_or_restore()
    tr.detector.warmup = 0
    for i in range(4):
        tr.detector.record(i, 0.1)
    tr._step = 1
    tr.detector.record(5, 10.0)                 # fires _on_straggler
    assert tr.ckpt.latest_step() == 1


def test_trainer_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_reduced("olmo_1b")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig(), workdir=str(tmp_path))


def test_train_launcher_cpu(tmp_path, capsys):
    """``launch.train.main`` on a reduced arch: a metrics line a step,
    checkpoints at the cadence and the end, and a resume that continues
    from the last one."""
    wd = str(tmp_path / "run")

    def argv(steps):
        return ["--arch", "olmo_1b", "--device", "cpu", "--steps",
                str(steps), "--batch-size", "2", "--seq-len", "16",
                "--ckpt-every", "2", "--workdir", wd]

    final = train_launch.main(argv(4))
    assert final["step"] == 4 and np.isfinite(final["loss"])
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [m["step"] for m in lines] == [1, 2, 3, 4]
    assert sorted(os.listdir(os.path.join(wd, "ckpt"))) == ["ckpt_2",
                                                           "ckpt_4"]
    assert "final:" in capsys.readouterr().out
    # more steps in the same workdir resume from step 4
    final = train_launch.main(argv(6))
    assert final["step"] == 6
    assert "[resume] restored step 4" in capsys.readouterr().out
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [5, 6]
    # --multi-pod over distinct cards this host cannot see is refused
    # (512 logical CPU shards: tests/test_torch_dryrun_mesh.py)
    with pytest.raises(ValueError, match="needs 512 cards"):
        train_launch.main(argv(4) + ["--multi-pod", "--device", "cuda"])
