"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` has to come out false for each
fault a channelizer cell can have, and for the controls (the program's
bf16 tier, the reference at one TF32 pass).  The sound run reads true."""
import json

import pytest
import torch
from conftest import TINY_CONFIG, run_cpu

CELLS = ["tiny.stream_closed", "tiny.stream_open", "tiny.offline_closed"]


def _wrap(fault):
    def hook(entry):
        submit = entry.submit
        state = {}

        def broken(k):
            out, call = submit(k)
            return fault(out, state), call
        entry.submit = broken
    return hook


def altered(out, state):
    """One answer a call changed where it is produced: a row's strongest
    channel 1e-4 high."""
    out = out.clone()
    row = out[0].view(-1)
    row[row.argmax()] *= 1.0001
    return out


def stale(out, state):
    """A step that returns its state unchanged: each call hands back the
    previous call's output."""
    prev = state.get("prev", out)
    state["prev"] = out
    return prev


def half_batch(out, state):
    """Half of the signals left out, the other half standing in."""
    out = out.clone()
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half]
    return out


def drop_carry(entry):
    """The carry dropped between pushes: each push starts afresh."""
    if entry.kind != "stream":
        pytest.skip("no carry outside a stream")
    push = entry.runner.push

    def fresh(chunk, **kw):
        entry.runner._carry = None
        return push(chunk, **kw)
    entry.runner.push = fresh


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_repo, cell):
    r = run_cpu(tiny_repo, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered, stale, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_reads_incorrect(tiny_repo, cell, fault):
    r = run_cpu(tiny_repo, cell, entry_hook=_wrap(fault))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_dropped_carry_reads_incorrect(tiny_repo, cell):
    r = run_cpu(tiny_repo, cell, entry_hook=drop_carry)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_tier_reads_incorrect(tiny_repo, cell):
    cfg = dict(TINY_CONFIG, precision="bf16")
    (tiny_repo / "tina_bench/configs/tiny_pfb.json").write_text(
        json.dumps(cfg))
    r = run_cpu(tiny_repo, cell)
    assert r["checks"]["off_config"]["value"] == 0
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_the_limit(tiny_repo, cell):
    from reference import pfb_power as ref
    taps = torch.from_numpy(ref.taps(16, 4, "hamming"))
    r = run_cpu(tiny_repo, cell, controls={
        "tf32": lambda x, call, out: ref.power_tf32(x, taps)})
    assert r["correct"]
    assert r["controls"]["tf32"] > r["checks"]["power_gap"]["limit"]
