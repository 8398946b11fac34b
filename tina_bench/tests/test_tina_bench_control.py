"""The controls on the card, at a size a test run holds: the program at
the configuration's f32 reads correct, and the reference one step down
(its DFT in one TF32 pass) and the program's own bf16 tier both fail the
configuration's limit.  Skips without a card.

    python -m pytest -q -m cuda tina_bench/tests/test_tina_bench_control.py
"""
import json

import pytest

CARD_CONFIGS = {
    "lofar_station_pfb": dict(n_branches=1024, n_taps=16, window="hamming"),
    "chime_fengine_pfb": dict(n_branches=2048, n_taps=4, window="hann"),
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _run(repo, card, seed, **kw):
    import time

    from harness import cell as cell_lib
    from harness import session
    cell = cell_lib.load(repo, repo / "tina_bench", "tiny.stream_closed")
    return session.run(cell, seed, 1.0, False, card, time.perf_counter(),
                       **kw)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_controls_fail_on_the_card(tiny_repo, card, name):
    from conftest import REPO
    real = json.loads((REPO / f"tina_bench/configs/{name}.json").read_text())
    cfg = dict(real, name="tiny_pfb", signals=8)
    path = tiny_repo / "tina_bench/configs/tiny_pfb.json"
    path.write_text(json.dumps(cfg))
    t = json.loads((tiny_repo / "tina_bench/traffic/stream_closed.json")
                   .read_text())
    t.update(chunk_len=2 ** 17, pool_chunks=3)
    (tiny_repo / "tina_bench/traffic/stream_closed.json").write_text(
        json.dumps(t))
    import torch
    from reference import pfb_power as ref
    taps = torch.from_numpy(ref.taps(cfg["n_branches"], cfg["n_taps"],
                                     cfg["window"]))
    for seed in (11, 2 ** 31 + 7, 99991):
        r = _run(tiny_repo, card, seed, controls={
            "tf32": lambda x, call, out: ref.power_tf32(x, taps)})
        assert r["correct"], r["checks"]
        assert r["controls"]["tf32"] > cfg["limits"]["power_gap"]
    path.write_text(json.dumps(dict(cfg, precision="bf16")))
    for seed in (12, 13, 14):
        assert not _run(tiny_repo, card, seed)["correct"]
