"""The port's sharded LM steps for rwkv6 (its time and channel mix, the WKV
state per head), on a (data 4, model 2) mesh of logical CPU shards,
against the reference's sharded steps (in this file's own subprocess)
and the port's one-device steps. The cases, oracle, helpers and bars are
``tests/test_torch_sharded_families.py``'s.
"""
import pytest

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded_families import (check_serve, check_serve_one_device,
                                         check_train, check_train_one_device,
                                         one_thread, run_oracle, serve_case,
                                         train_case)

A = "rwkv6_3b"
# at no wire in float64: rwkv6's f32 step moves by ~1e-4 under any
# reordering of its linears' sums (the reference's own one-device and
# fsdp steps differ by 1.08e-4 in the grad norm, 1.69e-4 of a leaf's
# largest in the first moment), above the bars; in float64 the sharding's
# arithmetic is held to them (ROADMAP.md queue 3)
TRAIN = [train_case(A, "tp", "bf16"), train_case(A, "fsdp", f64=True),
         train_case(A, "sp", f64=True)]
ONE_DEVICE = [train_case(A, layout, f64=True) for layout in ("tp", "fsdp",
                                                             "sp")]
SERVE = [serve_case(A, "tp"), serve_case(A, "sp")]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(TRAIN + SERVE, tmp_path_factory.mktemp("jax_rwkv"))


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_jax_sharded_step(case, oracle):
    check_train(case, oracle)


@pytest.mark.parametrize("case", ONE_DEVICE,
                         ids=[c["name"] for c in ONE_DEVICE])
def test_train_step_matches_one_device_step(case):
    check_train_one_device(case)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_jax_sharded_steps(case, oracle):
    check_serve(case, oracle)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_one_device_steps(case):
    check_serve_one_device(case)
