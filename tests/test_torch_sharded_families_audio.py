"""The port's sharded LM steps for hubert (the audio frontend, its conv_pos
halo, the masked-frame loss; prefill alone: an encoder) and olmo_1b's
sequence-parallel train steps, on a (data 4, model 2) mesh of logical
CPU shards, against the reference's sharded steps (in this file's own
subprocess) and the port's one-device steps. The cases, oracle, helpers
and bars are ``tests/test_torch_sharded_families.py``'s.
"""
import pytest

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded_families import (check_serve, check_serve_one_device,
                                         check_train, check_train_one_device,
                                         family_cases, one_thread,
                                         run_oracle, serve_case, train_case)

A = "hubert_xlarge"
TRAIN = family_cases(A) + [train_case(A, "sp"), train_case("olmo_1b", "sp"),
         train_case("olmo_1b", "tp", sp=True)]
SERVE = [serve_case(A, "tp"), serve_case(A, "sp")]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(TRAIN + SERVE, tmp_path_factory.mktemp("jax_audio"))


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_jax_sharded_step(case, oracle):
    check_train(case, oracle)


@pytest.mark.parametrize("case", TRAIN, ids=[c["name"] for c in TRAIN])
def test_train_step_matches_one_device_step(case):
    check_train_one_device(case)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_jax_sharded_steps(case, oracle):
    check_serve(case, oracle)


@pytest.mark.parametrize("case", SERVE, ids=[c["name"] for c in SERVE])
def test_prefill_and_decode_match_one_device_steps(case):
    check_serve_one_device(case)
