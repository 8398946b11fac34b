"""The port's sharded train step on (data 2, model 4), with the case whose 2 KV heads are replicated over
4-way tensor parallelism,
against the reference's sharded ``make_train_step`` on 8 forced host
devices with ``Auto`` mesh axes (in a subprocess of this file's own).
The cases, weights, helpers and bars are ``tests/test_torch_sharded.py``'s;
its (4, 2) cases run there, each mesh's oracle in its own file so that
the three subprocesses run apart.
"""
import pytest

# one_thread: the autouse fixture, imported so that it runs here too
from test_torch_sharded import (cases_on, check_case, load_weights,
                                one_thread, run_oracle)

CASES = cases_on((2, 4))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(CASES, tmp_path_factory.mktemp("jax_sharded"))


@pytest.fixture(scope="module")
def weights():
    return load_weights()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_train_step_matches_jax_sharded_step(case, oracle, weights):
    check_case(case, oracle, weights)
