"""The port's logical-axis rules and sharding specs
(``repro_torch.partitioning``, ``repro_torch.distributed.sharding``)
against the reference's: the rule tests of ``tests/test_distributed.py``,
then every parameter, optimizer-state, batch and cache spec of the ten
full configs, leaf for leaf, at the production mesh shapes.

The reference's specs are computed on ``jax.sharding.AbstractMesh``
(no devices); the port's read only the mesh's axis sizes.  The port
keeps one cache per repeat of the stack (``stack/<r>/sub0/k``, batch
first), the reference one stacked leaf (``stack/sub0/k``, its repeat
axis first): a port cache spec equals the reference's without that
leading entry.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro import optim as jopt
from repro.data import pipeline as jdata
from repro.distributed import sharding as jsh
from repro.models import model as jmodel
from repro.partitioning import default_rules as jrules
from repro.partitioning import logical_to_spec as jlogical
from repro_torch import configs as tconfigs
from repro_torch import optim as topt
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import step as step_lib
from repro_torch.models import model as tmodel
from repro_torch.partitioning import (P, axis_rules, constrain,
                                      current_rules, default_rules,
                                      logical_to_spec)
from repro_torch.tree import flatten_with_path

ARCHS = tconfigs.ARCHS
LAYOUTS = ("tp", "fsdp", "sp")
# (mesh shape, axes, multi_pod): a pod of 16 x 16 and two of them
MESHES = [((16, 16), ("data", "model"), False),
          ((2, 16, 16), ("pod", "data", "model"), False),
          ((2, 16, 16), ("pod", "data", "model"), True)]
RULESETS = [(m, layout, fsdp) for m in MESHES for layout in LAYOUTS
            for fsdp in (False, True)]
BATCH, SEQ, CACHE = 32, 4096, 2048


# ---------------------------------------------------------------------------
# the rule tests (tests/test_distributed.py:39-64), on the port
# ---------------------------------------------------------------------------
def test_param_spec_rules():
    rules = default_rules(multi_pod=True, fsdp=True)
    assert tsh.spec_for("embed/table", 2, rules) == P("model", "data")
    assert tsh.spec_for("stack/sub0/attn/wq/w", 3, rules) == \
        P(None, "data", "model")
    assert tsh.spec_for("stack/sub0/attn/wo/w", 3, rules) == \
        P(None, "model", "data")
    assert tsh.spec_for("stack/sub0/ffn/w_up", 4, rules) == \
        P(None, "model", "data", None)
    assert tsh.spec_for("stack/sub0/ffn/router/w", 3, rules) == \
        P(None, None, None)
    assert tsh.spec_for("stack/sub0/ln1/scale", 2, rules) == P(None, None)
    rules2 = default_rules(fsdp=False)
    assert tsh.spec_for("stack/sub0/attn/wq/w", 3, rules2) == \
        P(None, None, "model")


def test_constrain_noop_outside_context():
    x = torch.ones((2, 3))
    assert current_rules() is None
    assert constrain(x, ("batch", None, "tp")) is x


def test_constrain_inside_context_checks_rank():
    x = torch.ones((2, 3))
    with axis_rules(default_rules()):
        assert current_rules()["tp"] == "model"
        assert constrain(x, ("batch", "tp")) is x
        with pytest.raises(ValueError, match="axes"):
            constrain(x, ("batch", None, "tp"))
    assert current_rules() is None


def test_sequence_parallel_rule():
    rules = default_rules(sequence_parallel=True)
    assert logical_to_spec(("batch", "seq", "embed"), rules) == \
        P(("data",), "model", None)


@pytest.mark.parametrize("layout", LAYOUTS + ("dp",))
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sp", [False, True])
def test_rules_and_specs_equal_reference(layout, multi_pod, fsdp, sp):
    kw = dict(multi_pod=multi_pod, fsdp=fsdp, sequence_parallel=sp,
              layout=layout)
    if layout == "dp":
        with pytest.raises(ValueError, match="layout"):
            default_rules(**kw)
        return
    rules = default_rules(**kw)
    assert rules == jrules(**kw)
    for logical in [("batch", "seq", "embed"), ("vocab", "fsdp"),
                    (None, "expert", "tp"), ()]:
        assert tuple(logical_to_spec(logical, rules)) == \
            tuple(jlogical(logical, rules))


# ---------------------------------------------------------------------------
# the sweep: every spec of the ten full configs against the reference's
# ---------------------------------------------------------------------------
def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.spec) for path, v in flat}


def _tflat(tree) -> dict:
    return {k: tuple(v) for k, v in flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))}


@functools.lru_cache(maxsize=None)
def _trees(arch: str) -> dict:
    """{kind: (reference shape tree, port tree)} for one full config:
    parameters, AdamW and Adafactor state, a batch, decode caches."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jp = jax.eval_shape(lambda: jmodel.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    tp = step_lib.param_specs(tcfg)
    lr = 3e-4
    out = {"params": (jp, tp)}
    for name in ("adamw", "adafactor"):
        jo = getattr(jopt, name)(jopt.constant(lr))
        to = getattr(topt, name)(topt.constant(lr))
        out[name] = (jax.eval_shape(jo.init, jp), to.init(tp))
    out["batch"] = (jdata.input_specs(jcfg, BATCH, SEQ),
                    tdata.input_specs(tcfg, BATCH, SEQ))
    out["caches"] = (jax.eval_shape(lambda: jmodel.init_caches(jcfg, BATCH,
                                                               CACHE)),
                     tmodel.init_caches(tcfg, BATCH, CACHE, device="meta"))
    return out


def _specs(kind, arch, jtree, ttree, mesh_shape, axes, rules):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    mesh = AbstractMesh(mesh_shape, axes)
    sizes = dict(zip(axes, mesh_shape))
    if kind == "params":
        return (_jflat(jsh.param_shardings(jtree, jcfg, mesh, rules)),
                _tflat(tsh.param_shardings(ttree, tcfg, sizes, rules)))
    if kind in ("adamw", "adafactor"):
        return (_jflat(jsh.opt_state_shardings(jtree, jcfg, mesh, rules)),
                _tflat(tsh.opt_state_shardings(ttree, tcfg, sizes, rules)))
    if kind == "batch":
        return (_jflat(jsh.batch_shardings(jtree, mesh, rules)),
                _tflat(tsh.batch_shardings(ttree, sizes, rules)))
    j = _jflat(jsh.cache_shardings(jtree, jcfg, mesh, rules))
    t = _tflat(tsh.cache_shardings(ttree, tcfg, sizes, rules))
    # the port's stack/<r>/<sub>/<leaf> against the reference's stacked
    # stack/<sub>/<leaf> without its leading (repeat) entry
    folded = {}
    for key, spec in t.items():
        parts = key.split("/")
        if parts[0] == "stack":
            key = "/".join([parts[0]] + parts[2:])
        assert folded.setdefault(key, spec) == spec, key
    want = {k: (v[1:] if k.startswith("stack/") else v) for k, v in j.items()}
    return want, folded


@pytest.mark.parametrize("kind", ["params", "adamw", "adafactor", "batch",
                                  "caches"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, kind):
    """Leaf for leaf, on meshes (16, 16) and (2, 16, 16), multi_pod on
    and off, fsdp on and off, every layout."""
    jtree, ttree = _trees(arch)[kind]
    for (shape, axes, multi_pod), layout, fsdp in RULESETS:
        rules = jrules(multi_pod=multi_pod, fsdp=fsdp, layout=layout)
        want, got = _specs(kind, arch, jtree, ttree, shape, axes, rules)
        assert got == want, (shape, layout, fsdp, multi_pod)
    assert len(got) > 0


def test_specs_shard_something_and_read_only_sizes():
    """The sweep is not vacuous: qwen2's qkv shards over the model axis,
    and a BatchMesh's ``shape`` serves as the mesh."""
    from repro_torch.launch.mesh import BatchMesh
    rules = default_rules(fsdp=True)
    specs = dict(flatten_with_path(tsh.param_shardings(
        step_lib.param_specs(tconfigs.get("qwen2_7b")),
        tconfigs.get("qwen2_7b"), {"data": 16, "model": 16}, rules),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert specs["stack/sub0/attn/wq/w"] == P(None, "data", "model")
    assert specs["stack/sub0/attn/wq/b"] == P(None, "model")
    mesh = BatchMesh(("cpu",) * 4, axis="data")
    b = tsh.batch_shardings(tdata.input_specs(tconfigs.get("olmo_1b"), 8,
                                              16), mesh,
                            default_rules())
    assert b == {"tokens": P("data", None)}
    odd = tsh.batch_shardings({"tokens": torch.empty((6, 16), device="meta")},
                              mesh, default_rules())
    assert odd == {"tokens": P(None, None)}
