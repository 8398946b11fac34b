"""The port's optimizers, schedules, clipping and gradient compression
(``repro_torch.optim``) against the JAX package's (``repro.optim``).

The twins of ``tests/test_optim.py``'s ten tests, each also held against
the JAX function on the same seeded numpy inputs, and both optimizers
over three updates of a tree in the training layout, whose stacked
``(reps, d)`` leaf AdamW decays and Adafactor factors, as the reference
does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import compress as jcompress
from repro_torch import optim as topt
from repro_torch.optim import compress as tcompress
from repro_torch.tree import flatten_with_path

RTOL = 1e-6     # f32 elementwise updates, FMA contraction on either side


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree):
    return dict(flatten_with_path(tree))


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def _close_trees(got, want, rtol, what):
    g, w = _flat(got), _jflat(want)
    assert set(g) == set(w), (what, sorted(g), sorted(w))
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=rtol,
                                   atol=rtol * np.abs(_np(w[k])).max(),
                                   err_msg=f"{what} {k}")


def _grads(loss, params):
    """(loss, grads) of ``loss(params)`` by autograd, params untouched."""
    q = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        out = loss(q)
        gs = torch.autograd.grad(out, list(q.values()))
    return out.detach(), dict(zip(q, gs))


def test_adamw_matches_reference_math():
    """One update == hand-computed Adam with decoupled decay == JAX's."""
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.95, 1e-8, 0.1
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=wd)
    opt = topt.adamw(topt.constant(lr), **kw)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.25]])}
    st = opt.init(p)
    p2, st2 = opt.update(g, st, p)
    m = (1 - b1) * np.array([[0.5, 0.25]])
    v = (1 - b2) * np.array([[0.25, 0.0625]])
    mhat, vhat = m / (1 - b1), v / (1 - b2)
    want = np.array([[1.0, -2.0]]) - lr * (
        mhat / (np.sqrt(vhat) + eps) + wd * np.array([[1.0, -2.0]]))
    np.testing.assert_allclose(_np(p2["w"]), want, rtol=1e-6)
    assert int(st2["count"]) == 1 and st2["count"].dtype == torch.int32
    jo = jopt.adamw(jopt.constant(lr), **kw)
    jp = {"w": jnp.asarray([[1.0, -2.0]])}
    jp2, jst2 = jo.update({"w": jnp.asarray([[0.5, 0.25]])}, jo.init(jp), jp)
    np.testing.assert_allclose(_np(p2["w"]), _np(jp2["w"]), rtol=RTOL)
    _close_trees(st2["m"], jst2["m"], RTOL, "m")
    _close_trees(st2["v"], jst2["v"], RTOL, "v")


def test_adamw_no_decay_on_1d():
    opt = topt.adamw(topt.constant(0.1), weight_decay=1.0)
    p = {"b": torch.tensor([1.0, 1.0])}
    g = {"b": torch.tensor([0.0, 0.0])}
    p2, _ = opt.update(g, opt.init(p), p)
    np.testing.assert_allclose(_np(p2["b"]), [1.0, 1.0])
    jo = jopt.adamw(jopt.constant(0.1), weight_decay=1.0)
    jp = {"b": jnp.asarray([1.0, 1.0])}
    jp2, _ = jo.update({"b": jnp.zeros(2)}, jo.init(jp), jp)
    np.testing.assert_array_equal(_np(p2["b"]), _np(jp2["b"]))


def _loss_t(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["u"] + 1.0) ** 2)


def _loss_j(p):
    return jnp.sum((p["w"] - 3.0) ** 2) + jnp.sum((p["u"] + 1.0) ** 2)


def _rosenbrock_ish(topt_, jopt_, steps=600, early=20):
    """Both packages' optimizers on the same problem: (port's final loss,
    JAX's final loss, and each one's params after ``early`` steps: near
    the optimum a constant step makes the last bits chaotic, so the
    trajectories are held to each other before it)."""
    p = {"w": torch.zeros((4, 4)), "u": torch.zeros((5,))}
    st = topt_.init(p)
    jp = {"w": jnp.zeros((4, 4)), "u": jnp.zeros((5,))}
    jst = jopt_.init(jp)
    step = jax.jit(lambda q, s: jopt_.update(jax.grad(_loss_j)(q), s, q))
    for i in range(steps):
        _, g = _grads(_loss_t, p)
        p, st = topt_.update(g, st, p)
        jp, jst = step(jp, jst)
        if i + 1 == early:
            at = ({k: v.clone() for k, v in p.items()}, jp)
    return float(_loss_t(p)), float(_loss_j(jp)), *at


def test_adamw_converges():
    lt, lj, p, jp = _rosenbrock_ish(
        topt.adamw(topt.constant(0.05), weight_decay=0.0),
        jopt.adamw(jopt.constant(0.05), weight_decay=0.0))
    assert lt < 1e-2 and lj < 1e-2, (lt, lj)
    for k in p:
        np.testing.assert_allclose(_np(p[k]), _np(jp[k]), rtol=1e-5)


def test_adafactor_converges():
    # RMS-clipped updates step ~lr each iteration: a decaying schedule
    lt, lj, p, jp = _rosenbrock_ish(
        topt.adafactor(topt.cosine_decay(0.5, 600, min_ratio=1e-3)),
        jopt.adafactor(jopt.cosine_decay(0.5, 600, min_ratio=1e-3)))
    assert lt < 1e-2 and lj < 1e-2, (lt, lj)
    for k in p:
        np.testing.assert_allclose(_np(p[k]), _np(jp[k]), rtol=1e-5)


def test_adafactor_state_is_factored():
    opt = topt.adafactor(topt.constant(0.1))
    st = opt.init({"w": torch.zeros((64, 32))})
    sizes = [t.numel() for t in _flat(st["s"]).values()]
    assert sum(sizes) == 64 + 32          # O(n+m), not O(n*m)
    jst = jopt.adafactor(jopt.constant(0.1)).init({"w": jnp.zeros((64, 32))})
    assert {k: tuple(v.shape) for k, v in _flat(st["s"]).items()} == \
        {k: tuple(v.shape) for k, v in _jflat(jst["s"]).items()}


SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "linear_warmup": lambda m: m.linear_warmup(1e-3, 7),
    "cosine_decay": lambda m: m.cosine_decay(2e-3, 40, min_ratio=0.05),
    "warmup_cosine": lambda m: m.warmup_cosine(3e-4, 10, 50),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """Every step 0..60 (past the warmup and the decay's end), as an int
    and as a 0-d int32 tensor, within 1e-7 of the reference."""
    tf, jf = SCHEDULES[name](topt), SCHEDULES[name](jopt)
    for s in range(61):
        want = float(jf(s))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tf(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 1e-7 * max(1.0, abs(want)), \
                (name, s, float(got), want)


def test_warmup_cosine_shape():
    fn = topt.warmup_cosine(1.0, 10, 100)
    assert float(fn(0)) < 0.2
    assert abs(float(fn(10)) - 1.0) < 0.15
    assert float(fn(99)) < 0.2


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-5)
    c2, _ = topt.clip_by_global_norm(g, 1e6)
    np.testing.assert_allclose(_np(c2["a"]), 3.0)
    # a tree of several leaves against the reference
    rng = np.random.default_rng(7)
    tree = {"x": rng.standard_normal((3, 5)).astype(np.float32),
            "y": [rng.standard_normal((7,)).astype(np.float32) * 4]}
    tt = {"x": _t(tree["x"]), "y": [_t(tree["y"][0])]}
    jt = jax.tree.map(jnp.asarray, tree)
    for max_norm in (0.5, 1e3):
        got, gn = topt.clip_by_global_norm(tt, max_norm)
        want, jn = jopt.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
        _close_trees(got, want, 1e-6, f"clip {max_norm}")
        inplace = {"x": tt["x"].clone(), "y": [tt["y"][0].clone()]}
        topt.clip_by_global_norm(inplace, max_norm, inplace=True)
        _close_trees(inplace, want, 1e-6, f"clip in place {max_norm}")


def test_compress_bf16_halves_floats():
    g = {"w": torch.ones((4,)), "i": torch.ones((4,), dtype=torch.int32)}
    c = tcompress.compress_bf16(g)
    assert c["w"].dtype == torch.bfloat16 and c["i"].dtype == torch.int32
    # round to nearest even, bit for bit as XLA's cast (ties included:
    # 1 + 2^-8 and 1 + 3 * 2^-8 lie half way between two bf16 values)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10,
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                    -(1 + 2 ** -8), 3.0e-39, 65504.5])])
    got = tcompress.compress_bf16({"x": _t(x)})["x"]
    want = jcompress.compress_bf16({"x": jnp.asarray(x)})["x"]
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.uint16).view(np.int16))


def test_int8_error_feedback_unbiased():
    """EF residuals make repeated quantization asymptotically exact; the
    port's q's and scales equal the reference's bit for bit, its
    residuals within 1e-7."""
    rng = np.random.default_rng(0)
    g_np = rng.standard_normal((32, 32)).astype(np.float32)
    g_true = {"w": _t(g_np)}
    res = tcompress.init_residuals(g_true)
    jg = {"w": jnp.asarray(g_np)}
    jres = jcompress.init_residuals(jg)
    acc = np.zeros((32, 32), np.float32)
    for step in range(50):
        q, res = tcompress.compress_int8_ef(g_true, res)
        jq, jres = jcompress.compress_int8_ef(jg, jres)
        np.testing.assert_array_equal(q["w"][0].numpy(),
                                      np.asarray(jq["w"][0]))
        assert q["w"][0].dtype == torch.int8
        np.testing.assert_array_equal(q["w"][1].numpy(),
                                      np.asarray(jq["w"][1]))
        np.testing.assert_allclose(res["w"].numpy(), np.asarray(jres["w"]),
                                   rtol=0, atol=1e-7)
        acc += tcompress.decompress_int8(q)["w"].numpy()
    err = np.abs(acc / 50 - g_np).max()
    assert err < 5e-3, err


def test_q_int8_rounds_half_to_even():
    """x / scale landing on a half-integer rounds to even (as jnp.round),
    never away from zero."""
    x = np.float32([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5])
    q, scale = tcompress._q_int8(_t(x))
    jq, jscale = jcompress._q_int8(jnp.asarray(x))
    assert float(scale) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy()[1:], [0, 2, 2, 0, -2, 4])


def test_int8_ef_training_converges():
    """Toy regression trained with int8+EF compressed grads reaches the
    loss of uncompressed training, as in the reference (both packages)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((128, 16)).astype(np.float32)
    Y = rng.standard_normal((128, 4)).astype(np.float32)
    Xt, Yt = _t(X), _t(Y)

    def train(compressed):
        p = {"w": torch.zeros((16, 4))}
        opt = topt.adamw(topt.constant(0.01), weight_decay=0.0)
        st = opt.init(p)
        res = tcompress.init_residuals(p)
        for _ in range(200):
            _, g = _grads(lambda q: torch.mean((Xt @ q["w"] - Yt) ** 2), p)
            if compressed:
                qg, res = tcompress.compress_int8_ef(g, res)
                g = tcompress.decompress_int8(qg)
            p, st = opt.update(g, st, p)
        return float(torch.mean((Xt @ p["w"] - Yt) ** 2))

    def jtrain(compressed):
        p = {"w": jnp.zeros((16, 4))}
        opt = jopt.adamw(jopt.constant(0.01), weight_decay=0.0)
        st = opt.init(p)
        res = jcompress.init_residuals(p)
        loss = lambda q: jnp.mean((jnp.asarray(X) @ q["w"] - Y) ** 2)
        for _ in range(200):
            g = jax.grad(loss)(p)
            if compressed:
                qg, res = jcompress.compress_int8_ef(g, res)
                g = jcompress.decompress_int8(qg)
            p, st = opt.update(g, st, p)
        return float(loss(p))

    l_plain, l_comp = train(False), train(True)
    assert l_comp < l_plain * 1.2 + 1e-3, (l_plain, l_comp)
    np.testing.assert_allclose([l_plain, l_comp],
                               [jtrain(False), jtrain(True)], rtol=1e-4)


def _stacked_tree(rng, reps=3, d=8):
    """A training-layout tree: a stacked norm scale (reps, d), a stacked
    matrix (reps, d, 2d), a 1-D final norm scale and a tied table."""
    return {"stack": {"sub0": {"ln1": {"scale": 1 + 0.1 * rng.standard_normal((reps, d))},
                               "w": rng.standard_normal((reps, d, 2 * d))}},
            "final_norm": {"scale": 1 + 0.1 * rng.standard_normal((d,))},
            "embed": {"table": rng.standard_normal((16, d))}}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_on_stacked_leaves_matches_jax(kind):
    """Three updates of a training-layout tree within 1e-6 (relative, of
    each leaf's max) of the reference; the stacked (reps, d) norm scale
    is decayed (AdamW) and factored (Adafactor), the 1-D final scale not,
    as in the reference."""
    rng = np.random.default_rng(11)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    p0 = f32(_stacked_tree(rng))
    gs = [f32(jax.tree.map(lambda a: rng.standard_normal(a.shape), p0))
          for _ in range(3)]
    lr = (topt.warmup_cosine(1e-2, 2, 10), jopt.warmup_cosine(1e-2, 2, 10))
    if kind == "adamw":
        to, jo = topt.adamw(lr[0]), jopt.adamw(lr[1])
    else:
        to, jo = topt.adafactor(lr[0]), jopt.adafactor(lr[1])
    tp = jax.tree.map(_t, p0)
    jp = jax.tree.map(jnp.asarray, p0)
    ts, js = to.init(tp), jo.init(jp)
    if kind == "adafactor":
        st = ts["s"]["stack"]["sub0"]["ln1"]["scale"]
        assert set(st) == {"vr", "vc"} and tuple(st["vr"].shape) == (3,)
        assert set(ts["s"]["final_norm"]["scale"]) == {"v"}
    for g in gs:
        tp, ts = to.update(jax.tree.map(_t, g), ts, tp)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
    _close_trees(tp, jp, RTOL, f"{kind} params")
    _close_trees(ts, js, RTOL, f"{kind} state")
    if kind == "adamw":
        # zero gradients: only the decay moves a leaf
        z = jax.tree.map(lambda a: torch.zeros(a.shape), tp)
        before = {k: v.clone() for k, v in _flat(tp).items()}
        to_nomom = topt.adamw(topt.constant(0.1), weight_decay=0.5)
        after = _flat(to_nomom.update(z, to_nomom.init(tp), tp)[0])
        assert not torch.equal(after["stack/sub0/ln1/scale"],
                               before["stack/sub0/ln1/scale"])
        assert torch.equal(after["final_norm/scale"],
                           before["final_norm/scale"])
