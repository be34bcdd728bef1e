"""The port's AdamW (``repro_torch.optim``), its train step
(``repro_torch.train.step``) and ``remat`` on the CPU against the JAX
reference, at SMOKE in f32.

AdamW: one ``update`` from the same non-zero state (the reference's after
two of its own updates, through ``opt_state_from_jax``) on the same
gradient tree equals the reference's updates, moments, global norm and
learning rate within rtol 1e-6 (atol 1e-9) for all ten archs, weight
decay following the reference's stacked layout (``decay_mask``).  The
train step: one step from the reference's parameters and state after two
of its jitted steps equals its third within rtol 1e-4 (atol 1e-6, a
thousandth of one step's update at lr 1e-3), at ``accum`` 1 and 2.  From
a zero state the comparison would be ill-posed: Adam's first update is
about lr * sign(g) for every element, so an element whose gradient is at
f32 noise level takes a sign that neither side determines.  Inputs are
numpy arrays from seeds, handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.api import build_model
from repro_torch.models.common import remat
from repro_torch.models.transformer import decay_mask, params_from_jax
from repro_torch.optim import (AdamW, apply_updates, opt_state_from_jax,
                               tree_leaves, tree_map)
from repro_torch.train import make_train_step

UPDATE_TOL = dict(rtol=1e-6, atol=1e-9)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these SMOKE shapes gain nothing from more,
    and the test run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict / list of arrays or tensors."""
    if isinstance(tree, (dict, list)):
        items = sorted(tree.items()) if isinstance(tree, dict) \
            else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, exp, **tol):
    g, e = _flat(got), _flat(exp)
    assert g.keys() == e.keys()
    for k in e:
        np.testing.assert_allclose(g[k], e[k], err_msg=k, **tol)


def _configs(arch):
    return (jax_config(arch, smoke=True).with_(dtype=jnp.float32),
            get_config(arch, smoke=True, dtype=torch.float32))


def _tree_like(shapes, rng, scale):
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _reference_update(arch, opt_kw=OPT):
    """The reference's AdamW over random parameters of ``arch``'s SMOKE
    tree (values from a numpy seed): two updates, then the state, the
    parameters and the third gradient as numpy, and the third update's
    (updates, state, metrics)."""
    cj, _ = _configs(arch)
    rng = np.random.default_rng(0)
    params = _tree_like(jax_build_model(cj).param_shape(), rng, 0.1)
    grads = [_tree_like(params, rng, 0.02) for _ in range(3)]
    opt = JaxAdamW(**opt_kw)
    update = jax.jit(opt.update)
    state = opt.init(params)
    for g in grads[:2]:
        upd, state, _ = update(g, state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, upd)
    state = jax.tree.map(np.asarray, state)
    return params, state, grads[2], update(grads[2], state, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_equals_the_reference(arch):
    assert set(ARCHS) == set(JAX_ARCHS)
    _, ct = _configs(arch)
    params, state, grads, (upd, new_state, metrics) = _reference_update(arch)
    p = params_from_jax(params, ct, "cpu")
    got_upd, got_state, got_metrics = AdamW(**OPT).update(
        params_from_jax(grads, ct, "cpu"), opt_state_from_jax(state, ct,
                                                              "cpu"),
        p, decay=decay_mask(p, ct))
    assert int(got_state.step) == int(new_state.step) == 3
    for name, got, exp in (("updates", got_upd, upd),
                           ("m", got_state.m, new_state.m),
                           ("v", got_state.v, new_state.v)):
        _assert_trees_close(got, params_from_jax(
            jax.tree.map(np.asarray, exp), ct, "cpu"), **UPDATE_TOL)
    for k in ("gnorm", "lr"):
        np.testing.assert_allclose(float(got_metrics[k]), float(metrics[k]),
                                   rtol=1e-6, err_msg=k)
    # the global norm is above clip_norm: the clip scale is in play
    assert float(metrics["gnorm"]) > 1.0


# (arch, a per-layer norm scale, the axes the reference stacks it on)
STACKED_NORMS = [("internlm2-1.8b", ("blocks", 0, "ln1", "scale"), 1),
                 ("llama-3.2-vision-11b",
                  ("groups", 1, "self", 0, "ln2", "scale"), 2),
                 ("xlstm-1.3b", ("groups", 0, "m", 3, "ln", "scale"), 2),
                 ("recurrentgemma-9b", ("groups", 0, "attn", "ln2", "scale"),
                  1)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,path,axes", STACKED_NORMS)
def test_stacked_norm_scales_take_decay_as_in_the_reference(arch, path,
                                                            axes):
    """The reference decays every leaf with ndim >= 2 of its stacked tree,
    so a per-layer norm scale (D,) stacked to (L, D) is decayed and the
    unstacked final norm is not.  The port's mask says the same; the rule
    ``p.ndim >= 2`` on the port's unstacked tree (``decay=None``) leaves
    the scale undecayed, and its update then departs from the
    reference's."""
    _, ct = _configs(arch)
    params, state, grads, (upd, _, _) = _reference_update(arch)
    p = params_from_jax(params, ct, "cpu")
    mask = decay_mask(p, ct)
    # (D,) in the port, (L, D) or (G, inner, D) in the reference
    assert _at(p, path).dim() == 1
    assert _at(params, [k for k in path if isinstance(k, str)]).ndim \
        == 1 + axes
    assert _at(mask, path) is True and mask["final_norm"]["scale"] is False
    exp = _at(params_from_jax(jax.tree.map(np.asarray, upd), ct, "cpu"),
              path)
    got = {}
    for name, decay in (("mask", mask), ("ndim", None)):
        u, _, _ = AdamW(**OPT).update(
            params_from_jax(grads, ct, "cpu"),
            opt_state_from_jax(state, ct, "cpu"), p, decay=decay)
        got[name] = _at(u, path).numpy()
    np.testing.assert_allclose(got["mask"], exp.numpy(), **UPDATE_TOL)
    assert not np.allclose(got["ndim"], exp.numpy(), **UPDATE_TOL)


def test_decay_none_is_the_reference_rule_on_a_tree_without_stacks():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = {k: 0.3 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    opt = JaxAdamW(**OPT)
    upd, _, _ = opt.update(grads, opt.init(params), params)
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    port = AdamW(**OPT)
    got, _, _ = port.update({k: torch.as_tensor(v) for k, v in grads.items()},
                            port.init(p), p)
    _assert_trees_close(got, jax.tree.map(np.asarray, upd), **UPDATE_TOL)


@pytest.mark.parametrize("step", [0, 1, 49, 100, 5000, 10000, 20000])
def test_schedule_equals_the_reference(step):
    """Warm-up (0, 1, 49), its end (100), mid-decay, the end of the
    cosine and past it, at the reference's defaults."""
    got = float(AdamW().schedule(torch.tensor(step, dtype=torch.int32)))
    exp = float(JaxAdamW().schedule(jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, exp, rtol=1e-6)
    if step >= 10000:
        np.testing.assert_allclose(got, 3e-4 * 0.1, rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [0.0, 0.05])
def test_clip_norm_off_and_active(clip_norm):
    """clip_norm 0 takes no clip; 0.05 is below the gradients' norm, so it
    scales them; both as the reference's."""
    kw = dict(OPT, clip_norm=clip_norm)
    _, ct = _configs("qwen2.5-3b")
    params, state, grads, (upd, new_state, metrics) = _reference_update(
        "qwen2.5-3b", kw)
    assert float(metrics["gnorm"]) > 0.05
    p = params_from_jax(params, ct, "cpu")
    got_upd, got_state, _ = AdamW(**kw).update(
        params_from_jax(grads, ct, "cpu"),
        opt_state_from_jax(state, ct, "cpu"), p, decay=decay_mask(p, ct))
    for got, exp in ((got_upd, upd), (got_state.m, new_state.m)):
        _assert_trees_close(got, params_from_jax(
            jax.tree.map(np.asarray, exp), ct, "cpu"), **UPDATE_TOL)


def test_init_and_apply_updates_in_place():
    p = {"w": torch.ones((2, 3), dtype=torch.bfloat16),
         "l": [{"s": torch.zeros(3)}]}
    st = AdamW().init(p)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert [t.dtype for t in tree_leaves(st.m)] == [torch.float32] * 2
    assert all(not t.any() for t in tree_leaves(st.v))
    w = p["w"]
    out = apply_updates(p, tree_map(lambda t: torch.full_like(t, 0.5), p))
    assert out["w"] is w and torch.equal(w, torch.full((2, 3), 1.5,
                                                       dtype=torch.bfloat16))


# ------------------------------------------------------------- train step
B, T = 4, 16


def _batches(cfg, n, seed=0):
    r = np.random.default_rng(seed)
    return [{"tokens": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "recurrentgemma-9b"])
def test_train_step_equals_the_reference(arch, accum):
    cj, ct = _configs(arch)
    jm = jax_build_model(cj)
    opt = JaxAdamW(**OPT)
    params = jm.init(jax.random.PRNGKey(0))
    state = opt.init(params)
    step = jax.jit(jax_make_train_step(jm, opt, accum=accum))
    batches = _batches(cj, 3)
    for b in batches[:2]:
        params, state, _ = step(params, state, b)
    p = params_from_jax(jax.tree.map(np.asarray, params), ct, "cpu")
    s = opt_state_from_jax(jax.tree.map(np.asarray, state), ct, "cpu")
    params, state, metrics = step(params, state, batches[2])
    got_p, got_s, got_m = make_train_step(build_model(ct), AdamW(**OPT),
                                          accum=accum)(p, s, batches[2])
    assert int(got_s.step) == 3
    _assert_trees_close(got_p, params_from_jax(
        jax.tree.map(np.asarray, params), ct, "cpu"), **STEP_TOL)
    for k in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert all(t.grad is None for t in tree_leaves(got_p))


def test_accumulation_splits_the_batch_rows_in_order():
    """accum 2 over a batch equals the mean of the two half-batches'
    gradients, the first half being rows 0..b/2-1: the reference's
    reshape(accum, b // accum, ...)."""
    cfg = get_config("internlm2-1.8b", smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    batch = _batches(cfg, 1)[0]
    init = model.init(torch.Generator().manual_seed(0))
    seen = []
    loss = model.loss
    probe = dataclasses.replace(
        model, loss=lambda p, b: seen.append(np.asarray(b["tokens"]))
        or loss(p, b))
    opt = AdamW(**OPT)
    _, _, m = make_train_step(probe, opt, accum=2)(
        tree_map(torch.clone, init), opt.init(init), batch)
    assert [s.tolist() for s in seen] == [batch["tokens"][:2].tolist(),
                                          batch["tokens"][2:].tolist()]
    with torch.no_grad():
        halves = [float(loss(init, {k: v[i:i + 2] for k, v in batch.items()}))
                  for i in (0, 2)]
    np.testing.assert_allclose(float(m["loss"]), sum(halves) / 2, rtol=1e-6)


def test_int8_grad_compression_without_a_mesh_is_the_plain_step():
    cfg = get_config("qwen2.5-3b", smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    batch = _batches(cfg, 1)[0]
    init = model.init(torch.Generator().manual_seed(0))
    out = []
    for comp in ("none", "int8"):
        p = tree_map(torch.clone, init)
        opt = AdamW(**OPT)
        out.append(make_train_step(model, opt, grad_compression=comp)(
            p, opt.init(p), batch)[0])
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, AdamW(), grad_compression="fp8")


# ------------------------------------------------------------------ remat
class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _model_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab, (2, T)).astype(np.int32),
         "targets": r.integers(0, cfg.vocab, (2, T)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = r.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = r.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    """The loss's gradient is the same bit for bit under remat "none",
    "dots" and "full".  The backward's matrix products show what each
    kept: "full" recomputes the forward's products, "dots" keeps them (as
    "none" does) in the transformer families, and the recurrent families
    recompute under both, their reference's ``_remat`` taking no policy."""
    assert get_config(arch).remat == "dots"
    out = {}
    for mode in ("none", "dots", "full"):
        cfg = get_config(arch, smoke=True, dtype=torch.float32, remat=mode)
        model = build_model(cfg)
        p = model.init(torch.Generator().manual_seed(0))
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(p, _model_batch(cfg))
        with _CountOps() as ops:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[mode] = (grads, ops.mm)
    for mode in ("dots", "full"):
        for a, b in zip(out["none"][0], out[mode][0]):
            assert (a is None and b is None) or torch.equal(a, b)
    mm = {k: v[1] for k, v in out.items()}
    assert mm["full"] > mm["none"]
    recurrent = get_config(arch).family in ("ssm", "hybrid")
    assert mm["dots"] == (mm["full"] if recurrent else mm["none"]), mm


def test_remat_passes_through_without_grad_and_refuses_unknown_modes():
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return x * x
    x = torch.full((3,), 2.0, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(remat(fn, "full")(x), torch.full((3,), 4.0))
    remat(fn, "full")(x).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 4.0))
    assert calls == [False, True, True]     # the backward recomputed
    with pytest.raises(ValueError, match="remat"):
        remat(fn, "selective")
