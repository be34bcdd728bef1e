"""The port's model API (``repro_torch.models.api.build_model``) on the CPU
against the JAX reference's ``build_model``, for the transformer families:
dense (qwen2.5-3b), MoE (moonshot-v1-16b-a3b, qwen3-moe-235b-a22b),
encoder-decoder (whisper-large-v3) and VLM (llama-3.2-vision-11b), SMOKE
in f32.

The port's parameters are the reference's init converted by
``params_from_jax``, with every ``xgate`` set to 0.5 in the numpy tree
that both sides take (the reference initialises it to 0, and tanh(0) = 0
would multiply the cross-attention away).  forward, loss, prefill (logits
and the whole cache, padded by ``s_max``) and two decode steps (logits and
cache) agree within atol = rtol = 1e-4.  Then the pieces: the MoE block
(dropped tokens, no drops, ties at the capacity edge), attention over a
prompt on the flash kernel's plain version, decode attention over a
contiguous cache on the paged kernel's plain version (page 4, page 16,
n_rep 16 split over rows), and what the port refuses."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro.models.common import MoECfg as JaxMoECfg
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers as tl
from repro_torch.models.api import build_model
from repro_torch.models.common import MoECfg
from repro_torch.models.transformer import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
# "@cf8": the same SMOKE config with the MoE's capacity factor at 8.0, so
# no token is dropped (the default 1.25 drops some)
MODEL_ARCHS = ["qwen2.5-3b", "moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b@cf8",
               "qwen3-moe-235b-a22b", "whisper-large-v3",
               "llama-3.2-vision-11b"]
NEW_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "whisper-large-v3",
             "llama-3.2-vision-11b"]
B, T, S_MAX = 2, 8, 12


def _xgate(tree, value):
    """The numpy tree with every ``xgate`` leaf set to ``value``."""
    if isinstance(tree, dict):
        return {k: np.full_like(v, value) if k == "xgate"
                else _xgate(v, value) for k, v in tree.items()}
    return tree


def _batch(cfg, seed=0) -> dict:
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "loss_mask": (r.random((B, T)) < 0.7).astype(np.float32)}
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = r.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _setup(arch: str):
    """(jax model, jax params, port model, port params, numpy batch)."""
    arch, _, variant = arch.partition("@")
    cj = jax_config(arch, smoke=True).with_(dtype=jnp.float32)
    ct = get_config(arch, smoke=True, dtype=torch.float32)
    if variant == "cf8":
        cj = cj.with_(moe=dataclasses.replace(cj.moe, capacity_factor=8.0))
        ct = ct.with_(moe=dataclasses.replace(ct.moe, capacity_factor=8.0))
    jm = jax_build_model(cj)
    tree = _xgate(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                  0.5)
    return (jm, jax.tree.map(jnp.asarray, tree), build_model(ct),
            params_from_jax(tree, ct, "cpu"), _batch(cj))


def _jb(batch, *drop):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _tb(batch, *drop):
    return {k: torch.as_tensor(v) for k, v in batch.items() if k not in drop}


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict (or list) of arrays or tensors;
    bf16 tensors as f32, which holds them exactly."""
    if isinstance(tree, (dict, list)):
        items = sorted(tree.items()) if isinstance(tree, dict) \
            else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if torch.is_tensor(tree):
        return {prefix: (tree.float() if tree.dtype == torch.bfloat16
                         else tree).numpy()}
    return {prefix: np.asarray(tree)}


def _assert_caches_close(jf, tc):
    """jf: the reference's cache, flattened by ``_flat``."""
    tf = _flat(tc)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert jf[k].shape == tf[k].shape, k
        assert jf[k].dtype == tf[k].dtype, k
        np.testing.assert_allclose(tf[k], jf[k], err_msg=k, **TOL)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's forward, loss, prefill and two greedy decode steps,
    as numpy: {"forward", "loss", "prefill": (logits, cache), "decode":
    [(token, pos, logits, cache), ...]}."""
    jm, jp, _, _, batch = _setup(arch)
    out = {"forward": np.asarray(jm.forward(jp, _jb(batch))),
           "loss": float(jm.loss(jp, _jb(batch)))}
    logits, cache = jm.prefill(jp, _jb(batch, "targets", "loss_mask"),
                               s_max=S_MAX)
    out["prefill"] = (np.asarray(logits), _flat(cache))
    steps = []
    for i in range(2):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        pos = np.full((B,), T + i, np.int32)
        logits, cache = jm.decode_step(jp, cache, jnp.asarray(tok),
                                       jnp.asarray(pos))
        steps.append((tok, pos, np.asarray(logits), _flat(cache)))
    out["decode"] = steps
    return out


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_matches_the_reference(arch):
    _, _, tm, tp, batch = _setup(arch)
    got = tm.forward(tp, _tb(batch))
    exp = _reference(arch)["forward"]
    assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
    np.testing.assert_allclose(got.numpy(), exp, **TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_loss_matches_the_reference(arch):
    _, _, tm, tp, batch = _setup(arch)
    np.testing.assert_allclose(float(tm.loss(tp, _tb(batch))),
                               _reference(arch)["loss"], **TOL)
    jm, jp = _setup(arch)[:2]
    np.testing.assert_allclose(
        float(tm.loss(tp, _tb(batch, "loss_mask"))),
        float(jm.loss(jp, _jb(batch, "loss_mask"))), **TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_logits_and_cache_match_the_reference(arch):
    _, _, tm, tp, batch = _setup(arch)
    logits, cache = tm.prefill(tp, _tb(batch, "targets", "loss_mask"),
                               s_max=S_MAX)
    exp_logits, exp_cache = _reference(arch)["prefill"]
    np.testing.assert_allclose(logits.numpy(), exp_logits, **TOL)
    _assert_caches_close(exp_cache, cache)
    # prefill's logits are the forward's last position's
    np.testing.assert_allclose(logits.numpy(),
                               _reference(arch)["forward"][:, -1], **TOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_decode_steps_match_the_reference(arch):
    _, _, tm, tp, batch = _setup(arch)
    _, cache = tm.prefill(tp, _tb(batch, "targets", "loss_mask"),
                          s_max=S_MAX)
    for tok, pos, exp_logits, exp_cache in _reference(arch)["decode"]:
        logits, cache = tm.decode_step(tp, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), exp_logits, **TOL)
        _assert_caches_close(exp_cache, cache)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_the_cross_attention_is_seen(arch):
    """With xgate 0.5 the cross-attention moves the logits: a different
    frame or patch input gives other logits (with xgate 0 it would not)."""
    _, _, tm, tp, batch = _setup(arch)
    key = "frames" if "frames" in batch else "image_embeds"
    other = dict(batch, **{key: batch[key][::-1].copy()})
    a = tm.forward(tp, _tb(batch)).numpy()
    b = tm.forward(tp, _tb(other)).numpy()
    assert np.abs(a - b).max() > 1e-2


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax_is_exact_in_bf16(arch):
    """Every leaf of the reference's bf16 tree lands bit for bit, in the
    port's layout (a list per layer; vlm groups of self blocks and one
    cross block)."""
    cj = jax_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray,
                        jax_build_model(cj).init(jax.random.PRNGKey(1)))
    ct = get_config(arch, smoke=True)
    tp = params_from_jax(tree, ct, "cpu")
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        if keys[0] in ("blocks", "enc_blocks", "dec_blocks"):
            pairs = [(tp[keys[0]][i], leaf[i]) for i in range(len(leaf))]
        elif keys[0] == "groups" and keys[1] == "self":
            pairs = [(tp["groups"][g]["self"][i], leaf[g, i])
                     for g in range(leaf.shape[0])
                     for i in range(leaf.shape[1])]
        elif keys[0] == "groups":
            pairs = [(tp["groups"][g]["cross"], leaf[g])
                     for g in range(leaf.shape[0])]
        else:
            pairs = [(tp, leaf)]
        rest = keys[2:] if keys[0] == "groups" else \
            keys[1:] if keys[0].endswith("blocks") else keys
        for sub, exp in pairs:
            for k in rest:
                sub = sub[k]
            assert sub.dtype == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32}[exp.dtype.name]
            assert np.array_equal(sub.float().numpy(),
                                  exp.astype(np.float32)), keys
            checked += 1
    assert checked > 10


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_is_seeded(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    a, b, c = (_flat(model.init(torch.Generator().manual_seed(s)))
               for s in (3, 3, 4))
    assert a.keys() == b.keys() == c.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)
    tree = jax.tree.map(np.asarray, jax_build_model(
        jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in _flat(params_from_jax(
        tree, cfg, "cpu")).items()} == {k: v.shape for k, v in a.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_and_param_counts_are_the_references(arch, smoke):
    ct, cj = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "qkv_bias", "norm",
              "act", "rope_theta", "pos", "tie_embeddings", "enc_layers",
              "enc_seq", "cross_every", "n_img_tokens", "attn_window",
              "block_pattern", "lru_width", "logits_f32"):
        assert getattr(ct, f) == getattr(cj, f), f
    assert (ct.moe is None) == (cj.moe is None)
    if ct.moe is not None:
        assert vars(ct.moe) == vars(cj.moe)
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()


def test_moonshot_full_is_the_size_the_card_holds():
    cfg = get_config("moonshot-v1-16b-a3b")
    assert cfg.param_count() == 28_057_796_608       # 56.1 GB in bf16
    assert tl.moe_capacity(4, 6, 64, 1.25) == 4      # every expert runs


def test_init_counts_every_parameter_of_the_formula():
    """The drawn weights of a SMOKE MoE model are the formula's count plus
    the norms (which the formula leaves out)."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    flat = _flat(build_model(cfg).init(torch.Generator().manual_seed(0)))
    norms = sum(v.size for k, v in flat.items() if "/ln" in k or "norm" in k)
    assert sum(v.size for v in flat.values()) - norms == cfg.param_count()


def test_the_serving_cli_offers_the_dense_archs_only():
    """The paged engine serves the dense family, as the reference's does:
    the other archs of the registry go through ``build_model``."""
    from repro_torch.launch.serve import build_parser
    choices = next(a.choices for a in build_parser()._actions
                   if a.dest == "arch")
    assert sorted(choices) == sorted(
        a for a in ARCHS if get_config(a).family == "dense")
    assert len(choices) == 4 and len(ARCHS) == 10


# ------------------------------------------------- decode past the cache
def test_decode_past_the_cache_raises():
    _, _, tm, tp, batch = _setup("moonshot-v1-16b-a3b")
    _, cache = tm.prefill(tp, _tb(batch, "targets", "loss_mask"))
    before = _flat(cache)
    tok = torch.zeros(B, dtype=torch.int32)
    for pos in (T, T + 5, -1):
        with pytest.raises(IndexError, match="cache of 8 slots"):
            tm.decode_step(tp, cache, tok, torch.full((B,), pos))
    after = _flat(cache)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_decode_that_leaves_a_gap_raises():
    """A row's step goes in the slot after its last: at pos = T + 1 after
    a prefill of T, the paged kernel would read slot T, never written,
    which the reference masks out (its cache pos is -1)."""
    _, _, tm, tp, batch = _setup("moonshot-v1-16b-a3b")
    _, cache = tm.prefill(tp, _tb(batch, "targets", "loss_mask"),
                          s_max=S_MAX)
    before = _flat(cache)
    tok = torch.zeros(B, dtype=torch.int32)
    for pos in ([T + 1, T + 1], [T, T + 2], [T, T - 1]):
        with pytest.raises(ValueError, match="slot after its last"):
            tm.decode_step(tp, cache, tok, torch.tensor(pos))
    after = _flat(cache)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    logits, _ = tm.decode_step(tp, cache, tok, torch.full((B,), T))
    assert bool(torch.isfinite(logits).all())


def test_reference_drops_the_decode_write_past_the_cache():
    """ROADMAP Queue 3 item 2: the reference's off-mesh decode writes the
    new token with ``.at[bidx, slot].set``, which JAX drops out of bounds:
    after a prefill without ``s_max``, a step at pos = T leaves the cache
    as it was and returns finite logits computed without the token."""
    jm, jp, _, _, batch = _setup("moonshot-v1-16b-a3b")
    _, cache = jm.prefill(jp, _jb(batch, "targets", "loss_mask"))
    assert cache["k"].shape[2] == T
    logits, new = jm.decode_step(jp, cache, jnp.zeros((B,), jnp.int32),
                                 jnp.full((B,), T, jnp.int32))
    assert bool(jnp.isfinite(logits).all())
    before, after = _flat(cache), _flat(new)
    assert all(np.array_equal(before[k], after[k]) for k in before)


# ---------------------------------------------------------------- the MoE
def _moe_params(D, E, F, seed=0):
    cfg = JaxMoECfg(n_experts=E, top_k=2, d_expert=F)
    p = jax.tree.map(np.asarray, jl.moe_init(jax.random.PRNGKey(seed), D,
                                             cfg, jnp.float32))
    return p, {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


def _dropped(x, router, top_k, capacity):
    """How many (token, expert) routings the capacity drops, from the
    routing alone (numpy)."""
    logits = x @ router
    top = np.argsort(-logits, axis=-1)[:, :top_k]
    counts = np.bincount(top.ravel(), minlength=router.shape[1])
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("cf,drops", [(1.25, True), (8.0, False)])
def test_moe_apply_matches_the_reference(cf, drops):
    D, E, F, k = 32, 8, 48, 2
    jp, tp = _moe_params(D, E, F)
    x = np.random.default_rng(1).standard_normal((2, 24, D)).astype(
        np.float32)
    cap = tl.moe_capacity(48, k, E, cf)
    assert cap == jl.moe_capacity(48, k, E, cf)
    assert (_dropped(x.reshape(-1, D), jp["router"], k, cap) > 0) == drops
    got = tl.moe_apply(torch.as_tensor(x), tp,
                       MoECfg(n_experts=E, top_k=k, d_expert=F,
                              capacity_factor=cf))
    exp = jl.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, jp),
                       JaxMoECfg(n_experts=E, top_k=k, d_expert=F,
                                 capacity_factor=cf), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


def _moe_local_both(x, jp, tp, top_k, capacity, E):
    kw = dict(top_k=top_k, capacity=capacity)
    got = tl.moe_local(torch.as_tensor(x), *(tp[n] for n in (
        "router", "wg", "wu", "wd")), **kw)
    exp = jl.moe_local(jnp.asarray(x), *(jnp.asarray(jp[n]) for n in (
        "router", "wg", "wu", "wd")), n_experts=E, expert_offset=0, **kw)
    return got.numpy(), np.asarray(exp)


def test_moe_positive_gate_tie_at_the_capacity_edge_takes_the_lower_index():
    """top_k = 1 renormalises every routed gate to exactly 1.0, so the
    tokens routed to one expert tie; with fewer slots than such tokens the
    reference keeps the lowest indices, and so must the port."""
    D, E, F, C = 16, 2, 24, 2
    jp, tp = _moe_params(D, E, F, seed=2)
    x = np.random.default_rng(3).standard_normal((9, D)).astype(np.float32)
    probs = torch.softmax(torch.as_tensor(x) @ tp["router"], -1)
    top1 = probs.argmax(-1)
    gate = probs.max(-1).values / (probs.max(-1).values + 1e-9)
    assert bool((gate == 1.0).all())
    routed = [np.flatnonzero(top1.numpy() == e) for e in range(E)]
    assert max(len(r) for r in routed) > C          # a tie at the edge
    score = torch.where(top1[:, None] == torch.arange(E), gate[:, None], 0.0)
    _, idx = tl.capacity_top_k(score.T, C)
    for e in range(E):
        kept = sorted(idx[e].tolist())
        if len(routed[e]) >= C:
            assert kept == routed[e][:C].tolist()
    got, exp = _moe_local_both(x, jp, tp, 1, C, E)
    np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)
    assert (np.abs(exp).sum(-1) == 0).any()          # dropped tokens


def test_moe_zero_gate_ties_cannot_change_the_output(monkeypatch):
    """Where C exceeds the tokens routed to an expert, the rest of its
    slots go to tokens of gate 0; which of them is picked adds exactly
    nothing.  The same call with the zero-gate slots filled from the
    highest index down equals the stable choice and the reference."""
    D, E, F, C = 16, 4, 24, 10
    jp, tp = _moe_params(D, E, F, seed=4)
    x = np.random.default_rng(5).standard_normal((12, D)).astype(np.float32)
    stable, exp = _moe_local_both(x, jp, tp, 2, C, E)
    sort = tl.capacity_top_k

    def reversed_zero_ties(score, capacity):
        vals, idx = sort(score, score.shape[-1])
        zero = vals == 0
        idx = torch.where(zero, idx.flip(-1), idx)   # zeros: high first
        assert bool(zero[:, capacity - 1].any())     # some slot gate 0
        return vals[..., :capacity], idx[..., :capacity]
    monkeypatch.setattr(tl, "capacity_top_k", reversed_zero_ties)
    other, _ = _moe_local_both(x, jp, tp, 2, C, E)
    assert np.array_equal(other, stable)
    np.testing.assert_allclose(stable, exp, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_local,offset", [(8, 0), (4, 0), (4, 4)])
def test_moe_combine_equals_the_scatter_add(monkeypatch, n_local, offset):
    """The gather and fixed-order sum of each token's k expert outputs
    equals the scatter-add of every slot's output (zero-gate slots
    among them), also where the call holds a part of the experts."""
    D, E, F, T, k, C = 16, 8, 24, 20, 2, 6
    g = torch.Generator().manual_seed(11)
    x = torch.randn((T, D), generator=g)
    router = torch.randn((D, E), generator=g)
    wg, wu = (torch.randn((n_local, D, F), generator=g) for _ in range(2))
    wd = torch.randn((n_local, F, D), generator=g)
    seen, combine = {}, tl.combine_top_k

    def spy(ye, idx, topi, T):
        seen.update(ye=ye, idx=idx)
        return combine(ye, idx, topi, T)
    monkeypatch.setattr(tl, "combine_top_k", spy)
    got = tl.moe_local(x, router, wg, wu, wd, top_k=k, capacity=C,
                       expert_offset=offset)
    exp = torch.zeros((T, D)).index_add_(0, seen["idx"].reshape(-1),
                                         seen["ye"].reshape(-1, D))
    assert (seen["ye"].abs().sum(-1) == 0).any()         # zero-gate slots
    torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


def test_moe_local_in_bf16_rounds_where_the_reference_rounds():
    """bf16 router logits widened after the product, silu one op at a
    time, the gate in the experts' dtype: equal to the reference's bits."""
    D, E, F = 64, 8, 96
    p = jl.moe_init(jax.random.PRNGKey(0), D, JaxMoECfg(E, 2, F),
                    jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(9).standard_normal((32, D)),
                    jnp.bfloat16)
    kw = dict(top_k=2, capacity=10)
    exp = jl.moe_local(x, p["router"], p["wg"], p["wu"], p["wd"],
                       n_experts=E, expert_offset=0, **kw)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    got = tl.moe_local(t(x), *(t(p[n]) for n in ("router", "wg", "wu",
                                                  "wd")), **kw)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(exp, np.float32))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("case", ["self-causal", "self-window",
                                  "cross-long-S-chunked", "cross-T-ne-S"])
def test_flash_attention_matches_the_reference_chunked_attention(case):
    """The port's attention over a prompt (``ops.flash_attention``: on the
    CPU its plain version) against the reference's ``chunked_attention``
    at prompt positions 0..T-1: causal, windowed, and non-causal over S
    keys, at S = 4096 through the reference's chunked scan."""
    from repro_torch.kernels.ops import flash_attention
    r = np.random.default_rng(6)
    Bq, Tq, S, H, Hkv, hd = {"self-causal": (2, 16, 16, 4, 2, 8),
                             "self-window": (2, 16, 16, 4, 1, 8),
                             "cross-long-S-chunked": (1, 4, 4096, 4, 2, 8),
                             "cross-T-ne-S": (2, 6, 30, 4, 4, 16)}[case]
    q = r.standard_normal((Bq, Tq, H, hd)).astype(np.float32)
    k = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    v = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    causal = case.startswith("self")
    window = 5 if case == "self-window" else 0
    got = flash_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                          window=window)
    exp = jl.chunked_attention(
        *map(jnp.asarray, (q, k, v)),
        q_pos=jnp.broadcast_to(jnp.arange(Tq), (Bq, Tq)),
        k_pos=jnp.broadcast_to(jnp.arange(S), (Bq, S)), causal=causal,
        window=window, chunk=512, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("S,page", [(1500, 4), (144, 16), (12, 4), (30, 2),
                                    (7, 1), (1600, 16)])
def test_contiguous_page(S, page):
    assert tl.contiguous_page(S) == page


@pytest.mark.parametrize("n_rep,rep", [(1, 1), (7, 7), (8, 8), (16, 8),
                                       (12, 6), (64, 8)])
def test_kernel_rep_stays_within_the_kernel(n_rep, rep):
    assert tl.kernel_rep(n_rep) == rep


@pytest.mark.parametrize("label,Bq,S,H,Hkv,hd", [
    ("whisper-cross-page4", 2, 1500, 4, 4, 8),
    ("s_max-144-page16", 3, 144, 4, 2, 16),
    ("qwen3-moe-nrep16-split", 2, 144, 32, 2, 8),
])
def test_decode_attention_over_a_contiguous_cache_matches_the_reference(
        label, Bq, S, H, Hkv, hd):
    """The paged kernel's call (here its plain version) over the cache
    viewed as pages, with the identity table and lengths pos + 1, against
    the reference's ``decode_attention`` over the cache's slot positions
    (-1 = empty).  n_rep 16 runs as 2 rows of n_rep 8 each."""
    r = np.random.default_rng(7)
    q = r.standard_normal((Bq, 1, H, hd)).astype(np.float32)
    k = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    v = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    pos = r.integers(0, S, Bq).astype(np.int32)
    pos[0] = S - 1
    cpos = np.where(np.arange(S)[None] <= pos[:, None], np.arange(S)[None],
                    -1).astype(np.int32)
    pages = tl.decode_pages(torch.as_tensor(pos + 1), S, H // Hkv)
    assert pages.page == tl.contiguous_page(S)
    assert pages.split == (2 if H // Hkv == 16 else 1)
    assert tuple(pages.table.shape) == (Bq * pages.split, S // pages.page)
    got = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), pages)
    exp = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              k_pos=jnp.asarray(cpos), pos=jnp.asarray(pos),
                              window=0, kv_mask=jnp.asarray(cpos >= 0),
                              ctx=None, chunk=512, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5,
                               rtol=1e-5)


def test_decode_update_writes_one_slot_per_row_in_place():
    Bq, S, H, Hkv, hd = 3, 16, 4, 2, 8
    r = np.random.default_rng(8)
    ck = torch.zeros((Bq, S, Hkv, hd))
    cv = torch.zeros((Bq, S, Hkv, hd))
    cp = torch.full((Bq, S), -1, dtype=torch.int32)
    pos = torch.tensor([0, 5, 15])
    nk, nv = (torch.as_tensor(r.standard_normal((Bq, 1, Hkv, hd)),
                              dtype=torch.float32) for _ in range(2))
    q = torch.as_tensor(r.standard_normal((Bq, 1, H, hd)),
                        dtype=torch.float32)
    out = tl.decode_update_and_attend(
        q, ck, cv, cp, nk, nv, (torch.arange(Bq), pos),
        tl.decode_pages(pos + 1, S, H // Hkv))
    for b, p in enumerate(pos.tolist()):
        assert torch.equal(ck[b, p], nk[b, 0])
        assert torch.equal(cv[b, p], nv[b, 0])
        assert cp[b].tolist() == [p if i == p else -1 for i in range(S)]
    assert int((ck != 0).any(-1).any(-1).sum()) == Bq
    assert tuple(out.shape) == (Bq, 1, H, hd)
