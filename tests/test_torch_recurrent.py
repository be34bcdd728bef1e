"""The recurrent families of the port's model API on the CPU against the
JAX reference: xLSTM (xlstm-1.3b, family ssm) and RecurrentGemma
(recurrentgemma-9b, family hybrid), SMOKE in f32, with the windowed ring
cache, and the dense path's windowed ring.

The port's parameters are the reference's init converted by
``params_from_jax``; inputs come from numpy seeds.  The pieces (the causal
conv, the RG-LRU scan, the mLSTM step, chunkwise form and sequential
branch, the sLSTM loop), forward, loss, prefill (logits and state) and 8
greedy decode steps (from the port's own prefill and from the reference's
state through ``state_from_jax``) agree within atol = rtol = 1e-4 unless a
test says otherwise.

RecurrentGemma's ring has W slots, position p in slot p % W.  The
reference's prefill keeps only min(T, W) slots and its decode then
overwrites slot pos % T (ROADMAP Queue 3): after a prompt shorter than
the window its decode is wrong, so there the port is held to the
reference's ``forward`` over the extended sequence instead, and a test
shows the reference's own decode differing."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.models import rglru as jr
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.models import rglru as tr
from repro_torch.models import xlstm as tx
from repro_torch.models.api import build_model
from repro_torch.models.transformer import params_from_jax, state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
XLSTM, RG = "xlstm-1.3b", "recurrentgemma-9b"
B, STEPS = 2, 8
W = 32                                 # recurrentgemma SMOKE's window


@functools.lru_cache(maxsize=None)
def _setup(arch: str, **overrides):
    """(jax model, jax params, numpy tree, port model, port params)."""
    cj = jax_config(arch, smoke=True).with_(dtype=jnp.float32, **overrides)
    ct = get_config(arch, smoke=True, dtype=torch.float32, **overrides)
    jm = jax_build_model(cj)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return (jm, jax.tree.map(jnp.asarray, tree), tree, build_model(ct),
            params_from_jax(tree, ct, "cpu"))


def _tokens(arch: str, T: int, seed: int = 0) -> np.ndarray:
    vocab = jax_config(arch, smoke=True).vocab
    return np.random.default_rng(seed).integers(0, vocab, (B, T)) \
        .astype(np.int32)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in sorted(tree.items()):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.float().numpy() if tree.dtype == torch.bfloat16
                else tree.numpy()}
    return {prefix: np.asarray(tree)}


def _ring_keys(flat):
    return [k for k in flat if k.startswith("/groups/attn/")]


def _assert_states_close(jf, state, T=None):
    """jf: the reference's flattened state.  At T < W (RecurrentGemma) the
    reference's ring holds T slots: the port's first T must equal them and
    every other slot be empty (pos -1)."""
    tf = _flat(state)
    assert jf.keys() == tf.keys()
    for k in jf:
        got, exp = tf[k], jf[k]
        if k in _ring_keys(jf) and exp.shape != got.shape:
            assert T is not None and T < W and exp.shape[2] == T, k
            if k.endswith("pos"):
                assert (got[:, :, T:] == -1).all(), k
            got = got[:, :, :T]
        assert got.shape == exp.shape and got.dtype == exp.dtype, k
        np.testing.assert_allclose(got, exp, err_msg=k, **TOL)


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch: str, T: int):
    """The reference's prefill: (logits, state), as numpy."""
    jm, jp, _, _, _ = _setup(arch)
    logits, state = jm.prefill(jp, {"tokens": jnp.asarray(_tokens(arch, T))})
    return np.asarray(logits), jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def _ref_decode(arch: str, T: int):
    """The reference's 8 greedy decode steps from its own prefill state:
    [(token, pos, logits, flattened state), ...]."""
    jm, jp, _, _, _ = _setup(arch)
    logits, state = _ref_prefill(arch, T)
    state = jax.tree.map(jnp.asarray, state)
    steps = []
    for i in range(STEPS):
        tok = logits.argmax(-1).astype(np.int32)
        pos = np.full((B,), T + i, np.int32)
        logits, state = jm.decode_step(jp, state, jnp.asarray(tok),
                                       jnp.asarray(pos))
        logits = np.asarray(logits)
        steps.append((tok, pos, logits, _flat(state)))
    return steps


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [XLSTM, RG])
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_and_param_counts_are_the_references(arch, smoke):
    ct, cj = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    shared = set(type(ct).__dataclass_fields__) - {"dtype", "moe"}
    assert shared <= set(type(cj).__dataclass_fields__)
    for f in sorted(shared):
        assert getattr(ct, f) == getattr(cj, f), f
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()


def test_recurrentgemma_full_is_the_size_the_card_holds():
    cfg = get_config(RG)
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == (256, 16)
    assert cfg.param_count() == 10_444_242_944       # 20.9 GB in bf16
    assert [cfg._layer_kind(i) for i in range(4)] == ["rec", "rec", "attn",
                                                      "rec"]


# ---------------------------------------------------------- the pieces
def _rec_params(tree, tp):
    """The first group's rec1 mixer, on each side."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["groups"]["rec1"]["rec"])
    return jp, tp["groups"][0]["rec1"]["rec"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_the_reference(with_tail):
    _, _, tree, _, tp = _setup(RG)
    jp, p = _rec_params(tree, tp)
    rng = np.random.default_rng(3)
    x = _rand(rng, B, 5, 64)
    tail = _rand(rng, B, 3, 64) if with_tail else None
    exp, exp_tail = jr._causal_conv(jnp.asarray(x), jp["conv_w"],
                                    jp["conv_b"],
                                    None if tail is None
                                    else jnp.asarray(tail))
    got, got_tail = tr._causal_conv(
        torch.as_tensor(x), p["conv_w"], p["conv_b"],
        None if tail is None else torch.as_tensor(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    np.testing.assert_allclose(got_tail.numpy(), np.asarray(exp_tail), **TOL)


@pytest.mark.parametrize("T,with_h0", [(37, False), (37, True), (1, True)])
def test_rg_lru_matches_the_reference(T, with_h0):
    """The doubling scan against ``jax.lax.associative_scan`` (T = 37: not
    a power of two), the carry-in folded into the first element, and the
    one-step decode path."""
    _, _, tree, _, tp = _setup(RG)
    jp, p = _rec_params(tree, tp)
    rng = np.random.default_rng(4)
    y = _rand(rng, B, T, 64)
    h0 = _rand(rng, B, 64) if with_h0 else None
    exp, exp_last = jr.rg_lru(jnp.asarray(y), jp,
                              None if h0 is None else jnp.asarray(h0))
    got, got_last = tr.rg_lru(torch.as_tensor(y), p,
                              None if h0 is None else torch.as_tensor(h0))
    assert tuple(got.shape) == (B, T, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(exp_last), **TOL)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.uniform(0, 1, (2, 19, 3)))
    b = torch.as_tensor(rng.standard_normal((2, 19, 3)))
    h, want = torch.zeros(2, 3, dtype=a.dtype), []
    for t in range(19):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tr.linear_scan(a, b), torch.stack(want, 1))


def _mlstm_inputs(rng, T, H=2, dh=32, carried=True):
    q, k, v = (_rand(rng, B, T, H, dh) * 0.3 for _ in range(3))
    ipre, fpre = _rand(rng, B, T, H), _rand(rng, B, T, H) + 2.0
    s0 = {"C": _rand(rng, B, H, dh, dh) * 0.1,
          "n": _rand(rng, B, H, dh) * 0.1,
          "m": _rand(rng, B, H)} if carried else None
    return q, k, v, ipre, fpre, s0


def _to_jax(x):
    return jax.tree.map(jnp.asarray, x)


def _to_torch(x):
    return {k: torch.as_tensor(v) for k, v in x.items()} \
        if isinstance(x, dict) else torch.as_tensor(x)


def test_mlstm_step_matches_the_reference():
    rng = np.random.default_rng(6)
    q, k, v, ipre, fpre, s0 = _mlstm_inputs(rng, 1)
    args = [a[:, 0] for a in (q, k, v, ipre, fpre)]
    exp_s, exp_h = jx._mlstm_step(_to_jax(s0), *map(jnp.asarray, args))
    got_s, got_h = tx._mlstm_step(_to_torch(s0), *map(torch.as_tensor, args))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(exp_h), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(got_s[key].numpy(),
                                   np.asarray(exp_s[key]), **TOL)


@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 12)])
def test_mlstm_chunkwise_matches_the_reference(T, chunk):
    """Several chunks from a carried-in state (16 in chunks of 4), and one
    chunk: the same h and the same chunk-end state."""
    rng = np.random.default_rng(7)
    q, k, v, ipre, fpre, s0 = _mlstm_inputs(rng, T)
    exp_h, exp_s = jx.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, ipre,
                                                         fpre)),
                                      _to_jax(s0), chunk=chunk)
    got_h, got_s = tx.mlstm_chunkwise(*map(torch.as_tensor, (q, k, v, ipre,
                                                             fpre)),
                                      _to_torch(s0), chunk=chunk)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(exp_h), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(got_s[key].numpy(),
                                   np.asarray(exp_s[key]), **TOL)


@pytest.mark.parametrize("T", [130, 8])
def test_mlstm_apply_matches_the_reference(T):
    """T = 130 is no multiple of min(128, T): the step recurrence; T = 8
    the chunkwise form in one chunk."""
    jm, jparams, _, tm, tp = _setup(XLSTM)
    blk = jax.tree.map(lambda a: a[0, 0], jparams["groups"]["m"])
    x = _rand(np.random.default_rng(8), B, T, 64)
    exp, exp_s = jx.mlstm_apply(jnp.asarray(x), blk, jm.cfg)
    got, got_s = tx.mlstm_apply(torch.as_tensor(x), tp["groups"][0]["m"][0],
                                tm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(got_s[key].numpy(),
                                   np.asarray(exp_s[key]), **TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_apply_matches_the_reference(carried):
    jm, jparams, _, tm, tp = _setup(XLSTM)
    blk = jax.tree.map(lambda a: a[0], jparams["groups"]["s"])
    rng = np.random.default_rng(9)
    x = _rand(rng, B, 9, 64)
    state = None
    if carried:
        state = {k: _rand(rng, B, 2, 32) * 0.5 for k in ("c", "h")}
        state["n"] = np.abs(_rand(rng, B, 2, 32)) + 0.5
        state["m"] = _rand(rng, B, 2)
    exp, exp_s = jx.slstm_apply(jnp.asarray(x), blk, jm.cfg,
                                None if state is None else _to_jax(state))
    got, got_s = tx.slstm_apply(torch.as_tensor(x), tp["groups"][0]["s"],
                                tm.cfg,
                                None if state is None else _to_torch(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(got_s[key].numpy(),
                                   np.asarray(exp_s[key]), **TOL)


# --------------------------------------------------------------- models
@pytest.mark.parametrize("arch,T", [(XLSTM, 8), (RG, 40)])
def test_forward_and_loss_match_the_reference(arch, T):
    jm, jp, _, tm, tp = _setup(arch)
    batch = {"tokens": _tokens(arch, T), "targets": _tokens(arch, T, seed=1)}
    got = tm.forward(tp, batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.forward(jp, batch)),
                               **TOL)
    np.testing.assert_allclose(float(tm.loss(tp, batch)),
                               float(jm.loss(jp, batch)), **TOL)


@pytest.mark.parametrize("arch,T", [(XLSTM, 8), (XLSTM, 130), (RG, 40),
                                    (RG, 8)])
def test_prefill_logits_and_state_match_the_reference(arch, T):
    """xLSTM in one chunk and on the step recurrence (T = 130); the ring
    full from the prompt (T = 40 > W) and part-filled (T = 8 < W)."""
    _, _, _, tm, tp = _setup(arch)
    logits, state = tm.prefill(tp, {"tokens": _tokens(arch, T)}, s_max=T + 4)
    exp_logits, exp_state = _ref_prefill(arch, T)
    np.testing.assert_allclose(logits.numpy(), exp_logits, **TOL)
    _assert_states_close(_flat(exp_state), state, T)
    if arch == RG:
        pos = state["groups"]["attn"]["pos"]
        assert pos.shape[-1] == W
        want = [p if p < T else -1 for p in range(W)] if T < W else \
            [max(p for p in range(T) if p % W == s) for s in range(W)]
        assert (pos == torch.tensor(want, dtype=torch.int32)).all()


@pytest.mark.parametrize("arch,T", [(XLSTM, 8), (RG, 40)])
@pytest.mark.parametrize("start", ["own prefill", "reference state"])
def test_decode_steps_match_the_reference(arch, T, start):
    """8 greedy steps: tokens equal, logits and state within TOL, from the
    port's own prefill or from the reference's prefill state."""
    _, _, _, tm, tp = _setup(arch)
    if start == "own prefill":
        _, state = tm.prefill(tp, {"tokens": _tokens(arch, T)})
    else:
        state = state_from_jax(_ref_prefill(arch, T)[1], tm.cfg, "cpu")
    for tok, pos, exp_logits, exp_state in _ref_decode(arch, T):
        logits, state = tm.decode_step(tp, state, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), exp_logits, **TOL)
        _assert_states_close(exp_state, state)
        assert np.array_equal(logits.argmax(-1).numpy(),
                              exp_logits.argmax(-1))


@pytest.mark.parametrize("start", ["own prefill", "reference state"])
def test_ring_decode_below_the_window_equals_the_forward(start):
    """A prompt of 8 < W, then 28 greedy steps, so the ring wraps (slot
    pos % 32 past position 31): each step's logits equal the reference's
    ``forward`` over the sequence up to that token.  From the reference's
    8-slot prefill state, ``state_from_jax`` pads it to the W-slot ring."""
    jm, jp, _, tm, tp = _setup(RG)
    T, n = 8, 28
    toks = _tokens(RG, T)
    if start == "own prefill":
        logits, state = tm.prefill(tp, {"tokens": toks})
    else:
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        logits = torch.as_tensor(np.array(jl))
        state = state_from_jax(jax.tree.map(np.asarray, js), tm.cfg, "cpu")
        assert state["groups"]["attn"]["k"].shape[2] == W
    seq, got = toks, []
    for i in range(n):
        tok = logits.argmax(-1)
        seq = np.concatenate([seq, tok.numpy()[:, None].astype(np.int32)], 1)
        logits, state = tm.decode_step(tp, state, tok, np.full(B, T + i))
        got.append(logits.numpy())
    exp = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(seq)}))
    np.testing.assert_allclose(np.stack(got, 1), exp[:, T:T + n], **TOL)
    pos = state["groups"]["attn"]["pos"]
    assert sorted(pos[0, 0].tolist()) == list(range(T + n - W, T + n))


def test_the_reference_decode_below_the_window_is_wrong():
    """ROADMAP Queue 3, a reference fault the port does not copy: after a
    prompt of 8 < W = 32 the reference's prefill keeps an 8-slot ring
    (``attn_mixer_apply`` collects min(T, W) slots) and its decode writes
    slot pos % 8, overwriting keys still inside the window; its logits
    leave its own ``forward``'s.  Nothing in the reference is changed."""
    jm, jp, _, _, _ = _setup(RG)
    T = 8
    assert _ref_prefill(RG, T)[1]["groups"]["attn"]["k"].shape[2] == T
    steps = _ref_decode(RG, T)
    seq = np.concatenate([_tokens(RG, T)] + [tok[:, None]
                                             for tok, *_ in steps], 1)
    # the step at position p writes slot p % 8: its own forward's logits
    # at p see the whole window, its decode loses position p - 8
    exp = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(seq)}))
    err = [np.abs(logits - exp[:, T + i]).max()
           for i, (_, _, logits, _) in enumerate(steps[:-1])]
    assert min(err) > 1e-2 and max(err) > 0.1


@pytest.mark.parametrize("arch", [XLSTM, RG])
def test_make_cache_does_not_grow_with_S(arch):
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    a, b = (_flat(model.make_cache(B, S, device="cpu")) for S in (64, 4096))
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    jm = _setup(arch)[0]
    exp = _flat(jax.tree.map(np.asarray, jm.make_cache(B, 64)))
    assert {k: (v.shape, v.dtype) for k, v in exp.items()} == \
        {k: (v.shape, v.dtype) for k, v in a.items()}
    assert all(np.array_equal(a[k], exp[k]) for k in a)


def test_decode_at_a_wrong_position_raises():
    _, _, _, tm, tp = _setup(RG)
    _, state = tm.prefill(tp, {"tokens": _tokens(RG, 8)})
    before = _flat(state)
    tok = torch.zeros(B, dtype=torch.int32)
    for pos in ([9, 9], [8, 7]):
        with pytest.raises(ValueError, match="after its last"):
            tm.decode_step(tp, state, tok, torch.tensor(pos))
    with pytest.raises(IndexError):
        tm.decode_step(tp, state, tok, torch.tensor([-1, -1]))
    after = _flat(state)
    assert all(np.array_equal(before[k], after[k]) for k in before)


# -------------------------------------------- parameters and init
@pytest.mark.parametrize("arch", [XLSTM, RG])
def test_params_from_jax_is_exact_in_bf16(arch):
    """Every leaf of the reference's bf16 tree lands bit for bit: xlstm's
    groups on (G, 7) and G, rglru's on G, and the tail layers."""
    cj = jax_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray,
                        jax_build_model(cj).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(tree, get_config(arch, smoke=True), "cpu")
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] != "groups":
            pairs = [(tp, leaf, keys)]
        elif keys[1] == "m":
            pairs = [(tp["groups"][g]["m"][i], leaf[g, i], keys[2:])
                     for g in range(leaf.shape[0])
                     for i in range(leaf.shape[1])]
        else:
            pairs = [(tp["groups"][g][keys[1]], leaf[g], keys[2:])
                     for g in range(leaf.shape[0])]
        for sub, exp, rest in pairs:
            for k in rest:
                sub = sub[k]
            assert sub.dtype == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32}[exp.dtype.name]
            assert np.array_equal(sub.float().numpy(),
                                  exp.astype(np.float32)), keys
            checked += 1
    assert checked > 20


@pytest.mark.parametrize("arch", [XLSTM, RG])
def test_init_is_seeded_in_the_converted_layout(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)

    def flat(params):
        out = {}
        for k, v in params.items():
            if k == "groups":
                for g, grp in enumerate(v):
                    for name, blk in grp.items():
                        blks = blk if isinstance(blk, list) else [blk]
                        for i, b in enumerate(blks):
                            out.update(_flat(b, f"/groups/{g}/{name}/{i}"))
            else:
                out.update(_flat(v, f"/{k}"))
        return out

    a, b, c = (flat(model.init(torch.Generator().manual_seed(s)))
               for s in (3, 3, 4))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)
    tree = jax.tree.map(np.asarray, jax_build_model(
        jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0)))
    conv = flat(params_from_jax(tree, cfg, "cpu"))
    assert {k: (v.shape, v.dtype) for k, v in conv.items()} == \
        {k: (v.shape, v.dtype) for k, v in a.items()}


# ------------------------------------------- the dense windowed ring
@pytest.mark.parametrize("T,s_max", [(5, 12), (12, None)])
def test_dense_windowed_prefill_and_decode_match_the_reference(T, s_max):
    """qwen2.5-3b SMOKE with an 8-token window: a prompt of 5 in an 8-slot
    ring (the reference pads to W given ``s_max``) and of 12 > W; then 8
    greedy steps, the ring wrapping.  Logits and the whole cache (slot p %
    8 holds position p) equal the reference's ``lm_prefill`` and
    ``lm_decode_step``."""
    jm, jp, _, tm, tp = _setup("qwen2.5-3b", attn_window=8)
    toks = _tokens("qwen2.5-3b", T)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, s_max=s_max)
    logits, cache = tm.prefill(tp, {"tokens": toks}, s_max=s_max)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert cache["k"].shape[2] == 8
    _assert_states_close(_flat(jc), cache)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = np.full((B,), T + i, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        logits, cache = tm.decode_step(tp, cache, torch.as_tensor(tok),
                                       torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _assert_states_close(_flat(jc), cache)
