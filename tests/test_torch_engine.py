"""The port's serving slice on the CPU against the JAX reference, on
qwen2.5-3b SMOKE (and phi3-mini-3.8b SMOKE for the decode parity) with the
JAX init converted by ``params_from_jax``.

f32: greedy tokens equal ``model.prefill``/``decode_step``'s (the dense
ring-cache path) and logits agree within 1e-4.  bf16: logits agree with
the reference's own ``PagedLM`` (plain attention path) within 2e-2 — the
model path attends in a different order of bf16 roundings, so it is not
the bf16 oracle.  Then the serving scenarios of ``test_train_serve.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model
from repro.kernels import ref as jref
from repro.serve import kvcache as jkv
from repro.serve.engine import PagedLM as JaxPagedLM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvcache import PagedCacheConfig as JaxCacheConfig
from repro.serve.kvcache import PagedKVCache as JaxKVCache
from repro_torch.configs import get_config
from repro_torch.launch.serve import build_parser, main as serve_main
from repro_torch.models.transformer import init_lm, params_from_jax
from repro_torch.serve import (PagedCacheConfig, PagedKVCache, PagedLM,
                               ServeEngine)

JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"f32": torch.float32, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """dtype -> (jax cfg, jax model, jax params, port cfg, port params).
    One JAX init in f32; the bf16 tree is its cast, which is what
    ``init_lm`` with a bf16 config draws (norm scales stay f32)."""
    cj = jax_config(arch, smoke=True).with_(dtype=jnp.float32)
    model = build_model(cj)
    params = model.init(jax.random.PRNGKey(0))
    norms = {"ln1", "ln2", "final_norm"}
    trees = {"f32": params, "bf16": jax.tree_util.tree_map_with_path(
        lambda path, a: a if norms & {getattr(k, "key", None) for k in path}
        else a.astype(jnp.bfloat16), params)}
    out = {}
    for dt, tree in trees.items():
        cjd = cj.with_(dtype=JD[dt])
        ct = get_config(arch, smoke=True, dtype=TD[dt])
        tp = params_from_jax(jax.tree.map(np.asarray, tree), ct, "cpu")
        out[dt] = (cjd, build_model(cjd), tree, ct, tp)
    return out


@pytest.fixture(scope="module")
def models():
    return _models("qwen2.5-3b")


def _cache_cfg(ct, pool_pages=64, page_size=8):
    return PagedCacheConfig(
        n_layers=ct.n_layers, n_kv_heads=ct.n_kv_heads, head_dim=ct.hd,
        page_size=page_size, n_pages=pool_pages, max_pages_per_seq=16,
        dtype=ct.dtype)


def _engine(models, dt="f32", pool_pages=64, page_size=8):
    _, _, _, ct, tp = models[dt]
    return ServeEngine(ct, tp, cache_cfg=_cache_cfg(ct, pool_pages, page_size),
                       max_batch=2, device="cpu")


def test_params_from_jax_is_exact(models):
    _, _, params, ct, tp = models["bf16"]
    assert len(tp["blocks"]) == ct.n_layers
    for name in ("wq", "bq", "wo"):
        for li in range(ct.n_layers):
            got = tp["blocks"][li]["attn"][name]
            assert got.dtype == torch.bfloat16
            exp = np.asarray(params["blocks"]["attn"][name][li], np.float32)
            assert np.array_equal(got.float().numpy(), exp)
    assert tp["blocks"][1]["ln2"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3-mini-3.8b"])
def test_paged_decode_matches_dense_reference(arch):
    """Greedy tokens from the port's engine == tokens from the reference
    dense-cache decode path, and the logits agree step by step."""
    models = _models(arch)
    cj, model, params, ct, tp = models["f32"]
    prompt = np.random.default_rng(0).integers(2, cj.vocab, size=(12,))
    eng = _engine(models)
    req = eng.submit(prompt.tolist(), max_new_tokens=6)
    eng.run()

    logits, cache = model.prefill(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)[None]}, s_max=20)
    lm = PagedLM(ct, tp, PagedKVCache(_cache_cfg(ct), device="cpu"))
    sid = lm.cache.new_sequence()
    got = lm.prefill(prompt, sid)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits[0]), atol=1e-4,
                               rtol=1e-4)
    ref = [int(jnp.argmax(logits[0]))]
    for pos in range(12, 17):
        t = jnp.asarray([ref[-1]], jnp.int32)
        logits, cache = model.decode_step(params, cache, t,
                                          jnp.asarray([pos], jnp.int32))
        got = lm.decode_step(np.array([ref[-1]]), [sid], np.array([pos]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(logits[0]),
                                   atol=1e-4, rtol=1e-4)
        ref.append(int(jnp.argmax(logits[0])))
    assert req.out_tokens == ref, (req.out_tokens, ref)


def test_bf16_logits_match_reference_paged_lm(models):
    cj, _, params, ct, tp = models["bf16"]
    prompt = np.random.default_rng(1).integers(2, cj.vocab, size=(12,))
    jc = JaxKVCache(JaxCacheConfig(n_layers=ct.n_layers,
                                   n_kv_heads=ct.n_kv_heads,
                                   head_dim=ct.hd, page_size=8, n_pages=16))
    jlm = JaxPagedLM(cj, params, jc, use_kernel=False)
    lm = PagedLM(ct, tp, PagedKVCache(_cache_cfg(ct, 16), device="cpu"))
    js, ts = jc.new_sequence(), lm.cache.new_sequence()
    exp, got = jlm.prefill(prompt, js), lm.prefill(prompt, ts)
    tok = int(np.argmax(np.asarray(exp)))
    for pos in range(12, 14):
        np.testing.assert_allclose(got.float().numpy().reshape(-1),
                                   np.asarray(exp, np.float32).reshape(-1),
                                   atol=2e-2, rtol=2e-2)
        exp = jlm.decode_step(np.array([tok]), [js], np.array([pos]))
        got = lm.decode_step(np.array([tok]), [ts], np.array([pos]))
        tok = int(np.argmax(np.asarray(exp)[0]))


def test_eager_pageout_on_retire_and_release(models):
    eng = _engine(models, pool_pages=32)
    for _ in range(3):
        eng.submit(list(range(2, 10)), max_new_tokens=4)
    eng.run()
    assert len(eng.finished) == 3
    assert eng.cache.free_pages() == 32
    assert len(eng.cache.host) == 0
    assert eng.metrics.count["pages_out"] > 0


def test_conditional_bypass_under_pool_pressure(models):
    """A pool too small for the working set triggers host-tier bypass
    pages, and decoding still completes."""
    eng = _engine(models, pool_pages=2, page_size=4)
    req = eng.submit(list(range(2, 20)), max_new_tokens=4)
    eng.run()
    assert req.done and len(req.out_tokens) == 4
    assert eng.metrics.count.get("bypass_pages", 0) > 0
    assert eng.metrics.count.get("hybrid_attention", 0) > 0


def test_transit_pageout_pagein_roundtrip(models):
    """deactivate (int8 page-out) then activate (page-in): decode still
    produces the tokens of an uninterrupted run."""
    prompt = list(range(2, 18))
    ref_eng = _engine(models)
    ref_req = ref_eng.submit(prompt, max_new_tokens=6)
    ref_eng.run()
    eng = _engine(models)
    req = eng.submit(prompt, max_new_tokens=6)
    eng.step()                       # prefill + 1 token
    eng.cache.deactivate(req.seq_id)
    assert eng.metrics.count.get("pages_out", 0) > 0
    eng.cache.activate(req.seq_id)
    assert eng.metrics.count.get("pages_in", 0) > 0
    eng.run()
    # int8 KV roundtrip may perturb logits; require the first tokens match
    assert req.out_tokens[:2] == ref_req.out_tokens[:2]
    assert len(req.out_tokens) == len(ref_req.out_tokens)
    assert eng.metrics.count.get("transit_crc_errors", 0) == 0


def test_suspend_resume_through_the_scheduler(models):
    """ServeEngine.suspend pages a running request out; the next tick
    resumes it ahead of the queue and pages it back in."""
    eng = _engine(models)
    a = eng.submit(list(range(2, 14)), max_new_tokens=6)
    b = eng.submit(list(range(20, 30)), max_new_tokens=6)
    eng.step()
    eng.step()
    eng.suspend(a)
    assert a in eng.suspended and eng.metrics.count["suspends"] == 1
    eng.run()
    assert a.done and b.done
    assert len(a.out_tokens) == len(b.out_tokens) == 6
    count = eng.metrics.count
    assert count["resumes"] == 1 and count["pages_in"] > 0
    assert count["pages_out"] > count["pages_in"]
    assert eng.cache.free_pages() == 64


def test_default_cache_keeps_bf16_pools_like_the_reference(models,
                                                          monkeypatch):
    """With no ``cache_cfg`` the engine's pools take the cache config's
    own dtype (bf16), as the reference's do, whatever the model's dtype: an
    f32 SMOKE engine gives the reference engine's greedy tokens, through a
    suspend (bf16 page-out and page-in).  The reference's Pallas codec
    does not trace on this jax; its cache calls the eager oracles."""
    monkeypatch.setattr(jkv, "gather_quantize_crc", lambda pool, ids: (
        *jref.gather_quantize_ref(pool, ids),
        jref.transit_crc_ref(jref.gather_quantize_ref(pool, ids)[0])))
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", lambda pool, ids, q, s: (
        jref.scatter_dequantize_ref(pool, ids, q, s),
        jref.transit_crc_ref(q)))
    cj, _, params, ct, tp = models["f32"]
    tokens = []
    for eng in (ServeEngine(ct, tp, max_batch=2, device="cpu"),
                JaxServeEngine(cj, params, max_batch=2, use_kernel=False)):
        rng = np.random.default_rng(4)
        reqs = [eng.submit(rng.integers(2, cj.vocab, size=n).tolist(),
                           max_new_tokens=6) for n in (12, 20)]
        eng.step()
        eng.step()
        eng.suspend(reqs[0])
        eng.run()
        assert eng.metrics.count["pages_in"] > 0
        tokens.append([r.out_tokens for r in reqs])
        pool = eng.cache.k_pool[0]
        assert pool.dtype in (torch.bfloat16, jnp.bfloat16), pool.dtype
    assert tokens[0] == tokens[1]


def test_init_lm_is_seeded():
    ct = get_config("qwen2.5-3b", smoke=True)
    p1 = init_lm(ct, torch.Generator().manual_seed(3))
    p2 = init_lm(ct, torch.Generator().manual_seed(3))
    assert torch.equal(p1["embed"], p2["embed"])
    assert torch.equal(p1["blocks"][1]["mlp"]["wd"], p2["blocks"][1]["mlp"]["wd"])
    assert p1["embed"].dtype == torch.bfloat16
    assert p1["blocks"][0]["attn"]["bq"].abs().sum() == 0


def test_serve_cli_smoke_is_a_real_switch(capsys):
    assert build_parser().parse_args([]).smoke is True
    assert build_parser().parse_args(["--no-smoke"]).smoke is False
    serve_main(["--device", "cpu", "--requests", "2", "--max-new", "3",
                "--prompt-len", "8"])
    assert "[serve] qwen25-smoke on cpu: 2 requests, 6 tokens" in \
        capsys.readouterr().out
