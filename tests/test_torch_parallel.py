"""The port's mesh (``repro_torch.parallel``, ``launch/mesh.py`` and the
model's mesh branches) on the CPU, against the reference and against one
process.

  (a) the sharding rules: for all ten configs, FULL and SMOKE, on meshes
      (16, 16), (2, 16, 16) and (2, 4), the port's parameter, ZeRO-1 and
      cache specs equal the reference's (its parameter specs with the
      stack axes dropped, which the reference never shards);
  (b) the int8 ring: ``compressed_allreduce_tree`` over 4 gloo ranks (and
      over (pod, data) = (2, 4) in 8) equals the reference's on 4 (8)
      forced host devices within 1e-6, and the reference's ring receives
      identical copies;
  (c) N ranks equal one process: losses, a train step, MoE with ZeRO-3
      experts, the query-sharded attention, the S-sharded decode and both
      recurrent families, within rtol 1e-4 (parameters row by row);
  (d) the elastic restore: a checkpoint saved on (2, 2) restores bit for
      bit onto (4, 1) and (1, 4), each rank holding its shards and one
      whole leaf at a time, and a ``Trainer`` resumed on a resized
      mesh continues the single-process losses;
  (e) the new kernel arguments' plain versions: the paged attention's
      log-sum-exp, flash attention's ``q_offset``.

Multi-rank cases start their ranks with ``torch.multiprocessing`` on the
gloo backend (a ``file://`` rendezvous under ``tmp_path``, one intra-op
thread a rank) and compare what rank 0 saves with the parent's own run.
Every case uses f32 SMOKE configs.  JAX is imported inside the cases that
need it, so the ranks, which import this module, never load it.
"""
import contextlib
import math
import os
import subprocess
import sys
import textwrap
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref
from repro_torch.models.api import build_model
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
ROW_TOL = 1e-4
INTERNLM2, QWEN3_MOE = "internlm2-1.8b", "qwen3-moe-235b-a22b"
DEEPSEEK, XLSTM, RGEMMA = ("deepseek-coder-33b", "xlstm-1.3b",
                           "recurrentgemma-9b")
B, T = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ spawning
def _spawn(fn, n: int, tmp_path, *args, timeout: float = 120.0):
    """Run ``fn(rank, n, rendezvous, out_dir, *args)`` on n gloo ranks;
    raise if one fails or the ranks outlive ``timeout``."""
    rdv = tmp_path / f"rdv_{fn.__name__}"
    ctx = mp.start_processes(fn, args=(n, str(rdv), str(tmp_path), *args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} ranks outlived {timeout} s")


def _init(rank: int, world: int, rdv: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)


def _smoke(arch: str, **kw):
    return get_config(arch, smoke=True, dtype=torch.float32, **kw)


def _no_drop(cfg):
    """Capacity factor E / k: every expert takes every token routed to it,
    so a batch shard's capacity drops nothing that the whole batch's
    keeps (with drops the two differ by design: the capacity counts each
    rank's own tokens, as in the reference)."""
    return cfg.with_(moe=replace(cfg.moe, capacity_factor=(
        cfg.moe.n_experts / cfg.moe.top_k)))


def _batch(cfg, seed: int = 0, b: int = B, t: int = T) -> dict:
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab, (b, t)),
            "targets": r.integers(0, cfg.vocab, (b, t))}


def _params(model):
    return model.init(torch.Generator().manual_seed(0))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_rows_close(got, exp, tol=ROW_TOL):
    """Every row (along the last axis) of every leaf: ||got - exp|| <=
    tol ||exp||."""
    got, exp = _leaves(got), _leaves(exp)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        g, e = g.double().reshape(-1, e.shape[-1] if e.dim() else 1), \
            e.double().reshape(-1, e.shape[-1] if e.dim() else 1)
        err, size = (g - e).norm(dim=-1), e.norm(dim=-1)
        assert bool((err <= tol * size).all()), \
            float((err / size.clamp_min(1e-30)).max())


# ====================================================== (a) spec rules
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}]


class _DuckMesh:
    """What the reference's rules read of a mesh: ``.shape``, a dict."""

    def __init__(self, shape: dict) -> None:
        self.shape = shape


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_rules_equal_the_reference(arch):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.parallel import sharding as ref
    from repro_torch.parallel import (batch_spec_tree, cache_spec_tree,
                                      make_ctx, map_tree, param_spec_tree,
                                      zero_spec_tree)
    for smoke in (False, True):
        model = build_model(get_config(arch, smoke=smoke))
        jm = jax_build(jax_config(arch, smoke=smoke))
        shapes = model.param_shape()
        assert all(t.device.type == "meta" for t in _leaves(shapes))
        jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        cache = model.make_cache(32, 256, device="meta")
        jcache = jm.cache_shape(32, 256)
        for ms in MESHES:
            dm = _DuckMesh(ms)
            jspec = ref.param_spec_tree(jshapes, dm)
            jzero = ref.zero_spec_tree(jspec, jshapes, dm)
            checked = []

            def same(path, stack, spec, jtree, stack_whole=True):
                want = _norm(_at(jtree, path))
                # the stack axes the port drops are never sharded in the
                # reference's parameter specs (ZeRO-1 may put 'data' on one)
                assert not stack_whole or all(
                    e is None for e in want[:len(stack)]), (arch, path, want)
                assert _norm(spec) == want[len(stack):], (arch, ms, path,
                                                           spec, want)
                checked.append(path)

            map_tree(lambda p, s, sp: same(p, s, sp, jspec),
                     param_spec_tree(shapes, ms))
            map_tree(lambda p, s, sp: same(p, s, sp, jzero, False),
                     zero_spec_tree(shapes, ms))
            ctx, jctx = make_ctx(ms, 32), ref.make_ctx(dm, 32)
            assert ctx.batch_axes == jctx.batch_axes
            jc = ref.cache_spec_tree(jcache, jctx, dm)
            map_tree(lambda p, s, sp: same(p, s, sp, jc),
                     cache_spec_tree(cache, ctx))
            batch = {"tokens": (32, 256), "frames": (32, 1500, 64)}
            jb = ref.batch_spec_tree({k: jax.ShapeDtypeStruct(v, "int32")
                                      for k, v in batch.items()}, jctx)
            assert {k: _norm(v) for k, v in batch_spec_tree(
                batch, ctx).items()} == {k: _norm(v) for k, v in jb.items()}
            assert len(checked) == 2 * len(_leaves(shapes)) + len(
                _leaves(cache))


# ====================================================== (b) the int8 ring
def _ring_grads() -> dict:
    r = np.random.default_rng(0)
    return {"a": torch.tensor(r.standard_normal((64, 64)),
                              dtype=torch.float32),
            "b": torch.tensor(r.standard_normal((1000,)),
                              dtype=torch.float32)}


def _ring_worker(rank, world, rdv, out, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.common import MeshCtx
    from repro_torch.parallel.collectives import (compressed_allreduce_tree,
                                                  hierarchical_psum_tree)
    _init(rank, world, rdv)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    ctx = MeshCtx(mesh=mesh, batch_axes=names, model_axis=None)
    got = compressed_allreduce_tree(_ring_grads(), ctx)
    # the exact mean of what each rank holds, over every DP axis
    got["mean"] = hierarchical_psum_tree(
        {"x": [torch.full((3,), float(rank))]}, ctx)["x"][0]
    if rank == 0:
        torch.save(got, f"{out}/ring_{world}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_ring(tmp_path_factory):
    """The reference's ``compressed_allreduce_tree`` on 8 forced host
    devices: over ('data',) = 4 of them and over ('pod', 'data') = (2, 4);
    and what each device's shard_map body receives."""
    out = tmp_path_factory.mktemp("ring") / "ref.npz"
    code = "import os\nos.environ['XLA_FLAGS'] = " \
        "'--xla_force_host_platform_device_count=8'\n" + textwrap.dedent(f"""
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.models.common import MeshCtx
    from repro.parallel.collectives import compressed_allreduce_tree
    from repro.parallel.compat import shard_map
    r = np.random.default_rng(0)
    g = {{'a': jnp.asarray(r.standard_normal((64, 64)), jnp.float32),
         'b': jnp.asarray(r.standard_normal((1000,)), jnp.float32)}}
    dev = np.array(jax.devices())
    res = {{}}
    for tag, m, axes in (
            ('4', Mesh(dev[:4], ('data',)), ('data',)),
            ('8', Mesh(dev.reshape(2, 4), ('pod', 'data')), ('pod', 'data'))):
        ctx = MeshCtx(mesh=m, batch_axes=axes, model_axis=None)
        o = jax.jit(lambda t: compressed_allreduce_tree(t, ctx))(g)
        for k in o:
            res[f'{{tag}}_{{k}}'] = np.asarray(o[k])
    # what the ring's shard_map hands each device: its in_specs P(None,
    # None) give every one the whole (already reduced) array
    m = Mesh(dev[:4], ('data',))
    flat = jnp.arange(4 * 6, dtype=jnp.float32).reshape(4, 6)
    seen = shard_map(lambda x: x[None], mesh=m, in_specs=P(None, None),
                     out_specs=P('data', None, None), check_vma=False)(flat)
    res['seen'] = np.asarray(seen)
    res['flat'] = np.asarray(flat)
    np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("world,shape,names", [
    (4, (4,), ("data",)), (8, (2, 4), ("pod", "data"))])
def test_int8_ring_equals_the_reference(tmp_path, reference_ring, world,
                                        shape, names):
    _spawn(_ring_worker, world, tmp_path, shape, names, timeout=90)
    got = torch.load(tmp_path / f"ring_{world}.pt")
    torch.testing.assert_close(got.pop("mean"),
                               torch.full((3,), (world - 1) / 2))
    grads = _ring_grads()
    for k in grads:
        exp = reference_ring[f"{world}_{k}"]
        np.testing.assert_allclose(got[k].numpy(), exp, rtol=0, atol=1e-6)
    flat = torch.cat([grads["a"].reshape(-1), grads["b"]])
    out = torch.cat([got["a"].reshape(-1), got["b"]])
    n_ring = shape[-1]
    if world == 4:
        # lossy: the ring moved the mean of equal copies off it, within
        # the reference's bound
        err = (out - flat).abs().max()
        assert 0 < err <= flat.abs().max() / 127.0 * world + 1e-6
        return
    # the reference's two-axis form views the vector as (8, -1) but rings
    # over the inner axis of 4: chunks 4..7 are never summed, only divided
    # by 4 (ROADMAP Queue 3); the port computes the same
    pad = (-flat.numel()) % world
    view = torch.nn.functional.pad(flat, (0, pad)).reshape(world, -1)
    got_view = torch.nn.functional.pad(out, (0, pad)).reshape(world, -1)
    torch.testing.assert_close(got_view[n_ring:], view[n_ring:] / n_ring,
                               rtol=0, atol=0)
    err = (got_view[:n_ring] - view[:n_ring]).abs().max()
    assert 0 < err <= flat.abs().max() / 127.0 * n_ring + 1e-6


def test_the_reference_ring_receives_identical_copies(reference_ring):
    """Each device's block of the ring's input is the whole array the
    caller passed (the gradient XLA has already reduced), so the int8
    ring averages n equal copies (ROADMAP Queue 3)."""
    seen, flat = reference_ring["seen"], reference_ring["flat"]
    assert seen.shape == (4, *flat.shape)
    for i in range(4):
        np.testing.assert_array_equal(seen[i], flat)


# ============================================ (c) N ranks equal one process
def _model_worker(rank, world, rdv, out):
    import repro_torch.models.layers as layers
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import (distribute_tree, full_tree, make_ctx,
                                      param_spec_tree)
    from repro_torch.train import make_train_step
    _init(rank, world, rdv)
    res = {}
    mesh22 = make_local_mesh(2, "cpu")
    mesh14 = make_local_mesh(4, "cpu")

    def on(model, mesh, b=B):
        ctx = make_ctx(mesh, b)
        p = _params(model)
        return ctx, distribute_tree(p, param_spec_tree(p, mesh), mesh)

    # internlm2: the loss and one train step on (2, 2)
    cfg = _smoke(INTERNLM2)
    model = build_model(cfg)
    ctx, p = on(model, mesh22)
    batch = _batch(cfg)
    res["dense_loss"] = model.loss(p, batch, ctx=ctx).full_tensor()
    opt = AdamW()
    p, _, m = make_train_step(model, opt, ctx=ctx)(p, opt.init(p), batch)
    res["dense_step_loss"] = m["loss"]
    res["dense_step_params"] = full_tree(p)
    # qwen3-moe with ZeRO-3 experts on (2, 2)
    model = build_model(_no_drop(_smoke(QWEN3_MOE)))
    ctx, p = on(model, mesh22)
    res["moe_wg_placements"] = [str(x) for x in
                                p["blocks"][0]["moe"]["wg"].placements]
    calls = layers.MOE_MESH_CALLS[0]
    res["moe_loss"] = model.loss(p, _batch(model.cfg), ctx=ctx).full_tensor()
    res["moe_mesh_calls"] = layers.MOE_MESH_CALLS[0] - calls
    # deepseek's 7 heads over tp 2: the query sequence over 'model'
    model = build_model(_smoke(DEEPSEEK))
    ctx, p = on(model, mesh22)
    offsets, flash = [], layers.flash_attention

    def spy(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        return flash(*a, **kw)
    layers.flash_attention = spy
    try:
        res["seq_loss"] = model.loss(p, _batch(model.cfg),
                                     ctx=ctx).full_tensor()
    finally:
        layers.flash_attention = flash
    every = [None] * world
    dist.all_gather_object(every, offsets)
    res["seq_offsets"] = every
    # an odd prompt (15 rows, no split over 2): every head on every rank
    lg, _ = model.prefill(p, {"tokens": _batch(model.cfg, t=15)["tokens"]},
                          ctx=ctx)
    res["seq_odd_prefill"] = lg.full_tensor()
    # both recurrent families' forward on (2, 2)
    for arch in (XLSTM, RGEMMA):
        model = build_model(_smoke(arch))
        ctx, p = on(model, mesh22)
        res[f"fwd_{arch}"] = model.forward(p, _batch(model.cfg),
                                           ctx=ctx).full_tensor()
    # internlm2's decode over a cache whose S is split 4 ways, (1, 4)
    model = build_model(_smoke(INTERNLM2))
    ctx, p = on(model, mesh14, 2)
    toks = _batch(model.cfg, b=2, t=6)["tokens"]
    lg, cache = model.prefill(p, {"tokens": toks}, ctx=ctx, s_max=20)
    res["cache_k_placements"] = [str(x) for x in cache["k"].placements]
    steps = [lg.full_tensor()]
    for i in range(4):
        tok = steps[-1].argmax(-1)
        lg, cache = model.decode_step(p, cache, tok, np.full(2, 6 + i),
                                      ctx=ctx)
        steps.append(lg.full_tensor())
    res["decode_logits"] = torch.stack(steps)
    res["decode_pos"] = cache["pos"].full_tensor()
    if rank == 0:
        torch.save(res, f"{out}/model.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("model")
    _spawn(_model_worker, 4, out, timeout=150)
    return torch.load(out / "model.pt")


def test_dense_loss_and_train_step_on_a_mesh_equal_one_process(mesh_runs):
    from repro_torch.train import make_train_step
    model = build_model(_smoke(INTERNLM2))
    p, batch = _params(model), _batch(model.cfg)
    np.testing.assert_allclose(float(mesh_runs["dense_loss"]),
                               float(model.loss(p, batch)), rtol=RTOL)
    opt = AdamW()
    p, _, m = make_train_step(model, opt)(p, opt.init(p), batch)
    np.testing.assert_allclose(float(mesh_runs["dense_step_loss"]),
                               float(m["loss"]), rtol=RTOL)
    _assert_rows_close(mesh_runs["dense_step_params"], p)


def test_moe_with_zero3_experts_on_a_mesh_equals_one_process(mesh_runs):
    # the expert F axis is stored over 'data' (ZeRO-3) and E over 'model'
    assert mesh_runs["moe_wg_placements"] == ["S(2)", "S(0)"]
    assert mesh_runs["moe_mesh_calls"] == _smoke(QWEN3_MOE).n_layers
    model = build_model(_no_drop(_smoke(QWEN3_MOE)))
    np.testing.assert_allclose(
        float(mesh_runs["moe_loss"]),
        float(model.loss(_params(model), _batch(model.cfg))), rtol=RTOL)


def test_query_sharded_attention_equals_one_process(mesh_runs):
    """deepseek SMOKE has 7 heads: over a model axis of 2 the query
    sequence is split, the rows of model rank 1 (ranks 1 and 3 of the
    (2, 2) mesh) starting at position T / 2, one flash launch a layer."""
    cfg = _smoke(DEEPSEEK)
    assert cfg.n_heads % 2 and T % 2 == 0
    for rank, offsets in enumerate(mesh_runs["seq_offsets"]):
        assert offsets == [rank % 2 * T // 2] * cfg.n_layers, offsets
    model = build_model(_smoke(DEEPSEEK))
    p = _params(model)
    np.testing.assert_allclose(float(mesh_runs["seq_loss"]),
                               float(model.loss(p, _batch(model.cfg))),
                               rtol=RTOL)
    lg, _ = model.prefill(p, {"tokens": _batch(model.cfg, t=15)["tokens"]})
    _assert_rows_close(mesh_runs["seq_odd_prefill"], lg)


@pytest.mark.parametrize("arch", [XLSTM, RGEMMA])
def test_recurrent_forward_on_a_mesh_equals_one_process(mesh_runs, arch):
    model = build_model(_smoke(arch))
    exp = model.forward(_params(model), _batch(model.cfg))
    _assert_rows_close(mesh_runs[f"fwd_{arch}"], exp)


def test_decode_over_an_s_sharded_cache_equals_one_process(mesh_runs):
    """Prefill of 6 tokens into 20 slots split 4 ways (shards 2 and 3
    start empty: their log-sum-exp is -inf), then 4 decode steps; every
    new token lands in exactly one shard."""
    assert mesh_runs["cache_k_placements"] == ["S(1)",
                                               "S(2)"]
    model = build_model(_smoke(INTERNLM2))
    p = _params(model)
    toks = _batch(model.cfg, b=2, t=6)["tokens"]
    lg, cache = model.prefill(p, {"tokens": toks}, s_max=20)
    steps = [lg]
    for i in range(4):
        lg, cache = model.decode_step(p, cache, steps[-1].argmax(-1),
                                      np.full(2, 6 + i))
        steps.append(lg)
    _assert_rows_close(mesh_runs["decode_logits"], torch.stack(steps))
    assert torch.equal(mesh_runs["decode_pos"], cache["pos"])


# ============================================================ (d) elastic
def _elastic_worker(rank, world, rdv, out):
    from repro_torch.ckpt import CheckpointEngine, make_blockstore
    from repro_torch.ckpt.engine import join_save, receive_restore
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import (distribute_tree, full_tree, make_ctx,
                                      map_tree, param_spec_tree, placements)
    from repro_torch.train.loop import TrainConfig, Trainer
    _init(rank, world, rdv)
    res = {}
    model = build_model(get_config(INTERNLM2, smoke=True))
    params = _params(model)
    mesh_a = make_local_mesh(2, "cpu")
    p_a = distribute_tree(params, param_spec_tree(params, mesh_a), mesh_a)
    pool = f"{out}/pool.bin"
    if rank == 0:
        eng = CheckpointEngine(make_blockstore(pool, capacity_bytes=64 << 20))
        eng.save(0, p_a)
        eng.close()
    else:
        join_save(p_a)
    dist.barrier()
    for mp_ in (1, 4):                       # (4, 1) and (1, 4)
        mesh_b = make_local_mesh(mp_, "cpu")
        shape = model.param_shape()
        pl = map_tree(lambda path, stack, spec: placements(spec, mesh_b),
                      param_spec_tree(shape, mesh_b))
        with _held_bytes() as peak:
            if rank == 0:
                eng = CheckpointEngine(make_blockstore(
                    pool, capacity_bytes=64 << 20))
                tree, step = eng.restore(like=shape, device="cpu",
                                         placements=pl, mesh=mesh_b)
                eng.close()
            else:
                tree, step = receive_restore(shape, pl, mesh_b, "cpu")
        locs = _storage_bytes(t.to_local() for t in _leaves(tree))
        whole = [t.numel() * t.element_size() for t in _leaves(tree)]
        every = [None] * world
        dist.all_gather_object(every, (peak[0], locs, max(whole),
                                       sum(whole)))
        res[f"peak_{mp_}"] = every
        res[f"restored_{mp_}"] = (full_tree(tree), step, tuple(
            tree["blocks"][0]["attn"]["wq"].device_mesh.shape))
        dist.barrier()
    # a Trainer (f32): 3 steps on (2, 2) with a checkpoint, then resumed
    # to 5 on (4, 1); rank 0 holds the engine
    model = build_model(_smoke(INTERNLM2))
    src = SyntheticLM(256, seq=32, global_batch=8)
    eng = (CheckpointEngine(make_blockstore(f"{out}/pool2.bin",
                                            capacity_bytes=64 << 20))
           if rank == 0 else None)
    for steps, mp_ in ((3, 2), (5, 1)):
        tr = Trainer(model, AdamW(lr=1e-3), src, ckpt=eng,
                     cfg=TrainConfig(total_steps=steps, ckpt_every=100,
                                     async_ckpt=False), device="cpu",
                     ctx=make_ctx(make_local_mesh(mp_, "cpu"), 8))
        o = tr.run(torch.Generator().manual_seed(0))
        res[f"trainer_{steps}"] = (o["losses"], o["last_step"])
    if eng is not None:
        eng.close()
    if rank == 0:
        torch.save(res, f"{out}/elastic.pt")
    dist.destroy_process_group()


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@contextlib.contextmanager
def _held_bytes():
    """-> [peak]: the most bytes held at once by the tensors a restore
    broadcasts (each leaf whole) and the shards it keeps, read at every
    broadcast and every placement."""
    import weakref

    import repro_torch.ckpt.engine as engine
    live, peak = [], [0]
    bcast, place = dist.broadcast, engine.place

    def note(t):
        live.append(weakref.ref(t))
        peak[0] = max(peak[0], _storage_bytes(
            x for x in (r() for r in live) if x is not None))

    def spy_bcast(t, *a, **kw):
        note(t)
        return bcast(t, *a, **kw)

    def spy_place(t, pl, mesh):
        d = place(t, pl, mesh)
        note(d._local_tensor)
        return d

    dist.broadcast, engine.place = spy_bcast, spy_place
    try:
        yield peak
    finally:
        dist.broadcast, engine.place = bcast, place


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    _spawn(_elastic_worker, 4, out, timeout=150)
    return torch.load(out / "elastic.pt")


def test_checkpoint_saved_on_one_mesh_restores_onto_another(elastic_runs):
    params = _params(build_model(get_config(INTERNLM2, smoke=True)))
    for mp_, mesh_shape in ((1, (4, 1)), (4, (1, 4))):
        tree, step, shape = elastic_runs[f"restored_{mp_}"]
        assert step == 0 and shape == mesh_shape
        got, exp = _leaves(tree), _leaves(params)
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype and torch.equal(g, e)


def test_elastic_restore_holds_one_whole_leaf_at_a_time(elastic_runs):
    """No rank holds more than its shards and one whole leaf while it
    restores; on (1, 4) that is less than the whole state, which the
    restore never builds."""
    for mp_ in (1, 4):
        for peak, shards, leaf, state in elastic_runs[f"peak_{mp_}"]:
            assert 0 < peak <= shards + leaf, (mp_, peak, shards, leaf)
    assert all(shards + leaf < state for _, shards, leaf, state
               in elastic_runs["peak_4"])


def test_trainer_resumes_on_a_resized_mesh(elastic_runs):
    """3 steps on (2, 2), a checkpoint, 2 more on (4, 1): the losses
    continue the single-process run's (the data schedule is the step's)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train.loop import TrainConfig, Trainer
    model = build_model(_smoke(INTERNLM2))
    ref = Trainer(model, AdamW(lr=1e-3), SyntheticLM(256, seq=32,
                                                     global_batch=8),
                  cfg=TrainConfig(total_steps=5, ckpt_every=100),
                  device="cpu").run(torch.Generator().manual_seed(0))
    first, last1 = elastic_runs["trainer_3"]
    resumed, last2 = elastic_runs["trainer_5"]
    assert (last1, last2) == (2, 4)
    np.testing.assert_allclose(first, ref["losses"][:3], rtol=RTOL)
    np.testing.assert_allclose(resumed, ref["losses"][3:5], rtol=RTOL)


# ===================================================== (e) plain versions
def test_paged_plain_lse_is_the_log_sum_exp_of_the_scores():
    r = np.random.default_rng(0)
    Bq, H, Hkv, hd, page, maxp = 3, 4, 2, 16, 4, 3
    q = torch.tensor(r.standard_normal((Bq, H, hd)), dtype=torch.float32)
    k = torch.tensor(r.standard_normal((8, page, Hkv, hd)),
                     dtype=torch.float32)
    v = torch.tensor(r.standard_normal((8, page, Hkv, hd)),
                     dtype=torch.float32)
    table = torch.tensor([[5, 1, 2], [0, 7, 3], [4, 6, 1]], dtype=torch.int32)
    lens = torch.tensor([9, 0, 12], dtype=torch.int32)
    out, lse = paged_attention_ref(q, k, v, table, lens, return_lse=True)
    assert torch.equal(out, paged_attention_ref(q, k, v, table, lens))
    for b in range(Bq):
        n = int(lens[b])
        kb = k[table[b].long()].reshape(-1, Hkv, hd)[:n]
        kb = kb.repeat_interleave(H // Hkv, dim=1)
        s = torch.einsum("hd,shd->hs", q[b], kb) / math.sqrt(hd)
        exp = torch.logsumexp(s, dim=-1) if n else torch.full((H,),
                                                              -math.inf)
        torch.testing.assert_close(lse[b], exp, rtol=1e-6, atol=1e-6)
    assert bool((out[1] == 0).all())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_plain_q_offset_equals_the_reference_shifted(causal, window):
    """Query rows at positions off..off+t-1 against the reference's
    ``chunked_attention`` with that ``q_pos``; and the rows of the whole
    prompt's attention."""
    import jax.numpy as jnp
    from repro.models.layers import chunked_attention
    r = np.random.default_rng(1)
    Bq, S, H, Hkv, hd, t = 2, 24, 6, 2, 8, 8
    q = r.standard_normal((Bq, S, H, hd)).astype(np.float32)
    k = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    v = r.standard_normal((Bq, S, Hkv, hd)).astype(np.float32)
    whole = flash_attention_ref(*map(torch.tensor, (q, k, v)), causal=causal,
                                window=window)
    for off in (0, 8, 16):
        got = flash_attention_ref(torch.tensor(q[:, off:off + t]),
                                  torch.tensor(k), torch.tensor(v),
                                  causal=causal, window=window, q_offset=off)
        exp = chunked_attention(
            jnp.asarray(q[:, off:off + t]), jnp.asarray(k), jnp.asarray(v),
            q_pos=jnp.asarray(np.arange(off, off + t)[None].repeat(Bq, 0)),
            k_pos=jnp.asarray(np.arange(S)[None].repeat(Bq, 0)),
            causal=causal, window=window, dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got, whole[:, off:off + t], rtol=1e-5,
                                   atol=1e-5)
