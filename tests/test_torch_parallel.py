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
      experts, the query-sharded attention, the sequence-parallel train
      step on (2, 4), the S-sharded decode and both recurrent families,
      within rtol 1e-4 (parameters row by row);
  (d) the elastic restore: a checkpoint saved on (2, 2) restores bit for
      bit onto (4, 1) and (1, 4), each rank holding its shards and one
      whole leaf at a time, and a ``Trainer`` resumed on a resized
      mesh continues the single-process losses;
  (e) the new kernel arguments' plain versions: the paged attention's
      log-sum-exp, flash attention's ``q_offset``; the chunked
      whole-vocab NLL against ``torch.logsumexp``.

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
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode

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
WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-11b"
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
    """Tokens and targets (b, t), and whisper's frames."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, t)),
             "targets": r.integers(0, cfg.vocab, (b, t))}
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _params(model):
    """Seed-0 parameters, every ``xgate`` at 0.5 (0 at init would leave
    the cross-attention out of the output)."""
    p = model.init(torch.Generator().manual_seed(0))

    def gate(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "xgate":
                    t[k] = torch.full_like(v, 0.5)
                else:
                    gate(v)
        elif isinstance(t, list):
            for v in t:
                gate(v)
    gate(p)
    return p


class _GradSpy(AdamW):
    """AdamW that keeps, whole, the gradients each update is given."""

    def update(self, grads, *a, **kw):
        from repro_torch.parallel import full_tree
        self.grads = full_tree(grads)
        return super().update(grads, *a, **kw)


def _shards(cache, ctx) -> list:
    """(path, global shape, local shape, the global shape divided as
    ``cache_spec_tree`` says) of each leaf of a cache on a mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import cache_spec_tree, map_tree, mesh_shape
    sizes, out = mesh_shape(ctx.mesh), []

    def one(path, stack, t, spec):
        assert isinstance(t, DTensor), path
        div = [math.prod(sizes[a] for a in ((s,) if isinstance(s, str)
                                            else s or ()))
               for s in spec]
        out.append(("/".join(path), tuple(t.shape),
                    tuple(t.to_local().shape),
                    tuple(g // d for g, d in zip(t.shape, div))))
    map_tree(one, cache, cache_spec_tree(cache, ctx))
    return out


def _decode(model, p, ctx=None, b: int = B, t: int = 6, n: int = 3):
    """Greedy decode of n steps after a prompt of t tokens (with frames
    or patches for the cross-attention families) -> the logits of the
    prefill and of each step, whole.  On a mesh, each leaf of the
    prefill's cache holds only its rank's shard."""
    cfg = model.cfg
    r = np.random.default_rng(1)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, t))}
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        batch["image_embeds"] = r.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    whole = (lambda x: x.full_tensor()) if ctx is not None else \
        (lambda x: x)
    lg, cache = model.prefill(p, batch, s_max=t + n, ctx=ctx)
    if ctx is not None:
        for path, _, local, exp in _shards(cache, ctx):
            assert local == exp, path
    out = [whole(lg)]
    for i in range(n):
        lg, cache = model.decode_step(p, cache, out[-1].argmax(-1),
                                      np.full(b, t + i), ctx=ctx)
        out.append(whole(lg))
    return torch.stack(out)


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


def _assert_leaves_close(got, exp, tol=RTOL):
    """Every leaf as one vector: ||got - exp|| <= tol ||exp||.  For
    gradients, whose rows can be a single element near 0 (the sLSTM's
    ``rf`` is (H, dh, 1)): summed from each rank's part on a mesh, such an
    element keeps f32's absolute rounding but not its relative one."""
    got, exp = _leaves(got), _leaves(exp)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        err = float((g.double() - e.double()).norm())
        assert err <= tol * float(e.double().norm()), (tuple(e.shape), err)


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
# (name, arch, mesh, config overrides) of the vocab-parallel loss's cases
VOCAB_CASES = [("vocab14", INTERNLM2, "14", {}),
               ("vocab22", INTERNLM2, "22", {}),
               ("tied14", INTERNLM2, "14", {"tie_embeddings": True}),
               ("tied22", INTERNLM2, "22", {"tie_embeddings": True}),
               ("rg14", RGEMMA, "14", {}), ("xl14", XLSTM, "14", {}),
               ("v250", INTERNLM2, "14", {"vocab": 250})]


class _Widest(TorchDispatchMode):
    """The widest last axis of any 3-D tensor an op returns on this rank
    (DTensor ops pass down to their local ops), forward and backward.
    The fake tensors of DTensor's shape propagation hold no memory and
    are not counted."""

    def __init__(self):
        super().__init__()
        self.widest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim() == 3 \
                    and not is_fake(t):
                self.widest = max(self.widest, t.shape[-1])
        return out


def _nll_inputs(b: int = 2, t: int = 8, v: int = 256):
    """Logits (b, t, v) f32 with rows scaled past exp's f32 range, targets
    in every quarter of the vocab, and weights for the NLL's sum."""
    r = np.random.default_rng(3)
    lg = r.standard_normal((b, t, v)).astype(np.float32) * np.float32(40.0)
    tg = r.integers(0, v, (b, t))
    tg[0, :4] = np.arange(4) * (v // 4) + 1
    return lg, tg, r.standard_normal((b, t)).astype(np.float32)


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
        n = len(offsets)
        # a prompt of T rows: prefill keeps the tensor-parallel blocks,
        # their attention query-sharded (``mesh_attention``'s by-row
        # branch)
        lg, _ = model.prefill(p, {"tokens": _batch(model.cfg)["tokens"]},
                              ctx=ctx)
        res["seq_prefill"] = lg.full_tensor()
    finally:
        layers.flash_attention = flash
    every = [None] * world
    dist.all_gather_object(every, (offsets[:n], offsets[n:]))
    res["seq_offsets"] = [o for o, _ in every]
    res["seq_prefill_offsets"] = [o for _, o in every]
    # an odd prompt (15 rows, no split over 2): 8 query rows a rank, the
    # last rank's padded by one
    lg, _ = model.prefill(p, {"tokens": _batch(model.cfg, t=15)["tokens"]},
                          ctx=ctx)
    res["seq_odd_prefill"] = lg.full_tensor()
    # both recurrent families on (2, 2): the forward, a greedy decode
    # after a prefill, and a train step's gradients
    for arch in (XLSTM, RGEMMA):
        model = build_model(_smoke(arch))
        ctx, p = on(model, mesh22)
        batch = _batch(model.cfg)
        res[f"fwd_{arch}"] = model.forward(p, batch, ctx=ctx).full_tensor()
        res[f"dec_{arch}"] = _decode(model, p, ctx)
        opt = _GradSpy()
        _, _, m = make_train_step(model, opt, ctx=ctx)(p, opt.init(p), batch)
        res[f"step_loss_{arch}"] = m["loss"]
        res[f"grads_{arch}"] = opt.grads
    # the cross-attention families' greedy decode on (2, 2)
    for arch in (WHISPER, VISION):
        model = build_model(_smoke(arch))
        ctx, p = on(model, mesh22)
        res[f"dec_{arch}"] = _decode(model, p, ctx)
    # the vocab-parallel loss: one train step's loss and gradients on
    # (1, 4) and (2, 2), the head untied and tied (``embed.T``), the
    # recurrent families on (1, 4) (on (2, 2) above), a vocab of 250 that
    # 4 does not divide; and the widest 3-D tensor a rank holds meanwhile
    for name, arch, mesh, kw in VOCAB_CASES:
        model = build_model(_smoke(arch, **kw))
        ctx, p = on(model, {"14": mesh14, "22": mesh22}[mesh])
        opt = _GradSpy()
        with _Widest() as w:
            _, _, m = make_train_step(model, opt, ctx=ctx)(
                p, opt.init(p), _batch(model.cfg))
        res[f"{name}_loss"] = m["loss"]
        res[f"{name}_grads"] = opt.grads
        res[f"{name}_widest"] = w.widest
    # ``token_nll`` alone on (1, 4): logits split over the vocab (the
    # rows past +-88 overflow exp without the max), weighted NLL's
    # gradient
    from repro_torch.models.layers import token_nll
    lg, tg, wt = _nll_inputs()
    ctx = make_ctx(mesh14, lg.shape[0])
    x = distribute_tree({"x": torch.from_numpy(lg)}, {"x": (None, None,
                                                            "model")},
                        mesh14)["x"].requires_grad_(True)
    nll = token_nll(x, tg, ctx).full_tensor()
    (nll * torch.from_numpy(wt)).sum().backward()
    res["nll_placements"] = [str(q) for q in x.placements]
    res["nll"] = nll.detach()
    res["nll_grad"] = x.grad.full_tensor()
    # internlm2's decode over a cache whose S is split 4 ways, (1, 4)
    model = build_model(_smoke(INTERNLM2))
    ctx, p = on(model, mesh14, 2)
    toks = _batch(model.cfg, b=2, t=6)["tokens"]
    lg, cache = model.prefill(p, {"tokens": toks}, ctx=ctx, s_max=20)
    res["cache_k_placements"] = [str(x) for x in cache["k"].placements]
    res["cache_shards"] = _shards(cache, ctx)
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


@pytest.mark.parametrize("name,arch,mesh,kw", VOCAB_CASES,
                         ids=[c[0] for c in VOCAB_CASES])
def test_vocab_parallel_loss_and_gradients_equal_one_process(
        mesh_runs, name, arch, mesh, kw):
    """One train step's loss and every parameter's gradient (the
    embedding's and the head's included) against one process, within
    rtol 1e-4.  Where the model axis divides V no rank holds a tensor as
    wide as the vocab: its widest 3-D tensor is its shard of the logits
    or narrower.  V = 250 over 4 takes the whole path (the logits whole
    over ``model``)."""
    from repro_torch.train import make_train_step
    model = build_model(_smoke(arch, **kw))
    p, batch = _params(model), _batch(model.cfg)
    opt = _GradSpy()
    _, _, m = make_train_step(model, opt)(p, opt.init(p), batch)
    np.testing.assert_allclose(float(mesh_runs[f"{name}_loss"]),
                               float(m["loss"]), rtol=RTOL)
    _assert_leaves_close(mesh_runs[f"{name}_grads"], opt.grads)
    V, tp = model.cfg.vocab, int(mesh[1])
    if V % tp:
        assert mesh_runs[f"{name}_widest"] == V
    else:
        assert mesh_runs[f"{name}_widest"] < V


def test_token_nll_over_vocab_shards_equals_the_reference_arithmetic(
        mesh_runs):
    """``token_nll`` of logits split over the vocab on (1, 4), and the
    gradient of a weighted sum of it, against the reference's
    ``lm_loss`` arithmetic (``jax.nn.logsumexp`` less
    ``take_along_axis``) on the same numpy inputs."""
    import jax
    import jax.numpy as jnp
    lg, tg, wt = _nll_inputs()

    def nll(x):
        return jax.nn.logsumexp(x, axis=-1) - jnp.take_along_axis(
            x, jnp.asarray(tg)[..., None], axis=-1)[..., 0]
    exp = np.asarray(nll(jnp.asarray(lg)))
    grad = np.asarray(jax.grad(lambda x: (nll(x) * wt).sum())(
        jnp.asarray(lg)))
    assert mesh_runs["nll_placements"] == ["R", "S(2)"]
    np.testing.assert_allclose(mesh_runs["nll"].numpy(), exp, rtol=RTOL)
    np.testing.assert_allclose(mesh_runs["nll_grad"].numpy(), grad,
                               rtol=RTOL, atol=RTOL * np.abs(grad).max())


def test_one_rank_mesh_train_steps_equal_off_mesh_bit_for_bit(tmp_path):
    """phi3 SMOKE bf16, two train steps on a one-rank mesh (a model axis
    of 1: the loss runs ``vocab_nll`` over one shard) against two off it:
    the same losses and parameters bit for bit, as chip_smoke's phase 20
    holds on the card.  The NLL's arithmetic is ``torch.logsumexp``'s;
    any other order of the same sums moves bf16 parameters after AdamW's
    normalised steps."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import tree_map
    from repro_torch.parallel import (distribute_tree, full_tree, make_ctx,
                                      param_spec_tree)
    from repro_torch.train import make_train_step
    cfg = get_config("phi3-mini-3.8b", smoke=True, dtype=torch.bfloat16)
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (B, 4 * T), generator=g)
                for k in ("tokens", "targets")} for _ in range(2)]
    opt = AdamW()
    p_off = tree_map(torch.clone, p)
    s_off = opt.init(p_off)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, "cpu")
        pd = distribute_tree(p, param_spec_tree(p, mesh), mesh)
        sd = opt.init(pd)
        off = make_train_step(model, opt)
        on = make_train_step(model, opt, ctx=make_ctx(mesh, B))
        for b in batches:
            p_off, s_off, m_off = off(p_off, s_off, b)
            pd, sd, m_on = on(pd, sd, b)
            assert float(m_on["loss"]) == float(m_off["loss"])
        got = full_tree(pd)
    finally:
        dist.destroy_process_group()
    for a, e in zip(_leaves(got), _leaves(p_off)):
        assert torch.equal(a, e)


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


def test_query_sharded_prefill_equals_one_process(mesh_runs):
    """deepseek SMOKE's prefill of T rows on (2, 2): each block's attention
    takes the query rows of its model rank (``mesh_attention``'s by-row
    branch, one flash launch a layer at ``q_offset`` rank * T / 2) and
    the logits equal one process's."""
    cfg = _smoke(DEEPSEEK)
    for rank, offsets in enumerate(mesh_runs["seq_prefill_offsets"]):
        assert offsets == [rank % 2 * T // 2] * cfg.n_layers, offsets
    model = build_model(cfg)
    lg, _ = model.prefill(_params(model),
                          {"tokens": _batch(model.cfg)["tokens"]})
    _assert_rows_close(mesh_runs["seq_prefill"], lg)


# (name, arch, config overrides) of the sequence-parallel train step on
# (2, 4): deepseek's 7 heads; whisper at 6 heads (its decoder's blocks
# with cross-attention) and a vocab of 250 that 4 does not divide (the
# head whole over ``model``, each rank's own rows' logits and NLL)
SEQ_CASES = [("deepseek", DEEPSEEK, {}),
             ("whisper", WHISPER, {"n_heads": 6, "n_kv_heads": 6,
                                   "head_dim": 16, "vocab": 250})]


def _seq_worker(rank, world, rdv, out):
    import repro_torch.models.layers as layers
    import repro_torch.models.transformer as transformer
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import (distribute_tree, full_tree, make_ctx,
                                      param_spec_tree)
    from repro_torch.train import make_train_step
    _init(rank, world, rdv)
    mesh = make_local_mesh(4, "cpu")
    res, block_rows = {}, transformer.block_rows
    flash = layers.flash_attention
    for name, arch, kw in SEQ_CASES:
        model = build_model(_smoke(arch, **kw))
        p = _params(model)
        p = distribute_tree(p, param_spec_tree(p, mesh), mesh)
        residual, full = [], []

        def spy(*a, **k):
            y = block_rows(*a, **k)
            residual.append([str(x) for x in y.placements])
            return y

        def flash_spy(q, k, v, **kw):
            # the mesh's full (non-causal) attention: whisper's encoder
            if not kw.get("causal", True):
                full.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
            return flash(q, k, v, **kw)
        transformer.block_rows = spy
        layers.flash_attention = flash_spy
        try:
            opt = _GradSpy()
            p, _, m = make_train_step(model, opt, ctx=make_ctx(mesh, B))(
                p, opt.init(p), _batch(model.cfg))
        finally:
            transformer.block_rows = block_rows
            layers.flash_attention = flash
        every = [None] * world
        dist.all_gather_object(every, full)
        res[f"{name}_full_attention"] = every
        res[f"{name}_loss"] = m["loss"]
        res[f"{name}_grads"] = opt.grads
        res[f"{name}_params"] = full_tree(p)
        res[f"{name}_residual"] = residual
    if rank == 0:
        torch.save(res, f"{out}/seq.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq")
    _spawn(_seq_worker, 8, out, timeout=150)
    return torch.load(out / "seq.pt")


@pytest.mark.parametrize("name,arch,kw", SEQ_CASES,
                         ids=[c[0] for c in SEQ_CASES])
def test_sequence_parallel_train_step_equals_one_process(seq_runs, name,
                                                         arch, kw):
    """One train step on (2, 4) where the heads do not divide the model
    axis: every block runs on its rank's rows (``block_rows``), its
    output, the residual, split over the batch and T, (S(0), S(1)) (the
    recompute under remat "dots" may stop early, inside the block);
    whisper's encoder, whose 30 frames the axis does not divide, keeps
    the tensor-parallel layout with its attention split by query rows
    (``layers.mesh_attention``); the loss, every gradient and the
    AdamW-updated parameters against one process."""
    from repro_torch.train import make_train_step
    model = build_model(_smoke(arch, **kw))
    cfg = model.cfg
    assert cfg.n_heads % 4 and T % 4 == 0
    residual = seq_runs[f"{name}_residual"]
    assert len(residual) >= cfg.n_layers
    assert {tuple(r) for r in residual} == {("S(0)", "S(1)")}
    # whisper's encoder (30 frames, 4 ranks of ``model``): each layer's
    # attention on the rank's 8 query rows against K/V whole, rows
    # rank * 8 on (the last rank's 6 padded to 8), no rank on all 30
    for rank, full in enumerate(seq_runs[f"{name}_full_attention"]):
        if not cfg.enc_layers:
            assert full == []
            continue
        n = -(-cfg.enc_seq // 4)
        assert n < cfg.enc_seq and len(full) >= cfg.enc_layers
        assert set(full) == {(n, cfg.enc_seq, rank % 4 * n)}, full
    p, batch = _params(model), _batch(cfg)
    opt = _GradSpy()
    p, _, m = make_train_step(model, opt)(p, opt.init(p), batch)
    np.testing.assert_allclose(float(seq_runs[f"{name}_loss"]),
                               float(m["loss"]), rtol=RTOL)
    _assert_leaves_close(seq_runs[f"{name}_grads"], opt.grads)
    _assert_rows_close(seq_runs[f"{name}_params"], p)


@pytest.mark.parametrize("arch", [XLSTM, RGEMMA])
def test_recurrent_forward_on_a_mesh_equals_one_process(mesh_runs, arch):
    """The forward, a prefill and 3 decode steps (the state sharded on
    its channels as ``cache_spec_tree`` places it), and one train step's
    loss and gradients: the mixers split over ``model``.  The gradients
    are held leaf by leaf (``_assert_leaves_close``): the sLSTM's
    forget-gate gradients sum each rank's parts, which nearly cancel."""
    from repro_torch.train import make_train_step
    model = build_model(_smoke(arch))
    p, batch = _params(model), _batch(model.cfg)
    _assert_rows_close(mesh_runs[f"fwd_{arch}"], model.forward(p, batch))
    exp = _decode(model, p)
    _assert_rows_close(mesh_runs[f"dec_{arch}"], exp)
    assert torch.equal(mesh_runs[f"dec_{arch}"].argmax(-1), exp.argmax(-1))
    opt = _GradSpy()
    _, _, m = make_train_step(model, opt)(p, opt.init(p), batch)
    np.testing.assert_allclose(float(mesh_runs[f"step_loss_{arch}"]),
                               float(m["loss"]), rtol=RTOL)
    _assert_leaves_close(mesh_runs[f"grads_{arch}"], opt.grads)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_cross_attention_decode_on_a_mesh_equals_one_process(mesh_runs,
                                                             arch):
    """The decode's cross-attention split by heads over ``model`` (its
    cache whole there): the same logits and greedy tokens as one
    process."""
    model = build_model(_smoke(arch))
    exp = _decode(model, _params(model))
    _assert_rows_close(mesh_runs[f"dec_{arch}"], exp)
    assert torch.equal(mesh_runs[f"dec_{arch}"].argmax(-1), exp.argmax(-1))


def _mixer_flops(arch: str, fn_name: str, tp: int, on_mesh: bool) -> float:
    """OpCost's FLOPs of one recurrent mixer over (2, 16, d), off a mesh
    or on rank 0 of a fake (1, tp) mesh (nothing is computed: the
    collectives of the ``fake`` backend move no bytes)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import repro_torch.models.rglru as rg
    import repro_torch.models.xlstm as xl
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.layers import mesh_scope, model_shard
    from repro_torch.parallel import distribute_tree, make_ctx, param_spec_tree
    cfg = _smoke(arch)
    p = _params(build_model(cfg))
    p = p["tail0"]["rec"] if arch == RGEMMA else \
        p["groups"][0]["m" if fn_name == "mlstm" else "s"]
    if arch == XLSTM and fn_name == "mlstm":
        p = p[0]
    x = torch.randn(2, T, cfg.d_model)
    off = {"rec": rg.rec_mixer_apply, "mlstm": xl.mlstm_apply,
           "slstm": xl.slstm_apply}[fn_name]
    if not on_mesh:
        with OpCost() as c:
            off(x, p, cfg)
        return c.totals()["flops"]
    mesh_fn = {"rec": rg.rec_mixer_mesh, "mlstm": xl.mlstm_mesh,
               "slstm": xl.slstm_mesh}[fn_name]
    dist.init_process_group("fake", rank=0, world_size=tp, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (1, tp),
                                mesh_dim_names=("data", "model"))
        ctx = make_ctx(mesh, 2)
        wide = cfg.lru_width or cfg.d_model if fn_name == "rec" \
            else cfg.d_model // cfg.n_heads
        sh = model_shard(ctx, wide)
        assert sh is not None and sh.size == tp
        p = distribute_tree({"p": p}, param_spec_tree({"p": p}, mesh),
                            mesh)["p"]
        with mesh_scope(ctx), OpCost() as c:
            mesh_fn(x, p, cfg, None, ctx, sh)
        return c.totals()["flops"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,fn_name", [(RGEMMA, "rec"), (XLSTM, "mlstm"),
                                          (XLSTM, "slstm")])
def test_a_rank_computes_its_share_of_a_mixer(arch, fn_name):
    """Rank 0 of a (1, 4) mesh counts 1/4 of the mixer's products off the
    mesh.  The sLSTM also runs whole, on every rank, what the
    reference's rules keep whole: its recurrence (2 T H dh (dh + 2) a
    row) and its input and forget gates, whose (d, H) weights do not
    split over 4 (2 T d 2H a row)."""
    tp, cfg = 4, _smoke(arch)
    off = _mixer_flops(arch, fn_name, tp, False)
    got = _mixer_flops(arch, fn_name, tp, True)
    whole = 0.0
    if fn_name == "slstm":
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        assert H % tp
        whole = 2 * (2.0 * T * H * dh * (dh + 2) + 2.0 * T * d * 2 * H)
    assert got == pytest.approx((off - whole) / tp + whole, rel=1e-9)


def test_decode_over_an_s_sharded_cache_equals_one_process(mesh_runs):
    """Prefill of 6 tokens into 20 slots split 4 ways (shards 2 and 3
    start empty: their log-sum-exp is -inf), then 4 decode steps; every
    new token lands in exactly one shard."""
    assert mesh_runs["cache_k_placements"] == ["S(1)",
                                               "S(2)"]
    # each leaf of the prefill's cache is a DTensor holding its rank's
    # shard: k, v and pos split 4 ways over S
    shards = mesh_runs["cache_shards"]
    assert [p for p, *_ in shards] == ["k", "v", "pos"]
    for path, glob, local, exp in shards:
        assert local == exp, path
        assert local[2] * 4 == glob[2] == 20, path
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


@pytest.mark.parametrize("rows", [0, 7])
def test_the_chunked_whole_vocab_nll_equals_logsumexp_less_gold(
        rows, monkeypatch):
    """``layers.whole_nll`` at a vocab of 32767 over 3 x 50 rows, in chunks
    that divide neither (the default ``NLL_CHUNK``, 512 rows, and one of
    7 rows' elements, ``rows``): its value and the gradient of a weighted
    sum of it against ``torch.logsumexp(l) - l[target]`` and its
    autograd, within rtol 1e-6 in f32 (logits scaled past exp's f32
    range)."""
    from repro_torch.models import layers
    V = 32767
    if rows:
        monkeypatch.setattr(layers, "NLL_CHUNK", rows * V)
    lg, tg, wt = (torch.from_numpy(a) for a in _nll_inputs(3, 50, V))
    assert 150 % (layers.NLL_CHUNK // V)
    got_x = lg.clone().requires_grad_(True)
    got = layers.whole_nll(got_x, tg)
    (got * wt).sum().backward()
    exp_x = lg.clone().requires_grad_(True)
    exp = torch.logsumexp(exp_x, dim=-1) - exp_x.gather(
        -1, tg[..., None])[..., 0]
    (exp * wt).sum().backward()
    torch.testing.assert_close(got, exp, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_x.grad, exp_x.grad, rtol=1e-6,
                               atol=1e-6 * float(exp_x.grad.abs().max()))
