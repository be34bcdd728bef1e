"""The port's checkpoint engine (``repro_torch.ckpt``) on the CPU, against
the JAX reference's (``repro.ckpt``).

The cases of ``tests/test_ckpt.py`` on the port (round trip, retention,
async, the int8 codec's error, a bf16 state, an uncommitted generation
after a reopen, the bump allocator, and a restore onto a named device in
place of ``shardings=``); the wire format: every arch's state gives the
reference's keys, shapes and dtypes, and one state saved by both engines
leaves the same keys and the same bytes under each (``MANIFEST``
included), raw and int8; checkpoints cross between the packages both
ways and the resumed losses equal an uninterrupted run's within rtol
1e-4; a reference bf16 checkpoint restores bit for bit with
``ml_dtypes`` unimportable; the snapshot is a copy that in-place updates
after ``save_async`` do not reach; a failing sink raises on ``wait()``.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jax_data
from repro.ckpt import CheckpointEngine as JaxEngine
from repro.ckpt import make_blockstore as jax_blockstore
from repro.ckpt.engine import _leaf_paths as jax_leaf_paths
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import Trainer as JaxTrainer
from repro_torch.ckpt import CheckpointEngine, make_blockstore
from repro_torch.ckpt.engine import _leaf_paths
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.models.transformer import params_from_jax, params_to_jax
from repro_torch.optim import AdamW, opt_state_from_jax, tree_leaves
from repro_torch.train.loop import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these SMOKE shapes gain nothing from more,
    and the test run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    """tests/test_ckpt.py's state, as tensors."""
    r = np.random.default_rng(seed)
    return {"w": {"a": torch.from_numpy(
                      r.standard_normal((64, 32)).astype(np.float32)),
                  "b": torch.from_numpy(
                      r.standard_normal((7,)).astype(np.float32))},
            "step": torch.tensor(5, dtype=torch.int32),
            "m": torch.from_numpy(
                r.standard_normal((1 << 14,)).astype(np.float32))}


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                    b.view(torch.int16) if b.dtype == torch.bfloat16 else b))


def _trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------ tests/test_ckpt.py's cases
def test_roundtrip_exact():
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    s = _state()
    eng.save(3, s)
    got, step = eng.restore(like=s, device="cpu")
    assert step == 3
    assert _trees_equal(got, s)
    assert int(got["step"]) == 5
    eng.close()


def test_latest_and_retention():
    eng = CheckpointEngine(make_blockstore(capacity_bytes=128 << 20), keep=2)
    for step in (1, 2, 3, 4):
        eng.save(step, _state(step))
    assert eng.list_steps() == [3, 4]
    got, step = eng.restore(like=_state(), device="cpu")
    assert step == 4
    assert torch.equal(got["m"], _state(4)["m"])
    # older generations GC'd from the directory
    assert not any(k.startswith("step0000000001/")
                   for k in eng.store.keys())
    eng.close()


def test_async_save_then_restore():
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    s = _state(9)
    eng.save_async(7, s)
    eng.wait()
    got, step = eng.restore(like=s, device="cpu")
    assert step == 7
    assert torch.equal(got["m"], s["m"])
    eng.close()


def test_int8_codec_bounded_error():
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20),
                           codec="int8")
    m = np.random.default_rng(0).standard_normal(1 << 13).astype(np.float32)
    s = {"m": torch.from_numpy(m)}
    eng.save(1, s)
    got, _ = eng.restore(like=s, device="cpu")
    err = np.abs(got["m"].numpy() - m).max()
    assert err <= np.abs(m).max() / 127.0 * 0.75
    eng.close()


def test_restore_with_a_bf16_state():
    """A (params, opt)-like tree with bf16 leaves, as the reference's
    ``test_restore_with_jax_state``: dtype and bits come back."""
    params = {"w": torch.ones((8, 8), dtype=torch.bfloat16) * 1.5,
              "b": torch.arange(4, dtype=torch.float32)}
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    eng.save(0, params)
    got, _ = eng.restore(like=params, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert _trees_equal(got, params)
    flat, _ = eng.restore()
    assert flat["w"].dtype == torch.bfloat16 and flat["b"].dtype == np.float32
    eng.close()


@pytest.mark.parametrize("device", ["meta", None])
def test_restore_onto_a_named_device(device):
    """In place of the reference's ``shardings=`` (a mesh, ROADMAP Queue 1
    item 4): ``device=`` places every leaf; None keeps each ``like``
    leaf's device; the default is the card."""
    params = {"w": torch.ones((16, 8)), "n": [torch.zeros(3),
                                             torch.ones(3)]}
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    eng.save(0, params)
    got, _ = eng.restore(like=params, device=device)
    assert all(t.device.type == (device or "cpu") for t in tree_leaves(got))
    assert got["w"].shape == (16, 8) and len(got["n"]) == 2
    if device is None:
        assert _trees_equal(got, params)
    assert inspect.signature(eng.restore).parameters["device"].default \
        == "cuda"
    eng.close()


def test_uncommitted_generation_invisible(tmp_path):
    pool = str(tmp_path / "pool.bin")
    s1 = _state(1)
    store = make_blockstore(pool, capacity_bytes=64 << 20)
    eng = CheckpointEngine(store)
    eng.save(0, s1)
    # stage step-1 objects WITHOUT commit, then 'crash'
    for k, v in _state(2).items():
        if isinstance(v, dict):
            continue
        store.put(f"step{1:010d}/{k}/0", v.numpy().tobytes())
    del eng, store
    eng2 = CheckpointEngine(make_blockstore(pool, capacity_bytes=64 << 20))
    got, step = eng2.restore(like=s1, device="cpu")
    assert step == 0
    assert torch.equal(got["m"], s1["m"])
    eng2.close()


def test_generation_bump_allocator_wraps():
    """Writing many generations beyond capacity reuses space after GC."""
    eng = CheckpointEngine(make_blockstore(capacity_bytes=16 << 20), keep=1)
    s = {"m": torch.zeros(1 << 18)}                # 1 MB
    for step in range(12):
        s["m"][:] = step
        eng.save(step, s)
    got, step = eng.restore(like=s, device="cpu")
    assert step == 11
    assert float(got["m"][0]) == 11.0
    eng.close()


# -------------------------------------------------------------- wire format
@pytest.mark.parametrize("arch", ARCHS)
def test_state_keys_shapes_and_dtypes_are_the_references(arch):
    """The port's (params, AdamW state) of every arch, stacked on the host
    by ``params_to_jax``, gives the reference's leaf keys in its flatten
    order, with its stacked shapes and dtypes; and, as the reference's
    numpy tree, unstacks back to the port's tree exactly
    (``params_from_jax``, ``opt_state_from_jax``)."""
    assert arch in JAX_ARCHS
    jm = jax_build_model(jax_config(arch, smoke=True))
    like = jm.param_shape()
    ref = jax_leaf_paths({"params": like,
                          "opt": jax.eval_shape(JaxAdamW().init, like)})
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    opt_state = AdamW().init(params)
    host = {"params": params_to_jax(params),
            "opt": params_to_jax(opt_state)}
    got = _leaf_paths(host)
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert got[0][0] == "opt/.step"
    for (key, t), (_, r) in zip(got, ref):
        assert tuple(t.shape) == r.shape, key
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), key
    host = _as_numpy(host)
    assert _trees_equal(params_from_jax(host["params"], cfg, "cpu"), params)
    back = opt_state_from_jax(host["opt"], cfg, "cpu")
    assert _trees_equal(back.m, opt_state.m) and int(back.step) == 0


def _as_numpy(x):
    """A host tree of ``params_to_jax``'s -> the reference's numpy tree
    (bf16 through ml_dtypes), its dict keys in their order."""
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*map(_as_numpy, x))
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(jnp.bfloat16)
    return x.numpy()


def _internlm2_state(seed=0):
    """internlm2 SMOKE in its default dtype (bf16 params, f32 norms) with
    non-zero f32 moments: the reference's tree (numpy, stacked) and the
    port's (tensors, per layer) from the same numbers."""
    cj = jax_config(ARCH, smoke=True)
    p = jax.tree.map(np.asarray,
                     jax_build_model(cj).init(jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    m = jax.tree.map(
        lambda a: r.standard_normal(a.shape).astype(np.float32), p)
    v = jax.tree.map(
        lambda a: np.abs(r.standard_normal(a.shape)).astype(np.float32), p)
    ref = {"params": p, "opt": JaxAdamWState(step=np.int32(3), m=m, v=v)}
    cfg = get_config(ARCH, smoke=True)
    port = {"params": params_from_jax(p, cfg, "cpu"),
            "opt": opt_state_from_jax(ref["opt"], cfg, "cpu")}
    return ref, port, cfg


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_same_bytes_as_the_reference(codec):
    ref, port, _ = _internlm2_state()
    assert any(str(a.dtype) == "bfloat16"
               for a in jax.tree.leaves(ref["params"]))
    a = JaxEngine(jax_blockstore(capacity_bytes=64 << 20), codec=codec)
    b = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20),
                         codec=codec)
    a.save(3, ref)
    b.save(3, port)
    keys = sorted(a.store.keys())
    assert keys == sorted(b.store.keys())
    assert "step0000000003/MANIFEST" in keys and "STEPS" in keys
    for k in keys:
        assert a.store.get(k) == b.store.get(k), k
    manifest = json.loads(b.store.get("step0000000003/MANIFEST"))
    assert next(iter(manifest)) == "opt/.step"
    assert (codec == "int8") == any(m["codec"] == "int8"
                                    for m in manifest.values())
    a.close()
    b.close()


@pytest.fixture(scope="module")
def reference_run():
    """The reference Trainer's uninterrupted 9 steps of internlm2 SMOKE in
    f32 (as ``tests/test_torch_train.py`` sets it up), and its init."""
    cj = jax_config(ARCH, smoke=True).with_(dtype=jnp.float32)
    jm = jax_build_model(cj)
    out = JaxTrainer(jm, JaxAdamW(lr=1e-3, total_steps=100),
                     jax_data.SyntheticLM(cj.vocab, seq=32, global_batch=4),
                     cfg=JaxTrainConfig(total_steps=9)).run(
                         jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return cj, jm, init, out["losses"]


def _jax_trainer(cj, jm, eng, steps, every):
    return JaxTrainer(jm, JaxAdamW(lr=1e-3, total_steps=100),
                      jax_data.SyntheticLM(cj.vocab, seq=32, global_batch=4),
                      ckpt=eng, cfg=JaxTrainConfig(total_steps=steps,
                                                   ckpt_every=every))


def _port_trainer(init, eng, steps, every):
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    model = dataclasses.replace(
        model, init=lambda gen: params_from_jax(init, cfg, gen.device))
    return Trainer(model, AdamW(lr=1e-3, total_steps=100),
                   SyntheticLM(cfg.vocab, seq=32, global_batch=4), ckpt=eng,
                   cfg=TrainConfig(total_steps=steps, ckpt_every=every),
                   device="cpu")


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, reference_run,
                                                 saver):
    """One package trains steps 0-5 with a checkpoint every 2 steps to a
    file store; the other reopens the file and resumes steps 6-8, whose
    losses equal the reference's uninterrupted run's within rtol 1e-4."""
    cj, jm, init, ref_losses = reference_run
    pool = str(tmp_path / "pool.bin")
    if saver == "jax":
        eng = JaxEngine(jax_blockstore(pool, capacity_bytes=64 << 20))
        out = _jax_trainer(cj, jm, eng, 6, 2).run(jax.random.PRNGKey(0))
    else:
        eng = CheckpointEngine(make_blockstore(pool, capacity_bytes=64 << 20))
        out = _port_trainer(init, eng, 6, 2).run()
    assert out["last_step"] == 5 and eng.latest_step() == 5
    eng.close()
    if saver == "jax":
        eng = CheckpointEngine(make_blockstore(pool, capacity_bytes=64 << 20))
        out = _port_trainer(init, eng, 9, 100).run()
    else:
        eng = JaxEngine(jax_blockstore(pool, capacity_bytes=64 << 20))
        out = _jax_trainer(cj, jm, eng, 9, 100).run(jax.random.PRNGKey(0))
    eng.close()
    assert out["last_step"] == 8 and len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], ref_losses[6:9], rtol=1e-4)


def test_bf16_restore_needs_no_ml_dtypes(tmp_path):
    """A bf16 checkpoint that the reference wrote restores into the port,
    bit for bit, in a process where ``ml_dtypes`` cannot be imported."""
    ref, _, _ = _internlm2_state(seed=1)
    pool = str(tmp_path / "pool.bin")
    eng = JaxEngine(jax_blockstore(pool, capacity_bytes=64 << 20))
    eng.save(4, ref)
    flat, _ = eng.restore()
    eng.close()
    bits = {k: (a.view(np.uint16) if str(a.dtype) == "bfloat16" else a)
            for k, a in flat.items()}
    assert any(str(a.dtype) == "bfloat16" for a in flat.values())
    np.savez(tmp_path / "expected.npz", **{k.replace("/", "|"): a
                                           for k, a in bits.items()})
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from repro_torch.ckpt import CheckpointEngine, make_blockstore
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.optim import AdamW
expected = np.load({str(tmp_path / "expected.npz")!r})
eng = CheckpointEngine(make_blockstore({pool!r}, capacity_bytes=64 << 20))
flat, step = eng.restore()
assert step == 4 and len(flat) == len(expected.files)
n_bf16 = 0
for key, got in flat.items():
    exp = expected[key.replace("/", "|")]
    if got.dtype == torch.bfloat16:
        n_bf16 += 1
        got = got.view(torch.int16).numpy().view(np.uint16)
    assert got.dtype == exp.dtype and np.array_equal(got, exp), key
params = build_model(get_config({ARCH!r}, smoke=True)).init(
    torch.Generator().manual_seed(0))
tree, _ = eng.restore(like={{"params": params, "opt": AdamW().init(params)}},
                      device="cpu")
params, opt = tree["params"], tree["opt"]
wq = expected["params|blocks|attn|wq"]
assert params["embed"].dtype == torch.bfloat16
assert np.array_equal(params["blocks"][1]["attn"]["wq"].view(torch.int16)
                      .numpy().view(np.uint16), wq[1])
assert int(opt.step) == 3
assert sys.modules["ml_dtypes"] is None
eng.close()
print("ok", n_bf16)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok" and int(out.stdout.split()[1]) > 0


def test_snapshot_isolation():
    """``save_async`` returns with its own copy: every leaf of the live
    state changed in place afterwards (as ``AdamW.update`` and
    ``apply_updates`` do), before the engine has serialized a byte,
    leaves the checkpoint holding the old values.  On the CPU
    ``.numpy()`` would alias the live tensors."""
    cfg = get_config(ARCH, smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    opt_state = AdamW().init(params)
    for t in tree_leaves(opt_state):
        t.add_(1)
    state = {"params": params, "opt": opt_state}
    before = [t.clone() for t in tree_leaves(state)]
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    gate, written = threading.Event(), []
    write = eng._write_state

    def gated_write(step, snapshot):
        gate.wait()
        written.append(step)
        write(step, snapshot)

    eng._write_state = gated_write
    eng.save_async(1, state)
    for t in tree_leaves(state):
        t.add_(1)
    assert written == []
    gate.set()
    eng.wait()
    assert written == [1]
    got, _ = eng.restore(like=state, device="cpu")
    assert all(_equal(a, b) for a, b in zip(tree_leaves(got), before))
    assert not any(_equal(a, b) for a, b in zip(tree_leaves(got),
                                                tree_leaves(state)))
    eng.close()


@pytest.mark.parametrize("mode", ["save_async", "save"])
def test_a_failing_sink_raises(mode):
    store = make_blockstore(capacity_bytes=64 << 20)

    def broken(key, payload):
        raise OSError("sink down")

    store.put = broken
    eng = CheckpointEngine(store)
    with pytest.raises(OSError, match="sink down"):
        getattr(eng, mode)(1, _state())
        eng.wait()
    assert eng.latest_step() is None
    eng.wait()                                   # reported once
    eng.close()
