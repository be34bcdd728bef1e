"""The port's training loop (``repro_torch.train.loop.Trainer``), its data
pipeline copy (``repro_torch.data``) and its launcher
(``repro_torch.launch.train``) on the CPU.

Every arch's SMOKE config, in its default dtype, overfits one batch in 8
steps of ``make_train_step``, as the reference's
``tests/test_models_smoke.py::test_train_step_improves_loss`` does; the
``Trainer``'s losses over 6 steps of internlm2 SMOKE in f32 equal the
reference ``Trainer``'s within rtol 1e-4 from the same parameters and
data; then the cases of ``tests/test_train_serve.py`` (runs and finite,
a crash-restart that resumes the exact schedule, a preemption stop that
saves), the straggler log, ``launch/train.py --ckpt`` and
``examples/train_e2e_torch.py`` run twice (the second run resumes), and
the pipeline's determinism, prefetch and host sharding on the copy.
"""
import dataclasses
import importlib.util
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jax_data
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import Trainer as JaxTrainer
from repro_torch.ckpt import CheckpointEngine, make_blockstore
from repro_torch.configs import ARCHS, get_config
import repro_torch.data as port_data
from repro_torch.data import MemmapCorpus, Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.api import build_model
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.train import make_train_step
from repro_torch.train.loop import TrainConfig, Trainer

B, T = 2, 32



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these SMOKE shapes gain nothing from more,
    and the test run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, rng=0):
    r = np.random.default_rng(rng)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = r.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = r.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_improves_loss(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-2, warmup_steps=1, total_steps=20, clip_norm=1.0)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    batch = _batch(cfg)
    losses = []
    for _ in range(8):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1]), arch
    # overfit one batch: loss must drop
    assert losses[-1] < losses[0], (arch, losses)
    assert all(t.dtype == cfg.dtype for t in tree_leaves(params)
               if t.dim() >= 2 and t.dtype != torch.float32)


def _setup(steps=6, device="cpu", ckpt=None, ckpt_every=3, **cfg_kw):
    """The reference test's setup (``tests/test_train_serve.py``), on the
    port."""
    cfg = get_config("internlm2-1.8b", smoke=True, **cfg_kw)
    model = build_model(cfg)
    opt = AdamW(lr=1e-3, total_steps=100)
    src = SyntheticLM(cfg.vocab, seq=32, global_batch=4)
    tr = Trainer(model, opt, src, ckpt=ckpt,
                 cfg=TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 async_ckpt=True),
                 device=device)
    return cfg, model, opt, src, tr


def test_trainer_losses_equal_the_reference_trainer():
    """6 steps of internlm2 SMOKE in f32 from the reference's init (the
    port's model draws it through ``params_from_jax``) over the same
    pipeline: the losses agree within rtol 1e-4."""
    cj = jax_config("internlm2-1.8b", smoke=True).with_(dtype=jnp.float32)
    jm = jax_build_model(cj)
    ref = JaxTrainer(jm, JaxAdamW(lr=1e-3, total_steps=100),
                     jax_data.SyntheticLM(cj.vocab, seq=32, global_batch=4),
                     cfg=JaxTrainConfig(total_steps=6)).run(
                         jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg, model, opt, src, _ = _setup(dtype=torch.float32)
    model = dataclasses.replace(
        model, init=lambda gen: params_from_jax(init, cfg, gen.device))
    out = Trainer(model, opt, src, cfg=TrainConfig(total_steps=6),
                  device="cpu").run()
    assert out["last_step"] == ref["last_step"] == 5
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)


def test_trainer_runs_and_losses_finite():
    *_, tr = _setup(steps=5)
    out = tr.run(torch.Generator().manual_seed(0))
    assert out["last_step"] == 4
    assert all(np.isfinite(x) for x in out["losses"])
    assert int(out["opt_state"].step) == 5
    assert all(t.grad is None for t in tree_leaves(out["params"]))


def test_trainer_crash_restart_resumes_exact_schedule():
    """Run 0..5 with checkpoints; 'crash'; resume must continue from the
    next step and see the same data batches (deterministic pipeline)."""
    eng = CheckpointEngine(make_blockstore(capacity_bytes=256 << 20))
    cfg, model, opt, src, tr = _setup(steps=6, ckpt=eng, ckpt_every=2)
    out1 = tr.run(torch.Generator().manual_seed(0))
    assert out1["last_step"] == 5 and eng.latest_step() == 5

    # full run without interruption, same seeds
    *_, tr_ref = _setup(steps=9)
    ref = tr_ref.run(torch.Generator().manual_seed(0))

    # resume the checkpointed trainer for 3 more steps
    tr2 = Trainer(model, opt, src, ckpt=eng,
                  cfg=TrainConfig(total_steps=9, ckpt_every=100),
                  device="cpu")
    out2 = tr2.run(torch.Generator().manual_seed(0))
    assert out2["last_step"] == 8
    # the resumed losses must match the uninterrupted run's steps 6..8
    np.testing.assert_allclose(out2["losses"], ref["losses"][6:9],
                               rtol=1e-4)
    assert int(out2["opt_state"].step) == 9
    eng.close()


def test_trainer_preemption_stop():
    """request_stop() during a step: that step finishes, the loop saves
    synchronously and exits."""
    eng = CheckpointEngine(make_blockstore(capacity_bytes=128 << 20))
    *_, tr = _setup(steps=50, ckpt=eng, ckpt_every=100)
    orig_fn = tr.step_fn
    calls = {"n": 0}

    def wrapped(*a):
        calls["n"] += 1
        if calls["n"] == 3:
            tr.request_stop()          # SIGTERM arrives mid-run
        return orig_fn(*a)

    tr.step_fn = wrapped
    out = tr.run(torch.Generator().manual_seed(0))
    assert out["last_step"] == 2 and len(out["losses"]) == 3
    assert eng.latest_step() == 2      # final sync save happened
    eng.close()


def test_straggler_log_records_an_injected_slow_step():
    *_, tr = _setup(steps=8)
    orig_fn = tr.step_fn
    calls = {"n": 0}
    slow = 5                            # step 5 sleeps

    def wrapped(*a):
        out = orig_fn(*a)
        if calls["n"] == slow:
            time.sleep(20 * tr._ema_dt + 0.5)
        calls["n"] += 1
        return out

    tr.step_fn = wrapped
    out = tr.run(torch.Generator().manual_seed(0))
    # the injected step is logged; a step slowed by a busy machine may be
    # logged beside it
    assert slow in [s.step for s in tr.straggler_log]
    assert out["stragglers"] == len(tr.straggler_log) \
        == sum(s.straggler for s in tr.history)
    assert tr.history[slow].straggler and not tr.history[0].straggler


def test_training_entry_points_default_to_the_card():
    import inspect
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert launch_train.build_parser().parse_args([]).device == "cuda"
    args = launch_train.build_parser().parse_args(["--full"])
    assert args.smoke is False
    assert launch_train.build_parser().parse_args(["--no-smoke"]).smoke \
        is False


def test_launch_train_with_ckpt_resumes_on_a_second_run(tmp_path, capsys):
    pool = str(tmp_path / "ckpt.pool")
    args = ["--device", "cpu", "--smoke", "--ckpt", pool, "--ckpt-every",
            "2", "--ckpt-policy", "caiti"]
    first = launch_train.main(args + ["--steps", "3"])
    assert first["last_step"] == 2
    second = launch_train.main(args + ["--steps", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert second["last_step"] == 4 and len(second["losses"]) == 2
    assert lines[-1].startswith("[train] arch=internlm2-1.8b steps->4 ")
    assert int(second["opt_state"].step) == 5
    eng = CheckpointEngine(make_blockstore(pool, capacity_bytes=2 << 30))
    assert eng.list_steps() == [2, 3, 4]       # keep 3: step 1 went
    eng.close()


def test_train_e2e_example_resumes(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_e2e_torch", Path(__file__).resolve().parents[1] / "examples"
        / "train_e2e_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    pool = ["--ckpt", str(tmp_path / "e2e.pool"), "--device", "cpu"]
    first = example.main(pool + ["--steps", "4"])
    second = example.main(pool + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert first["last_step"] == 3 and second["last_step"] == 5
    assert len(second["losses"]) == 2
    assert "[e2e] found checkpoint @ step 3 -> resuming" in out
    assert out.strip().splitlines()[-1].endswith("ckpt @ 5")


def test_launch_train_prints_the_train_line(capsys):
    out = launch_train.main(["--device", "cpu", "--smoke", "--steps", "3"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] arch=internlm2-1.8b steps->2 loss ")
    assert line.endswith("stragglers=0")
    assert len(out["losses"]) == 3
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))


# ------------------------------------------------------------ the pipeline
def test_data_pipeline_deterministic_and_prefetch():
    src = SyntheticLM(vocab=128, seq=16, global_batch=4, seed=7)
    a = src.batch_at(12)
    b = src.batch_at(12)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = src.batch_at(13)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # prefetcher yields consecutive steps from the start step
    pf = Prefetcher(src, start_step=5)
    s5, b5 = pf.next()
    s6, b6 = pf.next()
    pf.close()
    assert (s5, s6) == (5, 6)
    assert np.array_equal(b5["tokens"], src.batch_at(5)["tokens"])


def test_multihost_shards_disjoint_but_deterministic():
    h0 = SyntheticLM(vocab=128, seq=16, global_batch=8, seed=3,
                     n_hosts=2, host_id=0)
    h1 = SyntheticLM(vocab=128, seq=16, global_batch=8, seed=3,
                     n_hosts=2, host_id=1)
    b0, b1 = h0.batch_at(0), h1.batch_at(0)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    assert np.array_equal(b0["tokens"], h0.batch_at(0)["tokens"])


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_pipeline_copy_gives_the_reference_batches(source):
    tokens = np.random.default_rng(5).integers(0, 1000, 4096)
    make = {"synthetic": lambda m: m.SyntheticLM(512, 32, 4, seed=9),
            "memmap": lambda m: m.MemmapCorpus(tokens, 32, 4, seed=9)}[source]
    port, ref = make(port_data), make(jax_data)
    for step in (0, 1, 77):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys() == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == np.int32 and np.array_equal(a[k], b[k])
        assert np.array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert isinstance(port, (SyntheticLM, MemmapCorpus))
