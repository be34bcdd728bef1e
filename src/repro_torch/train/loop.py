"""The training loop, as ``repro.train.loop`` on one device.

  * **async Caiti-backed checkpointing** — ``CheckpointEngine.save_async``
    snapshots the state to the host and transits it to the block store
    while the next steps run; the commit is crash-atomic (BTT root flip).
  * **crash/restart** — ``Trainer.restore_or_init`` resumes the
    parameters, the optimizer state and the *data schedule* (the step
    number is enough: the pipeline is deterministic in the step).
  * **step watchdog / straggler log** — every step's wall time feeds an
    EMA after the first steps; a step slower than ``straggler_factor`` x
    the EMA is logged with its step index.
  * **preemption hook** — ``request_stop()`` finishes the step in flight,
    saves, and exits cleanly.
  * **deterministic data** — the ``Prefetcher`` issues the source's
    batches ``start_step, start_step + 1, ...``; a restart at step k needs
    only k.

The reference's elastic restore onto a mesh waits for the port's mesh
(ROADMAP Queue 1 item 4); the port restores onto ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.ckpt import CheckpointEngine
from repro_torch.data import Prefetcher
from repro_torch.models.api import Model
from repro_torch.optim import AdamW, tree_leaves
from .step import make_train_step


@dataclass
class TrainConfig:
    """The reference's fields: with a checkpoint engine, a save every
    ``ckpt_every`` steps, in the background if ``async_ckpt``;
    ``log_every`` is unused, as in the reference."""
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    accum: int = 1
    straggler_factor: float = 3.0
    async_ckpt: bool = True


@dataclass
class StepStats:
    step: int
    loss: float
    dt_s: float
    straggler: bool = False


class Trainer:
    """``run`` trains on ``device`` (the card unless the caller asks for
    another) from ``ckpt``'s latest checkpoint, or from fresh parameters
    where there is none."""

    def __init__(self, model: Model, opt: AdamW, source,
                 ckpt: CheckpointEngine | None = None,
                 cfg: TrainConfig = TrainConfig(), device="cuda") -> None:
        self.model = model
        self.opt = opt
        self.source = source
        self.ckpt = ckpt
        self.cfg = cfg
        self.device = torch.device(device)
        self.step_fn = make_train_step(model, opt, accum=cfg.accum)
        self.history: list[StepStats] = []
        self.straggler_log: list[StepStats] = []
        self._stop = False
        self._ema_dt: float | None = None

    # ------------------------------------------------------------ lifecycle
    def restore_or_init(self, gen: torch.Generator) -> tuple:
        """Returns (params, opt_state, start_step): the latest checkpoint's
        on ``device`` and the step after it, else fresh parameters from
        ``gen``.  The port has no ``param_shape`` (ROADMAP Queue 1 item
        5): fresh parameters and their zeroed state give the checkpoint
        its structure and dtypes, and are dropped."""
        params = self.model.init(gen)
        opt_state = self.opt.init(params)
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return params, opt_state, 0
        state, step = self.ckpt.restore(
            like={"params": params, "opt": opt_state}, device=self.device)
        return state["params"], state["opt"], step + 1

    def request_stop(self) -> None:
        self._stop = True

    # ----------------------------------------------------------------- run
    def run(self, gen: torch.Generator | None = None,
            max_steps: int | None = None) -> dict:
        """Trains to ``cfg.total_steps`` (at most ``max_steps`` more);
        ``gen`` None draws fresh parameters from seed 0 on ``device``."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        params, opt_state, start = self.restore_or_init(gen)
        dev = tree_leaves(params)[0].device
        total = min(self.cfg.total_steps,
                    start + (max_steps or self.cfg.total_steps))
        prefetch = Prefetcher(self.source, start_step=start)
        last_saved = start - 1
        try:
            for _ in range(start, total):
                step, batch = prefetch.next()
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                st = StepStats(step, loss, dt)
                # watchdog: EMA after warm-up (the first step builds the
                # kernels and warms the allocator)
                if self._ema_dt is None:
                    self._ema_dt = dt
                elif step > start + 1:
                    if dt > self.cfg.straggler_factor * self._ema_dt:
                        st.straggler = True
                        self.straggler_log.append(st)
                    self._ema_dt = 0.9 * self._ema_dt + 0.1 * dt
                self.history.append(st)
                if self.ckpt is not None and \
                        (step + 1) % self.cfg.ckpt_every == 0:
                    state = {"params": params, "opt": opt_state}
                    if self.cfg.async_ckpt:
                        self.ckpt.save_async(step, state)
                    else:
                        self.ckpt.save(step, state)
                    last_saved = step
                if self._stop:
                    break
            # final save (sync) so restarts land at the exact stop point
            if self.ckpt is not None and self.history and \
                    self.history[-1].step != last_saved:
                self.ckpt.wait()
                self.ckpt.save(self.history[-1].step,
                               {"params": params, "opt": opt_state})
        finally:
            prefetch.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "last_step": self.history[-1].step if self.history else -1,
                "losses": [s.loss for s in self.history],
                "stragglers": len(self.straggler_log)}
