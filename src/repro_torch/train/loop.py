"""The training loop, as ``repro.train.loop`` on one device.

  * **step watchdog / straggler log** — every step's wall time feeds an
    EMA after the first steps; a step slower than ``straggler_factor`` x
    the EMA is logged with its step index.
  * **preemption hook** — ``request_stop()`` finishes the step in flight
    and exits cleanly.
  * **deterministic data** — the ``Prefetcher`` issues the source's
    batches ``start_step, start_step + 1, ...``; a restart at step k needs
    only k.

Checkpoints (the reference's async Caiti-backed saves, crash/restart
resume and the final save at a stop) are ROADMAP Queue 1 item 1b: a
``Trainer`` given a checkpoint engine raises until then.  The save
points stay where the reference has them, in ``run``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.data import Prefetcher
from repro_torch.models.api import Model
from repro_torch.optim import AdamW, tree_leaves
from .step import make_train_step


@dataclass
class TrainConfig:
    """The reference's fields: ``ckpt_every`` and ``async_ckpt`` take
    effect with the checkpoint engine (item 1b); ``log_every`` is unused,
    as in the reference."""
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
    """``run`` trains from fresh parameters drawn on ``device`` (the card
    unless the caller asks for another)."""

    def __init__(self, model: Model, opt: AdamW, source, ckpt=None,
                 cfg: TrainConfig = TrainConfig(), device="cuda") -> None:
        if ckpt is not None:
            raise NotImplementedError(
                "checkpointing is ROADMAP Queue 1 item 1b (the checkpoint "
                "engine over TransitBuffer); pass ckpt=None")
        self.model = model
        self.opt = opt
        self.source = source
        self.cfg = cfg
        self.device = torch.device(device)
        self.step_fn = make_train_step(model, opt, accum=cfg.accum)
        self.history: list[StepStats] = []
        self.straggler_log: list[StepStats] = []
        self._stop = False
        self._ema_dt: float | None = None

    # ------------------------------------------------------------ lifecycle
    def restore_or_init(self, gen: torch.Generator) -> tuple:
        """Returns (params, opt_state, start_step): fresh parameters from
        ``gen``; a restore from ``ckpt`` is item 1b."""
        params = self.model.init(gen)
        return params, self.opt.init(params), 0

    def request_stop(self) -> None:
        self._stop = True

    # ----------------------------------------------------------------- run
    def run(self, gen: torch.Generator | None = None,
            max_steps: int | None = None) -> dict:
        """Trains to ``cfg.total_steps`` (at most ``max_steps`` more);
        ``gen`` None draws the parameters from seed 0 on ``device``."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        params, opt_state, start = self.restore_or_init(gen)
        dev = tree_leaves(params)[0].device
        total = min(self.cfg.total_steps,
                    start + (max_steps or self.cfg.total_steps))
        prefetch = Prefetcher(self.source, start_step=start)
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
                # item 1b: the periodic save, every cfg.ckpt_every steps
                if self._stop:
                    break
            # item 1b: the final save at the stop point
        finally:
            prefetch.close()
        return {"params": params, "opt_state": opt_state,
                "last_step": self.history[-1].step if self.history else -1,
                "losses": [s.loss for s in self.history],
                "stragglers": len(self.straggler_log)}
