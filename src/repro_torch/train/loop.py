"""The training loop, as ``repro.train.loop``, on one device or a mesh.

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

On a mesh (``ctx``) every rank runs the same loop over the whole batch
(the model shards it); the parameters and moments are DTensors of the
parameters' placements.  Rank 0 holds the checkpoint engine and the other
ranks ``ckpt=None``: they take part in each save's gathers
(``ckpt.join_save``) and receive the restored leaves
(``ckpt.receive_restore``), so a run resumes on a mesh of another shape
than the one that saved it (the reference's elastic restore).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.ckpt import CheckpointEngine
from repro_torch.ckpt.engine import join_save, receive_restore
from repro_torch.data import Prefetcher
from repro_torch.models.api import Model
from repro_torch.models.layers import on_mesh
from repro_torch.optim import AdamW, AdamWState, tree_leaves
from repro_torch.parallel.collectives import broadcast_object
from repro_torch.parallel.sharding import (distribute_tree, map_tree,
                                           param_spec_tree, placements)
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
    where there is none; on the mesh of ``ctx`` where it has one."""

    def __init__(self, model: Model, opt: AdamW, source,
                 ckpt: CheckpointEngine | None = None,
                 cfg: TrainConfig = TrainConfig(), device="cuda",
                 ctx=None) -> None:
        self.model = model
        self.opt = opt
        self.source = source
        self.ckpt = ckpt
        self.cfg = cfg
        self.device = torch.device(device)
        self.ctx = ctx
        self.step_fn = make_train_step(model, opt, ctx=ctx, accum=cfg.accum)
        self.history: list[StepStats] = []
        self.straggler_log: list[StepStats] = []
        self._stop = False
        self._ema_dt: float | None = None

    # ------------------------------------------------------------ lifecycle
    def _shared(self, value):
        """Rank 0's ``value`` on every rank of a mesh's world."""
        return broadcast_object(value) if on_mesh(self.ctx) else value

    def restore_or_init(self, gen: torch.Generator) -> tuple:
        """Returns (params, opt_state, start_step): the latest checkpoint's
        on ``device`` and the step after it, else fresh parameters from
        ``gen``.  ``Model.param_shape`` (meta tensors) gives the
        checkpoint its structure and dtypes, so nothing but the restored
        state is allocated.  On a mesh the leaves are DTensors of the
        parameters' placements (the moments' too), wherever the
        checkpoint was saved."""
        latest = self._shared(None if self.ckpt is None
                              else self.ckpt.latest_step())
        mesh = self.ctx.mesh if on_mesh(self.ctx) else None
        if latest is None:
            params = self.model.init(gen)
            if mesh is not None:
                params = distribute_tree(params, param_spec_tree(params, mesh),
                                         mesh)
            return params, self.opt.init(params), 0
        shape = self.model.param_shape()
        like = {"params": shape, "opt": self.opt.init(shape)}
        if mesh is None:
            state, step = self.ckpt.restore(like=like, device=self.device)
            return state["params"], state["opt"], step + 1
        pl = map_tree(lambda path, stack, spec: placements(spec, mesh),
                      param_spec_tree(shape, mesh))
        pl = {"params": pl, "opt": AdamWState(step=None, m=pl, v=pl)}
        if self.ckpt is not None:
            state, step = self.ckpt.restore(like=like, device=self.device,
                                            placements=pl, mesh=mesh)
        else:
            state, step = receive_restore(like, pl, mesh, self.device)
        return state["params"], state["opt"], step + 1

    def request_stop(self) -> None:
        self._stop = True

    def _save(self, step: int, state: dict, background: bool) -> None:
        if self.ckpt is None:
            join_save(state)
        elif background:
            self.ckpt.save_async(step, state)
        else:
            self.ckpt.save(step, state)

    # ----------------------------------------------------------------- run
    def run(self, gen: torch.Generator | None = None,
            max_steps: int | None = None) -> dict:
        """Trains to ``cfg.total_steps`` (at most ``max_steps`` more);
        ``gen`` None draws fresh parameters from seed 0 on ``device``."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        params, opt_state, start = self.restore_or_init(gen)
        dev = tree_leaves(params)[0].device
        # on a mesh every rank joins the saves of rank 0's engine
        saving = self._shared(self.ckpt is not None)
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
                if saving and (step + 1) % self.cfg.ckpt_every == 0:
                    self._save(step, {"params": params, "opt": opt_state},
                               self.cfg.async_ckpt)
                    last_saved = step
                if self._stop:
                    break
            # final save (sync) so restarts land at the exact stop point
            if saving and self.history and \
                    self.history[-1].step != last_saved:
                if self.ckpt is not None:
                    self.ckpt.wait()
                self._save(self.history[-1].step,
                           {"params": params, "opt": opt_state}, False)
        finally:
            prefetch.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "last_step": self.history[-1].step if self.history else -1,
                "losses": [s.loss for s in self.history],
                "stragglers": len(self.straggler_log)}
