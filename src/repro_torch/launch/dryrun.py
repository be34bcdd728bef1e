"""Dry run of the production cells, as ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell this traces the port's
own step (``make_train_step`` with AdamW and ZeRO-1 moments, ``prefill``
or ``decode_step``) on the production mesh, with nothing computed and
nothing allocated: the inputs are fake tensors (``FakeTensorMode``) of
each rank's shard, placed as DTensors by the port's spec trees, on a fake
process group of 256 or 512 ranks (``torch.distributed``'s ``fake``
backend, which moves no bytes).  ``launch/op_cost.py`` counts what rank
0 runs and follows its memory, and each cell writes one JSON record with
the reference's keys:

  * ``memory``      — per-device argument, output, alias (arguments
                      updated in place) and temporary bytes (the peak of
                      live storage above the arguments): does it fit?
  * ``cost``        — ``flops``, ``bytes accessed`` and
                      ``transcendentals`` of the counted step
  * ``collectives`` — per kind, count and payload bytes, and their total
  * ``hlo_cost``    — ``op_cost``'s totals (the reference's ``HloCost``
                      keys: flops, bytes, transcendentals, collective and
                      wire bytes), and ``ops``

``trace_s`` takes the place of the reference's ``lower_s`` and
``compile_s``, and every record says ``"attention": "kernel"``: the
attention kernels are counted through their fake forms
(``kernels/ops.py``), by their own formulas, as the card runs them (the
flash backward is the plain recompute there too).  The port has no XLA
attention, so the reference's ``--attn-chunk`` has no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]
One file per cell, so long sweeps are resumable (``--skip-existing``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import COLLECTIVE_KINDS, OpCost
from repro_torch.models import SHAPES, build_model, shape_applicable
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import (batch_spec_tree, cache_spec_tree,
                                  from_shard, local_shape, make_ctx,
                                  map_tree, param_spec_tree, placements,
                                  zero_spec_tree)
from repro_torch.train.step import make_train_step

MESHES = {False: "pod16x16", True: "pod2x16x16"}


def placed(meta, spec, mesh):
    """A fake DTensor of ``meta``'s shape and dtype placed by ``spec``:
    only this rank's shard is made.  With no mesh, a fake tensor."""
    if mesh is None:
        return torch.empty(meta.shape, dtype=meta.dtype)
    pl = placements(spec, mesh)
    local = torch.empty(local_shape(meta.shape, pl, mesh), dtype=meta.dtype)
    return from_shard(local, pl, meta.shape, mesh)


def placed_tree(metas, specs, mesh):
    return map_tree(lambda path, stack, m, s: placed(m, s, mesh), metas,
                    specs)


def build_cell(arch: str, shape, mesh, opts: dict):
    """Returns (step function, its arguments) for one cell: ``shape`` a
    name in ``SHAPES`` or a ``ShapeCfg``, ``mesh`` a ``DeviceMesh`` or
    None (one device: plain tensors, no ``ctx``).  Run it inside
    ``FakeTensorMode``: the arguments are fake DTensors (fake tensors)."""
    cfg = get_config(arch, **opts.get("cfg_overrides", {}))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    model = build_model(cfg)
    ctx = make_ctx(mesh, shape.batch) if mesh is not None else None
    pmeta = model.param_shape()
    pspecs = param_spec_tree(pmeta, mesh)
    params = placed_tree(pmeta, pspecs, mesh)
    specs = model.input_specs(shape)

    if shape.kind == "train":
        opt = AdamW()
        # moments follow params (+ZeRO-1 over data when enabled)
        mspec = pspecs if not opts.get("zero1", True) else \
            zero_spec_tree(pmeta, mesh)
        f32 = map_tree(lambda path, stack, m: m.to(torch.float32), pmeta)
        opt_state = AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            m=placed_tree(f32, mspec, mesh),
            v=placed_tree(f32, mspec, mesh))
        batch = placed_tree(specs["batch"], _batch_specs(specs, ctx), mesh)
        step = make_train_step(model, opt, ctx, accum=opts.get("accum", 1),
                               grad_compression=opts.get("compression",
                                                         "none"))
        return step, (params, opt_state, batch)

    if shape.kind == "prefill":
        batch = placed_tree(specs["batch"], _batch_specs(specs, ctx), mesh)

        def prefill(params, batch):
            return model.prefill(params, batch, ctx=ctx)
        return prefill, (params, batch)

    # decode
    cspecs = cache_spec_tree(specs["cache"], ctx, mesh) if ctx \
        else specs["cache"]
    cache = placed_tree(specs["cache"], cspecs, mesh)
    b = ctx.batch_axes if ctx and ctx.batch_axes else None
    # The reference takes token and pos sharded over the batch axes, and
    # the record counts those shards (``trace_cell`` holds ``args``); the
    # port's step takes them whole on every rank, so it is handed whole
    # fake tensors of the same shape and dtype (a fake trace reads no
    # values).
    token, pos = (placed(specs[k], (b,), mesh) for k in ("token", "pos"))
    whole = [torch.empty(specs[k].shape, dtype=specs[k].dtype)
             for k in ("token", "pos")]

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, *whole, ctx=ctx)
    return serve_step, (params, cache, token, pos)


def _batch_specs(specs, ctx):
    return batch_spec_tree(specs["batch"], ctx) if ctx else specs["batch"]


def trace_cell(arch: str, shape, mesh, opts: dict) -> dict:
    """Builds the cell and runs its step once under ``OpCost`` inside
    ``FakeTensorMode``: -> the record's ``trace_s``, ``cost``,
    ``memory`` (with ``argument_bytes_by_input``, one entry per
    positional argument of the step), ``collectives`` and ``hlo_cost``."""
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False):
        fn, args = build_cell(arch, shape, mesh, opts)
        with OpCost() as oc:
            for a in args:
                oc.hold(a)
            by_input = list(oc.held)
            out = fn(*args)
        mem = oc.memory(out)
        mem["argument_bytes_by_input"] = by_input
        del out, args
    hc = oc.totals()
    coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
    for k, v in hc["collectives"].items():
        coll[k] = {"count": v["count"], "bytes": v["bytes"]}
    coll["total_bytes"] = hc["collective_bytes"]
    cost = {"flops": hc["flops"], "bytes accessed": hc["bytes"],
            "transcendentals": hc["transcendentals"]}
    hc = dict(hc)
    hc.pop("collectives")
    return {"trace_s": round(time.time() - t0, 1), "cost": cost,
            "memory": mem, "collectives": coll, "hlo_cost": hc}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             opts: dict | None = None, tag: str = "") -> dict:
    """One cell on a fake process group of 256 (or 512) ranks that this
    call initialises and destroys: the caller may hold no process group."""
    opts = opts or {}
    mesh_name = MESHES[multi_pod]
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    outp = pathlib.Path(out_dir)
    outp.mkdir(parents=True, exist_ok=True)
    fpath = outp / f"{cell_id}.json"
    cfg = get_config(arch, **opts.get("cfg_overrides", {}))
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "opts": {k: v for k, v in opts.items() if k != "cfg_overrides"},
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "attention": "kernel"}
    if not ok:
        rec.update(status="SKIP", reason=why)
        fpath.write_text(json.dumps(rec, indent=1))
        return rec
    if dist.is_initialized():
        raise RuntimeError("run_cell initialises its own fake process "
                           "group: destroy the caller's first")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 512 if multi_pod else 256
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(status="OK", **trace_cell(arch, shape_name, mesh, opts),
                   n_devices=mesh.size())
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        dist.destroy_process_group()
    fpath.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)

    opts = {"zero1": not args.no_zero1, "accum": args.accum,
            "compression": args.compression, "cfg_overrides": {}}
    if args.remat:
        opts["cfg_overrides"]["remat"] = args.remat

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) \
        else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape}__{MESHES[mp]}" + \
                    (f"__{args.tag}" if args.tag else "")
                fpath = pathlib.Path(args.out) / f"{cell}.json"
                if args.skip_existing and fpath.exists():
                    prev = json.loads(fpath.read_text())
                    if prev.get("status") in ("OK", "SKIP"):
                        print(f"[skip] {cell}: {prev['status']}")
                        continue
                rec = run_cell(arch, shape, mp, args.out, opts, args.tag)
                msg = rec["status"]
                if rec["status"] == "OK":
                    msg += (f" flops={rec['cost']['flops']:.3e}"
                            f" coll={rec['collectives']['total_bytes']:.3e}B"
                            f" temp={rec['memory']['temp_size_in_bytes']:.3e}B"
                            f" trace={rec['trace_s']}s")
                elif rec["status"] == "FAIL":
                    msg += f" {rec['error'][:200]}"
                print(f"[{cell}] {msg}", flush=True)


if __name__ == "__main__":
    main()
