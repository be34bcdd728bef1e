#!/usr/bin/env python3
"""The JAX reference's dry-run cells, compiled on the CPU: per device, the
argument and temporary bytes, ``HloCost``'s FLOPs, collectives and wire
bytes, and two readings of its compiled HLO text that the port's counts
are held against (``tests/test_torch_dryrun.py``):

  * ``at_program_width``: XLA's CPU compiler has no bf16 all-reduce and
    promotes each to f32 (the promoted reducer's name ends in
    ``promoted``).  The text with those all-reduces back at bf16 gives
    the bytes at the width the program reduces in, as the port does.
  * ``without_weight_gathers``: the text with every all-gather of a whole
    weight (its result the shape of a parameter leaf, or of one layer's
    slice of a stacked leaf) emptied.  XLA gathers a layer's weights and
    computes its products replicated where its cost model finds that
    cheaper; the port, as DTensor, reduces the products' partial sums.

  * ``--loop-trips N``: the collectives that the while loops of N trips
    run, every trip and their callers' trips counted (``HloCost``'s
    totals less its totals with those loops run no time): at N = T, the
    per-step collectives of a recurrence that steps token by token.

    PYTHONPATH=src python scripts/reference_cells.py \\
        --arch phi3-mini-3.8b --shape train_4k [--multi-pod] [--f32] \\
        [--hlo out.txt] [--loop-trips 4096]

compiles one production cell on 256 (``--multi-pod``: 512) forced host
devices, a mesh with Auto axes (the reference's own ``run_cell`` makes
Explicit axes on jax 0.9.0 and fails), and prints one JSON record.
Nothing is allocated at the cell's size: ``build_cell`` lowers abstract
shapes.  Imports JAX; the port never imports this file.
"""
import argparse
import functools
import json
import os
import re
import sys


def at_program_width(text: str) -> str:
    out = []
    for line in text.splitlines():
        if re.search(r" all-reduce(-start)?\(", line) and \
                re.search(r"to_apply=%\S*promoted", line):
            lhs, rhs = line.split(" all-reduce", 1)
            line = lhs.replace("f32[", "bf16[") + " all-reduce" + rhs
        out.append(line)
    return "\n".join(out)


def without_weight_gathers(text: str, shapes: set) -> str:
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*\S+ = (\w+)\[([\d,]*)\]\S* all-gather\(", line)
        if m and tuple(int(x) for x in m.group(2).split(",") if x) in shapes:
            line = line.replace(f"{m.group(1)}[{m.group(2)}]",
                                f"{m.group(1)}[0]", 1)
        out.append(line)
    return "\n".join(out)


def weight_shapes(arch: str, overrides: dict) -> set:
    """Every parameter leaf's shape and the shapes of its slices along
    its leading (stacked) axes."""
    import jax
    from repro.configs import get_config
    from repro.models import build_model
    shapes = set()
    for leaf in jax.tree_util.tree_leaves(
            build_model(get_config(arch, **overrides)).param_shape()):
        shapes.update(tuple(leaf.shape)[i:] for i in range(leaf.ndim))
    return shapes


def compile_cell(arch: str, shape: str, mesh, overrides: dict,
                 hlo_path: str | None = None) -> dict:
    """One cell of the reference's ``build_cell`` on ``mesh``, compiled;
    its HLO text written to ``hlo_path`` if given."""
    from repro.launch import dryrun
    from repro.launch.hlo_cost import HloCost
    fn, args = dryrun.build_cell(arch, shape, mesh,
                                 {"cfg_overrides": overrides})
    c = fn.lower(*args).compile()
    text = c.as_text()
    if hlo_path:
        with open(hlo_path, "w") as f:
            f.write(text)
    tot = HloCost(text).totals()
    no_w = HloCost(without_weight_gathers(
        text, weight_shapes(arch, overrides))).totals()["collectives"]
    ag = tot["collectives"].get("all-gather", {}).get("bytes", 0)
    return {"args": c.memory_analysis().argument_size_in_bytes,
            "temp": c.memory_analysis().temp_size_in_bytes,
            "flops": tot["flops"], "collectives": tot["collectives"],
            "wire_bytes": tot["wire_bytes"],
            "program_all_reduce": HloCost(at_program_width(text)).totals()[
                "collectives"].get("all-reduce", {}).get("bytes", 0),
            "weight_gathers": ag - no_w.get("all-gather", {}).get("bytes", 0)}


def loop_collectives(text: str, trips: int) -> dict:
    """Per kind, the count and payload bytes of the collectives that the
    while loops of ``trips`` trips run."""
    from repro.launch.hlo_cost import HloCost

    class Skipped(HloCost):
        def _trips(self, caller, body):
            n = super()._trips(caller, body)
            return 0 if n == trips else n

    full = HloCost(text).totals()["collectives"]
    rest = Skipped(text).totals()["collectives"]
    return {k: {f: v[f] - rest.get(k, {}).get(f, 0)
                for f in ("count", "bytes")} for k, v in full.items()}


def auto_mesh(shape: tuple, names: tuple):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


def keep_unused() -> None:
    """``jax.jit`` with ``keep_unused=True``: an argument the step does not
    read (the encoder's weights in a decode) is counted, as the port
    holds it."""
    import jax
    jax.jit = functools.partial(jax.jit, keep_unused=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="the config in f32 (no width the compiler changes)")
    ap.add_argument("--hlo", default=None,
                    help="write the compiled HLO text to this file")
    ap.add_argument("--loop-trips", type=int, default=None,
                    help="also count the collectives of while loops of "
                    "this many trips")
    args = ap.parse_args(argv)
    n = 512 if args.multi_pod else 256
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp
    keep_unused()
    shape, names = ((2, 16, 16), ("pod", "data", "model")) \
        if args.multi_pod else ((16, 16), ("data", "model"))
    overrides = {"dtype": jnp.float32} if args.f32 else {}
    hlo = args.hlo
    if args.loop_trips and not hlo:
        import tempfile
        hlo = tempfile.mkstemp(suffix=".hlo.txt")[1]
    rec = compile_cell(args.arch, args.shape, auto_mesh(shape, names),
                       overrides, hlo)
    if args.loop_trips:
        with open(hlo) as f:
            rec["loop_collectives"] = {
                args.loop_trips: loop_collectives(f.read(), args.loop_trips)}
        if not args.hlo:
            os.remove(hlo)
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": "x".join(map(str, shape)), "f32": args.f32,
                      **rec}))


if __name__ == "__main__":
    sys.exit(main())
