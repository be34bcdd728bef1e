"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 50 --ckpt /tmp/ckpt.pool

Trains the chosen config on the deterministic synthetic pipeline
(``data.SyntheticLM``) with AdamW, the straggler watchdog and
``--accum`` microbatches a step, and prints the reference's ``[train]``
line.  ``--ckpt PATH`` saves Caiti-backed checkpoints to a block store in
that file (async, every ``--ckpt-every`` steps, and at the end); run it
twice with the same ``--ckpt`` and the second run resumes.  Runs on the
card by default (``--no-smoke`` or ``--full``: the FULL config);
``--device cpu`` runs the kernels' plain versions.  Weights are random,
drawn from ``--seed``, which also seeds the data.  The pipeline's batches
are tokens alone, so whisper (frames) and the VLM (patch embeddings) do
not train here, as in the reference.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt import CheckpointEngine, make_blockstore
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.optim import AdamW
from repro_torch.train.loop import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list(ARCHS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the SMOKE config (--no-smoke: FULL)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the FULL config, as the reference's flag")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None, help="block-pool file path")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-policy", default="caiti")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    opt = AdamW(lr=args.lr, total_steps=args.steps)
    source = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)

    ckpt = None
    if args.ckpt:
        store = make_blockstore(args.ckpt, policy=args.ckpt_policy,
                                capacity_bytes=2 << 30)
        ckpt = CheckpointEngine(store)

    trainer = Trainer(model, opt, source, ckpt=ckpt,
                      cfg=TrainConfig(total_steps=args.steps,
                                      ckpt_every=args.ckpt_every,
                                      accum=args.accum),
                      device=args.device)
    try:
        out = trainer.run(torch.Generator(device=args.device)
                          .manual_seed(args.seed))
    finally:
        if ckpt is not None:
            ckpt.close()
    if out["losses"]:
        print(f"[train] arch={args.arch} steps->{out['last_step']} "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"stragglers={out['stragglers']}")
    else:
        print(f"[train] arch={args.arch} nothing to run: the checkpoint "
              f"is at the last of {args.steps} steps")
    return out


if __name__ == "__main__":
    main()
