"""End-to-end training driver on the PyTorch port: a small LM for a few
hundred steps with the full substrate — deterministic data pipeline,
AdamW, Caiti-backed async checkpointing, watchdog, and crash/resume.

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 300
    PYTHONPATH=src python examples/train_e2e_torch.py --steps 300 --resume

The second run finds the first one's checkpoint in ``--ckpt`` and resumes
from it (``--fresh`` deletes the pool and starts over).  Runs on the card
unless ``--device cpu``; the 8m default keeps a few hundred steps
tractable on a CPU, --preset 25m/100m scale up.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.ckpt import CheckpointEngine, make_blockstore
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.optim import AdamW
from repro_torch.train.loop import TrainConfig, Trainer

PRESETS = {
    # name: (layers, d_model, heads, kv, d_ff, vocab, seq, batch)
    "8m":   (4, 256, 8, 4, 1024, 8192, 128, 8),
    "25m":  (6, 384, 8, 4, 1536, 12288, 128, 8),
    "100m": (12, 512, 8, 4, 2048, 32768, 256, 8),
}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", default="8m", choices=list(PRESETS))
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_e2e_torch.pool"))
    ap.add_argument("--fresh", action="store_true",
                    help="delete the pool and start over")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --ckpt (what a run without --fresh "
                         "does wherever it finds a checkpoint)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    L, d, H, kv, ff, V, seq, batch = PRESETS[args.preset]
    cfg = get_config("internlm2-1.8b", smoke=True).with_(
        name=f"lm-{args.preset}", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=kv, d_ff=ff, vocab=V)
    model = build_model(cfg)
    print(f"[e2e] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"seq {seq}, batch {batch}, steps {args.steps}")

    if args.fresh and os.path.exists(args.ckpt):
        os.unlink(args.ckpt)
    store = make_blockstore(args.ckpt, policy="caiti",
                            capacity_bytes=2 << 30)
    ckpt = CheckpointEngine(store, keep=2)
    if ckpt.latest_step() is not None:
        print(f"[e2e] found checkpoint @ step {ckpt.latest_step()} "
              f"-> resuming")

    opt = AdamW(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    source = SyntheticLM(cfg.vocab, seq, batch)
    trainer = Trainer(model, opt, source, ckpt=ckpt,
                      cfg=TrainConfig(total_steps=args.steps,
                                      ckpt_every=50, async_ckpt=True),
                      device=args.device)
    t0 = time.time()
    try:
        out = trainer.run(torch.Generator(device=args.device).manual_seed(0))
    finally:
        latest = ckpt.latest_step()
        ckpt.close()
    dt = time.time() - t0
    n = len(out["losses"])
    losses = (f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}"
              if n else "no step to run")
    print(f"[e2e] {n} steps in {dt:.1f}s ({dt/max(n,1)*1e3:.0f} ms/step) | "
          f"{losses} | stragglers logged: {out['stragglers']} | "
          f"ckpt @ {latest}")
    return out


if __name__ == "__main__":
    main()
