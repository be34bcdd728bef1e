"""Self-tuning control plane quickstart: frozen knobs vs a live
Controller across a workload phase change.

    PYTHONPATH=src python examples/autotune_phase_change.py

1. replays a two-phase trace (YCSB-A with heavy fsync pressure, then a
   zipf read-only YCSB-C) on the virtual-time volume sim, once with the
   knobs frozen at their defaults and once with the feedback controller
   retuning them online — and prints the throughput/latency contrast
   plus every knob move the controller applied;
2. attaches the SAME controller class to a real threaded volume
   (``make_volume(autotune=True)``) and drives one control tick.
"""
from repro_torch.core.sim import run_autotune_sim_workload
from repro_torch.volume import make_default_controller, make_volume

PHASES = [
    {"name": "ycsb_a",                      # 50/50, fsync every 4 ops
     "tenants": [{"name": f"t{j}", "n_ops": 1500, "jobs": 2,
                  "read_frac": 0.5, "fsync_every": 4} for j in range(4)]},
    {"name": "ycsb_c", "lba_dist": "zipf",  # read-only hot set
     "tenants": [{"name": f"t{j}", "n_ops": 1500, "jobs": 2,
                  "read_frac": 1.0} for j in range(4)]},
]

# -- 1. tuned vs frozen on the same trace (virtual time) --------------------
frozen = run_autotune_sim_workload("caiti", phases=PHASES, autotune=None)
ctl = make_default_controller(slos={"*": {"p99_us": 50_000.0}})
tuned = run_autotune_sim_workload("caiti", phases=PHASES, autotune=ctl)

print("[sim] phase-change trace, 4 tenants x 2 streams:")
for label, r in (("frozen", frozen), ("tuned", tuned)):
    print(f"  {label:6s} {r['ops_s']:10.0f} ops/s  p99 {r['p99_us']:8.1f}us")
print(f"  -> tuned/frozen: {tuned['ops_s'] / frozen['ops_s']:.2f}x ops/s, "
      f"{tuned['p99_us'] / frozen['p99_us']:.2f}x p99")
print("  knob moves (virtual time):")
for t_us, changes in tuned["knob_trace"]:
    for name, v in changes.items():
        lo, hi = ctl.clamp_range(name)
        print(f"    t={t_us:9.0f}us  {name:18s} -> {v:7.1f}  "
              f"(clamps [{lo:g}, {hi:g}])")
print(f"  final knobs: {tuned['knob_final']}")

# -- 2. the same controller on the real threaded volume ---------------------
vol = make_volume("caiti", n_lbas=4096, n_shards=2, cache_bytes=2 << 20,
                  shared_workers=2, autotune=True)
try:
    blk = b"\xab" * vol.cfg.block_size
    for i in range(200):
        vol.write(i % 256, blk)
        if i % 4 == 0:
            vol.fsync()
    moves = vol.autotune_step()                  # one live control tick
    snap = vol.metrics_snapshot()["autotune"]
    print(f"\n[real] one control tick on the threaded volume: "
          f"moves={moves or '{} (hysteresis gathering)'}")
    print(f"       ticks={snap['ticks']} total_moves={snap['total_moves']} "
          f"commit_window={vol.cfg.commit_window * 1e6:.0f}us")
finally:
    vol.close()
