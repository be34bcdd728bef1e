"""Kernels: the least time the card could take for the profiled slice's
flash-attention launches (q, k and v read once, the output written once,
the causal pairs; 989 TFLOP/s and 3.35 TB/s) over the device time the
trace gives them, in %.  A prefill makes one launch a layer; where the
trace holds fewer launches than that, the bound is taken for the share it
holds."""
from perfbench.harness import work


def read(run):
    s, m = run.slice, run.dims
    if not s or not s["prefills"] or s["flash_s"] <= 0:
        return None
    ms = 0.0
    for T in s["prefills"]:
        ops, n_bytes = work.flash_work(1, T, T, m["H"], m["Hkv"], m["hd"])
        ms += m["L"] * work.bound(n_bytes, ops, work.BF16_OPS_PER_S)[0]
    held = min(s["flash_launches"] / (m["L"] * len(s["prefills"])), 1.0)
    return 100.0 * ms * held / 1e3 / s["flash_s"]
