"""Kernels: the least time the card could take for the profiled slice's
paged-attention calls (the K and V rows of each sequence's length read
once, q read and the output written) over the device time the trace gives
their split and combine launches, in %.  A decode step makes two launches
a layer; where the trace holds fewer, the bound is taken for the share it
holds."""
from perfbench.harness import work


def read(run):
    s, m = run.slice, run.dims
    if not s or not s["decodes"] or s["paged_s"] <= 0:
        return None
    ms = 0.0
    for lens in s["decodes"]:
        ops, n_bytes = work.paged_work(lens, m["H"], m["Hkv"], m["hd"])
        ms += m["L"] * work.bound(n_bytes, ops, work.BF16_OPS_PER_S)[0]
    held = min(s["paged_launches"] / (2 * m["L"] * len(s["decodes"])), 1.0)
    return 100.0 * ms * held / 1e3 / s["paged_s"]
