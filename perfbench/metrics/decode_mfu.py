"""Model step: the model FLOPs of the window's decode steps (every block's
products for one token a sequence, attention over each sequence's
length, the logits) over their synchronised seconds at 989 TFLOP/s, in %."""
from perfbench.harness import work


def read(run):
    if run.rec is None:
        return None
    calls = [(lens, t1 - t0) for lens, t0, t1 in run.rec.decode
             if run.in_window(t0)]
    s = sum(dt for _, dt in calls)
    if not calls or s <= 0:
        return None
    flops = sum(work.decode_flops(lens, **run.dims) for lens, _ in calls)
    return 100.0 * flops / (s * work.BF16_OPS_PER_S)
