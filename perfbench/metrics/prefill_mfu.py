"""Model step: the model FLOPs of the window's prefills (every block's
products over the prompt, causal attention, the last token's logits) over
their synchronised seconds at 989 TFLOP/s (H100 SXM bf16, dense), in %."""
from perfbench.harness import work


def read(run):
    if run.rec is None:
        return None
    calls = [(T, t1 - t0) for _, T, t0, t1 in run.rec.prefill
             if run.in_window(t0)]
    s = sum(dt for _, dt in calls)
    if not calls or s <= 0:
        return None
    flops = sum(work.prefill_flops(T, **run.dims) for T, _ in calls)
    return 100.0 * flops / (s * work.BF16_OPS_PER_S)
