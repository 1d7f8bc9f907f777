"""The whole window's share of the H100's dense bf16 peak, %: the model's
operations for the window's training steps and evaluation batches
(harness/counts.py, from shapes) over the window time."""
from harness.counts import PEAK_FLOPS_BF16


def read(rec):
    if rec["kind"] != "train" or "busy_s" not in rec:
        return None
    flops = rec["flops_train"] * rec["steps"] + rec["flops_eval"] * rec["eval_batches"]
    return 100.0 * flops / rec["window_s"] / PEAK_FLOPS_BF16
