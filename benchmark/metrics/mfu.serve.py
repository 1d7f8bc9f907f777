"""The whole window's share of the H100's dense bf16 peak, %: the model's
operations for the window's eval batches over the window time."""
from harness.counts import PEAK_FLOPS_BF16


def read(rec):
    if rec["kind"] != "serve" or "busy_s" not in rec:
        return None
    return 100.0 * rec["flops_eval"] * rec["eval_batches"] / rec["window_s"] / PEAK_FLOPS_BF16
