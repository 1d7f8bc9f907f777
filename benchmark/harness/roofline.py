"""K1 and K2's share of their byte bound, for the per-layer readers."""
from __future__ import annotations

from harness.counts import HBM_BYTES_PER_S

K1, K2 = "segment_spmm_csr", "windowed_tile_spmm"


def share(rec, kind: str, span: str, n: int):
    """100 x (the bound of n units of `kind`'s launches) / (K1 and K2's
    device seconds launched inside `span`).  None unless the port's
    launch counters over the window equal the launches the bound counts
    (every unit of the window, training steps and eval batches)."""
    b = rec.get(f"bytes_{kind}")
    k = rec.get("kernels_in", {}).get(span, {})
    secs = k.get("K1", 0.0) + k.get("K2", 0.0)
    if not b or not n or secs <= 0:
        return None
    want = {K1: 0, K2: 0}
    units = {"eval": rec.get("eval_batches", 0)}
    if rec["kind"] == "train":
        units["train"] = rec.get("steps", 0)
    for u, count in units.items():
        bu = rec.get(f"bytes_{u}")
        if bu is None:
            return None
        want[K1] += bu["count_K1"] * count
        want[K2] += bu["count_K2"] * count
    if any(rec["launches"].get(name, -1) != c for name, c in want.items()):
        return None
    return 100.0 * (b["K1"] + b["K2"]) * n / HBM_BYTES_PER_S / secs
