"""Device ms an eval batch: CUDA events around each eval_step, their sum
over their count."""


def read(rec):
    ms = rec.get("eval_batch_ms") or []
    return sum(ms) / len(ms) if ms else None
