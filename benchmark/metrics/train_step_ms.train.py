"""Device ms a training step: FoldResult.step_ms (CUDA events around each
train_step in run_fold), their sum over their count."""


def read(rec):
    ms = rec.get("step_ms") or []
    return sum(ms) / len(ms) if ms else None
