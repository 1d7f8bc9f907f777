"""Trained samples over the window: E whole epochs of run_fold, each
epoch's trained samples (drop_last) over the call's wall time, evaluation
included."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["samples"] / rec["window_s"]
