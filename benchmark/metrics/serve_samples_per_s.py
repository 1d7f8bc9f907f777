"""Patients scored over the window: every request's patients over the
window's wall time."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["patients"] / rec["window_s"]
