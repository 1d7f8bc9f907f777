"""The share of the traced window in which no operation ran on the device, %."""


def read(rec):
    if rec["kind"] != "serve" or "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
