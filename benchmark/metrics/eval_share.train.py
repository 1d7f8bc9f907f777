"""The share of the window spent in driver.evaluate (the benchmark's span
around each call), in %."""


def read(rec):
    if rec["kind"] != "train" or "evaluate_s" not in rec:
        return None
    return 100.0 * rec["evaluate_s"] / rec["window_s"]
