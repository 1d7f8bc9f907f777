"""The 95th percentile of every request's wall time in the traced window
(ms), where requests are short and host-paced (B = 32)."""
import numpy as np


def read(rec):
    if rec["kind"] != "serve" or not rec["request_s"]:
        return None
    return float(np.percentile(np.asarray(rec["request_s"]) * 1e3, 95))
