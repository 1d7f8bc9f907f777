"""Host ms a request: the requests' wall time less the device's busy time
in the window, over the requests."""


def read(rec):
    if rec["kind"] != "serve" or "busy_s" not in rec or not rec["n_requests"]:
        return None
    return 1e3 * (sum(rec["request_s"]) - rec["busy_s"]) / rec["n_requests"]
