"""Device ms an eval batch of the dense kernels (every kernel but the
port's own), launched inside eval_step."""


def read(rec):
    k = rec.get("kernels_in", {}).get("eval_step", {})
    if rec["kind"] != "serve" or not rec.get("eval_batches") or "dense" not in k:
        return None
    return 1e3 * k["dense"] / rec["eval_batches"]
