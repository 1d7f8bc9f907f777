"""Device ms a training step of the dense kernels (cuBLAS, cuDNN, torch's
elementwise and reductions: every kernel but the port's own), launched
inside train_step."""


def read(rec):
    k = rec.get("kernels_in", {}).get("train_step", {})
    if rec["kind"] != "train" or not rec.get("steps") or "dense" not in k:
        return None
    return 1e3 * k["dense"] / rec["steps"]
