"""Readings of the PathCNN / DiffPool / AE / VAE / VQ-VAE / pretraining
parity tests: runs the five test files and prints, for each test, the
largest error it compared (max|diff| / max(1, max|ref|), every quantity
and gradient of the test; for the protocols, the largest fold test-score
difference) as one JSON line; then R7's bf16 readings (the AE's last
MLP bias, test_torch_autoencoder.cancelling_readings).

    JAX_PLATFORMS=cpu python tests/torch_families_report.py

The limits are the tests' own (1e-5 in f32 unless a named residue says
otherwise); this prints what they read.
"""
import json
import os
import sys
from collections import defaultdict

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ["test_torch_pathcnn.py", "test_torch_diffpool.py", "test_torch_autoencoder.py",
         "test_torch_vae.py", "test_torch_pretrain.py"]


class Readings:
    """A pytest plugin: every rel_err and fold-score comparison of a test
    recorded under its node id."""

    def __init__(self):
        self.max = defaultdict(float)
        self.current = None

    def pytest_runtest_setup(self, item):
        self.current = item.nodeid

    def pytest_sessionstart(self, session):
        import torch_families as tf

        rel_err, close = tf.rel_err, tf.close_scores

        def recorded(a, ref):
            v = rel_err(a, ref)
            self.max[self.current] = max(self.max[self.current], v)
            return v

        def recorded_scores(a, b):
            for key in ("epoch_pred", "epoch_pred_by_loss", "epoch_pred_by_epoch"):
                for e in getattr(a, key):
                    d = float(np.abs(getattr(a, key)[e] - getattr(b, key)[e]).max())
                    self.max[self.current] = max(self.max[self.current], d)
            return close(a, b)

        tf.rel_err, tf.close_scores = recorded, recorded_scores
        for name in FILES:
            mod = __import__(name[:-3])
            if hasattr(mod, "rel_err"):
                mod.rel_err = recorded


def main():
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    plugin = Readings()
    rc = pytest.main([os.path.join(HERE, f) for f in FILES] + ["-q", "-p", "no:cacheprovider"],
                     plugins=[plugin])
    for node, v in sorted(plugin.max.items()):
        print(json.dumps({"test": node, "max_reading": v}))
    import test_torch_autoencoder as ae

    r = ae.run_pair(bf16=True, **ae.DECODERS["flatten"])
    print(json.dumps({"test": "R7 bf16", **ae.cancelling_readings(r)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
