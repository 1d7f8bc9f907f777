"""The exported-inference artifact: its format, and its loader.

An exported fold (``train/export.py``) is a directory with

- ``model.pt2``: a ``torch.export`` program of ``infer(x, age) -> (B, 2)``
  probabilities at a fixed batch size B, holding the model's parameters
  and the fold context (plans, MI mask, PCA rows, gather plan) as its
  parameters and buffers;
- ``meta.json``: batch_size, n_nodes, n_tensors (the saved tensors),
  platforms (the device type the program was exported on), run, fold,
  cancer_type, model.

``load_exported`` needs torch and the kernels' op registrations
(``mgtpu::*``, ``ops/kernels``) and nothing of the port's model, layer, data
or training code, as a serving process would run it::

    from multilevel_gnn_tpu_torch.artifact import load_exported
    infer = load_exported(DIR)
    probs = infer(x, age)            # (B, 2); pad the last batch to B
"""
from __future__ import annotations

import json
import os

import torch

PROGRAM = "model.pt2"
META = "meta.json"


def save_exported(out_dir: str, ex: dict) -> None:
    """Write export_fold's result ({"program": ExportedProgram, "meta":
    dict}) into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ex["program"], os.path.join(out_dir, PROGRAM))
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(ex["meta"], f, indent=2)


def load_exported(out_dir: str):
    """A serving callable ``infer(x, age) -> (B, 2)`` float32 probabilities
    on the artifact's device; x (B, n_nodes) and age (B,) may be numpy
    arrays or tensors.  ``infer.meta`` is the artifact's meta.json."""
    # the op registrations the program's kernel calls resolve to
    import multilevel_gnn_tpu_torch.ops.kernels.segment_max  # noqa: F401
    import multilevel_gnn_tpu_torch.ops.kernels.windowed  # noqa: F401

    with open(os.path.join(out_dir, META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(out_dir, PROGRAM)).module()
    device = torch.device(meta["platforms"][0])

    def infer(x, age):
        x = torch.as_tensor(x, dtype=torch.float32).to(device)
        age = torch.as_tensor(age, dtype=torch.float32).to(device)
        with torch.no_grad():
            return program(x, age)

    infer.meta = meta
    return infer
