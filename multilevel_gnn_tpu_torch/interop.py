"""Carry the JAX package's parameters into the port: MultilevelGNN,
DeeperGCN, PathCNN, AutoEncoder, VAE, VQVAE and VAEClassifier (DiffPool
included; the foreach decoders' dec_slot{s}_* keep their slot index in
both).

Input: a flat dict of numpy arrays keyed by flax path, e.g.
``params/gnn_0/gconv/lin_r/kernel`` (the caller flattens the flax tree, so
no jax type reaches this module).  Conversions:

  Dense kernel (in, out)            -> Linear weight (out, in)
  nn.Conv kernel (kh, kw, in, out)  -> Conv2d weight (out, in, kh, kw)
  attention DenseGeneral kernels (d, heads, head_dim) / (heads,
  head_dim, d), their biases        -> as they are (the port keeps flax's
                                       layout)
  biases, embedding tables, LayerNorm / BatchNorm scale and bias,
  pred_norm_scale / _bias, learnable_pca_params, GENConv's t, p, y,
  msg_scale                         -> as they are

Path mapping: drop the leading ``params`` (or ``batch_stats``, whose mean
and var are the port's BatchNorm buffers), drop the ``Dense_0`` that the
JAX Linear wrapper adds and the ``LayerNorm_0`` / ``BatchNorm1d_0`` /
``BatchNorm_0`` that the JAX Norm and BatchNorm1d wrap (so
``norm_0/LayerNorm_0/scale`` is ``norm_0.scale`` and DiffPool's
``bn_0/BatchNorm_0/scale`` is ``bn_0.scale``), ``kernel`` -> ``weight``,
``/`` -> ``.``.  Unknown or
missing keys raise.
"""
from __future__ import annotations

from typing import Dict

import re

import numpy as np
import torch

_NORM = re.compile(r"^(norm|Norm|bn)_\d+$")
_NORM_INNER = ("LayerNorm_0", "BatchNorm1d_0", "BatchNorm_0")


def flax_key_to_torch(key: str) -> str:
    parts = key.split("/")
    if parts and parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    out = []
    for p in parts:
        if p == "Dense_0" or (p in _NORM_INNER and out and _NORM.match(out[-1])):
            continue  # a wrapper's module: Norm's inner modules keep its name
        out.append(p)
    if out and out[-1] == "kernel":
        out[-1] = "weight"
    return ".".join(out)


def _convert(name: str, value: np.ndarray) -> np.ndarray:
    value = np.asarray(value, np.float32)
    if name.endswith(".weight") and value.ndim == 2:
        return value.T
    if name.endswith(".weight") and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def state_dict_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params -> port state_dict entries (torch tensors, CPU)."""
    out = {}
    for key, value in flat.items():
        name = flax_key_to_torch(key)
        if name in out:
            raise KeyError(f"two flax keys map to {name!r}")
        out[name] = torch.from_numpy(np.array(_convert(name, value), order="C"))
    return out


def load_flax_params(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Load flat flax params (and batch_stats) into ``model``'s parameters
    and buffers in place.  Raises KeyError on any unknown or missing entry
    and ValueError on a shape mismatch."""
    sd = state_dict_from_flax(flat)
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(f"unknown params {unknown}; missing params {missing}")
    with torch.no_grad():
        for name, p in own.items():
            v = sd[name]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax {tuple(v.shape)} vs port {tuple(p.shape)}")
            p.copy_(v.to(p.device, p.dtype))
