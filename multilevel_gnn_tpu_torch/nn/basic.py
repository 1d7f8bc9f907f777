"""Basic NN primitives (port of multilevel_gnn_tpu/nn/basic.py: act :32,
Linear :116, MLP :197) and flax's Dropout.

Initialisers follow the JAX package's: torch's nn.Linear default
(U(+-1/sqrt(fan_in)) for weight and bias) or Xavier-uniform weights.  Random
init draws from an explicit torch.Generator; parameters are created on the
CPU and moved with the module.  Dropout masks, too, come from a generator
the caller passes in, never from the global RNG.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def act(x: torch.Tensor, act_type: Optional[str], neg_slope: float = 0.2) -> torch.Tensor:
    """reference act_layer (basic.py:32); leakyrelu slope 0.2."""
    if act_type is None:
        return x
    a = act_type.lower()
    if a == "none":
        return x
    if a == "relu":
        return F.relu(x)
    if a == "leakyrelu":
        return F.leaky_relu(x, neg_slope)
    if a == "elu":
        return F.elu(x)
    if a == "tanh":
        return torch.tanh(x)
    if a == "sigmoid":
        return torch.sigmoid(x)
    if a == "softmax":
        return torch.softmax(x, dim=-1)
    raise NotImplementedError(f"activation [{act_type}] is not found")


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


class Dropout(nn.Module):
    """flax.linen.Dropout: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); rate 1 drops all.
    The mask is drawn from ``generator``, a torch.Generator on x's device;
    in eval mode, or at rate 0, x passes through and nothing is drawn."""

    def __init__(self, rate: Optional[float]):
        super().__init__()
        self.rate = float(rate or 0.0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Module):
    """Dense layer with weight (out, in).  kernel_init: "torch" (nn.Linear
    default) or "xavier"; bias U(+-1/sqrt(fan_in)).  dtype: optional compute
    dtype (params stay float32, input and params cast for the product)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        kernel_init: str = "torch",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        if kernel_init == "torch":
            uniform_(self.weight, 1.0 / math.sqrt(in_features), generator)
        elif kernel_init == "xavier":
            uniform_(self.weight, xavier_bound(in_features, features), generator)
        else:
            raise ValueError(kernel_init)
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
            uniform_(self.bias, 1.0 / math.sqrt(in_features), generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return F.linear(x, self.weight, self.bias)
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class MLP(nn.Module):
    """reference MLP (basic.py:197): channels [in, h1, ..., out]; after each
    Linear: norm -> act -> dropout.  Layers are named Linear_0, Linear_1,
    ... like the flax submodules."""

    def __init__(
        self,
        channels: Sequence[int],
        act_type: str = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        drop: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm_type is not None and str(norm_type).lower() != "none":
            raise NotImplementedError(f"MLP norm {norm_type!r} is not ported yet")
        if act_type is not None and act_type.lower() == "prelu":
            raise NotImplementedError("MLP prelu is not ported yet")
        self.act_type = act_type
        self.n = len(channels)
        for i in range(1, self.n):
            self.add_module(
                f"Linear_{i - 1}",
                Linear(
                    channels[i - 1], channels[i], use_bias, dtype=dtype,
                    generator=generator,
                ),
            )
        self.drop = Dropout(drop)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for i in range(1, self.n):
            x = getattr(self, f"Linear_{i - 1}")(x)
            x = act(x, self.act_type)
            x = self.drop(x, generator)
        return x
