"""Basic NN primitives (port of multilevel_gnn_tpu/nn/basic.py:
torch_linear_init :17, act :32, BatchNorm1d :54, Norm :81 with flax's
LayerNorm, Linear :116, EmbedTable :140, onehot_embed :161, MLP :197),
flax's Dropout and flax's training BatchNorm.

Initialisers follow the JAX package's: torch's nn.Linear default
(U(+-1/sqrt(fan_in)) for weight and bias, torch_linear_init) or
Xavier-uniform weights.  Random init draws from an explicit
torch.Generator; parameters are created on the CPU and moved with the
module.  Dropout masks, too, come from a generator
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
        return leaky_relu(x, neg_slope)
    if a == "elu":
        return F.elu(x)
    if a == "tanh":
        return torch.tanh(x)
    if a == "sigmoid":
        return torch.sigmoid(x)
    if a == "softmax":
        return torch.softmax(x, dim=-1)
    raise NotImplementedError(f"activation [{act_type}] is not found")


class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu with the slope rounded to x's dtype: a bf16 x times
    bf16(0.2) = 0.2001953125 is exact in f32, so its one rounding to bf16
    is jax.nn.leaky_relu's bf16 product; the backward is JAX's
    where(x >= 0, g, g * slope), gradient 1 at x = 0 (F.leaky_relu's is
    the slope there)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, slope: float):
        return F.leaky_relu(x, slope)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, slope = inputs
        ctx.save_for_backward(x)
        ctx.slope = slope

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """value rounded to dtype, as JAX rounds a Python scalar to a bf16
    array's dtype (a weak-typed constant) before the op."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, neg_slope: float = 0.2) -> torch.Tensor:
    """jax.nn.leaky_relu(x, neg_slope): the slope in x's dtype, gradient 1
    at x = 0."""
    return _LeakyReLU.apply(x, in_dtype(neg_slope, x.dtype))


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def torch_linear_init(weight: torch.Tensor, generator: Optional[torch.Generator]):
    """variance_scaling(1/3, fan_in, uniform) on an (out, in) weight:
    U(+-1/sqrt(fan_in)), torch's nn.Linear default (basic.py:17-19)."""
    return uniform_(weight, 1.0 / math.sqrt(weight.shape[1]), generator)


def onehot_embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows table[ids] as onehot(ids) @ table (basic.py:161-169): the
    gradient to the table is the transposed product, with no atomics (an
    index_add_ backward adds its rows in an order that varies from run to
    run on the card).  For small tables."""
    return F.one_hot(ids, table.shape[0]).to(table.dtype) @ table


class UnitGenerators(tuple):
    """One torch.Generator per unit of the fold-parallel step: passed where
    a model takes its dropout generator, it makes each Dropout draw unit
    u's mask from generator u, as that unit's own run_fold would."""


class RowShardGenerator:
    """The dropout generator of a forward on one data rank of a mesh
    (parallel/mesh.py:DataParallel), whose batch holds the rows
    [rank * rows, (rank + 1) * rows) of a batch of size * rows (shard, a
    parallel/comm.py:DataShard): each Dropout draws the whole batch's mask
    from generator, as the single-device step draws it, and keeps the
    rank's rows along its batch axis.  Reads through to the generator's
    attributes."""

    def __init__(self, generator: torch.Generator, shard):
        self.generator, self.shard = generator, shard

    def __getattr__(self, name):
        return getattr(self.generator, name)

    def rand(self, shape, batch_axis: int, device) -> torch.Tensor:
        """Uniform draws of a mask of shape, the rank's rows of the whole
        batch's; a mask broadcast over the batch (size 1 there) is drawn as
        it is."""
        d = self.shard
        if len(shape) == 0 or shape[batch_axis] == 1:
            return torch.rand(shape, generator=self.generator, device=device)
        if shape[batch_axis] != d.rows:
            raise ValueError(
                f"dropout over a batch axis {batch_axis} of {shape[batch_axis]} rows; "
                f"the data rank holds {d.rows}")
        full = list(shape)
        full[batch_axis] = d.rows * d.size
        u = torch.rand(full, generator=self.generator, device=device)
        return u.narrow(batch_axis, d.rank * d.rows, d.rows)


class _UnitDropout(torch.autograd.Function):
    """Dropout of stacked (U, ...) values, unit u's keep mask drawn from
    generators[u] with unit u's shape, in unit order; torch.vmap over the
    unit axis routes each unit's call here (its vmap rule), so the masks
    equal the ones the units' sequential steps draw.  The product and its
    gradient are torch.where(keep, x / keep_prob, 0) and where(keep,
    g / keep_prob, 0), Dropout's own.  mask_shape: a unit's mask shape
    where it broadcasts over x (flax's broadcast_dropout), else x's."""

    @staticmethod
    def forward(x, generators, keep_prob: float, mask_shape=None):
        shape = x.shape[1:] if mask_shape is None else mask_shape
        keep = torch.stack([
            torch.rand(shape, generator=g, device=x.device) < keep_prob
            for g in generators])
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                              device=x.device)), keep

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.keep_prob = inputs[2]
        ctx.save_for_backward(output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _):
        (keep,) = ctx.saved_tensors
        return torch.where(keep, g / ctx.keep_prob, torch.zeros((), dtype=g.dtype,
                                                                  device=g.device)), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, generators, keep_prob, mask_shape=None):
        if len(generators) != info.batch_size:
            raise ValueError(f"{len(generators)} generators for {info.batch_size} units")
        x = x.movedim(in_dims[0], 0) if in_dims[0] is not None else x.expand(
            (info.batch_size,) + tuple(x.shape))
        out, keep = _UnitDropout.apply(x, generators, keep_prob, mask_shape)
        return (out, keep), (0, 0)


def apply_dropout(x: torch.Tensor, generator, keep_prob: float, mask_shape=None,
                  batch_axis: int = 0) -> torch.Tensor:
    """x with each element kept with probability keep_prob and scaled by
    1 / keep_prob.  The keep mask, of mask_shape (broadcast over x, flax's
    broadcast_dropout) or of x's shape, is drawn from ``generator``, a
    torch.Generator, or under the fold-parallel step's vmap unit u's from
    generators[u] of UnitGenerators, or on a data rank of a mesh the
    rank's rows along batch_axis of the whole batch's mask from a
    RowShardGenerator."""
    if isinstance(generator, UnitGenerators):
        return _UnitDropout.apply(x, generator, keep_prob, mask_shape)[0]
    shape = tuple(x.shape if mask_shape is None else mask_shape)
    if isinstance(generator, RowShardGenerator):
        u = generator.rand(shape, batch_axis, x.device)
    else:
        u = torch.rand(shape, generator=generator, device=x.device)
    keep = u < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """flax.linen.Dropout: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); rate 1 drops all.
    The mask is drawn from ``generator``, a torch.Generator on x's device
    (or UnitGenerators, one a unit, under the fold-parallel step's vmap,
    or a RowShardGenerator on a data rank of a mesh);
    in eval mode, or at rate 0, x passes through and nothing is drawn.
    batch_axis: x's batch axis (1 for node-major (N, B, C) values), where a
    data rank of a mesh keeps its rows of the whole batch's mask."""

    def __init__(self, rate: Optional[float], batch_axis: int = 0):
        super().__init__()
        self.rate = float(rate or 0.0)
        self.batch_axis = batch_axis

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        return apply_dropout(x, generator, 1.0 - self.rate, batch_axis=self.batch_axis)


class Linear(nn.Module):
    """Dense layer with weight (out, in).  kernel_init: "torch" (nn.Linear
    default) or "xavier"; bias U(+-1/sqrt(fan_in)), or 0 with zero_bias
    (flax's nn.Dense).  dtype: optional compute
    dtype (params stay float32, input and params cast for the product).
    As flax's Dense, the product is rounded to the compute dtype and the
    bias is added after it in that dtype (F.linear with a bias rounds
    once)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        kernel_init: str = "torch",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        zero_bias: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        if kernel_init == "torch":
            torch_linear_init(self.weight, generator)
        elif kernel_init == "xavier":
            uniform_(self.weight, xavier_bound(in_features, features), generator)
        else:
            raise ValueError(kernel_init)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
            if not zero_bias:
                uniform_(self.bias, 1.0 / math.sqrt(in_features), generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = b.to(self.dtype) if b is not None else None
        y = F.linear(x, w)
        return y if b is None else y + b


def flax_normalize(x, mean, var, scale, bias, eps: float, dtype):
    """flax's _normalize (linen/normalization.py): y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias in float32, then one cast to dtype
    (x's dtype promoted with float32 when None)."""
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    y = (x.float() - mean) * mul
    if bias is not None:
        y = y + bias
    return y.to(dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32))


def layer_norm(x, scale, bias, eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """flax.linen.LayerNorm over the last axis: the statistics in float32
    with var = E[x^2] - E[x]^2 (clipped at 0), then flax_normalize.
    F.layer_norm takes the variance as E[(x - E[x])^2], which can move a
    bf16 result."""
    xs = x.float()
    mean = xs.mean(-1, keepdim=True)
    var = torch.clamp((xs * xs).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return flax_normalize(x, mean, var, scale, bias, eps, dtype)


class Norm(nn.Module):
    """reference norm_layer (basic.py:81-107): 'none', 'layer' (flax's
    LayerNorm, eps 1e-5), 'instance' (over the last axis in float32, no
    affine) or 'batch' (BatchNorm1d over all leading axes).  The JAX
    package's train step carries no batch_stats, so its BatchNorm reads
    the statistics it was initialised with (mean 0, var 1) in eval mode
    and cannot run in training mode (flax raises
    ModifyScopeVariableError); the port does the same.  The scale and bias
    (layer, batch) are this module's own parameters; interop.py maps the
    flax paths onto them."""

    def __init__(self, norm_type: str, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kind, self.dtype = norm_type.lower(), dtype
        if self.kind not in ("none", "layer", "instance", "batch"):
            raise NotImplementedError(f"norm [{norm_type}] is not found")
        if self.kind in ("layer", "batch"):
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        if self.kind == "batch":
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "none":
            return x
        if k == "layer":
            return layer_norm(x, self.scale, self.bias, 1e-5, self.dtype)
        if k == "instance":
            xs = x.float()
            mean = xs.mean(-1, keepdim=True)
            var = ((xs - mean) ** 2).mean(-1, keepdim=True)
            return ((xs - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
        if self.training:
            raise RuntimeError(
                "norm 'batch' cannot train: the JAX package's train step carries "
                "no batch_stats, so flax refuses to update them")
        return flax_normalize(x, self.mean, self.var, self.scale, self.bias, 1e-5,
                              self.dtype)


def BatchNorm1d(features: int, dtype: Optional[torch.dtype] = None) -> Norm:
    """BatchNorm over all leading axes (basic.py:54-78): Norm('batch'), whose
    scale, bias, mean and var carry flax's names; eval mode only."""
    return Norm("batch", features, dtype)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm in float32 over every axis but the last: in
    training mode it normalises with the batch's mean and (biased) variance
    E[x^2] - E[x]^2 and moves the running statistics, ra = momentum * ra +
    (1 - momentum) * batch (flax's batch_stats, here the buffers mean and
    var, mutated in place); in eval mode it reads the running ones.  The
    models that train it (MiNet, the dense blocks) call flax's directly;
    the cohort models' Norm('batch') cannot train, as in JAX."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return flax_normalize(x, self.mean, self.var, self.scale, self.bias, self.eps,
                                  torch.float32)
        xs = x.float().reshape(-1, x.shape[-1])
        mean = xs.mean(0)
        var = torch.clamp((xs * xs).mean(0) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return flax_normalize(x, mean, var, self.scale, self.bias, self.eps, torch.float32)


class EmbedTable(nn.Module):
    """A raw (V, D) embedding table, flax path <name>/embedding
    (basic.py:140-158); the caller slices rows or looks them up with
    ops.spmm.gather_rows."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))


class MLP(nn.Module):
    """reference MLP (basic.py:197): channels [in, h1, ..., out]; after each
    Linear except the last one when last_lin: norm -> act -> dropout.
    Layers are named Linear_0, Linear_1, ... and norms Norm_0, Norm_1, ...
    like the flax submodules.  act_type 'prelu' learns one slope per
    activated layer, prelu_1, prelu_2, ... (initialised to 0.2; flax's
    param names), and where(x >= 0, x, slope * x) with the float32 slope
    gives a float32 result, as JAX promotes a bf16 x (basic.py:228-232).
    batch_axis: the dropout's (Dropout's), 1 for node-major values."""

    def __init__(
        self,
        channels: Sequence[int],
        act_type: str = "relu",
        norm_type: Optional[str] = None,
        use_bias: bool = True,
        drop: float = 0.0,
        last_lin: bool = False,
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        batch_axis: int = 0,
    ):
        super().__init__()
        self.act_type = act_type
        self.prelu = act_type is not None and act_type.lower() == "prelu"
        self.n = len(channels)
        self.last_lin = last_lin
        norm = norm_type is not None and str(norm_type).lower() != "none"
        for i in range(1, self.n):
            self.add_module(
                f"Linear_{i - 1}",
                Linear(
                    channels[i - 1], channels[i], use_bias, dtype=dtype,
                    generator=generator,
                ),
            )
            if i == self.n - 1 and last_lin:
                continue
            if norm:
                self.add_module(f"Norm_{i - 1}", Norm(norm_type, channels[i], dtype))
            if self.prelu:
                self.register_parameter(f"prelu_{i}", nn.Parameter(torch.full((1,), 0.2)))
        self.drop = Dropout(drop, batch_axis)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        for i in range(1, self.n):
            x = getattr(self, f"Linear_{i - 1}")(x)
            if i == self.n - 1 and self.last_lin:
                continue
            norm = getattr(self, f"Norm_{i - 1}", None)
            if norm is not None:
                x = norm(x)
            if self.prelu:
                slope = getattr(self, f"prelu_{i}")
                x = torch.where(x >= 0, x, slope * x)
            else:
                x = act(x, self.act_type)
            x = self.drop(x, generator)
        return x
