"""PCA on the device (port of multilevel_gnn_tpu/ops/pca.py:14-43), for
MultilevelGNN's runtime reduction methods 'pca_svd' and 'pca_lowrank'.

Both are dense library calls (torch.linalg.svd / qr).  As in JAX, the sign
of each singular vector is the solver's, and a bfloat16 input is refused
(LAPACK and cuSOLVER have no bf16 factorisation; jnp.linalg.svd raises
NotImplementedError on one).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"PCA of a {x.dtype} input: the JAX package refuses it too")


def pca_svd(x: torch.Tensor, k: int, center: bool = True) -> torch.Tensor:
    """Project (..., n, d) onto its top-k right singular vectors: x @ V[:, :k]
    (pca.py:14-24), centred over n first when ``center``."""
    _check_dtype(x)
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    _, _, vh = torch.linalg.svd(x, full_matrices=False)
    return x @ vh.transpose(-1, -2)[..., :k]


def start_block(shape: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """pca_lowrank's random start block: standard normal draws from a
    generator seeded 0 on ``device`` on every call, as JAX draws from
    PRNGKey(0) on every call (the draws themselves differ)."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def pca_lowrank(
    x: torch.Tensor, k: int, niter: int = 2, center: bool = False,
    q0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Randomised PCA projection (pca.py:27-43, torch.pca_lowrank's
    subspace iteration): q = qr(x^T x q) max(niter, 1) times from the
    (..., d, k) start block q0 (start_block's when None), then x @ q."""
    _check_dtype(x)
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    d = x.shape[-1]
    q = start_block(tuple(x.shape[:-2]) + (d, k), x.dtype, x.device) if q0 is None else q0
    xtx = x.transpose(-1, -2) @ x
    for _ in range(max(niter, 1)):
        q, _ = torch.linalg.qr(xtx @ q)
    return x @ q
