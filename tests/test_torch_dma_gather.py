"""P1 (the per-row gather probe, ops/kernels/dma_gather.py) of the PyTorch
port against tools/bench_dma_gather.py's Pallas kernel.

- The plain version, the ``mgtpu::dma_row_gather`` op on CPU tensors (its
  CPU kernel), ``dma_row_gather_ordered`` (the CUDA kernel's order of
  additions: a chunk's rows in edge order from 0.0, then the chunks' sums
  in chunk order) and a numpy loop in that order against the tool's
  ``build(...)`` kernel run in interpret mode
  (``pallas_call`` patched to ``interpret=True`` in this test only), at
  N 64 / te 8 / 12 chunks and N 100 / te 4 / 3 chunks, f32 and bf16 rows
  from RandomState(0).  Tolerance per lane: 1e-6 x max(1, sum_e
  |x3[src[e], 0, l]|), the f32 sums taken in another order (readings:
  up to 3.8e-6 at sums of |x| up to 104 in f32, 0.0 in bf16).
- ``dma_row_gather_ordered`` equals the numpy loop bit for bit (the f32
  words compared, so +0.0 and -0.0 differ) at the cases the kernel's
  layout has to get right: whole chunks, a short last chunk, E < te, E =
  0, te = 1, te = 1,024, te not a multiple of a slot's rows (2 or 4), and
  rows of -0.0, in f32 and bf16.
- The op's CPU result equals the plain version bit for bit, and
  ``torch.library.opcheck`` passes on a ragged last chunk.
- The input checks raise on a wrong dtype, shape, layout, device or te,
  on an src that is not contiguous, and ``check_src`` on rows outside
  [0, N).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1
from torch_threads import few_threads  # noqa: F401  (autouse)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_dma_gather.py"
TOL = 1e-6  # times max(1, sum_e |x3[src[e], 0, l]|), per lane

CASES = [(64, 8, 12), (100, 4, 3)]  # N, te, chunks
DTYPES = ["float32", "bfloat16"]


def _tool():
    spec = importlib.util.spec_from_file_location("bench_dma_gather", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n, te, chunks, dtype):
    """x3 (n, 16, 128) and src (te * chunks,) from RandomState(0); x3's
    values are exact in bf16 when dtype is bf16."""
    rng = np.random.RandomState(0)
    x3 = torch.from_numpy(rng.randn(n, 16, 128).astype(np.float32)).to(getattr(torch, dtype))
    src = torch.from_numpy(rng.randint(0, n, te * chunks).astype(np.int32))
    return x3, src


def _jax_probe(monkeypatch, x3, src, te):
    from jax.experimental import pallas

    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))
    n, chunks = x3.shape[0], src.shape[0] // te
    dtype = jnp.bfloat16 if x3.dtype == torch.bfloat16 else jnp.float32
    run = _tool().build(n, chunks, te, dtype)
    out = jax.jit(run)(jnp.asarray(x3.float().numpy(), dtype), jnp.asarray(src.numpy()))
    return np.asarray(out)


def _limit(x3, src):
    return TOL * np.maximum(1.0, x3[src.long(), 0, :].float().abs().sum(0).numpy())


def _kernel_order(x3, src, te):
    """The CUDA kernel's additions as a numpy loop: each chunk's rows in
    edge order into an f32 sum from 0.0, then the chunks' sums in chunk
    order from 0.0."""
    rows = x3[src.long(), 0, :].float().numpy()
    total = np.zeros(rows.shape[1], np.float32)
    for c in range(0, rows.shape[0], te):
        part = np.zeros(rows.shape[1], np.float32)
        for r in rows[c:c + te]:
            part = part + r
        total = total + part
    return torch.from_numpy(np.broadcast_to(total, (p1.OUT_ROWS, rows.shape[1])).copy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,te,chunks", CASES)
def test_matches_tool_kernel(monkeypatch, n, te, chunks, dtype):
    x3, src = _inputs(n, te, chunks, dtype)
    ref = _jax_probe(monkeypatch, x3, src, te)
    assert ref.shape == (8, 128) and (ref == ref[:1]).all()
    limit = _limit(x3, src)
    for name, got in (("plain", p1.dma_row_gather_plain(x3, src)),
                      ("op", p1.dma_row_gather(x3, src, te)),
                      ("kernel order", _kernel_order(x3, src, te)),
                      ("ordered", p1.dma_row_gather_ordered(x3, src, te))):
        assert got.shape == (8, 128) and got.dtype == torch.float32, name
        err = np.abs(got.numpy() - ref)
        assert (err <= limit).all(), (name, float(err.max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_equals_plain_and_opcheck(dtype):
    x3, src = _inputs(50, 16, 3, dtype)
    src = src[:45]  # a short last chunk
    args = (x3, src, 16)
    assert torch.equal(p1.dma_row_gather_op(*args), p1.dma_row_gather_plain(x3, src))
    torch.library.opcheck(p1.dma_row_gather_op, args)
    err = (_kernel_order(x3, src, 16) - p1.dma_row_gather_plain(x3, src)).abs().numpy()
    assert (err <= _limit(x3, src)).all()


# N, E, te: whole chunks; a short last chunk; E < te; E = 0; te = 1;
# te = 1,024 with a short last chunk; te 7 and 3, not multiples of a
# slot's rows
ORDER_CASES = [(64, 96, 8), (50, 45, 16), (30, 5, 16), (30, 0, 4), (40, 33, 1),
               (40, 2_100, 1_024), (40, 50, 7), (20, 11, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,e,te", ORDER_CASES)
def test_ordered_equals_numpy_loop(n, e, te, dtype):
    rng = np.random.RandomState(1)
    x3 = torch.from_numpy(rng.randn(n, 16, 128).astype(np.float32)).to(getattr(torch, dtype))
    x3[::3] = -0.0  # rows of -0.0: a sum from +0.0 stays +0.0
    src = torch.from_numpy(rng.randint(0, n, e).astype(np.int32))
    got = p1.dma_row_gather_ordered(x3, src, te)
    want = _kernel_order(x3, src, te)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_empty_src_gives_zeros():
    x3, src = _inputs(10, 4, 1, "float32")
    out = p1.dma_row_gather(x3, src[:0])
    assert torch.equal(out, torch.zeros(8, 128))


def test_input_checks_raise():
    x3, src = _inputs(20, 4, 2, "float32")
    with pytest.raises(TypeError):
        p1.dma_row_gather(x3.half(), src)
    with pytest.raises(TypeError):
        p1.dma_row_gather(x3, src.long())
    with pytest.raises(ValueError):
        p1.dma_row_gather(x3.reshape(20, 8, 256), src)
    with pytest.raises(ValueError):
        p1.dma_row_gather(x3.transpose(1, 2).contiguous().transpose(1, 2), src)
    with pytest.raises(ValueError):
        p1.dma_row_gather(x3, src.to("meta"))
    with pytest.raises(ValueError):
        p1.dma_row_gather(x3, src[::2])  # not contiguous
    for te in (0, p1.TE_MAX + 1):
        with pytest.raises(ValueError):
            p1.dma_row_gather(x3, src, te)
    p1.check_src(src, 20)
    with pytest.raises(ValueError):
        p1.check_src(src, 5)
    with pytest.raises(ValueError):
        p1.check_src(torch.tensor([0, -1], dtype=torch.int32), 20)
