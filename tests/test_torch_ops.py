"""K1-K4 as torch.library custom ops (namespace mgtpu) on the CPU.

``torch.library.opcheck`` runs each op's schema, fake (meta) function and
dispatch tests on CPU tensors at small shapes, and each op's CPU result
equals its kernel's plain version (the CPU kernel is that version, so
equal bits).  The same checks on CUDA tensors are in
tests/test_torch_cuda_kernels.py (marker ``cuda``) and chip_smoke.py's
``ops`` phase.
"""
import numpy as np
import pytest
import torch

from multilevel_gnn_tpu_torch.ops.kernels import segment_max as k3
from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2
from torch_threads import few_threads  # noqa: F401  (autouse)


def _graph(seed=0, n=300, e=2500):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    # a hub row, so the plan has long rows (more than LONG_ROW entries)
    dst = np.where(rng.rand(e) < 0.1, 7, rng.randint(0, n, e))
    return rng, src, dst, n


def op_cases():
    """(name, op, args, plain result) per op, CPU tensors."""
    rng, src, dst, n = _graph()
    E = len(src)
    plan = k1.CSRPlan.build(dst, src, np.arange(E), n)
    assert plan.long_rows.numel() > 0
    w = torch.as_tensor(rng.rand(E).astype(np.float32))
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.randn(n, 24).astype(np.float32)).to(dtype)
        args = (plan.rowptr, plan.col, plan.eid, plan.row, plan.items, plan.long_rows)
        cases.append((f"k1_{dtype}", k1.segment_spmm_csr_op, (x, w) + args,
                      k1.segment_spmm_csr_plain(x, w, plan)))
        base = torch.as_tensor(rng.randn(n, 24).astype(np.float32))
        cases.append((f"k1_acc_{dtype}", k1.segment_spmm_csr_acc_op,
                      (base.clone(), x, w) + args + (plan.n_busy,),
                      k1.segment_spmm_csr_plain(x, w, plan, out=base.clone())))
        perm = np.random.RandomState(1).permutation(n)
        wplan = k2.build_plan(src, dst, n, perm=perm, Wb=128, nwin=1)
        for t in (False, True):
            cases.append((f"k2_{dtype}_{t}", k2.windowed_tile_spmm_op,
                          (x, w) + k2._side_args(wplan, t),
                          k2.windowed_tile_spmm_plain(x, w, wplan, t)))
        msg = torch.as_tensor(rng.randn(E, 24).astype(np.float32)).to(dtype)
        cases.append((f"k3_{dtype}", k3.segment_max_csr_op,
                      (msg, plan.rowptr, plan.eid, plan.row),
                      k3.segment_max_csr_plain(msg, plan)))
        ids = rng.randint(-1, 40, 500)
        mask = rng.rand(500) > 0.1
        splan = k1.SortedPlan.build(ids, 40, mask)
        data = torch.as_tensor(rng.randn(3, 500, 8).astype(np.float32)).to(dtype)
        cases.append((f"k4_sorted_{dtype}", k1.sorted_segment_sum_op,
                      (data, splan.rowptr, None, splan.seg),
                      k1.sorted_segment_sum_plain(data, splan)))
        cases.append((f"k4_by_{dtype}", k1.sorted_segment_sum_op,
                      (data, splan.rowptr, splan.perm, splan.seg),
                      k1.sorted_segment_sum_plain(data, splan, permuted=True)))
    return cases


NAMES = [c[0] for c in op_cases()]


def _case(name):
    """Fresh inputs per test: the K1 accumulate form mutates its first."""
    return next(c for c in op_cases() if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_opcheck_cpu(name):
    _, op, args, _ = _case(name)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", NAMES)
def test_op_equals_plain_cpu(name):
    _, op, args, ref = _case(name)
    got = op(*args)
    if got is None:  # the mutating K1 form: the result is its first argument
        got = args[0]
    assert got.dtype == torch.float32
    assert torch.equal(got, ref), name


def test_ops_registered_in_namespace():
    for name in ("segment_spmm_csr", "segment_spmm_csr_acc", "windowed_tile_spmm",
                 "segment_max_csr", "sorted_segment_sum"):
        op = getattr(torch.ops.mgtpu, name).default
        schema = op._schema
        # tensors and ints only
        for a in schema.arguments:
            assert str(a.type) in ("Tensor", "Optional[Tensor]", "int"), (name, a)
    # the accumulating form declares that it writes into its first argument
    out = torch.ops.mgtpu.segment_spmm_csr_acc.default._schema.arguments[0]
    assert out.name == "out" and out.alias_info.is_write
