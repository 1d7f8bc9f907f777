#!/usr/bin/env python3
"""Where a hand-written kernel spends its time on the card: its CUDA source
built as it is and in variants that each change or remove one part by a
text edit, timed at the GBM fold of chip_smoke.py.

    python3 probes/variants.py KERNEL SOURCE.cu

KERNEL is one of
  k2_pr4  PR 4's windowed-SpMM kernel (K2), whose plan layout only PR 4's
          tree has: run with PYTHONPATH=<checkout of that commit>
  k2      the windowed-SpMM kernel of this tree
  k1      the CSR SpMM kernel (K1) of this tree
  k1_pr4  PR 4's K1 source (one block per row), on this tree's plans
Every edit must match the source, or the script fails.  Each variant and
form is timed as the device time of its kernels per call (torch.profiler,
20 calls after 3 warm-up calls) and held against the plain version (the
error is printed; a variant that removes work is not expected to match).
Prints the ptxas register and spill lines of each build, one JSON line per
(variant, form), then the card's nvidia-smi name and power limit.  Needs
one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# PR 4's K2 (dense 128 x 128 tiles, WMMA bf16 / FMA f32)
PR4_NO_PRODUCT = [("for (int k = 0; k < SB; k += 16)", "for (int k = 0; k < 0; k += 16)"),
                  ("for (int k = 0; k < SB; ++k)", "for (int k = 0; k < 0; ++k)")]
PR4_NO_A = [("for (int e = e0 + tid; e < e1; e += THREADS)",
             "for (int e = e0 + tid; e < e0; e += THREADS)")]
K2_PR4 = {
    "base": [],
    # an entry's value with one load instead of the chain
    # ent_edge_ptr -> edge_eid -> w
    "one_load": [("  for (int k = p.ent_edge_ptr[e]; k < k1; ++k) s += p.w[p.edge_eid[k]];",
                  "  s = p.w[e];")],
    "no_product": PR4_NO_PRODUCT,  # A and X staged, no product
    "no_a": PR4_NO_A,  # no A built or reset, product kept
    "x_only": PR4_NO_A + PR4_NO_PRODUCT,  # X staged, nothing else
    # no sub-block visited: the A clear and the output store
    "empty": [("for (int b = p.tile_blk_ptr[t]; b < b1; ++b)", "for (int b = b1; b < b1; ++b)")],
}
K2_SUM = "      for (int j = rps[rbase + i]; j < j1; ++j) {"
K2_UNROLL = ("#pragma unroll 2\n" + K2_SUM, K2_SUM)  # removes the unroll
K2_ROWS = """#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int j1 = rps[rbase + i + 1];
      for (int j = rps[rbase + i]; j < j1; ++j) {
        const int2 pv = es[j];
        const float v = __int_as_float(pv.y);
        float xv[L::FPL];
        lane_values(Xs + pv.x * L::FT + lane * L::FPL, xv);
#pragma unroll
        for (int q = 0; q < L::FPL; ++q) acc[i][q] = fmaf(v, xv[q], acc[i][q]);
      }
    }"""
# two rows walked side by side: two independent chains of shared loads
K2_PAIRS = """#pragma unroll
    for (int i = 0; i < RPW; i += 2) {
      const int ja = rps[rbase + i], jb = rps[rbase + i + 1];
      const int na = jb - ja, nb = rps[rbase + i + 2] - jb;
      const int m = max(na, nb);
      for (int k = 0; k < m; ++k) {
        if (k < na) {
          const int2 pv = es[ja + k];
          float xv[L::FPL];
          lane_values(Xs + pv.x * L::FT + lane * L::FPL, xv);
#pragma unroll
          for (int q = 0; q < L::FPL; ++q)
            acc[i][q] = fmaf(__int_as_float(pv.y), xv[q], acc[i][q]);
        }
        if (k < nb) {
          const int2 pv = es[jb + k];
          float xv[L::FPL];
          lane_values(Xs + pv.x * L::FT + lane * L::FPL, xv);
#pragma unroll
          for (int q = 0; q < L::FPL; ++q)
            acc[i + 1][q] = fmaf(__int_as_float(pv.y), xv[q], acc[i + 1][q]);
        }
      }
    }"""
# 8 warps of 16 destination rows each, in place of 16 of 8
K2_W8 = [("constexpr int THREADS = 512;   // 16 warps", "constexpr int THREADS = 256;"),
         ("constexpr int RPW = TN / 16;", "constexpr int RPW = TN / 8;")]
K2 = {
    "base": [],
    "no_sum": [(K2_SUM, "      for (int j = j1; j < j1; ++j) {")],  # chunks staged only
    "no_x": [("      cp_async16(d, ok ? x + (size_t)src * p.F + f : x, ok);", "")],
    "no_unroll": [K2_UNROLL],
    "pairs": [K2_UNROLL, (K2_ROWS, K2_PAIRS)],
    "eight_warps": K2_W8 + [K2_UNROLL],
    "eight_warps_pairs": K2_W8 + [K2_UNROLL, (K2_ROWS, K2_PAIRS)],
}
K1_PR4 = {"base": []}
K1 = {
    "base": [],
    "three_blocks_per_sm": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)")],
    "four_blocks_per_sm": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 4)")],
    "one_block_per_sm": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")],
    # long rows a block each, edges not split among its warps
    "long_rows_unsplit": [("const int b = beg + (int)((long long)len * warp / WARPS);",
                           "const int b = warp == 0 ? beg : beg + len;"),
                          ("const int e = beg + (int)((long long)len * (warp + 1) / WARPS);",
                           "const int e = beg + len;")],
}


def edit(src, edits):
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not match the source: {old!r}")
        src = src.replace(old, new)
    return src


def build(src, variants, symbol, argtypes, tmp):
    procs = {}
    for name, edits in variants.items():
        cu = tmp / f"{name}.cu"
        cu.write_text(edit(src, edits))
        so = tmp / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(fn, iters=20, warmup=3):
    """Device time of one fn() call: its kernels' time from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", 0.0)
                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
    return total / 1e3 / iters


def k2_forms(graph, w, gen, new_layout):
    from multilevel_gnn_tpu_torch.ops.kernels import windowed as k2

    plan = graph.winplan
    N, F = graph.n_nodes, 2048
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(N, F, generator=gen, device="cuda").to(dt)
        out = torch.empty(N, F, device="cuda")
        for transpose in (False, True):
            side = plan.bwd if transpose else plan.fwd
            row_of = plan.row_of.data_ptr() if plan.row_of is not None else None
            stream = torch.cuda.current_stream().cuda_stream
            if new_layout:
                pv = torch.empty(side.n_entries, 2, dtype=torch.int32, device="cuda")
                args = [side.tile_blk_ptr.data_ptr(), side.blk_src.data_ptr(),
                        side.blk_ent_ptr.data_ptr(), side.blk_row_ptr.data_ptr(),
                        side.ent_pos.data_ptr(), side.ent_edge_ptr.data_ptr(),
                        side.edge_eid.data_ptr(), w.data_ptr(), row_of, pv.data_ptr(),
                        x.data_ptr(), out.data_ptr(), side.n_tiles, side.n_entries, N, F,
                        int(dt == torch.bfloat16), 1, stream]
            else:
                args = [side.tile_blk_ptr.data_ptr(), side.blk_src.data_ptr(),
                        side.blk_ent_ptr.data_ptr(), side.ent_pos.data_ptr(),
                        side.ent_edge_ptr.data_ptr(), side.edge_eid.data_ptr(),
                        w.data_ptr(), row_of, x.data_ptr(), out.data_ptr(), side.n_tiles,
                        N, F, int(dt == torch.bfloat16), 1, stream]
            ref = k2.windowed_tile_spmm_plain(x, w, plan, transpose)
            name = f"{'transpose' if transpose else 'forward'} {str(dt)[6:]}"
            yield name, args, out, ref


def k1_forms(graph, ctx, w, gen, pr4=False):
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1

    plan = graph.winplan
    N, F = graph.n_nodes, 2048
    ones = torch.ones(max(graph.num_padded_edges, ctx.num_pca_rows), device="cuda")
    cases = [("csr", graph.csr, w, F, torch.bfloat16, False),
             ("csr", graph.csr, w, F, torch.float32, False),
             ("csc", graph.csc, w, F, torch.bfloat16, False),
             ("residual", plan.res, w, F, torch.bfloat16, True),
             ("tres", plan.tres, w, F, torch.bfloat16, True),
             ("res_csc", plan.res_csc, w, F, torch.bfloat16, True),
             ("gather_rows_bwd", ctx.pca_gather, ones, 1024, torch.bfloat16, False),
             ("src_gather", graph.src_gather, ones, F, torch.bfloat16, False),
             ("dst_gather", graph.dst_gather, ones, F, torch.bfloat16, False)]
    for name, p, wt, Fc, dt, acc in cases:
        rows = graph.num_padded_edges if name.endswith("_gather") else (
            ctx.num_pca_rows if name == "gather_rows_bwd" else N)
        x = torch.randn(rows, Fc, generator=gen, device="cuda").to(dt)
        base = torch.randn(p.n_rows, Fc, generator=gen, device="cuda")
        out = base.clone()
        n_items = p.n_busy if acc else int(p.items.shape[0])
        stream = torch.cuda.current_stream().cuda_stream
        if pr4:  # rowptr, col, eid, w, x, out, n_rows, F, is_bf16, accumulate, vector
            args = [p.rowptr.data_ptr(), p.col.data_ptr(), p.eid.data_ptr(), wt.data_ptr(),
                    x.data_ptr(), out.data_ptr(), p.n_rows, Fc, int(dt == torch.bfloat16),
                    int(acc), 1, stream]
        else:
            args = [p.rowptr.data_ptr(), p.col.data_ptr(), p.eid.data_ptr(), wt.data_ptr(),
                    p.items.data_ptr(), p.long_rows.data_ptr(), x.data_ptr(),
                    out.data_ptr(), n_items, int(p.long_rows.shape[0]), Fc,
                    int(dt == torch.bfloat16), int(acc), 1, stream]
        ref = k1.segment_spmm_csr_plain(x, wt, p, base.clone() if acc else None)
        yield f"{name} {str(dt)[6:]}", args, (out, base if acc else None), ref


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    kernel, source = sys.argv[1], Path(sys.argv[2])
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.ops import spmm

    _, _, graph, ctx, _ = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    if kernel == "k1":
        variants, symbol, argtypes = K1, "segment_spmm_csr", [P] * 8 + [I] * 6 + [P]
        forms = k1_forms(graph, ctx, w, gen)
    elif kernel == "k1_pr4":
        variants, symbol, argtypes = K1_PR4, "segment_spmm_csr", [P] * 6 + [I] * 5 + [P]
        forms = k1_forms(graph, ctx, w, gen, pr4=True)
    else:
        new = kernel == "k2"
        variants = K2 if new else K2_PR4
        symbol = "windowed_tile_spmm"
        argtypes = [P] * 12 + [I] * 6 + [P] if new else [P] * 10 + [I] * 5 + [P]
        forms = k2_forms(graph, w, gen, new)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(source.read_text(), variants, symbol, argtypes, Path(tmp))
        for form, args, out, ref in forms:
            out, base = out if isinstance(out, tuple) else (out, None)
            for name, fn in fns.items():
                def launch(fn=fn, name=name):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                if base is not None:
                    out.copy_(base)
                launch()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                print(json.dumps({"kernel": kernel, "variant": name, "form": form,
                                  "device_ms": device_ms(launch),
                                  "max_abs_err_vs_plain": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
