#!/usr/bin/env python3
"""Where a hand-written kernel spends its time on the card: its CUDA source
built as it is and in variants that each change or remove one part by a
text edit, timed at the GBM fold of chip_smoke.py.

    python3 probes/variants.py KERNEL SOURCE.cu [SPLIT_ROW ...]

KERNEL is one of
  k2_pr4  PR 4's windowed-SpMM kernel (K2), whose plan layout only PR 4's
          tree has: run with PYTHONPATH=<checkout of that commit>
  k2      the windowed-SpMM kernel of this tree
  k1      the CSR SpMM kernel (K1) of this tree, on the GBM fold's forms
          and on the long-row forms: DeeperGCN's edge-id lookup backward
          (one row of 120,001 entries into 5,548 table rows, (E, 128) f32),
          five such lookups stacked, and the kNN graph's gather backwards
          (N 15,405, k 9, F 64 f32, plans built on the card); each
          SPLIT_ROW given (default: the tree's) rebuilds every plan with
          that chunk length and times every variant on it
  k1_pr4  PR 4's K1 source (one block per row), on this tree's plans
  p1      the per-row gather probe (dma_row_gather.cu): slot rows, ring
          bytes (blocks an SM) and the consumers' reads, at the tool's
          shapes (x3 (15,408, 16, 128), E 165,888, te 256, from
          RandomState(0) as the tool makes them), L2-resident (src drawn
          from the rows of x3 that fill half the L2) and on K1's stream
          (the GBM fold's csr source rows, an (N, 2,048) input viewed as
          (N, 16, 128)); held to dma_row_gather_ordered (0.0 for every
          variant that keeps the reads)
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

import numpy as np
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
    # entries of a narrow row's lane group in flight
    "narrow_u2": [("constexpr int NARROW_U = 4;", "constexpr int NARROW_U = 2;")],
    "narrow_u8": [("constexpr int NARROW_U = 4;", "constexpr int NARROW_U = 8;")],
}

P1_SLOTS = ("constexpr int SLOT_ROWS_BF16 = 4;", "constexpr int SLOT_ROWS_F32 = 2;")
P1_RING = "constexpr int RING_BYTES = 224 * 1024;"
P1 = {
    "base": [],
    # one row a slot (56 / 28 slots), or 32 KB slots (7 slots)
    "slot_rows_1": [(P1_SLOTS[0], "constexpr int SLOT_ROWS_BF16 = 1;"),
                    (P1_SLOTS[1], "constexpr int SLOT_ROWS_F32 = 1;")],
    "slot_rows_8_4": [(P1_SLOTS[0], "constexpr int SLOT_ROWS_BF16 = 8;"),
                      (P1_SLOTS[1], "constexpr int SLOT_ROWS_F32 = 4;")],
    # a smaller ring: 2 (112 KB) or 3 (72 KB) blocks an SM
    "ring_112k": [(P1_RING, "constexpr int RING_BYTES = 112 * 1024;")],
    "ring_72k": [(P1_RING, "constexpr int RING_BYTES = 72 * 1024;")],
    # the rows copied and waited for, not read by the consumers
    "no_read": [("v[r] = r < rows ? to_f32(st[(size_t)r * ROW + l]) : 0.f;", "v[r] = 0.f;")],
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


def replan(p, on_device):
    """The plan p rebuilt from its entries with the module's SPLIT_ROW (on
    the card for a device-built plan)."""
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1

    if on_device:
        return k1.CSRPlan.on_device(p.row, p.col, p.eid, p.n_rows, p.max_col)
    return k1.CSRPlan.build(p.row.cpu().numpy(), p.col.cpu().numpy(),
                            p.eid.cpu().numpy(), p.n_rows).to("cuda")


def k1_forms(graph, ctx, knn, w, gen, pr4=False):
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1

    plan = graph.winplan
    N, F = graph.n_nodes, 2048
    ones = torch.ones(max(graph.num_padded_edges, ctx.num_pca_rows, 5 * 120_001),
                      device="cuda")
    lookup = k1.CSRPlan.gather(np.zeros(120_001, np.int64), 5_548)
    stacked = k1.CSRPlan.stack([lookup] * 5, 120_001, 120_001)
    cases = [("csr", graph.csr, w, F, torch.bfloat16, False, N),
             ("csr", graph.csr, w, F, torch.float32, False, N),
             ("csc", graph.csc, w, F, torch.bfloat16, False, N),
             ("residual", plan.res, w, F, torch.bfloat16, True, N),
             ("tres", plan.tres, w, F, torch.bfloat16, True, N),
             ("res_csc", plan.res_csc, w, F, torch.bfloat16, True, N),
             ("gather_rows_bwd", ctx.pca_gather, ones, 1024, torch.bfloat16, False,
              ctx.num_pca_rows),
             ("src_gather", graph.src_gather, ones, F, torch.bfloat16, False,
              graph.num_padded_edges),
             ("dst_gather", graph.dst_gather, ones, F, torch.bfloat16, False,
              graph.num_padded_edges)]
    if not pr4:
        cases += [("edge_id_lookup_bwd", lookup, ones, 128, torch.float32, False, 120_001),
                  ("stacked_edge_id_lookup_bwd", stacked, ones, 128, torch.float32, False,
                   5 * 120_001),
                  ("knn_gather_src_bwd", knn.src_gather, ones, 64, torch.float32, False,
                   knn.n_edges),
                  ("knn_gather_dst_bwd", knn.dst_gather, ones, 64, torch.float32, False,
                   knn.n_edges)]
    for name, p, wt, Fc, dt, acc, rows in cases:
        if not pr4:
            p = replan(p, name.startswith("knn"))
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
            n_chunks = int(p.chunk_row.shape[0])
            partial = torch.empty(n_chunks, Fc, device="cuda")
            # the kernel sets each ticket back to 0, so one buffer serves
            # the calls of this single stream
            tickets = torch.zeros(max(1, int(p.split_rows.shape[0])), dtype=torch.int32,
                                  device="cuda")
            args = [p.rowptr.data_ptr(), p.col.data_ptr(), p.eid.data_ptr(), wt.data_ptr(),
                    p.items.data_ptr(), p.long_rows.data_ptr(), p.split_rows.data_ptr(),
                    p.chunk_ptr.data_ptr(), p.chunk_row.data_ptr(), partial.data_ptr(),
                    tickets.data_ptr(), x.data_ptr(), out.data_ptr(), n_items,
                    int(p.long_rows.shape[0]), n_chunks, Fc, int(dt == torch.bfloat16),
                    int(acc), 1, stream]
            args.append((partial, tickets))  # kept alive; dropped before the call
        ref = k1.segment_spmm_csr_plain(x, wt, p, base.clone() if acc else None)
        yield f"{name} {str(dt)[6:]}", args, (out, base if acc else None), ref


def p1_forms(graph, gen):
    from multilevel_gnn_tpu_torch.ops.kernels import dma_gather as p1

    N, E, te = 15_408, 165_888, 256
    rng = np.random.RandomState(0)  # x3 then src, f32 then bf16, as the tool
    inputs = []
    for dt in (torch.float32, torch.bfloat16):
        x3 = torch.from_numpy(rng.randn(N, 16, 128)).to(dt).to("cuda")
        inputs.append((x3, torch.from_numpy(rng.randint(0, N, E).astype(np.int32)).to("cuda")))
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for x3, src in inputs:
        dt = x3.dtype
        n_l2 = l2 // 2 // (x3[0].numel() * x3.element_size())
        src_l2 = torch.from_numpy(np.random.RandomState(1).randint(0, n_l2, E).astype(np.int32))
        x = torch.randn(graph.n_nodes, 2048, generator=gen, device="cuda").to(dt)
        for name, xx, ss in (("tool", x3, src), ("l2_resident", x3, src_l2.to("cuda")),
                             ("k1_stream", x.view(-1, 16, 128), graph.csr.col)):
            n = ss.shape[0]
            partial = torch.empty(-(-n // te), 128, device="cuda")
            out = torch.empty(p1.OUT_ROWS, 128, device="cuda")
            args = [xx.data_ptr(), ss.data_ptr(), partial.data_ptr(), out.data_ptr(), n, te,
                    int(dt == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
                    (partial,)]
            yield f"{name} {str(dt)[6:]}", args, out, p1.dma_row_gather_ordered(xx, ss, te)


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    kernel, source = sys.argv[1], Path(sys.argv[2])
    from multilevel_gnn_tpu_torch.data.synthetic import make_gbm_scale_setup
    from multilevel_gnn_tpu_torch.nn.conv import dynamic_graph
    from multilevel_gnn_tpu_torch.ops import spmm
    from multilevel_gnn_tpu_torch.ops.kernels import segment_sum as k1
    from multilevel_gnn_tpu_torch.ops.knn import knn_graph

    _, _, graph, ctx, _ = make_gbm_scale_setup(
        topology="cohort", windowed=True, batch=32, compute_dtype="bfloat16",
        spmm_bf16=True, device="cuda")
    w = spmm.edge_weights(graph, "mean", graph.edge_attr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    knn = dynamic_graph(*knn_graph(torch.randn(15_405, 64, generator=gen, device="cuda"), 9),
                        15_405)
    splits = [int(a) for a in sys.argv[3:]] or [k1.SPLIT_ROW]
    P, I = ctypes.c_void_p, ctypes.c_int
    if kernel == "k1":
        variants, symbol, argtypes = K1, "segment_spmm_csr", [P] * 13 + [I] * 7 + [P]

        def forms_at(split):
            k1.SPLIT_ROW = split
            return k1_forms(graph, ctx, knn, w, gen)

        forms = ((split, f) for split in splits for f in forms_at(split))
    elif kernel == "p1":
        variants, symbol, argtypes = P1, "dma_row_gather", [P] * 4 + [I] * 3 + [P]
        forms = ((None, f) for f in p1_forms(graph, gen))
    elif kernel == "k1_pr4":
        variants, symbol, argtypes = K1_PR4, "segment_spmm_csr", [P] * 6 + [I] * 5 + [P]
        forms = ((None, f) for f in k1_forms(graph, ctx, knn, w, gen, pr4=True))
    else:
        new = kernel == "k2"
        variants = K2 if new else K2_PR4
        symbol = "windowed_tile_spmm"
        argtypes = [P] * 12 + [I] * 6 + [P] if new else [P] * 10 + [I] * 5 + [P]
        forms = ((None, f) for f in k2_forms(graph, w, gen, new))
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(source.read_text(), variants, symbol, argtypes, Path(tmp))
        for split, (form, args, out, ref) in forms:
            out, base = out if isinstance(out, tuple) else (out, None)
            if isinstance(args[-1], tuple):  # K1's workspace, held for the calls
                args, _workspace = args[:-1], args[-1]
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
                                  "split_row": split, "device_ms": device_ms(launch),
                                  "max_abs_err_vs_plain": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
