// windowed_tile_spmm: SpMM over a locality-blocked edge plan, accumulated
// sparsely from shared memory.
//
//   out[row_of[p], :] = sum_{in-window entries (p, q)} a(p, q) * x[row_of[q], :]
//
// in the plan's (possibly permuted) node order, with row_of mapping a
// permuted row back to its original row (identity when null) and a(p, q)
// the value of the distinct (dst, src) entry: the f32 sum of its edges'
// weights in plan order.  With bf16 x each weight is first rounded to bf16
// and the sum is rounded to bf16 again, as the TPU kernel's bf16 weighted
// one-hot and its bf16 cast of the adjacency block do
// (multilevel_gnn_tpu/ops/pallas/windowed.py:523-533, :561).
//
// Replaces multilevel_gnn_tpu/ops/pallas/windowed.py:574 windowed_exec
// (either side), together with the two permute_rows gathers around it
// (windowed.py:720-730): the row map is applied inside the loads and
// stores.
//
// Why no dense tile.  The TPU kernel builds a dense (128 x 1024) adjacency
// block and multiplies it on the MXU, its only fast path.  At GBM scale the
// plan holds 132,754 entries over 502 non-empty 128 x 128 sub-blocks: 1.6%
// density, so a dense product does 62x the needed arithmetic.  On Hopper
// the work needed is small (2 flops per entry and feature, 0.54 GFLOP at
// F = 2048, 8 us on the CUDA cores at 67 TFLOP/s) and the bound is the
// bytes: each source row read once and each output row written once.  So
// the kernel adds each entry's row straight from shared memory.
//
// Design, per (128-row destination tile, feature slice) block; blockIdx.x
// is the tile, so the blocks of one feature slice run together and its X
// slice (N x FT) stays in L2:
//   0. a pre-pass (entry_values) writes each entry's (source column,
//      value) once per call, deterministically, instead of every block
//      summing edge weights through dependent loads;
//   1. the tile's sub-block chunks (a 128-row source sub-block and at most
//      ENT_CAP of its entries, split at destination-row boundaries) stream
//      through a two-stage ring in shared memory, filled with cp.async
//      16-byte copies that follow row_of, so the next chunk's X rows,
//      per-row entry pointers and entries load while this one is summed;
//   2. warp w of 16 owns destination rows 8w .. 8w+7 and lane l features
//      FT/32 * l ..; the 8 x FT/32 f32 sums stay in registers across
//      chunks, indexed statically (the row loop is unrolled);
//   3. each entry adds val * Xs[src, features] from shared memory.  In bf16
//      mode val and x are bf16 values, so every product is exact in f32,
//      and the sum order is fixed (chunk order, then entry order):
//      deterministic;
//   4. one store per block from registers: every output row of the tile,
//      zeros where it has no in-window edges, in the original row order.
// FT is 128 features for bf16 and 64 for f32: a 32 KB X sub-block either
// way.  Shared memory: 2 stages x 41.5 KB, so two blocks (32 warps) fit on
// an SM.  Measured on an H100 at GBM scale (bf16, F = 2048), the stages
// and stores alone take 0.085 ms against a 0.057 ms bound (the f32 output
// write is two thirds of the bytes); the sums from shared memory add about
// 0.04 ms on top, latency of the dependent shared loads that the 32 warps
// do not hide fully.  16 warps of 8 rows took 0.127 ms where 8 warps of 16
// rows took 0.158 (probes/variants.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;        // destination rows per tile
constexpr int SB = 128;        // source rows per sub-block
constexpr int THREADS = 512;   // 16 warps
constexpr int RPW = TN / 16;   // destination rows per warp
constexpr int RP = 132;        // per-chunk row pointers (129 used), 16 B rows
constexpr int ENT_CAP = 1024;  // entries per chunk (the host plan's limit)
constexpr int STAGES = 2;

template <typename T>
struct Slice;
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int FT = 128;
};
template <>
struct Slice<float> {
  static constexpr int FT = 64;
};

template <typename T>
struct Layout {
  static constexpr int FT = Slice<T>::FT;
  static constexpr int FPL = FT / 32;             // features per lane
  static constexpr int VEC = 16 / sizeof(T);      // elements per 16 B copy
  static constexpr int X_BYTES = SB * FT * sizeof(T);
  static constexpr int RP_OFF = X_BYTES;
  static constexpr int ENT_OFF = RP_OFF + RP * 4;
  static constexpr int STAGE = ENT_OFF + ENT_CAP * 8;
  static constexpr int SMEM = STAGES * STAGE;
};

struct Plan {
  const int* tile_blk_ptr;  // (n_tiles + 1) chunk range per tile
  const int* blk_src;       // (n_blk) first source row (permuted order)
  const int* blk_ent_ptr;   // (n_blk + 1) entry range per chunk
  const int* blk_row_ptr;   // (n_blk, RP) entry offsets per destination row
  const int* row_of;        // (N) permuted row -> original row, or null
  int N;
  int F;
};

__device__ __forceinline__ int orig_row(const Plan& p, int r) {
  if (r >= p.N) return -1;
  return p.row_of ? p.row_of[r] : r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Each entry's (source column in its sub-block, value), once per call.
__global__ void entry_values(const int* __restrict__ ent_pos,
                             const int* __restrict__ ent_edge_ptr,
                             const int* __restrict__ edge_eid,
                             const float* __restrict__ w,
                             int2* __restrict__ ent_pv, int n_ent,
                             int bf16) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_ent) return;
  float s = 0.f;
  const int k1 = ent_edge_ptr[e + 1];
  for (int k = ent_edge_ptr[e]; k < k1; ++k) {
    const float wk = w[edge_eid[k]];
    s += bf16 ? round_bf16(wk) : wk;
  }
  if (bf16) s = round_bf16(s);
  ent_pv[e] = make_int2(ent_pos[e] & (SB - 1), __float_as_int(s));
}

__device__ __forceinline__ void lane_values(const __nv_bfloat16* p,
                                            float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void lane_values(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}

__device__ __forceinline__ void store_lane(float* d, const float* v,
                                           int n) {  // n = FPL: 4 or 2
  if (n == 4)
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void load_chunk(const Plan& p, const int2* ent_pv,
                                           const T* x, int c, int f0,
                                           unsigned char* stage) {
  using L = Layout<T>;
  constexpr int CPR = L::FT / L::VEC;  // 16-byte copies per X row
  T* Xs = reinterpret_cast<T*>(stage);
  int* rps = reinterpret_cast<int*>(stage + L::RP_OFF);
  int2* es = reinterpret_cast<int2*>(stage + L::ENT_OFF);
  const int tid = threadIdx.x;
  const int s0 = p.blk_src[c];
  for (int i = tid; i < SB * CPR; i += THREADS) {
    const int r = i / CPR;
    const int col = (i % CPR) * L::VEC;
    const int src = orig_row(p, s0 + r);
    const int f = f0 + col;
    T* d = Xs + r * L::FT + col;
    if (VECTOR) {
      const bool ok = src >= 0 && f < p.F;
      cp_async16(d, ok ? x + (size_t)src * p.F + f : x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < L::VEC; ++j)
        d[j] = (src >= 0 && f + j < p.F) ? x[(size_t)src * p.F + f + j]
                                         : static_cast<T>(0.f);
    }
  }
  for (int i = tid; i < RP / 4; i += THREADS)
    cp_async16(rps + 4 * i, p.blk_row_ptr + (size_t)c * RP + 4 * i, true);
  const int e0 = p.blk_ent_ptr[c];
  const int n = p.blk_ent_ptr[c + 1] - e0;
  for (int i = tid; i < n; i += THREADS) cp_async8(es + i, ent_pv + e0 + i);
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 2)
    win_kernel(Plan p, const int2* __restrict__ ent_pv,
               const T* __restrict__ x, float* __restrict__ out) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * L::FT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rbase = warp * RPW;

  float acc[RPW][L::FPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int q = 0; q < L::FPL; ++q) acc[i][q] = 0.f;

  const int c0 = p.tile_blk_ptr[t];
  const int nc = p.tile_blk_ptr[t + 1] - c0;
  if (nc > 0) load_chunk<T, VECTOR>(p, ent_pv, x, c0, f0, smem);
  cp_commit();
  for (int k = 0; k < nc; ++k) {
    if (k + 1 < nc)
      load_chunk<T, VECTOR>(p, ent_pv, x, c0 + k + 1, f0,
                            smem + ((k + 1) % STAGES) * L::STAGE);
    cp_commit();
    cp_wait_one();  // every group but the newest: chunk k has landed
    __syncthreads();
    const unsigned char* stage = smem + (k % STAGES) * L::STAGE;
    const T* Xs = reinterpret_cast<const T*>(stage);
    const int* rps = reinterpret_cast<const int*>(stage + L::RP_OFF);
    const int2* es = reinterpret_cast<const int2*>(stage + L::ENT_OFF);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int j1 = rps[rbase + i + 1];
#pragma unroll 2
      for (int j = rps[rbase + i]; j < j1; ++j) {
        const int2 pv = es[j];
        const float v = __int_as_float(pv.y);
        float xv[L::FPL];
        lane_values(Xs + pv.x * L::FT + lane * L::FPL, xv);
#pragma unroll
        for (int q = 0; q < L::FPL; ++q) acc[i][q] = fmaf(v, xv[q], acc[i][q]);
      }
    }
    __syncthreads();  // chunk k consumed before its stage is refilled
  }

  const int f = f0 + lane * L::FPL;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int dst = orig_row(p, t * TN + rbase + i);
    if (dst < 0) continue;
    float* d = out + (size_t)dst * p.F + f;
    if (VECTOR) {
      if (f < p.F) store_lane(d, acc[i], L::FPL);
    } else {
#pragma unroll
      for (int q = 0; q < L::FPL; ++q)
        if (f + q < p.F) d[q] = acc[i][q];
    }
  }
}

template <typename T, bool VECTOR>
int run(dim3 grid, cudaStream_t s, const Plan& p, const int2* ent_pv,
        const void* x, float* out) {
  auto kernel = win_kernel<T, VECTOR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, Layout<T>::SMEM, s>>>(p, ent_pv,
                                                static_cast<const T*>(x), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point.  x is bf16 (is_bf16=1) or f32, row-major (N, F) in the
// original row order; out is f32 (N, F), every row written; ent_pv is
// scratch for n_ent (column, value) pairs.  vector=1 promises F % 8 == 0
// and 16-byte aligned x and out.  Launches the entry pre-pass, then the
// tile kernel, on one stream.  Returns the cudaError_t of the first failed
// call (0 on success).
extern "C" int windowed_tile_spmm(
    const int* tile_blk_ptr, const int* blk_src, const int* blk_ent_ptr,
    const int* blk_row_ptr, const int* ent_pos, const int* ent_edge_ptr,
    const int* edge_eid, const float* w, const int* row_of, void* ent_pv,
    const void* x, float* out, int n_tiles, int n_ent, int N, int F,
    int is_bf16, int vector, void* stream) {
  if (n_tiles <= 0 || N <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* pv = static_cast<int2*>(ent_pv);
  if (n_ent > 0) {
    entry_values<<<(n_ent + 255) / 256, 256, 0, s>>>(
        ent_pos, ent_edge_ptr, edge_eid, w, pv, n_ent, is_bf16);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Plan p{tile_blk_ptr, blk_src, blk_ent_ptr, blk_row_ptr, row_of, N, F};
  if (is_bf16) {
    const dim3 grid(n_tiles, (F + Slice<__nv_bfloat16>::FT - 1) /
                                 Slice<__nv_bfloat16>::FT);
    return vector ? run<__nv_bfloat16, true>(grid, s, p, pv, x, out)
                  : run<__nv_bfloat16, false>(grid, s, p, pv, x, out);
  }
  const dim3 grid(n_tiles, (F + Slice<float>::FT - 1) / Slice<float>::FT);
  return vector ? run<float, true>(grid, s, p, pv, x, out)
                : run<float, false>(grid, s, p, pv, x, out);
}
