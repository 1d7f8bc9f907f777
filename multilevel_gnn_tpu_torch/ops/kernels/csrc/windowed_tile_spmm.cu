// windowed_tile_spmm: block-sparse tile SpMM over a locality-blocked edge
// plan, on tensor cores.
//
//   out[row_of[p], :] = sum_{in-window edges e with dst(e) = p}
//                           w[eid(e)] * x[row_of[src(e)], :]
//
// in the plan's (possibly permuted) node order p, with row_of mapping a
// permuted row back to its original row (identity when null).
//
// Replaces multilevel_gnn_tpu/ops/pallas/windowed.py:574 windowed_exec
// (forward side), together with the two permute_rows gathers around it
// (windowed.py:720-730): the row map is applied inside the loads and
// stores.  The TPU kernel accumulates a (128 x 1024) f32 adjacency block
// per destination tile in VMEM, then multiplies it by the whole source
// window.  That block is 512 KB, more than a Hopper block's 227 KB of
// shared memory, so this kernel walks the window in 128-row source
// sub-blocks, and only the non-empty ones, which the plan lists per tile.
//
// Per (128-row destination tile, 128-feature slice) block, per non-empty
// sub-block:
//   1. X sub-block (128 source rows x 128 features) -> shared memory;
//   2. A sub-tile (128 x 128) built in shared memory from the plan's
//      distinct (dst, src) entries: one thread sums each entry's edge
//      weights in plan order (duplicates summed in a fixed order, no
//      atomics), then writes it;
//   3. bf16: A (rounded to bf16) @ X on tensor cores through WMMA
//      (mma.sync, bf16 in, f32 accumulate).  f32: CUDA-core FMA, 8x8
//      outputs per thread, for full f32 accuracy.
//   4. the entries just written are reset to 0 so A stays zero between
//      sub-blocks without clearing the whole tile.
// The f32 results are staged through shared memory and stored once, to
// the original row order.  Tiles without in-window edges store zeros, so
// every output row is written.
//
// Bound: the tensor-core work is 2 * 128 * 128 * F flops per non-empty
// sub-block; the memory traffic is one X sub-block read per sub-block and
// feature slice plus one output write.  Which one bounds depends on the
// number of non-empty sub-blocks, which the plan reports.
//
// Shared memory: bf16 68 KB, f32 132 KB per block; both above the 48 KB
// default, so the launcher opts in with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TN = 128;       // destination rows per tile
constexpr int SB = 128;       // source rows per sub-block
constexpr int FT = 128;       // features per block
constexpr int THREADS = 256;  // 8 warps

// bf16 layout: row strides padded by 8 elements (16 B) against bank
// conflicts; every WMMA tile pointer stays 32-byte aligned.
constexpr int LDA16 = SB + 8;
constexpr int LDX16 = FT + 8;
constexpr int LDO = FT + 4;  // f32 staging of the output tile
constexpr size_t SMEM_BF16_IN = (size_t)(TN * LDA16 + SB * LDX16) * 2;
constexpr size_t SMEM_BF16_OUT = (size_t)TN * LDO * 4;
constexpr size_t SMEM_BF16 =
    SMEM_BF16_IN > SMEM_BF16_OUT ? SMEM_BF16_IN : SMEM_BF16_OUT;

constexpr int LDA32 = SB + 4;
constexpr int LDX32 = FT + 4;
constexpr size_t SMEM_F32 = (size_t)(TN * LDA32 + SB * LDX32) * 4;

struct Plan {
  const int* tile_blk_ptr;  // (n_tiles + 1) sub-block range per tile
  const int* blk_src;       // (n_blk) first source row (permuted order)
  const int* blk_ent_ptr;   // (n_blk + 1) entry range per sub-block
  const int* ent_pos;       // (n_ent) dst_local * 128 + src_local
  const int* ent_edge_ptr;  // (n_ent + 1) edge range per entry
  const int* edge_eid;      // (n_in) original edge id, entry-grouped
  const float* w;           // (E) weight per original edge
  const int* row_of;        // (N) permuted row -> original row, or null
  int N;
  int F;
};

__device__ __forceinline__ int orig_row(const Plan& p, int r) {
  if (r >= p.N) return -1;
  return p.row_of ? p.row_of[r] : r;
}

__device__ __forceinline__ float entry_sum(const Plan& p, int e) {
  float s = 0.f;
  const int k1 = p.ent_edge_ptr[e + 1];
  for (int k = p.ent_edge_ptr[e]; k < k1; ++k) s += p.w[p.edge_eid[k]];
  return s;
}

// ---------------------------------------------------------------- bf16

template <bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    win_bf16_kernel(Plan p, const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Xs = As + TN * LDA16;
  float* Os = reinterpret_cast<float*>(smem);  // reused after the products

  const int t = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // warp rows wr*32 .. +32
  const int wc = warp & 1;   // warp cols wc*64 .. +64
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < TN * LDA16 / 8; i += THREADS)
    reinterpret_cast<uint4*>(As)[i] = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  const int b1 = p.tile_blk_ptr[t + 1];
  for (int b = p.tile_blk_ptr[t]; b < b1; ++b) {
    const int s0 = p.blk_src[b];
    const int e0 = p.blk_ent_ptr[b];
    const int e1 = p.blk_ent_ptr[b + 1];
    for (int i = tid; i < SB * (FT / 8); i += THREADS) {
      const int r = i / (FT / 8);
      const int c = (i % (FT / 8)) * 8;
      const int src = orig_row(p, s0 + r);
      const int f = f0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src >= 0 && f < p.F) {
        const __nv_bfloat16* xr = x + (size_t)src * p.F + f;
        if (VECTOR) {
          v = *reinterpret_cast<const uint4*>(xr);
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) tmp[j] = (f + j < p.F) ? xr[j] : zero;
          v = *reinterpret_cast<const uint4*>(tmp);
        }
      }
      *reinterpret_cast<uint4*>(Xs + r * LDX16 + c) = v;
    }
    for (int e = e0 + tid; e < e1; e += THREADS) {
      const int pos = p.ent_pos[e];
      As[(pos >> 7) * LDA16 + (pos & 127)] = __float2bfloat16(entry_sum(p, e));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SB; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bx[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA16 + k,
                               LDA16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bx[j], Xs + k * LDX16 + wc * 64 + j * 16,
                               LDX16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], bx[j], acc[i][j]);
    }
    __syncthreads();  // products done before A and X are rewritten
    for (int e = e0 + tid; e < e1; e += THREADS) {
      const int pos = p.ent_pos[e];
      As[(pos >> 7) * LDA16 + (pos & 127)] = zero;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Os + (wr * 32 + i * 16) * LDO + wc * 64 + j * 16,
                              acc[i][j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TN * (FT / 4); i += THREADS) {
    const int r = i / (FT / 4);
    const int c = (i % (FT / 4)) * 4;
    const int dst = orig_row(p, t * TN + r);
    const int f = f0 + c;
    if (dst < 0 || f >= p.F) continue;
    const float* o = Os + r * LDO + c;
    float* d = out + (size_t)dst * p.F + f;
    if (VECTOR) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(o);
    } else {
      for (int j = 0; j < 4 && f + j < p.F; ++j) d[j] = o[j];
    }
  }
}

// ----------------------------------------------------------------- f32

template <bool VECTOR>
__global__ void __launch_bounds__(THREADS)
    win_f32_kernel(Plan p, const float* __restrict__ x,
                   float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Xs = As + TN * LDA32;

  const int t = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*8 .. +8
  const int tx = tid & 15;  // cols tx*4 .. +4 and 64 + tx*4 .. +4

  for (int i = tid; i < TN * LDA32 / 4; i += THREADS)
    reinterpret_cast<float4*>(As)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int b1 = p.tile_blk_ptr[t + 1];
  for (int b = p.tile_blk_ptr[t]; b < b1; ++b) {
    const int s0 = p.blk_src[b];
    const int e0 = p.blk_ent_ptr[b];
    const int e1 = p.blk_ent_ptr[b + 1];
    for (int i = tid; i < SB * (FT / 4); i += THREADS) {
      const int r = i / (FT / 4);
      const int c = (i % (FT / 4)) * 4;
      const int src = orig_row(p, s0 + r);
      const int f = f0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0 && f < p.F) {
        const float* xr = x + (size_t)src * p.F + f;
        if (VECTOR) {
          v = *reinterpret_cast<const float4*>(xr);
        } else {
          v.x = xr[0];
          v.y = (f + 1 < p.F) ? xr[1] : 0.f;
          v.z = (f + 2 < p.F) ? xr[2] : 0.f;
          v.w = (f + 3 < p.F) ? xr[3] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(Xs + r * LDX32 + c) = v;
    }
    for (int e = e0 + tid; e < e1; e += THREADS) {
      const int pos = p.ent_pos[e];
      As[(pos >> 7) * LDA32 + (pos & 127)] = entry_sum(p, e);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < SB; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * LDA32 + k];
      const float4 u = *reinterpret_cast<const float4*>(Xs + k * LDX32 + tx * 4);
      const float4 v =
          *reinterpret_cast<const float4*>(Xs + k * LDX32 + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i], u.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], u.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], u.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], u.w, acc[i][3]);
        acc[i][4] = fmaf(a[i], v.x, acc[i][4]);
        acc[i][5] = fmaf(a[i], v.y, acc[i][5]);
        acc[i][6] = fmaf(a[i], v.z, acc[i][6]);
        acc[i][7] = fmaf(a[i], v.w, acc[i][7]);
      }
    }
    __syncthreads();
    for (int e = e0 + tid; e < e1; e += THREADS) {
      const int pos = p.ent_pos[e];
      As[(pos >> 7) * LDA32 + (pos & 127)] = 0.f;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dst = orig_row(p, t * TN + ty * 8 + i);
    if (dst < 0) continue;
    float* d = out + (size_t)dst * p.F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + h * 64 + tx * 4;
      if (f >= p.F) continue;
      if (VECTOR) {
        *reinterpret_cast<float4*>(d + f) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
        for (int j = 0; j < 4 && f + j < p.F; ++j) d[f + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <typename KernelT, typename XT>
int run(KernelT kernel, size_t smem, dim3 grid, cudaStream_t s, const Plan& p,
        const XT* x, float* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, s>>>(p, x, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point.  x is bf16 (is_bf16=1) or f32, row-major (N, F) in the
// original row order; out is f32 (N, F), every row written.  vector=1
// promises F % 8 == 0 and 16-byte aligned x and out.  Returns the
// cudaError_t of the attribute call or the launch (0 on success).
extern "C" int windowed_tile_spmm(
    const int* tile_blk_ptr, const int* blk_src, const int* blk_ent_ptr,
    const int* ent_pos, const int* ent_edge_ptr, const int* edge_eid,
    const float* w, const int* row_of, const void* x, float* out, int n_tiles,
    int N, int F, int is_bf16, int vector, void* stream) {
  if (n_tiles <= 0 || N <= 0 || F <= 0) return 0;
  const Plan p{tile_blk_ptr, blk_src, blk_ent_ptr, ent_pos, ent_edge_ptr,
               edge_eid,     w,       row_of,      N,       F};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (F + FT - 1) / FT);
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    return vector ? run(win_bf16_kernel<true>, SMEM_BF16, grid, s, p, xb, out)
                  : run(win_bf16_kernel<false>, SMEM_BF16, grid, s, p, xb, out);
  }
  const float* xf = static_cast<const float*>(x);
  return vector ? run(win_f32_kernel<true>, SMEM_F32, grid, s, p, xf, out)
                : run(win_f32_kernel<false>, SMEM_F32, grid, s, p, xf, out);
}
