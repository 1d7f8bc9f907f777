// segment_max_csr: deterministic CSR segmented max over edge rows.
//
//   out[n, :] = max_{e in rowptr[n] .. rowptr[n+1]} msg[eid[e], :]
//   out[n, :] = 0 when row n has no entries
//
// Replaces multilevel_gnn_tpu/ops/pallas/segment_max.py:106 flat_segment_max
// (reached through segment_max_by :160), together with the XLA reorder
// gather that lays the edge rows out in its flat tile order.  The TPU kernel
// runs a segmented prefix-max over each chunk of sorted ids and picks the
// run ends into the owner tile with a one-hot matmul; on Hopper a block per
// destination row reads that row's edge rows directly, through the
// receiver-sorted CSR the graph already carries, so no reordered copy of
// the E x F messages is written.
//
// Design: one block per destination row.  Each thread owns 8 consecutive
// features (one 16-byte load of bf16, two of f32) and keeps their running
// max in f32 registers, starting at -inf; the row's edge ids are staged in
// shared memory 256 at a time and four edge rows are loaded before they
// are reduced, so several loads are in flight per thread.  The max selects
// one of its inputs (bf16 -> f32 is exact) and does no arithmetic on it, so
// the result equals an input element bit for bit: the backward's equality
// test finds the same edges.  NaN propagates, as jnp.maximum does.  No
// atomics: the result is deterministic.
//
// Bound: memory.  It reads every edge row once (E x F x dsize bytes: 629 MB
// for E = 153,538, F = 2048 in bf16) and writes each output row once
// (N x F x 4); one compare-select per edge and feature is far below the
// f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;           // features per thread per pass
constexpr int EDGE_CHUNK = 256;  // edge ids staged in shared memory per step
constexpr int UNROLL = 4;        // edge rows loaded before they are reduced

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// max that keeps the first of equal values and propagates NaN
__device__ __forceinline__ float pick(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void load_row(const T* xr, int f, int F, float* v) {
  if (VECTOR) {
    load8(xr, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = (f + j < F) ? to_f32(xr[j]) : 0.f;
  }
}

template <typename T, bool VECTOR>
__global__ void segment_max_csr_kernel(const int* __restrict__ rowptr,
                                       const int* __restrict__ eid,
                                       const T* __restrict__ msg,
                                       float* __restrict__ out, int F) {
  __shared__ int s_eid[EDGE_CHUNK];
  const int n = blockIdx.x;
  const int beg = rowptr[n];
  const int end = rowptr[n + 1];
  float* orow = out + (size_t)n * F;
  for (int f0 = 0; f0 < F; f0 += blockDim.x * VEC) {
    const int f = f0 + threadIdx.x * VEC;
    float m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = -CUDART_INF_F;
    for (int c = beg; c < end; c += EDGE_CHUNK) {
      const int cnt = min(EDGE_CHUNK, end - c);
      __syncthreads();  // previous chunk fully consumed
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_eid[i] = eid[c + i];
      __syncthreads();
      if (f < F) {
        int i = 0;
        for (; i + UNROLL <= cnt; i += UNROLL) {
          float v[UNROLL][VEC];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            load_row<T, VECTOR>(msg + (size_t)s_eid[i + u] * F + f, f, F, v[u]);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
#pragma unroll
            for (int j = 0; j < VEC; ++j) m[j] = pick(m[j], v[u][j]);
        }
        for (; i < cnt; ++i) {
          float v[VEC];
          load_row<T, VECTOR>(msg + (size_t)s_eid[i] * F + f, f, F, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) m[j] = pick(m[j], v[j]);
        }
      }
    }
    if (f < F) {
      if (beg == end) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) m[j] = 0.f;
      }
      if (VECTOR) {
        float4* o = reinterpret_cast<float4*>(orow + f);
        o[0] = make_float4(m[0], m[1], m[2], m[3]);
        o[1] = make_float4(m[4], m[5], m[6], m[7]);
      } else {
        for (int j = 0; j < VEC && f + j < F; ++j) orow[f + j] = m[j];
      }
    }
  }
}

template <typename T>
void launch(const int* rowptr, const int* eid, const void* msg, float* out,
            int n_rows, int F, int vector, cudaStream_t stream) {
  int threads = ((F + VEC - 1) / VEC + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* m = static_cast<const T*>(msg);
  if (vector)
    segment_max_csr_kernel<T, true><<<n_rows, threads, 0, stream>>>(
        rowptr, eid, m, out, F);
  else
    segment_max_csr_kernel<T, false><<<n_rows, threads, 0, stream>>>(
        rowptr, eid, m, out, F);
}

}  // namespace

// C entry point.  msg is bf16 (is_bf16=1) or f32, row-major (rows, F),
// indexed by eid; out is f32 (n_rows, F).  vector=1 promises F % 8 == 0 and
// 16-byte aligned msg and out.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int segment_max_csr(const int* rowptr, const int* eid,
                               const void* msg, float* out, int n_rows, int F,
                               int is_bf16, int vector, void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(rowptr, eid, msg, out, n_rows, F, vector, s);
  else
    launch<float>(rowptr, eid, msg, out, n_rows, F, vector, s);
  return static_cast<int>(cudaGetLastError());
}
