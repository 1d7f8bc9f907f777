// segment_spmm_csr: deterministic CSR segmented reduction with the row
// gather fused in.
//
//   out[n, :] (+)= sum_{e in rowptr[n] .. rowptr[n+1]} w[eid[e]] * x[col[e], :]
//
// Replaces multilevel_gnn_tpu/ops/pallas/segment_sum.py:497 flat_segment_sum
// together with the XLA row gather that feeds it (take_ib(x2, flat_idx) in
// ops/spmm.py:156 and ops/pallas/windowed.py:741).  The TPU kernel contracts
// a (128 x te) one-hot against gathered message chunks on the MXU; on Hopper
// the gather is a plain coalesced row read, so the message matrix of
// E x F values is never written to device memory.
//
// Design: one block per destination row.  Each thread owns 8 consecutive
// features (one 16-byte load of bf16, two of f32) and keeps their sums in
// f32 registers; the row's edges are staged (source row, weight) in shared
// memory 256 at a time.  Each output element is summed by one thread in
// CSR order, so the result is deterministic: no atomics.
//
// Bound: memory.  It reads each touched source row once per edge (from L2
// when rows repeat) and writes each output row once; arithmetic is 2
// flops per edge and feature, far below the tensor-free f32 rate.
//
// accumulate=1 adds into out and leaves rows without edges untouched (the
// windowed path's residual edges land on the tile kernel's output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;           // features per thread per pass
constexpr int EDGE_CHUNK = 256;  // edges staged in shared memory per step

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

template <typename T, bool VECTOR>
__global__ void segment_spmm_csr_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const int* __restrict__ eid, const float* __restrict__ w,
    const T* __restrict__ x, float* __restrict__ out, int F,
    int accumulate) {
  __shared__ int s_col[EDGE_CHUNK];
  __shared__ float s_w[EDGE_CHUNK];
  const int n = blockIdx.x;
  const int beg = rowptr[n];
  const int end = rowptr[n + 1];
  if (accumulate && beg == end) return;  // same for the whole block
  float* orow = out + (size_t)n * F;
  for (int f0 = 0; f0 < F; f0 += blockDim.x * VEC) {
    const int f = f0 + threadIdx.x * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int c = beg; c < end; c += EDGE_CHUNK) {
      const int m = min(EDGE_CHUNK, end - c);
      __syncthreads();  // previous chunk fully consumed
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        s_col[i] = col[c + i];
        s_w[i] = w[eid[c + i]];
      }
      __syncthreads();
      if (f < F) {
        for (int i = 0; i < m; ++i) {
          const T* xr = x + (size_t)s_col[i] * F + f;
          const float we = s_w[i];
          if (VECTOR) {
            float v[VEC];
            load8(xr, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = fmaf(we, v[j], acc[j]);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              if (f + j < F) acc[j] = fmaf(we, to_f32(xr[j]), acc[j]);
          }
        }
      }
    }
    if (f < F) {
      if (VECTOR) {
        float4* o = reinterpret_cast<float4*>(orow + f);
        float4 a = make_float4(acc[0], acc[1], acc[2], acc[3]);
        float4 b = make_float4(acc[4], acc[5], acc[6], acc[7]);
        if (accumulate) {
          const float4 pa = o[0], pb = o[1];
          a.x += pa.x; a.y += pa.y; a.z += pa.z; a.w += pa.w;
          b.x += pb.x; b.y += pb.y; b.z += pb.z; b.w += pb.w;
        }
        o[0] = a;
        o[1] = b;
      } else {
        for (int j = 0; j < VEC && f + j < F; ++j)
          orow[f + j] = accumulate ? orow[f + j] + acc[j] : acc[j];
      }
    }
  }
}

template <typename T>
void launch(const int* rowptr, const int* col, const int* eid, const float* w,
            const void* x, float* out, int n_rows, int F, int accumulate,
            int vector, cudaStream_t stream) {
  int threads = ((F + VEC - 1) / VEC + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xt = static_cast<const T*>(x);
  if (vector)
    segment_spmm_csr_kernel<T, true><<<n_rows, threads, 0, stream>>>(
        rowptr, col, eid, w, xt, out, F, accumulate);
  else
    segment_spmm_csr_kernel<T, false><<<n_rows, threads, 0, stream>>>(
        rowptr, col, eid, w, xt, out, F, accumulate);
}

}  // namespace

// C entry point.  x is bf16 (is_bf16=1) or f32, row-major (rows, F); out is
// f32 (n_rows, F).  vector=1 promises F % 8 == 0 and 16-byte aligned x and
// out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int segment_spmm_csr(const int* rowptr, const int* col,
                                const int* eid, const float* w, const void* x,
                                float* out, int n_rows, int F, int is_bf16,
                                int accumulate, int vector, void* stream) {
  if (n_rows <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(rowptr, col, eid, w, x, out, n_rows, F, accumulate,
                          vector, s);
  else
    launch<float>(rowptr, col, eid, w, x, out, n_rows, F, accumulate, vector,
                  s);
  return static_cast<int>(cudaGetLastError());
}
