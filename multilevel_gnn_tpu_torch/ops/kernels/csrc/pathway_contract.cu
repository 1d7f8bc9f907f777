// pathway_contract: the learnable-PCA pathway contraction as a segmented
// gather-reduce over a slot plan, forward and backward.
//
//   out[k*S + s, f] = sum_{g in slot s} P[g, k] * x[g, f]                (fwd)
//   dx[g, f]  = sum_{k = K-1 .. 0} round_x(P[g, k] * gout[k*S + seg g, f]) (bwd)
//   dP[g, k]  = sum_f gout[k*S + seg g, f] * x[g, f]                      (bwd)
//
// Replaces no Pallas kernel.  It replaces the one-hot einsum of
// multilevel_gnn_tpu/ops/pathway.py:44-58 (method "matmul"), which the JAX
// package leaves to the TPU's matrix unit, and which the port ran on the
// card as f32 cuBLAS products of the (K*S, G) slot one-hot weighted by each
// PCA column with the (G, F) rows: 2 K S G F operations a product where the
// sum needs 2 K G F (each column of the one-hot has one nonzero of S), and
// the backward two more products of that size.  Here each PCA row is read
// once, in f32 arithmetic as before (x as stored, bf16 or f32; P, every
// product and every sum in f32; no TF32).
//
// Plan (ops/kernels/pathway.py SlotPlan, built once a fold on the host):
// slot_rows lists the PCA rows of each slot in ascending order, slot_ptr
// bounds each slot's rows in it; each slot's rows are cut into chunks of at
// most CHUNK consecutive rows (an empty slot is one empty chunk), a block a
// chunk.  A slot of one chunk is written by its block; a longer slot's
// chunks write partial sums, which a second kernel adds in chunk order.  No
// atomics: two calls give the same bits.
//
// Forward: each thread owns VEC consecutive features (one 16-byte load of
// bf16, two of f32) and keeps K x VEC f32 sums in registers; the chunk's row
// ids and their P rows are staged in shared memory, and UNROLL rows are
// loaded before they are added, in ascending row order, by fused
// multiply-adds (the plain version's CSR product on the CPU sums a slot of
// one chunk in the same order and rounding).  Features past one block's width
// (128 threads, 1,024 features) are the next block of the grid's second
// axis, so kirc's F 2,048 gives two blocks a chunk and the card one wave.
//
// Backward: one pass over the same chunks, a block each; each thread owns
// VEC features (further passes where F is wider than the block) and keeps
// the slot's K cotangent rows there in registers (the cotangent, K S F f32,
// stays in L2).  Per row it writes dx (each column's product rounded to x's
// dtype and added in that dtype, the last column first: the dense form's
// per-column rounding, where every other term is an exact zero, so the bits
// are the same) and its share of dP, which a butterfly sums over the warp
// and shared memory over the passes and then the warps, in order.  A
// thread loads BWD_BYTES of rows before it uses them.  (A warp a row, with
// the cotangent in shared memory, took 0.13-0.14 ms bf16 and 0.34-0.38 ms
// f32 at kirc's shapes on an H100, against 0.107 / 0.164 here.)
//
// Bound: memory.  At kirc's shapes (G 25,015, S 438, K 3, F 2,048, bf16)
// the forward reads x once (102.5 MB) and writes out (10.8 MB): 34 us at
// 3.35 TB/s; the backward reads x and writes dx (205 MB): 61 us.  About 0.3
// operations a byte, far below the f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;            // features per thread per pass
constexpr int CHUNK = 128;        // rows a block (SlotPlan.CHUNK)
constexpr int UNROLL = 4;         // rows loaded before they are used
constexpr int MAX_THREADS = 128;
constexpr int BWD_BYTES = 64;     // bytes of x a thread has in flight in the backward

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

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }

// (a, b) rounded to T and back (exact for f32); one conversion for bf16
__device__ __forceinline__ float2 round2(float a, float b, const __nv_bfloat16*) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
__device__ __forceinline__ float2 round2(float a, float b, const float*) {
  return make_float2(a, b);
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void load_row(const T* r, int f, int F, float* v) {
  if (VECTOR) {
    load8(r, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = (f + j < F) ? to_f32(r[j]) : 0.f;
  }
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void store_row(T* r, int f, int F, const float* v) {
  if (VECTOR) {
    store8(r, v);
  } else {
    for (int j = 0; j < VEC && f + j < F; ++j) from_f32(v[j], r + j);
  }
}

// The chunk's rows and their P rows into shared memory; returns its length.
template <int K>
__device__ __forceinline__ int stage_chunk(const float* __restrict__ p,
                                           const int* __restrict__ slot_ptr,
                                           const int* __restrict__ slot_rows,
                                           int s, int beg, int* s_row, float* s_p) {
  const int n = min(CHUNK, slot_ptr[s + 1] - beg);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int g = slot_rows[beg + i];
    s_row[i] = g;
#pragma unroll
    for (int k = 0; k < K; ++k) s_p[i * K + k] = p[(size_t)g * K + k];
  }
  return n;
}

template <typename T, int K, bool VECTOR>
__global__ void __launch_bounds__(MAX_THREADS)
pathway_fwd_kernel(const T* __restrict__ x, const float* __restrict__ p,
                   const int* __restrict__ slot_ptr, const int* __restrict__ slot_rows,
                   const int* __restrict__ chunk_slot, const int* __restrict__ chunk_beg,
                   const int* __restrict__ chunk_part, float* __restrict__ out,
                   float* __restrict__ parts, int S, int F) {
  __shared__ int s_row[CHUNK];
  __shared__ float s_p[CHUNK * K];
  const int c = blockIdx.x;
  const int s = chunk_slot[c];
  const int part = chunk_part[c];
  const int n = stage_chunk<K>(p, slot_ptr, slot_rows, s, chunk_beg[c], s_row, s_p);
  __syncthreads();
  const int f = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (f >= F) return;  // no barrier below
  float acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
  int i = 0;
  for (; i + UNROLL <= n; i += UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_row<T, VECTOR>(x + (size_t)s_row[i + u] * F + f, f, F, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float pk = s_p[(i + u) * K + k];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[k][j] = __fmaf_rn(pk, v[u][j], acc[k][j]);
      }
  }
  for (; i < n; ++i) {
    float v[VEC];
    load_row<T, VECTOR>(x + (size_t)s_row[i] * F + f, f, F, v);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float pk = s_p[i * K + k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[k][j] = __fmaf_rn(pk, v[j], acc[k][j]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float* o = part < 0 ? out + ((size_t)k * S + s) * F + f
                        : parts + ((size_t)part * K + k) * F + f;
    store_row<float, VECTOR>(o, f, F, acc[k]);
  }
}

// A slot of several chunks: its partial sums added in chunk order.
__global__ void pathway_add_parts_kernel(const float* __restrict__ parts,
                                         const int* __restrict__ split_slot,
                                         const int* __restrict__ part_ptr,
                                         float* __restrict__ out, int S, int F, int K) {
  const int j = blockIdx.x;
  const int s = split_slot[j];
  const int q0 = part_ptr[j], q1 = part_ptr[j + 1];
  for (int k = 0; k < K; ++k)
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      float acc = parts[((size_t)q0 * K + k) * F + f];
      for (int q = q0 + 1; q < q1; ++q)
        acc = __fadd_rn(acc, parts[((size_t)q * K + k) * F + f]);
      out[((size_t)k * S + s) * F + f] = acc;
    }
}

// dx of one row at this thread's VEC features: each column's product
// rounded to T (fma with +0: the product rounded once, a zero product +0,
// as the dense product's first term gives it), the columns added in T, the
// last first; two features a conversion.
template <typename T, int K, bool VECTOR>
__device__ __forceinline__ void dx_features(const float* pk, const float (*g)[VEC], T* dxr,
                                            int f, int F) {
  float d[VEC];
#pragma unroll
  for (int i = 0; i < VEC; i += 2) {
    float2 a = round2(__fmaf_rn(pk[K - 1], g[K - 1][i], 0.f),
                      __fmaf_rn(pk[K - 1], g[K - 1][i + 1], 0.f), dxr);
#pragma unroll
    for (int k = K - 2; k >= 0; --k) {
      const float2 t = round2(__fmaf_rn(pk[k], g[k][i], 0.f),
                              __fmaf_rn(pk[k], g[k][i + 1], 0.f), dxr);
      a = round2(__fadd_rn(a.x, t.x), __fadd_rn(a.y, t.y), dxr);
    }
    d[i] = a.x;
    d[i + 1] = a.y;
  }
  store_row<T, VECTOR>(dxr, f, F, d);
}

template <typename T, int K, bool VECTOR>
__global__ void __launch_bounds__(MAX_THREADS)
pathway_bwd_kernel(const T* __restrict__ x, const float* __restrict__ p,
                   const float* __restrict__ gout,
                   const int* __restrict__ slot_ptr, const int* __restrict__ slot_rows,
                   const int* __restrict__ chunk_slot, const int* __restrict__ chunk_beg,
                   T* __restrict__ dx, float* __restrict__ dp, int S, int F) {
  constexpr int MAX_WARPS = MAX_THREADS / 32;
  constexpr int UN = BWD_BYTES / (VEC * sizeof(T));  // rows in flight: bf16 4, f32 2
  __shared__ int s_row[CHUNK];
  __shared__ float s_p[CHUNK * K];
  __shared__ float s_dp[CHUNK][MAX_WARPS][K];
  const int c = blockIdx.x;
  const int s = chunk_slot[c];
  const int n = stage_chunk<K>(p, slot_ptr, slot_rows, s, chunk_beg[c], s_row, s_p);
  for (int t = threadIdx.x; t < n * MAX_WARPS * K; t += blockDim.x) (&s_dp[0][0][0])[t] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f0 = 0; f0 < F; f0 += blockDim.x * VEC) {
    // every thread stays to the end of the pass, for the warps'
    // butterflies; a thread past F adds zeros
    const int f = f0 + threadIdx.x * VEC;
    const bool on = f < F;
    float g[K][VEC];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (on) {
        load_row<float, VECTOR>(gout + ((size_t)k * S + s) * F + f, f, F, g[k]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) g[k][j] = 0.f;
      }
    }
    for (int i = 0; i < n; i += UN) {
      float v[UN][VEC];
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        if (on && i + u < n) {
          load_row<T, VECTOR>(x + (size_t)s_row[i + u] * F + f, f, F, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int r = i + u;
        if (r >= n) break;
        float pk[K];
#pragma unroll
        for (int k = 0; k < K; ++k) pk[k] = s_p[r * K + k];
        if (on) dx_features<T, K, VECTOR>(pk, g, dx + (size_t)s_row[r] * F + f, f, F);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) a = __fmaf_rn(g[k][j], v[u][j], a);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
          if (lane == 0) s_dp[r][warp][k] = __fadd_rn(s_dp[r][warp][k], a);
        }
      }
    }
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < n * K; t += blockDim.x) {
    const int r = t / K, k = t - r * K;
    float a = s_dp[r][0][k];
    for (int w = 1; w < n_warps; ++w) a = __fadd_rn(a, s_dp[r][w][k]);
    dp[(size_t)s_row[r] * K + k] = a;
  }
}

int threads_for(int F) {
  int t = ((F + VEC - 1) / VEC + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

template <typename T, int K>
void fwd(const void* x, const float* p, const int* slot_ptr, const int* slot_rows,
         const int* chunk_slot, const int* chunk_beg, const int* chunk_part,
         float* out, float* parts, int n_chunks, int S, int F, int vector,
         cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int th = threads_for(F);
  const dim3 grid(n_chunks, (F + th * VEC - 1) / (th * VEC));
  if (vector)
    pathway_fwd_kernel<T, K, true><<<grid, th, 0, stream>>>(
        xt, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, S, F);
  else
    pathway_fwd_kernel<T, K, false><<<grid, th, 0, stream>>>(
        xt, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, S, F);
}

template <typename T, int K>
void bwd(const void* x, const float* p, const float* gout, const int* slot_ptr,
         const int* slot_rows, const int* chunk_slot, const int* chunk_beg, void* dx,
         float* dp, int n_chunks, int S, int F, int vector, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  const int th = threads_for(F);
  if (vector)
    pathway_bwd_kernel<T, K, true><<<n_chunks, th, 0, stream>>>(
        xt, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dxt, dp, S, F);
  else
    pathway_bwd_kernel<T, K, false><<<n_chunks, th, 0, stream>>>(
        xt, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dxt, dp, S, F);
}

template <typename T>
bool fwd_k(int K, const void* x, const float* p, const int* slot_ptr, const int* slot_rows,
           const int* chunk_slot, const int* chunk_beg, const int* chunk_part, float* out,
           float* parts, int n_chunks, int S, int F, int vector, cudaStream_t st) {
  switch (K) {
    case 1: fwd<T, 1>(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, n_chunks, S, F, vector, st); return true;
    case 2: fwd<T, 2>(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, n_chunks, S, F, vector, st); return true;
    case 3: fwd<T, 3>(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, n_chunks, S, F, vector, st); return true;
    case 4: fwd<T, 4>(x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part, out, parts, n_chunks, S, F, vector, st); return true;
    default: return false;
  }
}

template <typename T>
bool bwd_k(int K, const void* x, const float* p, const float* gout, const int* slot_ptr,
           const int* slot_rows, const int* chunk_slot, const int* chunk_beg, void* dx,
           float* dp, int n_chunks, int S, int F, int vector, cudaStream_t st) {
  switch (K) {
    case 1: bwd<T, 1>(x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx, dp, n_chunks, S, F, vector, st); return true;
    case 2: bwd<T, 2>(x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx, dp, n_chunks, S, F, vector, st); return true;
    case 3: bwd<T, 3>(x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx, dp, n_chunks, S, F, vector, st); return true;
    case 4: bwd<T, 4>(x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx, dp, n_chunks, S, F, vector, st); return true;
    default: return false;
  }
}

}  // namespace

// C entry points.  x is bf16 (is_bf16=1) or f32, row-major (G, F); p is f32
// (G, K), K in 1..4; out is f32 (K*S, F); parts is f32 (n_parts, K, F)
// scratch for the slots of several chunks (unused when n_split is 0).
// vector=1 promises F % 8 == 0 and 16-byte aligned x, out, parts (fwd) and
// x, gout, dx (bwd).  Return the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for a K outside 1..4).
extern "C" int pathway_contract_fwd(const void* x, const float* p, const int* slot_ptr,
                                    const int* slot_rows, const int* chunk_slot,
                                    const int* chunk_beg, const int* chunk_part,
                                    const int* split_slot, const int* part_ptr, float* out,
                                    float* parts, int n_chunks, int n_split, int S, int F,
                                    int K, int is_bf16, int vector, void* stream) {
  if (n_chunks <= 0 || F <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok =
      is_bf16 ? fwd_k<__nv_bfloat16>(K, x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg,
                                     chunk_part, out, parts, n_chunks, S, F, vector, st)
              : fwd_k<float>(K, x, p, slot_ptr, slot_rows, chunk_slot, chunk_beg, chunk_part,
                             out, parts, n_chunks, S, F, vector, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split > 0)
    pathway_add_parts_kernel<<<n_split, F < MAX_THREADS ? (F + 31) / 32 * 32 : MAX_THREADS,
                               0, st>>>(parts, split_slot, part_ptr, out, S, F, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pathway_contract_bwd(const void* x, const float* p, const float* gout,
                                    const int* slot_ptr, const int* slot_rows,
                                    const int* chunk_slot, const int* chunk_beg, void* dx,
                                    float* dp, int n_chunks, int S, int F, int K, int is_bf16,
                                    int vector, void* stream) {
  if (n_chunks <= 0 || F <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok =
      is_bf16 ? bwd_k<__nv_bfloat16>(K, x, p, gout, slot_ptr, slot_rows, chunk_slot,
                                     chunk_beg, dx, dp, n_chunks, S, F, vector, st)
              : bwd_k<float>(K, x, p, gout, slot_ptr, slot_rows, chunk_slot, chunk_beg, dx,
                             dp, n_chunks, S, F, vector, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
