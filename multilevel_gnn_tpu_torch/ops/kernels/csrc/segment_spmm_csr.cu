// segment_spmm_csr: deterministic CSR segmented reduction with the row
// gather fused in.
//
//   out[n, :] (+)= sum_{e in rowptr[n] .. rowptr[n+1]} w[eid[e]] * x[col[e], :]
//
// With bf16 x each weight is rounded to bf16 before the product, as the
// TPU kernel's bf16 weighted one-hot does (segment_sum.py:481-490), so
// every product is exact in f32.
//
// Replaces multilevel_gnn_tpu/ops/pallas/segment_sum.py:497 flat_segment_sum
// together with the XLA row gather that feeds it (take_ib(x2, flat_idx) in
// ops/spmm.py:156 and ops/pallas/windowed.py:741).  The TPU kernel contracts
// a (128 x te) one-hot against gathered message chunks on the MXU; on Hopper
// the gather is a plain coalesced row read, so the message matrix of
// E x F values is never written to device memory.
//
// Bound: memory.  Each edge reads a source row (from L2 when rows repeat)
// and each output row is written once; arithmetic is 2 flops per edge and
// feature.  The kernel keeps many row reads in flight, over rows the host
// listed:
//   - a warp per ordinary row (items) and chunk of F: lanes cover the
//     chunk in 16-byte vectors (8 a lane: a 4 KB bf16 row, half an f32
//     row at F = 2048, so each source row is read once, whole, per edge),
//     the row's edges are read 32 at a time, one per lane, and broadcast
//     by shuffles, and 1 (bf16) or 2 (f32) edges are unrolled, so 8 or 16
//     16-byte loads are in flight per lane (a thread of the block-per-row
//     kernel this replaces had 1); each element is summed in f32 in CSR
//     order;
//   - a block per long row (more than 64 edges, LONG_ROW in
//     segment_sum.py: the host's long_rows): its 8 warps take contiguous
//     eighths of the edges and add their partial sums in shared memory in
//     warp order;
//   - accumulate mode launches over the rows with edges only (the windowed
//     path's residual, tres and res_csc forms touch a few rows of N);
//     overwrite mode also lists the empty rows, which get zeros.
// No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// Features a lane covers: NV 16-byte vectors.  A warp item covers a chunk
// of WIDE vectors a lane (2,048 bf16 or 1,024 f32 features), so at F =
// 2048 a bf16 row is read whole by one warp, an f32 row by two warps side
// by side; a long-row block passes over F in chunks of LONG vectors a lane
// (its partial sums go through shared memory).
constexpr int WIDE = 8;
constexpr int LONG = 4;

template <typename T>
struct Traits {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
};

template <typename T, int NV>
struct Chunk {
  static constexpr int S = NV * Traits<T>::VEC;  // values per lane
  static constexpr int WIDTH = 32 * S;           // features per chunk
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// the edge weight as the product uses it
__device__ __forceinline__ float weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float weight(float w, const float*) { return w; }

__device__ __forceinline__ void unpack(const uint4& raw, const __nv_bfloat16*,
                                       float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, const float*,
                                       float* v) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Feature of a lane's value slot s in the chunk starting at f0.  VECTOR:
// 16-byte vector s / VEC of the lane, element s % VEC; scalar: one element
// per lane, lanes adjacent.
template <typename T, bool VECTOR>
__device__ __forceinline__ int feature(int f0, int lane, int s) {
  constexpr int VEC = Traits<T>::VEC;
  return VECTOR ? f0 + ((s / VEC) * 32 + lane) * VEC + s % VEC
                : f0 + s * 32 + lane;
}

// acc[s] = sum over edges beg .. end (CSR order) of w * x[col, feature(s)]
template <typename T, bool VECTOR, int NV>
__device__ __forceinline__ void row_sum(const int* __restrict__ col,
                                        const int* __restrict__ eid,
                                        const float* __restrict__ w,
                                        const T* __restrict__ x, int beg,
                                        int end, int F, int f0, int lane,
                                        float* acc) {
  constexpr int VEC = Traits<T>::VEC;
  constexpr int S = Chunk<T, NV>::S;
  // edges unrolled, each with its NV loads in flight: 1 for a wide bf16
  // chunk (its 64 sums and 8 loads fill the registers), else 2
  constexpr int U = !VECTOR ? 1 : (sizeof(T) == 2 && NV == WIDE ? 1 : 2);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;
  for (int b = beg; b < end; b += 32) {
    const int m = min(32, end - b);
    int my_c = 0;
    float my_w = 0.f;
    if (lane < m) {
      my_c = col[b + lane];
      my_w = weight(w[eid[b + lane]], x);
    }
    for (int k = 0; k < m; k += U) {
      int c[U];
      float we[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = __shfl_sync(FULL, my_c, (k + u) & 31);
        we[u] = __shfl_sync(FULL, my_w, (k + u) & 31);
      }
      if (VECTOR) {
        uint4 raw[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int f = feature<T, true>(f0, lane, v * VEC);
            raw[u][v] = (k + u < m && f < F)
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  x + (size_t)c[u] * F + f))
                            : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k + u >= m) break;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float vals[VEC];
            unpack(raw[u][v], x, vals);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[v * VEC + j] = fmaf(we[u], vals[j], acc[v * VEC + j]);
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int f = feature<T, false>(f0, lane, s);
          if (f < F)
            acc[s] = fmaf(we[0], to_f32(x[(size_t)c[0] * F + f]), acc[s]);
        }
      }
    }
  }
}

template <typename T, bool VECTOR, int NV>
__device__ __forceinline__ void write_row(float* __restrict__ orow,
                                          const float* acc, int F, int f0,
                                          int lane, int accumulate) {
  constexpr int S = Chunk<T, NV>::S;
  if (VECTOR) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const int f = feature<T, true>(f0, lane, s);
      if (f >= F) continue;
      float4* o = reinterpret_cast<float4*>(orow + f);
      float4 a = make_float4(acc[s], acc[s + 1], acc[s + 2], acc[s + 3]);
      if (accumulate) {
        const float4 p = *o;
        a.x += p.x;
        a.y += p.y;
        a.z += p.z;
        a.w += p.w;
      }
      *o = a;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int f = feature<T, false>(f0, lane, s);
      if (f < F) orow[f] = accumulate ? orow[f] + acc[s] : acc[s];
    }
  }
}

template <typename T, bool VECTOR>
__device__ __forceinline__ void long_row(const int* rowptr, const int* col,
                                         const int* eid, const float* w,
                                         const T* x, float* out, int n, int F,
                                         int accumulate) {
  // warp w sums its eighth of the edges, then the block adds the eight
  // partial sums in warp order
  constexpr int S = Chunk<T, LONG>::S;
  __shared__ float part[WARPS][32 * S];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int beg = rowptr[n];
  const int len = rowptr[n + 1] - beg;
  const int b = beg + (int)((long long)len * warp / WARPS);
  const int e = beg + (int)((long long)len * (warp + 1) / WARPS);
  float* orow = out + (size_t)n * F;
  float acc[S];
  for (int f0 = 0; f0 < F; f0 += Chunk<T, LONG>::WIDTH) {
    row_sum<T, VECTOR, LONG>(col, eid, w, x, b, e, F, f0, lane, acc);
#pragma unroll
    for (int s = 0; s < S; ++s) part[warp][s * 32 + lane] = acc[s];
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * S; i += THREADS) {
      float sum = part[0][i];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) sum += part[k][i];
      const int f = feature<T, VECTOR>(f0, i % 32, i / 32);
      if (f < F) orow[f] = accumulate ? orow[f] + sum : sum;
    }
    __syncthreads();  // part is rewritten by the next chunk
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 2)
    segment_spmm_csr_kernel(const int* __restrict__ rowptr,
                            const int* __restrict__ col,
                            const int* __restrict__ eid,
                            const float* __restrict__ w,
                            const int* __restrict__ items, int n_items,
                            const int* __restrict__ long_rows, int n_long,
                            int chunks, const T* __restrict__ x,
                            float* __restrict__ out, int F, int accumulate) {
  if (blockIdx.x < n_long) {
    long_row<T, VECTOR>(rowptr, col, eid, w, x, out, long_rows[blockIdx.x], F,
                        accumulate);
    return;
  }
  // warp items: (row, chunk), the chunks of a row on neighbouring warps
  const int item = (blockIdx.x - n_long) * WARPS + (threadIdx.x >> 5);
  if (item >= n_items * chunks) return;  // whole warp: no shuffle waits
  const int lane = threadIdx.x & 31;
  const int n = items[item / chunks];
  const int f0 = (item % chunks) * Chunk<T, WIDE>::WIDTH;
  float acc[Chunk<T, WIDE>::S];
  row_sum<T, VECTOR, WIDE>(col, eid, w, x, rowptr[n], rowptr[n + 1], F, f0,
                           lane, acc);
  write_row<T, VECTOR, WIDE>(out + (size_t)n * F, acc, F, f0, lane,
                             accumulate);
}

template <typename T>
int launch(const int* rowptr, const int* col, const int* eid, const float* w,
           const int* items, int n_items, const int* long_rows, int n_long,
           const void* x, float* out, int F, int accumulate, int vector,
           cudaStream_t stream) {
  const int chunks = (F + Chunk<T, WIDE>::WIDTH - 1) / Chunk<T, WIDE>::WIDTH;
  const long long warps = (long long)n_items * chunks;
  const int blocks = n_long + (int)((warps + WARPS - 1) / WARPS);
  if (blocks == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  if (vector)
    segment_spmm_csr_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
        rowptr, col, eid, w, items, n_items, long_rows, n_long, chunks, xt,
        out, F, accumulate);
  else
    segment_spmm_csr_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
        rowptr, col, eid, w, items, n_items, long_rows, n_long, chunks, xt,
        out, F, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point.  x is bf16 (is_bf16=1) or f32, row-major (rows, F); out is
// f32 (n_rows, F).  items lists the rows one warp each sums (n_items of
// them), long_rows those a block each sums; together they must cover every
// row to be written (in overwrite mode every row, empty ones included).
// vector=1 promises F % 8 == 0 and 16-byte aligned x and out.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int segment_spmm_csr(const int* rowptr, const int* col,
                                const int* eid, const float* w,
                                const int* items, const int* long_rows,
                                const void* x, float* out, int n_items,
                                int n_long, int F, int is_bf16,
                                int accumulate, int vector, void* stream) {
  if (F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(rowptr, col, eid, w, items, n_items,
                                 long_rows, n_long, x, out, F, accumulate,
                                 vector, s);
  return launch<float>(rowptr, col, eid, w, items, n_items, long_rows, n_long,
                       x, out, F, accumulate, vector, s);
}
