// sorted_segment_sum: batched segment-sum of rows already grouped by segment.
//
//   out[b, n, :] = sum_{i in rowptr[n] .. rowptr[n+1]} data[b, src(i), :]
//   src(i) = perm ? perm[i] : i
//
// Replaces multilevel_gnn_tpu/ops/pallas/segment_sum.py:286 sorted_segment_sum
// (3-D data, K4a) and :384 _sorted_segment_sum_2d (2-D data, K4b: B = 1).
// The TPU kernels contract a (128 x te) one-hot against tile-major chunks of
// the sorted rows on the MXU, with the batch as a grid axis and a transpose
// of the (N, B, C) result afterwards.  On Hopper a segment's rows are a
// contiguous run of the sorted order, so a warp sums them directly in
// registers and writes (B, N, C) in place: no one-hot, no chunk padding, no
// transpose.  With perm, the rows are read through it (segment_sum_by on
// data in its original order), so no permuted copy is written.
//
// Design: one warp per (segment, batch) pair, warps ordered batch-major so
// that the warps of a block read one contiguous stretch of data[b] and write
// consecutive output rows.  A lane owns 8 consecutive features (one 16-byte
// load of bf16, two of f32).  When C/8 < 32 the warp splits into row groups
// that read different rows of the segment at once, and the groups' partial
// sums are added with warp shuffles in a fixed order: deterministic, no
// atomics.  Empty segments write 0.
//
// Bound: memory.  Each kept row is read once and each output element
// written once; one add per element read, far below the f32 rate.
//
// bf16 inputs convert to f32 exactly, so both dtypes sum exact values in f32
// (the TPU kernel's bf16 one-hot product and f32 3-limb split do the same).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;          // features per lane per slot
constexpr int WARPS = 8;        // warps per block

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

// slots: lanes per row group (a power of two, 1..32); groups = 32 / slots
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(WARPS * 32) sorted_segment_sum_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ perm,
    const T* __restrict__ data, float* __restrict__ out, int B, int N,
    int E, int C, int slots) {
  const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
  if (warp >= B * N) return;  // whole warp leaves together
  const int lane = threadIdx.x % 32;
  const int b = warp / N;
  const int n = warp - b * N;
  const int beg = rowptr[n];
  const int end = rowptr[n + 1];
  const int groups = 32 / slots;
  const int g = lane / slots;
  const int s = lane - g * slots;
  const T* base = data + (size_t)b * E * C;
  float* orow = out + ((size_t)b * N + n) * C;
  const int n_vec = (C + VEC - 1) / VEC;
  // every lane runs the same number of passes, so all take part in the
  // shuffles; a lane past the last slot only adds zeros
  for (int p0 = 0; p0 < n_vec; p0 += slots) {
    const bool active = p0 + s < n_vec;
    const int f = (p0 + s) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int i = beg + g; active && i < end; i += groups) {
      const int r = perm ? perm[i] : i;
      const T* xr = base + (size_t)r * C + f;
      if (VECTOR) {
        float v[VEC];
        load8(xr, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += v[j];
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (f + j < C) acc[j] += to_f32(xr[j]);
      }
    }
    // add the row groups' partial sums: lanes s, s + slots, ... hold the
    // same features; every lane takes part in every shuffle
    for (int off = slots; off < 32; off *= 2) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (g == 0 && active) {
      if (VECTOR) {
        float4* o = reinterpret_cast<float4*>(orow + f);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
        for (int j = 0; j < VEC && f + j < C; ++j) orow[f + j] = acc[j];
      }
    }
  }
}

template <typename T>
void launch(const int* rowptr, const int* perm, const void* data, float* out,
            int B, int N, int E, int C, int vector, cudaStream_t stream) {
  const int n_vec = (C + VEC - 1) / VEC;
  int slots = 1;
  while (slots < n_vec && slots < 32) slots *= 2;
  const long long warps = (long long)B * N;
  const int blocks = (int)((warps + WARPS - 1) / WARPS);
  const T* d = static_cast<const T*>(data);
  if (vector)
    sorted_segment_sum_kernel<T, true><<<blocks, WARPS * 32, 0, stream>>>(
        rowptr, perm, d, out, B, N, E, C, slots);
  else
    sorted_segment_sum_kernel<T, false><<<blocks, WARPS * 32, 0, stream>>>(
        rowptr, perm, d, out, B, N, E, C, slots);
}

}  // namespace

// C entry point.  data is bf16 (is_bf16=1) or f32, row-major (B, E, C); out
// is f32 (B, N, C); rowptr (N + 1) int32 indexes positions 0..rowptr[N] of
// the sorted order; perm (rowptr[N],) int32 maps a sorted position to its
// row of data, or is null when data is already sorted.  vector=1 promises
// C % 8 == 0 and 16-byte aligned data and out.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int sorted_segment_sum(const int* rowptr, const int* perm,
                                  const void* data, float* out, int B, int N,
                                  int E, int C, int is_bf16, int vector,
                                  void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(rowptr, perm, data, out, B, N, E, C, vector, s);
  else
    launch<float>(rowptr, perm, data, out, B, N, E, C, vector, s);
  return static_cast<int>(cudaGetLastError());
}
