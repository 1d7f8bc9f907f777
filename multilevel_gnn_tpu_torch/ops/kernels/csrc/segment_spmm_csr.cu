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
// feature.  The kernel keeps many row reads in flight, over three classes
// of rows the plan lists (segment_sum.py: LONG_ROW, SPLIT_ROW):
//   - a warp per ordinary row (items, 1 .. LONG_ROW entries) and chunk of
//     F: lanes cover the chunk in 16-byte vectors (8 a lane: a 4 KB bf16
//     row, half an f32 row at F = 2048, so each source row is read once,
//     whole, per edge), the row's edges are read 32 at a time, one per
//     lane, and broadcast by shuffles, and 1 (bf16) or 2 (f32) edges are
//     unrolled, so 8 or 16 16-byte loads are in flight per lane; each
//     element is summed in f32 in CSR order;
//   - a block per long row (long_rows, up to SPLIT_ROW entries): its 8
//     warps take contiguous eighths of the edges and add their partial
//     sums in shared memory in warp order;
//   - a long row's block work spread over the card for the longest rows
//     (split_rows): a row of len entries is cut into n = ceil(len /
//     SPLIT_ROW) chunks of consecutive entries (chunk k: entries len * k /
//     n .. len * (k + 1) / n), a block each, summed as a long row into an
//     f32 partial row of the workspace; the block that takes the row's
//     last ticket (an atomic counter after __threadfence(), which it sets
//     back to 0) adds the n partial rows, its warp w the chunks n * w / 8
//     .. n * (w + 1) / 8 in chunk order, then the warps' sums in warp
//     order, and writes the row (or adds it into out).  Which block comes
//     last does not change the order, so two calls give equal bits;
//   - block work reads a row in passes of NB 16-byte vectors a lane and
//     unrolls 8 / NB edges: NB = 1 for a row of 512 bytes (F 128 f32, the
//     edge-id lookup's), so no vector slot is masked out, else 4;
//   - narrow rows (vector path, under 512 bytes: F 64 f32, F 128 bf16)
//     split the warp into groups of G lanes (G the power of two at or
//     above the row's 16-byte vectors), each group reading another entry
//     in the same instruction (group g the entries g, g + 32 / G, ...; 4
//     entries of a group in flight); the groups' sums are added by a
//     butterfly of shuffles (the same tree in every call);
//   - accumulate mode launches over the rows with edges only (the windowed
//     path's residual, tres and res_csc forms touch a few rows of N);
//     overwrite mode also lists the empty rows, which get zeros.
// A plan built on the device pads its lists to bounds known from the
// shapes with -1; such an item exits at once, as does a warp item whose row
// is empty in accumulate mode.  The tickets are the only atomics, and they
// order nothing: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// 16-byte vectors a lane covers.  A warp item covers a chunk of WIDE
// vectors a lane (2,048 bf16 or 1,024 f32 features), so at F = 2048 a bf16
// row is read whole by one warp, an f32 row by two warps side by side;
// block work passes over F in chunks of NB vectors a lane (LONG on the
// scalar path), its partial sums going through shared memory.
constexpr int WIDE = 8;
constexpr int LONG = 4;
constexpr int NARROW_U = 4;  // entries of a lane group in flight

template <typename T>
struct Traits {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
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

// Feature of value slot s of lane l (its index in a group of G lanes) in
// the chunk starting at f0.  VECTOR: 16-byte vector s / VEC of the lane,
// element s % VEC; scalar: one element per lane, lanes adjacent (G = 32).
template <typename T, bool VECTOR>
__device__ __forceinline__ int feature(int f0, int l, int s, int G) {
  constexpr int VEC = Traits<T>::VEC;
  return VECTOR ? f0 + ((s / VEC) * G + l) * VEC + s % VEC
                : f0 + s * 32 + l;
}

// acc[s] = sum over entries beg .. end of w * x[col, feature(s)], NV
// vectors a lane, U entries in flight per lane.  Without NARROW the warp
// reads one entry at a time (G = 32) and sums in CSR order; with NARROW, G
// = Gn < 32 lanes read an entry, group g the entries g, g + 32 / G, ...
// in order, and a butterfly over the groups leaves the row's sums in every
// group.
template <typename T, bool VECTOR, int NV, int U, bool NARROW>
__device__ __forceinline__ void range_sum(const int* __restrict__ col,
                                          const int* __restrict__ eid,
                                          const float* __restrict__ w,
                                          const T* __restrict__ x, int beg,
                                          int end, int F, int f0, int lane,
                                          int Gn, float* acc) {
  constexpr int VEC = Traits<T>::VEC;
  constexpr int S = NV * VEC;
  const int G = NARROW ? Gn : 32;
  const int groups = NARROW ? 32 / G : 1;
  const int g = NARROW ? lane / G : 0;
  const int l = NARROW ? lane & (G - 1) : lane;
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
    for (int k = 0; k < m; k += U * groups) {
      int c[U];
      float we[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = (k + u * groups + g) & 31;
        c[u] = __shfl_sync(FULL, my_c, j);
        we[u] = __shfl_sync(FULL, my_w, j);
      }
      if (VECTOR) {
        uint4 raw[U][NV];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int f = feature<T, true>(f0, l, v * VEC, G);
            raw[u][v] = (k + u * groups + g < m && f < F)
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  x + (size_t)c[u] * F + f))
                            : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k + u * groups + g >= m) break;
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
        for (int u = 0; u < U; ++u) {
          if (k + u >= m) break;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int f = feature<T, false>(f0, lane, s, 32);
            if (f < F)
              acc[s] = fmaf(we[u], to_f32(x[(size_t)c[u] * F + f]), acc[s]);
          }
        }
      }
    }
  }
  if (NARROW) {
    for (int off = G; off < 32; off <<= 1)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] += __shfl_xor_sync(FULL, acc[s], off);
  }
}

// a warp item's sums into its output row (the first group's lanes)
template <typename T, bool VECTOR, int NV>
__device__ __forceinline__ void write_row(float* __restrict__ orow,
                                          const float* acc, int F, int f0,
                                          int lane, int G, int accumulate) {
  constexpr int S = NV * Traits<T>::VEC;
  if (lane >= G) return;
  if (VECTOR) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const int f = feature<T, true>(f0, lane, s, G);
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
      const int f = feature<T, false>(f0, lane, s, 32);
      if (f < F) orow[f] = accumulate ? orow[f] + acc[s] : acc[s];
    }
  }
}

// Block work: the entries beg .. end summed into dst (an output row, or a
// chunk's partial row with accumulate 0).  Warp w sums its eighth of the
// entries, then the block adds the eight sums in warp order.  part holds
// WARPS x 32 x S floats.
template <typename T, bool VECTOR, int NV, int U, bool NARROW>
__device__ __forceinline__ void block_sum(const int* col, const int* eid,
                                          const float* w, const T* x,
                                          int beg, int end, float* dst,
                                          int F, int Gn, int accumulate,
                                          float* part) {
  constexpr int VEC = Traits<T>::VEC;
  constexpr int S = NV * VEC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = NARROW ? Gn : 32;
  const int len = end - beg;
  const int b = beg + (int)((long long)len * warp / WARPS);
  const int e = beg + (int)((long long)len * (warp + 1) / WARPS);
  const int width = VECTOR ? G * NV * VEC : 32 * S;  // features a pass
  float acc[S];
  for (int f0 = 0; f0 < F; f0 += width) {
    range_sum<T, VECTOR, NV, U, NARROW>(col, eid, w, x, b, e, F, f0, lane,
                                        G, acc);
#pragma unroll
    for (int s = 0; s < S; ++s) part[(warp * S + s) * 32 + lane] = acc[s];
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * S; i += THREADS) {
      const int l = i % 32;
      if (l >= G) continue;  // the other groups hold the same sums
      float sum = part[i];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) sum += part[k * 32 * S + i];
      const int f = feature<T, VECTOR>(f0, l, i / 32, G);
      if (f < F) dst[f] = accumulate ? dst[f] + sum : sum;
    }
    __syncthreads();  // part is rewritten by the next pass
  }
}

// A split row's n partial rows (chunks c0 .. c0 + n of partial) added in
// chunk order by each warp's run of chunks, the runs in warp order, into
// the output row.  Partial rows written by other blocks are read from L2.
template <int S>
__device__ __forceinline__ void combine(const float* partial, int c0, int n,
                                        float* orow, int F, int accumulate,
                                        float* part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a = c0 + (int)((long long)n * warp / WARPS);
  const int b = c0 + (int)((long long)n * (warp + 1) / WARPS);
  for (int f0 = 0; f0 < F; f0 += 32 * S) {
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
#pragma unroll 2
    for (int c = a; c < b; ++c) {
      const float* p = partial + (size_t)c * F + f0 + lane;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (f0 + s * 32 + lane < F) acc[s] += __ldcg(p + s * 32);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) part[(warp * S + s) * 32 + lane] = acc[s];
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * S; i += THREADS) {
      const int f = f0 + i;
      if (f >= F) continue;
      float sum = part[i];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) sum += part[k * 32 * S + i];
      orow[f] = accumulate ? orow[f] + sum : sum;
    }
    __syncthreads();
  }
}

// NB: 16-byte vectors a lane of block work (wide rows); NARROW: rows under
// 512 bytes, read by groups of G lanes in every class.
template <typename T, bool VECTOR, int NB, bool NARROW>
__global__ void __launch_bounds__(THREADS, 2) segment_spmm_csr_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const int* __restrict__ eid, const float* __restrict__ w,
    const int* __restrict__ items, int n_items,
    const int* __restrict__ long_rows, int n_long,
    const int* __restrict__ split_rows, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_row, int n_chunks,
    float* __restrict__ partial, int* __restrict__ tickets, int chunks,
    const T* __restrict__ x, float* __restrict__ out, int F, int G,
    int accumulate) {
  constexpr int VEC = Traits<T>::VEC;
  constexpr int NBV = NARROW ? 1 : NB;
  constexpr int UB = NARROW ? NARROW_U : (VECTOR ? 8 / NB : 1);
  constexpr int S = NBV * VEC;
  __shared__ float part[WARPS * 32 * S];
  __shared__ int last;
  int blk = blockIdx.x;
  if (blk < n_chunks) {
    const int s = chunk_row[blk];
    if (s < 0) return;
    const int c0 = chunk_ptr[s];
    const int n = chunk_ptr[s + 1] - c0;
    const int k = blk - c0;
    const int r = split_rows[s];
    const int beg = rowptr[r];
    const int len = rowptr[r + 1] - beg;
    block_sum<T, VECTOR, NBV, UB, NARROW>(
        col, eid, w, x, beg + (int)((long long)len * k / n),
        beg + (int)((long long)len * (k + 1) / n), partial + (size_t)blk * F,
        F, G, 0, part);
    __threadfence();  // this block's partial row before its ticket
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(tickets + s, 1) == n - 1;
      if (last) tickets[s] = 0;  // ready for the next call
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    combine<S>(partial, c0, n, out + (size_t)r * F, F, accumulate, part);
    return;
  }
  blk -= n_chunks;
  if (blk < n_long) {
    const int r = long_rows[blk];
    if (r < 0) return;
    block_sum<T, VECTOR, NBV, UB, NARROW>(col, eid, w, x, rowptr[r],
                                          rowptr[r + 1], out + (size_t)r * F,
                                          F, G, accumulate, part);
    return;
  }
  blk -= n_long;
  // warp items: (row, chunk), the chunks of a row on neighbouring warps
  const int item = blk * WARPS + (threadIdx.x >> 5);
  if (item >= n_items * chunks) return;  // whole warp: no shuffle waits
  const int lane = threadIdx.x & 31;
  const int n = items[item / chunks];
  if (n < 0) return;
  const int beg = rowptr[n];
  const int end = rowptr[n + 1];
  if (accumulate && end == beg) return;
  if constexpr (NARROW) {
    float acc[VEC];
    range_sum<T, true, 1, NARROW_U, true>(col, eid, w, x, beg, end, F, 0,
                                          lane, G, acc);
    write_row<T, true, 1>(out + (size_t)n * F, acc, F, 0, lane, G,
                          accumulate);
  } else {
    // edges unrolled, each with its WIDE loads in flight: 1 for bf16 (its
    // 64 sums and 8 loads fill the registers), else 2
    constexpr int UW = !VECTOR ? 1 : (sizeof(T) == 2 ? 1 : 2);
    const int f0 = (item % chunks) * (32 * WIDE * VEC);
    float acc[WIDE * VEC];
    range_sum<T, VECTOR, WIDE, UW, false>(col, eid, w, x, beg, end, F, f0,
                                          lane, 32, acc);
    write_row<T, VECTOR, WIDE>(out + (size_t)n * F, acc, F, f0, lane, 32,
                               accumulate);
  }
}

struct Launch {
  const int *rowptr, *col, *eid;
  const float* w;
  const int *items, *long_rows, *split_rows, *chunk_ptr, *chunk_row;
  float* partial;
  int* tickets;
  const void* x;
  float* out;
  int n_items, n_long, n_chunks, F, accumulate;
};

template <typename T, bool VECTOR, int NB, bool NARROW>
int run(const Launch& a, int blocks, int chunks, int G, cudaStream_t stream) {
  segment_spmm_csr_kernel<T, VECTOR, NB, NARROW>
      <<<blocks, THREADS, 0, stream>>>(
          a.rowptr, a.col, a.eid, a.w, a.items, a.n_items, a.long_rows,
          a.n_long, a.split_rows, a.chunk_ptr, a.chunk_row, a.n_chunks,
          a.partial, a.tickets, chunks, static_cast<const T*>(a.x), a.out,
          a.F, G, a.accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Launch& a, int vector, cudaStream_t stream) {
  constexpr int VEC = Traits<T>::VEC;
  const int bytes = a.F * (int)sizeof(T);
  const bool narrow = vector && bytes < 512;
  int G = 32;
  if (narrow)
    for (G = 1; G * 16 < bytes; G <<= 1) {
    }
  const int chunks =
      narrow ? 1 : (a.F + 32 * WIDE * VEC - 1) / (32 * WIDE * VEC);
  const long long warps = (long long)a.n_items * chunks;
  const long long blocks =
      (long long)a.n_chunks + a.n_long + (warps + WARPS - 1) / WARPS;
  if (blocks == 0) return 0;
  const int nb = (int)blocks;
  if (!vector) return run<T, false, LONG, false>(a, nb, chunks, G, stream);
  if (narrow) return run<T, true, 1, true>(a, nb, chunks, G, stream);
  if (bytes == 512) return run<T, true, 1, false>(a, nb, chunks, G, stream);
  return run<T, true, LONG, false>(a, nb, chunks, G, stream);
}

}  // namespace

// C entry point.  x is bf16 (is_bf16=1) or f32, row-major (rows, F); out is
// f32 (n_rows, F).  items lists the rows one warp each sums (n_items of
// them), long_rows those a block each sums, split_rows those cut into
// chunks (chunk_ptr, chunk_row: n_chunks chunks, a block each); together
// they must cover every row to be written (in overwrite mode every row,
// empty ones included).  A -1 in items, long_rows or chunk_row is skipped.
// partial is an (n_chunks, F) f32 workspace and tickets one int a split row,
// 0 on entry and on return; neither may be shared with a call that could
// run at the same time.  vector=1 promises F % 8 == 0 and 16-byte aligned
// x and out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int segment_spmm_csr(const int* rowptr, const int* col,
                                const int* eid, const float* w,
                                const int* items, const int* long_rows,
                                const int* split_rows, const int* chunk_ptr,
                                const int* chunk_row, float* partial,
                                int* tickets, const void* x, float* out,
                                int n_items, int n_long, int n_chunks, int F,
                                int is_bf16, int accumulate, int vector,
                                void* stream) {
  if (F <= 0) return 0;
  const Launch a{rowptr,    col,       eid,     w,       items,
                 long_rows, split_rows, chunk_ptr, chunk_row, partial,
                 tickets,   x,         out,     n_items, n_long,
                 n_chunks,  F,         accumulate};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(a, vector, s);
  return launch<float>(a, vector, s);
}
