// dma_row_gather: a per-row gather probe, every gathered row one TMA bulk copy.
//
//   out[r, l] = sum_e x3[src[e], 0, l]     for r < 8, l < 128 (all 8 rows equal)
//
// x3 is (N, 16, 128) f32 or bf16: one logical 2,048-wide row is one (16, 128)
// block of 8 KB (f32) or 4 KB (bf16).  The sum is taken in f32, chunk by
// chunk of te edges (the last chunk may be short); each chunk's sum starts
// from 0.0f and adds its rows in edge order, and the chunks' sums are added
// in chunk order.  No atomics: two calls are equal bit for bit.
//
// Replaces tools/bench_dma_gather.py:86 (the pallas_call inside build), the
// TPU probe that sets the issue-rate floor of a fused gather SpMM: te
// single-row async copies per grid step into a double-buffered (2, te, 16,
// 128) VMEM scratch, with almost no compute (the landed rows' first 128
// lanes are summed so the copies cannot be dropped).  Its grid runs in
// order and carries the sum in its output block; its scratch is 2 MB in f32,
// which no SM can hold.
//
// Design for Hopper: a persistent block on each SM, warp-specialised.
// - Grid: min(chunks, SMs x blocks an SM holds) blocks (one an SM with this
//   ring).  Block b takes chunks b, b + grid, b + 2 grid, ...; their rows,
//   in that order, are one stream, so the ring runs across chunk
//   boundaries: no chunk starts with an empty ring or ends with a drain.
// - Ring: RING_BYTES (224 KB) of dynamic shared memory in slots of
//   SLOT_ROWS whole rows (16 KB: 4 rows of bf16, 2 of f32; 14 slots), each
//   slot with a full and an empty mbarrier.
// - Producer: warp 4.  It reads the stream's indices straight from global
//   memory, 32 at a time, one a lane, a batch ahead of the copies.  For each
//   slot it waits on the slot's empty barrier, lane 0 sets the full
//   barrier's expected bytes once (arrive.expect_tx), and lanes 0 ..
//   SLOT_ROWS-1 each issue one cp.async.bulk (TMA, non-tensor) of one whole
//   row into the slot, completing on the full barrier through
//   mbarrier::complete_tx::bytes (bulk_copy in the producer branch below).
// - Consumers: warps 0-3, thread l owning lane l of sub-row 0.  Each waits
//   on a slot's full barrier, adds lane l of its rows into an f32 sum in
//   stream order, and each warp arrives once on the slot's empty barrier
//   (count 4), so a slot is refilled as soon as it is read.  Crossing a
//   chunk's last row, a thread writes the chunk's partial and starts again
//   from 0.0f.  No __syncthreads inside the loop.
// - A second launch (one block) adds the partials in chunk order and writes
//   the 8 rows.
//
// Bound: memory.  Every gathered row is one bulk copy of the whole row
// (E x 8 KB = 1.36 GB in f32 at E = 165,888, half that in bf16), against a
// byte bound of each input byte read once (x3 126 MB f32 / 63 MB bf16, src
// 0.66 MB); rows gathered again may hit the 50 MB L2, so what the design
// can reach is the card's rate of whole rows copied from L2 (and HBM) into
// shared memory, which it approaches by keeping up to 224 KB of copies in
// flight on every SM at all times.  The sum is E x 128 adds, far below any
// rate.
//
// Settled on an NVIDIA H100 80GB HBM3 at 700 W (probes/variants.py p1):
// one row a slot is slower in bf16 (the consumers' wait per row sets the
// pace); 32 KB slots, a ring of 112 or 72 KB (2 or 3 blocks an SM) and
// consumers that do not read the rows all time within a few percent of
// this build, whose rows from L2 arrive at the card's L2-to-shared-memory
// rate of whole rows (about 6 TB/s bf16, 6.6 f32).  ptxas: 28 (f32) and
// 31 (bf16) registers, 256 bytes of static shared memory (the barriers),
// no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;                  // lanes of one sub-row, one thread each
constexpr int CONSUMER_WARPS = LANES / 32;  // warps 0-3
constexpr int THREADS = LANES + 32;         // + the producer warp
constexpr int ROW = 16 * LANES;             // elements of one gathered row
constexpr int RING_BYTES = 224 * 1024;      // dynamic shared memory of the ring
constexpr int SLOT_ROWS_BF16 = 4;           // rows of a slot (16 KB)
constexpr int SLOT_ROWS_F32 = 2;            // rows of a slot (16 KB)
constexpr int TE_MAX = 1024;                // largest chunk
constexpr int FINAL_BATCH = 16;             // partials loaded before they are added

template <typename T>
struct Ring {
  static constexpr uint32_t ROW_BYTES = ROW * sizeof(T);
  static constexpr int R = sizeof(T) == 2 ? SLOT_ROWS_BF16 : SLOT_ROWS_F32;
  static constexpr int SLOTS = RING_BYTES / (R * ROW_BYTES);
  static_assert(32 % R == 0, "a slot's rows must divide the producer's index batch");
  static_assert(SLOTS >= 2, "the ring needs two slots");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into this block's shared memory, completing
// on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// rows of chunk c (te, or fewer for the last chunk)
__device__ __forceinline__ int chunk_len(long long c, int E, int te) {
  return (int)min((long long)te, (long long)E - c * te);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    gather_chunks_kernel(const T* __restrict__ x, const int* __restrict__ src,
                         float* __restrict__ partial, int E, int te, int n_chunks) {
  using C = Ring<T>;
  constexpr int R = C::R;
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t full[C::SLOTS];
  __shared__ __align__(8) uint64_t empty[C::SLOTS];
  T* ring = reinterpret_cast<T*>(ring_raw);

  // this block's chunks b, b + G, ...: one stream of n_rows rows
  const int b = blockIdx.x, G = gridDim.x;
  const int n_mine = (int)(((long long)n_chunks - b + G - 1) / G);
  const int n_rows = (n_mine - 1) * te + chunk_len(b + (n_mine - 1) * G, E, te);
  const int n_slots = (n_rows + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    // the barriers' init visible to the async proxy (the bulk copies)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= LANES) {
    // ---- producer warp
    const int lane = threadIdx.x - LANES;
    // src index of stream row k (0 past the stream's end)
    auto index_of = [&](int k) -> int {
      if (k >= n_rows) return 0;
      return __ldg(src + (long long)(b + (k / te) * G) * te + k % te);
    };
    int base = 0;  // stream row of cur's lane 0
    int cur = index_of(lane), next = index_of(32 + lane);
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_slots; ++i) {
      const int k0 = i * R;
      if (k0 - base == 32) {
        base += 32;
        cur = next;
        next = index_of(base + 32 + lane);
      }
      // the slot's previous rows read (passes at once on the first lap)
      mbar_wait(&empty[s], phase ^ 1);
      const int rows = min(R, n_rows - k0);
      const int id = __shfl_sync(0xffffffffu, cur, (k0 - base + lane) & 31);
      if (lane == 0) mbar_expect_tx(&full[s], rows * C::ROW_BYTES);
      __syncwarp();
      if (lane < rows)  // one whole row a lane
        bulk_copy(ring + (size_t)(s * R + lane) * ROW, x + (size_t)id * ROW, C::ROW_BYTES,
                  &full[s]);
      if (++s == C::SLOTS) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warps: thread l sums lane l of sub-row 0
    const int l = threadIdx.x;
    long long c = b;
    int left = chunk_len(c, E, te);
    float acc = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_slots; ++i) {
      mbar_wait(&full[s], phase);
      const int rows = min(R, n_rows - i * R);
      const T* st = ring + (size_t)s * R * ROW;
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = r < rows ? to_f32(st[(size_t)r * ROW + l]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          acc += v[r];
          if (--left == 0) {  // the chunk's last row: its partial is done
            partial[c * LANES + l] = acc;
            acc = 0.f;
            c += G;
            left = c < n_chunks ? chunk_len(c, E, te) : 0;
          }
        }
      }
      __syncwarp();  // every lane of this warp has read slot s
      if ((l & 31) == 0) mbar_arrive(&empty[s]);
      if (++s == C::SLOTS) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// out[r, l] = sum over chunks c, in chunk order, of partial[c, l]; 8 rows
__global__ void __launch_bounds__(LANES)
    add_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        int n_chunks) {
  const int l = threadIdx.x;
  float acc = 0.f;
  int c = 0;
  for (; c + FINAL_BATCH <= n_chunks; c += FINAL_BATCH) {
    float v[FINAL_BATCH];
#pragma unroll
    for (int j = 0; j < FINAL_BATCH; ++j) v[j] = partial[(size_t)(c + j) * LANES + l];
#pragma unroll
    for (int j = 0; j < FINAL_BATCH; ++j) acc += v[j];
  }
  for (; c < n_chunks; ++c) acc += partial[(size_t)c * LANES + l];
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * LANES + l] = acc;
}

template <typename T>
cudaError_t launch(const void* x3, const int* src, float* partial, int E, int te,
                   int n_chunks, cudaStream_t stream) {
  // the opt-in above 48 KB of dynamic shared memory, on the current device
  cudaError_t e = cudaFuncSetAttribute(gather_chunks_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_chunks_kernel<T>,
                                                         THREADS, RING_BYTES)) != cudaSuccess)
    return e;
  const int grid = (int)min((long long)n_chunks, (long long)sms * max(per_sm, 1));
  gather_chunks_kernel<T><<<grid, THREADS, RING_BYTES, stream>>>(
      static_cast<const T*>(x3), src, partial, E, te, n_chunks);
  return cudaSuccess;
}

}  // namespace

// C entry point.  x3: (N, 16, 128) bf16 (is_bf16=1) or f32, contiguous and
// 16-byte aligned; src: (E,) int32 rows of x3, each in [0, N); partial:
// (ceil(E / te), 128) f32 scratch; out: (8, 128) f32.  1 <= te <= 1024.
// E = 0 writes zeros.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int dma_row_gather(const void* x3, const int* src, float* partial, float* out,
                              int E, int te, int is_bf16, void* stream) {
  if (te < 1 || te > TE_MAX || E < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)(((long long)E + te - 1) / te);
  if (E > 0) {
    cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(x3, src, partial, E, te, n_chunks, s)
                            : launch<float>(x3, src, partial, E, te, n_chunks, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  add_partials_kernel<<<1, LANES, 0, s>>>(partial, out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
