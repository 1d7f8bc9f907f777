// dma_row_gather: a per-row gather probe, every gathered row one TMA bulk copy.
//
//   out[r, l] = sum_e x3[src[e], 0, l]     for r < 8, l < 128 (all 8 rows equal)
//
// x3 is (N, 16, 128) f32 or bf16: one logical 2,048-wide row is one (16, 128)
// block of 8 KB (f32) or 4 KB (bf16).  The sum is taken in f32, chunk by
// chunk of te edges (the last chunk may be short); each chunk's sum adds its
// rows in edge order, and the chunks' sums are added in chunk order.
//
// Replaces tools/bench_dma_gather.py:86 (the pallas_call inside build), the
// TPU probe that sets the issue-rate floor of a fused gather SpMM: te
// single-row async copies per grid step into a double-buffered (2, te, 16,
// 128) VMEM scratch, with almost no compute (the landed rows' first 128
// lanes are summed so the copies cannot be dropped).  Its grid runs in
// order and carries the sum in its output block; its scratch is 2 MB in f32,
// which no SM can hold.
//
// Design for Hopper.  One block of 128 threads per chunk of te edges.  The
// chunk's te indices are staged in shared memory; one elected thread
// (thread 0) issues one cp.async.bulk (TMA, non-tensor) per gathered row, the
// whole 8 or 4 KB row, into a ring of STAGES stages x R rows in dynamic
// shared memory (32 KB a stage: 4 rows of f32 or 8 of bf16; 128 KB in all),
// each stage completing on its own mbarrier through
// mbarrier::complete_tx::bytes after arrive.expect_tx of the stage's bytes.
// All 128 threads consume: each waits on the stage's phase parity, adds
// lane l of sub-row 0 of each landed row into its f32 sum in edge order,
// and after a __syncthreads (the stage released) thread 0 refills the
// stage with the rows STAGES stages ahead.  Each block writes its chunk's
// (128,) f32 partial; a second launch (one block) adds the partials in chunk
// order and writes the 8 rows.  No atomics: two calls are equal bit for bit.
//
// Bound: memory.  Every gathered row is one bulk copy of the whole row
// (E x 8 KB = 1.36 GB in f32 at E = 165,888, half that in bf16), against a
// byte bound of each input byte read once (x3 126 MB f32 / 63 MB bf16, src
// 0.66 MB); rows gathered again may hit the 50 MB L2.  The sum is E x 128
// adds, far below any rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;                 // lanes of one sub-row, one thread each
constexpr int ROW = 16 * LANES;            // elements of one gathered row
constexpr int STAGES = 4;                  // ring depth
constexpr int STAGE_BYTES = 32 * 1024;     // bytes of one stage
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int TE_MAX = 1024;               // largest chunk the index stage holds
constexpr int FINAL_BATCH = 16;            // partials loaded before they are added

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

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

template <typename T>
__global__ void __launch_bounds__(LANES)
    gather_chunks_kernel(const T* __restrict__ x, const int* __restrict__ src,
                         float* __restrict__ partial, int E, int te) {
  constexpr uint32_t ROW_BYTES = ROW * sizeof(T);
  constexpr int R = STAGE_BYTES / ROW_BYTES;  // rows a stage
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int ids[TE_MAX];
  T* ring = reinterpret_cast<T*>(ring_raw);

  const int c = blockIdx.x;
  const int l = threadIdx.x;
  const long long begin = (long long)c * te;
  const int len = (int)min((long long)te, (long long)E - begin);
  const int n_st = (len + R - 1) / R;

  for (int j = l; j < len; j += LANES) ids[j] = src[begin + j];
  if (l == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    // the barriers' init visible to the async proxy (the bulk copies)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: stage i of the chunk into ring slot i % STAGES
  auto issue = [&](int i) {
    const int s = i % STAGES;
    const int first = i * R;
    const int rows = min(R, len - first);
    mbar_expect_tx(&full[s], rows * ROW_BYTES);
    for (int r = 0; r < rows; ++r)
      bulk_copy(ring + (size_t)(s * R + r) * ROW, x + (size_t)ids[first + r] * ROW,
                ROW_BYTES, &full[s]);
  };
  if (l == 0)
    for (int i = 0; i < STAGES && i < n_st; ++i) issue(i);

  float acc = 0.f;
  for (int i = 0; i < n_st; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (uint32_t)((i / STAGES) & 1));
    const int rows = min(R, len - i * R);
    const T* st = ring + (size_t)s * R * ROW;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows) acc += to_f32(st[(size_t)r * ROW + l]);
    __syncthreads();  // every thread has read slot s: it may be refilled
    if (l == 0 && i + STAGES < n_st) issue(i + STAGES);
  }
  partial[(size_t)c * LANES + l] = acc;
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
                   cudaStream_t stream) {
  // the opt-in above 48 KB of dynamic shared memory, on the current device
  cudaError_t e = cudaFuncSetAttribute(gather_chunks_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (e != cudaSuccess) return e;
  const int n_chunks = (E + te - 1) / te;
  gather_chunks_kernel<T><<<n_chunks, LANES, RING_BYTES, stream>>>(
      static_cast<const T*>(x3), src, partial, E, te);
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
  if (E > 0) {
    cudaError_t e = is_bf16 ? launch<__nv_bfloat16>(x3, src, partial, E, te, s)
                            : launch<float>(x3, src, partial, E, te, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_chunks = (E + te - 1) / te;
  add_partials_kernel<<<1, LANES, 0, s>>>(partial, out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
