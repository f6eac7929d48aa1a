// Kernel B1 (murmur3 bucket ids) at k = 1 as a TMA pipeline: a variant
// measured against hyperspace_tpu_torch/csrc/murmur3_bucket.cu by
// scripts/torch_b1_variants.py, not used by the package.
//
// Persistent blocks (as many as are resident at once) each walk chunks of
// ROWS rows. Thread 0 keeps a ring of STAGES shared-memory stages filled
// with 1-D bulk copies (cp.async.bulk, completion counted in bytes on one
// mbarrier per stage); every thread hashes pairs of rows out of the stage
// that has arrived, stores two bucket ids with one 8-byte store, and after
// a block barrier thread 0 refills the stage with the chunk STAGES ahead.
// The rows after the last whole chunk take a scalar path. Same arithmetic
// and remainder constant as the package kernel; the reps' plane and the
// output must be 16-byte aligned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, unsigned r) {
  return __funnelshift_l(x, x, r);
}
__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}
__device__ __forceinline__ uint32_t mix_rep(uint32_t h, uint64_t u) {
  h = mix_word(h, (uint32_t)u);
  return mix_word(h, (uint32_t)(u >> 32));
}
__device__ __forceinline__ int32_t finish(uint32_t h, uint32_t len, uint64_t m,
                                          uint32_t d) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const uint64_t low = m * (uint64_t)h;
  const uint64_t t =
      (uint64_t)(uint32_t)(low >> 32) * d + __umulhi((uint32_t)low, d);
  return (int32_t)(t >> 32);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

constexpr int kThreads = 256;

template <int ROWS, int STAGES>
__global__ void __launch_bounds__(kThreads)
    b1_tma_kernel(const int64_t* __restrict__ reps, int32_t* __restrict__ out,
                  int64_t n, uint64_t m, uint32_t d, uint32_t seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  int64_t* ring = reinterpret_cast<int64_t*>(smem);
  const int64_t chunks = n / ROWS;
  const int64_t mine =
      chunks > blockIdx.x ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int64_t i = 0; i < STAGES && i < mine; ++i) {
      const int64_t c = blockIdx.x + i * gridDim.x;
      mbar_expect_tx(&full[i], ROWS * 8);
      bulk_g2s(ring + i * ROWS, reps + c * ROWS, ROWS * 8, &full[i]);
    }
  }
  for (int64_t i = 0; i < mine; ++i) {
    const int s = (int)(i % STAGES);
    mbar_wait(&full[s], (unsigned)((i / STAGES) & 1));
    const int64_t c = blockIdx.x + i * gridDim.x;
    const longlong2* st = reinterpret_cast<const longlong2*>(ring + s * ROWS);
#pragma unroll
    for (int p = threadIdx.x; p < ROWS / 2; p += kThreads) {
      const longlong2 v = st[p];
      const uint32_t h0 = mix_rep(seed, (uint64_t)v.x);
      const uint32_t h1 = mix_rep(seed, (uint64_t)v.y);
      *reinterpret_cast<int2*>(out + c * ROWS + 2 * p) =
          make_int2(finish(h0, 8, m, d), finish(h1, 8, m, d));
    }
    __syncthreads();
    if (threadIdx.x == 0 && i + STAGES < mine) {
      const int64_t c2 = blockIdx.x + (i + STAGES) * gridDim.x;
      mbar_expect_tx(&full[s], ROWS * 8);
      bulk_g2s(ring + s * ROWS, reps + c2 * ROWS, ROWS * 8, &full[s]);
    }
  }
  if (blockIdx.x == 0) {
    for (int64_t row = chunks * ROWS + threadIdx.x; row < n; row += kThreads)
      out[row] = finish(mix_rep(seed, (uint64_t)__ldg(reps + row)), 8, m, d);
  }
}

template <int ROWS, int STAGES>
int launch(const int64_t* r, int32_t* o, int64_t n, uint64_t m, uint32_t d,
           uint32_t s, int* grid, cudaStream_t st) {
  const int smem = ROWS * 8 * STAGES;
  auto kern = b1_tma_kernel<ROWS, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > n / ROWS) blocks = n / ROWS;
  if (blocks < 1) blocks = 1;
  *grid = (int)blocks;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(r, o, n, m, d, s);
  return cudaGetLastError();
}

}  // namespace

// reps: [1, n] int64 and out: [n] int32, both 16-byte aligned, on the
// device; config picks (ROWS, STAGES); *grid receives the blocks launched.
extern "C" int b1_tma(const void* reps, void* out, int64_t n, uint64_t m,
                      int64_t d, int64_t seed, int config, int* grid,
                      void* stream) {
  if (n == 0) return 0;
  if (reinterpret_cast<uintptr_t>(reps) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  auto r = static_cast<const int64_t*>(reps);
  auto o = static_cast<int32_t*>(out);
  auto dd = (uint32_t)d;
  auto ss = (uint32_t)seed;
  auto st = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch<2048, 4>(r, o, n, m, dd, ss, grid, st);
    case 1: return launch<4096, 4>(r, o, n, m, dd, ss, grid, st);
    case 2: return launch<1024, 8>(r, o, n, m, dd, ss, grid, st);
    case 3: return launch<8192, 3>(r, o, n, m, dd, ss, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
