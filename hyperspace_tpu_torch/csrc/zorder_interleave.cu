// Z-address bit interleave (kernel B6).
//
// Replaces hyperspace_tpu/ops/zorder.py::_interleave (an XLA program at
// zorder.py:60, not a Pallas kernel): [k, n] uint32 words, each below
// 2^bits (1 <= bits <= 32), become [ceil(k * bits / 32), n] uint32 planes,
// most significant first. Z-bit t (counted from the most significant) is
// bit bits - 1 - t / k of column t % k, stored at bit 31 - t % 32 of plane
// t / 32; when k * bits is not a multiple of 32 the last plane's low bits
// are zero. Bit-identical to ops/zorder.py::interleave_torch (the plain
// PyTorch version). The reference builds the planes with k * bits passes
// of whole-array adds; here each thread owns one row.
//
// Bound: it reads 4k bytes and writes 4 * nplanes bytes a row and reuses
// nothing, so HBM bandwidth bounds it when the arithmetic stays small: at
// 6,001,215 rows, k = 1 moves 48.0 MB (14.3 us at the 3.35 TB/s of an
// H100 SXM) and k = 2 moves 72.0 MB (21.5 us).
//
// Design:
// * One thread a row, a grid-stride loop over rows. A warp's loads of one
//   column and its stores of one plane each cover 128 contiguous bytes.
//   The words are 4-byte values, so any view of them is aligned enough.
// * Column j's bit b lands at bit b * k + (k - 1 - j) of the k * bits-bit
//   z-address (counted from the least significant), so the address is the
//   OR of each word spread by k and shifted by k - 1 - j, then shifted up
//   by the padding 32 * nplanes - k * bits and cut into 32-bit planes.
// * Specialised on k for 1 <= k <= 4 with bits <= 16 (k = 1 takes any
//   bits): the spread is the classic mask-and-shift sequence on 64 bits
//   (four or five steps a word), so the whole address of up to 64 bits
//   sits in one register. The z-order build and the zone-map capture use
//   16 bits a column. Any other (k, bits) takes a generic path that
//   assembles each plane bit by bit in a register.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// x (< 2^16) with bit b moved to bit b * K.
template <int K>
__device__ __forceinline__ uint64_t spread(uint64_t x);

template <>
__device__ __forceinline__ uint64_t spread<1>(uint64_t x) {
  return x;
}

template <>
__device__ __forceinline__ uint64_t spread<2>(uint64_t x) {
  x &= 0xFFFFull;
  x = (x | (x << 8)) & 0x00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0Full;
  x = (x | (x << 2)) & 0x33333333ull;
  x = (x | (x << 1)) & 0x55555555ull;
  return x;
}

template <>
__device__ __forceinline__ uint64_t spread<3>(uint64_t x) {
  x &= 0xFFFFull;
  x = (x | (x << 16)) & 0x0000FF0000FFull;
  x = (x | (x << 8)) & 0x00F00F00F00Full;
  x = (x | (x << 4)) & 0x0C30C30C30C3ull;
  x = (x | (x << 2)) & 0x249249249249ull;
  return x;
}

template <>
__device__ __forceinline__ uint64_t spread<4>(uint64_t x) {
  x &= 0xFFFFull;
  x = (x | (x << 24)) & 0x000000FF000000FFull;
  x = (x | (x << 12)) & 0x000F000F000F000Full;
  x = (x | (x << 6)) & 0x0303030303030303ull;
  x = (x | (x << 3)) & 0x1111111111111111ull;
  return x;
}

// k = K columns of at most 16 bits (any bits for K = 1): the address in
// one 64-bit register, one or two planes.
template <int K>
__global__ void __launch_bounds__(kThreads)
    interleave_small(const uint32_t* __restrict__ words, uint32_t* __restrict__ planes,
                     int64_t n, int bits) {
  const int total = K * bits;
  const int nplanes = (total + 31) / 32;
  const int pad = 32 * nplanes - total;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    uint64_t z = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) z |= spread<K>(__ldg(words + j * n + row)) << (K - 1 - j);
    z <<= pad;
    if (nplanes == 2) {
      planes[row] = (uint32_t)(z >> 32);
      planes[n + row] = (uint32_t)z;
    } else {
      planes[row] = (uint32_t)z;
    }
  }
}

// Any k and bits: each plane assembled bit by bit in a register.
__global__ void __launch_bounds__(kThreads)
    interleave_generic(const uint32_t* __restrict__ words, uint32_t* __restrict__ planes,
                       int64_t n, int k, int bits) {
  const int total = k * bits;
  const int nplanes = (total + 31) / 32;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    for (int p = 0; p < nplanes; ++p) {
      uint32_t acc = 0;
      const int end = total < 32 * p + 32 ? total : 32 * p + 32;
      for (int t = 32 * p; t < end; ++t) {
        const uint32_t w = __ldg(words + (int64_t)(t % k) * n + row);
        acc |= ((w >> (bits - 1 - t / k)) & 1u) << (31 - t % 32);
      }
      planes[(int64_t)p * n + row] = acc;
    }
  }
}

}  // namespace

// words: [k, n] uint32, planes: [ceil(k * bits / 32), n] uint32, both
// contiguous on the device. Returns a cudaError_t; launches nothing for
// n = 0.
extern "C" int hs_zorder_interleave(const void* words, void* planes, int64_t n, int k,
                                    int bits, void* stream) {
  if (n < 0 || k < 1 || bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();  // empty tensors may hold null pointers
  if (words == nullptr || planes == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = want < kMaxBlocks ? (unsigned)want : (unsigned)kMaxBlocks;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* p = static_cast<uint32_t*>(planes);
  if (k == 1)
    interleave_small<1><<<blocks, kThreads, 0, st>>>(w, p, n, bits);
  else if (k == 2 && bits <= 16)
    interleave_small<2><<<blocks, kThreads, 0, st>>>(w, p, n, bits);
  else if (k == 3 && bits <= 16)
    interleave_small<3><<<blocks, kThreads, 0, st>>>(w, p, n, bits);
  else if (k == 4 && bits <= 16)
    interleave_small<4><<<blocks, kThreads, 0, st>>>(w, p, n, bits);
  else
    interleave_generic<<<blocks, kThreads, 0, st>>>(w, p, n, k, bits);
  return (int)cudaGetLastError();
}
