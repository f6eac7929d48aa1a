// Fused range mask over up to 16 terms (kernel B3a).
//
// Replaces the range-mask route of the JAX package's serve path:
// hyperspace_tpu/ops/filter.py::fused_range_mask (:561), which calls the
// host kernel hs_range_mask (numpy twin range_mask_numpy, filter.py:378).
// The port evaluates every mask on the device, so this route is a device
// kernel here. ops/filter.py::range_mask_torch is its plain PyTorch
// version, and ops/filter.py::native_range_bounds lowers the bounds.
//
// What it computes: out[i] = AND over the terms t of
//   (has_lo(t) ? v > lo : v >= lo when lo_strict ...) AND the same for hi
//   AND valid[col(t)][i],
// where v is row i of the term's column, read as int64 (an int64 or
// temporal column) or as float64 (flag bit 4). Float compares are IEEE:
// NaN fails every compare and -0.0 equals 0.0. Bounds arrive exact, in
// the column's own type (int bounds given as floats were tightened on
// the host), so every compare is exact.
//
// Bound: it reads each distinct column once (8 bytes a row), each
// validity mask once (1 byte a row) and writes one byte a row; the
// compares are a few operations a row. HBM bandwidth bounds it: two
// columns without nulls over 6,001,215 rows move 102.0 MB, 30.5 us at the
// 3.35 TB/s of an H100 SXM (700 W part).
//
// The predicate (Term, Args, holds, row_mask) lives in range_terms.cuh,
// shared with B3b and B5f.
//
// Design, a simple one for that bound:
// * The terms arrive grouped by column (the wrapper sorts them), so each
//   thread loads a column's value once and tests every term on it: two
//   terms on one column (l_orderkey >= a AND l_orderkey < b) read it once.
// * A thread owns pairs of rows: one 16-byte load per column, one 2-byte
//   load of the validity bytes and one 2-byte store of the two results.
//   Consecutive threads take consecutive pairs, so every warp load reads
//   512 contiguous bytes. Each thread keeps kUnroll pairs' loads in
//   flight before testing them, on a grid-stride loop over the pairs.
// * The arguments (16 column pointers, 16 validity pointers, 16 terms)
//   travel as one __grid_constant__ kernel parameter: reads with a
//   runtime column index stay in the parameter bank, nothing is copied
//   per thread, and concurrent launches on other streams cannot race.
// * A column or validity pointer that is not aligned for the vector
//   loads (a view with an odd offset) selects the scalar instance, one
//   8-byte load a row. An odd n leaves one last row, which thread 0 of
//   block 0 tests alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "range_terms.cuh"

namespace {

using hs_terms::Args;
using hs_terms::holds;
using hs_terms::row_mask;
using hs_terms::Term;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row pairs in flight per thread
constexpr unsigned kMaxBlocks = 132 * 16;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    range_mask_kernel(const __grid_constant__ Args a, uint8_t* __restrict__ out, int64_t n) {
  const int64_t pairs = n >> 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; base < pairs;
       base += stride * kUnroll) {
    bool ok0[kUnroll], ok1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ok0[u] = ok1[u] = true;
    for (int c = 0; c < a.ncols; ++c) {
      const int64_t* col = a.cols[c];
      int64_t v0[kUnroll], v1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t p = base + u * stride;
        v0[u] = v1[u] = 0;
        if (p < pairs) {
          if (kVec) {
            const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(col) + p);
            v0[u] = x.x;
            v1[u] = x.y;
          } else {
            v0[u] = __ldg(col + 2 * p);
            v1[u] = __ldg(col + 2 * p + 1);
          }
        }
      }
      const uint8_t* valid = a.valid[c];
      if (valid != nullptr) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t p = base + u * stride;
          if (p < pairs) {
            if (kVec) {
              const unsigned short w = __ldg(reinterpret_cast<const unsigned short*>(valid) + p);
              ok0[u] &= (w & 0xFF) != 0;
              ok1[u] &= (w >> 8) != 0;
            } else {
              ok0[u] &= __ldg(valid + 2 * p) != 0;
              ok1[u] &= __ldg(valid + 2 * p + 1) != 0;
            }
          }
        }
      }
      for (int t = a.term_begin[c]; t < a.term_begin[c + 1]; ++t) {
        const Term term = a.terms[t];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ok0[u] &= holds(term, v0[u]);
          ok1[u] &= holds(term, v1[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = base + u * stride;
      if (p < pairs) {
        if (kVec) {
          reinterpret_cast<unsigned short*>(out)[p] =
              (unsigned short)((ok0[u] ? 1 : 0) | (ok1[u] ? 0x100 : 0));
        } else {
          out[2 * p] = ok0[u] ? 1 : 0;
          out[2 * p + 1] = ok1[u] ? 1 : 0;
        }
      }
    }
  }
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) out[n - 1] = row_mask(a, n - 1);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// cols[ncols]: [n] int64 (or float64, read by bits) device columns;
// valids[ncols]: [n] bool (1 byte) validity, or NULL for none;
// term_col[nterms]: each term's column, ascending, every column used;
// lo_i/hi_i/lo_f/hi_f/flags[nterms]: the exact bounds and flag words
// (bit 0 has_lo, 1 has_hi, 2 lo_strict, 3 hi_strict, 4 float64 column);
// out: [n] bool. Launches on `stream` (nothing for n = 0) and returns a
// CUDA error code: cudaErrorInvalidValue for counts out of range or terms
// not grouped by column.
extern "C" int hs_range_mask(const void* const* cols, const void* const* valids, int ncols,
                             const int* term_col, const int64_t* lo_i, const int64_t* hi_i,
                             const double* lo_f, const double* hi_f, const int* flags,
                             int nterms, void* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  Args a;
  const cudaError_t packed =
      hs_terms::pack_args(a, cols, valids, ncols, term_col, lo_i, hi_i, lo_f, hi_f, flags,
                          nterms, /*allow_empty=*/false);
  if (packed != cudaSuccess) return (int)packed;
  bool vec = aligned(out, 2);
  for (int c = 0; c < ncols; ++c)
    vec = vec && aligned(a.cols[c], 16) && (a.valid[c] == nullptr || aligned(a.valid[c], 2));
  if (n == 0) return (int)cudaGetLastError();
  const int64_t pairs = n >> 1;
  const int64_t want = (pairs + (int64_t)kThreads * kUnroll - 1) / ((int64_t)kThreads * kUnroll);
  const unsigned blocks = want < 1 ? 1u : (want < kMaxBlocks ? (unsigned)want : kMaxBlocks);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint8_t*>(out);
  if (vec)
    range_mask_kernel<true><<<blocks, kThreads, 0, st>>>(a, o, n);
  else
    range_mask_kernel<false><<<blocks, kThreads, 0, st>>>(a, o, n);
  return (int)cudaGetLastError();
}
