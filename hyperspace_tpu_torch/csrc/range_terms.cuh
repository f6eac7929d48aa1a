// The range-term predicate shared by kernels B3a (range_mask.cu), B3b
// (fused_select.cu) and B5f (fused_agg.cu), so the three can never
// disagree on a row: a conjunction of up to 16 bound terms over int64 or
// float64 columns, each column's validity included.
//
// A term holds when its column's value meets its bounds: lo (> or >=) and
// hi (< or <=), each present or not. The value is read as int64 (an int64
// or temporal column) or as float64 (flag kF64). Float compares are IEEE:
// NaN fails every compare and -0.0 equals 0.0. Bounds arrive exact, in the
// column's own type (ops/filter.py::native_range_bounds tightened int
// bounds given as floats on the host), so every compare is exact. A row
// passes when every term holds and every term column is valid there.
//
// The terms travel grouped by column (term_begin), so a thread loads a
// column's value once and tests each of its terms on it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hs_terms {

constexpr int kMaxTerms = 16;
constexpr int kHasLo = 1, kHasHi = 2, kLoStrict = 4, kHiStrict = 8, kF64 = 16;

struct Term {
  int64_t lo_i, hi_i;
  double lo_f, hi_f;
  int flags;
};

struct Args {
  const int64_t* cols[kMaxTerms];
  const uint8_t* valid[kMaxTerms];  // nullptr: the column has no nulls
  int term_begin[kMaxTerms + 1];    // terms of column c: [begin[c], begin[c+1])
  int ncols;                        // 0: no terms, every row passes
  Term terms[kMaxTerms];
};

__device__ __forceinline__ bool holds(const Term& t, int64_t bits) {
  bool ok = true;
  if (t.flags & kF64) {
    const double v = __longlong_as_double(bits);
    if (t.flags & kHasLo) ok &= (t.flags & kLoStrict) ? v > t.lo_f : v >= t.lo_f;
    if (t.flags & kHasHi) ok &= (t.flags & kHiStrict) ? v < t.hi_f : v <= t.hi_f;
  } else {
    if (t.flags & kHasLo) ok &= (t.flags & kLoStrict) ? bits > t.lo_i : bits >= t.lo_i;
    if (t.flags & kHasHi) ok &= (t.flags & kHiStrict) ? bits < t.hi_i : bits <= t.hi_i;
  }
  return ok;
}

// one row, every term
__device__ __forceinline__ uint8_t row_mask(const Args& a, int64_t row) {
  bool ok = true;
  for (int c = 0; c < a.ncols; ++c) {
    const int64_t v = __ldg(a.cols[c] + row);
    if (a.valid[c] != nullptr) ok &= __ldg(a.valid[c] + row) != 0;
    for (int t = a.term_begin[c]; t < a.term_begin[c + 1]; ++t) ok &= holds(a.terms[t], v);
  }
  return ok ? 1 : 0;
}

// kU row pairs at once, as B3b and B5f's block pass read them: pair u is
// rows 2p and 2p + 1 with p = pair0 + u * stride; a row at or past n
// fails. kVec loads a pair with one 16-byte load per column and one
// 2-byte load per validity (every column 16-byte aligned, every validity
// 2-byte aligned); a pair cut by n takes scalar loads. All kU pairs'
// loads of a column are issued before its terms are tested.
template <bool kVec, int kU>
__device__ __forceinline__ void pair_masks(const Args& a, int64_t pair0, int64_t stride,
                                           int64_t n, bool (&ok0)[kU], bool (&ok1)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t r = 2 * (pair0 + u * stride);
    ok0[u] = r < n;
    ok1[u] = r + 1 < n;
  }
  for (int c = 0; c < a.ncols; ++c) {
    const int64_t* col = a.cols[c];
    int64_t v0[kU], v1[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t r = 2 * (pair0 + u * stride);
      v0[u] = v1[u] = 0;
      if (kVec && r + 1 < n) {
        const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(col + r));
        v0[u] = x.x;
        v1[u] = x.y;
      } else {
        if (r < n) v0[u] = __ldg(col + r);
        if (r + 1 < n) v1[u] = __ldg(col + r + 1);
      }
    }
    const uint8_t* valid = a.valid[c];
    if (valid != nullptr) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t r = 2 * (pair0 + u * stride);
        if (kVec && r + 1 < n) {
          const unsigned short w = __ldg(reinterpret_cast<const unsigned short*>(valid + r));
          ok0[u] &= (w & 0xFF) != 0;
          ok1[u] &= (w >> 8) != 0;
        } else {
          if (r < n) ok0[u] &= __ldg(valid + r) != 0;
          if (r + 1 < n) ok1[u] &= __ldg(valid + r + 1) != 0;
        }
      }
    }
    for (int t = a.term_begin[c]; t < a.term_begin[c + 1]; ++t) {
      const Term term = a.terms[t];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ok0[u] &= holds(term, v0[u]);
        ok1[u] &= holds(term, v1[u]);
      }
    }
  }
}

// Whether every term column is 16-byte aligned and every validity 2-byte
// aligned, so pair_masks<true> may take vector loads.
inline bool vec_aligned(const Args& a) {
  for (int c = 0; c < a.ncols; ++c) {
    if (reinterpret_cast<uintptr_t>(a.cols[c]) % 16 != 0) return false;
    if (a.valid[c] != nullptr && reinterpret_cast<uintptr_t>(a.valid[c]) % 2 != 0) return false;
  }
  return true;
}

// Packs the C interface's term arrays into `a` (see hs_range_mask in
// range_mask.cu for their layout). ncols = nterms = 0 is accepted only
// with allow_empty. Returns cudaSuccess or cudaErrorInvalidValue (counts
// out of range, a null column, terms not grouped by column).
inline cudaError_t pack_args(Args& a, const void* const* cols, const void* const* valids,
                             int ncols, const int* term_col, const int64_t* lo_i,
                             const int64_t* hi_i, const double* lo_f, const double* hi_f,
                             const int* flags, int nterms, bool allow_empty) {
  a = Args{};
  if (allow_empty && ncols == 0 && nterms == 0) return cudaSuccess;
  if (ncols < 1 || ncols > kMaxTerms || nterms < 1 || nterms > kMaxTerms)
    return cudaErrorInvalidValue;
  a.ncols = ncols;
  for (int c = 0; c < ncols; ++c) {
    a.cols[c] = static_cast<const int64_t*>(cols[c]);
    a.valid[c] = static_cast<const uint8_t*>(valids[c]);
    if (a.cols[c] == nullptr) return cudaErrorInvalidValue;
  }
  int t = 0;
  for (int c = 0; c < ncols; ++c) {
    a.term_begin[c] = t;
    while (t < nterms && term_col[t] == c) {
      a.terms[t] = Term{lo_i[t], hi_i[t], lo_f[t], hi_f[t], flags[t]};
      ++t;
    }
    if (t == a.term_begin[c]) return cudaErrorInvalidValue;  // a column without terms
  }
  if (t != nterms) return cudaErrorInvalidValue;  // not grouped by column
  a.term_begin[ncols] = t;
  return cudaSuccess;
}

}  // namespace hs_terms
