// Segment reductions over sorted groups (kernel B5).
//
// Replaces the JAX package's grouped reductions,
// hyperspace_tpu/ops/aggregate.py: _seg_sum_count (:25), _seg_min (:36),
// _seg_max (:55) and segment_count (:164), with the semantics of their
// host route (_host_sum_count, _host_minmax, :88-126). Plain PyTorch
// versions: hyperspace_tpu_torch/ops/aggregate.py::segment_*_torch.
//
// Input: the group-sorted row permutation perm ([n] int64, NULL for the
// identity), group offsets offs ([G + 1] int64, offs[0] = 0, offs[G] = n,
// nondecreasing), values ([n] int64, uint64 bits, float or double; NULL
// for a count), validity ([n] bool, NULL when every row is valid). Group g
// is rows perm[offs[g] .. offs[g+1]), in row order (the sort is stable).
// "Position" below is an index into that group-sorted order.
//
// Three launch functions:
// * hs_seg_sum_count: integer sum (64-bit, wrapping) and count of valid
//   rows. Both are exact in any order, so any reduction tree will do.
// * hs_seg_minmax: MIN or MAX with Spark's float order (MIN is NaN only
//   when no valid non-NaN row exists; a valid NaN wins MAX) and ties
//   keeping the later row, as np.minimum.at / np.maximum.at do: -0.0
//   against 0.0 keeps the later one's sign. Each partial carries its
//   value and the position it came from; the combine takes the better
//   value and, on a tie, the later position. That order is total, so the
//   combine is associative and commutative and any tree gives the row
//   the sequential fold keeps.
// * hs_seg_fold_sum: float SUM. The contract is np.add.at's left fold in
//   row order from +0.0, in the column's own type, so no tree and no
//   atomic can meet it: one lane of a warp adds the group's rows in order.
//   NaN bits follow the x86 fold: the first NaN the fold meets stays (a
//   NaN value, quieted, or for inf + -inf the default NaN 0xFFF8...).
//
// Bound: every design reads perm (8 B a row, when not the identity), the
// values (4 or 8 B) and the validity (1 B) once and writes 8 or 16 B a
// group: HBM bandwidth bounds the two parallel launches. The fold is
// bound by its chain instead: the longest group's length times the
// latency of one dependent add, because each add needs the one before.
//
// Design, a simple one for those bounds:
// * Range pass (sum/count, min/max): each warp owns 1,024 consecutive
//   positions. It finds the group holding its first position by binary
//   search in offs, then walks the groups overlapping its range; for each
//   the lanes stride over the overlap and a shuffle tree combines them.
//   A group inside the range is written whole; a group cut at the
//   range's start leaves a "continuation" partial, a group that starts in
//   the range and runs past its end an "owner" partial. Empty groups are
//   written by the warp whose range holds their position (the last warp
//   also those at n), so every group is written exactly once.
// * Fix-up pass: one block per range; the blocks of ranges that own a cut
//   group combine the continuation partials of the ranges it spans with
//   their own and write it; the others return at once. A group of 6 M
//   rows is then 5,861 warps wide instead of one.
// * Fold: one warp a group. All lanes load the next 256 positions (perm,
//   value, validity; an invalid row stages +0.0, which adds nothing: the
//   sum starts at +0.0 and never becomes -0.0) into registers, so the
//   loads fly while lane 0 adds the tile staged in shared memory before.
//   The adds run unguarded; a tile whose sum turns NaN is folded again
//   with the NaN rule from the sum before it. A NaN sum stays as it is.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRangeWarps = 8;  // warps a block in the range pass
constexpr long long kRange = 1024;  // positions a warp in the range pass
constexpr int kFixThreads = 128;
constexpr int kFoldWarps = 4;
constexpr int kFoldItems = 8;  // positions a lane stages per tile
constexpr int kTile = kWarp * kFoldItems;

enum ValueType { kI64 = 0, kU64 = 1, kF32 = 2, kF64 = 3 };

struct Partial {
  long long a;  // the sum, or the value's bits
  long long b;  // the count, or the position (-1: no row took part)
};

__device__ __forceinline__ long long row_of(const long long* perm, long long i) {
  return perm ? perm[i] : i;
}

__device__ __forceinline__ bool row_valid(const bool* valid, long long row) {
  return valid == nullptr || valid[row];
}

// first index in offs[0 .. G] whose value is >= x
__device__ long long lower_bound(const long long* offs, long long G, long long x) {
  long long lo = 0, hi = G + 1;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (offs[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- operations -------------------------------------------------------------

struct SumCount {
  const long long* vals;  // NULL: count only
  long long* sums;
  long long* counts;

  struct Acc {
    unsigned long long sum;
    long long count;
  };
  __device__ Acc identity() const { return {0ull, 0}; }
  __device__ void add_row(Acc& a, const bool* valid, long long row, long long) const {
    if (!row_valid(valid, row)) return;
    if (vals) a.sum += static_cast<unsigned long long>(vals[row]);
    a.count += 1;
  }
  __device__ Acc combine(Acc a, Acc b) const { return {a.sum + b.sum, a.count + b.count}; }
  __device__ Acc shfl_down(Acc a, int d) const {
    return {__shfl_down_sync(0xffffffffu, a.sum, d),
            __shfl_down_sync(0xffffffffu, a.count, d)};
  }
  __device__ Partial pack(Acc a) const {
    return {static_cast<long long>(a.sum), a.count};
  }
  __device__ Acc unpack(Partial p) const {
    return {static_cast<unsigned long long>(p.a), p.b};
  }
  __device__ void write(long long g, Acc a) const {
    if (sums) sums[g] = static_cast<long long>(a.sum);
    counts[g] = a.count;
  }
};

template <typename T> struct Bits;
template <> struct Bits<long long> {
  __device__ static long long to(long long v) { return v; }
  __device__ static long long from(long long b) { return b; }
  __device__ static bool is_nan(long long) { return false; }
};
template <> struct Bits<unsigned long long> {
  __device__ static long long to(unsigned long long v) { return static_cast<long long>(v); }
  __device__ static unsigned long long from(long long b) { return static_cast<unsigned long long>(b); }
  __device__ static bool is_nan(unsigned long long) { return false; }
};
template <> struct Bits<float> {
  __device__ static long long to(float v) { return static_cast<unsigned int>(__float_as_int(v)); }
  __device__ static float from(long long b) { return __int_as_float(static_cast<int>(b)); }
  __device__ static bool is_nan(float v) { return isnan(v); }
  __device__ static float canonical_nan() { return __int_as_float(0x7FC00000); }
  __device__ static float neg_inf() { return __int_as_float(static_cast<int>(0xFF800000u)); }
};
template <> struct Bits<double> {
  __device__ static long long to(double v) { return __double_as_longlong(v); }
  __device__ static double from(long long b) { return __longlong_as_double(b); }
  __device__ static bool is_nan(double v) { return isnan(v); }
  __device__ static double canonical_nan() { return __longlong_as_double(0x7FF8000000000000ll); }
  __device__ static double neg_inf() {
    return __longlong_as_double(static_cast<long long>(0xFFF0000000000000ull));
  }
};

template <typename T>
constexpr bool kFloat = false;
template <> constexpr bool kFloat<float> = true;
template <> constexpr bool kFloat<double> = true;

template <typename T, bool kMax>
struct MinMax {
  const T* vals;
  T* out;
  T fill;  // integers: a group without valid rows

  struct Acc {
    T v;
    long long pos;  // -1: no row took part
  };
  __device__ Acc identity() const { return {T(0), -1}; }
  // b better than a: the larger (MAX) or smaller (MIN) value, a NaN above
  // every value for MAX, and on a tie the later position
  __device__ static bool better(const Acc& b, const Acc& a) {
    if (b.pos < 0) return false;
    if (a.pos < 0) return true;
    if constexpr (kFloat<T>) {
      bool bn = Bits<T>::is_nan(b.v), an = Bits<T>::is_nan(a.v);
      if (bn || an) return bn && (!an || b.pos > a.pos);
    }
    if (kMax ? b.v > a.v : b.v < a.v) return true;
    return b.v == a.v && b.pos > a.pos;
  }
  __device__ void add_row(Acc& a, const bool* valid, long long row, long long pos) const {
    if (!row_valid(valid, row)) return;
    Acc b{vals[row], pos};
    if constexpr (kFloat<T> && !kMax) {
      if (Bits<T>::is_nan(b.v)) return;  // MIN takes the non-NaN rows
    }
    if (better(b, a)) a = b;
  }
  __device__ Acc combine(Acc a, Acc b) const { return better(b, a) ? b : a; }
  __device__ Acc shfl_down(Acc a, int d) const {
    return {__shfl_down_sync(0xffffffffu, a.v, d), __shfl_down_sync(0xffffffffu, a.pos, d)};
  }
  __device__ Partial pack(Acc a) const { return {Bits<T>::to(a.v), a.pos}; }
  __device__ Acc unpack(Partial p) const { return {Bits<T>::from(p.a), p.b}; }
  __device__ void write(long long g, Acc a) const {
    T r;
    if constexpr (kFloat<T>) {
      if (a.pos < 0) r = kMax ? Bits<T>::neg_inf() : Bits<T>::canonical_nan();
      else r = Bits<T>::is_nan(a.v) ? Bits<T>::canonical_nan() : a.v;
    } else {
      r = a.pos < 0 ? fill : a.v;
    }
    out[g] = r;
  }
};

template <class Op>
__device__ typename Op::Acc warp_reduce(const Op& op, typename Op::Acc a) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) a = op.combine(a, op.shfl_down(a, d));
  return a;
}

struct RangeArgs {
  const long long* perm;
  const long long* offs;
  const bool* valid;
  long long n, G, ranges;
  Partial* cont;     // [ranges] continuation partials
  Partial* own;      // [ranges] owner partials
  long long* owned;  // [ranges] the group a range owns, or -1
};

template <class Op>
__global__ void __launch_bounds__(kRangeWarps * kWarp)
range_pass(const RangeArgs args, const Op op) {
  const int lane = threadIdx.x % kWarp;
  const long long w = static_cast<long long>(blockIdx.x) * kRangeWarps + threadIdx.x / kWarp;
  if (w >= args.ranges) return;
  const long long n = args.n, G = args.G;
  const long long lo = w * kRange, hi = min(lo + kRange, n);
  long long g = lower_bound(args.offs, G, lo);
  if (args.offs[g] > lo) g -= 1;  // the group holding position lo began before it
  long long owned = -1;
  while (true) {
    const long long gs = args.offs[g], ge = args.offs[g + 1];
    const long long s = max(gs, lo), e = min(ge, hi);
    typename Op::Acc acc = op.identity();
#pragma unroll 4
    for (long long i = s + lane; i < e; i += kWarp) {
      op.add_row(acc, args.valid, row_of(args.perm, i), i);
    }
    acc = warp_reduce(op, acc);
    if (lane == 0) {
      if (gs < lo) {
        args.cont[w] = op.pack(acc);
      } else if (ge > hi) {
        args.own[w] = op.pack(acc);
        owned = g;
      } else {
        op.write(g, acc);
      }
    }
    if (g + 1 >= G || !(ge < hi || hi == n)) break;
    ++g;
  }
  if (lane == 0) args.owned[w] = owned;
}

template <class Op>
__global__ void __launch_bounds__(kFixThreads)
fixup_pass(const RangeArgs args, const Op op) {
  __shared__ Partial part[kFixThreads / kWarp];
  const long long w = blockIdx.x;
  const long long g = args.owned[w];
  if (g < 0) return;
  const long long last = (args.offs[g + 1] - 1) / kRange;  // the last range g reaches
  typename Op::Acc acc = op.identity();
  for (long long j = w + 1 + threadIdx.x; j <= last; j += kFixThreads) {
    acc = op.combine(acc, op.unpack(args.cont[j]));
  }
  acc = warp_reduce(op, acc);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) part[warp] = op.pack(acc);
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = op.unpack(args.own[w]);
    for (int k = 0; k < kFixThreads / kWarp; ++k) acc = op.combine(acc, op.unpack(part[k]));
    op.write(g, acc);
  }
}

long long num_ranges(long long n) { return n > 0 ? (n + kRange - 1) / kRange : 1; }

template <class Op>
int launch_ranges(const long long* perm, const long long* offs, const bool* valid, long long n,
                  long long G, const Op& op, void* scratch, cudaStream_t stream) {
  const long long ranges = num_ranges(n);
  RangeArgs args{perm, offs, valid, n, G, ranges,
                 static_cast<Partial*>(scratch),
                 static_cast<Partial*>(scratch) + ranges,
                 reinterpret_cast<long long*>(static_cast<Partial*>(scratch) + 2 * ranges)};
  const long long blocks = (ranges + kRangeWarps - 1) / kRangeWarps;
  range_pass<Op><<<static_cast<unsigned>(blocks), kRangeWarps * kWarp, 0, stream>>>(args, op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixup_pass<Op><<<static_cast<unsigned>(ranges), kFixThreads, 0, stream>>>(args, op);
  return static_cast<int>(cudaGetLastError());
}

// ---- the ordered float fold ----------------------------------------------------

template <typename T> struct FoldBits;
template <> struct FoldBits<float> {
  using U = unsigned int;
  static constexpr U kQuiet = 0x00400000u, kDefaultNan = 0xFFC00000u;
  __device__ static U bits(float v) { return static_cast<U>(__float_as_int(v)); }
  __device__ static float value(U b) { return __int_as_float(static_cast<int>(b)); }
};
template <> struct FoldBits<double> {
  using U = unsigned long long;
  static constexpr U kQuiet = 0x0008000000000000ull, kDefaultNan = 0xFFF8000000000000ull;
  __device__ static U bits(double v) { return static_cast<U>(__double_as_longlong(v)); }
  __device__ static double value(U b) { return __longlong_as_double(static_cast<long long>(b)); }
};

// one step of the x86 fold acc + v where acc is not NaN: a NaN result
// keeps v's NaN, quieted, or is the default NaN when v is not NaN
template <typename T>
__device__ __forceinline__ T nan_step(T acc, T v) {
  const T s = acc + v;
  if (!isnan(s)) return s;
  using B = FoldBits<T>;
  return B::value(isnan(v) ? (B::bits(v) | B::kQuiet) : B::kDefaultNan);
}

template <typename T>
__global__ void __launch_bounds__(kFoldWarps * kWarp)
fold_sum(const long long* __restrict__ perm, const long long* __restrict__ offs,
         const T* __restrict__ vals, const bool* __restrict__ valid, long long G,
         T* __restrict__ sums, long long* __restrict__ counts) {
  __shared__ T tile[kFoldWarps][kTile];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long g = static_cast<long long>(blockIdx.x) * kFoldWarps + warp;
  if (g >= G) return;
  const long long s = offs[g], e = offs[g + 1];
  T* buf = tile[warp];
  T staged[kFoldItems];
  long long count = 0;
  auto load = [&](long long base) {
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) {
      const long long i = base + k * kWarp + lane;
      T v = T(0);
      if (i < e) {
        const long long row = row_of(perm, i);
        if (row_valid(valid, row)) {
          v = vals[row];
          ++count;
        }
      }
      staged[k] = v;
    }
  };
  T acc = T(0);
  if (s < e) load(s);
  for (long long base = s; base < e; base += kTile) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kFoldItems; ++k) buf[k * kWarp + lane] = staged[k];
    __syncwarp();
    if (base + kTile < e) load(base + kTile);  // in flight while lane 0 adds
    if (lane == 0 && !isnan(acc)) {
      const int len = static_cast<int>(min(static_cast<long long>(kTile), e - base));
      const T before = acc;
      int j = 0;
      for (; j + 8 <= len; j += 8) {
        T x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = buf[j + k];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = acc + x[k];
      }
      for (; j < len; ++j) acc = acc + buf[j];
      if (isnan(acc)) {  // the first NaN of the fold: again, by the x86 rule
        acc = before;
        for (int k = 0; k < len && !isnan(acc); ++k) acc = nan_step(acc, buf[k]);
      }
    }
  }
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) count += __shfl_down_sync(0xffffffffu, count, d);
  if (lane == 0) {
    sums[g] = acc;
    counts[g] = count;
  }
}

}  // namespace

extern "C" {

// Bytes of scratch the range pass needs for n rows: two partials and an
// owned-group slot a range.
long long hs_seg_scratch_bytes(long long n) {
  return num_ranges(n) * static_cast<long long>(2 * sizeof(Partial) + sizeof(long long));
}

// Integer sum (vals int64 or uint64 bits; NULL with sums NULL for a
// count) and count of valid rows per group. Returns a CUDA error code.
int hs_seg_sum_count(const long long* perm, const long long* offs, const long long* vals,
                     const bool* valid, long long n, long long G, long long* sums,
                     long long* counts, void* scratch, void* stream) {
  if (G <= 0) return 0;
  SumCount op{vals, sums, counts};
  return launch_ranges(perm, offs, valid, n, G, op, scratch, static_cast<cudaStream_t>(stream));
}

// MIN (is_max 0) or MAX (is_max 1) per group; fill_bits is an integer
// group's value when it has no valid row. Returns a CUDA error code.
int hs_seg_minmax(const long long* perm, const long long* offs, const void* vals,
                  const bool* valid, long long n, long long G, int type, int is_max,
                  long long fill_bits, void* out, void* scratch, void* stream) {
  if (G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HS_MINMAX(T, FILL)                                                              \
  return is_max                                                                         \
      ? launch_ranges(perm, offs, valid, n, G,                                          \
                      MinMax<T, true>{static_cast<const T*>(vals), static_cast<T*>(out), FILL}, \
                      scratch, st)                                                      \
      : launch_ranges(perm, offs, valid, n, G,                                          \
                      MinMax<T, false>{static_cast<const T*>(vals), static_cast<T*>(out), FILL}, \
                      scratch, st)
  switch (type) {
    case kI64: HS_MINMAX(long long, fill_bits);
    case kU64: HS_MINMAX(unsigned long long, static_cast<unsigned long long>(fill_bits));
    case kF32: HS_MINMAX(float, 0.0f);
    case kF64: HS_MINMAX(double, 0.0);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HS_MINMAX
}

// Float SUM (is_f64: double, else float) as the ordered left fold, and the
// count of valid rows, per group. Returns a CUDA error code.
int hs_seg_fold_sum(const long long* perm, const long long* offs, const void* vals,
                    const bool* valid, long long G, int is_f64, void* sums, long long* counts,
                    void* stream) {
  if (G <= 0) return 0;
  const long long blocks = (G + kFoldWarps - 1) / kFoldWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    fold_sum<double><<<static_cast<unsigned>(blocks), kFoldWarps * kWarp, 0, st>>>(
        perm, offs, static_cast<const double*>(vals), valid, G, static_cast<double*>(sums),
        counts);
  } else {
    fold_sum<float><<<static_cast<unsigned>(blocks), kFoldWarps * kWarp, 0, st>>>(
        perm, offs, static_cast<const float*>(vals), valid, G, static_cast<float*>(sums),
        counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
