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
//   An optional start vector ([G], the column's type) replaces +0.0 as
//   group g's first operand: the fused filter-aggregate (fused_agg.cu,
//   B5f) carries its float sums across chunks this way, as the
//   reference's row sweep carries acc_f. A NaN start stays, quieted once
//   the group has a row to add, as the x86 add of a NaN first operand.
//
// Bounds on the H100 (3.35 TB/s; the add latency from
// scripts/torch_chain_probe.cu). The range pass reads offs (8 B a group),
// perm (8 B a row, when not the identity), the values (4 or 8 B) and the
// validity (1 B) once and writes 8 or 16 B a group: HBM bandwidth bounds
// it (TPC-H Q18's integer SUM, 6,001,215 rows in 1,472,478 groups: 131 MB,
// 0.039 ms; MIN over one group of them: 48 MB, 0.014 ms). The fix-up pass
// reads a few bytes a range and one partial a range a long group spans:
// microseconds of L2 reads, not a bandwidth term. The fold is bound by its
// chain instead: the longest group's length times the latency of one
// dependent add (about 4.1 ns in float64), because each add needs the one
// before.
//
// Design, against those bounds:
// * Every kernel is instanced on whether a permutation and a validity are
//   given (Source), so no load waits behind a branch on a null pointer.
// * Range pass (sum/count, min/max): each warp owns kRange consecutive
//   positions. It finds the group holding its first position by a 32-ary
//   warp search in offs (5 dependent loads over 1.5 M groups), then walks
//   the groups overlapping its range 32 at a time: lane k takes group
//   g0 + k, its start from one coalesced load of offs (in flight a round
//   ahead), its end from lane k + 1 by shuffle. A lane whose group lies
//   wholly inside the range and has at most kShortGroup rows folds it
//   alone, in position order, issuing the loads of kBatch positions (perm,
//   then value and validity) before it combines them, and writes it: a
//   warp's ~500 Q18 groups of 1-7 rows cost 16 rounds of a few loads in
//   flight, not 500 walks. The other groups (longer, or cut at the range's
//   start or end) go one at a time, from a ballot of their lanes, through
//   the warp: the lanes stride over the overlap, kBatch positions' loads
//   at once, and a shuffle tree combines them. A group inside the range is
//   written whole; a group cut at the range's start leaves a
//   "continuation" partial, a group that starts in the range and runs past
//   its end an "owner" partial and the last range it reaches. Empty groups
//   are written by the warp whose range holds their position (the last
//   warp also those at n), so every group is written exactly once. Ranges
//   of 2,048 positions and registers capped for 3 blocks an SM make Q18's
//   2,931 warps one resident wave (1,024 took two; 4,096 left warps
//   latency-bound).
// * Fix-up pass: one block of 128 threads per range, launched as a
//   programmatic dependent of the range pass, so its blocks are resident
//   when that pass ends. The blocks of ranges that own a cut group combine
//   the continuation partials of the ranges it spans with their own and
//   write it; the others return at once. A block's first loads need
//   nothing else (the owned group, its reach, the owner partial and one
//   continuation a thread), then each thread issues kFixBatch partials'
//   loads before it combines them: a group of 6 M rows (2,930 partials)
//   costs three rounds of L2 reads.
// * Fold: one warp a group, lane 0 adding in row order from a tile of 256
//   values in shared memory. The loads run two tiles ahead of the adds:
//   while lane 0 adds tile t, the lanes hold tile t + 1's values and
//   tile t + 2's rows; each iteration they store tile t + 1 into the other
//   of two shared buffers, gather tile t + 2's values from rows that
//   arrived an iteration ago, and load tile t + 3's rows. No load that
//   lane 0 waits on was issued in the same iteration, so a group gathered
//   through a permutation adds at nearly the pace of an identity one. An
//   invalid row stages +0.0, which the fold adds as the reference adds
//   0.0 for a null row (from a -0.0 start that add gives +0.0). The adds
//   run unguarded; a tile whose sum turns NaN is folded again with the
//   NaN rule from the sum before it.
//   A NaN sum stays as it is. What is left above the chain is lane 0's
//   shared-memory reads (ptxas issues each two adds ahead) and the
//   staging instructions it runs between tiles. A start, when given, is
//   one load a group before the first tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRangeWarps = 8;  // warps a block in the range pass
constexpr int kRangeBlocks = 3;  // blocks an SM the range pass's registers leave room for
                                 // (2 for MIN/MAX over a validity, which spill at 3)
constexpr long long kRange = 2048;  // positions a warp in the range pass
constexpr int kShortGroup = 32;  // the longest group one lane of the range pass folds alone
constexpr int kBatch = 8;  // positions whose loads a lane issues before combining them
constexpr int kFixThreads = 128;
constexpr int kFixBatch = 16;  // partials whose loads a fix-up thread issues together
constexpr int kFoldWarps = 4;
constexpr int kFoldItems = 8;  // positions a lane stages per tile
constexpr int kTile = 256;  // positions a tile of the fold
static_assert(kTile == kWarp * kFoldItems, "a tile is one staged position a lane and item");

enum ValueType { kI64 = 0, kU64 = 1, kF32 = 2, kF64 = 3 };

struct alignas(16) Partial {
  long long a;  // the sum, or the value's bits
  long long b;  // the count, or the position (-1: no row took part)
};

// Where a position's row and validity come from: the permutation or the
// identity, the validity or every row valid. Each is fixed per instance,
// so no load sits behind a branch on a null pointer.
template <bool kPerm, bool kValid>
struct Source {
  const long long* perm;
  const bool* valid;
  __device__ __forceinline__ long long row(long long i) const {
    if constexpr (kPerm) return __ldg(perm + i);
    else return i;
  }
  __device__ __forceinline__ bool ok(long long row) const {
    if constexpr (kValid) return __ldg(reinterpret_cast<const unsigned char*>(valid) + row) != 0;
    else return true;
  }
};

// The first index in offs[0 .. G] whose value is >= x, found by the
// whole warp (every lane gets it): each step the lanes probe 32 evenly
// spaced offsets at once and keep the 32nd of the interval that holds the
// answer, so a search over 1.5 M groups is 5 dependent loads, not 21.
__device__ long long warp_lower_bound(const long long* offs, long long G, long long x, int lane) {
  long long lo = 0, hi = G + 1;  // the answer lies in [lo, hi]; offs[hi] >= x if hi <= G
  while (hi - lo > kWarp) {
    const long long step = (hi - lo + kWarp - 1) / kWarp;
    const long long end = min(lo + (lane + 1) * step, hi);  // lane's piece: [end - step, end)
    const unsigned above = __ballot_sync(kFull, __ldg(offs + end - 1) >= x);
    if (above == 0) return hi;
    const int k = __ffs(static_cast<int>(above)) - 1;
    hi = min(lo + (k + 1) * step, hi) - 1;
    lo += k * step;
  }
  const bool here = lo + lane < hi && __ldg(offs + lo + lane) >= x;
  const unsigned above = __ballot_sync(kFull, here);
  return above ? lo + __ffs(static_cast<int>(above)) - 1 : hi;
}

// ---- operations -------------------------------------------------------------
//
// An operation loads a row's value (V), adds a value with its validity
// and position to an accumulator, and combines, shuffles, packs and
// writes accumulators.

template <bool kValues>  // false: count only
struct SumCount {
  const long long* vals;
  long long* sums;
  long long* counts;

  using V = unsigned long long;
  static constexpr bool kWide = false;  // its accumulator carries no position (kRangeBlocks)
  struct Acc {
    unsigned long long sum;
    long long count;
  };
  __device__ Acc identity() const { return {0ull, 0}; }
  __device__ V value(long long row) const {
    if constexpr (kValues) return static_cast<V>(__ldg(vals + row));
    else return 0ull;
  }
  __device__ void add(Acc& a, V v, bool ok, long long) const {
    a.sum += ok ? v : 0ull;
    a.count += ok;
  }
  __device__ Acc combine(Acc a, Acc b) const { return {a.sum + b.sum, a.count + b.count}; }
  __device__ Acc shfl_down(Acc a, int d) const {
    return {__shfl_down_sync(kFull, a.sum, d), __shfl_down_sync(kFull, a.count, d)};
  }
  __device__ Partial pack(Acc a) const {
    return {static_cast<long long>(a.sum), a.count};
  }
  __device__ Acc unpack(Partial p) const {
    return {static_cast<unsigned long long>(p.a), p.b};
  }
  __device__ void write(long long g, Acc a) const {
    if constexpr (kValues) sums[g] = static_cast<long long>(a.sum);
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
  using V = T;
  static constexpr bool kWide = true;  // its accumulator carries a position (kRangeBlocks)
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
  __device__ V value(long long row) const { return __ldg(vals + row); }
  __device__ void add(Acc& a, V v, bool ok, long long pos) const {
    if (!ok) return;
    if constexpr (kFloat<T> && !kMax) {
      if (Bits<T>::is_nan(v)) return;  // MIN takes the non-NaN rows
    }
    const Acc b{v, pos};
    if (better(b, a)) a = b;
  }
  __device__ Acc combine(Acc a, Acc b) const { return better(b, a) ? b : a; }
  __device__ Acc shfl_down(Acc a, int d) const {
    return {__shfl_down_sync(kFull, a.v, d), __shfl_down_sync(kFull, a.pos, d)};
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

// Adds positions start, start + stride, ... below e to acc in that order,
// kBatch at a time: first every position's row, then every row's value and
// validity, then the adds, so a lane keeps kBatch loads in flight.
template <class Op, class Src>
__device__ __forceinline__ void fold_positions(const Op& op, const Src& src,
                                               typename Op::Acc& acc, long long start,
                                               long long e, long long stride) {
  for (long long i = start; i < e; i += kBatch * stride) {
    long long rows[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long p = i + k * stride;
      rows[k] = p < e ? src.row(p) : -1;
    }
    typename Op::V v[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = typename Op::V();
      ok[k] = false;
      if (rows[k] >= 0) {
        v[k] = op.value(rows[k]);
        ok[k] = src.ok(rows[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) op.add(acc, v[k], ok[k], i + k * stride);
  }
}

struct RangeArgs {
  const long long* perm;
  const long long* offs;
  const bool* valid;
  long long n, G, ranges;
  Partial* cont;     // [ranges] continuation partials
  Partial* own;      // [ranges] owner partials
  long long* owned;  // [ranges] the group a range owns, or -1
  long long* reach;  // [ranges] for a range that owns a group, the last range it reaches
};

template <class Op, bool kPerm, bool kValid>
__global__ void __launch_bounds__(kRangeWarps * kWarp, Op::kWide && kValid ? 2 : kRangeBlocks)
range_pass(const RangeArgs args, const Op op) {
  // the fix-up pass may launch now; it waits for this pass to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Source<kPerm, kValid> src{args.perm, args.valid};
  const int lane = threadIdx.x % kWarp;
  const long long w = static_cast<long long>(blockIdx.x) * kRangeWarps + threadIdx.x / kWarp;
  if (w >= args.ranges) return;
  const long long n = args.n, G = args.G;
  const long long lo = w * kRange, hi = min(lo + kRange, n);
  const bool last = hi == n;  // the last range also takes the empty groups at n
  long long g0 = warp_lower_bound(args.offs, G, lo, lane);
  if (args.offs[g0] > lo) g0 -= 1;  // the group holding position lo began before it
  auto start_of = [&](long long g) { return g <= G ? __ldg(args.offs + g) : n; };
  // a round: lane k takes group g0 + k, which starts at gs; the starts of
  // the next round's groups are in flight one round ahead
  long long gs = start_of(g0 + lane), gs_next = start_of(g0 + kWarp + lane);
  long long owned = -1;
  while (true) {
    const long long g = g0 + lane;
    const long long gs_later = start_of(g + 2 * kWarp);
    const long long after = __shfl_sync(kFull, gs_next, 0);  // offs[g0 + 32]
    long long ge = __shfl_down_sync(kFull, gs, 1);
    if (lane == kWarp - 1) ge = after;
    const bool active = g < G && (gs < hi || last);
    const bool cut = gs < lo || ge > hi;
    const bool alone = active && !cut && ge - gs <= kShortGroup;
    if (alone) {
      typename Op::Acc acc = op.identity();
      fold_positions(op, src, acc, gs, ge, 1);
      op.write(g, acc);
    }
    // the other groups of the round, one at a time, by the whole warp
    unsigned together = __ballot_sync(kFull, active && !alone);
    while (together) {
      const int from = __ffs(static_cast<int>(together)) - 1;
      together &= together - 1;
      const long long tg = __shfl_sync(kFull, g, from);
      const long long ts = __shfl_sync(kFull, gs, from), te = __shfl_sync(kFull, ge, from);
      typename Op::Acc acc = op.identity();
      fold_positions(op, src, acc, max(ts, lo) + lane, min(te, hi), kWarp);
      acc = warp_reduce(op, acc);
      if (ts < lo) {
        if (lane == 0) args.cont[w] = op.pack(acc);
      } else if (te > hi) {
        if (lane == 0) {
          args.own[w] = op.pack(acc);
          args.reach[w] = (te - 1) / kRange;
        }
        owned = tg;
      } else if (lane == 0) {
        op.write(tg, acc);
      }
    }
    g0 += kWarp;
    if (g0 >= G || !(after < hi || last)) break;
    gs = gs_next;
    gs_next = gs_later;
  }
  if (lane == 0) args.owned[w] = owned;
}

template <class Op>
__global__ void __launch_bounds__(kFixThreads)
fixup_pass(const RangeArgs args, const Op op) {
  __shared__ Partial part[kFixThreads / kWarp];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the range pass's partials
  const long long w = blockIdx.x;
  // first the loads that need no other: the group this range owns, the
  // last range it reaches, the owner partial and one continuation a
  // thread (all a group of a few rows needs), whether or not it owns one
  const long long g = args.owned[w], last = args.reach[w];
  const long long j0 = w + 1 + threadIdx.x;
  const Partial first = j0 < args.ranges ? args.cont[j0] : op.pack(op.identity());
  const Partial mine = threadIdx.x == 0 ? args.own[w] : op.pack(op.identity());
  if (g < 0) return;
  typename Op::Acc acc = op.combine(op.unpack(mine),
                                    j0 <= last ? op.unpack(first) : op.identity());
  for (long long j = j0 + kFixThreads; j <= last; j += kFixThreads * kFixBatch) {
    Partial p[kFixBatch];
#pragma unroll
    for (int k = 0; k < kFixBatch; ++k) {
      const long long jk = j + k * kFixThreads;
      p[k] = jk <= last ? args.cont[jk] : op.pack(op.identity());
    }
#pragma unroll
    for (int k = 0; k < kFixBatch; ++k) acc = op.combine(acc, op.unpack(p[k]));
  }
  acc = warp_reduce(op, acc);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) part[warp] = op.pack(acc);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kFixThreads / kWarp; ++k) acc = op.combine(acc, op.unpack(part[k]));
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
                 reinterpret_cast<long long*>(static_cast<Partial*>(scratch) + 2 * ranges),
                 reinterpret_cast<long long*>(static_cast<Partial*>(scratch) + 2 * ranges) + ranges};
  const unsigned blocks = static_cast<unsigned>((ranges + kRangeWarps - 1) / kRangeWarps);
  const unsigned threads = kRangeWarps * kWarp;
  if (perm && valid) range_pass<Op, true, true><<<blocks, threads, 0, stream>>>(args, op);
  else if (perm) range_pass<Op, true, false><<<blocks, threads, 0, stream>>>(args, op);
  else if (valid) range_pass<Op, false, true><<<blocks, threads, 0, stream>>>(args, op);
  else range_pass<Op, false, false><<<blocks, threads, 0, stream>>>(args, op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a programmatic dependent launch: the fix-up's blocks may be resident
  // before the range pass ends, and wait for its results
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ranges));
  cfg.blockDim = dim3(kFixThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fixup_pass<Op>, args, op);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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

// The fold's staging, a lane's kFoldItems positions of a tile at a time:
// the rows of positions base + k * 32 + lane (-1 past the group), their
// values (+0.0 past the group) and validity (a bit an item), and the store
// of a tile's values into shared memory (+0.0 for an invalid row),
// counting its valid rows.
template <class Src>
__device__ __forceinline__ void find_rows(const Src& src, long long (&rows)[kFoldItems],
                                          long long base, long long e, int lane) {
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    const long long i = base + k * kWarp + lane;
    rows[k] = i < e ? src.row(i) : -1;
  }
}

template <typename T, class Src>
__device__ __forceinline__ void gather(const Src& src, const T* __restrict__ vals,
                                       const long long (&rows)[kFoldItems], T (&got)[kFoldItems],
                                       unsigned& ok) {
  ok = 0;
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    got[k] = T(0);
    if (rows[k] >= 0) {
      got[k] = vals[rows[k]];
      ok |= static_cast<unsigned>(src.ok(rows[k])) << k;
    }
  }
}

template <bool kValid, typename T>
__device__ __forceinline__ void stage(T* buf, const T (&got)[kFoldItems], unsigned ok,
                                      long long& count, int lane) {
  if constexpr (kValid) count += __popc(ok);
#pragma unroll
  for (int k = 0; k < kFoldItems; ++k) {
    if constexpr (kValid) {
      buf[k * kWarp + lane] = (ok >> k) & 1u ? got[k] : T(0);
    } else {
      buf[k * kWarp + lane] = got[k];
    }
  }
}

// __maxnreg__ rather than __launch_bounds__: with the latter ptxas kept
// the fold near 64 registers and spilled values the loop reloads every tile
template <typename T, bool kPerm, bool kValid>
__global__ void __maxnreg__(128)
fold_sum(const long long* __restrict__ perm, const long long* __restrict__ offs,
         const T* __restrict__ vals, const bool* __restrict__ valid,
         const T* __restrict__ start, long long G, T* __restrict__ sums,
         long long* __restrict__ counts) {
  __shared__ T tile[kFoldWarps][2][kTile];
  const Source<kPerm, kValid> src{perm, valid};
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long g = static_cast<long long>(blockIdx.x) * kFoldWarps + warp;
  if (g >= G) return;
  const long long s = offs[g], e = offs[g + 1];
  long long rows[kFoldItems];  // a later tile's rows
  T got[kFoldItems];           // the next tile's values
  unsigned ok;                 // ... bit k: item k is a valid row of the group
  long long count = 0;         // valid rows this lane staged
  // tile 0 staged; tile 1's values and tile 2's rows in flight
  find_rows(src, rows, s, e, lane);
  gather(src, vals, rows, got, ok);
  find_rows(src, rows, s + kTile, e, lane);
  stage<kValid>(tile[warp][0], got, ok, count, lane);
  gather(src, vals, rows, got, ok);
  find_rows(src, rows, s + 2 * kTile, e, lane);
  T acc = start != nullptr ? start[g] : T(0);
  int cur = 0;
  for (long long base = s; base < e; base += kTile, cur ^= 1) {
    __syncwarp();  // tile cur is whole; lane 0 is done with the other buffer
    stage<kValid>(tile[warp][cur ^ 1], got, ok, count, lane);  // tile t + 1, gathered before
    gather(src, vals, rows, got, ok);               // tile t + 2, from rows found before
    find_rows(src, rows, base + 3 * kTile, e, lane);  // tile t + 3
    if (lane == 0 && !isnan(acc)) {
      const T* buf = tile[warp][cur];
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
  if constexpr (kValid) {
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) count += __shfl_down_sync(kFull, count, d);
  } else {
    count = e - s;
  }
  if (lane == 0) {
    if (e > s && isnan(acc)) {  // a NaN start, as the first add leaves it: quieted
      using B = FoldBits<T>;
      acc = B::value(B::bits(acc) | B::kQuiet);
    }
    sums[g] = acc;
    counts[g] = count;
  }
}

template <typename T>
void launch_fold(const long long* perm, const long long* offs, const void* vals,
                 const bool* valid, const void* start_v, long long G, void* sums,
                 long long* counts, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((G + kFoldWarps - 1) / kFoldWarps);
  const unsigned threads = kFoldWarps * kWarp;
  const T* v = static_cast<const T*>(vals);
  const T* start = static_cast<const T*>(start_v);
  T* out = static_cast<T*>(sums);
  if (perm && valid) {
    fold_sum<T, true, true><<<blocks, threads, 0, stream>>>(perm, offs, v, valid, start, G, out, counts);
  } else if (perm) {
    fold_sum<T, true, false><<<blocks, threads, 0, stream>>>(perm, offs, v, valid, start, G, out, counts);
  } else if (valid) {
    fold_sum<T, false, true><<<blocks, threads, 0, stream>>>(perm, offs, v, valid, start, G, out, counts);
  } else {
    fold_sum<T, false, false><<<blocks, threads, 0, stream>>>(perm, offs, v, valid, start, G, out, counts);
  }
}

}  // namespace

extern "C" {

// Bytes of scratch the range pass needs for n rows: two partials, the
// owned group and the last range it reaches, a range.
long long hs_seg_scratch_bytes(long long n) {
  return num_ranges(n) * static_cast<long long>(2 * sizeof(Partial) + 2 * sizeof(long long));
}

// Integer sum (vals int64 or uint64 bits; NULL with sums NULL for a
// count) and count of valid rows per group. Returns a CUDA error code.
int hs_seg_sum_count(const long long* perm, const long long* offs, const long long* vals,
                     const bool* valid, long long n, long long G, long long* sums,
                     long long* counts, void* scratch, void* stream) {
  if (G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sums) return launch_ranges(perm, offs, valid, n, G, SumCount<true>{vals, sums, counts},
                                 scratch, st);
  return launch_ranges(perm, offs, valid, n, G, SumCount<false>{vals, sums, counts}, scratch, st);
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
// count of valid rows, per group; start ([G], NULL for +0.0) is each
// group's first operand. Returns a CUDA error code.
int hs_seg_fold_sum(const long long* perm, const long long* offs, const void* vals,
                    const bool* valid, long long G, int is_f64, void* sums, long long* counts,
                    void* stream, const void* start) {
  if (G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) launch_fold<double>(perm, offs, vals, valid, start, G, sums, counts, st);
  else launch_fold<float>(perm, offs, vals, valid, start, G, sums, counts, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
