// Fused filter-aggregate (kernel B5f): one chunk of rows folded into
// the carried groups of a grouped COUNT/SUM/MIN/MAX.
//
// Replaces the JAX package's host kernel hs_fused_filter_agg
// (hyperspace_tpu/native/hs_native.cpp:632), driven chunk by chunk by
// pipeline_compiler.py::_AggState.accumulate (:440). That kernel sweeps a
// chunk's rows in order: tests the range terms, finds each passing row's
// group in an open-addressing table keyed by the canonical key reps
// (Column.key_rep: NULL -> -0x7FFFFFFFFFFFFF13 with a null flag, NaN ->
// 0x7FF8000000000000, -0.0 -> 0), numbers new groups in order of first
// occurrence, and folds the row into the group's COUNT/SUM/MIN/MAX. Its
// plain PyTorch version is ops/fused_agg.py::fused_filter_agg_torch.
// Group identity is the full (rep, null) tuple of every key, never the
// hash: every probe compares tuples.
//
// Two routes, chosen on the host from the plan (ops/fused_agg.py::route):
//
// The one-pass route, for plans whose aggregates are exact in any order
// of combination: COUNT(*), COUNT(col), int64/temporal SUM (wrapping mod
// 2^64) and int64/temporal MIN and MAX (equal ints have equal bits, so no
// order can show). hs_agg_one_pass launches:
// 1. agg_block_pass: a block owns block_rows consecutive rows (2,048
//    from ops/fused_agg.py: small blocks spread the passing rows, which
//    come in runs, over more SMs). It reads the term columns as row pairs
//    (one 16-byte load a pair per column, pair_masks in range_terms.cuh),
//    keeps the 64-row steps' ballots in shared memory and counts the
//    block's passing rows; a block with none stops there. The key and
//    value columns are read only at passing rows, a lane's loads of
//    several steps issued together. Keyed, in two steps:
//    a. each passing row finds its tuple's slot in a table in dynamic
//       shared memory, sized from the block's passing rows up to block_slots,
//       by its own multiplicative hash. A slot names the block-local least
//       row of its tuple (claimed with atomicCAS, lowered with atomicMin)
//       and holds its first key's (rep, null), written by the claimant
//       after the claim: a prober compares the first key there once it is
//       written and re-reads the named row's key before, so it never sees
//       a half-written key. The row's slot goes to shared memory and the
//       slot's row count gains one (32-bit atomicAdd).
//    b. each other plane in turn: counts of valid rows (32-bit atomicAdd),
//       64-bit wrapping sums by atomicAdd, MIN and MAX by atomicMin /
//       atomicMax on long long.
//    Without keys a thread folds its rows in registers, plane by plane,
//    then warp shuffles and one block reduce. The block appends its
//    groups (first row, accumulators) to a global record list at an
//    offset taken by one atomicAdd. A table past 3/4 full, or a probe
//    that finds no free slot, sets the overflow flag and the block writes
//    no groups.
// 2. merge_init, insert_carried, merge_records: a global table sized on
//    the device to a power of two above twice the carried groups plus the
//    records (its buffer sized by the host from an upper bound and never
//    cleared whole). Carried groups go in first (slot = group id); each
//    record finds its tuple's slot, a new one claimed as -2 - first row
//    and listed in new_slot, the least first row kept by atomicMax on
//    -2 - r, the accumulators combined by the same atomics. Every kernel
//    reads the record count from the device and stops at once after an
//    overflow.
// The host then reads back four words in one copy (passing rows, records,
// overflow, new groups): the chunk's only synchronisation. On overflow it
// folds the chunk by the ordered route instead (the two give equal bits).
// Otherwise the new groups are numbered G, G+1, ... by first row (up to
// 1,024 of them ranked inside hs_agg_finish, by counting the smaller
// first rows; more by one torch.sort of their first rows: 15 us of sort
// launches against a microsecond), and hs_agg_finish writes the next
// state in one launch: carried groups' keys copied and accumulators
// combined with their slot's, new groups' keys read at their first rows.
//
// The ordered route, for plans with a float SUM, MIN or MAX: the float SUM
// is a left fold in row order and float MIN/MAX ties (-0.0 against 0.0)
// keep the later row, which no per-group atomic keeps. There kernel B3b
// (csrc/fused_select.cu) compacts the passing rows, hs_fused_group below
// finds each one's slot, and ops/fused_agg.py numbers the new groups and
// folds the rows with kernel B5 (csrc/segment_reduce.cu) over the rows
// sorted by group. hs_fused_group's table (-1 free, a carried group id, or
// -2 - r for the least listed row r of a tuple) is sized by the caller
// from the passing count; insert_groups puts the carried groups in first;
// group_pass gives a thread a listed row, claims a free slot with
// atomicCAS and moves a slot to its least row with atomicMax.
//
// Bound: the one-pass route reads the term columns whole and, of the key
// and value columns, the 32-byte sectors that hold passing rows; its
// records, table and state are a few words a group. HBM bandwidth bounds
// it. What holds it back on the H100 is the passing rows' chain of hash,
// probe and shared atomics in the blocks that hold passing rows: small
// blocks and four of them an SM put more warps on those chains.

#include <cstdint>
#include <cuda_runtime.h>

#include "range_terms.cuh"

namespace {

constexpr int kMaxKeys = 16;
constexpr long long kEmpty = -1;
constexpr long long kNullRep = -0x7FFFFFFFFFFFFF13LL;  // columnar.NULL_KEY_REP
constexpr long long kNanRep = 0x7FF8000000000000LL;    // canonical NaN (key_rep)
constexpr unsigned long long kSeed = 0x9E3779B97F4A7C15ull;
constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

struct Keys {
  const long long* cols[kMaxKeys];  // int64 bits: int64/temporal values or float64 bits
  const uint8_t* valid[kMaxKeys];   // nullptr: the key column has no nulls
  int f64;                          // bit j: key j is a float64 column
  int nk;
};

struct Groups {
  const long long* reps;  // [nk][G] carried groups' canonical reps
  const uint8_t* nulls;   // [nk][G] their null flags
  long long G;
};

struct PassArgs {
  Keys keys;
  Groups groups;
};

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

__device__ __forceinline__ unsigned long long hash_step(unsigned long long h, long long rep,
                                                        int nul) {
  h = mix64(h ^ static_cast<unsigned long long>(rep));
  return mix64(h ^ static_cast<unsigned long long>(nul));
}

// key j of row r as its canonical (rep, null flag)
__device__ __forceinline__ void key_at(const Keys& k, int j, long long r, long long& rep,
                                       int& nul) {
  if (k.valid[j] != nullptr && k.valid[j][r] == 0) {
    rep = kNullRep;
    nul = 1;
    return;
  }
  nul = 0;
  const long long bits = k.cols[j][r];
  if ((k.f64 >> j) & 1) {
    const double v = __longlong_as_double(bits);
    rep = v != v ? kNanRep : (v == 0.0 ? 0LL : bits);
  } else {
    rep = bits;
  }
}

__global__ void __launch_bounds__(kThreads)
    insert_groups(Groups g, int nk, long long* __restrict__ table, unsigned long long mask) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; id < g.G;
       id += stride) {
    unsigned long long h = kSeed;
    for (int j = 0; j < nk; ++j) h = hash_step(h, g.reps[j * g.G + id], g.nulls[j * g.G + id]);
    unsigned long long s = h & mask;
    while (atomicCAS(reinterpret_cast<unsigned long long*>(table + s),
                     static_cast<unsigned long long>(kEmpty),
                     static_cast<unsigned long long>(id)) != static_cast<unsigned long long>(kEmpty))
      s = (s + 1) & mask;
  }
}

__global__ void __launch_bounds__(kThreads)
    group_pass(const __grid_constant__ PassArgs a, const long long* __restrict__ rows,
               long long m, long long* __restrict__ table, unsigned long long mask,
               long long* __restrict__ slot_of_row) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int nk = a.keys.nk;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const long long r = rows != nullptr ? rows[i] : i;
    long long rep[kMaxKeys];
    int nul[kMaxKeys];
    unsigned long long h = kSeed;
    for (int j = 0; j < nk; ++j) {
      key_at(a.keys, j, r, rep[j], nul[j]);
      h = hash_step(h, rep[j], nul[j]);
    }
    const long long me = -2 - r;
    unsigned long long s = h & mask;
    long long cand;
    while (true) {
      cand = *reinterpret_cast<volatile long long*>(table + s);
      if (cand == kEmpty) {
        cand = static_cast<long long>(atomicCAS(reinterpret_cast<unsigned long long*>(table + s),
                                                static_cast<unsigned long long>(kEmpty),
                                                static_cast<unsigned long long>(me)));
        if (cand == kEmpty) {
          cand = me;
          break;
        }
      }
      bool eq = true;
      if (cand >= 0) {
        const Groups& g = a.groups;
        for (int j = 0; j < nk && eq; ++j)
          eq = g.reps[j * g.G + cand] == rep[j] && g.nulls[j * g.G + cand] == nul[j];
      } else {
        const long long q = -2 - cand;
        for (int j = 0; j < nk && eq; ++j) {
          long long qr;
          int qn;
          key_at(a.keys, j, q, qr, qn);
          eq = qr == rep[j] && qn == nul[j];
        }
      }
      if (eq) break;
      s = (s + 1) & mask;
    }
    // a row of this chunk holds the slot: keep the least row as its reference
    if (cand < 0 && me > *reinterpret_cast<volatile long long*>(table + s)) atomicMax(table + s, me);
    slot_of_row[i] = static_cast<long long>(s);
  }
}

unsigned blocks_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return want < 1 ? 1u : (want < kMaxBlocks ? static_cast<unsigned>(want) : kMaxBlocks);
}

// -- the one-pass route ---------------------------------------------------------

constexpr int kMaxPlanes = 32;   // count planes and value planes, each
constexpr int kMaxAggs = kMaxPlanes - 1;
constexpr int kRankMax = 1024;  // new groups a chunk that finish_groups ranks itself
constexpr int kPassThreads = 256;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kPassPairs = 4;      // row pairs a thread has in flight
constexpr int kStepsInFlight = 4;  // warp steps whose rows a lane loads at once
constexpr int kPassMinBlocks = 4;  // resident blocks an SM (64 registers a thread)
constexpr int kMaxBlockRows = 16384;  // block_rows: a multiple of 64 up to this
constexpr int kMinSlots = 32;
constexpr int kMaxSlots = 4096;
// shared memory a keyed block's table may take (its rows' slots take 2
// bytes a row beside it): four blocks an SM at 2,048 rows a block
constexpr int kTableBytes = 48 * 1024;
constexpr int kMaxDynSmem = kTableBytes + 2 * kMaxBlockRows;
constexpr int kOpSum = 2, kOpMin = 4, kOpMax = 5;  // ops/fused_agg.py's OP_* codes
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kI64Min = -kI64Max - 1;
constexpr unsigned kFull = 0xffffffffu;

// The accumulator planes of a chunk. Count plane 0 counts passing rows;
// count plane p > 0 the passing rows valid in cnt_valid[p]. Value plane q
// is the wrapping SUM, MIN or MAX (val_op[q]) of val_col[q] over the
// passing rows valid in val_valid[q] (nullptr: all). Aggregates share
// planes (ops/fused_agg.py::_planes).
struct Planes {
  int ncnt, nval;
  const uint8_t* cnt_valid[kMaxPlanes];
  const long long* val_col[kMaxPlanes];
  const uint8_t* val_valid[kMaxPlanes];
  int val_op[kMaxPlanes];
};

// Shared-memory bytes of one slot of a keyed block's table: the value
// planes and the first key's rep (8 bytes each), the count planes and the
// first row (4 each), the first key's null flag (1).
__host__ __device__ constexpr int slot_bytes(int ncnt, int nval) {
  return 8 * nval + 8 + 4 * ncnt + 4 + 1;
}

// Slots of a keyed block's table: the largest power of two, up to
// kMaxSlots, whose slots fit kTableBytes (at least kMinSlots).
constexpr int block_slots(int ncnt, int nval) {
  int s = kMaxSlots;
  while (s > kMinSlots && s * slot_bytes(ncnt, nval) > kTableBytes) s /= 2;
  return s;
}
static_assert(kMinSlots * slot_bytes(kMaxPlanes, kMaxPlanes) <= kTableBytes,
              "the least table of the most planes fits");

// Groups a block's table holds before the chunk overflows: 3/4 of its slots.
__host__ __device__ constexpr int fill_limit(int slots) { return slots - slots / 4; }

// Records the block pass may write: a group a block without keys; keyed,
// at most a block's fill limit a block and one a row.
long long records_cap(long long n, int block_rows, int nk, int ncnt, int nval) {
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (nk == 0) return blocks;
  const long long most = blocks * fill_limit(block_slots(ncnt, nval));
  return most < n ? most : n;
}

// Counters on the device, read back in one copy after the merge.
enum { kPassing = 0, kRecords = 1, kOverflow = 2, kNewGroups = 3 };

struct BlockArgs {
  hs_terms::Args terms;  // ncols 0: every row passes
  Keys keys;             // nk 0: one group
  Planes planes;
  long long n;
  int block_rows, slots;
  unsigned long long* counters;
  long long* rec;  // records: first rows [cap], count planes [ncnt][cap], value planes [nval][cap]
  long long cap;
};

struct MergeArgs {
  Keys keys;
  Groups groups;
  Planes planes;
  unsigned long long* counters;
  const long long* rec;
  long long cap;
  long long* table;  // refs [tcap], count planes [ncnt][tcap], value planes [nval][tcap]
  long long tcap;
  long long* carried_slot;  // [G]
  long long* new_slot;      // [cap]
};

struct State {
  long long* reps;  // [nk][G]
  uint8_t* nulls;
  long long* kvals;
  uint8_t* kvalid;
  long long* acc_i;  // [na][G]
  long long* acc_f;  // float64 bits
  long long* acc_cnt;
  long long* acc_aux;
};

struct FinishArgs {
  Keys keys;
  int ncnt, na;
  int agg_op[kMaxAggs], agg_cnt[kMaxAggs], agg_val[kMaxAggs];
  const long long* table;
  long long tcap;
  const long long* carried_slot;
  const long long* new_slot;
  const long long* order;  // new groups in first-row order; nullptr: ranked here
  long long G, G_new;
  State old_state, new_state;
};

__device__ __forceinline__ long long identity_of(int op) {
  return op == kOpMin ? kI64Max : (op == kOpMax ? kI64Min : 0);
}

__device__ __forceinline__ long long combine(int op, long long acc, long long v) {
  if (op == kOpSum)
    return static_cast<long long>(static_cast<unsigned long long>(acc) +
                                  static_cast<unsigned long long>(v));
  if (op == kOpMin) return v < acc ? v : acc;
  if (op == kOpMax) return v > acc ? v : acc;
  return acc;
}

__device__ __forceinline__ void atomic_combine(int op, long long* at, long long v) {
  if (op == kOpSum)
    atomicAdd(reinterpret_cast<unsigned long long*>(at), static_cast<unsigned long long>(v));
  else if (op == kOpMin)
    atomicMin(at, v);
  else
    atomicMax(at, v);
}

__device__ __forceinline__ unsigned long long row_hash(const Keys& k, long long r) {
  unsigned long long h = kSeed;
  for (int j = 0; j < k.nk; ++j) {
    long long rep;
    int nul;
    key_at(k, j, r, rep, nul);
    h = hash_step(h, rep, nul);
  }
  return h;
}

__device__ __forceinline__ bool same_rows(const Keys& k, long long a, long long b) {
  for (int j = 0; j < k.nk; ++j) {
    long long ra, rb;
    int na, nb;
    key_at(k, j, a, ra, na);
    key_at(k, j, b, rb, nb);
    if (ra != rb || na != nb) return false;
  }
  return true;
}

__device__ __forceinline__ bool same_as_group(const Keys& k, const Groups& g, long long gid,
                                              long long r) {
  for (int j = 0; j < k.nk; ++j) {
    long long rep;
    int nul;
    key_at(k, j, r, rep, nul);
    if (g.reps[j * g.G + gid] != rep || g.nulls[j * g.G + gid] != nul) return false;
  }
  return true;
}

__device__ __forceinline__ unsigned long long pow2_at_least(unsigned long long x) {
  return x <= 1 ? 1 : 1ull << (64 - __clzll(x - 1));
}

// the merge table's size: a power of two above twice the live tuples
__device__ __forceinline__ long long merge_size(const unsigned long long* counters,
                                                long long G) {
  const unsigned long long want = 2 * (static_cast<unsigned long long>(G) + counters[kRecords]);
  return static_cast<long long>(pow2_at_least(want < 2 ? 2 : want));
}

// One key into a block table's hash: Fibonacci hashing of the running
// hash and the key (the table takes the product's high bits).
__device__ __forceinline__ unsigned long long block_hash(unsigned long long h, long long rep,
                                                        int nul) {
  return ((h ^ static_cast<unsigned long long>(rep)) + static_cast<unsigned long long>(nul)) *
         kSeed;
}

// Whether the keys after the first of rows q and r are equal.
__device__ __forceinline__ bool same_rest(const Keys& k, long long q, long long r) {
  for (int j = 1; j < k.nk; ++j) {
    long long ra, rb;
    int na, nb;
    key_at(k, j, q, ra, na);
    key_at(k, j, r, rb, nb);
    if (ra != rb || na != nb) return false;
  }
  return true;
}

// The block-local slot of row r (block offset loc, first key (rep0,
// nul0), tuple hash h) in a table of S slots naming block-local rows;
// false when the table overflows. A slot's claimant writes its first
// key to srep/snul after the claim (snul 0xFF until then, a block fence
// between the two), so a prober compares the first key in shared memory
// once it is there, and re-reads the named row's key before.
__device__ bool block_slot(const Keys& k, long long row0, long long r, int loc, long long rep0,
                           int nul0, unsigned long long h, int* first, long long* srep,
                           uint8_t* snul, int S, int fill, int* used, int* overflow,
                           int& slot) {
  int s = static_cast<int>(h & static_cast<unsigned long long>(S - 1));
  for (int probe = 0; probe < S; ++probe) {
    int cur = *reinterpret_cast<volatile int*>(first + s);
    if (cur < 0) {
      cur = atomicCAS(first + s, -1, loc);
      if (cur < 0) {
        srep[s] = rep0;
        __threadfence_block();
        *reinterpret_cast<volatile uint8_t*>(snul + s) = static_cast<uint8_t>(nul0);
        if (atomicAdd(used, 1) >= fill) *reinterpret_cast<volatile int*>(overflow) = 1;
        slot = s;
        return true;
      }
    }
    const int n0 = *reinterpret_cast<volatile uint8_t*>(snul + s);
    __threadfence_block();
    long long q0;
    int m0 = n0;
    if (n0 != 0xFF) {
      q0 = *reinterpret_cast<volatile long long*>(srep + s);
    } else {
      key_at(k, 0, row0 + cur, q0, m0);
    }
    if (q0 == rep0 && m0 == nul0 && same_rest(k, row0 + cur, r)) {
      if (loc < cur) atomicMin(first + s, loc);
      slot = s;
      return true;
    }
    s = (s + 1) & (S - 1);
  }
  *reinterpret_cast<volatile int*>(overflow) = 1;
  return false;
}

// A lane's rows of kWords warp steps (64 rows each) of a block: step u is
// word base + u * kPassWarps, the lane's rows 64 * word + 2 * lane and the
// next; p0/p1 whether each passes.
template <int kWords>
__device__ __forceinline__ void step_rows(const uint2* bits, int base, int words, int lane,
                                          bool (&p0)[kWords], bool (&p1)[kWords]) {
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int word = base + u * kPassWarps;
    const uint2 w = word < words ? bits[word] : make_uint2(0u, 0u);
    p0[u] = (w.x >> lane) & 1u;
    p1[u] = (w.y >> lane) & 1u;
  }
}

__device__ __forceinline__ long long warp_combine(int op, long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = combine(op, v, __shfl_xor_sync(kFull, v, d));
  return v;
}

template <bool kKeys, bool kVec>
__global__ void __launch_bounds__(kPassThreads, kPassMinBlocks)
    agg_block_pass(const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint2 bits[kMaxBlockRows / 64];
  __shared__ long long red[kPassWarps];
  __shared__ int warp_cnt[kPassWarps];
  __shared__ int used, overflow, written;
  __shared__ long long base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * a.block_rows;
  const long long end = row0 + a.block_rows < a.n ? row0 + a.block_rows : a.n;
  const int words = a.block_rows / 64;

  // the predicate over the block's rows, a pair a lane, 64 rows a warp step
  int cnt = 0;
  for (int p0 = 0; p0 < a.block_rows / 2; p0 += kPassThreads * kPassPairs) {
    bool ok0[kPassPairs], ok1[kPassPairs];
    hs_terms::pair_masks<kVec, kPassPairs>(a.terms, row0 / 2 + p0 + threadIdx.x, kPassThreads,
                                           end, ok0, ok1);
#pragma unroll
    for (int u = 0; u < kPassPairs; ++u) {
      const unsigned b0 = __ballot_sync(kFull, ok0[u]), b1 = __ballot_sync(kFull, ok1[u]);
      const int word = p0 / 32 + u * kPassWarps + warp;
      if (word < words) {
        if (lane == 0) bits[word] = make_uint2(b0, b1);
        cnt += __popc(b0) + __popc(b1);
      }
    }
  }
  if (lane == 0) warp_cnt[warp] = cnt;
  if (threadIdx.x == 0) used = overflow = written = 0;
  __syncthreads();
  int pass = 0;
#pragma unroll
  for (int w = 0; w < kPassWarps; ++w) pass += warp_cnt[w];
  if (pass == 0) return;
  if (threadIdx.x == 0) atomicAdd(a.counters + kPassing, static_cast<unsigned long long>(pass));
  const Planes& pl = a.planes;

  constexpr int kW = kStepsInFlight;
  const int chunk = kPassWarps * kW;  // the warp steps of one round of loads

  if (!kKeys) {  // one group: registers, warp shuffles, one block reduce a plane
    if (threadIdx.x == 0) base = static_cast<long long>(atomicAdd(a.counters + kRecords, 1ull));
    __syncthreads();
    if (base >= a.cap) {  // cannot happen: one record a block
      if (threadIdx.x == 0) atomicExch(a.counters + kOverflow, 1ull);
      return;
    }
    if (threadIdx.x == 0) {
      a.rec[base] = row0;
      a.rec[a.cap + base] = pass;
    }
    for (int q = -(pl.ncnt - 1); q < pl.nval; ++q) {  // q < 0: count plane -q
      const int op = q < 0 ? kOpSum : pl.val_op[q];
      const uint8_t* valid = q < 0 ? pl.cnt_valid[-q] : pl.val_valid[q];
      const long long* col = q < 0 ? nullptr : pl.val_col[q];
      long long acc = identity_of(op);
      for (int w0 = warp; w0 < words; w0 += chunk) {
        bool p0[kW], p1[kW];
        step_rows<kW>(bits, w0, words, lane, p0, p1);
        long long x0[kW], x1[kW];
#pragma unroll
        for (int u = 0; u < kW; ++u) {  // every load of the round first
          const long long r = row0 + 64 * (w0 + u * kPassWarps) + 2 * lane;
          if (valid != nullptr) {
            p0[u] = p0[u] && valid[r];
            p1[u] = p1[u] && valid[r + 1];
          }
          x0[u] = col != nullptr && p0[u] ? col[r] : 1;
          x1[u] = col != nullptr && p1[u] ? col[r + 1] : 1;
        }
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          if (p0[u]) acc = combine(op, acc, x0[u]);
          if (p1[u]) acc = combine(op, acc, x1[u]);
        }
      }
      acc = warp_combine(op, acc);
      if (lane == 0) red[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        long long v = red[0];
        for (int w = 1; w < kPassWarps; ++w) v = combine(op, v, red[w]);
        a.rec[(q < 0 ? 1 - q : 1 + pl.ncnt + q) * a.cap + base] = v;
      }
      __syncthreads();
    }
    return;
  }

  // keyed: the block's table in dynamic shared memory, sized from its rows
  const int want = 2 * pass < kMinSlots ? kMinSlots : 2 * pass;
  int S = kMinSlots;
  while (S < want && S < a.slots) S <<= 1;
  if (S > a.slots) S = a.slots;
  const int fill = fill_limit(S);
  const int log_s = __ffs(S) - 1;
  auto* sval = reinterpret_cast<long long*>(smem);
  long long* srep = sval + static_cast<size_t>(pl.nval) * S;
  auto* scnt = reinterpret_cast<unsigned*>(srep + S);
  int* sfirst = reinterpret_cast<int*>(scnt + static_cast<size_t>(pl.ncnt) * S);
  auto* snul = reinterpret_cast<uint8_t*>(sfirst + S);
  // each passing row's slot, by block offset, after the largest table
  auto* slot_of = reinterpret_cast<unsigned short*>(
      smem + static_cast<size_t>(a.slots) * slot_bytes(pl.ncnt, pl.nval));
  for (int i = threadIdx.x; i < S; i += kPassThreads) {
    sfirst[i] = -1;
    snul[i] = 0xFF;
    for (int p = 0; p < pl.ncnt; ++p) scnt[p * S + i] = 0;
    for (int q = 0; q < pl.nval; ++q) sval[q * S + i] = identity_of(pl.val_op[q]);
  }
  __syncthreads();
  // 1. each passing row's slot (the first key's loads of a round issued together)
  const Keys& k = a.keys;
  for (int w0 = warp; w0 < words; w0 += chunk) {
    if (*reinterpret_cast<volatile int*>(&overflow)) break;
    bool p0[kW], p1[kW];
    step_rows<kW>(bits, w0, words, lane, p0, p1);
    long long b0[kW], b1[kW];
    bool v0[kW], v1[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      const long long r = row0 + 64 * (w0 + u * kPassWarps) + 2 * lane;
      b0[u] = p0[u] ? k.cols[0][r] : 0;
      b1[u] = p1[u] ? k.cols[0][r + 1] : 0;
      v0[u] = !p0[u] || k.valid[0] == nullptr || k.valid[0][r];
      v1[u] = !p1[u] || k.valid[0] == nullptr || k.valid[0][r + 1];
    }
    bool ok = true;
#pragma unroll
    for (int u = 0; u < kW; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok || !(h ? p1[u] : p0[u])) continue;
        const int loc = 64 * (w0 + u * kPassWarps) + 2 * lane + h;
        const long long r = row0 + loc;
        long long rep0 = kNullRep;
        int nul0 = 1;
        if (h ? v1[u] : v0[u]) {
          const long long bits0 = h ? b1[u] : b0[u];
          nul0 = 0;
          rep0 = bits0;
          if (k.f64 & 1) {
            const double d = __longlong_as_double(bits0);
            rep0 = d != d ? kNanRep : (d == 0.0 ? 0LL : bits0);
          }
        }
        // the block table's own hash (any one will do inside a block): a
        // multiply a key, high bits first
        unsigned long long hsh = block_hash(0, rep0, nul0);
        for (int j = 1; j < k.nk; ++j) {
          long long rep;
          int nul;
          key_at(k, j, r, rep, nul);
          hsh = block_hash(hsh, rep, nul);
        }
        hsh >>= 64 - log_s;
        int s;
        if (!block_slot(k, row0, r, loc, rep0, nul0, hsh, sfirst, srep, snul, S, fill, &used,
                        &overflow, s)) {
          ok = false;
          continue;
        }
        slot_of[loc] = static_cast<unsigned short>(s);
        atomicAdd(scnt + s, 1u);
      }
    }
    if (!ok) break;
  }
  __syncthreads();
  if (*reinterpret_cast<volatile int*>(&overflow)) {
    if (threadIdx.x == 0) atomicExch(a.counters + kOverflow, 1ull);
    return;
  }
  // 2. the other planes, one at a time, a round's loads issued together
  for (int q = -(pl.ncnt - 1); q < pl.nval; ++q) {  // q < 0: count plane -q
    const int op = q < 0 ? kOpSum : pl.val_op[q];
    const uint8_t* valid = q < 0 ? pl.cnt_valid[-q] : pl.val_valid[q];
    const long long* col = q < 0 ? nullptr : pl.val_col[q];
    for (int w0 = warp; w0 < words; w0 += chunk) {
      bool p0[kW], p1[kW];
      step_rows<kW>(bits, w0, words, lane, p0, p1);
      long long x0[kW], x1[kW];
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const long long r = row0 + 64 * (w0 + u * kPassWarps) + 2 * lane;
        if (valid != nullptr) {
          p0[u] = p0[u] && valid[r];
          p1[u] = p1[u] && valid[r + 1];
        }
        x0[u] = col != nullptr && p0[u] ? col[r] : 1;
        x1[u] = col != nullptr && p1[u] ? col[r + 1] : 1;
      }
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const int loc = 64 * (w0 + u * kPassWarps) + 2 * lane;
        if (q < 0) {
          if (p0[u]) atomicAdd(scnt + (-q) * S + slot_of[loc], 1u);
          if (p1[u]) atomicAdd(scnt + (-q) * S + slot_of[loc + 1], 1u);
        } else {
          if (p0[u]) atomic_combine(op, sval + q * S + slot_of[loc], x0[u]);
          if (p1[u]) atomic_combine(op, sval + q * S + slot_of[loc + 1], x1[u]);
        }
      }
    }
  }
  __syncthreads();
  const int ng = used;
  if (threadIdx.x == 0) base = static_cast<long long>(atomicAdd(a.counters + kRecords, static_cast<unsigned long long>(ng)));
  __syncthreads();
  if (base + ng > a.cap) {  // cannot happen: a block writes at most 3/4 of its slots
    if (threadIdx.x == 0) atomicExch(a.counters + kOverflow, 1ull);
    return;
  }
  for (int s = threadIdx.x; s < S; s += kPassThreads) {
    const int f = sfirst[s];
    if (f < 0) continue;
    const long long i = base + atomicAdd(&written, 1);
    a.rec[i] = row0 + f;
    for (int p = 0; p < pl.ncnt; ++p) a.rec[(1 + p) * a.cap + i] = scnt[p * S + s];
    for (int q = 0; q < pl.nval; ++q) a.rec[(1 + pl.ncnt + q) * a.cap + i] = sval[q * S + s];
  }
}

__global__ void __launch_bounds__(kThreads) merge_init(const __grid_constant__ MergeArgs a) {
  if (a.counters[kOverflow]) return;
  const long long T = merge_size(a.counters, a.groups.G);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < T;
       s += stride) {
    a.table[s] = kEmpty;
    for (int p = 0; p < a.planes.ncnt; ++p) a.table[(1 + p) * a.tcap + s] = 0;
    for (int q = 0; q < a.planes.nval; ++q)
      a.table[(1 + a.planes.ncnt + q) * a.tcap + s] = identity_of(a.planes.val_op[q]);
  }
}

__global__ void __launch_bounds__(kThreads) insert_carried(const __grid_constant__ MergeArgs a) {
  if (a.counters[kOverflow]) return;
  const Groups& g = a.groups;
  const unsigned long long mask = static_cast<unsigned long long>(merge_size(a.counters, g.G)) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; id < g.G;
       id += stride) {
    unsigned long long h = kSeed;
    for (int j = 0; j < a.keys.nk; ++j) h = hash_step(h, g.reps[j * g.G + id], g.nulls[j * g.G + id]);
    unsigned long long s = h & mask;
    while (atomicCAS(reinterpret_cast<unsigned long long*>(a.table + s),
                     static_cast<unsigned long long>(kEmpty),
                     static_cast<unsigned long long>(id)) != static_cast<unsigned long long>(kEmpty))
      s = (s + 1) & mask;
    a.carried_slot[id] = static_cast<long long>(s);
  }
}

__global__ void __launch_bounds__(kThreads) merge_records(const __grid_constant__ MergeArgs a) {
  if (a.counters[kOverflow]) return;
  const long long m = static_cast<long long>(a.counters[kRecords]);
  const unsigned long long mask = static_cast<unsigned long long>(merge_size(a.counters, a.groups.G)) - 1;
  const Planes& pl = a.planes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const long long r = a.rec[i];
    const long long me = -2 - r;
    unsigned long long s = row_hash(a.keys, r) & mask;
    long long cand;
    while (true) {
      cand = *reinterpret_cast<volatile long long*>(a.table + s);
      if (cand == kEmpty) {
        cand = static_cast<long long>(atomicCAS(reinterpret_cast<unsigned long long*>(a.table + s),
                                                static_cast<unsigned long long>(kEmpty),
                                                static_cast<unsigned long long>(me)));
        if (cand == kEmpty) {
          a.new_slot[atomicAdd(a.counters + kNewGroups, 1ull)] = static_cast<long long>(s);
          cand = me;
          break;
        }
      }
      if (cand >= 0 ? same_as_group(a.keys, a.groups, cand, r) : same_rows(a.keys, -2 - cand, r))
        break;
      s = (s + 1) & mask;
    }
    if (cand < 0 && me > *reinterpret_cast<volatile long long*>(a.table + s)) atomicMax(a.table + s, me);
    for (int p = 0; p < pl.ncnt; ++p)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.table + (1 + p) * a.tcap + s),
                static_cast<unsigned long long>(a.rec[(1 + p) * a.cap + i]));
    for (int q = 0; q < pl.nval; ++q)
      atomic_combine(pl.val_op[q], a.table + (1 + pl.ncnt + q) * a.tcap + s,
                     a.rec[(1 + pl.ncnt + q) * a.cap + i]);
  }
}

__global__ void __launch_bounds__(kThreads) finish_groups(const __grid_constant__ FinishArgs a) {
  __shared__ long long refs[kRankMax];  // the new groups' slot refs, -2 - first row
  const long long G2 = a.G + a.G_new;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const State& o = a.old_state;
  const State& w = a.new_state;
  const bool rank_here = a.order == nullptr && a.G_new > 1;
  if (rank_here) {
    for (int i = threadIdx.x; i < a.G_new; i += blockDim.x) refs[i] = a.table[a.new_slot[i]];
    __syncthreads();
  }
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < G2;
       idx += stride) {
    const bool carried = idx < a.G;
    long long s, g = idx;
    if (!carried && a.order != nullptr) {
      s = a.new_slot[a.order[idx - a.G]];
    } else if (!carried) {  // listed new group k: its rank among the new groups by first row
      const long long k = idx - a.G;
      s = a.new_slot[k];
      long long rank = 0;
      if (rank_here) {
        const long long mine = refs[k];
        for (int i = 0; i < a.G_new; ++i) rank += refs[i] > mine;
      }
      g = a.G + rank;
    }
    if (carried) {
      s = a.carried_slot[g];
      for (int j = 0; j < a.keys.nk; ++j) {
        w.reps[j * G2 + g] = o.reps[j * a.G + g];
        w.nulls[j * G2 + g] = o.nulls[j * a.G + g];
        w.kvals[j * G2 + g] = o.kvals[j * a.G + g];
        w.kvalid[j * G2 + g] = o.kvalid[j * a.G + g];
      }
    } else {
      const long long r = -2 - a.table[s];
      for (int j = 0; j < a.keys.nk; ++j) {
        long long rep;
        int nul;
        key_at(a.keys, j, r, rep, nul);
        w.reps[j * G2 + g] = rep;
        w.nulls[j * G2 + g] = static_cast<uint8_t>(nul);
        w.kvals[j * G2 + g] = a.keys.cols[j][r];
        w.kvalid[j * G2 + g] = a.keys.valid[j] != nullptr ? (a.keys.valid[j][r] != 0) : 1;
      }
    }
    for (int x = 0; x < a.na; ++x) {
      const int op = a.agg_op[x];
      const long long old_i = carried ? o.acc_i[x * a.G + g] : identity_of(op);
      const long long v = a.agg_val[x] >= 0 ? a.table[(1 + a.ncnt + a.agg_val[x]) * a.tcap + s]
                                            : identity_of(op);
      w.acc_i[x * G2 + g] = combine(op, old_i, v);
      w.acc_cnt[x * G2 + g] = (carried ? o.acc_cnt[x * a.G + g] : 0) +
                              a.table[(1 + a.agg_cnt[x]) * a.tcap + s];
      w.acc_f[x * G2 + g] = carried ? o.acc_f[x * a.G + g] : 0;
      w.acc_aux[x * G2 + g] = carried ? o.acc_aux[x * a.G + g] : 0;
    }
  }
}

template <bool kKeys, bool kVec>
cudaError_t launch_block_pass(const BlockArgs& a, unsigned blocks, size_t smem, cudaStream_t st) {
  static bool sized = false;  // one instance, one attribute: set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        agg_block_pass<kKeys, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  agg_block_pass<kKeys, kVec><<<blocks, kPassThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Keys: key_cols[nk] [n] int64 bits on the device, key_valids[nk] [n]
// bool or NULL, key_f64 bit j for a float64 key, 1 <= nk <= 16. Carried
// groups: g_reps [nk][G] int64 and g_nulls [nk][G] uint8. rows: [m]
// ascending row indices to group (the passing rows), or NULL for rows
// 0 .. m - 1. table: [table_size] int64 scratch, a power of two above
// G + m; slot_of_row: [m] int64 out. Launches on `stream`: the table's
// fill, insert_groups when there are carried groups, group_pass when
// m > 0. Returns a CUDA error code.
int hs_fused_group(const void* const* key_cols, const void* const* key_valids, int key_f64,
                   int nk, const long long* g_reps, const uint8_t* g_nulls, long long G,
                   const long long* rows, long long m, long long* table, long long table_size,
                   long long* slot_of_row, void* stream) {
  if (m < 0 || G < 0 || nk < 1 || nk > kMaxKeys || (m > 0 && slot_of_row == nullptr) ||
      table == nullptr || table_size <= G + m || (table_size & (table_size - 1)) != 0 ||
      (G > 0 && (g_reps == nullptr || g_nulls == nullptr)))
    return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.keys.nk = nk;
  a.keys.f64 = key_f64;
  for (int j = 0; j < nk; ++j) {
    a.keys.cols[j] = static_cast<const long long*>(key_cols[j]);
    a.keys.valid[j] = static_cast<const uint8_t*>(key_valids[j]);
    if (a.keys.cols[j] == nullptr && m > 0) return (int)cudaErrorInvalidValue;
  }
  a.groups = Groups{g_reps, g_nulls, G};
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned long long mask = static_cast<unsigned long long>(table_size) - 1;
  const cudaError_t err = cudaMemsetAsync(table, 0xFF, table_size * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  if (G > 0) insert_groups<<<blocks_for(G), kThreads, 0, st>>>(a.groups, nk, table, mask);
  if (m > 0) group_pass<<<blocks_for(m), kThreads, 0, st>>>(a, rows, m, table, mask, slot_of_row);
  return (int)cudaGetLastError();
}

// Slots of a keyed block's table in hs_agg_one_pass for ncnt count
// planes and nval value planes (block_slots); the table overflows past
// 3/4 of them. -1 for plane counts out of range.
int hs_agg_block_slots(int ncnt, int nval) {
  if (ncnt < 1 || ncnt > kMaxPlanes || nval < 0 || nval > kMaxPlanes) return -1;
  return block_slots(ncnt, nval);
}

// The one-pass route's first half (see the top of this file). Terms as
// hs_range_mask takes them (ncols = nterms = 0: every row passes); keys as
// hs_fused_group takes them, nk 0 for one group; planes: ncnt count planes
// (cnt_valids[0] ignored: plane 0 counts passing rows), nval value planes
// (val_cols [n] int64, val_valids or NULL, val_ops 2 SUM, 4 MIN, 5 MAX).
// block_rows: a multiple of 64 up to 16,384 (a keyed block's table takes
// hs_agg_block_slots of the planes, sized here). Carried groups
// g_reps/g_nulls [nk][G]. Scratch: counters [4] int64 (zeroed here; read
// back after: passing rows, records, overflow, new groups); rec [(1 +
// ncnt + nval) * cap] with cap >= the records (blocks without keys;
// keyed, min(n, blocks * 3/4 of the slots)); table [(1 + ncnt + nval) *
// tcap], tcap a power of two
// >= 2 (G + cap); carried_slot [G]; new_slot [cap]. Launches on
// `stream`: a memset, agg_block_pass, merge_init, insert_carried when
// G > 0, merge_records. Returns a CUDA error code.
int hs_agg_one_pass(const void* const* cols, const void* const* valids, int ncols,
                    const int* term_col, const int64_t* lo_i, const int64_t* hi_i,
                    const double* lo_f, const double* hi_f, const int* flags, int nterms,
                    const void* const* key_cols, const void* const* key_valids, int key_f64,
                    int nk, int ncnt, const void* const* cnt_valids, int nval,
                    const void* const* val_cols, const void* const* val_valids,
                    const int* val_ops, long long n, int block_rows,
                    const long long* g_reps, const uint8_t* g_nulls, long long G,
                    long long* counters, long long* rec, long long cap, long long* table,
                    long long tcap, long long* carried_slot, long long* new_slot,
                    void* stream) {
  if (n < 1 || nk < 0 || nk > kMaxKeys || ncnt < 1 || ncnt > kMaxPlanes || nval < 0 ||
      nval > kMaxPlanes || block_rows < 64 || block_rows > kMaxBlockRows || block_rows % 64 ||
      G < 0 || cap < 1 || tcap < 2 || (tcap & (tcap - 1)) || tcap < 2 * (G + cap) ||
      counters == nullptr || rec == nullptr || table == nullptr || new_slot == nullptr ||
      (G > 0 && (carried_slot == nullptr || (nk > 0 && (g_reps == nullptr || g_nulls == nullptr)))) ||
      (nk == 0 && G != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  BlockArgs a = {};
  cudaError_t err = hs_terms::pack_args(a.terms, cols, valids, ncols, term_col, lo_i, hi_i, lo_f,
                                        hi_f, flags, nterms, /*allow_empty=*/true);
  if (err != cudaSuccess) return (int)err;
  a.keys.nk = nk;
  a.keys.f64 = key_f64;
  for (int j = 0; j < nk; ++j) {
    a.keys.cols[j] = static_cast<const long long*>(key_cols[j]);
    a.keys.valid[j] = static_cast<const uint8_t*>(key_valids[j]);
    if (a.keys.cols[j] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.planes.ncnt = ncnt;
  a.planes.nval = nval;
  for (int p = 1; p < ncnt; ++p) {
    a.planes.cnt_valid[p] = static_cast<const uint8_t*>(cnt_valids[p]);
    if (a.planes.cnt_valid[p] == nullptr) return (int)cudaErrorInvalidValue;
  }
  for (int q = 0; q < nval; ++q) {
    a.planes.val_col[q] = static_cast<const long long*>(val_cols[q]);
    a.planes.val_valid[q] = static_cast<const uint8_t*>(val_valids[q]);
    a.planes.val_op[q] = val_ops[q];
    if (a.planes.val_col[q] == nullptr ||
        (val_ops[q] != kOpSum && val_ops[q] != kOpMin && val_ops[q] != kOpMax))
      return (int)cudaErrorInvalidValue;
  }
  a.n = n;
  a.block_rows = block_rows;
  const int slots = block_slots(ncnt, nval);
  a.slots = slots;
  a.counters = reinterpret_cast<unsigned long long*>(counters);
  a.rec = rec;
  a.cap = cap;
  // the table (at most kTableBytes) and the rows' slots: at most kMaxDynSmem
  const size_t smem =
      nk > 0 ? static_cast<size_t>(slots) * slot_bytes(ncnt, nval) + 2 * block_rows : 0;
  if (cap < records_cap(n, block_rows, nk, ncnt, nval)) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counters, 0, 4 * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  const bool vec = hs_terms::vec_aligned(a.terms);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (nk > 0)
    err = vec ? launch_block_pass<true, true>(a, grid, smem, st)
              : launch_block_pass<true, false>(a, grid, smem, st);
  else
    err = vec ? launch_block_pass<false, true>(a, grid, smem, st)
              : launch_block_pass<false, false>(a, grid, smem, st);
  if (err != cudaSuccess) return (int)err;
  MergeArgs m = {};
  m.keys = a.keys;
  m.groups = Groups{g_reps, g_nulls, G};
  m.planes = a.planes;
  m.counters = a.counters;
  m.rec = rec;
  m.cap = cap;
  m.table = table;
  m.tcap = tcap;
  m.carried_slot = carried_slot;
  m.new_slot = new_slot;
  merge_init<<<blocks_for(tcap), kThreads, 0, st>>>(m);
  if (G > 0) insert_carried<<<blocks_for(G), kThreads, 0, st>>>(m);
  merge_records<<<blocks_for(cap), kThreads, 0, st>>>(m);
  return (int)cudaGetLastError();
}

// The one-pass route's last launch, after the counters were read back
// (no overflow, a passing row): the next state [nk][G + G_new] and
// [na][G + G_new] from the carried one [nk][G], [na][G] (the State
// pointers in the order reps, nulls, kvals, kvalid, acc_i, acc_f bits,
// acc_cnt, acc_aux) and hs_agg_one_pass's table. Aggregate x has op
// agg_ops[x], count plane agg_cnt[x] and value plane agg_val[x] (-1:
// none). order: [G_new] positions in new_slot by first row, or NULL when
// G_new <= 1,024 (the kernel ranks them by first row itself). Returns a
// CUDA error code.
int hs_agg_finish(const void* const* key_cols, const void* const* key_valids, int key_f64,
                  int nk, int ncnt, int na, const int* agg_ops, const int* agg_cnt,
                  const int* agg_val, const long long* table, long long tcap,
                  const long long* carried_slot, const long long* new_slot,
                  const long long* order, long long G, long long G_new,
                  const void* const* old_state, const void* const* new_state, void* stream) {
  if (nk < 0 || nk > kMaxKeys || na < 0 || na > kMaxAggs || G < 0 || G_new < 0 ||
      G + G_new < 1 || table == nullptr || (G > 0 && carried_slot == nullptr) ||
      (G_new > 0 && new_slot == nullptr) || (G_new > kRankMax && order == nullptr))
    return (int)cudaErrorInvalidValue;
  FinishArgs f = {};
  f.keys.nk = nk;
  f.keys.f64 = key_f64;
  for (int j = 0; j < nk; ++j) {
    f.keys.cols[j] = static_cast<const long long*>(key_cols[j]);
    f.keys.valid[j] = static_cast<const uint8_t*>(key_valids[j]);
  }
  f.ncnt = ncnt;
  f.na = na;
  for (int x = 0; x < na; ++x) {
    f.agg_op[x] = agg_ops[x];
    f.agg_cnt[x] = agg_cnt[x];
    f.agg_val[x] = agg_val[x];
  }
  f.table = table;
  f.tcap = tcap;
  f.carried_slot = carried_slot;
  f.new_slot = new_slot;
  f.order = order;
  f.G = G;
  f.G_new = G_new;
  State* sides[2] = {&f.old_state, &f.new_state};
  const void* const* ptrs[2] = {old_state, new_state};
  for (int i = 0; i < 2; ++i) {
    const void* const* p = ptrs[i];
    *sides[i] = State{static_cast<long long*>(const_cast<void*>(p[0])),
                      static_cast<uint8_t*>(const_cast<void*>(p[1])),
                      static_cast<long long*>(const_cast<void*>(p[2])),
                      static_cast<uint8_t*>(const_cast<void*>(p[3])),
                      static_cast<long long*>(const_cast<void*>(p[4])),
                      static_cast<long long*>(const_cast<void*>(p[5])),
                      static_cast<long long*>(const_cast<void*>(p[6])),
                      static_cast<long long*>(const_cast<void*>(p[7]))};
  }
  const auto st = static_cast<cudaStream_t>(stream);
  finish_groups<<<blocks_for(G + G_new), kThreads, 0, st>>>(f);
  return (int)cudaGetLastError();
}

}  // extern "C"
