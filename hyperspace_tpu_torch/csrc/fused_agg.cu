// Fused filter-aggregate, the group pass (kernel B5f).
//
// Replaces the JAX package's host kernel hs_fused_filter_agg
// (hyperspace_tpu/native/hs_native.cpp:632), driven chunk by chunk by
// pipeline_compiler.py::_AggState.accumulate (:440). That kernel sweeps a
// chunk's rows in order: tests the range terms, finds each passing row's
// group in an open-addressing table keyed by the canonical key reps
// (Column.key_rep: NULL -> -0x7FFFFFFFFFFFFF13 with a null flag, NaN ->
// 0x7FF8000000000000, -0.0 -> 0), numbers new groups in order of first
// occurrence, and folds the row into the group's COUNT/SUM/MIN/MAX.
//
// The port splits that sweep in three (hyperspace_tpu_torch/ops/
// fused_agg.py): the passing rows compacted by kernel B3b (csrc/
// fused_select.cu, B3a's predicate from range_terms.cuh), this group pass
// over them, then first-occurrence numbering of the chunk's new groups
// (torch ops over the passing rows) and the reductions through kernel B5
// (csrc/segment_reduce.cu) over the passing rows sorted by group,
// combined with the carried state by the reference accumulators' own
// rules, the float sum folded from the carried sums. Its plain PyTorch
// version is ops/fused_agg.py::fused_filter_agg_torch (a stable sort of
// the rep planes instead of this table).
//
// What this pass computes, for m listed rows of a chunk (the passing
// rows, ascending) and G carried groups:
// * slot_of_row[i]: the table slot of listed row i's key tuple;
// * table[s]: -1 free, a carried group id (>= 0), or -2 - r where r is
//   the least listed row whose key tuple holds slot s.
// Group identity is the full (rep, null) tuple of every key, never the
// hash: a probe compares the tuples.
//
// Design:
// * The table is sized by the caller from the passing count (a power of
//   two above twice the carried groups plus the listed rows), so it never
//   fills and there is no stop-and-grow as in the reference. insert_groups
//   puts the carried groups in first, one thread a group (distinct
//   tuples, so a free slot is all they need).
// * group_pass gives a thread a listed row. A row probes from its hash
//   (the reference's splitmix64 chain over rep and null flag) and claims a
//   free slot with atomicCAS, storing -2 - r. A slot never holds a
//   half-written key: its occupant is a reference, and a prober compares
//   against the carried group's reps or against a referenced row's keys
//   re-read from the chunk's columns, both written before the launch.
//   Every row a slot references holds the same tuple, so a row of the
//   group that comes later moves the reference to the least row with
//   atomicMax on -2 - r, and a prober's compare does not depend on which
//   it reads. Slots are read with volatile loads and the atomicMax is
//   taken only when the slot holds a later row, so hot groups cost loads,
//   not atomics. A listed row is its group's first when the slot names it
//   after the pass.
//
// Bound: the pass reads the key columns at the listed rows once (8 bytes
// a row each, 1 a validity) and the row list, and writes 8 bytes a row;
// the table (16 bytes a listed row) lives in L2 for small group counts.

#include <cstdint>
#include <cuda_runtime.h>

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

}  // extern "C"
