// Kernel B: tight-inclusion root finder; in the unbounded modes eight lanes
// per query and domains shared inside a block, elsewhere one lane per query
// on a persistent grid.
//
// Replaces: scalable_ccd_tpu/ops/pallas_solver.py, _solver_kernel (global,
// per_query, max_iterations and round_limit modes, launched by
// _find_roots_packed), itself the TPU form of the reference's ccd_kernel
// (src/scalable_ccd/cuda/narrow_phase/root_finder.cu:277-370).
//
// What bounds it on an H100: latency, not arithmetic or bytes.  Each query
// evaluates one domain after another, from 1 to tens of thousands of times,
// and one evaluation is a dependent chain: the residual F at 8 corners in 3
// dims, their min/max, the filters, the split choice, the stack push or the
// unwind.  A launch lasts as long as its deepest query: on the bench scene's
// EE batches the deepest did 3,956 evaluations where the median did 10, on
// the per-query rows of cloth_on_sphere(64, 3) one query did 27,339, and
// a frame pool block whose deepest query did 806 took 0.44 ms on an H100
// (tools/stages.py --kernel-b).  f64 rows cost what f32 rows cost.
//
// Design: the host picks the form from the mode.
//
// 1. Bounded and round-limited modes (solve_lane_kernel): one lane per
//    query, as the reference's kernel.  Their results (the unfin plane, the
//    checks, a capped TOI) are defined by each query's depth-first order,
//    so nothing may change it.  They are throughput passes over many mostly
//    shallow queries (a median of ~10 evaluations; a round-limited query
//    stops at its limit, 128 rounds on the main path), so what bounds them
//    is the latency of each query's chain and how many chains the card
//    keeps in flight; the bytes (one 31-scalar row per query) are 500x
//    under it.  Launched one per 16,384-row batch in 32-thread blocks, this
//    form filled ~4 warps of an SM's 64, and each warp of 32 queries lasted
//    as long as its deepest.  Now:
//    - a persistent grid of 128-thread blocks, as many as stay resident
//      (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs) and no
//      more than the queries need, so that one launch over a chunk of up to
//      2^20 rows fills the card (the narrow loop's round-limited pass runs
//      once per chunk, pipeline/fused.py);
//    - each warp takes 32 consecutive queries at a time from a global cursor
//      (one atomicAdd per warp), stages their rows coalesced into its own
//      slice of shared memory with 1 / tol, the exactness flag and the valid
//      byte (Stage), and hands them out lane by lane: a lane whose query
//      ends takes the next staged query, so a deep query holds its own lane
//      and not its warp; the warp fetches the next 32 once every staged
//      query is taken;
//    - the search loop is flat: an iteration runs one round of every busy
//      lane's search, then the idle lanes refill, so no lane waits at the
//      end of another's search.  A lane keeps its query's row in registers
//      (the staged slot is refilled while the query runs);
//    - a row source fills the staged slots (template Source, below): the
//      columns source copies kernel C's packed columns; the pairs source
//      (sccd_solve_pairs, global mode) reads the query's element-id pair and
//      computes its row in the lane with kernel C's own pack_row
//      (csrc/pack_row.cuh), bit for bit kernel C's row.  With no column
//      buffer, whose size grows with the rows it holds, one launch can
//      solve a whole broad chunk of ccd() (pipeline/ccd.py: 0.36-2 M
//      candidates, 45-260 MB of columns) where columns allowed one 2^17-row
//      batch at a time, each with its own launch and host read.  The gather
//      (about 400 operations and two table rows from L2 a row) is paid once
//      a query, against a search of ten and more evaluations.
//    Each query's search is the form's as before: the same order, round
//    count, cap and guard, and its unfin byte and checks are written by
//    query index.  Eight lanes per query measured 10-40% slower in these
//    modes (the lanes split only the corners, and an evaluation's chain is
//    its decisions, stack and unwind).
// 2. Unbounded global and per-query modes (solve_kernel): domains shared
//    inside a block, eight lanes per query, 32 lane groups per block, and
//    32 to 128 queries per block with their rows staged in shared memory.
//    Their TOIs do not depend on the order (accept, reject and the caps are
//    decisions of the domain alone, and pruning drops only domains at or
//    after an accepted time), and their time is that of the deepest query.
//    - Queries: a group takes the block's next valid query (a shared
//      cursor) whenever its search ends, so a block of mostly shallow
//      queries keeps its groups busy until all its queries are taken.
//    - Queries per block (shared_grid): the most of 128, 64 and 32 whose
//      blocks still fill every SM's resident slots
//      (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), else
//      32: a large launch (a whole phase, or a chunk of up to 2^20 rows)
//      packs its many shallow queries densely, and a small one (a batch of
//      16,384 rows or fewer) keeps one query per group and its blocks on
//      every SM.
//    - Rows: a row source (template Source, as form 1's) fills the block's
//      rows when the block starts.  The columns source copies them
//      coalesced from kernel C's columns.  The pairs source (sccd_solve_pairs
//      with no cap) computes them, one thread a row, with pack_row, bit for
//      bit kernel C's rows.  With no column buffer (124 bytes a float row)
//      one launch solves a whole phase of fused_ccd's default path on CUDA
//      (tens of millions of rows): it launches no kernel C, drains its
//      deepest query once, and a contact found in any block prunes every
//      other block's search.
//    - Eight lanes per query: lane (it, iu, iv) computes F at one corner of
//      the domain with the expression and association of domain_corners
//      (narrow_phase/types.py), and the per-dimension min and max are
//      reduced with __shfl_xor_sync over offsets 1, 2 and 4: exact in any
//      order, so every lane holds the values one thread computes.  Every
//      lane keeps the same bounds, stack, split counters and round count, so
//      the group stays converged; lane 0 alone reads the running TOI (and
//      broadcasts it, so that one read decides the prune and the culls of
//      the whole group), does the atomics and writes the outputs.  The
//      running TOI is read one evaluation ahead (it only decreases; the
//      group's own accepts are folded in).  One lane per query measured
//      1.4-1.9x slower here: a block of 32 threads is one warp, and its
//      searches of one deep query share one scheduler.
//    - Sharing: each block keeps a queue of up to 32 domains in shared
//      memory, each with its query's slot, its bounds (exact dyadics), its
//      absolute depth and its split counters.  While a group of the block is
//      idle (its block's queries all taken), a group that splits hands it
//      the shallowest pending sibling on its stack (the largest subtree it
//      holds, at least kStealMin levels up; its bounds follow from the
//      current domain and the split counts at its level, since every domain
//      is an aligned dyadic box) and clears that level's pending bit.  An
//      idle group takes a domain and runs a fresh search rooted there, whose
//      stack holds kDepth - depth levels, so the depth and split caps stay
//      absolute.  A block ends when its queries are all taken, the queue is
//      empty and no group is busy (one counter holds the last two, so the
//      test is one read).  In per-query mode each query's running TOI lives
//      in shared memory, lowered with a shared-memory atomicMin, since
//      several groups may hold its domains.  Nothing in the search loop
//      waits on another group: the queue takes shared-memory atomics, and an
//      idle group polls with __nanosleep.  A deep query then takes the
//      block's 32 groups instead of one.
// In both forms the split choice's w / tol is w * (1 / tol), exact because
// every width is a power of two (below).
//
// Modes (template PER_QUERY, runtime max_iterations and round_limit;
// allow_zero_toi is a runtime flag too):
// - global (the TPU kernel's default mode): the running TOI is one device
//   float, seeded with toi_init, read at every evaluation and lowered with
//   atomicMin on its int bits (valid for non-negative floats; the
//   reference's atomic_min_float.cuh).
// - per_query (TPU per_query=True, the reference's TOI_PER_QUERY build):
//   each query prunes, and culls t-split siblings, only against its own
//   TOI, which starts at +inf, not toi_init.  Nothing is shared between
//   queries, so each per-query TOI is exact and independent of the others;
//   every query writes its TOI (+inf for invalid rows and rows without
//   contact) to the per-query plane, then one atomicMin folds it into the
//   global TOI.
// - bounded (TPU max_iterations >= 0): the query's evaluation count is
//   compared BEFORE it is incremented, and a domain past the cap is dropped,
//   never accepted; dropped evaluations count too (pallas_solver.py:
//   233-237, the reference's root_finder.cu:289,303-305).  With per_query
//   the result is deterministic and follows the plain lockstep DFS
//   (narrow_phase/root_finder.py:dfs_lockstep) bit for bit: both explore
//   child1 first and enter a pending sibling on unwind.  In global mode the
//   domains a binding cap drops depend on when other queries lower the
//   shared TOI, so the result can change from run to run (as on the TPU);
//   the plain version then counts as the JAX queue solver does, and the two
//   agree wherever the cap does not bind.
// - round_limit (TPU round_limit >= 0, the staged-escalation pass; global
//   mode only): a query stops after round_limit rounds and, if it is still
//   mid-search, writes unfin[q] = 1 instead of accepting: it neither lowers
//   the TOI nor sets overflow, and the caller re-solves it from scratch
//   (ops/solver.py:solve_escalated).  Rounds are counted as the TPU kernel's
//   while loop counts them (pallas_solver.py:392-397): one round evaluates
//   the current domain, if any, and then unwinds at most two levels of a
//   finished one, so a round can evaluate nothing.  In the other modes the
//   unwind runs to the next pending sibling in one round; the result is the
//   same, only the loop count differs.  Every query writes its unfin byte.
// Bounded and round-limited results depend on each query's order, so these
// modes take form 1; the host picks the form from the mode.
//
// Stack: a split stores one 4-bit nibble {dim, side, pending sibling} and
// the replaced bound is reconstructed on unwind as 2*hi - lo or 2*lo - hi,
// exact because every bound is a dyadic k/2^m with m at most the split cap.
// Past kDepth levels or dim_cap splits of one dimension the domain is
// accepted conservatively and the overflow flag is set.  checks are summed
// and overflow or-ed per warp, then once per warp with atomics.
//
// Runaway guard: a query stops after max_steps evaluations and accepts its
// earliest unexplored time conservatively (overflow set).  max_steps is
// kMaxSteps (2^20) in unbounded modes, where several groups may search one
// query: its count is kept in shared memory, each task adds its own when it
// ends, and a task stops once the count at its start plus its own reaches
// the guard and accepts the earliest time it still holds (so a query makes
// at most 32 times the guard's evaluations); with a cap it is raised to at
// least max_iterations + 2 * kDepth + 2, past the last evaluation a capped
// search can make (the cap, then one dropped evaluation per pending
// sibling), so the cap always applies before the guard.  With a round
// limit it is raised past the limit (a round evaluates at most once), so
// the guard never fires.
//
// Scalar type (template T): the rows are float or double.  In double the
// running TOI is lowered with atomicMin on its long long bits (valid for
// non-negative doubles) and the stack has 128 levels (sixteen 32-bit words:
// with a 2^-53 error filter a search ends on its tolerances, ~20 splits in
// each of the three dimensions at a co-domain tolerance of 1e-6, and runs
// deeper than float's).  The per-dimension split cap is an argument: 24 for
// float rows (bounds exact in a 24-bit mantissa), 52 for double rows, and
// 24 for double rows widened from float ones (the compensated precision of
// ops/solver.py: every bound, and so the TOI, stays exact in float).
//
// The VF cull limit 1 / (1 - eps) on u + v is an argument too: float's for
// float rows and for widened rows, as the JAX package's compensated mode
// keeps it, double's for double rows.
//
// Must be compiled with -fmad=false (it holds for DFMA as for FFMA): the
// unwind, the midpoints and the error filter assume separately rounded
// multiplies and adds (no FMA contraction), exactly as the plain twin
// computes them (ops/solver.py).
//
// Plain C interface, bound with ctypes (ops/solver.py).

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "pack_row.cuh"

namespace {

// stack levels (4-bit nibbles, eight per 32-bit word)
template <typename T> struct Scalar;
template <> struct Scalar<float> { static constexpr int kDepth = 64; };
template <> struct Scalar<double> { static constexpr int kDepth = 128; };
constexpr int kMaxDepth = 128;  // the deepest stack of any scalar type
constexpr long long kMaxSteps = 1ll << 20;  // runaway guard per query
constexpr unsigned kDimMask = 3u, kSideHi = 4u, kPending = 8u;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kRowWidth = 31;  // scalars per packed query row
// form 2: lane groups per block, lanes per query, threads, and the queries
// of a block (its rows' slots), taken by its groups one after another
constexpr int kGroups = 32;
constexpr int kShareLanes = 8;
constexpr int kShareThreads = kShareLanes * kGroups;
constexpr int kBlockQueries = 128;  // the most; a launch's own is shared_grid's
// form 1: threads per block (four warps, each staging its own queries)
constexpr int kLaneThreads = 128;
constexpr int kLaneWarps = kLaneThreads / 32;
// states of a queue entry
constexpr int kEmpty = 0, kHeld = 1, kFull = 2;
// a pending sibling is handed to an idle group only from this many levels
// above the current domain: a deeper one is a small subtree, not worth a
// task's start
constexpr int kStealMin = 3;
// an idle group that has waited this many cycles (~35 s) for work gives up
// and flags overflow rather than hang the card; no correct run comes near
constexpr long long kStallCycles = 1ll << 36;

// form 1's query cursor: the next query a warp takes, reset before each
// launch on its stream (sccd_solve_packed)
__device__ unsigned long long g_cursor;

__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T sel3(const T (&a)[3], int d) {
  return d == 0 ? a[0] : (d == 1 ? a[1] : a[2]);
}

template <typename T>
__device__ __forceinline__ void set3(T (&a)[3], int d, T v) {
  a[0] = d == 0 ? v : a[0];
  a[1] = d == 1 ? v : a[1];
  a[2] = d == 2 ? v : a[2];
}

__device__ __forceinline__ void atomic_min_nonneg(float* addr, float v) {
  atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ void atomic_min_nonneg(double* addr, double v) {
  atomicMin(reinterpret_cast<long long*>(addr), __double_as_longlong(v));
}

// x * 2^e, exact
__device__ __forceinline__ float scale2(float x, int e) { return scalbnf(x, e); }
__device__ __forceinline__ double scale2(double x, int e) { return scalbn(x, e); }

template <typename T>
__device__ __forceinline__ T load_volatile(const T* addr) {
  return *reinterpret_cast<const volatile T*>(addr);
}

// 1 / tol per dimension, and whether w * (1 / tol) is w / tol bitwise for
// every width w of a domain.  Every width is a power of two 2^-k (a dyadic
// domain), so w / tol is 2^-k * (1 / tol) rounded once, and scaling by 2^-k
// commutes with the rounding while both values stay normal: w * rcp is the
// quotient bitwise.  Tolerances whose reciprocal lies outside [2^-64, 2^64]
// (0, inf, NaN, extreme values) keep the division.
template <typename T>
__device__ __forceinline__ bool reciprocals(T t0, T t1, T t2, T (&rcp)[3]) {
  const T t[3] = {t0, t1, t2};
  bool exact = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    rcp[d] = T(1) / t[d];
    exact = exact && rcp[d] >= T(5.421010862427522e-20) && rcp[d] <= T(1.8446744073709552e19);
  }
  return exact;
}

// Form 2's block rows, staged in shared memory as (31, kBlockQueries):
// field k of the query in slot s at v[k][s], so the eight lanes of a group
// read one word (a broadcast).  rcp[d][s] = 1 / tol_d and exact[s] are
// computed once per query (reciprocals).
template <typename T>
struct Rows {
  T v[kRowWidth][kBlockQueries];
  T rcp[3][kBlockQueries];
  int exact[kBlockQueries];
};

// Form 1's staged queries of one warp, the same layout; flags[s]: bit 0 the
// reciprocals are exact, bit 1 the row is valid.
template <typename T>
struct Stage {
  T v[kRowWidth][32];
  T rcp[3][32];
  int flags[32];
};

// Row sources.  Form 1: stage<IS_VF>(st, lane, q) writes the 31 fields of
// query q into slot `lane` of the warp's Stage and returns whether the row
// is valid.  Form 2: fill<IS_VF>(rows, q0, nq), which every thread of the
// block calls, writes queries q0 + [0, nq) into slots [0, nq) of the
// block's Rows, and valid(q) says whether query q is solved.
//
// The columns source: a column buffer (kernel C's, or a slice of one) and
// the caller's valid mask.
template <typename T>
struct ColumnRows {
  const T* cols;  // field k of query q at cols[k * ld + q]
  long long ld;
  const unsigned char* valid;
  template <bool IS_VF>
  __device__ __forceinline__ bool stage(Stage<T>& st, int lane, long long q) const {
    const T* src = cols + q;
#pragma unroll
    for (int k = 0; k < kRowWidth; ++k) st.v[k][lane] = src[(size_t)k * ld];
    return valid[q] != 0;
  }
  // coalesced: neighbouring threads copy neighbouring words of a column,
  // through the read-only path
  template <bool IS_VF>
  __device__ __forceinline__ void fill(Rows<T>& rows, long long q0, int nq) const {
    for (int i = threadIdx.x; i < kRowWidth * nq; i += kShareThreads) {
      const int k = i / nq, s = i % nq;
      rows.v[k][s] = __ldg(cols + (size_t)k * ld + q0 + s);
    }
  }
  __device__ __forceinline__ bool valid_row(long long q) const { return __ldg(valid + q) != 0; }
};

// pack_row's sink into slot `slot` of N staged rows (a Stage's or a
// block's Rows), widened to the rows' type T
template <typename T, int N>
struct SlotSink {
  T (&v)[kRowWidth][N];
  int slot;
  template <typename C>
  __device__ __forceinline__ void operator()(int k, C x) const {
    v[k][slot] = (T)x;
  }
};

// The pairs source: query q is the element-id pair pairs[start + q], its
// row computed here by kernel C's pack_row (csrc/pack_row.cuh) in the
// compute type C (float for the widened rows of T = double); every row is
// valid.  Form 2 computes a block's rows one thread a row.
template <typename T, typename C>
struct PairRows {
  const int2* pairs;
  long long start;
  PackTables<C> tables;
  template <bool IS_VF>
  __device__ __forceinline__ bool stage(Stage<T>& st, int lane, long long q) const {
    const int2 ab = __ldg(pairs + start + q);
    pack_row<C, IS_VF>(ab.x, ab.y, tables, SlotSink<T, 32>{st.v, lane});
    return true;
  }
  template <bool IS_VF>
  __device__ __forceinline__ void fill(Rows<T>& rows, long long q0, int nq) const {
    for (int s = threadIdx.x; s < nq; s += kShareThreads) {
      const int2 ab = __ldg(pairs + start + q0 + s);
      pack_row<C, IS_VF>(ab.x, ab.y, tables, SlotSink<T, kBlockQueries>{rows.v, s});
    }
  }
  __device__ __forceinline__ bool valid_row(long long) const { return true; }
};

// A query's 24 point coordinates, field 3k + d, read from the block's rows
// at every evaluation (form 2).  `slot` is made opaque to the compiler so
// that it does not hoist them into 24 registers for the whole search (fewer
// registers, more queries resident per SM).  Form 1 passes them as a
// register array.
template <typename T>
struct SharedPoints {
  const T* row;
  __device__ __forceinline__ T operator[](int i) const { return row[i * kBlockQueries]; }
};

template <typename T>
__device__ __forceinline__ SharedPoints<T> shared_points(const Rows<T>& rows, int slot) {
  asm volatile("" : "+r"(slot));
  return {&rows.v[0][slot]};
}

// min/max over the 8 corners of the box of F, per xyz dim: this lane's
// corners (bit 2: t, bit 1: u, bit 0: v) with the association of
// domain_corners (narrow_phase/types.py), then a butterfly over the group's
// LANES lanes; min and max are exact, so the order of the reduction is free.
template <typename T, bool IS_VF, int LANES, typename Points>
__device__ __forceinline__ void corners_minmax(const Points& pts, const T (&lo)[3],
                                               const T (&hi)[3], int corner,
                                               unsigned gmask, T (&cmin)[3],
                                               T (&cmax)[3]) {
  constexpr int kCorners = 8 / LANES;  // domain corners per lane
#pragma unroll
  for (int j = 0; j < kCorners; ++j) {
    const int c = corner * kCorners + j;
    const T t = (c & 4) ? hi[0] : lo[0];
    const T u = (c & 2) ? hi[1] : lo[1];
    const T v = (c & 1) ? hi[2] : lo[2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T p[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) p[k] = pts[3 * k + d];
      // p[k] is coordinate d of point k: v0..v3 at t=0 then at t=1
      const T q0 = (p[4] - p[0]) * t + p[0];
      const T q1 = (p[5] - p[1]) * t + p[1];
      const T q2 = (p[6] - p[2]) * t + p[2];
      const T q3 = (p[7] - p[3]) * t + p[3];
      T f;
      if (IS_VF) {
        const T a = q2 - q1;
        const T b = q3 - q1;
        f = q0 - a * u - b * v - q1;
      } else {
        const T a = q1 - q0;
        const T b = q3 - q2;
        f = (a * u + q0) - (b * v + q2);
      }
      cmin[d] = j == 0 ? f : tmin(cmin[d], f);
      cmax[d] = j == 0 ? f : tmax(cmax[d], f);
    }
  }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cmin[d] = tmin(cmin[d], __shfl_xor_sync(gmask, cmin[d], off));
      cmax[d] = tmax(cmax[d], __shfl_xor_sync(gmask, cmax[d], off));
    }
  }
}

// What an evaluation decides about the domain [lo, hi]: accept it, or
// split it (want) along `split` at `mid`; neither when it is pruned or
// misses.  The caller applies the depth and split caps.
template <typename T>
struct Verdict {
  bool accept, want;
  int split;
  T mid;
};

template <typename T>
__device__ __forceinline__ Verdict<T> judge(const T (&lo)[3], const T (&hi)[3],
                                            const T (&cmin)[3], const T (&cmax)[3],
                                            const T (&tol)[3], const T (&err)[3], T ms,
                                            const T (&rcp)[3], bool exact_rcp, T co_tol,
                                            bool allow_zero, bool pruned) {
  bool miss = false, box_in = true;
  T true_tol = T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    miss = miss || (cmin[d] - ms > err[d]) || (cmax[d] + ms < -err[d]);
    box_in = box_in && !((cmin[d] + ms < -err[d]) || (cmax[d] - ms > err[d]));
    true_tol = tmax(true_tol, cmax[d] - cmin[d]);
  }
  true_tol = tmax(true_tol, T(0));
  const T w0 = hi[0] - lo[0], w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
  const bool pos_ok = allow_zero || lo[0] > T(0);
  const bool cond1 = w0 <= tol[0] && w1 <= tol[1] && w2 <= tol[2];
  const bool cond2 = box_in && pos_ok;
  const bool cond3 = true_tol <= co_tol && pos_ok;
  // split dim: argmax of widths / tol, first index on ties
  T r0, r1, r2;
  if (exact_rcp) {
    r0 = w0 * rcp[0];
    r1 = w1 * rcp[1];
    r2 = w2 * rcp[2];
  } else {
    r0 = w0 / tol[0];
    r1 = w1 / tol[1];
    r2 = w2 / tol[2];
  }
  const bool d0 = r0 >= r1 && r0 >= r2;
  const bool d1 = !d0 && r1 >= r2;
  Verdict<T> v;
  v.split = d0 ? 0 : (d1 ? 1 : 2);
  const T s_lo = sel3(lo, v.split), s_hi = sel3(hi, v.split);
  v.mid = (s_lo + s_hi) * T(0.5);
  const bool degenerate = s_lo >= v.mid || v.mid >= s_hi;
  const bool live = !pruned && !miss;
  v.accept = live && (cond1 || cond2 || cond3 || degenerate);
  v.want = live && !v.accept;
  return v;
}

// Split [lo, hi] along `split` at `mid` and descend into child1 = [s_lo,
// mid]; its sibling [mid, s_hi] is kept pending unless it is culled (VF: a
// t-split sibling at or past the running TOI, or a u/v one past the u + v
// limit; EE: a t-split sibling at or past the TOI).
template <typename T, bool IS_VF, int kPathWords>
__device__ __forceinline__ void descend(unsigned (&path)[kPathWords], T (&lo)[3], T (&hi)[3],
                                        unsigned& dimcnt, int& sp, T& pend_min, int split,
                                        T mid, T bound, T uv_limit) {
  bool push2;
  if (IS_VF) {
    const T other = split == 1 ? lo[2] : lo[1];
    push2 = split == 0 ? mid <= bound : (mid + other) <= uv_limit;
  } else {
    push2 = split != 0 || mid <= bound;
  }
  const unsigned meta = (unsigned)split | kSideHi | (push2 ? kPending : 0u);
#pragma unroll
  for (int k = kPathWords - 1; k > 0; --k) path[k] = (path[k] << 4) | (path[k - 1] >> 28);
  path[0] = (path[0] << 4) | meta;
  dimcnt += 1u << (8 * split);
  if (push2) pend_min = tmin(pend_min, split == 0 ? mid : lo[0]);
  set3(hi, split, mid);
  ++sp;
}

// Unwind finished levels, at most `levels`, until a pending sibling is
// entered (cur becomes true) or the stack is empty.
template <typename T, int kPathWords>
__device__ __forceinline__ void unwind(unsigned (&path)[kPathWords], T (&lo)[3], T (&hi)[3],
                                       unsigned& dimcnt, int& sp, bool& cur, int levels) {
  for (int lv = 0; lv < levels && !cur && sp > 0; ++lv) {
    const unsigned m = path[0] & 15u;
    const int dim = (int)(m & kDimMask);
    const bool side_hi = (m & kSideHi) != 0u;
    const bool pending = (m & kPending) != 0u;
    const T old_hi = sel3(hi, dim), old_lo = sel3(lo, dim);
    if (side_hi) {
      set3(hi, dim, T(2) * old_hi - old_lo);
    } else {
      set3(lo, dim, T(2) * old_lo - old_hi);
    }
    if (pending && side_hi) {
      set3(lo, dim, old_hi);  // the sibling [mid, H]
      path[0] = (path[0] & ~15u) | (unsigned)dim;
      cur = true;
    } else {
#pragma unroll
      for (int k = 0; k < kPathWords - 1; ++k) path[k] = (path[k] >> 4) | (path[k + 1] << 28);
      path[kPathWords - 1] >>= 4;
      dimcnt -= 1u << (8 * dim);
      --sp;
    }
  }
}

// A domain waiting in a block's queue: its bounds, its query's slot in the
// block and absolute depth (slot | depth << 8), its split counters.
template <typename T>
struct Task {
  T lo[3], hi[3];
  unsigned slot_depth, dimcnt;
};

template <typename T>
struct BlockQueue {
  Task<T> task[kGroups];
  int state[kGroups];       // kEmpty, kHeld (being written or read) or kFull
  T tpq[kBlockQueries];     // per-query mode: each query's running TOI
  int qcnt[kBlockQueries];  // each query's evaluations, added as tasks end
  int next;                 // the block's next query slot to take
  int work;    // busy groups, groups taking a query, queued tasks; 0 ends the block
  int hungry;  // groups left without a query of their own, idle, less queued tasks
};

// Lane 0 of a group that holds a pending sibling: queue the domain [lo, hi]
// if some idle group still waits for one.  Returns the entry or -1.
template <typename T>
__device__ __forceinline__ int hand_off(BlockQueue<T>& sh, const T (&lo)[3],
                                        const T (&hi)[3], unsigned slot_depth,
                                        unsigned dimcnt) {
  if (atomicSub(&sh.hungry, 1) <= 0) {
    atomicAdd(&sh.hungry, 1);
    return -1;
  }
  for (int i = 0; i < kGroups; ++i) {
    if (load_volatile(&sh.state[i]) != kEmpty ||
        atomicCAS(&sh.state[i], kEmpty, kHeld) != kEmpty)
      continue;
    Task<T>& t = sh.task[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t.lo[d] = lo[d];
      t.hi[d] = hi[d];
    }
    t.slot_depth = slot_depth;
    t.dimcnt = dimcnt;
    atomicAdd(&sh.work, 1);  // before the task can be taken and finished
    __threadfence_block();
    atomicExch(&sh.state[i], kFull);
    return i;
  }
  atomicAdd(&sh.hungry, 1);
  return -1;
}

// Lane 0 of an idle group: take a queued task; its index, or -1.
template <typename T>
__device__ __forceinline__ int take(BlockQueue<T>& sh) {
  for (int i = 0; i < kGroups; ++i) {
    if (load_volatile(&sh.state[i]) == kFull &&
        atomicCAS(&sh.state[i], kFull, kHeld) == kFull) {
      __threadfence_block();
      return i;
    }
  }
  return -1;
}

// Form 2: the unbounded global and per-query modes, its rows from `src` (a
// row source above).
template <typename T, bool IS_VF, bool PER_QUERY, typename Source = ColumnRows<T>>
__global__ void __launch_bounds__(kShareThreads)
    solve_kernel(Source src, const T* __restrict__ skip_seed, int Q, int bq, T co_tol,
                 T uv_limit, unsigned dim_cap, bool allow_zero, long long max_steps, T* toi,
                 T* __restrict__ pq_out, unsigned long long* __restrict__ checks_out,
                 int* __restrict__ ovf_out, long long* __restrict__ qchecks_out) {
  constexpr int kDepth = Scalar<T>::kDepth;
  constexpr int kPathWords = kDepth / 8;
  const T inf = (T)INFINITY;
  const int corner = threadIdx.x & (kShareLanes - 1);
  const int leader = (threadIdx.x & 31) & ~(kShareLanes - 1);  // lane 0's lane
  const unsigned gmask = 0xFFu << leader;
  const bool head = corner == 0;
  // the block's queries: bq (at most kBlockQueries) from q0, nq of them
  const long long q0 = (long long)blockIdx.x * bq;
  const int nq = (int)((long long)Q - q0 < bq ? (long long)Q - q0 : bq);
  // the loop's exit on the card: a launch made where the caller's loop
  // would have stopped (its seed, the running TOI, already 0) does nothing
  if (skip_seed != nullptr && *skip_seed <= T(0)) return;

  __shared__ Rows<T> rows;
  __shared__ BlockQueue<T> sh;
  src.template fill<IS_VF>(rows, q0, nq);
  __syncthreads();
  for (int s = threadIdx.x; s < nq; s += kShareThreads) {
    T r[3];
    rows.exact[s] = reciprocals(rows.v[24][s], rows.v[25][s], rows.v[26][s], r);
#pragma unroll
    for (int d = 0; d < 3; ++d) rows.rcp[d][s] = r[d];
    sh.tpq[s] = inf;
    sh.qcnt[s] = 0;
  }
  if (threadIdx.x < kGroups) sh.state[threadIdx.x] = kEmpty;
  if (threadIdx.x == 0) {
    sh.next = 0;
    sh.work = 0;
    sh.hungry = 0;
  }
  __syncthreads();

  unsigned long long checks = 0;  // this group's evaluations
  int ovf = 0;

  // the current task: a domain of query `slot`, its absolute depth and
  // split counters; a query of the group's own starts at the unit cube
  int slot = 0;
  bool busy = false;
  bool drained = false;  // the block's queries are all taken
  T lo[3], hi[3];
  int base = 0;
  unsigned dimcnt = 0u;  // 8-bit split counters: dims 0/1/2 at bits 0/8/16
  long long idle_since = -1;

  while (true) {
    if (!busy && !drained) {
      // the block's next valid query; `work` counts the group first, so
      // that no group sees 0 while a query is being taken
      int got = -1;
      if (head) {
        atomicAdd(&sh.work, 1);
        int s = atomicAdd(&sh.next, 1);
        while (s < nq && !src.valid_row(q0 + s)) s = atomicAdd(&sh.next, 1);
        if (s < nq) {
          got = s;
        } else {
          atomicSub(&sh.work, 1);
          atomicAdd(&sh.hungry, 1);  // from now on it waits for shared work
        }
      }
      got = __shfl_sync(gmask, got, leader);
      if (got >= 0) {
        slot = got;
        base = 0;
        dimcnt = 0u;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[d] = T(0);
          hi[d] = T(1);
        }
        busy = true;
      } else {
        drained = true;
      }
    }
    if (!busy) {
      int got = head ? take(sh) : -1;
      got = __shfl_sync(gmask, got, leader);
      if (got < 0) {
        int work = head ? load_volatile(&sh.work) : 0;
        work = __shfl_sync(gmask, work, leader);
        if (work == 0) break;
        const long long now = clock64();
        if (idle_since < 0) idle_since = now;
        if (now - idle_since > kStallCycles) {
          ovf = 1;  // never in a correct run: flag it rather than hang
          break;
        }
        if (head) __nanosleep(128);
        __syncwarp(gmask);
        continue;
      }
      idle_since = -1;
      __syncwarp(gmask);  // the head's acquire orders the lanes' reads
      const Task<T>& t = sh.task[got];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = t.lo[d];
        hi[d] = t.hi[d];
      }
      slot = (int)(t.slot_depth & 255u);
      base = (int)(t.slot_depth >> 8);
      dimcnt = t.dimcnt;
      __syncwarp(gmask);
      if (head) {
        __threadfence_block();
        atomicExch(&sh.state[got], kEmpty);
      }
      busy = true;
    }

    const T tol[3] = {rows.v[24][slot], rows.v[25][slot], rows.v[26][slot]};
    const T err[3] = {rows.v[27][slot], rows.v[28][slot], rows.v[29][slot]};
    const T ms = rows.v[30][slot];
    const T rcp[3] = {rows.rcp[0][slot], rows.rcp[1][slot], rows.rcp[2][slot]};
    const bool exact_rcp = rows.exact[slot] != 0;

    // The running TOI this search prunes against, read one evaluation
    // ahead by lane 0 so that the read's latency hides behind an
    // evaluation.  It only ever decreases, and `own` (this task's own
    // accepts) covers what the early read may miss: a read made earlier
    // prunes less, never differently where nothing else lowers the TOI.
    T own = inf;
    T next_bound = inf;
    int next_hungry = 0;
    int qbase = 0;  // the query's evaluations counted before this task
    if (head) {
      next_bound = PER_QUERY ? load_volatile(&sh.tpq[slot]) : load_volatile(toi);
      next_hungry = load_volatile(&sh.hungry);
      qbase = load_volatile(&sh.qcnt[slot]);
    }
    qbase = __shfl_sync(gmask, qbase, leader);

    unsigned path[kPathWords];
#pragma unroll
    for (int k = 0; k < kPathWords; ++k) path[k] = 0u;
    int sp = 0;        // levels on this task's stack
    bool cur = true;   // the current domain is still to be evaluated
    T pend_min = inf;  // lower bound of every pending sibling kept here
    int task_checks = 0;

    while (cur || sp > 0) {
      if (cur) {
        if (qbase + task_checks >= max_steps) break;  // guard
        const T b = next_bound;
        const int h = next_hungry;
        if (head) {
          next_bound = PER_QUERY ? load_volatile(&sh.tpq[slot]) : load_volatile(toi);
          next_hungry = load_volatile(&sh.hungry);
        }
        const T bound = tmin(__shfl_sync(gmask, b, leader), own);
        const int hungry = __shfl_sync(gmask, h, leader);
        const T min_t = lo[0];
        ++checks;
        ++task_checks;
        T cmin[3], cmax[3];
        corners_minmax<T, IS_VF, kShareLanes>(shared_points(rows, slot), lo, hi, corner,
                                              gmask, cmin, cmax);
        const Verdict<T> v = judge(lo, hi, cmin, cmax, tol, err, ms, rcp, exact_rcp, co_tol,
                                   allow_zero, min_t >= bound);
        const unsigned cnt_d = (dimcnt >> (8 * v.split)) & 255u;
        const bool full = base + sp >= kDepth || cnt_d >= dim_cap;
        bool accept = v.accept;
        if (v.want && full) {
          ovf = 1;
          accept = true;  // conservative accept
        }
        if (accept) {
          own = tmin(own, min_t);
          if (head) atomic_min_nonneg(PER_QUERY ? &sh.tpq[slot] : toi, min_t);
        }
        if (v.want && !full) {
          descend<T, IS_VF>(path, lo, hi, dimcnt, sp, pend_min, v.split, v.mid, bound,
                            uv_limit);
          if (hungry > 0) {
            // an idle group waits: give it the shallowest pending sibling
            // on this stack, the largest subtree left here
            int pick = -1;
#pragma unroll
            for (int k = 0; k < kPathWords; ++k) {
              const unsigned m = path[k] & 0x88888888u;
              if (m) pick = k * 8 + ((31 - __clz(m)) >> 2);
            }
            if (pick >= kStealMin) {
              // split counts at the level of the pick's child1: the current
              // ones less the splits stacked above it (positions < pick)
              int c[3] = {(int)(dimcnt & 255u), (int)((dimcnt >> 8) & 255u),
                          (int)((dimcnt >> 16) & 255u)};
              unsigned nib = 0u;
#pragma unroll
              for (int k = 0; k < kPathWords; ++k) {
                const int n = pick - k * 8;  // nibbles of word k above the pick
                const unsigned sel =
                    n >= 8 ? 0x11111111u
                           : (n <= 0 ? 0u : 0x11111111u & ((1u << (4 * n)) - 1u));
                const unsigned b0 = path[k] & sel, b1 = (path[k] >> 1) & sel;
                c[0] -= __popc(sel & ~b0 & ~b1);
                c[1] -= __popc(b0 & ~b1);
                c[2] -= __popc(b1 & ~b0);
                if (k == (pick >> 3)) nib = (path[k] >> (4 * (pick & 7))) & 15u;
              }
              // child1 is the aligned dyadic interval of width 2^-c holding
              // the current domain; the sibling is the next one along the
              // pick's dimension
              T s_lo2[3], s_hi2[3];
              const int e = (int)(nib & kDimMask);
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                const T w = scale2(T(1), -c[d]);
                T l = floor(scale2(lo[d], c[d])) * w;
                if (d == e) l = l + w;
                s_lo2[d] = l;
                s_hi2[d] = l + w;
              }
              int got = -1;
              if (head)
                got = hand_off(sh, s_lo2, s_hi2,
                               (unsigned)slot | ((unsigned)(base + sp - pick) << 8),
                               (unsigned)c[0] | ((unsigned)c[1] << 8) |
                                   ((unsigned)c[2] << 16));
              if (__shfl_sync(gmask, got, leader) >= 0) {
#pragma unroll
                for (int k = 0; k < kPathWords; ++k)
                  if (k == (pick >> 3)) path[k] &= ~(kPending << (4 * (pick & 7)));
              }
            }
          }
          continue;
        }
        cur = false;
      }
      // unwind finished levels until a pending sibling is entered
      unwind(path, lo, hi, dimcnt, sp, cur, kDepth + 1);
    }
    if (cur || sp > 0) {
      // runaway guard: accept the earliest unexplored time conservatively
      const T left = cur ? tmin(lo[0], pend_min) : pend_min;
      if (head) atomic_min_nonneg(PER_QUERY ? &sh.tpq[slot] : toi, left);
      ovf = 1;
    }
    if (head) {
      atomicAdd(&sh.qcnt[slot], task_checks);
      atomicSub(&sh.work, 1);
      if (drained) atomicAdd(&sh.hungry, 1);
    }
    busy = false;
  }

  __syncthreads();
  for (int s = threadIdx.x; s < nq; s += kShareThreads) {
    if (PER_QUERY) {
      const T t = sh.tpq[s];
      pq_out[q0 + s] = t;
      if (t < inf) atomic_min_nonneg(toi, t);
    }
    if (qchecks_out != nullptr) qchecks_out[q0 + s] = (long long)sh.qcnt[s];
  }
  if (!head) checks = 0;  // every lane of a group counted the same
  // one atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    checks += __shfl_down_sync(kFullMask, checks, off);
    ovf |= __shfl_down_sync(kFullMask, ovf, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (checks) atomicAdd(checks_out, checks);
    if (ovf) atomicOr(ovf_out, 1);
  }
}

// Form 1: the bounded and round-limited modes, one lane per query on a
// persistent grid (the design note above), its rows from `src` (a row
// source above).  `cursor` is zero at launch.
template <typename T, bool IS_VF, bool PER_QUERY, typename Source>
__global__ void __launch_bounds__(kLaneThreads)
    solve_lane_kernel(Source src, const T* __restrict__ skip_seed, int Q, T co_tol,
                      T uv_limit, unsigned dim_cap, bool allow_zero,
                      long long max_iterations, long long round_limit,
                      long long max_steps, T* toi, T* __restrict__ pq_out,
                      unsigned char* __restrict__ unfin_out,
                      unsigned long long* __restrict__ checks_out,
                      int* __restrict__ ovf_out, long long* __restrict__ qchecks_out,
                      unsigned long long* cursor) {
  constexpr int kDepth = Scalar<T>::kDepth;
  constexpr int kPathWords = kDepth / 8;
  const T inf = (T)INFINITY;
  // the loop's exit on the card, read once (form 2's note)
  if (skip_seed != nullptr && *skip_seed <= T(0)) return;
  __shared__ Stage<T> stages[kLaneWarps];
  Stage<T>& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  // unwind levels per round: two in round_limit mode, else all of them
  const int levels = round_limit >= 0 ? 2 : kDepth + 1;

  // the warp's staged queries, sbase + [0, staged), handed out from `next`
  // (the same in every lane)
  long long sbase = 0;
  int staged = 0, next = 0;
  bool drained = false;  // the cursor has passed Q

  unsigned long long checks = 0;  // this lane's evaluations, every query
  int ovf = 0;
  T own = inf;  // global modes: the earliest time this lane accepted

  // this lane's query: its index, row (in registers) and search state
  bool busy = false;
  long long q = 0;
  T pts[24], tol[3], err[3], rcp[3];
  T ms = T(0);
  bool exact_rcp = true;
  T lo[3], hi[3];
  unsigned path[kPathWords];
  int sp = 0;
  bool cur = false;   // the current domain is still to be evaluated
  T pend_min = inf;   // lower bound of every pending sibling
  T tpq = inf;        // per_query: this query's running TOI
  T next_bound = inf; // global modes: the running TOI, read one round ahead
  unsigned dimcnt = 0u;  // 8-bit split counters: dims 0/1/2 at bits 0/8/16
  long long rounds = 0, qchecks = 0;

  while (true) {
    // idle lanes take staged queries, in lane order; an invalid row writes
    // its outputs and leaves its lane idle
    unsigned idle = __ballot_sync(kFullMask, !busy);
    while (idle != 0u && !drained) {
      if (next == staged) {
        unsigned long long b = 0;
        if (lane == 0) b = atomicAdd(cursor, 32ull);
        b = __shfl_sync(kFullMask, b, 0);
        if (b >= (unsigned long long)Q) {
          drained = true;
          break;
        }
        __syncwarp();  // every lane has read its row of the last stage
        sbase = (long long)b;
        staged = min(32, Q - (int)b);
        next = 0;
        if (lane < staged) {
          const bool ok = src.template stage<IS_VF>(st, lane, sbase + lane);
          T r[3];
          const bool exact = reciprocals(st.v[24][lane], st.v[25][lane], st.v[26][lane], r);
#pragma unroll
          for (int d = 0; d < 3; ++d) st.rcp[d][lane] = r[d];
          st.flags[lane] = (exact ? 1 : 0) | (ok ? 2 : 0);
        }
        __syncwarp();
      }
      const int n_take = min(__popc(idle), staged - next);
      const int r = __popc(idle & below);
      if (!busy && r < n_take) {
        const int s = next + r;
        q = sbase + s;
        const int flags = st.flags[s];
        if (flags & 2) {
#pragma unroll
          for (int k = 0; k < 24; ++k) pts[k] = st.v[k][s];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            tol[d] = st.v[24 + d][s];
            err[d] = st.v[27 + d][s];
            rcp[d] = st.rcp[d][s];
            lo[d] = T(0);
            hi[d] = T(1);
          }
          ms = st.v[30][s];
          exact_rcp = (flags & 1) != 0;
#pragma unroll
          for (int k = 0; k < kPathWords; ++k) path[k] = 0u;
          sp = 0;
          cur = true;
          pend_min = inf;
          tpq = inf;
          dimcnt = 0u;
          rounds = 0;
          qchecks = 0;
          if (!PER_QUERY) next_bound = load_volatile(toi);
          busy = true;
        } else {
          if (PER_QUERY) pq_out[q] = inf;
          if (unfin_out != nullptr) unfin_out[q] = 0;
          if (qchecks_out != nullptr) qchecks_out[q] = 0;
        }
      }
      next += n_take;
      idle = __ballot_sync(kFullMask, !busy);
    }
    if (idle == kFullMask) break;  // drained, and every query done

    if (busy) {
      // one round of this lane's search (the bounded and round-limited
      // loop of form 2's search, without sharing)
      if ((cur || sp > 0) && qchecks < max_steps &&
          (round_limit < 0 || rounds < round_limit)) {
        ++rounds;
        bool pushed = false;
        if (cur) {
          T bound;
          if (PER_QUERY) {
            bound = tpq;
          } else {
            bound = tmin(next_bound, own);
            next_bound = load_volatile(toi);
          }
          const T min_t = lo[0];
          // bounded: the pre-increment count is compared, and a domain past
          // the cap is dropped, not accepted
          const bool pruned =
              min_t >= bound || (max_iterations >= 0 && qchecks > max_iterations);
          ++checks;
          ++qchecks;
          T cmin[3], cmax[3];
          corners_minmax<T, IS_VF, 1>(pts, lo, hi, 0, kFullMask, cmin, cmax);
          const Verdict<T> v = judge(lo, hi, cmin, cmax, tol, err, ms, rcp, exact_rcp,
                                     co_tol, allow_zero, pruned);
          const unsigned cnt_d = (dimcnt >> (8 * v.split)) & 255u;
          const bool full = sp >= kDepth || cnt_d >= dim_cap;
          bool accept = v.accept;
          if (v.want && full) {
            ovf = 1;
            accept = true;  // conservative accept
          }
          if (accept) {
            if (PER_QUERY) {
              tpq = tmin(tpq, min_t);
            } else {
              own = tmin(own, min_t);
              atomic_min_nonneg(toi, min_t);
            }
          }
          if (v.want && !full) {
            descend<T, IS_VF>(path, lo, hi, dimcnt, sp, pend_min, v.split, v.mid, bound,
                              uv_limit);
            pushed = true;
          } else {
            cur = false;
          }
        }
        if (!pushed) unwind(path, lo, hi, dimcnt, sp, cur, levels);
      }
      if (!((cur || sp > 0) && qchecks < max_steps &&
            (round_limit < 0 || rounds < round_limit))) {
        // the query ends: done, out of rounds, or stopped by the guard
        unsigned char unfin = 0;
        if ((cur || sp > 0) && round_limit >= 0) {
          unfin = 1;  // out of rounds: left to the caller's re-solve
        } else if (cur || sp > 0) {
          // runaway guard: accept the earliest unexplored time conservatively
          const T left = cur ? tmin(lo[0], pend_min) : pend_min;
          if (PER_QUERY) {
            tpq = tmin(tpq, left);
          } else {
            atomic_min_nonneg(toi, left);
          }
          ovf = 1;
        }
        if (PER_QUERY) {
          pq_out[q] = tpq;
          if (tpq < inf) atomic_min_nonneg(toi, tpq);
        }
        if (unfin_out != nullptr) unfin_out[q] = unfin;
        if (qchecks_out != nullptr) qchecks_out[q] = qchecks;
        busy = false;
      }
    }
  }

  // one atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    checks += __shfl_down_sync(kFullMask, checks, off);
    ovf |= __shfl_down_sync(kFullMask, ovf, off);
  }
  if (lane == 0) {
    if (checks) atomicAdd(checks_out, checks);
    if (ovf) atomicOr(ovf_out, 1);
  }
}

// The arguments of one launch, as the C entry point takes them.
struct Args {
  cudaStream_t stream;
  const void* cols;
  long long ld;
  const void* skip_seed;
  const void* valid;
  int Q;
  double co_tol, uv_limit;
  int dim_cap, allow_zero;
  long long max_iterations, round_limit, max_steps;
  void *toi, *pq, *unfin, *checks, *ovf, *qchecks;
};

// form 2's queries per block for Q queries: the most of kBlockQueries, half
// and a quarter of it whose blocks fill every SM's resident slots, else
// kGroups (one query per lane group)
template <typename T, bool IS_VF, bool PER_QUERY, typename Source = ColumnRows<T>>
int shared_grid(int Q, int* per_sm_out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, solve_kernel<T, IS_VF, PER_QUERY, Source>, kShareThreads, 0);
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  const long long full = (long long)sms * per_sm;
  int bq = kBlockQueries;
  while (bq > kGroups && ((long long)Q + bq - 1) / bq < full) bq /= 2;
  return bq;
}

template <typename T, bool IS_VF, bool PER_QUERY, typename Source>
int launch_shared(const Args& a, const Source& src) {
  const int bq = shared_grid<T, IS_VF, PER_QUERY, Source>(a.Q, nullptr);
  // in 64 bits: a launch may take up to 2^31 - 1 rows
  const unsigned blocks = (unsigned)(((long long)a.Q + bq - 1) / bq);
  solve_kernel<T, IS_VF, PER_QUERY, Source><<<blocks, kShareThreads, 0, a.stream>>>(
      src, (const T*)a.skip_seed, a.Q, bq, (T)a.co_tol, (T)a.uv_limit, (unsigned)a.dim_cap,
      a.allow_zero != 0, a.max_steps, (T*)a.toi, (T*)a.pq, (unsigned long long*)a.checks,
      (int*)a.ovf, (long long*)a.qchecks);
  return (int)cudaGetLastError();
}

// form 1's blocks for Q queries: as many as stay resident on the device, and
// no more than give every warp 32 queries; 0 if none fits
template <typename T, bool IS_VF, bool PER_QUERY, typename Source = ColumnRows<T>>
int lane_grid(int Q, int* per_sm_out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, solve_lane_kernel<T, IS_VF, PER_QUERY, Source>, kLaneThreads, 0);
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  const long long full = (long long)sms * per_sm;
  const long long need = ((long long)Q + kLaneThreads - 1) / kLaneThreads;
  return (int)(need < full ? need : full);
}

template <typename T, bool IS_VF, bool PER_QUERY, typename Source>
int launch_lanes(const Args& a, const Source& src) {
  const int blocks = lane_grid<T, IS_VF, PER_QUERY, Source>(a.Q, nullptr);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  void* cursor = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&cursor, g_cursor);
  if (err == cudaSuccess) err = cudaMemsetAsync(cursor, 0, sizeof(g_cursor), a.stream);
  if (err != cudaSuccess) return (int)err;
  solve_lane_kernel<T, IS_VF, PER_QUERY, Source><<<blocks, kLaneThreads, 0, a.stream>>>(
      src, (const T*)a.skip_seed, a.Q,
      (T)a.co_tol, (T)a.uv_limit, (unsigned)a.dim_cap, a.allow_zero != 0, a.max_iterations,
      a.round_limit, a.max_steps, (T*)a.toi, (T*)a.pq, (unsigned char*)a.unfin,
      (unsigned long long*)a.checks, (int*)a.ovf, (long long*)a.qchecks,
      (unsigned long long*)cursor);
  return (int)cudaGetLastError();
}

template <typename T, bool IS_VF, bool PER_QUERY>
int launch_form(int share, const Args& a) {
  const ColumnRows<T> src{(const T*)a.cols, a.ld, (const unsigned char*)a.valid};
  if (share) return launch_shared<T, IS_VF, PER_QUERY>(a, src);
  return launch_lanes<T, IS_VF, PER_QUERY>(a, src);
}

template <typename T>
int launch_mode(int is_vf, int per_query, int share, const Args& a) {
  if (is_vf)
    return per_query ? launch_form<T, true, true>(share, a) : launch_form<T, true, false>(share, a);
  return per_query ? launch_form<T, false, true>(share, a) : launch_form<T, false, false>(share, a);
}

// the pairs source's launch: rows of type T computed in type C, global
// mode, the form from the mode (share: unbounded)
template <typename T, typename C>
int launch_pairs(int is_vf, int share, const Args& a, const void* pairs, long long start,
                 const PackTables<C>& tables) {
  const PairRows<T, C> src{(const int2*)pairs, start, tables};
  if (share)
    return is_vf ? launch_shared<T, true, false>(a, src) : launch_shared<T, false, false>(a, src);
  return is_vf ? launch_lanes<T, true, false>(a, src) : launch_lanes<T, false, false>(a, src);
}

// the runaway guard of a launch (the design note): kMaxSteps, raised past a
// cap's last evaluation and past a round limit
long long guard_steps(long long max_iterations, long long round_limit) {
  long long max_steps = kMaxSteps;
  if (max_iterations >= 0 && max_iterations + 2 * kMaxDepth + 2 > max_steps)
    max_steps = max_iterations + 2 * kMaxDepth + 2;
  if (round_limit >= 0 && round_limit + 1 > max_steps)
    max_steps = round_limit + 1;
  return max_steps;
}

}  // namespace

// cols: field k of query q at cols[k * ld + q], ld >= Q (a slice of a wider
// column buffer needs no copy).  skip_seed, null unless the caller asks
// for the loop's exit: the running TOI before this launch (not `toi`, which
// the launch lowers); when it is <= 0 every block returns before its first
// evaluation, and the outputs keep what the caller put there.
// is_f64: cols, toi, skip_seed and per_query_toi are double, else float.
// dim_cap: the most splits of one dimension (1..255).  uv_limit: the VF
// cull limit on u + v (exact in the scalar type).  per_query: nonzero
// selects per-query mode, which writes `per_query_toi` (Q scalars);
// max_iterations < 0 means unbounded; round_limit >= 0 (global mode only,
// no cap) writes `unfin` (Q bytes).  query_checks, null on every call of the main path,
// receives each query's evaluation count (Q long longs, 0 for invalid rows).
// The unbounded modes share domains inside a block (form 2 above); the
// bounded and round-limited ones keep each query's order (form 1), whose
// launch is preceded by a reset of its query cursor on `stream`: one cursor
// per device, so launches of form 1 run one at a time per device (the port
// launches on PyTorch's current stream).
extern "C" int sccd_solve_packed(const void* cols, long long ld,
                                 const void* skip_seed, const void* valid, int Q,
                                 int is_vf, int allow_zero_toi, int per_query,
                                 int is_f64, int dim_cap,
                                 long long max_iterations,
                                 long long round_limit, double co_tol,
                                 double uv_limit, void* toi,
                                 void* per_query_toi, void* unfin,
                                 void* checks, void* overflow,
                                 void* query_checks, void* stream) {
  if (round_limit >= 0 && (per_query || max_iterations >= 0 || !unfin))
    return (int)cudaErrorInvalidValue;
  if (dim_cap < 1 || dim_cap > 255 || ld < Q) return (int)cudaErrorInvalidValue;
  const int share = max_iterations < 0 && round_limit < 0;
  const Args a{(cudaStream_t)stream, cols, ld, skip_seed, valid, Q, co_tol, uv_limit,
               dim_cap, allow_zero_toi, max_iterations, round_limit,
               guard_steps(max_iterations, round_limit), toi, per_query_toi, unfin, checks,
               overflow, query_checks};
  return is_f64 ? launch_mode<double>(is_vf, per_query, share, a)
                : launch_mode<float>(is_vf, per_query, share, a);
}

// The pairs source (global mode): query q is the element-id pair
// pairs[start + q], q < Q, its row computed in the kernel as kernel C
// computes it (csrc/gather_pack.cu's sccd_gather_pack takes the same pairs,
// tables, kind, ms, co_tol and k_eps), so that no column buffer exists and
// one launch can solve a whole broad chunk or phase.  Bounded
// (max_iterations >= 0) in form 1, unbounded (max_iterations < 0) in form
// 2.  pairs: int32 (N, 2), 8-byte aligned; vcat (nv, 6) and table ((nt,
// 18) faces when is_vf, (nt, 12) edges) in the compute type, 16-byte
// aligned.  kind: 0 float rows, 1 double rows, 2 widened rows (float
// compute, double rows and TOI, f32's split cap in dim_cap).  co_tol is the
// co-domain tolerance in the compute type, for the rows and the solve
// alike.  The rest as for sccd_solve_packed; every row is valid.
extern "C" int sccd_solve_pairs(const void* pairs, long long start, int Q, const void* vcat,
                                int nv, const void* table, int nt, int is_vf, int kind,
                                double ms, double co_tol, double k_eps,
                                const void* skip_seed, int allow_zero_toi, int dim_cap,
                                long long max_iterations, double uv_limit, void* toi,
                                void* checks, void* overflow, void* query_checks,
                                void* stream) {
  if (Q < 0 || start < 0 || kind < 0 || kind > 2 || nv < 1 || nt < 1 || dim_cap < 1 ||
      dim_cap > 255)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int share = max_iterations < 0;
  const Args a{(cudaStream_t)stream, nullptr, 0, skip_seed, nullptr, Q, co_tol, uv_limit,
               dim_cap, allow_zero_toi, max_iterations, -1, guard_steps(max_iterations, -1),
               toi, nullptr, nullptr, checks, overflow, query_checks};
  if (kind == 0) {
    const PackTables<float> t{(const float*)vcat, nv, (const float*)table, nt, (float)ms,
                              (float)co_tol, (float)k_eps};
    return launch_pairs<float, float>(is_vf, share, a, pairs, start, t);
  }
  if (kind == 1) {
    const PackTables<double> t{(const double*)vcat, nv, (const double*)table, nt, ms, co_tol,
                               k_eps};
    return launch_pairs<double, double>(is_vf, share, a, pairs, start, t);
  }
  const PackTables<float> t{(const float*)vcat, nv, (const float*)table, nt, (float)ms,
                            (float)co_tol, (float)k_eps};
  return launch_pairs<double, float>(is_vf, share, a, pairs, start, t);
}

// The grid form 1 takes for Q queries (for reports): its 128-thread blocks,
// and the blocks the occupancy calculator keeps resident per SM.
extern "C" int sccd_solver_lane_grid(int is_vf, int per_query, int is_f64, int Q,
                                     int* blocks, int* per_sm) {
  if (is_f64) {
    *blocks = is_vf ? (per_query ? lane_grid<double, true, true>(Q, per_sm)
                                 : lane_grid<double, true, false>(Q, per_sm))
                    : (per_query ? lane_grid<double, false, true>(Q, per_sm)
                                 : lane_grid<double, false, false>(Q, per_sm));
  } else {
    *blocks = is_vf ? (per_query ? lane_grid<float, true, true>(Q, per_sm)
                                 : lane_grid<float, true, false>(Q, per_sm))
                    : (per_query ? lane_grid<float, false, true>(Q, per_sm)
                                 : lane_grid<float, false, false>(Q, per_sm));
  }
  return (int)cudaGetLastError();
}

// The queries per block form 2 takes for Q queries (for reports and tests),
// and the blocks the occupancy calculator keeps resident per SM.
extern "C" int sccd_solver_share_grid(int is_vf, int per_query, int is_f64, int Q,
                                      int* block_queries, int* per_sm) {
  if (is_f64) {
    *block_queries = is_vf ? (per_query ? shared_grid<double, true, true>(Q, per_sm)
                                        : shared_grid<double, true, false>(Q, per_sm))
                           : (per_query ? shared_grid<double, false, true>(Q, per_sm)
                                        : shared_grid<double, false, false>(Q, per_sm));
  } else {
    *block_queries = is_vf ? (per_query ? shared_grid<float, true, true>(Q, per_sm)
                                        : shared_grid<float, true, false>(Q, per_sm))
                           : (per_query ? shared_grid<float, false, true>(Q, per_sm)
                                        : shared_grid<float, false, false>(Q, per_sm));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_solver_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
