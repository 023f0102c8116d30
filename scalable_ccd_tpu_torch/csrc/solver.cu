// Kernel B: tight-inclusion root finder; in the unbounded modes eight lanes
// per query and domains shared inside a block, elsewhere one thread per
// query.
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
// Design: a block holds 32 queries, their rows staged in shared memory; the
// host picks the form from the mode (template SHARE):
//
// 1. Bounded and round-limited modes: one thread per query, as the
//    reference's kernel, in 32-thread blocks.  Their results (the unfin
//    plane, the checks, a capped TOI) are defined by each query's
//    depth-first order, so nothing may change it; and they are throughput
//    passes over full batches of mostly shallow queries.  Eight lanes per
//    query measured 10-40% slower there (the lanes split only the corners,
//    and an evaluation's chain is its decisions, stack and unwind).
// 2. Unbounded global and per-query modes: domains shared inside a block,
//    eight lanes per query.  Their TOIs do not depend on the order (accept,
//    reject and the caps are decisions of the domain alone, and pruning
//    drops only domains at or after an accepted time), and their time is
//    that of the deepest query.
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
//      idle, a group that splits hands it the shallowest pending sibling on
//      its stack (the largest subtree it holds, at least kStealMin levels
//      up; its bounds follow from the current domain and the split counts at
//      its level, since every domain is an aligned dyadic box) and clears
//      that level's pending bit.  An idle group takes a domain and runs a
//      fresh search rooted there, whose stack holds kDepth - depth levels,
//      so the depth and split caps stay absolute.  A block ends when the
//      queue is empty and no group is busy (one counter holds both, so the
//      test is one read).  In per-query mode each query's running TOI lives
//      in shared memory, lowered with a shared-memory atomicMin, since
//      several groups may hold its domains.  Nothing in the search loop
//      waits on another group: the queue takes shared-memory atomics, and an
//      idle group polls with __nanosleep.  A deep query then takes the
//      block's 32 groups instead of one.
// In both forms the split choice's w / tol is w * (1 / tol), exact because
// every width is a power of two (below).
//
// Modes (template PER_QUERY and SHARE, runtime max_iterations and
// round_limit; allow_zero_toi is a runtime flag too):
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

namespace {

// stack levels (4-bit nibbles, eight per 32-bit word)
template <typename T> struct Scalar;
template <> struct Scalar<float> { static constexpr int kDepth = 64; };
template <> struct Scalar<double> { static constexpr int kDepth = 128; };
constexpr int kMaxDepth = 128;  // the deepest stack of any scalar type
constexpr long long kMaxSteps = 1ll << 20;  // runaway guard per query
constexpr unsigned kDimMask = 3u, kSideHi = 4u, kPending = 8u;

constexpr int kRowWidth = 31;  // scalars per packed query row
constexpr int kGroups = 32;  // queries (lane groups) per block
// lanes per query: eight where domains are shared (one corner each), one
// where each query keeps its order (measured faster there, PERF.md)
template <bool SHARE> struct Layout {
  static constexpr int kLanes = SHARE ? 8 : 1;
  static constexpr int kThreads = kLanes * kGroups;
};
// states of a queue entry
constexpr int kEmpty = 0, kHeld = 1, kFull = 2;
// a pending sibling is handed to an idle group only from this many levels
// above the current domain: a deeper one is a small subtree, not worth a
// task's start
constexpr int kStealMin = 3;
// an idle group that has waited this many cycles (~35 s) for work gives up
// and flags overflow rather than hang the card; no correct run comes near
constexpr long long kStallCycles = 1ll << 36;

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

// The block's query rows, staged in shared memory as (31, 32): field k of
// the query in slot s at v[k][s], so the queries of a warp read
// neighbouring words and the eight lanes of a group one (a broadcast).
// rcp[d][s] = 1 / tol_d and exact[s] are computed once per query (below).
template <typename T>
struct Rows {
  T v[kRowWidth][kGroups];
  T rcp[3][kGroups];
  int exact[kGroups];
};

// min/max over the 8 corners of the box of F, per xyz dim: this lane's
// corners (bit 2: t, bit 1: u, bit 0: v) with the association of
// domain_corners (narrow_phase/types.py), then a butterfly over the group's
// LANES lanes; min and max are exact, so the order of the reduction is free.
// With several lanes per query its 24 point coordinates are read from the
// block's rows at every evaluation: `slot` is made opaque to the compiler so
// that it does not hoist them into 24 registers for the whole search (fewer
// registers, more queries resident per SM).  One lane keeps them in
// registers.
template <typename T, bool IS_VF, int LANES>
__device__ __forceinline__ void corners_minmax(const Rows<T>& rows, int slot,
                                               const T (&lo)[3],
                                               const T (&hi)[3], int corner,
                                               unsigned gmask, T (&cmin)[3],
                                               T (&cmax)[3]) {
  constexpr int kCorners = 8 / LANES;  // domain corners per lane
  if (LANES > 1) asm volatile("" : "+r"(slot));
  const T* row = &rows.v[0][slot];
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
      for (int k = 0; k < 8; ++k) p[k] = row[(3 * k + d) * kGroups];
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
  int state[kGroups];  // kEmpty, kHeld (being written or read) or kFull
  T tpq[kGroups];      // per-query mode: each query's running TOI
  int qcnt[kGroups];   // each query's evaluations, added as tasks end
  int work;            // busy groups plus queued tasks; 0 ends the block
  int hungry;          // idle groups less queued tasks: > 0 asks for work
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

template <typename T, bool IS_VF, bool PER_QUERY, bool SHARE>
__global__ void __launch_bounds__(Layout<SHARE>::kThreads)
    solve_kernel(const T* __restrict__ cols,
                 const unsigned char* __restrict__ valid, int Q, T co_tol,
                 T uv_limit, unsigned dim_cap, bool allow_zero,
                 long long max_iterations,
                 long long round_limit, long long max_steps, T* toi,
                 T* __restrict__ pq_out, unsigned char* __restrict__ unfin_out,
                 unsigned long long* __restrict__ checks_out,
                 int* __restrict__ ovf_out,
                 long long* __restrict__ qchecks_out) {
  constexpr int kDepth = Scalar<T>::kDepth;
  constexpr int kPathWords = kDepth / 8;
  constexpr int kLanes = Layout<SHARE>::kLanes;
  constexpr int kThreads = Layout<SHARE>::kThreads;
  const T inf = (T)INFINITY;
  const int corner = threadIdx.x & (kLanes - 1);
  const int leader = (threadIdx.x & 31) & ~(kLanes - 1);  // lane 0's lane
  const unsigned gmask = (0xFFu >> (8 - kLanes)) << leader;
  const bool head = corner == 0;
  const int group = threadIdx.x / kLanes;
  const int q_own = blockIdx.x * kGroups + group;
  const bool own_valid = q_own < Q && valid[q_own];

  __shared__ Rows<T> rows;
  __shared__ BlockQueue<T> sh;
  for (int i = threadIdx.x; i < kRowWidth * kGroups; i += kThreads) {
    const int k = i / kGroups, s = i % kGroups;
    const int q = blockIdx.x * kGroups + s;
    rows.v[k][s] = q < Q ? cols[(size_t)k * Q + q] : T(0);
  }
  __syncthreads();
  if (threadIdx.x < kGroups) {
    // Every width is a power of two 2^-k (a dyadic domain), so w / tol is
    // 2^-k * (1 / tol) rounded once, and scaling by 2^-k commutes with the
    // rounding while both values stay normal: w * rcp is the quotient
    // bitwise.  Tolerances whose reciprocal lies outside [2^-64, 2^64]
    // (0, inf, NaN, extreme values) keep the division.
    const int s = threadIdx.x;
    bool exact = true;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T r = T(1) / rows.v[24 + d][s];
      rows.rcp[d][s] = r;
      exact = exact && r >= T(5.421010862427522e-20) && r <= T(1.8446744073709552e19);
    }
    rows.exact[s] = exact;
  }
  if (SHARE && threadIdx.x < kGroups) {
    sh.state[threadIdx.x] = kEmpty;
    sh.tpq[threadIdx.x] = inf;
    sh.qcnt[threadIdx.x] = 0;
  }
  const int n_valid = __syncthreads_count(head && own_valid);
  if (SHARE) {
    if (threadIdx.x == 0) {
      sh.work = n_valid;
      sh.hungry = kGroups - n_valid;
    }
    __syncthreads();
  }

  unsigned long long checks = 0;  // this group's evaluations
  int ovf = 0;
  unsigned char unfin = 0;
  T tpq = inf;  // per_query without sharing: this query's running TOI

  // the current task: a domain of query `slot`, its absolute depth and
  // split counters; first the own query's unit cube
  int slot = group;
  bool busy = own_valid;
  T lo[3] = {T(0), T(0), T(0)};
  T hi[3] = {T(1), T(1), T(1)};
  int base = 0;
  unsigned dimcnt = 0u;  // 8-bit split counters: dims 0/1/2 at bits 0/8/16
  long long idle_since = -1;

  while (true) {
    if (!busy) {
      if (!SHARE) break;
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
      if (SHARE) {
        next_bound = PER_QUERY ? load_volatile(&sh.tpq[slot]) : load_volatile(toi);
        next_hungry = load_volatile(&sh.hungry);
        qbase = load_volatile(&sh.qcnt[slot]);
      } else if (!PER_QUERY) {
        next_bound = load_volatile(toi);
      }
    }
    if (SHARE) qbase = __shfl_sync(gmask, qbase, leader);

    unsigned path[kPathWords];
#pragma unroll
    for (int k = 0; k < kPathWords; ++k) path[k] = 0u;
    int sp = 0;        // levels on this task's stack
    bool cur = true;   // the current domain is still to be evaluated
    T pend_min = inf;  // lower bound of every pending sibling kept here
    int task_checks = 0;

    // unwind levels per round: two in round_limit mode, else all of them
    const int levels = round_limit >= 0 ? 2 : kDepth + 1;
    long long rounds = 0;
    // without sharing checks counts this query's evaluations, so it is also
    // its step count
    while ((cur || sp > 0) &&
           (SHARE || ((long long)checks < max_steps &&
                      (round_limit < 0 || rounds < round_limit)))) {
      ++rounds;
      if (cur) {
        if (SHARE && qbase + task_checks >= max_steps) break;  // guard
        T bound;
        int hungry = 0;
        if (!SHARE && PER_QUERY) {
          bound = tpq;
        } else {
          const T b = next_bound;
          const int h = next_hungry;
          if (head) {
            next_bound = SHARE && PER_QUERY ? load_volatile(&sh.tpq[slot])
                                            : load_volatile(toi);
            if (SHARE) next_hungry = load_volatile(&sh.hungry);
          }
          bound = tmin(__shfl_sync(gmask, b, leader), own);
          if (SHARE) hungry = __shfl_sync(gmask, h, leader);
        }
        const T min_t = lo[0];
        // bounded: the pre-increment count is compared, and a domain past
        // the cap is dropped, not accepted
        const bool pruned =
            min_t >= bound ||
            (max_iterations >= 0 && (long long)checks > max_iterations);
        ++checks;
        ++task_checks;
        T cmin[3], cmax[3];
        corners_minmax<T, IS_VF, kLanes>(rows, slot, lo, hi, corner, gmask, cmin, cmax);
        bool miss = false, box_in = true;
        T true_tol = T(0);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          miss = miss || (cmin[d] - ms > err[d]) || (cmax[d] + ms < -err[d]);
          box_in = box_in &&
                   !((cmin[d] + ms < -err[d]) || (cmax[d] - ms > err[d]));
          true_tol = tmax(true_tol, cmax[d] - cmin[d]);
        }
        true_tol = tmax(true_tol, T(0));
        const T w0 = hi[0] - lo[0], w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
        const bool pos_ok = allow_zero || min_t > T(0);
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
        const int split = d0 ? 0 : (d1 ? 1 : 2);
        const T s_lo = sel3(lo, split), s_hi = sel3(hi, split);
        const T mid = (s_lo + s_hi) * T(0.5);
        const bool degenerate = s_lo >= mid || mid >= s_hi;

        const bool live = !pruned && !miss;
        bool accept = live && (cond1 || cond2 || cond3 || degenerate);
        const bool want = live && !accept;
        const unsigned cnt_d = (dimcnt >> (8 * split)) & 255u;
        const bool full = base + sp >= kDepth || cnt_d >= dim_cap;
        if (want && full) {
          ovf = 1;
          accept = true;  // conservative accept
        }
        if (accept) {
          if (!SHARE && PER_QUERY) {
            tpq = tmin(tpq, min_t);
          } else {
            own = tmin(own, min_t);
            if (head) atomic_min_nonneg(SHARE && PER_QUERY ? &sh.tpq[slot] : toi, min_t);
          }
        }
        if (want && !full) {
          bool push2;
          if (IS_VF) {
            const T other = split == 1 ? lo[2] : lo[1];
            push2 = split == 0 ? mid <= bound : (mid + other) <= uv_limit;
          } else {
            push2 = split != 0 || mid <= bound;
          }
          const unsigned meta = (unsigned)split | kSideHi | (push2 ? kPending : 0u);
#pragma unroll
          for (int k = kPathWords - 1; k > 0; --k)
            path[k] = (path[k] << 4) | (path[k - 1] >> 28);
          path[0] = (path[0] << 4) | meta;
          dimcnt += 1u << (8 * split);
          if (push2) pend_min = tmin(pend_min, split == 0 ? mid : lo[0]);
          set3(hi, split, mid);  // descend into child1 = [s_lo, mid]
          ++sp;
          if (SHARE && hungry > 0) {
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
          for (int k = 0; k < kPathWords - 1; ++k)
            path[k] = (path[k] >> 4) | (path[k + 1] << 28);
          path[kPathWords - 1] >>= 4;
          dimcnt -= 1u << (8 * dim);
          --sp;
        }
      }
    }
    if ((cur || sp > 0) && round_limit >= 0) {
      unfin = 1;  // out of rounds: left to the caller's re-solve
    } else if (cur || sp > 0) {
      // runaway guard: accept the earliest unexplored time conservatively
      const T left = cur ? tmin(lo[0], pend_min) : pend_min;
      if (!SHARE && PER_QUERY) {
        tpq = tmin(tpq, left);
      } else if (head) {
        atomic_min_nonneg(SHARE && PER_QUERY ? &sh.tpq[slot] : toi, left);
      }
      ovf = 1;
    }
    if (SHARE && head) {
      atomicAdd(&sh.qcnt[slot], task_checks);
      atomicSub(&sh.work, 1);
      atomicAdd(&sh.hungry, 1);
    }
    busy = false;
  }

  if (SHARE) __syncthreads();
  if (head && q_own < Q) {
    if (PER_QUERY) {
      const T t = SHARE ? sh.tpq[group] : tpq;
      pq_out[q_own] = t;
      if (t < inf) atomic_min_nonneg(toi, t);
    }
    if (unfin_out != nullptr) unfin_out[q_own] = unfin;
    if (qchecks_out != nullptr)
      qchecks_out[q_own] = SHARE ? (long long)sh.qcnt[group] : (long long)checks;
  }
  if (!head) checks = 0;  // every lane of a group counted the same
  // one atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    checks += __shfl_down_sync(0xffffffffu, checks, off);
    ovf |= __shfl_down_sync(0xffffffffu, ovf, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (checks) atomicAdd(checks_out, checks);
    if (ovf) atomicOr(ovf_out, 1);
  }
}

template <typename T, bool IS_VF, bool PER_QUERY, bool SHARE>
void launch(int blocks, cudaStream_t s, const void* c, const void* v, int Q,
            double co_tol, double uv_limit, int dim_cap, int allow_zero,
            long long max_iter, long long round_limit, long long max_steps,
            void* t, void* pq, void* u, void* k, void* o, void* qk) {
  solve_kernel<T, IS_VF, PER_QUERY, SHARE><<<blocks, Layout<SHARE>::kThreads, 0, s>>>(
      (const T*)c, (const unsigned char*)v, Q, (T)co_tol, (T)uv_limit,
      (unsigned)dim_cap, allow_zero != 0, max_iter, round_limit, max_steps,
      (T*)t, (T*)pq, (unsigned char*)u, (unsigned long long*)k, (int*)o,
      (long long*)qk);
}

template <typename T, bool IS_VF, typename... Args>
void launch_share(int per_query, int share, Args... a) {
  if (per_query) {
    if (share)
      launch<T, IS_VF, true, true>(a...);
    else
      launch<T, IS_VF, true, false>(a...);
  } else {
    if (share)
      launch<T, IS_VF, false, true>(a...);
    else
      launch<T, IS_VF, false, false>(a...);
  }
}

template <typename T, typename... Args>
void launch_mode(int is_vf, Args... a) {
  if (is_vf)
    launch_share<T, true>(a...);
  else
    launch_share<T, false>(a...);
}

}  // namespace

// is_f64: cols, toi and per_query_toi are double, else float.  dim_cap: the
// most splits of one dimension (1..255).  uv_limit: the VF cull limit on
// u + v (exact in the scalar type).  per_query: nonzero selects
// per-query mode, which writes `per_query_toi` (Q scalars); max_iterations
// < 0 means unbounded; round_limit >= 0 (global mode only, no cap) writes
// `unfin` (Q bytes).  query_checks, null on every call of the main path,
// receives each query's evaluation count (Q long longs, 0 for invalid rows).
// The unbounded modes share domains inside a block (form 2 above); the
// bounded and round-limited ones keep each query's order (form 1).
extern "C" int sccd_solve_packed(const void* cols, const void* valid, int Q,
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
  if (dim_cap < 1 || dim_cap > 255) return (int)cudaErrorInvalidValue;
  const int blocks = (Q + kGroups - 1) / kGroups;
  const int share = max_iterations < 0 && round_limit < 0;
  long long max_steps = kMaxSteps;
  if (max_iterations >= 0 && max_iterations + 2 * kMaxDepth + 2 > max_steps)
    max_steps = max_iterations + 2 * kMaxDepth + 2;
  if (round_limit >= 0 && round_limit + 1 > max_steps)
    max_steps = round_limit + 1;
  auto s = (cudaStream_t)stream;
  if (is_f64)
    launch_mode<double>(is_vf, per_query, share, blocks, s, cols, valid, Q,
                        co_tol, uv_limit, dim_cap, allow_zero_toi,
                        max_iterations, round_limit, max_steps, toi,
                        per_query_toi, unfin, checks, overflow, query_checks);
  else
    launch_mode<float>(is_vf, per_query, share, blocks, s, cols, valid, Q,
                       co_tol, uv_limit, dim_cap, allow_zero_toi,
                       max_iterations, round_limit, max_steps, toi,
                       per_query_toi, unfin, checks, overflow, query_checks);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_solver_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
