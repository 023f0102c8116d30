// Kernel B: tight-inclusion root finder, one depth-first search per thread.
//
// Replaces: scalable_ccd_tpu/ops/pallas_solver.py, _solver_kernel (global,
// per_query, max_iterations and round_limit modes, launched by
// _find_roots_packed), itself the TPU form of the reference's ccd_kernel
// (src/scalable_ccd/cuda/narrow_phase/root_finder.cu:277-370).
//
// What bounds it on an H100: f32 arithmetic and divergence.  One domain
// evaluation is ~300 separately rounded flops (the residual F at 8 corners
// in 3 dims, then min/max, the filters and the split choice) on 31 floats
// of query data that stay in registers; the number of evaluations per query
// varies from 1 to thousands, and a warp runs as long as its deepest lane.
//
// Design: one thread per query row, rows read as SoA (31, Q) so neighbouring
// threads read neighbouring addresses.  Each thread runs its own bisection
// of (t,u,v) in [0,1]^3 with the JAX kernel's value-free stack: a split
// stores one 4-bit nibble {dim, side, pending sibling} and the replaced
// bound is reconstructed on unwind as 2*hi - lo or 2*lo - hi, exact because
// every bound is a dyadic k/2^m with m <= 24 per dimension.  64 levels fit
// in eight 32-bit registers.  Past 64 levels or 24 splits of one dimension
// the domain is accepted conservatively and the overflow flag is set.
// checks are summed and overflow or-ed per warp, then once per warp with
// atomics.
//
// Modes (template PER_QUERY, runtime max_iterations and round_limit):
// - global (the TPU kernel's default mode): the running TOI is one device
//   float, seeded with toi_init, read at every evaluation and lowered with
//   atomicMin on its int bits (valid for non-negative floats; the
//   reference's atomic_min_float.cuh).
// - per_query (TPU per_query=True, the reference's TOI_PER_QUERY build):
//   each thread prunes, and culls t-split siblings, only against its own
//   register TOI, which starts at +inf, not toi_init.  Nothing is shared
//   during the search, so each per-query TOI is exact and independent of
//   the other threads; every thread writes its TOI (+inf for invalid rows
//   and rows without contact) to the per-query plane, then one atomicMin
//   folds it into the global TOI.  Bounded by the same arithmetic, but with
//   far more evaluations than global mode: nothing prunes across queries.
// - bounded (TPU max_iterations >= 0): the thread's evaluation count is
//   compared BEFORE it is incremented, and a domain past the cap is dropped,
//   never accepted; dropped evaluations count too (pallas_solver.py:
//   233-237, the reference's root_finder.cu:289,303-305).  A cap bounds the
//   work of the deepest thread, so a warp ends sooner; it costs one compare
//   per evaluation.  With per_query the result is deterministic and follows
//   the plain lockstep DFS (narrow_phase/root_finder.py:dfs_lockstep) bit
//   for bit: both explore child1 first and enter a pending sibling on
//   unwind.  In global mode the domains a binding cap drops depend on when
//   other threads lower the shared TOI, so the result can change from run to
//   run (as on the TPU); the plain version then counts as the JAX queue
//   solver does, and the two agree wherever the cap does not bind.
// - round_limit (TPU round_limit >= 0, the staged-escalation pass; global
//   mode only): a thread stops after round_limit rounds and, if it is still
//   mid-search, writes unfin[q] = 1 instead of accepting: it neither lowers
//   the TOI nor sets overflow, and the caller re-solves it from scratch
//   (ops/solver.py:solve_escalated).  Rounds are counted as the TPU kernel's
//   while loop counts them (pallas_solver.py:392-397): one round evaluates
//   the current domain, if any, and then unwinds at most two levels of a
//   finished one, so a round can evaluate nothing.  In the other modes the
//   unwind runs to the next pending sibling in one round; the result is the
//   same, only the loop count differs.  Every thread writes its unfin byte.
//
// Runaway guard: a thread stops after max_steps evaluations and accepts its
// earliest unexplored time conservatively (overflow set).  max_steps is
// kMaxSteps (2^20) in unbounded modes; with a cap it is raised to at least
// max_iterations + 2 * kDepth + 2, past the last evaluation a capped search
// can make (the cap, then one dropped evaluation per pending sibling), so
// the cap always applies before the guard.  With a round limit it is raised
// past the limit (a round evaluates at most once), so the guard never fires.
//
// Scalar type (template T): the rows are float or double.  In double the
// running TOI is lowered with atomicMin on its long long bits (valid for
// non-negative doubles), the stack has 128 levels (sixteen 32-bit words:
// with a 2^-53 error filter a search ends on its tolerances, ~20 splits in
// each of the three dimensions at a co-domain tolerance of 1e-6, and runs
// deeper than float's), and 31 doubles of query data take 62 registers.
// The per-dimension split cap is an argument: 24 for float rows (bounds
// exact in a 24-bit mantissa), 52 for double rows, and 24 for double rows
// widened from float ones (the compensated precision of ops/solver.py: every
// bound, and so the TOI, stays exact in float).
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

// min/max of F over the 8 corners of the box, per xyz dim; the same
// association as domain_corners (narrow_phase/types.py).
template <typename T, bool IS_VF>
__device__ __forceinline__ void corners_minmax(const T (&p)[24],
                                               const T (&lo)[3],
                                               const T (&hi)[3], T (&cmin)[3],
                                               T (&cmax)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cmin[d] = (T)INFINITY;
    cmax[d] = -(T)INFINITY;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const T t = it ? hi[0] : lo[0];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T q0 = (p[12 + d] - p[d]) * t + p[d];
      const T q1 = (p[15 + d] - p[3 + d]) * t + p[3 + d];
      const T q2 = (p[18 + d] - p[6 + d]) * t + p[6 + d];
      const T q3 = (p[21 + d] - p[9 + d]) * t + p[9 + d];
#pragma unroll
      for (int iu = 0; iu < 2; ++iu) {
        const T u = iu ? hi[1] : lo[1];
#pragma unroll
        for (int iv = 0; iv < 2; ++iv) {
          const T v = iv ? hi[2] : lo[2];
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
          cmin[d] = tmin(cmin[d], f);
          cmax[d] = tmax(cmax[d], f);
        }
      }
    }
  }
}

template <typename T, bool IS_VF, bool ALLOW_ZERO, bool PER_QUERY>
__global__ void solve_kernel(const T* __restrict__ cols,
                             const unsigned char* __restrict__ valid, int Q,
                             T co_tol, T uv_limit, unsigned dim_cap,
                             long long max_iterations, long long round_limit,
                             long long max_steps, T* toi,
                             T* __restrict__ pq_out,
                             unsigned char* __restrict__ unfin_out,
                             unsigned long long* __restrict__ checks_out,
                             int* __restrict__ ovf_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long checks = 0;
  int ovf = 0;
  unsigned char unfin = 0;
  constexpr int kDepth = Scalar<T>::kDepth;
  constexpr int kPathWords = kDepth / 8;
  const T inf = (T)INFINITY;
  T tpq = inf;  // per_query: this query's own running TOI
  if (q < Q && valid[q]) {
    T p[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) p[k] = cols[(size_t)k * Q + q];
    const T tol[3] = {cols[(size_t)24 * Q + q], cols[(size_t)25 * Q + q],
                      cols[(size_t)26 * Q + q]};
    const T err[3] = {cols[(size_t)27 * Q + q], cols[(size_t)28 * Q + q],
                      cols[(size_t)29 * Q + q]};
    const T ms = cols[(size_t)30 * Q + q];

    T lo[3] = {T(0), T(0), T(0)};
    T hi[3] = {T(1), T(1), T(1)};
    unsigned path[kPathWords];
#pragma unroll
    for (int k = 0; k < kPathWords; ++k) path[k] = 0u;
    int sp = 0;
    unsigned dimcnt = 0u;  // 8-bit split counters: dims 0/1/2 at bits 0/8/16
    bool cur = true;       // the current domain is still to be evaluated
    T pend_min = inf;  // lower bound of every pending sibling

    // unwind levels per round: two in round_limit mode, else all of them
    const int levels = round_limit >= 0 ? 2 : kDepth + 1;
    long long rounds = 0;
    // checks counts this thread's evaluations, so it is also the step count
    while ((cur || sp > 0) && (long long)checks < max_steps &&
           (round_limit < 0 || rounds < round_limit)) {
      ++rounds;
      if (cur) {
        // global: every accept lowers *toi first, so this read covers this
        // query's own accepts
        const T bound = PER_QUERY ? tpq : *(volatile T*)toi;
        const T min_t = lo[0];
        // bounded: the pre-increment count is compared, and a domain past
        // the cap is dropped, not accepted
        const bool pruned =
            min_t >= bound ||
            (max_iterations >= 0 && (long long)checks > max_iterations);
        ++checks;
        T cmin[3], cmax[3];
        corners_minmax<T, IS_VF>(p, lo, hi, cmin, cmax);
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
        const bool pos_ok = ALLOW_ZERO || min_t > T(0);
        const bool cond1 = w0 <= tol[0] && w1 <= tol[1] && w2 <= tol[2];
        const bool cond2 = box_in && pos_ok;
        const bool cond3 = true_tol <= co_tol && pos_ok;
        // split dim: argmax of widths / tol, first index on ties
        const T r0 = w0 / tol[0], r1 = w1 / tol[1], r2 = w2 / tol[2];
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
        const bool full = sp >= kDepth || cnt_d >= dim_cap;
        if (want && full) {
          ovf = 1;
          accept = true;  // conservative accept
        }
        if (accept) {
          if (PER_QUERY)
            tpq = tmin(tpq, min_t);
          else
            atomic_min_nonneg(toi, min_t);
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
      if (PER_QUERY)
        tpq = tmin(tpq, left);
      else
        atomic_min_nonneg(toi, left);
      ovf = 1;
    }
  }
  if (PER_QUERY && q < Q) {
    pq_out[q] = tpq;
    if (tpq < inf) atomic_min_nonneg(toi, tpq);
  }
  if (unfin_out != nullptr && q < Q) unfin_out[q] = unfin;
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

template <typename T, bool IS_VF, bool ALLOW_ZERO, bool PER_QUERY>
void launch(int blocks, int threads, cudaStream_t s, const void* c,
            const void* v, int Q, double co_tol, double uv_limit, int dim_cap,
            long long max_iter, long long round_limit, long long max_steps,
            void* t, void* pq, void* u, void* k, void* o) {
  solve_kernel<T, IS_VF, ALLOW_ZERO, PER_QUERY><<<blocks, threads, 0, s>>>(
      (const T*)c, (const unsigned char*)v, Q, (T)co_tol, (T)uv_limit,
      (unsigned)dim_cap, max_iter, round_limit, max_steps, (T*)t, (T*)pq,
      (unsigned char*)u, (unsigned long long*)k, (int*)o);
}

template <typename T, typename... Args>
void launch_mode(int is_vf, int allow_zero_toi, int per_query, Args... a) {
  if (is_vf) {
    if (allow_zero_toi) {
      if (per_query)
        launch<T, true, true, true>(a...);
      else
        launch<T, true, true, false>(a...);
    } else {
      if (per_query)
        launch<T, true, false, true>(a...);
      else
        launch<T, true, false, false>(a...);
    }
  } else {
    if (allow_zero_toi) {
      if (per_query)
        launch<T, false, true, true>(a...);
      else
        launch<T, false, true, false>(a...);
    } else {
      if (per_query)
        launch<T, false, false, true>(a...);
      else
        launch<T, false, false, false>(a...);
    }
  }
}

}  // namespace

// is_f64: cols, toi and per_query_toi are double, else float.  dim_cap: the
// most splits of one dimension (1..255).  uv_limit: the VF cull limit on
// u + v (exact in the scalar type).  per_query: nonzero selects
// per-query mode, which writes `per_query_toi` (Q scalars); max_iterations
// < 0 means unbounded; round_limit >= 0 (global mode only, no cap) writes
// `unfin` (Q bytes).
extern "C" int sccd_solve_packed(const void* cols, const void* valid, int Q,
                                 int is_vf, int allow_zero_toi, int per_query,
                                 int is_f64, int dim_cap,
                                 long long max_iterations,
                                 long long round_limit, double co_tol,
                                 double uv_limit, void* toi,
                                 void* per_query_toi, void* unfin,
                                 void* checks, void* overflow, void* stream) {
  if (round_limit >= 0 && (per_query || max_iterations >= 0 || !unfin))
    return (int)cudaErrorInvalidValue;
  if (dim_cap < 1 || dim_cap > 255) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  long long max_steps = kMaxSteps;
  if (max_iterations >= 0 && max_iterations + 2 * kMaxDepth + 2 > max_steps)
    max_steps = max_iterations + 2 * kMaxDepth + 2;
  if (round_limit >= 0 && round_limit + 1 > max_steps)
    max_steps = round_limit + 1;
  auto s = (cudaStream_t)stream;
  if (is_f64)
    launch_mode<double>(is_vf, allow_zero_toi, per_query, blocks, threads, s,
                        cols, valid, Q, co_tol, uv_limit, dim_cap, max_iterations,
                        round_limit, max_steps, toi, per_query_toi, unfin,
                        checks, overflow);
  else
    launch_mode<float>(is_vf, allow_zero_toi, per_query, blocks, threads, s,
                       cols, valid, Q, co_tol, uv_limit, dim_cap, max_iterations,
                       round_limit, max_steps, toi, per_query_toi, unfin,
                       checks, overflow);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_solver_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
