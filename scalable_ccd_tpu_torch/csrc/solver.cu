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
// Must be compiled with -fmad=false: the unwind, the midpoints and the error
// filter assume separately rounded multiplies and adds (no FMA contraction),
// exactly as the plain twin computes them (ops/solver.py).
//
// Plain C interface, bound with ctypes (ops/solver.py).

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kDepth = 64;        // stack levels (4-bit nibbles)
constexpr int kPathWords = kDepth / 8;
constexpr unsigned kDimCap = 24;  // splits per dimension (dyadic exactness)
constexpr long long kMaxSteps = 1ll << 20;  // runaway guard per query
constexpr unsigned kDimMask = 3u, kSideHi = 4u, kPending = 8u;

__device__ __forceinline__ float sel3(const float (&a)[3], int d) {
  return d == 0 ? a[0] : (d == 1 ? a[1] : a[2]);
}

__device__ __forceinline__ void set3(float (&a)[3], int d, float v) {
  a[0] = d == 0 ? v : a[0];
  a[1] = d == 1 ? v : a[1];
  a[2] = d == 2 ? v : a[2];
}

__device__ __forceinline__ void atomic_min_nonneg(float* addr, float v) {
  atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
}

// min/max of F over the 8 corners of the box, per xyz dim; the same
// association as domain_corners (narrow_phase/types.py).
template <bool IS_VF>
__device__ __forceinline__ void corners_minmax(const float (&p)[24],
                                               const float (&lo)[3],
                                               const float (&hi)[3],
                                               float (&cmin)[3],
                                               float (&cmax)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cmin[d] = INFINITY;
    cmax[d] = -INFINITY;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float t = it ? hi[0] : lo[0];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float q0 = (p[12 + d] - p[d]) * t + p[d];
      const float q1 = (p[15 + d] - p[3 + d]) * t + p[3 + d];
      const float q2 = (p[18 + d] - p[6 + d]) * t + p[6 + d];
      const float q3 = (p[21 + d] - p[9 + d]) * t + p[9 + d];
#pragma unroll
      for (int iu = 0; iu < 2; ++iu) {
        const float u = iu ? hi[1] : lo[1];
#pragma unroll
        for (int iv = 0; iv < 2; ++iv) {
          const float v = iv ? hi[2] : lo[2];
          float f;
          if (IS_VF) {
            const float a = q2 - q1;
            const float b = q3 - q1;
            f = q0 - a * u - b * v - q1;
          } else {
            const float a = q1 - q0;
            const float b = q3 - q2;
            f = (a * u + q0) - (b * v + q2);
          }
          cmin[d] = fminf(cmin[d], f);
          cmax[d] = fmaxf(cmax[d], f);
        }
      }
    }
  }
}

template <bool IS_VF, bool ALLOW_ZERO, bool PER_QUERY>
__global__ void solve_kernel(const float* __restrict__ cols,
                             const unsigned char* __restrict__ valid, int Q,
                             float co_tol, long long max_iterations,
                             long long round_limit, long long max_steps,
                             float* toi, float* __restrict__ pq_out,
                             unsigned char* __restrict__ unfin_out,
                             unsigned long long* __restrict__ checks_out,
                             int* __restrict__ ovf_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long checks = 0;
  int ovf = 0;
  unsigned char unfin = 0;
  float tpq = INFINITY;  // per_query: this query's own running TOI
  if (q < Q && valid[q]) {
    float p[24];
#pragma unroll
    for (int k = 0; k < 24; ++k) p[k] = cols[(size_t)k * Q + q];
    const float tol[3] = {cols[(size_t)24 * Q + q], cols[(size_t)25 * Q + q],
                          cols[(size_t)26 * Q + q]};
    const float err[3] = {cols[(size_t)27 * Q + q], cols[(size_t)28 * Q + q],
                          cols[(size_t)29 * Q + q]};
    const float ms = cols[(size_t)30 * Q + q];
    const float uv_limit = 1.0f / (1.0f - FLT_EPSILON);

    float lo[3] = {0.f, 0.f, 0.f};
    float hi[3] = {1.f, 1.f, 1.f};
    unsigned path[kPathWords];
#pragma unroll
    for (int k = 0; k < kPathWords; ++k) path[k] = 0u;
    int sp = 0;
    unsigned dimcnt = 0u;  // 8-bit split counters: dims 0/1/2 at bits 0/8/16
    bool cur = true;       // the current domain is still to be evaluated
    float pend_min = INFINITY;  // lower bound of every pending sibling

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
        const float bound = PER_QUERY ? tpq : *(volatile float*)toi;
        const float min_t = lo[0];
        // bounded: the pre-increment count is compared, and a domain past
        // the cap is dropped, not accepted
        const bool pruned =
            min_t >= bound ||
            (max_iterations >= 0 && (long long)checks > max_iterations);
        ++checks;
        float cmin[3], cmax[3];
        corners_minmax<IS_VF>(p, lo, hi, cmin, cmax);
        bool miss = false, box_in = true;
        float true_tol = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          miss = miss || (cmin[d] - ms > err[d]) || (cmax[d] + ms < -err[d]);
          box_in = box_in &&
                   !((cmin[d] + ms < -err[d]) || (cmax[d] - ms > err[d]));
          true_tol = fmaxf(true_tol, cmax[d] - cmin[d]);
        }
        true_tol = fmaxf(true_tol, 0.f);
        const float w0 = hi[0] - lo[0], w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
        const bool pos_ok = ALLOW_ZERO || min_t > 0.f;
        const bool cond1 = w0 <= tol[0] && w1 <= tol[1] && w2 <= tol[2];
        const bool cond2 = box_in && pos_ok;
        const bool cond3 = true_tol <= co_tol && pos_ok;
        // split dim: argmax of widths / tol, first index on ties
        const float r0 = w0 / tol[0], r1 = w1 / tol[1], r2 = w2 / tol[2];
        const bool d0 = r0 >= r1 && r0 >= r2;
        const bool d1 = !d0 && r1 >= r2;
        const int split = d0 ? 0 : (d1 ? 1 : 2);
        const float s_lo = sel3(lo, split), s_hi = sel3(hi, split);
        const float mid = (s_lo + s_hi) * 0.5f;
        const bool degenerate = s_lo >= mid || mid >= s_hi;

        const bool live = !pruned && !miss;
        bool accept = live && (cond1 || cond2 || cond3 || degenerate);
        const bool want = live && !accept;
        const unsigned cnt_d = (dimcnt >> (8 * split)) & 255u;
        const bool full = sp >= kDepth || cnt_d >= kDimCap;
        if (want && full) {
          ovf = 1;
          accept = true;  // conservative accept
        }
        if (accept) {
          if (PER_QUERY)
            tpq = fminf(tpq, min_t);
          else
            atomic_min_nonneg(toi, min_t);
        }
        if (want && !full) {
          bool push2;
          if (IS_VF) {
            const float other = split == 1 ? lo[2] : lo[1];
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
          if (push2) pend_min = fminf(pend_min, split == 0 ? mid : lo[0]);
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
        const float old_hi = sel3(hi, dim), old_lo = sel3(lo, dim);
        if (side_hi) {
          set3(hi, dim, 2.0f * old_hi - old_lo);
        } else {
          set3(lo, dim, 2.0f * old_lo - old_hi);
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
      const float left = cur ? fminf(lo[0], pend_min) : pend_min;
      if (PER_QUERY)
        tpq = fminf(tpq, left);
      else
        atomic_min_nonneg(toi, left);
      ovf = 1;
    }
  }
  if (PER_QUERY && q < Q) {
    pq_out[q] = tpq;
    if (tpq < INFINITY) atomic_min_nonneg(toi, tpq);
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

template <bool IS_VF, bool ALLOW_ZERO, bool PER_QUERY>
void launch(int blocks, int threads, cudaStream_t s, const float* c,
            const unsigned char* v, int Q, float co_tol, long long max_iter,
            long long round_limit, long long max_steps, float* t, float* pq,
            unsigned char* u, unsigned long long* k, int* o) {
  solve_kernel<IS_VF, ALLOW_ZERO, PER_QUERY><<<blocks, threads, 0, s>>>(
      c, v, Q, co_tol, max_iter, round_limit, max_steps, t, pq, u, k, o);
}

template <bool IS_VF, bool ALLOW_ZERO>
void launch_mode(int per_query, int blocks, int threads, cudaStream_t s,
                 const float* c, const unsigned char* v, int Q, float co_tol,
                 long long max_iter, long long round_limit,
                 long long max_steps, float* t, float* pq, unsigned char* u,
                 unsigned long long* k, int* o) {
  if (per_query)
    launch<IS_VF, ALLOW_ZERO, true>(blocks, threads, s, c, v, Q, co_tol,
                                    max_iter, round_limit, max_steps, t, pq,
                                    u, k, o);
  else
    launch<IS_VF, ALLOW_ZERO, false>(blocks, threads, s, c, v, Q, co_tol,
                                     max_iter, round_limit, max_steps, t, pq,
                                     u, k, o);
}

}  // namespace

// per_query: nonzero selects per-query mode, which writes `per_query_toi`
// (Q floats); max_iterations < 0 means unbounded; round_limit >= 0 (global
// mode only, no cap) writes `unfin` (Q bytes).
extern "C" int sccd_solve_packed(const void* cols, const void* valid, int Q,
                                 int is_vf, int allow_zero_toi, int per_query,
                                 long long max_iterations,
                                 long long round_limit, float co_tol,
                                 void* toi, void* per_query_toi, void* unfin,
                                 void* checks, void* overflow, void* stream) {
  if (round_limit >= 0 && (per_query || max_iterations >= 0 || !unfin))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  long long max_steps = kMaxSteps;
  if (max_iterations >= 0 && max_iterations + 2 * kDepth + 2 > max_steps)
    max_steps = max_iterations + 2 * kDepth + 2;
  if (round_limit >= 0 && round_limit + 1 > max_steps)
    max_steps = round_limit + 1;
  auto s = (cudaStream_t)stream;
  auto c = (const float*)cols;
  auto v = (const unsigned char*)valid;
  auto t = (float*)toi;
  auto pq = (float*)per_query_toi;
  auto u = (unsigned char*)unfin;
  auto k = (unsigned long long*)checks;
  auto o = (int*)overflow;
  if (is_vf) {
    if (allow_zero_toi)
      launch_mode<true, true>(per_query, blocks, threads, s, c, v, Q, co_tol,
                              max_iterations, round_limit, max_steps, t, pq,
                              u, k, o);
    else
      launch_mode<true, false>(per_query, blocks, threads, s, c, v, Q, co_tol,
                               max_iterations, round_limit, max_steps, t, pq,
                               u, k, o);
  } else {
    if (allow_zero_toi)
      launch_mode<false, true>(per_query, blocks, threads, s, c, v, Q, co_tol,
                               max_iterations, round_limit, max_steps, t, pq,
                               u, k, o);
    else
      launch_mode<false, false>(per_query, blocks, threads, s, c, v, Q, co_tol,
                                max_iterations, round_limit, max_steps, t, pq,
                                u, k, o);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_solver_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
