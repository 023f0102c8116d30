// The packed row of one candidate pair: the gather of its four points, its
// domain tolerances, its error filter and ms, in kernel B's field order
// (ops/solver.py:pack_query_rows).
//
// Shared by kernel C (csrc/gather_pack.cu), which writes each row into
// kernel B's columns, and by the pairs source of kernel B's one-thread form
// (csrc/solver.cu, form 1), which writes it into a warp's staged slot, so
// that both compute every row with the same expressions and, built with
// -fmad=false, bit for bit the same values.
//
// Every value is bitwise the plain version's, in the plain version's order
// of operations: the lerp (pe - ps) * t + ps at t = 0 and at t = 1; the
// residual F at the eight corners of the unit cube with the association of
// narrow_phase/types.py:domain_corners; each extent the max over the
// |corner differences| along its axis (the EE quirk: tolerances (ext_t,
// ext_t, ext_u)); co / (3 * ext); the error filter ((m * m) * m) * (k *
// eps), m = max(max |coordinate| over the eight endpoints, 1).  Maxima
// propagate NaN as torch.amax and torch.clamp do (fmaxf would drop it).
// ms, the co-domain tolerance and k * eps come in already rounded to the
// compute type, and the host decides use_ms on the rounded ms.
//
// The table rows come through the read-only path in 16-byte vector loads (a
// float face row of 72 bytes starts on 8 or 16 bytes: four 16-byte loads
// and one 8-byte load, in the order its alignment allows; float edge rows,
// 48 bytes, and every double row are whole 16-byte loads).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// max that returns NaN if either operand is NaN (torch.amax's rule)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// |x| with +0 for -0 and NaN kept, as torch.abs
template <typename T>
__device__ __forceinline__ T abs_of(T x) {
  return x < T(0) ? -x : (x == T(0) ? T(0) : x);
}

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id > n - 1 ? n - 1 : id);
}

// N floats of a table row (N even, the row 8-byte aligned): 16-byte loads
// through the read-only path, an 8-byte load first where the row starts 8
// bytes past a 16-byte boundary and last where one 8-byte unit is left
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ r, float (&d)[N]) {
  constexpr int U = N / 2;  // 8-byte units
  if ((reinterpret_cast<uintptr_t>(r) & 15) == 0) {
#pragma unroll
    for (int u = 0; u + 1 < U; u += 2) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(r + 2 * u));
      d[2 * u] = x.x;
      d[2 * u + 1] = x.y;
      d[2 * u + 2] = x.z;
      d[2 * u + 3] = x.w;
    }
    if (U % 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(r + N - 2));
      d[N - 2] = x.x;
      d[N - 1] = x.y;
    }
  } else {
    const float2 h = __ldg(reinterpret_cast<const float2*>(r));
    d[0] = h.x;
    d[1] = h.y;
#pragma unroll
    for (int u = 1; u + 1 < U; u += 2) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(r + 2 * u));
      d[2 * u] = x.x;
      d[2 * u + 1] = x.y;
      d[2 * u + 2] = x.z;
      d[2 * u + 3] = x.w;
    }
    if ((U - 1) % 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(r + N - 2));
      d[N - 2] = x.x;
      d[N - 1] = x.y;
    }
  }
}

// N doubles of a table row (N even, the row 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_row(const double* __restrict__ r, double (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 2) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(r + k));
    d[k] = x.x;
    d[k + 1] = x.y;
  }
}

// F at corner (t, u, v) of the unit cube, coordinate d: p[k][0..2] is
// point k at t=0, p[k][3..5] at t=1
template <typename T, bool IS_VF>
__device__ __forceinline__ T residual(const T (&p)[4][6], int d, T t, T u, T v) {
  const T q0 = (p[0][3 + d] - p[0][d]) * t + p[0][d];
  const T q1 = (p[1][3 + d] - p[1][d]) * t + p[1][d];
  const T q2 = (p[2][3 + d] - p[2][d]) * t + p[2][d];
  const T q3 = (p[3][3 + d] - p[3][d]) * t + p[3][d];
  if (IS_VF) return ((q0 - (q2 - q1) * u) - (q3 - q1) * v) - q1;
  return ((q1 - q0) * u + q0) - ((q3 - q2) * v + q2);
}

// what every row of a phase shares, in the compute type T
template <typename T>
struct PackTables {
  const T* vcat;   // (nv, 6) both-frame vertices
  int nv;
  const T* table;  // (nt, 18) faces when VF, (nt, 12) edges when EE
  int nt;
  T ms, co_tol, k_eps;
};

// gather the four points of the pair (a, b) and hand field k of its row to
// put(k, value), k = 0 .. 30 in order (ids out of range are clamped)
template <typename T, bool IS_VF, typename Sink>
__device__ __forceinline__ void pack_row(int a, int b, const PackTables<T>& c,
                                         const Sink& put) {
  T p[4][6];
  if (IS_VF) {
    T v[6], fr[18];
    load_row<6>(c.vcat + (size_t)clamp_id(a, c.nv) * 6, v);
    load_row<18>(c.table + (size_t)clamp_id(b, c.nt) * 18, fr);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      p[0][k] = v[k];
      p[1][k] = fr[k];
      p[2][k] = fr[6 + k];
      p[3][k] = fr[12 + k];
    }
  } else {
    T ar[12], br[12];
    load_row<12>(c.table + (size_t)clamp_id(a, c.nt) * 12, ar);
    load_row<12>(c.table + (size_t)clamp_id(b, c.nt) * 12, br);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      p[0][k] = ar[k];
      p[1][k] = ar[6 + k];
      p[2][k] = br[k];
      p[3][k] = br[6 + k];
    }
  }

  // extents of F over the unit cube along t, u and v
  T ext_t = T(0), ext_u = T(0), ext_v = T(0);
  bool first = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T f[2][2][2];
#pragma unroll
    for (int it = 0; it < 2; ++it)
#pragma unroll
      for (int iu = 0; iu < 2; ++iu)
#pragma unroll
        for (int iv = 0; iv < 2; ++iv)
          f[it][iu][iv] = residual<T, IS_VF>(p, d, T(it), T(iu), T(iv));
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const T dt = abs_of(f[1][x][y] - f[0][x][y]);
        const T du = abs_of(f[x][1][y] - f[x][0][y]);
        const T dv = abs_of(f[x][y][1] - f[x][y][0]);
        if (first) {
          ext_t = dt;
          ext_u = du;
          ext_v = dv;
          first = false;
        } else {
          ext_t = nan_max(ext_t, dt);
          ext_u = nan_max(ext_u, du);
          ext_v = nan_max(ext_v, dv);
        }
      }
  }
  const T three = T(3);
  const T tol0 = c.co_tol / (three * ext_t);
  const T tol1 = IS_VF ? c.co_tol / (three * ext_u) : tol0;
  const T tol2 = IS_VF ? c.co_tol / (three * ext_v) : c.co_tol / (three * ext_u);

  // the eight points: p0s p1s p2s p3s p0e p1e p2e p3e
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d) put(12 * e + 3 * k + d, p[k][3 * e + d]);
  put(24, tol0);
  put(25, tol1);
  put(26, tol2);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T m = abs_of(p[0][d]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k + e > 0) m = nan_max(m, abs_of(p[k][3 * e + d]));
    m = m < T(1) ? T(1) : m;  // clamp(min=1); NaN stays NaN
    put(27 + d, ((m * m) * m) * c.k_eps);
  }
  put(30, c.ms);
}

}  // namespace
