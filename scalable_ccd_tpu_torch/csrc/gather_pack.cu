// Kernel C: gather, tolerance, error filter and pack of one narrow batch,
// written straight into kernel B's column layout.
//
// Replaces: the glue the JAX package runs inside its jitted narrow batch
// (scalable_ccd_tpu/pipeline/fused.py, run_solver and run_bounded, which
// gather with narrow_phase/types.py:gather_vf_queries / gather_ee_queries
// and pack with ops/pallas_solver.py:pack_query_rows), XLA-fused code there
// and no Pallas kernel.  Its plain twin is ops/gather_pack.py:
// gather_pack_reference (narrow_phase/types.py and ops/solver.py:
// pack_query_rows, transposed).
//
// What bounds it on an H100: bytes.  A row reads its two ids (8 B) and
// writes 31 scalars (124 B in float, 248 B in double and for the
// compensated rows); the four points' both-frame endpoints (24 scalars a
// row) are gathered from table rows that many candidates share, so the
// least traffic reads each referenced vertex (6 scalars), face (18) or
// edge (12) row once, and the scenes' tables fit in the 50 MB L2.  About
// 400 operations per row are 10x under the bytes at the card's rates.
// chip_smoke.py (pack_bound) counts the bound from a frame's pairs.  The
// design is the simple one: one
// thread per row, the endpoint gathers as plain loads (one face or edge row
// of 72 or 48 contiguous bytes per row), and the 31 stores of a row made
// by neighbouring threads to neighbouring words of each column.
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
// Three instantiations: float rows, double rows, and the compensated rows
// (float arithmetic, written as double: exact).  -fmad=false keeps every
// multiply and add separately rounded, as in the plain version.
//
// Plain C interface, bound with ctypes (ops/gather_pack.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows per block, one per thread

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

template <typename T, typename OUT, bool IS_VF>
__global__ void __launch_bounds__(kThreads)
    gather_pack_kernel(const int* __restrict__ pairs, long long start, int Q,
                       const T* __restrict__ vcat, int nv,
                       const T* __restrict__ table, int nt, T ms, T co_tol,
                       T k_eps, OUT* __restrict__ out, long long ld) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= Q) return;
  const int a = pairs[2 * (start + i)];
  const int b = pairs[2 * (start + i) + 1];
  T p[4][6];
  if (IS_VF) {
    const T* vr = vcat + (size_t)clamp_id(a, nv) * 6;
    const T* fr = table + (size_t)clamp_id(b, nt) * 18;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      p[0][c] = vr[c];
      p[1][c] = fr[c];
      p[2][c] = fr[6 + c];
      p[3][c] = fr[12 + c];
    }
  } else {
    const T* ar = table + (size_t)clamp_id(a, nt) * 12;
    const T* br = table + (size_t)clamp_id(b, nt) * 12;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      p[0][c] = ar[c];
      p[1][c] = ar[6 + c];
      p[2][c] = br[c];
      p[3][c] = br[6 + c];
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
  const T tol0 = co_tol / (three * ext_t);
  const T tol1 = IS_VF ? co_tol / (three * ext_u) : tol0;
  const T tol2 = IS_VF ? co_tol / (three * ext_v) : co_tol / (three * ext_u);

  OUT* col = out + i;
  // the eight points: p0s p1s p2s p3s p0e p1e p2e p3e
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        col[(size_t)(12 * e + 3 * k + d) * ld] = (OUT)p[k][3 * e + d];
  col[(size_t)24 * ld] = (OUT)tol0;
  col[(size_t)25 * ld] = (OUT)tol1;
  col[(size_t)26 * ld] = (OUT)tol2;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T m = abs_of(p[0][d]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k + e > 0) m = nan_max(m, abs_of(p[k][3 * e + d]));
    m = m < T(1) ? T(1) : m;  // clamp(min=1); NaN stays NaN
    col[(size_t)(27 + d) * ld] = (OUT)(((m * m) * m) * k_eps);
  }
  col[(size_t)30 * ld] = (OUT)ms;
}

template <typename T, typename OUT>
void launch(int is_vf, cudaStream_t s, const void* pairs, long long start,
            int Q, const void* vcat, int nv, const void* table, int nt,
            double ms, double co_tol, double k_eps, void* out, long long ld) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  if (is_vf)
    gather_pack_kernel<T, OUT, true><<<blocks, kThreads, 0, s>>>(
        (const int*)pairs, start, Q, (const T*)vcat, nv, (const T*)table, nt,
        (T)ms, (T)co_tol, (T)k_eps, (OUT*)out, ld);
  else
    gather_pack_kernel<T, OUT, false><<<blocks, kThreads, 0, s>>>(
        (const int*)pairs, start, Q, (const T*)vcat, nv, (const T*)table, nt,
        (T)ms, (T)co_tol, (T)k_eps, (OUT*)out, ld);
}

}  // namespace

// pairs: int32 (N, 2), rows start .. start + Q - 1 are packed.  vcat: (nv,
// 6) both-frame vertices; table: the face table (nt, 18) when is_vf, else
// the edge table (nt, 12); both in the compute type.  kind: 0 float rows,
// 1 double rows, 2 compensated (float compute, double rows).  ms, co_tol
// and k_eps (k * eps of the error filter, k = 30 or 28, plus 4 when ms > 0)
// are exact in the compute type.  out: column k of row i at out[k * ld +
// i], ld >= Q.  Returns the launch's CUDA error code (0 on success).
extern "C" int sccd_gather_pack(const void* pairs, long long start, int Q,
                                const void* vcat, int nv, const void* table,
                                int nt, int is_vf, int kind, double ms,
                                double co_tol, double k_eps, void* out,
                                long long ld, void* stream) {
  if (Q < 0 || ld < Q || kind < 0 || kind > 2 || nv < 1 || nt < 1)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  auto s = (cudaStream_t)stream;
  if (kind == 0)
    launch<float, float>(is_vf, s, pairs, start, Q, vcat, nv, table, nt, ms,
                         co_tol, k_eps, out, ld);
  else if (kind == 1)
    launch<double, double>(is_vf, s, pairs, start, Q, vcat, nv, table, nt, ms,
                           co_tol, k_eps, out, ld);
  else
    launch<float, double>(is_vf, s, pairs, start, Q, vcat, nv, table, nt, ms,
                          co_tol, k_eps, out, ld);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_gather_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
