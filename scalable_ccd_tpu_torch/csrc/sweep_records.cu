// Kernel A': sorted-sweep broad phase with bit-record emission.
//
// Replaces: scalable_ccd_tpu/ops/pallas_sweep_ap.py, pallas_sweep_records
// (the records emissions of _sweep_kernel), with the same record contract:
// one record per (partner j, 128-box a-row r) that has a survivor i < j,
// eight int32 words: w0..w3 the 128-bit mask of the surviving a-lanes
// (lane i % 128 is bit i % 32 of word (i % 128) / 32), w4 = j (the partner's
// sorted position), w5 = r, w6 = w7 = 0.  The pair set is kernel A's; the
// filters are the same float and integer tests.  The TPU's record layouts
// (dense, sparse, mxu, mxu16) only place these records in VMEM and land the
// same 32 bytes in HBM; here a record is a plain row of an (R, 8) buffer.
//
// What bounds it on an H100: the candidate slots, as for kernel A (memory
// latency and divergence of the partner walk), plus one 32-byte record per
// (partner, row) with a survivor instead of 8 bytes per pair: on congested
// scenes a record carries several pairs, so fewer bytes leave the kernel.
//
// Design: one 128-thread CTA per a-row, thread t on sorted box i = 128 r + t.
// The row's reach (max major_max) and its union of minor axis 0 are reduced
// in shared memory.  Partners stream in chunks of 32, starting at the row's
// first box (the i < j test drops the rest): warp 0 stages the chunk's
// partner fields in shared memory, every thread tests its own box against
// each of the 32 partners, and each warp ballots its 32 lanes per partner.
// After the chunk, one thread per partner combines the four warps' ballots
// into the 128-bit mask and, if it is not empty, takes a record slot with
// atomicAdd on a 64-bit record counter and adds the mask's popcount to a
// 64-bit pair counter.  Both counters are exact even past the budget; a
// record is written only when its slot is below rec_budget.  Record order
// is therefore nondeterministic; the record multiset is not.
//
// The stream stops, for the whole CTA, at the first chunk whose first
// partner's major_min (fwd_min under any_order) exceeds the row's reach.
// Under any_order each slot also tests major_min[i] <= major_max[j], and a
// 128-aligned partner row whose minor-0 union misses the a-row's is skipped
// whole, as in kernel A.
//
// Scalar type (template T): float or double planes, as in kernel A.  The
// records hold positions and bits, no floats, so their format and decode do
// not depend on T.  The partner chunk, the ballots and the reductions take
// 1.7-1.8 KB of static shared memory per block in float and 2.3-2.7 KB in
// double (ptxas), far below the 48 KB a block may take statically.
//
// Plain C interface, bound with ctypes (ops/sweep_records.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRow = 128;   // boxes per a-row, threads per CTA
constexpr int kChunk = 32;  // partners per chunk
constexpr int kWarps = kRow / 32;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

template <typename T, bool ANY_ORDER>
__global__ void __launch_bounds__(kRow) sweep_records_kernel(
    const T* __restrict__ major_min, const T* __restrict__ major_max,
    const typename Vec2<T>::type* __restrict__ minor_min,
    const typename Vec2<T>::type* __restrict__ minor_max,
    const int* __restrict__ vertex_ids, const int* __restrict__ element_id,
    const T* __restrict__ fwd_min, const T* __restrict__ row_umin,
    const T* __restrict__ row_umax, int n, int is_two_lists,
    int* __restrict__ records, long long rec_budget,
    unsigned long long* __restrict__ n_records,
    unsigned long long* __restrict__ n_pairs) {
  using V = typename Vec2<T>::type;
  const T inf = (T)INFINITY;
  __shared__ T s_reach[kWarps], s_lo0[kWarps], s_hi0[kWarps];
  __shared__ T p_mmin[kChunk], p_mmax[kChunk];
  __shared__ V p_lo[kChunk], p_hi[kChunk];
  __shared__ int p_v0[kChunk], p_v1[kChunk], p_v2[kChunk], p_eid[kChunk];
  __shared__ unsigned ballots[kWarps][kChunk];

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int i = r * kRow + t;
  const bool live = i < n;
  T a_reach = -inf, a_start = inf;
  V a_lo, a_hi;
  a_lo.x = a_lo.y = inf;
  a_hi.x = a_hi.y = -inf;
  int a0 = 0, a1 = 0, a2 = 0, a_eid = 0;
  if (live) {
    a_reach = major_max[i];
    a_start = major_min[i];
    a_lo = minor_min[i];
    a_hi = minor_max[i];
    a0 = vertex_ids[3 * i + 0];
    a1 = vertex_ids[3 * i + 1];
    a2 = vertex_ids[3 * i + 2];
    a_eid = element_id[i];
  }
  // the row's reach and minor-0 union (dead lanes carry inverted bounds)
  T reach = a_reach, lo0 = a_lo.x, hi0 = a_hi.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    reach = tmax(reach, __shfl_xor_sync(0xffffffffu, reach, off));
    lo0 = tmin(lo0, __shfl_xor_sync(0xffffffffu, lo0, off));
    hi0 = tmax(hi0, __shfl_xor_sync(0xffffffffu, hi0, off));
  }
  if (lane == 0) {
    s_reach[warp] = reach;
    s_lo0[warp] = lo0;
    s_hi0[warp] = hi0;
  }
  __syncthreads();
  reach = tmax(tmax(s_reach[0], s_reach[1]), tmax(s_reach[2], s_reach[3]));
  lo0 = tmin(tmin(s_lo0[0], s_lo0[1]), tmin(s_lo0[2], s_lo0[3]));
  hi0 = tmax(tmax(s_hi0[0], s_hi0[1]), tmax(s_hi0[2], s_hi0[3]));

  for (int j0 = r * kRow; j0 < n; j0 += kChunk) {
    // uniform over the CTA: every thread reads the same words
    if ((ANY_ORDER ? fwd_min[j0] : major_min[j0]) > reach) break;
    if (ANY_ORDER && (j0 & (kRow - 1)) == 0) {
      const int pr = j0 / kRow;
      if (row_umin[pr] > hi0 || row_umax[pr] < lo0) {
        j0 += kRow - kChunk;  // the loop's increment lands on the next row
        continue;
      }
    }
    if (t < kChunk) {
      const int j = j0 + t;
      if (j < n) {
        p_mmin[t] = major_min[j];
        p_mmax[t] = major_max[j];
        p_lo[t] = minor_min[j];
        p_hi[t] = minor_max[j];
        p_v0[t] = vertex_ids[3 * j + 0];
        p_v1[t] = vertex_ids[3 * j + 1];
        p_v2[t] = vertex_ids[3 * j + 2];
        p_eid[t] = element_id[j];
      } else {
        p_mmin[t] = inf;  // past the end: fails the major test
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + u;
      bool keep = live && i < j && j < n && p_mmin[u] <= a_reach;
      if (ANY_ORDER) keep = keep && a_start <= p_mmax[u];
      if (keep) {
        const V b_lo = p_lo[u], b_hi = p_hi[u];
        keep = a_lo.x <= b_hi.x && b_lo.x <= a_hi.x && a_lo.y <= b_hi.y &&
               b_lo.y <= a_hi.y;
      }
      if (keep && is_two_lists) keep = (a_eid >= 0) != (p_eid[u] >= 0);
      if (keep) {
        const int b0 = p_v0[u], b1 = p_v1[u], b2 = p_v2[u];
        keep = !(a0 == b0 || a0 == b1 || a0 == b2 || a1 == b0 || a1 == b1 ||
                 a1 == b2 || a2 == b0 || a2 == b1 || a2 == b2);
      }
      const unsigned b = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) ballots[warp][u] = b;
    }
    __syncthreads();
    if (t < kChunk) {
      const unsigned w0 = ballots[0][t], w1 = ballots[1][t];
      const unsigned w2 = ballots[2][t], w3 = ballots[3][t];
      if (w0 | w1 | w2 | w3) {
        const unsigned cnt = __popc(w0) + __popc(w1) + __popc(w2) + __popc(w3);
        const unsigned long long slot = atomicAdd(n_records, 1ull);
        atomicAdd(n_pairs, (unsigned long long)cnt);
        if (slot < (unsigned long long)rec_budget) {
          int4* dst = reinterpret_cast<int4*>(records + 8 * (size_t)slot);
          dst[0] = make_int4((int)w0, (int)w1, (int)w2, (int)w3);
          dst[1] = make_int4(j0 + t, r, 0, 0);
        }
      }
    }
  }
}

template <typename T>
void launch(int any_order, int blocks, cudaStream_t s, const void* major_min,
            const void* major_max, const void* minor_min,
            const void* minor_max, const void* vertex_ids,
            const void* element_id, const void* fwd_min, const void* row_umin,
            const void* row_umax, int n, int is_two_lists, void* records,
            long long rec_budget, void* n_records, void* n_pairs) {
  using V = typename Vec2<T>::type;
  if (any_order)
    sweep_records_kernel<T, true><<<blocks, kRow, 0, s>>>(
        (const T*)major_min, (const T*)major_max, (const V*)minor_min,
        (const V*)minor_max, (const int*)vertex_ids, (const int*)element_id,
        (const T*)fwd_min, (const T*)row_umin, (const T*)row_umax, n,
        is_two_lists, (int*)records, rec_budget,
        (unsigned long long*)n_records, (unsigned long long*)n_pairs);
  else
    sweep_records_kernel<T, false><<<blocks, kRow, 0, s>>>(
        (const T*)major_min, (const T*)major_max, (const V*)minor_min,
        (const V*)minor_max, (const int*)vertex_ids, (const int*)element_id,
        nullptr, nullptr, nullptr, n, is_two_lists, (int*)records, rec_budget,
        (unsigned long long*)n_records, (unsigned long long*)n_pairs);
}

}  // namespace

// is_f64: the float planes are double (minor planes 16-byte aligned), else
// float.  fwd_min/row_umin/row_umax are read only with any_order (may be
// null otherwise).  records: (rec_budget, 8) int32, 16-byte aligned.
extern "C" int sccd_sweep_records(const void* major_min, const void* major_max,
                                  const void* minor_min, const void* minor_max,
                                  const void* vertex_ids,
                                  const void* element_id, const void* fwd_min,
                                  const void* row_umin, const void* row_umax,
                                  int n, int is_two_lists, int any_order,
                                  int is_f64, void* records,
                                  long long rec_budget, void* n_records,
                                  void* n_pairs, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRow - 1) / kRow;
  auto s = (cudaStream_t)stream;
  if (is_f64)
    launch<double>(any_order, blocks, s, major_min, major_max, minor_min,
                   minor_max, vertex_ids, element_id, fwd_min, row_umin,
                   row_umax, n, is_two_lists, records, rec_budget, n_records,
                   n_pairs);
  else
    launch<float>(any_order, blocks, s, major_min, major_max, minor_min,
                  minor_max, vertex_ids, element_id, fwd_min, row_umin,
                  row_umax, n, is_two_lists, records, rec_budget, n_records,
                  n_pairs);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_sweep_records_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
