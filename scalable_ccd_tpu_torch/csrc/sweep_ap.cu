// Kernel A: sorted-sweep broad phase with direct pair emission.
//
// Replaces: scalable_ccd_tpu/ops/pallas_sweep_ap.py, _sweep_kernel (pairs
// emission, launched by pallas_sweep_pairs, with its tile0/n_tiles a-side
// range and its any_order mode), itself the TPU form of the reference's
// sweep kernel (src/scalable_ccd/cuda/broad_phase/sweep.cu:101-182).
//
// What bounds it on an H100: memory latency and divergence, not arithmetic.
// Each candidate slot costs a handful of compares against ~36 bytes of
// partner data (major bound, two minor intervals, three vertex ids, element
// id); the bench scene has ~61M slots over both phases and keeps ~0.3% of
// them.  Runs vary in length from box to box, so the lanes of a warp wait for
// the warp's longest run.
//
// Design: one thread per sorted box i walks j = i+1, ... while
// major_min[j] <= major_max[i] (the exact run, since the boxes are sorted by
// major_min).  Neighbouring threads walk neighbouring partners, so the
// partner reads of a warp coalesce and hit L1/L2.  The cheap major and minor
// tests read floats first; the vertex ids are read only for the few slots
// that pass them.  Survivors are rare, so each one takes its slot with one
// atomicAdd on a 64-bit counter: the counter is the exact survivor total
// even past the budget, and a survivor is written only when its slot is
// below the budget.  Row order is therefore nondeterministic; the pair set
// is not.  Making the kernel fast (tiling partners through shared memory,
// warp-aggregated appends, balancing long runs) is later work.
//
// Box range (the TPU kernel's tile0/n_tiles, in boxes instead of 1024-box
// tiles): only sorted boxes i in [box_lo, box_hi) start a run, one thread
// each; partners still cover the whole array, so the union over ranges that
// cover [0, n) is exactly the whole-range pair set.  This is the chunk
// cursor of the chunked ccd() (the reference's thread_start_box_id,
// broad_phase.cu:121-224).  An empty range launches nothing.
//
// any_order (the congestion ordering of sort_boxes(bucket_minor=True), where
// major_min is not sorted): the run stops at the first j with
// fwd_min[j] > major_max[i], fwd_min being the suffix minimum of major_min
// (non-decreasing, so the stop is exact); each slot also tests
// major_min[i] <= major_max[j], which the major sort gives for free and
// without which phantom pairs leak through (pallas_sweep_ap.py:617-623).  At
// the first partner and at every 128-aligned partner row, a row whose union
// of minor axis 0 misses box i's own minor-0 interval is jumped whole: no
// partner in it can pass the minor filter.  Under the congestion ordering a
// row spans a narrow minor band, so most rows of a long run are jumped; that
// is what turns the ordering into saved work (pallas_sweep_ap.py:574-584).
//
// Plain C interface, bound with ctypes (ops/sweep_ap.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <bool ANY_ORDER>
__global__ void sweep_pairs_kernel(
    const float* __restrict__ major_min, const float* __restrict__ major_max,
    const float2* __restrict__ minor_min, const float2* __restrict__ minor_max,
    const int* __restrict__ vertex_ids, const int* __restrict__ element_id,
    const float* __restrict__ fwd_min, const float* __restrict__ row_umin,
    const float* __restrict__ row_umax, int n, int box_lo, int box_hi,
    int is_two_lists, int2* __restrict__ pairs, long long budget,
    unsigned long long* __restrict__ n_true) {
  const int i = box_lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= box_hi) return;
  const float a_reach = major_max[i];
  const float a_start = major_min[i];
  const float2 a_lo = minor_min[i];
  const float2 a_hi = minor_max[i];
  const int a0 = vertex_ids[3 * i + 0];
  const int a1 = vertex_ids[3 * i + 1];
  const int a2 = vertex_ids[3 * i + 2];
  const int a_eid = element_id[i];
  for (int j = i + 1; j < n; ++j) {
    if (ANY_ORDER) {
      if (fwd_min[j] > a_reach) break;
      if ((j & 127) == 0 || j == i + 1) {
        const int r = j >> 7;
        if (row_umin[r] > a_hi.x || row_umax[r] < a_lo.x) {
          j = ((r + 1) << 7) - 1;  // the loop's ++j lands on the next row
          continue;
        }
      }
      if (major_min[j] > a_reach || major_max[j] < a_start) continue;
    } else if (major_min[j] > a_reach) {
      break;
    }
    const float2 b_lo = minor_min[j];
    const float2 b_hi = minor_max[j];
    if (!(a_lo.x <= b_hi.x && b_lo.x <= a_hi.x && a_lo.y <= b_hi.y &&
          b_lo.y <= a_hi.y))
      continue;
    const int b_eid = element_id[j];
    if (is_two_lists && ((a_eid >= 0) == (b_eid >= 0))) continue;
    const int b0 = vertex_ids[3 * j + 0];
    const int b1 = vertex_ids[3 * j + 1];
    const int b2 = vertex_ids[3 * j + 2];
    const bool share = a0 == b0 || a0 == b1 || a0 == b2 || a1 == b0 ||
                       a1 == b1 || a1 == b2 || a2 == b0 || a2 == b1 ||
                       a2 == b2;
    if (share) continue;
    const int lo = min(a_eid, b_eid);
    const int hi = max(a_eid, b_eid);
    const unsigned long long slot = atomicAdd(n_true, 1ull);
    if (slot < (unsigned long long)budget)
      pairs[slot] = make_int2(is_two_lists ? -lo - 1 : lo, hi);
  }
}

}  // namespace

// fwd_min/row_umin/row_umax are read only with any_order (may be null
// otherwise).
extern "C" int sccd_sweep_pairs(const void* major_min, const void* major_max,
                                const void* minor_min, const void* minor_max,
                                const void* vertex_ids, const void* element_id,
                                const void* fwd_min, const void* row_umin,
                                const void* row_umax, int n, int box_lo,
                                int box_hi, int is_two_lists, int any_order,
                                void* pairs, long long budget, void* n_true,
                                void* stream) {
  if (box_hi <= box_lo) return 0;
  const int threads = 256;
  const int blocks = (box_hi - box_lo + threads - 1) / threads;
  auto s = (cudaStream_t)stream;
  if (any_order)
    sweep_pairs_kernel<true><<<blocks, threads, 0, s>>>(
        (const float*)major_min, (const float*)major_max,
        (const float2*)minor_min, (const float2*)minor_max,
        (const int*)vertex_ids, (const int*)element_id, (const float*)fwd_min,
        (const float*)row_umin, (const float*)row_umax, n, box_lo, box_hi,
        is_two_lists, (int2*)pairs, budget, (unsigned long long*)n_true);
  else
    sweep_pairs_kernel<false><<<blocks, threads, 0, s>>>(
        (const float*)major_min, (const float*)major_max,
        (const float2*)minor_min, (const float2*)minor_max,
        (const int*)vertex_ids, (const int*)element_id, nullptr, nullptr,
        nullptr, n, box_lo, box_hi, is_two_lists, (int2*)pairs, budget,
        (unsigned long long*)n_true);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
