// Kernel A: sorted-sweep broad phase with direct pair emission.
//
// Replaces: scalable_ccd_tpu/ops/pallas_sweep_ap.py, _sweep_kernel (pairs
// emission, launched by pallas_sweep_pairs), itself the TPU form of the
// reference's sweep kernel (src/scalable_ccd/cuda/broad_phase/sweep.cu:101-182).
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
// Plain C interface, bound with ctypes (ops/sweep_ap.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void sweep_pairs_kernel(
    const float* __restrict__ major_min, const float* __restrict__ major_max,
    const float2* __restrict__ minor_min, const float2* __restrict__ minor_max,
    const int* __restrict__ vertex_ids, const int* __restrict__ element_id,
    int n, int is_two_lists, int2* __restrict__ pairs, long long budget,
    unsigned long long* __restrict__ n_true) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a_reach = major_max[i];
  const float2 a_lo = minor_min[i];
  const float2 a_hi = minor_max[i];
  const int a0 = vertex_ids[3 * i + 0];
  const int a1 = vertex_ids[3 * i + 1];
  const int a2 = vertex_ids[3 * i + 2];
  const int a_eid = element_id[i];
  for (int j = i + 1; j < n && major_min[j] <= a_reach; ++j) {
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

extern "C" int sccd_sweep_pairs(const void* major_min, const void* major_max,
                                const void* minor_min, const void* minor_max,
                                const void* vertex_ids, const void* element_id,
                                int n, int is_two_lists, void* pairs,
                                long long budget, void* n_true, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  sweep_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)major_min, (const float*)major_max,
      (const float2*)minor_min, (const float2*)minor_max,
      (const int*)vertex_ids, (const int*)element_id, n, is_two_lists,
      (int2*)pairs, budget, (unsigned long long*)n_true);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
