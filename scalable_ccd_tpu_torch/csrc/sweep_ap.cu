// Kernel A: sorted-sweep broad phase with direct pair emission.
//
// Replaces: scalable_ccd_tpu/ops/pallas_sweep_ap.py, _sweep_kernel (pairs
// emission, launched by pallas_sweep_pairs, with its tile0/n_tiles a-side
// range, its any_order mode and its count_only option), itself the TPU form
// of the reference's sweep kernel (src/scalable_ccd/cuda/broad_phase/
// sweep.cu:101-182).
//
// What bounds it on an H100: the compares of the candidate slots, and before
// this design the latency of walking them.  Each slot costs a handful of
// compares against ~36 bytes of partner data (major bound, two minor
// intervals, three vertex ids, element id); the bench scene has ~61M slots
// over both phases and keeps ~0.3% of them.  One thread walking its box's
// whole run (546 slots on average, 2,279 at most on the bench; 47,295 under
// any_order on grid-600) waits on a dependent load per slot along the
// longest run, and one thread per box gives the card too few warps.
//
// Design: work units over a persistent grid, three launches, no host read.
// - A tile is 32 consecutive boxes of the box range, one warp's lanes.  Its
//   partner range is [first + 1, end): end is the first position whose stop
//   (major_min, or fwd_min under any_order; both non-decreasing) exceeds
//   the tile's largest major_max, so every box's run lies inside it.
// - The partner positions are cut at multiples of kRow = 128 into rows
//   (the rows of the any_order planes); a unit is one tile against one row of its range
//   (under any_order, one row the row skip keeps).  Units are numbered tile
//   by tile, so every unit costs about the same.
// - Launch 1 (tile_units_kernel), one thread per tile: the tile's largest
//   major_max, end by binary search, the tile's unit count, and an
//   inclusive scan of the counts over each block of 256 tiles.
// - Launch 2 (unit_prefix_kernel): each block adds the sum of the blocks
//   before it, giving prefix[t], the first unit of tile t (prefix[n_tiles]
//   is the total), and zeroes the grab counter.
// - Launch 3 (sweep_units_kernel): as many blocks as fit on the card at once.
//   Each warp takes G consecutive units from the grab counter (G sized so a
//   warp takes about kGrabsPerWarp grabs), finds their tile by a 32-way
//   search of prefix and their rows by walking the tile's rows 32 at a time
//   (one lane a row, a ballot of those kept), and per unit copies the
//   row's partner planes into its own shared memory, then tests its 32
//   boxes against the row in lockstep: every lane reads the same partner
//   (a broadcast) and applies its own box's tests.  A long run is spread
//   over many warps, a row's slots are independent (no dependent load, no
//   early break), and the partner data comes from shared memory.
// - A row is tested in groups of 32 partners.  The box tests of a group
//   (the minor overlap, one 16-byte shared load per f32 partner) are
//   unrolled and branch-free, each setting one bit of a 32-bit mask per
//   lane; only the set bits, a few percent of the slots, go on to the list
//   and shared-vertex filters and the append.
// - Each box keeps its own stop: partner j is kept only if j > i and
//   major_min[j] <= major_max[i].  With the boxes sorted by major_min these
//   are exactly the positions of box i's run, so the pair set is the
//   one-thread walk's; each lane finds where its run ends in a staged row
//   by binary search, and masks the slots past it.
// - Append: each partner's survivors are ballotted and go to the warp's
//   64-pair buffer in shared memory; a full buffer, and the warp's last, is
//   flushed with one atomicAdd on the 64-bit counter.  The counter is the
//   exact survivor total even past the budget; a pair is written only where
//   its slot is below the budget.  Row order is nondeterministic; the pair
//   set is not.
//
// Box range (the TPU kernel's tile0/n_tiles, in boxes instead of 1024-box
// tiles): tiles are cut from [box_lo, box_hi), so only those boxes start a
// run; partners still cover the whole array, so the union over ranges that
// cover [0, n) is exactly the whole-range pair set.  This is the chunk
// cursor of the chunked ccd() (the reference's thread_start_box_id,
// broad_phase.cu:121-224).  An empty range launches nothing.
//
// any_order (the congestion ordering of sort_boxes(bucket_minor=True), where
// major_min is not sorted): the tile's range ends at the first fwd_min past
// its largest major_max, fwd_min being the suffix minimum of major_min
// (non-decreasing, and no larger than major_min, so past that position
// every partner fails major_min[j] <= major_max[i]).  Each slot also tests
// major_min[i] <= major_max[j], which the major sort gives for free and
// without which phantom pairs leak through (pallas_sweep_ap.py:617-623).  A
// unit is one 128-partner row, and a row whose union of minor axis 0 misses
// the union of the tile's minor-0 intervals is skipped whole: no partner in
// it can pass the minor filter of any box of the tile.  Launch 1 counts
// only the kept rows as units, so a skipped row costs one lane's test and
// the grabs carry even work; in a kept row, a group of 32 partners whose
// minor-0 union (a warp reduction over the stage) misses the tile's is
// skipped the same way.  Under the congestion ordering a row spans a narrow
// minor band, so most rows of a long run are skipped (pallas_sweep_ap.py:
// 574-584).
//
// Scalar type (template T): the planes are float (a box is 40 bytes, the
// minor intervals float2) or double (64 bytes, double2, 16-byte aligned in
// global memory; the staged minor intervals of a partner are 16 or 32
// aligned bytes); the tests are the same compares in either.  The
// pair set of f64 boxes is a subset of the f32 one (f32 boxes are rounded
// outward).
//
// count_only (the TPU kernel's count_only option, pallas_sweep_ap.py:640,
// :1147-1152): the same units and tests, but no pair is written and no
// buffer is passed; only n_true is.  A survivor adds one to a register; the
// counts are summed over the warp with shuffles, over the block through
// shared memory, and the block takes one atomicAdd.  Its time against the
// emitting kernel's is what the append costs.
//
// The unit prefix, the grab loop, the stage and the box tests are shared
// with kernel A' (sweep_common.cuh).  Plain C interface, bound with ctypes
// (ops/sweep_ap.py).  The caller passes scratch of
// sccd_sweep_scratch_bytes(box_lo, box_hi) bytes, any contents; the kernels
// allocate nothing.


#include "sweep_common.cuh"

namespace {

// boxes per tile (one warp)
constexpr int kTile = 32;
// tiles per block of the unit-count launches
constexpr int kScanThreads = 256;
// warps per block of the sweep launch; pairs a warp buffers before a flush
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHitCap = 64;

inline int tiles_of(int box_lo, int box_hi) {
  return (box_hi - box_lo + kTile - 1) / kTile;
}

// Launch 1: per tile, its partner end and unit count (the rows its range
// touches; under any_order the rows kept by the row skip); per block, the
// inclusive scan of the counts (into prefix[t + 1]) and their sum.
template <typename T, bool ANY_ORDER>
__global__ void __launch_bounds__(kScanThreads) tile_units_kernel(
    Boxes<T> bx, const T* __restrict__ stops, int n, int box_lo, int box_hi,
    int n_tiles, Scratch s) {
  const int t = blockIdx.x * kScanThreads + threadIdx.x;
  u64 units = 0;
  if (t < n_tiles) {
    const int first = box_lo + t * kTile;
    const int last = min(first + kTile, box_hi);
    T reach = bx.major_max[first];
    T u_lo = bx.minor_min[first].x, u_hi = bx.minor_max[first].x;
    for (int i = first + 1; i < last; ++i) {
      const T v = bx.major_max[i];
      reach = v > reach ? v : reach;
      if constexpr (ANY_ORDER) {
        const T lo = bx.minor_min[i].x, hi = bx.minor_max[i].x;
        u_lo = lo < u_lo ? lo : u_lo;
        u_hi = hi > u_hi ? hi : u_hi;
      }
    }
    // the first j in [first + 1, n) with stops[j] > reach, else n
    int lo = first + 1, hi = n;
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      if (stops[mid] > reach)
        hi = mid;
      else
        lo = mid + 1;
    }
    s.tile_end[t] = lo;
    const int begin = first + 1;
    if (lo > begin) {
      const int row0 = begin / kRow, row1 = (lo - 1) / kRow;
      if constexpr (ANY_ORDER) {
        for (int r = row0; r <= row1; ++r)
          units += !(bx.row_umin[r] > u_hi || bx.row_umax[r] < u_lo);
      } else {
        units = (u64)(row1 - row0 + 1);
      }
    }
  }
  const u64 incl = block_inclusive_sum<kScanThreads>(units);
  if (t < n_tiles) s.prefix[t + 1] = incl;
  if (threadIdx.x == kScanThreads - 1) s.block_sum[blockIdx.x] = incl;
}

// Launch 3: the units, taken by warps from the grab counter.
template <typename T, bool ANY_ORDER, bool COUNT_ONLY>
__global__ void __launch_bounds__(kThreads) sweep_units_kernel(
    Boxes<T> bx, int box_lo, int box_hi, int is_two_lists, int n_tiles,
    Scratch s, int2* __restrict__ pairs, long long budget,
    u64* __restrict__ n_true) {
  using V = typename Vec2<T>::type;
  __shared__ Stage<T, ANY_ORDER> stages[kWarps];
  __shared__ int2 hit_bufs[kWarps][COUNT_ONLY ? 1 : kHitCap];
  __shared__ u64 warp_count[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stage<T, ANY_ORDER>& st = stages[warp];
  int2* hits = hit_bufs[warp];
  const unsigned lanes_below = (1u << lane) - 1u;

  // this lane's box of the current tile (i = INT_MAX past box_hi) and the
  // tile's minor-0 union
  int i = 0x7fffffff;
  T a_reach = 0, a_start = 0, u_lo = 0, u_hi = 0;
  V a_lo = {}, a_hi = {};
  int a0 = 0, a1 = 0, a2 = 0, a_eid = 0;
  int n_hits = 0;     // pairs in this warp's buffer (the same in every lane)
  unsigned count = 0;  // COUNT_ONLY: this lane's survivors

  auto flush = [&]() {
    __syncwarp();
    u64 slot = 0;
    if (lane == 0) slot = atomicAdd(n_true, (u64)n_hits);
    slot = __shfl_sync(kFull, slot, 0);
    for (int q = lane; q < n_hits; q += 32)
      if (slot + q < (u64)budget) pairs[slot + q] = hits[q];
    __syncwarp();
    n_hits = 0;
  };

  auto load = [&](int t) {
    const int first = box_lo + t * kTile;
    const bool active = first + lane < box_hi;
    i = active ? first + lane : 0x7fffffff;
    if (active) {
      a_reach = __ldg(bx.major_max + i);
      a_start = __ldg(bx.major_min + i);
      a_lo = __ldg(bx.minor_min + i);
      a_hi = __ldg(bx.minor_max + i);
      a0 = __ldg(bx.vertex_ids + 3 * i + 0);
      a1 = __ldg(bx.vertex_ids + 3 * i + 1);
      a2 = __ldg(bx.vertex_ids + 3 * i + 2);
      a_eid = __ldg(bx.element_id + i);
    }
    if constexpr (ANY_ORDER) {
      u_lo = warp_min(active ? a_lo.x : (T)INFINITY);
      u_hi = warp_max(active ? a_hi.x : -(T)INFINITY);
    }
    return TileRange<T>{first + 1, s.tile_end[t], u_lo, u_hi};
  };

  auto unit = [&](int j0, int m) {
    stage_row(st, bx, j0, m);
    // major sort: box i's run covers the row's partners below `own`
    int own = m;
    if constexpr (!ANY_ORDER) own = run_end(st, m, a_reach);

    // the row in groups of 32 partners: the box tests of a group set one
    // bit per partner in each lane, branch-free; the list and shared-vertex
    // filters and the append run on the set bits only
    for (int g = 0; g < m; g += 32) {
      const int jg = j0 + g;
      const int cnt = min(32, m - g);
      if constexpr (ANY_ORDER) {
        // a group whose minor-0 union misses the tile's is skipped
        const T g_lo = warp_min(lane < cnt ? st.minor[g + lane].lo0 : (T)INFINITY);
        const T g_hi = warp_max(lane < cnt ? st.minor[g + lane].hi0 : -(T)INFINITY);
        if (g_lo > u_hi || g_hi < u_lo) continue;
      }
      // partner jg + k counts for box i when k < min(cnt, own - g)
      // and jg + k > i
      const int upto = min(cnt, own - g);
      unsigned valid = upto >= 32 ? kFull : upto > 0 ? (1u << upto) - 1u : 0u;
      const int past = i - jg + 1;  // no overflow: jg >= 1
      if (past > 0) valid = past >= 32 ? 0u : valid & (kFull << past);
      unsigned bits = box_bits(st, g, a_lo, a_hi, a_reach, a_start) & valid;
      while (__any_sync(kFull, bits)) {
        bool keep = false;
        int b_eid = 0;
        if (bits) {
          const int k = g + __ffs(bits) - 1;
          bits &= bits - 1;
          b_eid = st.eid[k];
          keep = keeps(st, k, a0, a1, a2, a_eid, is_two_lists);
        }
        if constexpr (COUNT_ONLY) {
          count += keep;
        } else {
          const unsigned ballot = __ballot_sync(kFull, keep);
          if (ballot) {
            const int k_hits = __popc(ballot);
            if (n_hits + k_hits > kHitCap) flush();
            if (keep) {
              const int lo = min(a_eid, b_eid);
              const int hi = max(a_eid, b_eid);
              hits[n_hits + __popc(ballot & lanes_below)] =
                  make_int2(is_two_lists ? -lo - 1 : lo, hi);
            }
            n_hits += k_hits;
          }
        }
      }
    }
  };

  for_each_unit<ANY_ORDER>(bx, n_tiles, s, load, unit);

  if constexpr (COUNT_ONLY) {
    // a lane counts fewer than 2^32 survivors; the warp's and the block's
    // sums are 64-bit
    u64 sum = count;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFull, sum, off);
    if (lane == 0) warp_count[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      u64 block = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) block += warp_count[w];
      if (block) atomicAdd(n_true, block);
    }
  } else if (n_hits) {
    flush();
  }
}

template <typename T, bool ANY_ORDER, bool COUNT_ONLY>
void launch(cudaStream_t stream, const void* major_min, const void* major_max,
            const void* minor_min, const void* minor_max,
            const void* vertex_ids, const void* element_id,
            const void* fwd_min, const void* row_umin, const void* row_umax,
            int n, int box_lo, int box_hi, int is_two_lists, void* pairs,
            long long budget, void* n_true, void* scratch) {
  using V = typename Vec2<T>::type;
  const int n_tiles = tiles_of(box_lo, box_hi);
  const Scratch s = scratch_at(scratch, n_tiles, kScanThreads);
  Boxes<T> bx;
  bx.major_min = (const T*)major_min;
  bx.major_max = (const T*)major_max;
  bx.minor_min = (const V*)minor_min;
  bx.minor_max = (const V*)minor_max;
  bx.vertex_ids = (const int*)vertex_ids;
  bx.element_id = (const int*)element_id;
  bx.row_umin = ANY_ORDER ? (const T*)row_umin : nullptr;
  bx.row_umax = ANY_ORDER ? (const T*)row_umax : nullptr;
  const T* stops = ANY_ORDER ? (const T*)fwd_min : (const T*)major_min;
  const int scan_blocks = scan_blocks_of(n_tiles, kScanThreads);
  tile_units_kernel<T, ANY_ORDER><<<scan_blocks, kScanThreads, 0, stream>>>(
      bx, stops, n, box_lo, box_hi, n_tiles, s);
  unit_prefix_kernel<kScanThreads><<<scan_blocks, kScanThreads, 0, stream>>>(n_tiles, s);
  auto kernel = sweep_units_kernel<T, ANY_ORDER, COUNT_ONLY>;
  static const int blocks = resident_blocks(kernel, kThreads, 0);
  kernel<<<blocks, kThreads, 0, stream>>>(
      bx, box_lo, box_hi, is_two_lists, n_tiles, s,
      COUNT_ONLY ? nullptr : (int2*)pairs, budget, (u64*)n_true);
}

template <typename T, typename... Args>
void launch_mode(int any_order, int count_only, Args... args) {
  if (any_order) {
    if (count_only)
      launch<T, true, true>(args...);
    else
      launch<T, true, false>(args...);
  } else {
    if (count_only)
      launch<T, false, true>(args...);
    else
      launch<T, false, false>(args...);
  }
}

}  // namespace

// Bytes of scratch that sccd_sweep_pairs needs for the box range.
extern "C" long long sccd_sweep_scratch_bytes(int box_lo, int box_hi) {
  return box_hi > box_lo ? scratch_bytes(tiles_of(box_lo, box_hi), kScanThreads) : 0;
}

// is_f64: the float planes are double (minor planes 16-byte aligned), else
// float.  fwd_min/row_umin/row_umax are read only with any_order (may be
// null otherwise).  count_only: pairs may be null and budget is not read.
// scratch: sccd_sweep_scratch_bytes(box_lo, box_hi) bytes, 8-byte aligned.
extern "C" int sccd_sweep_pairs(const void* major_min, const void* major_max,
                                const void* minor_min, const void* minor_max,
                                const void* vertex_ids, const void* element_id,
                                const void* fwd_min, const void* row_umin,
                                const void* row_umax, int n, int box_lo,
                                int box_hi, int is_two_lists, int any_order,
                                int is_f64, int count_only, void* pairs,
                                long long budget, void* n_true, void* scratch,
                                void* stream) {
  if (box_hi <= box_lo) return 0;
  auto s = (cudaStream_t)stream;
  if (is_f64)
    launch_mode<double>(any_order, count_only, s, major_min, major_max,
                        minor_min, minor_max, vertex_ids, element_id, fwd_min,
                        row_umin, row_umax, n, box_lo, box_hi, is_two_lists,
                        pairs, budget, n_true, scratch);
  else
    launch_mode<float>(any_order, count_only, s, major_min, major_max,
                       minor_min, minor_max, vertex_ids, element_id, fwd_min,
                       row_umin, row_umax, n, box_lo, box_hi, is_two_lists,
                       pairs, budget, n_true, scratch);
  return (int)cudaGetLastError();
}

extern "C" const char* sccd_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
