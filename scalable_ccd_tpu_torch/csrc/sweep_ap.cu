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
// Plain C interface, bound with ctypes (ops/sweep_ap.py).  The caller
// passes scratch of sccd_sweep_scratch_bytes(box_lo, box_hi) bytes, any
// contents; the kernels allocate nothing.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

using u64 = unsigned long long;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

constexpr unsigned kFull = 0xffffffffu;
// boxes per tile (one warp), partners per row (a unit's partners)
constexpr int kTile = 32;
constexpr int kRow = 128;
// tiles per block of the unit-count launches
constexpr int kScanThreads = 256;
// warps per block of the sweep launch; pairs a warp buffers before a flush
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHitCap = 64;
// grabs a warp makes on average (the grab size follows from the total)
constexpr int kGrabsPerWarp = 8;

// The scratch of one call: the unit prefix per tile, the grab counter, the
// per-block sums of launch 1 and each tile's partner end.
struct Scratch {
  u64* prefix;     // n_tiles + 1
  u64* grab;       // 1
  u64* block_sum;  // n_blocks
  int* tile_end;   // n_tiles
};

inline int tiles_of(int box_lo, int box_hi) {
  return (box_hi - box_lo + kTile - 1) / kTile;
}

inline int scan_blocks_of(int n_tiles) {
  return (n_tiles + kScanThreads - 1) / kScanThreads;
}

inline long long scratch_bytes(int n_tiles) {
  return 8LL * (n_tiles + 2 + scan_blocks_of(n_tiles)) + 4LL * n_tiles;
}

inline Scratch scratch_at(void* base, int n_tiles) {
  u64* p = (u64*)base;
  Scratch s;
  s.prefix = p;
  s.grab = p + n_tiles + 1;
  s.block_sum = s.grab + 1;
  s.tile_end = (int*)(s.block_sum + scan_blocks_of(n_tiles));
  return s;
}

// Inclusive sum of v over the block (blockDim.x == kScanThreads).
__device__ u64 block_inclusive_sum(u64 v) {
  __shared__ u64 warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_total[w] = v;
  __syncthreads();
  u64 before = 0;
  for (int k = 0; k < w; ++k) before += warp_total[k];
  return v + before;
}

template <typename T> struct Boxes {
  const T* major_min;
  const T* major_max;
  const typename Vec2<T>::type* minor_min;
  const typename Vec2<T>::type* minor_max;
  const int* vertex_ids;
  const int* element_id;
  const T* row_umin;  // any_order only
  const T* row_umax;
};

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
  const u64 incl = block_inclusive_sum(units);
  if (t < n_tiles) s.prefix[t + 1] = incl;
  if (threadIdx.x == kScanThreads - 1) s.block_sum[blockIdx.x] = incl;
}

// Launch 2: prefix[t + 1] += the sums of the blocks before t's; prefix[0]
// and the grab counter are zeroed.
__global__ void __launch_bounds__(kScanThreads) unit_prefix_kernel(
    int n_tiles, Scratch s) {
  __shared__ u64 partial[kScanThreads];
  u64 v = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kScanThreads)
    v += s.block_sum[b];
  partial[threadIdx.x] = v;
  __syncthreads();
  for (int half = kScanThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) partial[threadIdx.x] += partial[threadIdx.x + half];
    __syncthreads();
  }
  const int t = blockIdx.x * kScanThreads + threadIdx.x;
  if (t < n_tiles) s.prefix[t + 1] += partial[0];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.prefix[0] = 0;
    *s.grab = 0;
  }
}

// The first k in [lo, hi] with pred(k), for a pred that is monotone
// (false, then true) and true at hi; the warp samples 32 points a round.
template <typename Pred>
__device__ int warp_first(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const unsigned b = __ballot_sync(kFull, pred(min(lo + lane * step, hi)));
    if (!b) {  // every sample below hi is false
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(b) - 1;
    if (f == 0) return lo;
    hi = min(lo + f * step, hi);
    lo += (f - 1) * step + 1;
  }
  return lo;
}

template <typename T> __device__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <typename T> __device__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// A partner's minor intervals, read with one 16-byte load (f32) or two.
template <typename T> struct alignas(4 * sizeof(T)) Minor {
  T lo0, lo1, hi0, hi1;
};

// One warp's copy of a row's partner planes.  Under any_order each slot
// tests both major bounds (major[k] = {major_min, major_max}); under the
// major sort a lane finds where its run ends in the row by binary search
// of major_min, so the slots test only the minor intervals.
template <typename T, bool ANY_ORDER> struct Stage {
  Minor<T> minor[kRow];
  typename Vec2<T>::type major[ANY_ORDER ? kRow : 1];
  T major_min[ANY_ORDER ? 1 : kRow];
  int eid[kRow];
  int vid[3 * kRow];
};

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

  const u64 total = s.prefix[n_tiles];
  const u64 warps = (u64)gridDim.x * kWarps;
  const u64 grab_size = max(1ull, total / (warps * kGrabsPerWarp));

  // the current tile: its index, units [t_lo, t_hi), partner range
  // [begin, end), and this lane's box (i = INT_MAX past box_hi)
  int t = -1, loaded = -1;
  u64 t_lo = 0, t_hi = 0;
  int begin = 0, end = 0, i = 0x7fffffff;
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

  for (;;) {
    u64 base = 0;
    if (lane == 0) base = atomicAdd(s.grab, grab_size);
    base = __shfl_sync(kFull, base, 0);
    if (base >= total) break;
    const u64 stop = min(base + grab_size, total);
    if (base >= t_hi) {
      // a warp's grabs only grow: the tile lies past the current one
      t = warp_first(t + 1, n_tiles - 1, [&](int k) { return s.prefix[k + 1] > base; });
      t_lo = s.prefix[t];
      t_hi = s.prefix[t + 1];
    }
    for (u64 u = base; u < stop;) {
      while (u >= t_hi) {  // tiles of no unit are passed over
        ++t;
        t_lo = t_hi;
        t_hi = s.prefix[t + 1];
      }
      if (t != loaded) {
        loaded = t;
        const int first = box_lo + t * kTile;
        begin = first + 1;
        end = s.tile_end[t];
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
      }
      // this tile's units of the grab, its kept rows [u - t_lo, u_end - t_lo):
      // each lane tests one row of a window of 32 rows, and the warp sweeps
      // the kept ones
      const u64 u_end = min(stop, t_hi);
      int pass = (int)(u - t_lo);  // kept rows of the tile before u
      int todo = (int)(u_end - u);
      const int last_row = (end - 1) / kRow;
      for (int row0 = begin / kRow; todo > 0 && row0 <= last_row; row0 += 32) {
        const int row = row0 + lane;
        bool kept = row <= last_row;
        if constexpr (ANY_ORDER)
          kept = kept && !(__ldg(bx.row_umin + row) > u_hi || __ldg(bx.row_umax + row) < u_lo);
        unsigned rows = __ballot_sync(kFull, kept);
        const int n_kept = __popc(rows);
        if (pass >= n_kept) {
          pass -= n_kept;
          continue;
        }
        for (; pass > 0; --pass) rows &= rows - 1;
        for (; rows && todo > 0; rows &= rows - 1, --todo) {
          const int r = row0 + __ffs(rows) - 1;
          const int j0 = max(r * kRow, begin);
          const int m = min(r * kRow + kRow, end) - j0;

          __syncwarp();  // the previous unit's reads of the stage are done
#pragma unroll
          for (int q = 0; q < kRow / 32; ++q) {
            const int k = lane + 32 * q;
            if (k < m) {
              const int j = j0 + k;
              const V lo = __ldg(bx.minor_min + j), hi = __ldg(bx.minor_max + j);
              st.minor[k] = {lo.x, lo.y, hi.x, hi.y};
              if constexpr (ANY_ORDER)
                st.major[k] = {__ldg(bx.major_min + j), __ldg(bx.major_max + j)};
              else
                st.major_min[k] = __ldg(bx.major_min + j);
              st.eid[k] = __ldg(bx.element_id + j);
              st.vid[3 * k + 0] = __ldg(bx.vertex_ids + 3 * j + 0);
              st.vid[3 * k + 1] = __ldg(bx.vertex_ids + 3 * j + 1);
              st.vid[3 * k + 2] = __ldg(bx.vertex_ids + 3 * j + 2);
            }
          }
          __syncwarp();
          // major sort: box i's run covers the row's partners below `own`
          int own = m;
          if constexpr (!ANY_ORDER) {
            int lo = 0;
            while (lo < own) {
              const int mid = (lo + own) >> 1;
              if (st.major_min[mid] <= a_reach)
                lo = mid + 1;
              else
                own = mid;
            }
          }

          // the row in groups of 32 partners: the box tests of a group
          // set one bit per partner in each lane, branch-free; the list and
          // shared-vertex filters and the append run on the set bits only
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
            unsigned bits = 0;
#pragma unroll
            for (int k = 0; k < 32; ++k) {
              // past cnt the stage holds stale partners: their bits are masked
              const Minor<T> b = st.minor[g + k];
              bool hit = (a_lo.x <= b.hi0) & (b.lo0 <= a_hi.x) & (a_lo.y <= b.hi1) &
                         (b.lo1 <= a_hi.y);
              if constexpr (ANY_ORDER) {
                // box i's own stop and the reverse major test
                const V mj = st.major[g + k];
                hit &= (mj.x <= a_reach) & (a_start <= mj.y);
              }
              bits |= (unsigned)hit << k;
            }
            bits &= valid;
            while (__any_sync(kFull, bits)) {
              bool keep = false;
              int b_eid = 0;
              if (bits) {
                const int k = g + __ffs(bits) - 1;
                bits &= bits - 1;
                b_eid = st.eid[k];
                const int b0 = st.vid[3 * k + 0];
                const int b1 = st.vid[3 * k + 1];
                const int b2 = st.vid[3 * k + 2];
                const bool share = a0 == b0 || a0 == b1 || a0 == b2 || a1 == b0 ||
                                   a1 == b1 || a1 == b2 || a2 == b0 || a2 == b1 ||
                                   a2 == b2;
                keep = !share && !(is_two_lists && ((a_eid >= 0) == (b_eid >= 0)));
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
        }
      }
      u = u_end;
    }
  }
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

// Blocks of the sweep launch: as many as fit on the card at once.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
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
  const Scratch s = scratch_at(scratch, n_tiles);
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
  const int scan_blocks = scan_blocks_of(n_tiles);
  tile_units_kernel<T, ANY_ORDER><<<scan_blocks, kScanThreads, 0, stream>>>(
      bx, stops, n, box_lo, box_hi, n_tiles, s);
  unit_prefix_kernel<<<scan_blocks, kScanThreads, 0, stream>>>(n_tiles, s);
  auto kernel = sweep_units_kernel<T, ANY_ORDER, COUNT_ONLY>;
  static const int blocks = resident_blocks(kernel);
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
  return box_hi > box_lo ? scratch_bytes(tiles_of(box_lo, box_hi)) : 0;
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
