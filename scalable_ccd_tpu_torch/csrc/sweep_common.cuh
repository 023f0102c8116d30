// The pieces that kernel A (sweep_ap.cu) and kernel A' (sweep_records.cu)
// share: the box planes, the unit prefix and its scratch, the grab loop of
// the persistent grid, a warp's stage of one 128-partner row, and the box
// tests of a group of 32 partners.
//
// Both kernels cut the sorted boxes into a-side tiles (kernel A: 32 boxes,
// kernel A': the 128-box a-row of a record), give each tile the partner
// range [first + 1, end), end the first position whose stop passes the
// tile's largest major_max, and cut that range at multiples of kRow into
// rows; a unit is one tile against one row (under any_order, one row the
// row skip keeps).  Launch 1 of each kernel counts a tile's units and scans
// the counts per block; unit_prefix_kernel adds the block offsets; the
// sweep's warps take units from a device counter (for_each_unit).
//
// Included by one .cu file each; everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

using u64 = unsigned long long;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

constexpr unsigned kFull = 0xffffffffu;
// partners per row (a unit's partners; the rows of the any_order planes)
constexpr int kRow = 128;
// grabs a warp makes on average (the grab size follows from the total)
constexpr int kGrabsPerWarp = 8;

// The scratch of one call: the unit prefix per tile, the grab counter, the
// per-block sums of launch 1 and each tile's partner end.
struct Scratch {
  u64* prefix;     // n_tiles + 1
  u64* grab;       // 1
  u64* block_sum;  // one per block of launch 1
  int* tile_end;   // n_tiles
};

// Blocks of launch 1 when it scans `per_block` tiles a block.
inline int scan_blocks_of(int n_tiles, int per_block) {
  return (n_tiles + per_block - 1) / per_block;
}

inline long long scratch_bytes(int n_tiles, int per_block) {
  return 8LL * (n_tiles + 2 + scan_blocks_of(n_tiles, per_block)) + 4LL * n_tiles;
}

inline Scratch scratch_at(void* base, int n_tiles, int per_block) {
  u64* p = (u64*)base;
  Scratch s;
  s.prefix = p;
  s.grab = p + n_tiles + 1;
  s.block_sum = s.grab + 1;
  s.tile_end = (int*)(s.block_sum + scan_blocks_of(n_tiles, per_block));
  return s;
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

// Inclusive sum of v over the block (blockDim.x == kThreads).
template <int kThreads>
__device__ u64 block_inclusive_sum(u64 v) {
  __shared__ u64 warp_total[kThreads / 32];
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

// Launch 2, blocks of kThreads == the tiles per block of launch 1:
// prefix[t + 1] += the sums of the blocks before t's; prefix[0] and the
// grab counter are zeroed.
template <int kThreads>
__global__ void __launch_bounds__(kThreads) unit_prefix_kernel(int n_tiles, Scratch s) {
  __shared__ u64 partial[kThreads];
  u64 v = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads) v += s.block_sum[b];
  partial[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) partial[threadIdx.x] += partial[threadIdx.x + half];
    __syncthreads();
  }
  const int t = blockIdx.x * kThreads + threadIdx.x;
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

// A tile's partner range [begin, end) and, under any_order, the union of
// its boxes' minor-0 intervals.
template <typename T> struct TileRange {
  int begin, end;
  T u_lo, u_hi;
};

// The grab loop of a persistent grid's warp: takes runs of units from the
// grab counter until none is left and calls unit(j0, m) for each, m
// partners from position j0, in order.  Before the first unit of a tile,
// load(t) returns the tile's TileRange (the caller loads its boxes there).
// A warp's grabs only grow, so its tiles do too.
template <bool ANY_ORDER, typename T, typename Load, typename Unit>
__device__ __forceinline__ void for_each_unit(const Boxes<T>& bx, int n_tiles, const Scratch& s,
                                              Load load, Unit unit) {
  const int lane = threadIdx.x & 31;
  const u64 total = s.prefix[n_tiles];
  const u64 warps = (u64)gridDim.x * (blockDim.x / 32);
  const u64 grab_size = max(1ull, total / (warps * kGrabsPerWarp));

  // the current tile: its index, units [t_lo, t_hi) and range
  int t = -1, loaded = -1;
  u64 t_lo = 0, t_hi = 0;
  TileRange<T> tr = {};
  for (;;) {
    u64 base = 0;
    if (lane == 0) base = atomicAdd(s.grab, grab_size);
    base = __shfl_sync(kFull, base, 0);
    if (base >= total) break;
    const u64 stop = min(base + grab_size, total);
    if (base >= t_hi) {
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
        tr = load(t);
      }
      // this tile's units of the grab, its kept rows [u - t_lo, u_end - t_lo):
      // each lane tests one row of a window of 32 rows, and the warp sweeps
      // the kept ones
      const u64 u_end = min(stop, t_hi);
      int pass = (int)(u - t_lo);  // kept rows of the tile before u
      int todo = (int)(u_end - u);
      const int last_row = (tr.end - 1) / kRow;
      for (int row0 = tr.begin / kRow; todo > 0 && row0 <= last_row; row0 += 32) {
        const int row = row0 + lane;
        bool kept = row <= last_row;
        if constexpr (ANY_ORDER)
          kept = kept && !(__ldg(bx.row_umin + row) > tr.u_hi ||
                           __ldg(bx.row_umax + row) < tr.u_lo);
        unsigned rows = __ballot_sync(kFull, kept);
        const int n_kept = __popc(rows);
        if (pass >= n_kept) {
          pass -= n_kept;
          continue;
        }
        for (; pass > 0; --pass) rows &= rows - 1;
        for (; rows && todo > 0; rows &= rows - 1, --todo) {
          const int r = row0 + __ffs(rows) - 1;
          const int j0 = max(r * kRow, tr.begin);
          unit(j0, min(r * kRow + kRow, tr.end) - j0);
        }
      }
      u = u_end;
    }
  }
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

// Copies partners [j0, j0 + m) into the warp's stage.
template <typename T, bool ANY_ORDER>
__device__ __forceinline__ void stage_row(Stage<T, ANY_ORDER>& st, const Boxes<T>& bx, int j0,
                                          int m) {
  using V = typename Vec2<T>::type;
  const int lane = threadIdx.x & 31;
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
}

// Major sort: the first k in [0, m) whose staged major_min exceeds reach,
// else m: box i's run covers the row's partners below it.
template <typename T, bool ANY_ORDER>
__device__ __forceinline__ int run_end(const Stage<T, ANY_ORDER>& st, int m, T reach) {
  int lo = 0, own = m;
  while (lo < own) {
    const int mid = (lo + own) >> 1;
    if (st.major_min[mid] <= reach)
      lo = mid + 1;
    else
      own = mid;
  }
  return own;
}

// The box tests of one lane's box against staged partners g .. g + 31, one
// bit each, branch-free: the minor overlaps and, under any_order, the box's
// own stop and the reverse major test.  Past the row's end the stage holds
// stale partners: the caller masks their bits.
template <typename T, bool ANY_ORDER>
__device__ __forceinline__ unsigned box_bits(const Stage<T, ANY_ORDER>& st, int g,
                                             typename Vec2<T>::type a_lo,
                                             typename Vec2<T>::type a_hi, T a_reach,
                                             T a_start) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const Minor<T> b = st.minor[g + k];
    bool hit = (a_lo.x <= b.hi0) & (b.lo0 <= a_hi.x) & (a_lo.y <= b.hi1) & (b.lo1 <= a_hi.y);
    if constexpr (ANY_ORDER) {
      const typename Vec2<T>::type mj = st.major[g + k];
      hit &= (mj.x <= a_reach) & (a_start <= mj.y);
    }
    bits |= (unsigned)hit << k;
  }
  return bits;
}

// The list and shared-vertex filters of a box (vertex ids a0..a2, element
// id a_eid) against staged partner k.
template <typename T, bool ANY_ORDER>
__device__ __forceinline__ bool keeps(const Stage<T, ANY_ORDER>& st, int k, int a0, int a1,
                                      int a2, int a_eid, int is_two_lists) {
  const int b0 = st.vid[3 * k + 0], b1 = st.vid[3 * k + 1], b2 = st.vid[3 * k + 2];
  const bool share = a0 == b0 || a0 == b1 || a0 == b2 || a1 == b0 || a1 == b1 || a1 == b2 ||
                     a2 == b0 || a2 == b1 || a2 == b2;
  return !share && !(is_two_lists && ((a_eid >= 0) == (st.eid[k] >= 0)));
}

// Blocks of a persistent launch: as many as fit on the card at once.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t dynamic_smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dynamic_smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace
