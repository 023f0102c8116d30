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
// What bounds it on an H100: the candidate slots, as for kernel A (a
// handful of compares per slot against partner data in shared memory),
// plus one 32-byte record per (partner, a-row) with a survivor instead of
// 8 bytes per pair: on congested scenes a record carries several pairs, so
// fewer bytes leave the kernel.
//
// Design: kernel A's work units and persistent grid (sweep_common.cuh),
// with the record's a-row as the tile.  A record can only be formed where
// all 128 boxes of its a-row meet its partner, so the unit is one a-row
// against one 128-partner row: each (j, r) arises in exactly one unit and
// leaves it whole.  Three launches, no host read:
// - Launch 1 (record_units_kernel), one warp per a-row: the a-row's largest
//   major_max and minor-0 union, its partner end by a 32-way search of the
//   stops (major_min, or fwd_min under any_order), its unit count (the rows
//   of [128 r + 1, end); under any_order the rows the row skip keeps), and
//   an inclusive scan of the counts over each block of 32 a-rows.
// - Launch 2 (unit_prefix_kernel): the block offsets; prefix[r] is the first
//   unit of a-row r, and the grab counter is zeroed.
// - Launch 3 (sweep_records_kernel): as many blocks as fit on the card.
//   Each warp grabs units (for_each_unit), keeps the current a-row's 128
//   boxes in its shared memory (with each 32-box sub-tile's minor-0 union)
//   and per unit stages the partner row.  The row is tested in groups of
//   32 partners; per group, each sub-tile of 32 boxes (one lane a box)
//   whose minor-0 union meets the group's and whose lanes have a partner in
//   their run tests the group branch-free into one 32-bit mask per lane
//   (the major sort: j > i and j below the lane's own run end, found by
//   binary search of the staged row; any_order: j > i and both major
//   tests).  The list and shared-vertex filters run on the set bits only.
// - Transpose: for each partner u with a bit in any lane,
//   __ballot_sync(bit u of the lane's mask) is the record word of partner u
//   and this sub-tile; lane u keeps it, so after the four sub-tiles lane u
//   holds the whole record (w0..w3, j0 + 32 g + u, r) in registers.  No
//   block barrier is needed.
// - Append: the warp's non-empty records go to its buffer of 64 records in
//   shared memory; a full buffer, and the warp's last, is flushed with one
//   atomicAdd on the 64-bit record counter and one on the pair counter (the
//   buffer's popcounts, summed over the warp).  Both totals are exact even
//   past the budgets; a record is written only where its slot is below
//   rec_budget.  Record order is nondeterministic; the record multiset is
//   not.
//
// Row range (the TPU kernel's tile0/n_tiles, in 128-box a-rows instead of
// 1024-box tiles): only the a-rows [row_lo, row_hi) form records.  Launch 1
// has one warp per a-row of the range, the unit prefix and the partner ends
// are indexed from row_lo, and the persistent grid takes only those units;
// partners still run to the end of the array, and a record keeps its
// absolute a-row r, so the union over ranges that cover every a-row is the
// whole record multiset and the decode is unchanged.  This is the range
// shard of the multi-device path (parallel/sharded.py).  The whole array is
// the range [0, ceil(n / 128)); an empty range launches nothing.
//
// Scalar type (template T): float or double planes, as in kernel A.  The
// records hold positions and bits, no floats, so their format and decode do
// not depend on T.  A warp's shared memory (partner stage, a-row, record
// buffer) is 11-12 KB in float and 16-19 KB in double, taken as dynamic
// shared memory for the 4-warp blocks: 3-5 blocks fit on an H100's SM.
//
// Plain C interface, bound with ctypes (ops/sweep_records.py).  The caller
// passes scratch of sccd_sweep_records_scratch_bytes(n) bytes, any
// contents; the kernels allocate nothing.

#include "sweep_common.cuh"

namespace {

// a-rows per block of launch 1 (one warp each)
constexpr int kRowsPerBlock = 32;
// warps per block of the sweep launch; records a warp buffers before a flush
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRecCap = 64;
constexpr int kSubTiles = kRow / 32;

inline int rows_of(int n) { return (n + kRow - 1) / kRow; }

// v[q] and v[q] = x for a runtime q, by static indices (v stays in registers)
template <typename X> __device__ __forceinline__ X pick(const X (&v)[kSubTiles], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}
template <typename X> __device__ __forceinline__ void put(X (&v)[kSubTiles], int q, X x) {
  v[0] = q == 0 ? x : v[0];
  v[1] = q == 1 ? x : v[1];
  v[2] = q == 2 ? x : v[2];
  v[3] = q == 3 ? x : v[3];
}

// Launch 1: per a-row (warp) of the range, its partner end and unit count;
// per block, the inclusive scan of the counts (into prefix[t + 1], t the
// a-row's index in the range) and their sum.
template <typename T, bool ANY_ORDER>
__global__ void __launch_bounds__(32 * kRowsPerBlock) record_units_kernel(
    Boxes<T> bx, const T* __restrict__ stops, int n, int row_lo, int n_rows, Scratch s) {
  __shared__ u64 counts[kRowsPerBlock];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = blockIdx.x * kRowsPerBlock + w;
  u64 units = 0;
  if (t < n_rows) {  // the whole warp
    const int first = (row_lo + t) * kRow;
    T reach = -(T)INFINITY, u_lo = (T)INFINITY, u_hi = -(T)INFINITY;
#pragma unroll
    for (int q = 0; q < kSubTiles; ++q) {
      const int i = first + 32 * q + lane;
      if (i < n) {
        const T v = bx.major_max[i];
        reach = v > reach ? v : reach;
        if constexpr (ANY_ORDER) {
          const T lo = bx.minor_min[i].x, hi = bx.minor_max[i].x;
          u_lo = lo < u_lo ? lo : u_lo;
          u_hi = hi > u_hi ? hi : u_hi;
        }
      }
    }
    reach = warp_max(reach);
    if constexpr (ANY_ORDER) {
      u_lo = warp_min(u_lo);
      u_hi = warp_max(u_hi);
    }
    // the first j in [first + 1, n) with stops[j] > reach, else n
    const int begin = first + 1;
    const int end = warp_first(begin, n, [&](int k) { return k >= n || stops[k] > reach; });
    if (lane == 0) s.tile_end[t] = end;
    if (end > begin) {
      const int row0 = begin / kRow, row1 = (end - 1) / kRow;
      if constexpr (ANY_ORDER) {
        for (int p0 = row0; p0 <= row1; p0 += 32) {
          const int p = p0 + lane;
          const bool kept = p <= row1 && !(bx.row_umin[p] > u_hi || bx.row_umax[p] < u_lo);
          units += __popc(__ballot_sync(kFull, kept));
        }
      } else {
        units = (u64)(row1 - row0 + 1);
      }
    }
  }
  if (lane == 0) counts[w] = units;
  __syncthreads();
  if (w == 0) {
    u64 v = counts[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 o = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += o;
    }
    const int rr = blockIdx.x * kRowsPerBlock + lane;
    if (rr < n_rows) s.prefix[rr + 1] = v;
    if (lane == 31) s.block_sum[blockIdx.x] = v;
  }
}

// A warp's copy of its current a-row: lane-indexed boxes 32 q + lane of
// sub-tile q, dead lanes (past n) with inverted bounds, and each sub-tile's
// minor-0 union.
template <typename T, bool ANY_ORDER> struct ARow {
  Minor<T> minor[kRow];
  T reach[kRow];
  T start[ANY_ORDER ? kRow : 1];
  int eid[kRow];
  int vid[3 * kRow];
  T sub_lo[kSubTiles], sub_hi[kSubTiles];
};

template <typename T, bool ANY_ORDER> struct WarpSmem {
  Stage<T, ANY_ORDER> st;
  ARow<T, ANY_ORDER> a;
  int4 buf[kRecCap][2];
};

// Launch 3: the units, taken by warps from the grab counter.
template <typename T, bool ANY_ORDER>
__global__ void __launch_bounds__(kThreads) sweep_records_kernel(
    Boxes<T> bx, int n, int is_two_lists, int row_lo, int n_rows, Scratch s,
    int4* __restrict__ records, long long rec_budget, u64* __restrict__ n_records,
    u64* __restrict__ n_pairs) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(32) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpSmem<T, ANY_ORDER>& ws = reinterpret_cast<WarpSmem<T, ANY_ORDER>*>(smem)[warp];
  Stage<T, ANY_ORDER>& st = ws.st;
  ARow<T, ANY_ORDER>& a = ws.a;
  const unsigned lanes_below = (1u << lane) - 1u;

  int r = 0, first = 0, n_sub = 0;  // the current a-row, its first box, live sub-tiles
  int n_buf = 0;        // records in this warp's buffer (the same in every lane)
  unsigned pairs = 0;   // this lane's pairs in the buffer

  auto flush = [&]() {
    __syncwarp();
    u64 sum = pairs;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(kFull, sum, off);
    u64 slot = 0;
    if (lane == 0) {
      slot = atomicAdd(n_records, (u64)n_buf);
      atomicAdd(n_pairs, sum);
    }
    slot = __shfl_sync(kFull, slot, 0);
    const int4* buf = &ws.buf[0][0];
    for (int q = lane; q < 2 * n_buf; q += 32)
      if (slot + q / 2 < (u64)rec_budget) records[2 * slot + q] = buf[q];
    __syncwarp();
    n_buf = 0;
    pairs = 0;
  };

  auto load = [&](int t) {
    r = row_lo + t;
    first = r * kRow;
    n_sub = min(kSubTiles, (n - first + 31) / 32);
    T u_lo = (T)INFINITY, u_hi = -(T)INFINITY;
    __syncwarp();  // the previous a-row's reads are done
#pragma unroll
    for (int q = 0; q < kSubTiles; ++q) {
      const int k = 32 * q + lane, i = first + k;
      Minor<T> mi = {(T)INFINITY, (T)INFINITY, -(T)INFINITY, -(T)INFINITY};
      T reach = -(T)INFINITY;
      if (i < n) {
        const V lo = __ldg(bx.minor_min + i), hi = __ldg(bx.minor_max + i);
        mi = {lo.x, lo.y, hi.x, hi.y};
        reach = __ldg(bx.major_max + i);
        if constexpr (ANY_ORDER) a.start[k] = __ldg(bx.major_min + i);
        a.eid[k] = __ldg(bx.element_id + i);
        a.vid[3 * k + 0] = __ldg(bx.vertex_ids + 3 * i + 0);
        a.vid[3 * k + 1] = __ldg(bx.vertex_ids + 3 * i + 1);
        a.vid[3 * k + 2] = __ldg(bx.vertex_ids + 3 * i + 2);
      }
      a.minor[k] = mi;
      a.reach[k] = reach;
      const T lo = warp_min(mi.lo0), hi = warp_max(mi.hi0);
      if (lane == 0) {
        a.sub_lo[q] = lo;
        a.sub_hi[q] = hi;
      }
      u_lo = lo < u_lo ? lo : u_lo;
      u_hi = hi > u_hi ? hi : u_hi;
    }
    __syncwarp();
    return TileRange<T>{first + 1, s.tile_end[t], u_lo, u_hi};
  };

  auto unit = [&](int j0, int m) {
    stage_row(st, bx, j0, m);
    // major sort: each sub-tile's lane keeps the row's partners below its
    // own run end
    int own[kSubTiles] = {m, m, m, m};
    if constexpr (!ANY_ORDER) {
#pragma unroll
      for (int q = 0; q < kSubTiles; ++q) own[q] = run_end(st, m, a.reach[32 * q + lane]);
    }

    for (int g = 0; g < m; g += 32) {
      const int jg = j0 + g;
      const int cnt = min(32, m - g);
      const T g_lo = warp_min(lane < cnt ? st.minor[g + lane].lo0 : (T)INFINITY);
      const T g_hi = warp_max(lane < cnt ? st.minor[g + lane].hi0 : -(T)INFINITY);
      unsigned word[kSubTiles] = {};  // lane u: the record words of partner jg + u
      // the major sort unrolls the sub-tiles; any_order's larger tests run
      // as one copy (unrolled, its sweeps ran 19-39% slower on an H100 and
      // the major sort's 3-8% faster); own and word are picked by static
      // index, so they stay in registers either way
#pragma unroll (ANY_ORDER ? 1 : kSubTiles)
      for (int q = 0; q < kSubTiles; ++q) {
        // a sub-tile past n, or whose minor-0 union misses the group's,
        // holds no survivor
        if (q >= n_sub || g_lo > a.sub_hi[q] || g_hi < a.sub_lo[q]) continue;
        const int k_a = 32 * q + lane;
        const int i = first + k_a;
        // partner jg + k counts for box i when k < min(cnt, own - g) and
        // jg + k > i; lanes past n have no such k
        const int upto = min(cnt, pick(own, q) - g);
        unsigned valid = upto >= 32 ? kFull : upto > 0 ? (1u << upto) - 1u : 0u;
        const int past = i - jg + 1;
        if (past > 0) valid = past >= 32 ? 0u : valid & (kFull << past);
        if (!__any_sync(kFull, valid)) continue;
        const Minor<T> mi = a.minor[k_a];
        T a_start = 0;
        if constexpr (ANY_ORDER) a_start = a.start[k_a];
        unsigned bits = valid & box_bits(st, g, V{mi.lo0, mi.lo1}, V{mi.hi0, mi.hi1},
                                         a.reach[k_a], a_start);
        if (bits) {
          const int a0 = a.vid[3 * k_a + 0], a1 = a.vid[3 * k_a + 1], a2 = a.vid[3 * k_a + 2];
          const int a_eid = a.eid[k_a];
          for (unsigned todo = bits; todo; todo &= todo - 1) {
            const int k = __ffs(todo) - 1;
            if (!keeps(st, g + k, a0, a1, a2, a_eid, is_two_lists)) bits &= ~(1u << k);
          }
        }
        // transpose: bit l of partner u's word is bit u of lane l's mask
        for (unsigned us = __reduce_or_sync(kFull, bits); us; us &= us - 1) {
          const int u = __ffs(us) - 1;
          const unsigned b = __ballot_sync(kFull, (bits >> u) & 1u);
          if (lane == u) put(word, q, b);
        }
      }
      const bool has = (word[0] | word[1] | word[2] | word[3]) != 0;
      const unsigned ballot = __ballot_sync(kFull, has);
      if (!ballot) continue;
      const int k_recs = __popc(ballot);
      if (n_buf + k_recs > kRecCap) flush();
      if (has) {
        const int pos = n_buf + __popc(ballot & lanes_below);
        ws.buf[pos][0] = make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
        ws.buf[pos][1] = make_int4(jg + lane, r, 0, 0);
        pairs += __popc(word[0]) + __popc(word[1]) + __popc(word[2]) + __popc(word[3]);
      }
      n_buf += k_recs;
    }
  };

  for_each_unit<ANY_ORDER>(bx, n_rows, s, load, unit);
  if (n_buf) flush();
}

// The sweep launch's grid: as many blocks as fit on the card, each with
// `smem` bytes of dynamic shared memory (above 48 KB only on request).
template <typename T, bool ANY_ORDER>
int sweep_grid(size_t* smem) {
  auto kernel = sweep_records_kernel<T, ANY_ORDER>;
  *smem = kWarps * sizeof(WarpSmem<T, ANY_ORDER>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  static const int blocks = resident_blocks(kernel, kThreads, *smem);
  (void)attr;
  return blocks;
}

template <typename T, bool ANY_ORDER>
void launch(cudaStream_t stream, const void* major_min, const void* major_max,
            const void* minor_min, const void* minor_max, const void* vertex_ids,
            const void* element_id, const void* fwd_min, const void* row_umin,
            const void* row_umax, int n, int row_lo, int row_hi, int is_two_lists,
            void* records, long long rec_budget, void* n_records, void* n_pairs,
            void* scratch) {
  using V = typename Vec2<T>::type;
  const int n_rows = row_hi - row_lo;
  const Scratch s = scratch_at(scratch, n_rows, kRowsPerBlock);
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
  const int scan_blocks = scan_blocks_of(n_rows, kRowsPerBlock);
  record_units_kernel<T, ANY_ORDER><<<scan_blocks, 32 * kRowsPerBlock, 0, stream>>>(
      bx, stops, n, row_lo, n_rows, s);
  unit_prefix_kernel<kRowsPerBlock><<<scan_blocks, kRowsPerBlock, 0, stream>>>(n_rows, s);
  size_t smem = 0;
  const int blocks = sweep_grid<T, ANY_ORDER>(&smem);
  sweep_records_kernel<T, ANY_ORDER><<<blocks, kThreads, smem, stream>>>(
      bx, n, is_two_lists, row_lo, n_rows, s, (int4*)records, rec_budget, (u64*)n_records,
      (u64*)n_pairs);
}

template <typename T, typename... Args>
void launch_mode(int any_order, Args... args) {
  if (any_order)
    launch<T, true>(args...);
  else
    launch<T, false>(args...);
}

}  // namespace

// Bytes of scratch that sccd_sweep_records needs for the a-rows [row_lo, row_hi).
extern "C" long long sccd_sweep_records_scratch_bytes(int row_lo, int row_hi) {
  return row_hi > row_lo ? scratch_bytes(row_hi - row_lo, kRowsPerBlock) : 0;
}

// is_f64: the float planes are double (minor planes 16-byte aligned), else
// float.  fwd_min/row_umin/row_umax are read only with any_order (may be
// null otherwise).  [row_lo, row_hi): the a-rows that form records, within
// [0, ceil(n / 128)).  records: (rec_budget, 8) int32, 16-byte aligned.
// scratch: sccd_sweep_records_scratch_bytes(row_lo, row_hi) bytes, 8-byte
// aligned.
extern "C" int sccd_sweep_records(const void* major_min, const void* major_max,
                                  const void* minor_min, const void* minor_max,
                                  const void* vertex_ids, const void* element_id,
                                  const void* fwd_min, const void* row_umin,
                                  const void* row_umax, int n, int row_lo, int row_hi,
                                  int is_two_lists, int any_order, int is_f64,
                                  void* records, long long rec_budget, void* n_records,
                                  void* n_pairs, void* scratch, void* stream) {
  if (row_lo < 0 || row_hi > rows_of(n)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || row_hi <= row_lo) return 0;
  auto s = (cudaStream_t)stream;
  if (is_f64)
    launch_mode<double>(any_order, s, major_min, major_max, minor_min, minor_max,
                        vertex_ids, element_id, fwd_min, row_umin, row_umax, n, row_lo,
                        row_hi, is_two_lists, records, rec_budget, n_records, n_pairs,
                        scratch);
  else
    launch_mode<float>(any_order, s, major_min, major_max, minor_min, minor_max,
                       vertex_ids, element_id, fwd_min, row_umin, row_umax, n, row_lo,
                       row_hi, is_two_lists, records, rec_budget, n_records, n_pairs,
                       scratch);
  return (int)cudaGetLastError();
}

// The sweep launch's blocks on the current device, and its dynamic shared
// memory per block in *smem_bytes (for reports; launches compute the same).
extern "C" int sccd_sweep_records_grid(int is_f64, int any_order, long long* smem_bytes) {
  size_t smem = 0;
  int blocks = 0;
  if (is_f64)
    blocks = any_order ? sweep_grid<double, true>(&smem) : sweep_grid<double, false>(&smem);
  else
    blocks = any_order ? sweep_grid<float, true>(&smem) : sweep_grid<float, false>(&smem);
  *smem_bytes = (long long)smem;
  return blocks;
}

extern "C" const char* sccd_sweep_records_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
