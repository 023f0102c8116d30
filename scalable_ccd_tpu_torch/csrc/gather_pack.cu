// Kernel C: gather, tolerance, error filter and pack of a run of candidate
// pairs, written straight into kernel B's column layout.
//
// Replaces: the glue the JAX package runs inside its jitted narrow batch
// (scalable_ccd_tpu/pipeline/fused.py, run_solver and run_bounded, which
// gather with narrow_phase/types.py:gather_vf_queries / gather_ee_queries
// and pack with ops/pallas_solver.py:pack_query_rows), XLA-fused code there
// and no Pallas kernel; and, in its records mode, the record decode of
// ops/pallas_sweep_ap.py:decode_records_range (XLA code too).  Its plain
// twins are ops/gather_pack.py:gather_pack_reference (narrow_phase/types.py
// and ops/solver.py:pack_query_rows, transposed) and, for the records mode,
// ops/sweep_records.py:decode_records_range followed by it.
//
// The narrow loop packs a phase's candidates in chunks of up to 2^20 rows,
// one launch per chunk, and kernel B reads each narrow batch as a column
// slice of its chunk (pipeline/narrow.py, the streams); on CUDA at the
// defaults kernel B's pairs source computes a phase of pairs' rows itself
// and this kernel is not launched for them.  Two modes:
// - pairs: row i packs the element-id pair pairs[start + i] (kernel A's
//   buffer);
// - records: row i packs pair p = start + i of kernel A''s record stream:
//   its record r is the first with cum[r] > p (cum the inclusive pair
//   prefix, records_pair_prefix), found by a binary search over [p / 128,
//   min(p, R - 1)] (a record holds 1 to 128 pairs), its bit the (p -
//   cum[r - 1])-th set bit of the record's mask words, its pair (element
//   ids of sorted slots rec[5] * 128 + bit and rec[4]) in the emit
//   convention of broad_phase/sweep.py:emit_pairs; the ids are also written
//   to pairs_out where the caller asks for them.  No cursor: every row finds
//   its record alone, whatever order chunks and batches come in.
//
// What bounds it on an H100: bytes.  A row reads its two ids (8 B; in the
// records mode its record, 32 B, and cum, 8 B, are read about once per
// record) and writes 31 scalars (124 B in float, 248 B in double and for the
// compensated rows); the four points' both-frame endpoints (24 scalars a
// row) are gathered from table rows that many candidates share, so the
// least traffic reads each referenced vertex (6 scalars), face (18) or
// edge (12) row once, and the scenes' tables sit in the 50 MB L2.  About
// 400 operations per row are 10x under the bytes at the card's rates.
// chip_smoke.py (pack_bound) counts the bound from a frame's pairs.
//
// The design aims at that byte bound:
// - one launch packs a whole chunk (up to 2^20 rows) on a grid of as many
//   256-thread blocks as the card holds at once (the occupancy calculator's
//   count times the SMs), each thread walking rows with a 64-bit grid
//   stride, so a phase costs a few launches and not one per 16,384-row
//   batch;
// - a thread reads the ids of its next row before it packs the current one,
//   so each thread keeps two rows' gathers in flight, and the full grid
//   keeps every SM's worth of threads on them;
// - the pair ids are one 8-byte load; table rows come through the read-only
//   path in 16-byte vector loads (csrc/pack_row.cuh);
// - the 31 stores of a row go to 31 columns, so a warp's 32 neighbouring
//   rows write 32 neighbouring words of each column.
// TMA and cp.async are not used: TMA copies tiles of a regular array, and
// these rows are scattered by runtime ids; staging them in shared memory
// with cp.async would add a round trip with no reuse, since each gathered
// row is used by the one thread that loads it.  The latency they would hide
// is hidden by the rows in flight.
//
// Every value is bitwise the plain version's: the row of each pair is
// csrc/pack_row.cuh's pack_row, the expressions and order of operations of
// the plain version, which kernel B's pairs source (csrc/solver.cu, form 1)
// shares, so that a row computed there equals kernel C's bit for bit.
// Three instantiations per mode: float rows, double rows, and the
// compensated rows (float arithmetic, written as double: exact).
// -fmad=false keeps every multiply and add separately rounded, as in the
// plain version.
//
// Plain C interface, bound with ctypes (ops/gather_pack.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "pack_row.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRow = 128;      // sorted boxes per record a-row

// what every row of a launch shares
template <typename T, typename OUT>
struct Pack {
  PackTables<T> t;
  OUT* out;  // column k of row i at out[k * ld + i]
  long long ld;
};

// kernel C's sink: field k of a row at col[k * ld]
template <typename OUT>
struct ColumnSink {
  OUT* col;
  long long ld;
  template <typename T>
  __device__ __forceinline__ void operator()(int k, T v) const {
    col[(size_t)k * ld] = (OUT)v;
  }
};

// the pairs mode: row i is pairs[start + i], one 8-byte load
struct PairIds {
  const int2* pairs;
  long long start;
  __device__ __forceinline__ int2 operator()(long long i) const {
    return __ldg(pairs + start + i);
  }
};

// the records mode: row i is pair start + i of the record stream
struct RecordIds {
  const int4* records;  // record r: words 0-3 at [2r], words 4-7 at [2r + 1]
  long long R;          // rows of the record buffer
  const long long* cum;  // (R,) inclusive pair prefix
  const int* element_id;  // (n_boxes,) of the sorted boxes
  int n_boxes;
  bool two_lists;
  long long start;
  int2* pairs_out;  // (Q, 2) ids of the rows, or null
  __device__ __forceinline__ int2 operator()(long long i) const {
    const long long p = start + i;
    // the first r with cum[r] > p: every record holds 1 to 128 pairs, so
    // it lies in [p / 128, p]
    long long lo = p / kRow, hi = p < R - 1 ? p : R - 1;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) > p) hi = mid;
      else lo = mid + 1;
    }
    const long long r = lo < R ? lo : R - 1;  // lo < R for any p below the pair count
    const long long k = p - (r > 0 ? __ldg(cum + r - 1) : 0);
    const int4 w = __ldg(records + 2 * r);
    const int4 x = __ldg(records + 2 * r + 1);
    // the word holding the k-th set bit, and the set bits before it
    const unsigned w0 = (unsigned)w.x, w1 = (unsigned)w.y, w2 = (unsigned)w.z;
    const long long c0 = __popc(w0), c1 = c0 + __popc(w1), c2 = c1 + __popc(w2);
    int g;
    unsigned word;
    long long before;
    if (k < c0) {
      g = 0, word = w0, before = 0;
    } else if (k < c1) {
      g = 1, word = w1, before = c0;
    } else if (k < c2) {
      g = 2, word = w2, before = c1;
    } else {
      g = 3, word = (unsigned)w.w, before = c2;
    }
    // the position of the kk-th set bit of the word, halving the window
    unsigned kk = (unsigned)(k - before);
    int bit = 0;
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      const unsigned low = word & ((1u << s) - 1u);
      const unsigned n_low = (unsigned)__popc(low);
      if (kk >= n_low) {
        kk -= n_low;
        word >>= s;
        bit += s;
      } else {
        word = low;
      }
    }
    const long long a_slot = (long long)x.y * kRow + g * 32 + bit;
    const int ea = __ldg(element_id + clamp_id((int)a_slot, n_boxes));
    const int eb = __ldg(element_id + clamp_id(x.x, n_boxes));
    const int lo_id = ea < eb ? ea : eb, hi_id = ea < eb ? eb : ea;
    const int2 ab = make_int2(two_lists ? -lo_id - 1 : lo_id, hi_id);
    if (pairs_out) pairs_out[i] = ab;
    return ab;
  }
};

template <typename T, typename OUT, bool IS_VF, typename Ids>
__global__ void __launch_bounds__(kThreads)
    gather_pack_kernel(Ids ids, long long Q, Pack<T, OUT> c) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= Q) return;
  int2 ab = ids(i);
  for (;;) {
    const long long next = i + stride;
    // the next row's ids are in flight while this row packs
    const int2 ab_next = next < Q ? ids(next) : ab;
    pack_row<T, IS_VF>(ab.x, ab.y, c.t, ColumnSink<OUT>{c.out + i, c.ld});
    if (next >= Q) break;
    i = next;
    ab = ab_next;
  }
}

// blocks of one launch: enough for every row, at most what the card holds
// at once
template <typename Kernel>
int grid_for(Kernel kernel, long long Q) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (Q + kThreads - 1) / kThreads;
  return (int)(need < full ? need : full);
}

template <typename T, typename OUT, typename Ids>
void launch(int is_vf, cudaStream_t s, Ids ids, long long Q, const void* vcat, int nv,
            const void* table, int nt, double ms, double co_tol, double k_eps, void* out,
            long long ld) {
  const Pack<T, OUT> c{{(const T*)vcat, nv, (const T*)table, nt, (T)ms, (T)co_tol, (T)k_eps},
                       (OUT*)out, ld};
  if (is_vf) {
    auto kernel = gather_pack_kernel<T, OUT, true, Ids>;
    kernel<<<grid_for(kernel, Q), kThreads, 0, s>>>(ids, Q, c);
  } else {
    auto kernel = gather_pack_kernel<T, OUT, false, Ids>;
    kernel<<<grid_for(kernel, Q), kThreads, 0, s>>>(ids, Q, c);
  }
}

template <typename Ids>
int dispatch(int kind, int is_vf, cudaStream_t s, Ids ids, long long Q, const void* vcat,
             int nv, const void* table, int nt, double ms, double co_tol, double k_eps,
             void* out, long long ld) {
  if (kind == 0)
    launch<float, float>(is_vf, s, ids, Q, vcat, nv, table, nt, ms, co_tol, k_eps, out, ld);
  else if (kind == 1)
    launch<double, double>(is_vf, s, ids, Q, vcat, nv, table, nt, ms, co_tol, k_eps, out,
                           ld);
  else
    launch<float, double>(is_vf, s, ids, Q, vcat, nv, table, nt, ms, co_tol, k_eps, out,
                          ld);
  return (int)cudaGetLastError();
}

bool bad_args(long long Q, long long ld, int kind, int nv, int nt) {
  return Q < 0 || ld < Q || kind < 0 || kind > 2 || nv < 1 || nt < 1;
}

}  // namespace

// The pairs mode.  pairs: int32 (N, 2), 8-byte aligned; rows start .. start
// + Q - 1 are packed.  vcat: (nv, 6) both-frame vertices; table: the face
// table (nt, 18) when is_vf, else the edge table (nt, 12); both in the
// compute type and 16-byte aligned.  kind: 0 float rows, 1 double rows, 2
// compensated (float compute, double rows).  ms, co_tol and k_eps (k * eps
// of the error filter, k = 30 or 28, plus 4 when ms > 0) are exact in the
// compute type.  out: column k of row i at out[k * ld + i], ld >= Q.
// Returns the launch's CUDA error code (0 on success).
extern "C" int sccd_gather_pack(const void* pairs, long long start, long long Q,
                                const void* vcat, int nv, const void* table, int nt,
                                int is_vf, int kind, double ms, double co_tol,
                                double k_eps, void* out, long long ld, void* stream) {
  if (bad_args(Q, ld, kind, nv, nt)) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  return dispatch(kind, is_vf, (cudaStream_t)stream, PairIds{(const int2*)pairs, start}, Q,
                  vcat, nv, table, nt, ms, co_tol, k_eps, out, ld);
}

// The records mode: pairs start .. start + Q - 1 of the record stream, each
// below the stream's pair count.  records: int32 (R, 8), 16-byte aligned;
// cum: int64 (R,), records_pair_prefix; element_id: int32 (n_boxes,) of the
// sorted boxes; the pairs in the emit convention of two lists when is_vf
// (VF), of one list otherwise (EE).  pairs_out: int32 (Q, 2) for the rows'
// ids, or null.  The rest as for sccd_gather_pack.
extern "C" int sccd_gather_pack_records(const void* records, long long R, const void* cum,
                                        const void* element_id, int n_boxes,
                                        long long start, long long Q, const void* vcat,
                                        int nv, const void* table, int nt, int is_vf,
                                        int kind, double ms, double co_tol, double k_eps,
                                        void* out, long long ld, void* pairs_out,
                                        void* stream) {
  if (bad_args(Q, ld, kind, nv, nt) || start < 0 || (Q > 0 && (R < 1 || n_boxes < 1)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const RecordIds ids{(const int4*)records, R, (const long long*)cum,
                      (const int*)element_id, n_boxes, is_vf != 0, start,
                      (int2*)pairs_out};
  return dispatch(kind, is_vf, (cudaStream_t)stream, ids, Q, vcat, nv, table, nt, ms,
                  co_tol, k_eps, out, ld);
}

extern "C" const char* sccd_gather_pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
