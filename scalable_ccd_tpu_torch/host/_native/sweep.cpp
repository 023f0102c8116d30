// Host (CPU) broad phase: conservative box building + parallel sort-and-sweep.
//
// The PyTorch port's copy of scalable_ccd_tpu/host/_native/sweep.cpp, with
// the same C ABI: the native sibling of the sweep kernels, playing the role
// of the reference's CPU broad phase
// (src/scalable_ccd/broad_phase/{aabb,sort_and_sweep}.cpp, which use TBB).
// A plain C ABI + std::thread, so it loads via ctypes with no build-system
// or third-party dependencies.
//
// Semantics (kept identical to the device sweeps so either can oracle the
// other):
//  * boxes are widened one ulp outward plus an up-rounded inflation radius
//  * sweep along a sort axis: for sorted boxes i<j, candidates while
//    min_axis[j] <= max_axis[i]; full 3-axis closed-interval overlap test
//  * pairs sharing a simplex vertex are skipped (9 integer compares on the
//    encoded vertex ids: vertex i -> {i,-i-1,-i-1}, edge -> {a,b,-a-1},
//    face -> {a,b,c})
//  * two-list mode requires opposite-sign element ids and emits
//    (original list-A id, list-B id); one-list emits (min,max) element ids
//  * the axis with the largest center variance is reported as the
//    recommended next sort axis

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SortedBoxes {
    std::vector<double> min_x, max_x;      // sort axis bounds
    std::vector<double> min_a, max_a;      // minor axis 1
    std::vector<double> min_b, max_b;      // minor axis 2
    std::vector<int32_t> v0, v1, v2;       // vertex ids
    std::vector<int32_t> eid;              // element ids
};

inline bool share_vertex(
    int32_t a0, int32_t a1, int32_t a2, int32_t b0, int32_t b1, int32_t b2)
{
    return a0 == b0 || a0 == b1 || a0 == b2 || a1 == b0 || a1 == b1
        || a1 == b2 || a2 == b0 || a2 == b1 || a2 == b2;
}

void sweep_range(
    const SortedBoxes& s,
    int64_t begin,
    int64_t end,
    bool two_lists,
    std::vector<int32_t>& out)
{
    const int64_t n = static_cast<int64_t>(s.min_x.size());
    for (int64_t i = begin; i < end; ++i) {
        const double limit = s.max_x[i];
        const double ia_min = s.min_a[i], ia_max = s.max_a[i];
        const double ib_min = s.min_b[i], ib_max = s.max_b[i];
        const int32_t iv0 = s.v0[i], iv1 = s.v1[i], iv2 = s.v2[i];
        const int32_t ie = s.eid[i];
        for (int64_t j = i + 1; j < n && s.min_x[j] <= limit; ++j) {
            if (s.min_a[j] > ia_max || ia_min > s.max_a[j])
                continue;
            if (s.min_b[j] > ib_max || ib_min > s.max_b[j])
                continue;
            const int32_t je = s.eid[j];
            if (two_lists && ((ie >= 0) == (je >= 0)))
                continue;
            if (share_vertex(iv0, iv1, iv2, s.v0[j], s.v1[j], s.v2[j]))
                continue;
            int32_t lo = std::min(ie, je), hi = std::max(ie, je);
            if (two_lists)
                lo = -lo - 1; // un-flip the list-A id
            out.push_back(lo);
            out.push_back(hi);
        }
    }
}

} // namespace

extern "C" {

// Conservative vertex boxes for linear motion v0 -> v1 (or static if v1 null).
// vmin/vmax: (n,3) outputs.  Mirrors the ulp-widening contract of
// geometry/aabb.py (_conservative_bounds).
void sccd_build_vertex_boxes(
    const double* v0,
    const double* v1,
    int64_t n,
    double inflation,
    double* vmin,
    double* vmax)
{
    const double inf_up = std::nextafter(inflation, HUGE_VAL);
    for (int64_t i = 0; i < 3 * n; ++i) {
        double lo = v0[i], hi = v0[i];
        if (v1) {
            lo = std::min(lo, v1[i]);
            hi = std::max(hi, v1[i]);
        }
        vmin[i] = std::nextafter(lo, -HUGE_VAL) - inf_up;
        vmax[i] = std::nextafter(hi, HUGE_VAL) + inf_up;
    }
}

// Union of k vertex boxes per element (k=2 edges, k=3 faces); exact min/max.
void sccd_build_element_boxes(
    const double* vmin,
    const double* vmax,
    const int32_t* elements,
    int64_t n_elements,
    int k,
    double* emin,
    double* emax)
{
    for (int64_t e = 0; e < n_elements; ++e) {
        for (int d = 0; d < 3; ++d) {
            double lo = HUGE_VAL, hi = -HUGE_VAL;
            for (int c = 0; c < k; ++c) {
                const int64_t v = elements[e * k + c];
                lo = std::min(lo, vmin[v * 3 + d]);
                hi = std::max(hi, vmax[v * 3 + d]);
            }
            emin[e * 3 + d] = lo;
            emax[e * 3 + d] = hi;
        }
    }
}

// Sort boxes by min[axis] and sweep.  Returns the pair count; *out_pairs is a
// malloc'd int32 buffer of (count*2), released with sccd_free.  next_axis
// gets the center-variance argmax (the recommended next sort axis).
int64_t sccd_sort_and_sweep(
    const double* bmin,          // (n,3) row-major
    const double* bmax,          // (n,3)
    const int32_t* vertex_ids,   // (n,3)
    const int32_t* element_ids,  // (n,)
    int64_t n,
    int axis,
    int two_lists,
    int n_threads,
    int32_t** out_pairs,
    int* next_axis)
{
    if (n <= 0) {
        *out_pairs = nullptr;
        if (next_axis)
            *next_axis = 0;
        return 0;
    }
    const int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;

    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i)
        order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return bmin[a * 3 + axis] < bmin[b * 3 + axis];
    });

    SortedBoxes s;
    s.min_x.resize(n); s.max_x.resize(n);
    s.min_a.resize(n); s.max_a.resize(n);
    s.min_b.resize(n); s.max_b.resize(n);
    s.v0.resize(n); s.v1.resize(n); s.v2.resize(n);
    s.eid.resize(n);
    double mean[3] = { 0, 0, 0 }, m2[3] = { 0, 0, 0 };
    for (int64_t i = 0; i < n; ++i) {
        const int64_t o = order[i];
        s.min_x[i] = bmin[o * 3 + axis];
        s.max_x[i] = bmax[o * 3 + axis];
        s.min_a[i] = bmin[o * 3 + a1];
        s.max_a[i] = bmax[o * 3 + a1];
        s.min_b[i] = bmin[o * 3 + a2];
        s.max_b[i] = bmax[o * 3 + a2];
        s.v0[i] = vertex_ids[o * 3];
        s.v1[i] = vertex_ids[o * 3 + 1];
        s.v2[i] = vertex_ids[o * 3 + 2];
        s.eid[i] = element_ids[o];
        // Welford over box centers for the next-axis recommendation
        for (int d = 0; d < 3; ++d) {
            const double c = 0.5 * (bmin[o * 3 + d] + bmax[o * 3 + d]);
            const double delta = c - mean[d];
            mean[d] += delta / static_cast<double>(i + 1);
            m2[d] += delta * (c - mean[d]);
        }
    }
    if (next_axis) {
        int best = 0;
        if (m2[1] > m2[best])
            best = 1;
        if (m2[2] > m2[best])
            best = 2;
        *next_axis = best;
    }

    int t = n_threads > 0
        ? n_threads
        : static_cast<int>(std::thread::hardware_concurrency());
    t = std::max(1, std::min<int>(t, 256));

    // Box-batched sweep with halve-on-OOM retry, the reference's adaptive
    // batching (sort_and_sweep.cpp:144-196): if a batch's thread-local pair
    // vectors exhaust memory, the failed batch is re-run at half the size
    // (already-emitted batches are kept).  SCCD_HOST_BATCH caps the initial
    // batch for tests / memory-constrained callers.
    int64_t batch = n;
    if (const char* env = std::getenv("SCCD_HOST_BATCH")) {
        const int64_t forced = std::atoll(env);
        if (forced > 0)
            batch = std::min(batch, forced);
    }
    std::vector<std::vector<int32_t>> done;
    int64_t batch_start = 0;
    while (batch_start < n) {
        const int64_t batch_end = std::min(batch_start + batch, n);
        const int64_t span = batch_end - batch_start;
        std::vector<std::vector<int32_t>> locals(t);
        std::atomic<bool> oom(false);
        std::vector<std::thread> threads;
        const int64_t per = (span + t - 1) / t;
        for (int ti = 0; ti < t; ++ti) {
            const int64_t b = std::min<int64_t>(batch_start + ti * per, batch_end);
            const int64_t e = std::min<int64_t>(b + per, batch_end);
            threads.emplace_back([&, b, e, ti]() {
                try {
                    sweep_range(s, b, e, two_lists != 0, locals[ti]);
                } catch (const std::bad_alloc&) {
                    oom.store(true);
                }
            });
        }
        for (auto& th : threads)
            th.join();
        if (oom.load()) {
            if (batch <= 1) {
                *out_pairs = nullptr; // a single box's pairs do not fit
                return -1;
            }
            batch = std::max<int64_t>(1, batch / 2);
            continue; // retry the same range at half the batch
        }
        for (auto& l : locals)
            if (!l.empty())
                done.emplace_back(std::move(l));
        batch_start = batch_end;
    }

    int64_t total = 0;
    for (const auto& l : done)
        total += static_cast<int64_t>(l.size());
    auto* buf = static_cast<int32_t*>(std::malloc(
        std::max<int64_t>(total, 1) * sizeof(int32_t)));
    if (buf == nullptr) {
        *out_pairs = nullptr;
        return -1;
    }
    int64_t off = 0;
    for (const auto& l : done) {
        std::memcpy(buf + off, l.data(), l.size() * sizeof(int32_t));
        off += static_cast<int64_t>(l.size());
    }
    *out_pairs = buf;
    return total / 2;
}

void sccd_free(void* p) { std::free(p); }

} // extern "C"
