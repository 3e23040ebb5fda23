// Native BVH builder — the C++ equivalent of the reference's compiled Cython
// builder (reference: boundingBoxes.pyx:9-132), emitting the
// flattened layout described in ops/bvh.py: DFS preorder with miss links,
// in-place triangle permutation so leaves are contiguous ranges.
//
// Two split methods:
//   method 0 — the reference's rule: split at the centroid MEAN along the
//              largest-extent axis (boundingBoxes.pyx:162-175), falling back
//              to an even index split when degenerate.  Matches the numpy
//              twin in ops/bvh.py (kept as the readable spec, the same way
//              the reference keeps scene.py:274-421 beside the Cython).
//   method 1 — binned SAH (16 bins, ALL THREE axes, binned by triangle-box
//              centers): picks the (axis, bin) split minimizing
//              surface-area * count.  Object splits only: every triangle
//              lands in exactly one leaf, so leaves stay contiguous ranges
//              of the permuted triangle array.
//
// C ABI for ctypes; caller allocates 2T-sized node arrays (a binary BVH with
// non-empty leaves has < 2T nodes).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;

struct AABB {
    float lo[3] = {std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity()};
    float hi[3] = {-std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity()};
    void grow(const float* p) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], p[a]);
            hi[a] = std::max(hi[a], p[a]);
        }
    }
    void grow(const AABB& o) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], o.lo[a]);
            hi[a] = std::max(hi[a], o.hi[a]);
        }
    }
    float area() const {
        float dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
        if (dx < 0 || dy < 0 || dz < 0) return 0.0f;
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Builder {
    long long T;
    int max_leaf;
    int method;

    std::vector<AABB> tri_box;        // per-triangle AABB
    std::vector<float> centroid;      // (T,3)
    std::vector<long long> work;      // permutation being partitioned in place

    std::vector<float> node_min, node_max;  // (N,3)
    std::vector<int> node_first, node_count;
    std::vector<std::pair<int, int>> children;  // (-1,-1) for leaves
    int max_depth = 0;

    // Progress (the reference's carriage-return percent bar during its
    // build loop, boundingBoxes.pyx:64-65): percent of triangles placed
    // into finished leaves — monotonic over the DFS.
    int progress = 0;
    long long done = 0;
    long long next_mark = 0;

    void leaf_progress(long long n) {
        done += n;
        if (!progress || done < next_mark) return;
        std::printf("\r%.2f%%...", (double)done / (double)T * 100.0);
        std::fflush(stdout);
        long long step = T / 100 > 0 ? T / 100 : 1;
        while (next_mark <= done) next_mark += step;
    }

    int alloc_node(long long lo, long long hi) {
        AABB box;
        for (long long i = lo; i < hi; ++i) box.grow(tri_box[(size_t)work[(size_t)i]]);
        node_min.insert(node_min.end(), box.lo, box.lo + 3);
        node_max.insert(node_max.end(), box.hi, box.hi + 3);
        node_first.push_back(0);
        node_count.push_back(0);
        children.emplace_back(-1, -1);
        return (int)node_count.size() - 1;
    }

    // Returns the split point in [lo+1, hi-1], or -1 to request even split.
    long long choose_split(long long lo, long long hi) {
        long long* w = work.data();
        if (method == 0) {
            // Centroid bounds + largest axis (the reference's rule).
            AABB cb;
            for (long long i = lo; i < hi; ++i)
                cb.grow(&centroid[(size_t)work[(size_t)i] * 3]);
            int axis = 0;
            float ext = cb.hi[0] - cb.lo[0];
            for (int a = 1; a < 3; ++a) {
                float e = cb.hi[a] - cb.lo[a];
                if (e > ext) { ext = e; axis = a; }
            }
            if (!(ext > 0.0f)) return -1;
            // Mean split (the reference's rule, boundingBoxes.pyx:169-175).
            double sum = 0.0;
            for (long long i = lo; i < hi; ++i) sum += centroid[(size_t)w[i] * 3 + axis];
            float mean = (float)(sum / (double)(hi - lo));
            long long* mid = std::partition(
                w + lo, w + hi,
                [&](long long t) { return centroid[(size_t)t * 3 + axis] <= mean; });
            long long m = mid - w;
            if (m == lo || m == hi) return -1;
            return m;
        }

        // Binned SAH, all 3 axes, binned by triangle-box centers.
        auto center_of = [&](long long t, int a) {
            const AABB& b = tri_box[(size_t)t];
            return 0.5f * (b.lo[a] + b.hi[a]);
        };
        float best_cost = std::numeric_limits<float>::infinity();
        int best_axis = -1, best_b = -1;
        float best_base = 0.0f, best_scale = 0.0f;
        for (int a = 0; a < 3; ++a) {
            float cmin = std::numeric_limits<float>::infinity();
            float cmax = -cmin;
            for (long long i = lo; i < hi; ++i) {
                float c0 = center_of(w[i], a);
                cmin = std::min(cmin, c0);
                cmax = std::max(cmax, c0);
            }
            if (!(cmax > cmin)) continue;
            float scale = (float)kBins / (cmax - cmin);
            int counts[kBins] = {0};
            AABB bins[kBins];
            for (long long i = lo; i < hi; ++i) {
                int b = (int)((center_of(w[i], a) - cmin) * scale);
                b = std::min(std::max(b, 0), kBins - 1);
                counts[b]++;
                bins[b].grow(tri_box[(size_t)w[i]]);
            }
            float right_area[kBins];
            int right_count[kBins];
            {
                AABB acc;
                int c = 0;
                for (int b = kBins - 1; b >= 1; --b) {
                    acc.grow(bins[b]);
                    c += counts[b];
                    right_area[b] = acc.area();
                    right_count[b] = c;
                }
            }
            AABB acc;
            int c = 0;
            for (int b = 0; b < kBins - 1; ++b) {
                acc.grow(bins[b]);
                c += counts[b];
                if (c == 0 || right_count[b + 1] == 0) continue;
                float cost = acc.area() * (float)c
                             + right_area[b + 1] * (float)right_count[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = a;
                    best_b = b;
                    best_base = cmin;
                    best_scale = scale;
                }
            }
        }
        if (best_axis < 0) return -1;
        long long* mid = std::partition(
            w + lo, w + hi, [&](long long t) {
                int b = (int)((center_of(t, best_axis) - best_base)
                              * best_scale);
                b = std::min(std::max(b, 0), kBins - 1);
                return b <= best_b;
            });
        long long m = mid - w;
        if (m == lo || m == hi) return -1;
        return m;
    }

    int build(long long lo, long long hi, int depth) {
        int me = alloc_node(lo, hi);
        if (depth > max_depth) max_depth = depth;
        long long n = hi - lo;
        if (n <= max_leaf) {
            node_first[(size_t)me] = (int)lo;
            node_count[(size_t)me] = (int)n;
            leaf_progress(n);
            return me;
        }
        long long m = choose_split(lo, hi);
        if (m < 0) m = lo + n / 2;  // even split fallback
        int left = build(lo, m, depth + 1);
        int right = build(m, hi, depth + 1);
        children[(size_t)me] = {left, right};
        return me;
    }
};

}  // namespace

extern "C" {

// Returns node count (>0) or negative on error.  Output arrays sized by the
// caller: node_* hold 2T entries (3 floats each for min/max), perm holds T.
long long bvh_build(const float* v0, const float* v1, const float* v2,
                    long long T, int max_leaf, int method,
                    float* out_min, float* out_max, int* out_miss,
                    int* out_first, int* out_count, long long* out_perm,
                    int* out_depth, int progress) {
    if (T <= 0 || max_leaf <= 0) return -1;

    Builder b;
    b.T = T;
    b.max_leaf = max_leaf;
    b.method = method;
    b.progress = progress;
    b.next_mark = T / 100 > 0 ? T / 100 : 1;
    b.tri_box.resize((size_t)T);
    b.centroid.resize((size_t)T * 3);
    b.work.resize((size_t)T);
    for (long long i = 0; i < T; ++i) {
        const float* a = v0 + i * 3;
        const float* c = v1 + i * 3;
        const float* d = v2 + i * 3;
        AABB& box = b.tri_box[(size_t)i];
        box.grow(a);
        box.grow(c);
        box.grow(d);
        for (int ax = 0; ax < 3; ++ax)
            b.centroid[(size_t)i * 3 + ax] = (a[ax] / 3.0f + c[ax] / 3.0f + d[ax] / 3.0f);
        b.work[(size_t)i] = i;
    }

    b.node_min.reserve((size_t)T * 6);
    b.build(0, T, 0);
    if (progress) std::printf("\n");

    long long N = (long long)b.node_count.size();
    if (N > 2 * T) return -4;

    // Miss links: preorder guarantees parents precede children.
    std::vector<int> miss((size_t)N, (int)N);
    for (long long i = 0; i < N; ++i) {
        auto [l, r] = b.children[(size_t)i];
        if (l != -1) {
            miss[(size_t)l] = r;
            miss[(size_t)r] = miss[(size_t)i];
        }
    }

    std::memcpy(out_min, b.node_min.data(), (size_t)N * 3 * sizeof(float));
    std::memcpy(out_max, b.node_max.data(), (size_t)N * 3 * sizeof(float));
    std::memcpy(out_miss, miss.data(), (size_t)N * sizeof(int));
    std::memcpy(out_first, b.node_first.data(), (size_t)N * sizeof(int));
    std::memcpy(out_count, b.node_count.data(), (size_t)N * sizeof(int));
    std::memcpy(out_perm, b.work.data(), (size_t)T * sizeof(long long));
    *out_depth = b.max_depth;
    return N;
}

}  // extern "C"
