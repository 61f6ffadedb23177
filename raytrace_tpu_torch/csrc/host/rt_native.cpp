// Native host components of raytrace_tpu_torch (a copy of the JAX
// package's native/rt_native.cpp; raytrace_tpu_torch/native.py builds and
// loads it). The card owns the render; this library takes the host-side
// hot spots around it:
//   * rt_build_bvh: the median-split BVH build over primitive boxes, in
//     the DFS + skip-pointer layout of the numpy build (bvh.py) and with
//     its tree (stable sort on centroids, longest-axis split, same leaf
//     rule);
//   * rt_png_unfilter / rt_png_filter_paeth: PNG scanline (un)filtering
//     (None/Sub/Up/Average/Paeth), the per-byte loop that dominates
//     Python PNG IO.
//
// Built with: g++ -O2 -shared -fPIC rt_native.cpp -o librt_native.so
// Loaded through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build
// ---------------------------------------------------------------------------

struct BuildCtx {
    const float* lo;   // (n,3)
    const float* hi;   // (n,3)
    int leaf_size;
    // outputs (preallocated to 2n-1 nodes max by caller)
    float* node_min;   // (cap,3)
    float* node_max;   // (cap,3)
    int32_t* node_skip;
    int32_t* node_first;
    int32_t* node_count;
    int32_t* prim_index;
    int n_nodes;
    int n_perm;
    std::vector<int32_t> ends;
};

static int build_rec(BuildCtx& c, std::vector<int32_t>& idx,
                     int begin, int end) {
    int my = c.n_nodes++;
    float bmin[3] = {3.0e38f, 3.0e38f, 3.0e38f};
    float bmax[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
    for (int k = begin; k < end; ++k) {
        const float* l = c.lo + 3 * idx[k];
        const float* h = c.hi + 3 * idx[k];
        for (int a = 0; a < 3; ++a) {
            bmin[a] = std::min(bmin[a], l[a]);
            bmax[a] = std::max(bmax[a], h[a]);
        }
    }
    std::memcpy(c.node_min + 3 * my, bmin, 12);
    std::memcpy(c.node_max + 3 * my, bmax, 12);
    c.node_skip[my] = -1;
    int count = end - begin;
    if (count <= c.leaf_size) {
        c.node_first[my] = c.n_perm;
        c.node_count[my] = count;
        for (int k = begin; k < end; ++k)
            c.prim_index[c.n_perm++] = idx[k];
    } else {
        c.node_first[my] = -1;
        c.node_count[my] = 0;
        int axis = 0;
        float best = bmax[0] - bmin[0];
        for (int a = 1; a < 3; ++a) {
            float ext = bmax[a] - bmin[a];
            if (ext > best) { best = ext; axis = a; }
        }
        // stable sort by centroid on the longest axis (matches
        // numpy argsort(kind="stable") in the Python build)
        std::stable_sort(idx.begin() + begin, idx.begin() + end,
                         [&](int32_t a, int32_t b) {
                             float ca = c.lo[3 * a + axis]
                                        + c.hi[3 * a + axis];
                             float cb = c.lo[3 * b + axis]
                                        + c.hi[3 * b + axis];
                             return ca < cb;
                         });
        int half = begin + count / 2;
        build_rec(c, idx, begin, half);
        build_rec(c, idx, half, end);
    }
    c.ends[my] = c.n_nodes;
    return my;
}

static void assign_skip(BuildCtx& c, int i, int skip) {
    c.node_skip[i] = skip;
    if (c.node_count[i] == 0) {
        int left = i + 1;
        int left_end = c.ends[left];
        assign_skip(c, left, left_end);
        assign_skip(c, left_end, skip);
    }
}

// Returns the node count; caller passes arrays sized for 2n-1 nodes.
int32_t rt_build_bvh(const float* lo, const float* hi, int32_t n,
                     int32_t leaf_size,
                     float* node_min, float* node_max,
                     int32_t* node_skip, int32_t* node_first,
                     int32_t* node_count, int32_t* prim_index) {
    if (n <= 0) return 0;
    BuildCtx c{lo, hi, leaf_size, node_min, node_max, node_skip,
               node_first, node_count, prim_index, 0, 0, {}};
    c.ends.resize(2 * n);
    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    build_rec(c, idx, 0, n);
    assign_skip(c, 0, c.n_nodes);
    return c.n_nodes;
}

// ---------------------------------------------------------------------------
// PNG scanline filters (RFC 2083 §6)
// ---------------------------------------------------------------------------

static inline uint8_t paeth(int a, int b, int cc) {
    int p = a + b - cc;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - cc);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)cc;
}

// In: filters (h,), data (h, stride) filtered bytes. Out: out (h, stride).
// Returns 0 on success, the bad filter id on failure.
int32_t rt_png_unfilter(const uint8_t* filters, const uint8_t* data,
                        uint8_t* out, int32_t h, int32_t stride,
                        int32_t bpp) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* line = data + (size_t)y * stride;
        const uint8_t* prev = y ? out + (size_t)(y - 1) * stride : nullptr;
        uint8_t* o = out + (size_t)y * stride;
        switch (filters[y]) {
            case 0:
                std::memcpy(o, line, stride);
                break;
            case 1:  // Sub
                for (int x = 0; x < stride; ++x)
                    o[x] = line[x] + (x >= bpp ? o[x - bpp] : 0);
                break;
            case 2:  // Up
                for (int x = 0; x < stride; ++x)
                    o[x] = line[x] + (prev ? prev[x] : 0);
                break;
            case 3:  // Average
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? o[x - bpp] : 0;
                    int b = prev ? prev[x] : 0;
                    o[x] = line[x] + (uint8_t)((a + b) >> 1);
                }
                break;
            case 4:  // Paeth
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? o[x - bpp] : 0;
                    int b = prev ? prev[x] : 0;
                    int cc = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    o[x] = line[x] + paeth(a, b, cc);
                }
                break;
            default:
                return filters[y];
        }
    }
    return 0;
}

// Apply the Paeth filter to every scanline (best general-purpose
// predictor) for smaller PNG output. out has stride+1 bytes per row
// (leading filter byte = 4).
void rt_png_filter_paeth(const uint8_t* data, uint8_t* out, int32_t h,
                         int32_t stride, int32_t bpp) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* line = data + (size_t)y * stride;
        const uint8_t* prev = y ? data + (size_t)(y - 1) * stride : nullptr;
        uint8_t* o = out + (size_t)y * (stride + 1);
        o[0] = 4;
        for (int x = 0; x < stride; ++x) {
            int a = x >= bpp ? line[x - bpp] : 0;
            int b = prev ? prev[x] : 0;
            int cc = (prev && x >= bpp) ? prev[x - bpp] : 0;
            o[x + 1] = line[x] - paeth(a, b, cc);
        }
    }
}

}  // extern "C"
