// Host SAH BVH builder of the PyTorch/CUDA port.
//
// The port's own copy of mitsuba_tpu/native/bvh_builder.cpp, unchanged in
// what it computes, so both packages build the same tree: the
// replacement for the reference's accel-build layer (Embree's BVH build,
// scene_embree.inl:113-160, and the SAH kd-tree builder with min-max
// binning, include/mitsuba/render/kdtree.h:800 MinMaxBins, :1827
// build()).  It emits the flattened DFS + miss-link node layout that
// ops/bvh.py walks and csrc/megakernel_bvh.cu traverses, one GPU thread
// per ray, without a stack.
//
// Binned SAH (16 bins per axis), leaf cut-off by SAH cost, iterative
// explicit stack (no recursion limits).  Exposed via a C ABI for ctypes.
//
// Build (ops/bvh.py does this at first use):
//   g++ -O3 -shared -fPIC -std=c++17 bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BBox {
    float lo[3], hi[3];
    BBox() {
        for (int i = 0; i < 3; ++i) { lo[i] = FLT_MAX; hi[i] = -FLT_MAX; }
    }
    void expand(const float* p) {
        for (int i = 0; i < 3; ++i) {
            lo[i] = std::min(lo[i], p[i]);
            hi[i] = std::max(hi[i], p[i]);
        }
    }
    void expand(const BBox& b) {
        for (int i = 0; i < 3; ++i) {
            lo[i] = std::min(lo[i], b.lo[i]);
            hi[i] = std::max(hi[i], b.hi[i]);
        }
    }
    float area() const {
        float d[3] = {hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]};
        for (int i = 0; i < 3; ++i) d[i] = std::max(d[i], 0.f);
        return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
    }
};

struct Prim {
    BBox box;
    float centroid[3];
    int32_t id;
};

struct BuildNode {
    BBox box;
    int32_t first = 0, count = 0;   // leaf: count > 0
    int32_t left = -1, right = -1;  // inner children (build indices)
};

constexpr int N_BINS = 16;
constexpr float TRAVERSAL_COST = 1.0f;
constexpr float INTERSECT_COST = 1.0f;

}  // namespace

extern "C" {

// Returns the number of flattened nodes (<= 2*n_faces), or -1 on error.
// Output arrays must be sized: bbox_lo/hi: 2*n_faces*3, first/count/miss:
// 2*n_faces, prims: n_faces + leaf_size (padded with -1).
int32_t build_bvh_sah(const float* verts, int32_t n_verts,
                      const int32_t* faces, int32_t n_faces,
                      int32_t leaf_size,
                      float* out_lo, float* out_hi,
                      int32_t* out_first, int32_t* out_count,
                      int32_t* out_miss, int32_t* out_prims) {
    (void)n_verts;
    if (n_faces <= 0) return -1;

    std::vector<Prim> prims(n_faces);
    for (int32_t f = 0; f < n_faces; ++f) {
        Prim& p = prims[f];
        p.id = f;
        for (int k = 0; k < 3; ++k) {
            const float* v = verts + 3 * faces[3 * f + k];
            p.box.expand(v);
        }
        for (int i = 0; i < 3; ++i)
            p.centroid[i] = 0.5f * (p.box.lo[i] + p.box.hi[i]);
    }

    std::vector<BuildNode> nodes;
    nodes.reserve(2 * (size_t)n_faces);
    std::vector<int32_t> order(n_faces);
    for (int32_t i = 0; i < n_faces; ++i) order[i] = i;

    struct Task { int32_t node, begin, end; };
    std::vector<Task> stack;
    nodes.push_back(BuildNode());
    stack.push_back({0, 0, n_faces});

    std::vector<int32_t> prim_out;
    prim_out.reserve(n_faces);

    while (!stack.empty()) {
        Task t = stack.back();
        stack.pop_back();
        BuildNode& node = nodes[t.node];
        int32_t n = t.end - t.begin;

        BBox bounds, cbounds;
        for (int32_t i = t.begin; i < t.end; ++i) {
            bounds.expand(prims[order[i]].box);
            cbounds.expand(prims[order[i]].centroid);
        }
        node.box = bounds;

        if (n <= leaf_size) {
            node.first = (int32_t)prim_out.size();
            node.count = n;
            for (int32_t i = t.begin; i < t.end; ++i)
                prim_out.push_back(prims[order[i]].id);
            continue;
        }

        // binned SAH over the widest centroid axis
        int axis = 0;
        float ext[3];
        for (int i = 0; i < 3; ++i) ext[i] = cbounds.hi[i] - cbounds.lo[i];
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int32_t mid;
        if (ext[axis] < 1e-12f) {
            mid = t.begin + n / 2;  // degenerate: median split
        } else {
            BBox bin_box[N_BINS];
            int32_t bin_cnt[N_BINS] = {0};
            float inv = N_BINS / ext[axis];
            for (int32_t i = t.begin; i < t.end; ++i) {
                const Prim& p = prims[order[i]];
                int b = (int)((p.centroid[axis] - cbounds.lo[axis]) * inv);
                b = std::min(b, N_BINS - 1);
                bin_box[b].expand(p.box);
                bin_cnt[b]++;
            }
            // sweep: suffix areas
            float right_area[N_BINS];
            BBox acc;
            int32_t right_cnt[N_BINS];
            int32_t cnt = 0;
            for (int b = N_BINS - 1; b >= 1; --b) {
                acc.expand(bin_box[b]);
                cnt += bin_cnt[b];
                right_area[b] = acc.area();
                right_cnt[b] = cnt;
            }
            // prefix sweep, pick min cost
            float best_cost = FLT_MAX;
            int best_split = -1;
            BBox lacc;
            int32_t lcnt = 0;
            float inv_area = 1.f / std::max(bounds.area(), 1e-20f);
            for (int b = 0; b < N_BINS - 1; ++b) {
                lacc.expand(bin_box[b]);
                lcnt += bin_cnt[b];
                if (lcnt == 0 || right_cnt[b + 1] == 0) continue;
                float cost = TRAVERSAL_COST +
                    inv_area * INTERSECT_COST *
                        (lacc.area() * lcnt +
                         right_area[b + 1] * right_cnt[b + 1]);
                if (cost < best_cost) { best_cost = cost; best_split = b; }
            }
            // NOTE: the traversal kernel unrolls exactly leaf_size prim
            // slots per leaf, so nodes with n > leaf_size MUST split even
            // when SAH prefers a leaf (fall back to a median split).
            if (best_split < 0) {
                mid = t.begin + n / 2;
                goto have_split;
            }
            float split_pos =
                cbounds.lo[axis] + (best_split + 1) * ext[axis] / N_BINS;
            int32_t* first = order.data() + t.begin;
            int32_t* last = order.data() + t.end;
            int32_t* pmid = std::partition(
                first, last, [&](int32_t id) {
                    return prims[id].centroid[axis] < split_pos;
                });
            mid = t.begin + (int32_t)(pmid - first);
            if (mid == t.begin || mid == t.end) mid = t.begin + n / 2;
        }
    have_split:

        int32_t li = (int32_t)nodes.size();
        nodes.push_back(BuildNode());
        int32_t ri = (int32_t)nodes.size();
        nodes.push_back(BuildNode());
        nodes[t.node].left = li;
        nodes[t.node].right = ri;
        // depth-first order: right pushed first so left pops first
        stack.push_back({ri, mid, t.end});
        stack.push_back({li, t.begin, mid});
    }

    // Flatten in DFS order with threaded miss links (ops/bvh.py layout):
    // hit-successor of an inner node is node+1; miss link jumps past the
    // subtree.  Iterative DFS carrying the miss target.
    int32_t n_nodes = (int32_t)nodes.size();
    std::vector<int32_t> flat_index(n_nodes, -1);
    struct FTask { int32_t build_node, miss; };
    std::vector<FTask> fstack;
    fstack.push_back({0, -1});
    int32_t cursor = 0;
    while (!fstack.empty()) {
        FTask ft = fstack.back();
        fstack.pop_back();
        const BuildNode& bn = nodes[ft.build_node];
        int32_t idx = cursor++;
        flat_index[ft.build_node] = idx;
        std::memcpy(out_lo + 3 * idx, bn.box.lo, 3 * sizeof(float));
        std::memcpy(out_hi + 3 * idx, bn.box.hi, 3 * sizeof(float));
        out_first[idx] = bn.first;
        out_count[idx] = bn.count;
        out_miss[idx] = ft.miss;
        if (bn.count == 0) {
            // right child's miss = this node's miss; left's miss = right
            fstack.push_back({bn.right, ft.miss});
            // left's miss target is the right child's flat index == the
            // cursor AFTER the whole left subtree; we don't know it yet,
            // so we fix it with a second pass below using subtree sizes.
            fstack.push_back({bn.left, -2 - bn.right});  // sentinel
        }
    }
    // second pass: resolve sentinels (-2 - build_right) to flat indices
    for (int32_t i = 0; i < cursor; ++i) {
        if (out_miss[i] <= -2) {
            int32_t build_right = -2 - out_miss[i];
            out_miss[i] = flat_index[build_right];
        }
    }

    for (size_t i = 0; i < prim_out.size(); ++i) out_prims[i] = prim_out[i];
    for (int32_t i = (int32_t)prim_out.size();
         i < n_faces + leaf_size; ++i)
        out_prims[i] = -1;
    return cursor;
}

}  // extern "C"
