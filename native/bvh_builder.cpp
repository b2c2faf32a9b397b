// Binned-SAH BVH builder with DFS flattening + exit links.
//
// Native replacement for the Python fallback in scene/meshbuild.py and the
// counterpart of the reference's host-side BVH construction
// (reference: src/renderer/BvhBuilder.mm median split + external/tinybvh
// SAH BLAS). Output contract matches schema.BvhSoA:
//   - nodes stored depth-first, left (near) child at node+1
//   - exit_index = where traversal resumes on AABB miss / after a leaf
//   - leaves reference a reordered prim_indices array, prim_count <= maxLeaf
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).
//
// Build: native/build.sh  ->  native/libbvh_builder.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
    Vec3 mn{std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity(),
            std::numeric_limits<float>::infinity()};
    Vec3 mx{-std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity(),
            -std::numeric_limits<float>::infinity()};

    void grow(const Aabb& o) {
        mn = vmin(mn, o.mn);
        mx = vmax(mx, o.mx);
    }
    void grow(const Vec3& p) {
        mn = vmin(mn, p);
        mx = vmax(mx, p);
    }
    float area() const {
        float dx = std::max(mx.x - mn.x, 0.0f);
        float dy = std::max(mx.y - mn.y, 0.0f);
        float dz = std::max(mx.z - mn.z, 0.0f);
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct BuildNode {
    Aabb bounds;
    int32_t left = -1;    // build-order child indices
    int32_t right = -1;
    int32_t prim_offset = 0;
    int32_t prim_count = 0;
};

struct Builder {
    const Aabb* tri_bounds;
    const Vec3* centroids;
    int max_leaf;
    int n_bins;
    std::vector<BuildNode> nodes;
    std::vector<int32_t> prim_order;  // reordered primitive ids
    std::vector<int32_t> work;        // scratch id array being partitioned

    int build(int32_t* ids, int count) {
        int node_id = static_cast<int>(nodes.size());
        nodes.emplace_back();
        Aabb bounds;
        Aabb cbounds;
        for (int i = 0; i < count; ++i) {
            bounds.grow(tri_bounds[ids[i]]);
            cbounds.grow(centroids[ids[i]]);
        }
        nodes[node_id].bounds = bounds;

        auto make_leaf = [&]() {
            nodes[node_id].prim_offset = static_cast<int32_t>(prim_order.size());
            nodes[node_id].prim_count = count;
            prim_order.insert(prim_order.end(), ids, ids + count);
        };

        if (count <= max_leaf) {
            make_leaf();
            return node_id;
        }

        float ext[3] = {cbounds.mx.x - cbounds.mn.x,
                        cbounds.mx.y - cbounds.mn.y,
                        cbounds.mx.z - cbounds.mn.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        if (ext[axis] <= 1e-12f) {
            make_leaf();
            return node_id;
        }

        const float cmin = axis == 0 ? cbounds.mn.x : (axis == 1 ? cbounds.mn.y : cbounds.mn.z);
        const float scale = n_bins / ext[axis];
        auto bin_of = [&](int32_t id) {
            const Vec3& c = centroids[id];
            float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
            int b = static_cast<int>((v - cmin) * scale);
            return std::min(std::max(b, 0), n_bins - 1);
        };

        std::vector<Aabb> bin_bounds(n_bins);
        std::vector<int> bin_counts(n_bins, 0);
        for (int i = 0; i < count; ++i) {
            int b = bin_of(ids[i]);
            bin_bounds[b].grow(tri_bounds[ids[i]]);
            bin_counts[b]++;
        }

        std::vector<float> right_area(n_bins);
        std::vector<int> right_count(n_bins);
        {
            Aabb acc;
            int cnt = 0;
            for (int b = n_bins - 1; b >= 0; --b) {
                if (bin_counts[b]) acc.grow(bin_bounds[b]);
                cnt += bin_counts[b];
                right_area[b] = cnt ? acc.area() : 0.0f;
                right_count[b] = cnt;
            }
        }

        float best_cost = std::numeric_limits<float>::infinity();
        int best_split = -1;
        {
            Aabb acc;
            int cnt = 0;
            for (int b = 0; b < n_bins - 1; ++b) {
                if (bin_counts[b]) acc.grow(bin_bounds[b]);
                cnt += bin_counts[b];
                if (cnt == 0 || right_count[b + 1] == 0) continue;
                float cost = acc.area() * cnt + right_area[b + 1] * right_count[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = b;
                }
            }
        }

        int mid;
        if (best_split < 0) {
            // Degenerate: median split on the axis (reference BvhBuilder.mm)
            mid = count / 2;
            std::nth_element(ids, ids + mid, ids + count,
                             [&](int32_t a, int32_t b) {
                                 const Vec3& ca = centroids[a];
                                 const Vec3& cb = centroids[b];
                                 float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                                 float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                                 return va < vb;
                             });
        } else {
            int32_t* split_it = std::partition(
                ids, ids + count,
                [&](int32_t id) { return bin_of(id) <= best_split; });
            mid = static_cast<int>(split_it - ids);
            if (mid == 0 || mid == count) {
                mid = count / 2;
            }
        }

        int left = build(ids, mid);
        int right = build(ids + mid, count - mid);
        nodes[node_id].left = left;
        nodes[node_id].right = right;
        return node_id;
    }
};

// DFS flatten + exit-link emit.
static int emit_flat(const std::vector<BuildNode>& bnodes,
                     const std::vector<int32_t>& order_prims,
                     float* out_bounds_min, float* out_bounds_max,
                     int32_t* out_prim_offset, int32_t* out_prim_count,
                     int32_t* out_exit_index, int32_t* out_prim_indices) {
    const int n_nodes = static_cast<int>(bnodes.size());
    std::vector<int32_t> new_index(n_nodes, -1);
    std::vector<int32_t> order;
    order.reserve(n_nodes);
    {
        std::vector<int32_t> stack{0};
        while (!stack.empty()) {
            int nd = stack.back();
            stack.pop_back();
            new_index[nd] = static_cast<int32_t>(order.size());
            order.push_back(nd);
            const BuildNode& bn = bnodes[nd];
            if (bn.left >= 0) {
                stack.push_back(bn.right);
                stack.push_back(bn.left);
            }
        }
    }
    std::vector<int32_t> exit_link(n_nodes, n_nodes);
    {
        struct Item {
            int32_t node;
            int32_t exit;
        };
        std::vector<Item> stack{{0, n_nodes}};
        while (!stack.empty()) {
            Item it = stack.back();
            stack.pop_back();
            exit_link[new_index[it.node]] = it.exit;
            const BuildNode& bn = bnodes[it.node];
            if (bn.left >= 0) {
                stack.push_back({bn.left, new_index[bn.right]});
                stack.push_back({bn.right, it.exit});
            }
        }
    }
    for (int i = 0; i < n_nodes; ++i) {
        const BuildNode& bn = bnodes[order[i]];
        out_bounds_min[3 * i + 0] = bn.bounds.mn.x;
        out_bounds_min[3 * i + 1] = bn.bounds.mn.y;
        out_bounds_min[3 * i + 2] = bn.bounds.mn.z;
        out_bounds_max[3 * i + 0] = bn.bounds.mx.x;
        out_bounds_max[3 * i + 1] = bn.bounds.mx.y;
        out_bounds_max[3 * i + 2] = bn.bounds.mx.z;
        out_prim_offset[i] = bn.prim_offset;
        out_prim_count[i] = bn.left >= 0 ? 0 : bn.prim_count;
        out_exit_index[i] = exit_link[i];
    }
    std::memcpy(out_prim_indices, order_prims.data(),
                sizeof(int32_t) * order_prims.size());
    return n_nodes;
}

}  // namespace

extern "C" int build_bvh_sah(int n_tris,
                             const float* verts,  // (n, 9): v0 v1 v2
                             float* out_bounds_min,   // (max_nodes, 3)
                             float* out_bounds_max,
                             int32_t* out_prim_offset,
                             int32_t* out_prim_count,
                             int32_t* out_exit_index,
                             int32_t* out_prim_indices,  // (n)
                             int max_leaf,
                             int n_bins) {
    if (n_tris <= 0) return -1;

    std::vector<Aabb> tri_bounds(n_tris);
    std::vector<Vec3> centroids(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        const float* v = verts + 9 * i;
        Aabb b;
        b.grow(Vec3{v[0], v[1], v[2]});
        b.grow(Vec3{v[3], v[4], v[5]});
        b.grow(Vec3{v[6], v[7], v[8]});
        tri_bounds[i] = b;
        centroids[i] = {(b.mn.x + b.mx.x) * 0.5f,
                        (b.mn.y + b.mx.y) * 0.5f,
                        (b.mn.z + b.mx.z) * 0.5f};
    }

    Builder builder;
    builder.tri_bounds = tri_bounds.data();
    builder.centroids = centroids.data();
    builder.max_leaf = max_leaf;
    builder.n_bins = n_bins;
    builder.nodes.reserve(2 * n_tris);
    builder.prim_order.reserve(n_tris);

    std::vector<int32_t> ids(n_tris);
    for (int i = 0; i < n_tris; ++i) ids[i] = i;
    builder.build(ids.data(), n_tris);

    return emit_flat(builder.nodes, builder.prim_order, out_bounds_min,
                     out_bounds_max, out_prim_offset, out_prim_count,
                     out_exit_index, out_prim_indices);
}
