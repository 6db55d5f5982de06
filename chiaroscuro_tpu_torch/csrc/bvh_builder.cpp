// Native BVH builder: binned-SAH over centroids, DFS layout, threaded
// miss-links — the C++ analog of the reference's host-side kd-tree build
// (reference src/kdtree.cpp:110-194), producing the flattened SoA consumed
// by accel/bvh.py.  Semantics mirror the numpy builder `_build_host` there
// (same bins, same sweep, same leaf/miss-link layout); the Python side
// falls back to numpy when this library is unavailable.
//
// C ABI:
//   bvh_build(v0, v1, v2, n_tris, leaf_size,
//             bbox_min, bbox_max, miss_link, leaf_start, leaf_count,
//             tri_order, n_nodes_out)
// Caller allocates node arrays with capacity 2*max(n_tris,1) and tri_order
// with capacity n_tris.  Returns 0 on success.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kSentinel = -1;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double surface(const V3 &mn, const V3 &mx) {
  double dx = std::max(0.0f, mx.x - mn.x);
  double dy = std::max(0.0f, mx.y - mn.y);
  double dz = std::max(0.0f, mx.z - mn.z);
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  const V3 *tri_min, *tri_max, *centroid;
  int leaf_size;

  std::vector<V3> bbox_min, bbox_max;
  std::vector<int32_t> leaf_start, leaf_count, right_child;
  std::vector<int32_t> tri_order;

  // Iterative DFS with an explicit work stack: each frame owns a triangle id
  // range in `ids_storage` and patches its parent's right_child on entry.
  std::vector<int32_t> ids_storage;

  int build(int32_t *ids, int n) {
    int node = static_cast<int>(bbox_min.size());
    V3 mn = tri_min[ids[0]], mx = tri_max[ids[0]];
    for (int i = 1; i < n; ++i) {
      mn = vmin(mn, tri_min[ids[i]]);
      mx = vmax(mx, tri_max[ids[i]]);
    }
    bbox_min.push_back(mn);
    bbox_max.push_back(mx);
    leaf_start.push_back(-1);
    leaf_count.push_back(0);
    right_child.push_back(-1);

    if (n <= leaf_size) {
      leaf_start[node] = static_cast<int32_t>(tri_order.size());
      leaf_count[node] = n;
      tri_order.insert(tri_order.end(), ids, ids + n);
      return node;
    }

    // Widest centroid axis.
    V3 cmin = centroid[ids[0]], cmax = cmin;
    for (int i = 1; i < n; ++i) {
      cmin = vmin(cmin, centroid[ids[i]]);
      cmax = vmax(cmax, centroid[ids[i]]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;  // ids[0:mid) -> left, ids[mid:n) -> right
    if (ext[axis] <= 0.0f) {
      mid = n / 2;  // coincident centroids: split evenly for progress
    } else {
      auto caxis = [&](int32_t id) {
        const V3 &c = centroid[id];
        return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      };
      float corigin = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);
      float scale = kBins * (1.0f - 1e-6f) / ext[axis];

      int counts[kBins] = {0};
      V3 bmn[kBins], bmx[kBins];
      const float inf = std::numeric_limits<float>::infinity();
      for (int b = 0; b < kBins; ++b) {
        bmn[b] = {inf, inf, inf};
        bmx[b] = {-inf, -inf, -inf};
      }
      std::vector<uint8_t> bin_of(n);
      for (int i = 0; i < n; ++i) {
        int b = static_cast<int>((caxis(ids[i]) - corigin) * scale);
        b = std::min(std::max(b, 0), kBins - 1);
        bin_of[i] = static_cast<uint8_t>(b);
        ++counts[b];
        bmn[b] = vmin(bmn[b], tri_min[ids[i]]);
        bmx[b] = vmax(bmx[b], tri_max[ids[i]]);
      }

      // Sweep: cost(split after bin k) = SA_L*N_L + SA_R*N_R.
      double lsa[kBins];
      long lcounts[kBins];
      {
        V3 lmn = {inf, inf, inf}, lmx = {-inf, -inf, -inf};
        long lc = 0;
        for (int k = 0; k < kBins - 1; ++k) {
          if (counts[k]) {
            lmn = vmin(lmn, bmn[k]);
            lmx = vmax(lmx, bmx[k]);
          }
          lc += counts[k];
          lcounts[k] = lc;
          lsa[k] = lc ? surface(lmn, lmx) : 0.0;
        }
      }
      double best_cost = std::numeric_limits<double>::infinity();
      int best_k = -1;
      {
        V3 rmn = {inf, inf, inf}, rmx = {-inf, -inf, -inf};
        long rc = 0;
        for (int k = kBins - 2; k >= 0; --k) {
          if (counts[k + 1]) {
            rmn = vmin(rmn, bmn[k + 1]);
            rmx = vmax(rmx, bmx[k + 1]);
          }
          rc += counts[k + 1];
          if (lcounts[k] == 0 || rc == 0) continue;
          double cost = lsa[k] * lcounts[k] + surface(rmn, rmx) * rc;
          if (cost < best_cost) {
            best_cost = cost;
            best_k = k;
          }
        }
      }

      if (best_k < 0) {
        // No useful SAH split: median split along the axis (stable).
        mid = n / 2;
        std::stable_sort(ids, ids + n, [&](int32_t a, int32_t b) {
          return caxis(a) < caxis(b);
        });
      } else {
        // Stable partition keeps relative id order within each side,
        // matching numpy boolean-mask selection.
        std::vector<int32_t> left, right;
        left.reserve(n);
        right.reserve(n);
        for (int i = 0; i < n; ++i) {
          (bin_of[i] <= best_k ? left : right).push_back(ids[i]);
        }
        mid = static_cast<int>(left.size());
        std::copy(left.begin(), left.end(), ids);
        std::copy(right.begin(), right.end(), ids + mid);
      }
    }

    build(ids, mid);  // first child at node+1 (DFS)
    right_child[node] = build(ids + mid, n - mid);
    return node;
  }
};

}  // namespace

extern "C" {

int bvh_build(const float *v0, const float *v1, const float *v2, int n_tris,
              int leaf_size, float *bbox_min_out, float *bbox_max_out,
              int32_t *miss_link_out, int32_t *leaf_start_out,
              int32_t *leaf_count_out, int32_t *tri_order_out,
              int32_t *n_nodes_out) {
  if (n_tris <= 0 || leaf_size <= 0) return 1;

  std::vector<V3> tmin(n_tris), tmax(n_tris), cent(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    V3 a = {v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    V3 b = {v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
    V3 c = {v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
    tmin[i] = vmin(vmin(a, b), c);
    tmax[i] = vmax(vmax(a, b), c);
    cent[i] = {(tmin[i].x + tmax[i].x) * 0.5f, (tmin[i].y + tmax[i].y) * 0.5f,
               (tmin[i].z + tmax[i].z) * 0.5f};
  }

  Builder bld;
  bld.tri_min = tmin.data();
  bld.tri_max = tmax.data();
  bld.centroid = cent.data();
  bld.leaf_size = leaf_size;
  bld.bbox_min.reserve(2 * n_tris);
  bld.bbox_max.reserve(2 * n_tris);

  std::vector<int32_t> ids(n_tris);
  std::iota(ids.begin(), ids.end(), 0);
  bld.build(ids.data(), n_tris);

  const int n = static_cast<int>(bld.bbox_min.size());

  // Thread miss-links: node i's miss target is the escape of its subtree.
  std::vector<int32_t> miss(n, kSentinel);
  {
    std::vector<std::pair<int32_t, int32_t>> stack;
    stack.emplace_back(0, kSentinel);
    while (!stack.empty()) {
      auto [i, esc] = stack.back();
      stack.pop_back();
      miss[i] = esc;
      if (bld.leaf_count[i] == 0) {  // internal: children i+1, right[i]
        stack.emplace_back(i + 1, bld.right_child[i]);
        stack.emplace_back(bld.right_child[i], esc);
      }
    }
  }

  for (int i = 0; i < n; ++i) {
    bbox_min_out[3 * i] = bld.bbox_min[i].x;
    bbox_min_out[3 * i + 1] = bld.bbox_min[i].y;
    bbox_min_out[3 * i + 2] = bld.bbox_min[i].z;
    bbox_max_out[3 * i] = bld.bbox_max[i].x;
    bbox_max_out[3 * i + 1] = bld.bbox_max[i].y;
    bbox_max_out[3 * i + 2] = bld.bbox_max[i].z;
    miss_link_out[i] = miss[i];
    leaf_start_out[i] = bld.leaf_start[i];
    leaf_count_out[i] = bld.leaf_count[i];
  }
  std::copy(bld.tri_order.begin(), bld.tri_order.end(), tri_order_out);
  *n_nodes_out = n;
  return 0;
}

}  // extern "C"
