// The stackless miss-link BVH walk of the wavefront's closest-hit and
// any-hit queries, csrc/traverse.cu (sm_90a).  Its walk needs no stack,
// so it takes a tree of any depth.  The BVH megakernels walk
// csrc/bvh_pair_walk.cuh instead, which takes only this file's safe_rcp
// and leaf-slot layout.
//
// - The tree is ops/bvh.py's: nodes in DFS order; an inner node's hit
//   successor is node + 1, miss[node] is where the walk goes when the
//   box is missed or after a leaf, -1 to exit.  Node arrays as
//   ops/traverse.py::pack_bvh_geometry lays them out: box as two float4
//   (lo, 0), (hi, 0), (first, count, miss, 0) as one int4.
// - Leaf triangles in leaf-slot order as [p0 | e1 | e2] in three float4
//   (48 bytes), so a leaf's tests read consecutive memory.
// - Visiting order and the strict < equal ops/bvh.py's plain walk, so
//   ties on shared edges resolve the same way; the slab test keeps
//   _slab_test's exact comparisons over safe_rcp's +-1e30 (no 0 * inf).
#pragma once

#include "path_common.cuh"

namespace mk {

// core/math.py safe_rcp: +-0 -> +-1e30
__device__ __forceinline__ float safe_rcp(float x) {
  return fabsf(x) > 1e-20f ? 1.0f / x : (signbit(x) ? -1e30f : 1e30f);
}

// Provides the hit query of path_common.cuh's `bounce`.
struct BvhQuery {
  const float4* box;      // 2 per node: (lo, 0), (hi, 0)
  const int4* meta;       // (first, count, miss, 0); count 0: inner node
  const float4* geo;      // 3 per leaf slot: [p0 | e1 | e2 | 0 0 0]
  const int32_t* face;    // face id of each leaf slot

  // Returns the winning leaf slot or -1.  ANY: the first hit within maxt.
  template <bool ANY>
  __device__ __forceinline__ int walk(float ox, float oy, float oz,
                                      float dx, float dy, float dz,
                                      float maxt, float& t) const {
    const float ix = safe_rcp(dx), iy = safe_rcp(dy), iz = safe_rcp(dz);
    float best = CUDART_INF_F;
    int slot = -1;
    int node = 0;
    while (node >= 0) {
      const float4 lo = __ldg(box + 2 * node);
      const float4 hi = __ldg(box + 2 * node + 1);
      const int4 m = __ldg(meta + node);
      const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
      const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
      const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
      const float tnear =
          fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                      fminf(t0z, t1z)),
                0.0f);
      const float tfar =
          fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                      fmaxf(t0z, t1z)),
                fminf(best, maxt));
      const bool hit = tnear <= tfar;
      if (hit && m.y > 0) {
        for (int j = 0; j < m.y; ++j) {
          const int sj = m.x + j;
          const float4 a = __ldg(geo + 3 * sj);
          const float4 b = __ldg(geo + 3 * sj + 1);
          const float4 c = __ldg(geo + 3 * sj + 2);
          const float g[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
          float tj;
          if (ANY) {
            if (tri_test(g, ox, oy, oz, dx, dy, dz, maxt, tj)) {
              t = tj;
              return sj;
            }
          } else if (tri_test(g, ox, oy, oz, dx, dy, dz, best, tj) &&
                     tj < best) {
            best = tj;
            slot = sj;
          }
        }
      }
      node = (hit && m.y == 0) ? node + 1 : m.z;
    }
    t = best;
    return slot;
  }

  __device__ __forceinline__ int closest(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t) const {
    const int s = walk<false>(ox, oy, oz, dx, dy, dz, CUDART_INF_F, t);
    return s >= 0 ? __ldg(face + s) : -1;
  }

  __device__ __forceinline__ bool occluded(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float maxt) const {
    float t;
    return walk<true>(ox, oy, oz, dx, dy, dz, maxt, t) >= 0;
  }
};

// The query over the tables' device pointers.
inline BvhQuery make_query(const float* node_box, const int32_t* node_meta,
                           const float* leaf_geo, const int32_t* leaf_face) {
  return BvhQuery{reinterpret_cast<const float4*>(node_box),
                  reinterpret_cast<const int4*>(node_meta),
                  reinterpret_cast<const float4*>(leaf_geo), leaf_face};
}

}  // namespace mk
