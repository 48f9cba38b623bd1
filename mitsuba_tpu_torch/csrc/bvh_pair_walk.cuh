// The two-child-box BVH walk of the BVH megakernels (csrc/megakernel_bvh.cu,
// sm_90a, the counterparts of mitsuba_tpu/ops/pallas/megakernel.py's
// megakernel_trace_bvh and megakernel_bounce_bvh): the hit queries of
// csrc/bvh_walk.cuh's miss-link walk, with fewer dependent steps.
//
// What holds the miss-link walk back on this card is latency and
// divergence: each visited node is one round trip to L2 (box and meta,
// ~20 MB of tables at 82k faces) before the walk knows where to go, a
// child's box is fetched only on arrival at the child, and the lanes of a
// warp visit different nodes, and different counts of them (the plain
// version counts about half the lanes busy past the first bounce:
// PERF.md).  This walk fetches, at an inner node, one
// 64-byte record that holds the boxes of BOTH children (Aila & Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009), so
// a child that is missed costs no fetch, a leaf child's triangles are
// tested at once, only inner children that are hit cost a step, and when
// both are hit the nearer goes first, which lets the closest walk clip
// more boxes by its best t.
//
// - Records (ops/bvh.py pack_node_pairs): one per inner node of
//   ops/bvh.py's tree, whose children are n + 1 and miss[n + 1] in the DFS
//   layout; record 0 is a super-root whose left child is the root, so the
//   root's box is tested like any other.  Four float4:
//     (L.lo.x, L.hi.x, L.lo.y, L.hi.y), (R.lo.x, R.hi.x, R.lo.y, R.hi.y),
//     (L.lo.z, L.hi.z, R.lo.z, R.hi.z), int (L link, R link, 0, 0);
//   a link >= 1 is an inner child's record, a link < 0 a leaf child,
//   ~(first << 3 | count).  The super-root's right box is NaN, which no
//   ray hits (tfar is NaN and tnear <= NaN is false).
// - Both children's boxes are tested at the parent with the miss-link
//   walk's slab test split at its clip: that walk hits a box on arrival
//   iff tnear <= min(box tfar, best, maxt), and tnear <= min(a, b) iff
//   tnear <= a and tnear <= b, so the box part is decided at the parent
//   and, for the child that waits on the stack with its tnear, the best
//   part again at its pop; best only falls, so a child that fails at the
//   parent would fail later too.
// - The results are the miss-link walk's.  An any-hit walk clips at maxt
//   alone until it stops at its first hit, so the leaves it reaches do not
//   depend on the order, nor does whether one of them occludes.  The
//   closest walk returns the least (t, slot) over the triangles it hits:
//   a strictly smaller t wins, an equal t the lower slot.  That is the
//   miss-link walk's answer, whose strict < keeps the first of equal t in
//   DFS order, because leaf slots rise in DFS order (tests/test_torch_bvh
//   checks the tree).  Only float rounding could part them: a box that
//   one order clips and the other enters, holding a triangle whose t
//   rounds below the box's tnear.  Over the at-scale frame (1,048,576
//   lanes of the single launch, each depth of the per-depth pipeline)
//   every lane equals the miss-link walk's kernels bit for bit
//   (utils/compare_designs.py, PERF.md).
// - The stack holds at most one entry per inner node on the path from the
//   root, so the tree's depth bounds it; the wrapper raises for a tree
//   deeper than PAIR_STACK.
// - tri_test and the safe_rcp slabs are those of bvh_walk.cuh.
#pragma once

#include "bvh_walk.cuh"

namespace mk {

// The deepest tree the walk takes (entries of its stack).
constexpr int PAIR_STACK = 32;

// The slab test of bvh_walk.cuh split at its clip: whether the ray meets
// the box at all (tnear <= box tfar) and below `lim`.  Stores tnear.
__device__ __forceinline__ bool box_hit(float lox, float hix, float loy,
                                        float hiy, float loz, float hiz,
                                        float ox, float oy, float oz,
                                        float ix, float iy, float iz,
                                        float lim, float& tnear) {
  const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy, t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz, t1z = (hiz - oz) * iz;
  tnear = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                      fminf(t0z, t1z)),
                0.0f);
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tnear <= tfar && tnear <= lim;
}

// Provides the hit query of path_common.cuh's `bounce`.
struct PairQuery {
  const float4* node;    // 4 per record
  const float4* geo;     // 3 per leaf slot: [p0 | e1 | e2 | 0 0 0]
  const int32_t* face;   // face id of each leaf slot

  // Tests the triangles of leaf `link`.  ANY: returns true at the first
  // hit within maxt, with its t and slot in best and slot.  Else keeps the
  // least (t, slot) in (best, slot).
  template <bool ANY>
  __device__ __forceinline__ bool leaf(int link, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz, float maxt, float& best,
                                       int& slot) const {
    const int first = ~link >> 3, count = ~link & 7;
    for (int j = 0; j < count; ++j) {
      const int sj = first + j;
      const float4 a = __ldg(geo + 3 * sj);
      const float4 b = __ldg(geo + 3 * sj + 1);
      const float4 c = __ldg(geo + 3 * sj + 2);
      const float g[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
      float tj;
      if (ANY) {
        if (tri_test(g, ox, oy, oz, dx, dy, dz, maxt, tj)) {
          best = tj;
          slot = sj;
          return true;
        }
      } else if (tri_test(g, ox, oy, oz, dx, dy, dz, best, tj) &&
                 (tj < best || (tj == best && sj < slot))) {
        best = tj;
        slot = sj;
      }
    }
    return false;
  }

  // Returns the winning leaf slot or -1.  ANY: the first hit within maxt.
  template <bool ANY>
  __device__ __forceinline__ int walk(float ox, float oy, float oz,
                                      float dx, float dy, float dz,
                                      float maxt, float& t) const {
    const float ix = safe_rcp(dx), iy = safe_rcp(dy), iz = safe_rcp(dz);
    float best = CUDART_INF_F;
    int slot = -1;
    int2 stack[PAIR_STACK];  // (link, tnear bits) of the children put off
    int sp = 0;
    int rec = 0;  // an inner node whose box was hit; 0 once none is left
    do {
      const float4 a = __ldg(node + 4 * rec);
      const float4 b = __ldg(node + 4 * rec + 1);
      const float4 c = __ldg(node + 4 * rec + 2);
      const int4 l = __ldg(reinterpret_cast<const int4*>(node) + 4 * rec + 3);
      const float lim = fminf(best, maxt);
      float tl, tr;
      const bool hl = box_hit(a.x, a.y, a.z, a.w, c.x, c.y, ox, oy, oz, ix,
                              iy, iz, lim, tl);
      const bool hr = box_hit(b.x, b.y, b.z, b.w, c.z, c.w, ox, oy, oz, ix,
                              iy, iz, lim, tr);
      // both hit: the nearer child next (the left on a tie), the other on
      // the stack
      const bool right_first = hl && hr && tr < tl;
      int next = hl ? l.x : (hr ? l.y : 0);
      if (hl && hr) {
        stack[sp++] = right_first ? make_int2(l.x, __float_as_int(tl))
                                  : make_int2(l.y, __float_as_int(tr));
        if (right_first) next = l.y;
      }
      rec = 0;
      if (next > 0) {
        rec = next;
      } else if (next < 0 &&
                 leaf<ANY>(next, ox, oy, oz, dx, dy, dz, maxt, best, slot)) {
        t = best;
        return slot;
      }
      // the children put off, the last first, until one is an inner node
      // still in reach
      while (rec == 0 && sp > 0) {
        const int2 e = stack[--sp];
        if (!(__int_as_float(e.y) <= fminf(best, maxt))) continue;
        if (e.x > 0) {
          rec = e.x;
        } else if (leaf<ANY>(e.x, ox, oy, oz, dx, dy, dz, maxt, best, slot)) {
          t = best;
          return slot;
        }
      }
    } while (rec != 0);
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

}  // namespace mk
