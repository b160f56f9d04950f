// The shadow any-hit walk of K4 (packed.cu) and K11b (mega3.cu): one warp's
// 32 shadow rays toward one light against the 8-triangle groups of their
// (tile, light) worklist, each ray stopping at its first occluder.
//
// A worklist row is the union over a whole 1024-ray tile (the glue's cull,
// raytpu_torch/render/packed.py and mega2.py), hundreds to thousands of
// groups a row on bunny300k, of which a single ray's segment crosses the
// boxes of a few (chip_smoke.py phase 4 prints the counts).
// So the walk tests boxes before triangles, at two levels:
//
//   1. the warp's bundle: lane j takes entry base + j of the row and tests
//      its group's box against the bounds of every live ray of the warp
//      (origins, reciprocal directions, the longest segment): one test a
//      group a warp instead of one a ray;
//   2. each ray: for the entries that pass, one after the other, every live
//      lane tests its own segment [0, mag] against the box (seg_box), and
//      the warp runs the group's triangles only if some lane passed
//      (__any_sync); a lane runs tri_t only where its own test passed.
//
// Both tests are conservative: neither rejects a group in which tri_t
// reports a hit.  A box record (accel.shadow_boxes) is the group's AABB
// padded by 1e-4 of its largest coordinate plus 1e-4, and two numbers by
// which each ray widens it further: tri_t's float32 Cramer solve can name
// a hit point as far as 13.2 |e1| |e2| |o - v0| off the segment when the
// ray grazes the triangle's plane (ops/accel.py derives it), so the box
// grows by kappa |o - c|_1 + kappa h for a ray from o (widen).  The ray's
// [tmin, mag) is taken as [0, mag]; a direction component below 1e-30 takes
// that value, sign kept, so its reciprocal is finite and no
// (face - origin) * (1 / 0) = 0 * inf = NaN arises; a ray that passes
// seg_box passes bundle_box, in float32 too, because the bundle widens the
// box for its farthest origin and tests the corner products of the same
// monotone roundings.  The occlusion does not depend on which triangles are
// tested or in what order, so it equals the walk over every listed
// triangle bit for bit (ops/accel.py has the torch twins of the two tests,
// held against the plain triangle test by tests/test_torch_shadow_boxes.py).
//
// The warp leaves the row as soon as every lane is resolved (__all_sync
// over occluded, out of the frame or not queried), instead of waiting for
// the whole block.  The walk keeps common.cuh's tri_t with its IEEE
// division: it decides every shadow.
#pragma once

#include "common.cuh"

namespace raytpu_dev {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kDirFloor = 1e-30f;

// 1 / d with |d| raised to kDirFloor, sign kept (accel.inv_dir)
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < kDirFloor ? copysignf(kDirFloor, d) : d);
}

constexpr int kBoxCols = 8;  // lo(3) hi(3) kappa kappa*h (accel.shadow_boxes)

// Box b's faces widened by kappa * dist + kappa * h (accel._faces); the
// multiply and the add round apart (-fmad=false), as the twin's do.
__device__ __forceinline__ void widen(const float* b, float dist, float* lo, float* hi) {
  const float w = b[6] * dist + b[7];
  for (int a = 0; a < 3; ++a) lo[a] = b[a] - w, hi[a] = b[a + 3] + w;
}

// The slab test of the segment o + t/inv, t in [0, mag], against box b
// widened for a ray from o (accel.segment_box_test).  A NaN origin or
// length makes the comparisons false: tri_t finds no hit for it either.
__device__ __forceinline__ bool seg_box(const float* b, const float* o, const float* inv,
                                        float mag) {
  float d[3], lo[3], hi[3];
  for (int a = 0; a < 3; ++a) d[a] = fabsf(o[a] - (b[a] + b[a + 3]) * 0.5f);
  widen(b, d[0] + d[1] + d[2], lo, hi);
  float near[3], far[3];
  for (int a = 0; a < 3; ++a) {
    const float t1 = (lo[a] - o[a]) * inv[a], t2 = (hi[a] - o[a]) * inv[a];
    near[a] = fminf(t1, t2), far[a] = fmaxf(t1, t2);
  }
  const float tn = fmaxf(fmaxf(near[0], near[1]), near[2]);
  const float tf = fminf(fminf(far[0], far[1]), far[2]);
  return tn <= tf && tf >= 0.0f && tn <= mag;
}

// The bounds of the warp's live rays: origins, reciprocal directions and the
// longest segment (accel.bundle_bounds).
struct Bundle {
  float olo[3], ohi[3], ilo[3], ihi[3], tmax;
};

__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFullWarp, x, off));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullWarp, x, off));
  return x;
}

__device__ __forceinline__ Bundle warp_bundle(bool live, const float* o, const float* inv,
                                              float mag) {
  Bundle q;
  for (int a = 0; a < 3; ++a) {
    q.olo[a] = warp_min(live ? o[a] : INFINITY);
    q.ohi[a] = warp_max(live ? o[a] : -INFINITY);
    q.ilo[a] = warp_min(live ? inv[a] : INFINITY);
    q.ihi[a] = warp_max(live ? inv[a] : -INFINITY);
  }
  q.tmax = warp_max(live ? mag : -INFINITY);
  return q;
}

// Could some ray of the bundle cross box b (accel.bundle_box_test)?  The
// box is widened for the bundle's farthest origin, per axis the larger of
// |olo - c| and |ohi - c|; per axis, the extremes of (face - origin) *
// reciprocal over the bundle lie at the corner products.
__device__ __forceinline__ bool bundle_box(const Bundle& q, const float* b) {
  float d[3], lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const float c = (b[a] + b[a + 3]) * 0.5f;
    d[a] = fmaxf(fabsf(q.olo[a] - c), fabsf(q.ohi[a] - c));
  }
  widen(b, d[0] + d[1] + d[2], lo, hi);
  float tn = -INFINITY, tf = INFINITY;
  for (int a = 0; a < 3; ++a) {
    float mn = INFINITY, mx = -INFINITY;
    for (int f = 0; f < 2; ++f) {
      const float face = f ? hi[a] : lo[a];
      const float x0 = face - q.ohi[a], x1 = face - q.olo[a];
      const float p0 = x0 * q.ilo[a], p1 = x0 * q.ihi[a], p2 = x1 * q.ilo[a], p3 = x1 * q.ihi[a];
      mn = fminf(mn, fminf(fminf(p0, p1), fminf(p2, p3)));
      mx = fmaxf(mx, fmaxf(fmaxf(p0, p1), fmaxf(p2, p3)));
    }
    tn = fmaxf(tn, mn);
    tf = fminf(tf, mx);
  }
  return tn <= tf && tf >= 0.0f && tn <= q.tmax;
}

// The slot of lane `lane` of warp `warp` (0-31) in a 1024-ray tile laid out
// as 32 rows of 32 (the routes' 32x32 pixel blocks): each warp takes an
// 8x4 block of pixels, whose shadow rays start closer together than a row
// of 32.  Four consecutive warps cover rows 4(warp/4) to 4(warp/4) + 3.
__device__ __forceinline__ int warp_slot(int warp, int lane) {
  return ((warp / 4) * 4 + lane / 8) * 32 + (warp % 4) * 8 + lane % 8;
}

// One warp's any-hit walk toward one light; every lane of the warp calls it
// together.  `live`: this lane's ray is queried and not yet occluded (by a
// sphere or plane).  tri: kRec floats a triangle record, v0 e1 e2 n cull
// first; boxes: (ceil(T/8), kBoxCols) box records; w: the row's `c`
// entries.  Returns whether a triangle occludes this lane's segment
// [tmin, mag) (false for a lane that is not live).
template <int kRec>
__device__ __forceinline__ bool shadow_walk(const float* __restrict__ tri, int T,
                                            const float* __restrict__ boxes,
                                            const int* __restrict__ w, int c, bool live,
                                            float ox, float oy, float oz, float dx, float dy,
                                            float dz, float tmin, float mag) {
  constexpr int kGroupTris = 8;
  if (!__any_sync(kFullWarp, live)) return false;
  const int lane = threadIdx.x % 32;
  const int ng = (T + kGroupTris - 1) / kGroupTris;
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {inv_dir(dx), inv_dir(dy), inv_dir(dz)};
  const Bundle q = warp_bundle(live, o, inv, mag);
  bool occ = false;
  for (int base = 0; base < c; base += 32) {
    const int e = base + lane;
    int g = e < c ? w[e] : -1;
    if (g >= ng) g = -1;  // not a group of this scene
    float b[kBoxCols] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool cand = false;
    if (g >= 0) {
      const float4* b4 = reinterpret_cast<const float4*>(boxes + kBoxCols * (size_t)g);
      const float4 u0 = b4[0], u1 = b4[1];
      b[0] = u0.x, b[1] = u0.y, b[2] = u0.z, b[3] = u0.w;
      b[4] = u1.x, b[5] = u1.y, b[6] = u1.z, b[7] = u1.w;
      cand = bundle_box(q, b);
    }
    unsigned todo = __ballot_sync(kFullWarp, cand);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int gj = __shfl_sync(kFullWarp, g, j);
      float bj[kBoxCols];
      for (int i = 0; i < kBoxCols; ++i) bj[i] = __shfl_sync(kFullWarp, b[i], j);
      const bool pass = live && seg_box(bj, o, inv, mag);
      if (!__any_sync(kFullWarp, pass)) continue;
      if (pass) {
        const int k1 = min(gj * kGroupTris + kGroupTris, T);
        for (int k = gj * kGroupTris; k < k1; ++k) {
          if (tri_t(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz, tmin, mag, true) < INFINITY) {
            occ = true;
            break;
          }
        }
      }
      live = live && !occ;
      if (__all_sync(kFullWarp, !live)) return occ;  // every lane resolved
    }
  }
  return occ;
}

}  // namespace raytpu_dev
