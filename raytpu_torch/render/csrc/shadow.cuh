// The group walk of the box-culled kernels: one warp's 32 rays against the
// 8-triangle groups of their worklist row.  Twelve kernels walk it:
//
//   K4 (packed.cu) and K11b (mega3.cu): any-hit toward one light,
//     8-triangle groups, the 8-float box records (accel.shadow_boxes);
//   K2b (mega2.cu): any-hit, 8-triangle groups, the 32-float normal
//     records (accel.normal_boxes);
//   K9 and K10 (chunked.cu): any-hit, 128-triangle chunks, each entry
//     expanded to its 16 groups in ascending order, the normal records;
//   K8 (chunked.cu): the closest hit, or in its shadow mode the first
//     occluder's t (FirstHitVisit), 128-triangle chunks expanded as K9's,
//     the normal records;
//   K5 (soft.cu): the soft transmittance, 8-triangle groups, the normal
//     records padded for the sigmoid's support (normal_boxes(soft_beta=...));
//   K7 (soft.cu): the soft transmittance's gradient on the triangles,
//     K5's worklists, the normal records padded for the gradient's support
//     (normal_boxes(soft_beta=..., support=GRAD_SUPPORT)), its sums taken
//     per warp after each group (a visit with kReduces);
//   K6 (soft.cu): the same gradient on the rays, K7's worklists and
//     records, each lane summing its own partials (DrayVisit);
//   K3 (packed.cu), K11a (mega3.cu) and K2a (mega2.cu; K11a's body,
//     closest.cuh): the closest hit, 8-triangle groups, the normal records
//     (kappa's are 2.6-4.7x slower there: shadow_ablation.py).
//
// A worklist row is the union over a whole 1024-ray tile (the glue's cull,
// raytpu_torch/render/packed.py and mega2.py), hundreds to thousands of
// groups a row on bunny300k, of which a single ray's segment crosses the
// boxes of a few (chip_smoke.py phase 4 prints the counts).
// So the walk tests boxes before triangles, at two levels:
//
//   1. the warp's bundle: lane j takes entry base + j of the expanded row
//      and tests its group's box against the bounds of every live ray of
//      the warp (origins, reciprocal directions, the longest segment, and
//      the directions for the normal records): one test a group a warp
//      instead of one a ray;
//   2. each ray: for the entries that pass, one after the other, every live
//      lane tests its own segment [0, mag] against the box (seg_box), and
//      the warp visits the group's triangles only if some lane passed
//      (__any_sync); a lane visits them only where its own test passed.
//
// Both tests are conservative: neither rejects a group in which tri_t
// reports a hit in [0, mag], nor, with the soft records, one holding a
// triangle whose soft factor 1 - occ is not exactly 1.0f, nor, with the
// gradient records, one holding a triangle whose partials are not all
// exactly 0.0f.  A box record is the group's AABB padded by 1e-4 of its
// largest coordinate plus 1e-4, and two numbers
// by which each ray widens it further: tri_t's float32 Cramer solve can
// name a hit point as far as 13.2 |e1| |e2| |o - v0| off the segment when
// the ray grazes the triangle's plane (ops/accel.py derives it), so the
// box grows by kappa |o - c|_1 + kappa h for a ray from o (widen).  The
// normal records scale that widening by 2u / a_lo <= 1, a_lo a lower bound
// of the determinant |e1 . (d x e2)| over the group's triangles for the
// ray's direction, from its eight triangles' normals (ray_scale);
// ops/accel.py derives it step by step: 1 at the grazing worst case, a few
// ulps of the scene for a ray far from grazing.  The ray's [tmin, mag) is
// taken as [0, mag]; a direction component below 1e-30 takes that value,
// sign kept, so its reciprocal is finite and no (face - origin) * (1 / 0)
// = 0 * inf = NaN arises; a ray that passes seg_box passes bundle_box, in
// float32 too, because the bundle widens the box for its farthest origin
// and its least bound of each |n_k . d| and tests the corner products of
// the same monotone roundings.  The occlusion does not depend on which triangles
// are tested or in what order, so it equals the walk over every listed
// triangle bit for bit; the soft product skips only factors of exactly
// 1.0f and multiplies the others in the row's order, so it too equals the
// walk over every listed triangle bit for bit (ops/accel.py has the torch
// twins of the two tests, held against the plain triangle tests by
// tests/test_torch_shadow_boxes.py).
//
// The closest walk (ClosestVisit) shrinks each lane's segment as it goes:
// mag is the lane's current closest t, inf until its first hit (spheres
// and planes are folded before the walk, so a wall usually sets it), and
// the bundle's longest segment is taken again, over the live lanes'
// current t, for every batch of 32 entries.  A hit that tri_t reports at
// tc < t_cur lies on the segment [0, t_cur], so it lies inside the box
// widened for that segment: the derivation in ops/accel.py bounds where
// tri_t places a hit for a hit at any t, and mag enters only the slab
// test's last comparison tn <= mag, so it holds for every mag, inf
// included.  A group is skipped only where no triangle of it can report a
// t below t_cur, and t_cur only falls, so a skipped group never holds the
// winner; a group that could tie the current t is entered by t_cur and so
// visited, and the entries keep the row's ascending order with the strict
// < update, so a tie still goes to the first primitive.  The walk returns
// what the fold over every listed triangle returns, bit for bit.
//
// The first-occluder walk (FirstHitVisit) visits the groups in the row's
// order and a group's triangles in order, and skips only groups holding no
// hit of the segment, so the occluder it stops at is the first of the row
// and its t equals the fold's bit for bit.  The gradient walks (K7, K6)
// skip only groups whose sigmoid derivative is exactly 0.0f for every
// triangle, so their sums add the same nonzero partials as the walk over
// every listed group: K7's in another order (atomics: not bit for bit),
// K6's, which a lane adds in the row's order, bit for bit.
//
// An any-hit warp leaves the row as soon as every lane is resolved
// (__all_sync over occluded, out of the frame or not queried), instead of
// waiting for the whole block; the soft and the closest walks never stop
// early (a closest query is resolved only at the end of its row).  The walk
// keeps common.cuh's tri_t with its IEEE division: it decides every
// shadow and every winner.
#pragma once

#include "common.cuh"

namespace raytpu_dev {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kDirFloor = 1e-30f;

// 1 / d with |d| raised to kDirFloor, sign kept (accel.inv_dir)
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < kDirFloor ? copysignf(kDirFloor, d) : d);
}

constexpr int kBoxCols = 8;    // lo(3) hi(3) kappa kappa*h (accel.shadow_boxes)
// ... then the eight normals n_k(3) (accel.normal_boxes); the walk holds
// the first kBoxCols in registers
constexpr int kNormalCols = 32;
// ea per unit kappa (accel.TRI_SLACK): 1.25 u
constexpr float kTriSlack = 0x1.4p-24f;

// Box b's faces widened by kappa * dist + kappa * h (accel._faces); the
// multiply and the add round apart (-fmad=false), as the twin's do.
__device__ __forceinline__ void widen(const float* b, float dist, float* lo, float* hi) {
  const float w = b[6] * dist + b[7];
  for (int a = 0; a < 3; ++a) lo[a] = b[a] - w, hi[a] = b[a + 3] + w;
}

// The same widening times `scale` (the normal records).
__device__ __forceinline__ void widen_scaled(const float* b, float dist, float scale, float* lo,
                                             float* hi) {
  const float w = (b[6] * dist + b[7]) * scale;
  for (int a = 0; a < 3; ++a) lo[a] = b[a] - w, hi[a] = b[a + 3] + w;
}

// 2u / max(a_lo, 2u) (accel._scale): exactly 1 where a_lo <= 2u.
__device__ __forceinline__ float scale_of(float a_lo) {
  return kFltEps / fmaxf(a_lo, kFltEps);
}

__device__ __forceinline__ float dot_r(const float* n, const float* d) {
  return (n[0] * d[0] + n[1] * d[1]) + n[2] * d[2];  // rounded as accel._dots
}

// The eight normals n_k(3) of normal record `rec` (global memory).
__device__ __forceinline__ void load_normals(const float* __restrict__ rec, float* n) {
  const float4* n4 = reinterpret_cast<const float4*>(rec + kBoxCols);
  for (int i = 0; i < 6; ++i) {
    const float4 u = n4[i];
    n[4 * i] = u.x, n[4 * i + 1] = u.y, n[4 * i + 2] = u.z, n[4 * i + 3] = u.w;
  }
}

// 2u / a_lo for `least` the least |n_k . d| of record b's normals, a_lo =
// least - kappa * kTriSlack (accel._scale_of_least).
__device__ __forceinline__ float least_scale(const float* b, float least) {
  return scale_of(least - b[6] * kTriSlack);
}

// A ray's scale (accel._ray_scale): from the least |n_k . d| of the
// group's normals.
__device__ __forceinline__ float ray_scale(const float* b, const float* __restrict__ rec,
                                           const float* d) {
  float n[24];
  load_normals(rec, n);
  float least = INFINITY;
  for (int k = 0; k < 8; ++k) least = fminf(least, fabsf(dot_r(n + 3 * k, d)));
  return least_scale(b, least);
}

// The least |(n0 d0 + n1 d1) + n2 d2| over directions in [dlo, dhi]
// (accel._least_abs_dot): the interval from the products at both ends of
// each component, its least magnitude, 0 where it holds 0.
__device__ __forceinline__ float least_abs_dot(const float* n, const float* dlo,
                                               const float* dhi) {
  float lo = 0.0f, hi = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float p0 = n[a] * dlo[a], p1 = n[a] * dhi[a];
    lo = a ? lo + fminf(p0, p1) : fminf(p0, p1);
    hi = a ? hi + fmaxf(p0, p1) : fmaxf(p0, p1);
  }
  return (lo <= 0.0f && hi >= 0.0f) ? 0.0f : fminf(fabsf(lo), fabsf(hi));
}

// The slab test of the segment o + t/inv, t in [0, mag], against box b
// widened for a ray from o (accel.segment_box_test), and for the normal
// records (b their first kBoxCols floats, rec the record) for its
// direction d.  A NaN origin or length makes the comparisons false: tri_t
// finds no hit for it either.
template <bool kNormals>
__device__ __forceinline__ bool seg_box(const float* b, const float* __restrict__ rec,
                                        const float* o, const float* inv, const float* d,
                                        float mag) {
  // the narrowed box lies inside kappa's (scale <= 1; every rounding is
  // monotone), so kappa's cheaper test decides every ray it rejects
  if constexpr (kNormals) {
    if (!seg_box<false>(b, rec, o, inv, d, mag)) return false;
  }
  float dd[3], lo[3], hi[3];
  for (int a = 0; a < 3; ++a) dd[a] = fabsf(o[a] - (b[a] + b[a + 3]) * 0.5f);
  if constexpr (kNormals) {
    widen_scaled(b, dd[0] + dd[1] + dd[2], ray_scale(b, rec, d), lo, hi);
  } else {
    widen(b, dd[0] + dd[1] + dd[2], lo, hi);
  }
  float near[3], far[3];
  for (int a = 0; a < 3; ++a) {
    const float t1 = (lo[a] - o[a]) * inv[a], t2 = (hi[a] - o[a]) * inv[a];
    near[a] = fminf(t1, t2), far[a] = fmaxf(t1, t2);
  }
  const float tn = fmaxf(fmaxf(near[0], near[1]), near[2]);
  const float tf = fminf(fminf(far[0], far[1]), far[2]);
  return tn <= tf && tf >= 0.0f && tn <= mag;
}

// The bounds of the warp's live rays: origins, reciprocal directions, the
// longest segment and, for the normal records, the directions
// (accel.bundle_bounds).
struct Bundle {
  float olo[3], ohi[3], ilo[3], ihi[3], dlo[3], dhi[3], tmax;
};

__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFullWarp, x, off));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullWarp, x, off));
  return x;
}

template <bool kNormals>
__device__ __forceinline__ Bundle warp_bundle(bool live, const float* o, const float* inv,
                                              const float* d, float mag) {
  Bundle q;
  for (int a = 0; a < 3; ++a) {
    q.olo[a] = warp_min(live ? o[a] : INFINITY);
    q.ohi[a] = warp_max(live ? o[a] : -INFINITY);
    q.ilo[a] = warp_min(live ? inv[a] : INFINITY);
    q.ihi[a] = warp_max(live ? inv[a] : -INFINITY);
    if constexpr (kNormals) {
      q.dlo[a] = warp_min(live ? d[a] : INFINITY);
      q.dhi[a] = warp_max(live ? d[a] : -INFINITY);
    }
  }
  q.tmax = warp_max(live ? mag : -INFINITY);
  return q;
}

// Could some ray of the bundle cross box b (accel.bundle_box_test)?  The
// box is widened for the bundle's farthest origin, per axis the larger of
// |olo - c| and |ohi - c|, and for the normal records by the least bound
// of each |n_k . d| over the bundle's directions (least_abs_dot).  Per
// axis, the extremes of (face - origin) * reciprocal over the bundle lie
// at the corner products.
template <bool kNormals>
__device__ __forceinline__ bool bundle_box(const Bundle& q, const float* b,
                                           const float* __restrict__ rec) {
  if constexpr (kNormals) {  // as seg_box: kappa's test first
    if (!bundle_box<false>(q, b, rec)) return false;
  }
  float d[3], lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const float c = (b[a] + b[a + 3]) * 0.5f;
    d[a] = fmaxf(fabsf(q.olo[a] - c), fabsf(q.ohi[a] - c));
  }
  if constexpr (kNormals) {
    float n[24];
    load_normals(rec, n);
    float least = INFINITY;
    for (int k = 0; k < 8; ++k) least = fminf(least, least_abs_dot(n + 3 * k, q.dlo, q.dhi));
    widen_scaled(b, d[0] + d[1] + d[2], least_scale(b, least), lo, hi);
  } else {
    widen(b, d[0] + d[1] + d[2], lo, hi);
  }
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

// The any-hit visit: tri_t on triangles [k0, k1) of the group, triangle
// culling inverted, stopping at the first occluder.
template <int kRec>
struct AnyHitVisit {
  static constexpr bool kStops = true;  // a lane is resolved at its first occluder
  static constexpr bool kShrinks = false;
  static constexpr bool kReduces = false;
  float ox, oy, oz, dx, dy, dz, tmin, mag;
  bool occ = false;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    for (int k = k0; k < k1; ++k) {
      if (tri_t(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz, tmin, mag, true) < INFINITY) {
        occ = true;
        break;
      }
    }
  }
  __device__ __forceinline__ bool resolved() const { return occ; }
};

// The first-occluder visit (K8's shadow mode): as AnyHitVisit, keeping the
// occluder's t, inf while none is found.
template <int kRec>
struct FirstHitVisit {
  static constexpr bool kStops = true;
  static constexpr bool kShrinks = false;
  static constexpr bool kReduces = false;
  float ox, oy, oz, dx, dy, dz, tmin, mag;
  float t = INFINITY;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    for (int k = k0; k < k1 && t == INFINITY; ++k)
      t = tri_t(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz, tmin, mag, true);
  }
  __device__ __forceinline__ bool resolved() const { return t < INFINITY; }
};

// The closest visit: tri_t on triangles [k0, k1) of the group, culling not
// inverted, with the strict < update that keeps the first triangle on a
// tie.  `t` starts at the spheres' and planes' winner; `k` is the winning
// triangle, -1 while none has won.
template <int kRec>
struct ClosestVisit {
  static constexpr bool kStops = false;   // resolved only at the end of the row
  static constexpr bool kShrinks = true;  // the segment ends at the current t
  static constexpr bool kReduces = false;
  float ox, oy, oz, dx, dy, dz, tmin, t;
  int k = -1;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    for (int j = k0; j < k1; ++j) {
      const float tc = tri_t(tri + (size_t)j * kRec, ox, oy, oz, dx, dy, dz, tmin, INFINITY, false);
      if (tc < t) {
        t = tc;
        k = j;
      }
    }
  }
  __device__ __forceinline__ bool resolved() const { return false; }
};

// The end of a lane's segment: the visit's current t for the closest walk,
// else the query's fixed length.
template <class Visit>
__device__ __forceinline__ float seg_end(const Visit& visit, float mag) {
  if constexpr (Visit::kShrinks) {
    return visit.t;
  } else {
    return mag;
  }
}

// One warp's walk over one worklist row; every lane of the warp calls it
// together.  kRec: floats a triangle record, v0 e1 e2 n cull first; kCols:
// kBoxCols or kNormalCols; kExpand: groups an entry (1 for a list of groups,
// 16 for a list of 128-triangle chunks); `visit` is called with each group
// this lane's segment crosses, in the row's order (AnyHitVisit,
// FirstHitVisit or ClosestVisit above, or soft.cu's product and gradient),
// and, where it has kReduces, its warp-collective reduce(tri, k0, k1) on
// every lane after each group some lane visited.  `live`: this lane's ray is
// queried and not yet resolved (occluded by a sphere or plane).  `mag`: the
// segment's length, unless the visit shrinks it (seg_end).  boxes: (ceil(T/8), kCols)
// records, 16-byte aligned; w: the row's `c` entries.
template <int kRec, int kCols, int kExpand, class Visit>
__device__ __forceinline__ void group_walk(const float* __restrict__ tri, int T,
                                           const float* __restrict__ boxes,
                                           const int* __restrict__ w, int c, bool live,
                                           const float* o, const float* d, float mag,
                                           Visit& visit) {
  constexpr bool kNormals = kCols == kNormalCols;
  constexpr int kGroupTris = 8;
  if (!__any_sync(kFullWarp, live)) return;
  const int lane = threadIdx.x % 32;
  const int ng = (T + kGroupTris - 1) / kGroupTris;

  const float inv[3] = {inv_dir(d[0]), inv_dir(d[1]), inv_dir(d[2])};
  Bundle q = warp_bundle<kNormals>(live, o, inv, d, seg_end(visit, mag));
  const int n = c * kExpand;
  for (int base = 0; base < n; base += 32) {
    if constexpr (Visit::kShrinks) {  // the live lanes' current t
      if (base) q.tmax = warp_max(live ? seg_end(visit, mag) : -INFINITY);
    }
    const int e = base + lane;
    // a negative entry gives g < 0, a chunk past the scene g >= ng
    int g = e < n ? w[e / kExpand] * kExpand + e % kExpand : -1;
    if (g >= ng) g = -1;  // not a group of this scene
    float b[kBoxCols];  // held in registers
    for (int i = 0; i < kBoxCols; ++i) b[i] = 0.0f;
    bool cand = false;
    if (g >= 0) {
      const float4* b4 = reinterpret_cast<const float4*>(boxes + kCols * (size_t)g);
      for (int i = 0; i < kBoxCols / 4; ++i) {
        const float4 u = b4[i];
        b[4 * i] = u.x, b[4 * i + 1] = u.y, b[4 * i + 2] = u.z, b[4 * i + 3] = u.w;
      }
      cand = bundle_box<kNormals>(q, b, boxes + kCols * (size_t)g);
    }
    unsigned todo = __ballot_sync(kFullWarp, cand);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int gj = __shfl_sync(kFullWarp, g, j);
      float bj[kBoxCols];
      for (int i = 0; i < kBoxCols; ++i) bj[i] = __shfl_sync(kFullWarp, b[i], j);
      const bool pass = live && seg_box<kNormals>(bj, boxes + kCols * (size_t)gj, o, inv, d,
                                                  seg_end(visit, mag));
      if (!__any_sync(kFullWarp, pass)) continue;
      if (pass) visit(tri, gj * kGroupTris, min(gj * kGroupTris + kGroupTris, T));
      if constexpr (Visit::kReduces) visit.reduce(tri, gj * kGroupTris,
                                                  min(gj * kGroupTris + kGroupTris, T));
      if constexpr (Visit::kStops) {
        live = live && !visit.resolved();
        if (__all_sync(kFullWarp, !live)) return;  // every lane resolved
      }
    }
  }
}

// The any-hit walk: whether a triangle occludes this lane's segment [tmin,
// mag) (false for a lane that is not live).  K4 and K11b: 8-triangle groups,
// the 8-float box records (the defaults); K2b: 8-triangle groups, the
// normal records (kNormalCols); K9: 128-triangle chunks (kExpand 16), the
// normal records.
template <int kRec, int kCols = kBoxCols, int kExpand = 1>
__device__ __forceinline__ bool shadow_walk(const float* __restrict__ tri, int T,
                                            const float* __restrict__ boxes,
                                            const int* __restrict__ w, int c, bool live,
                                            float ox, float oy, float oz, float dx, float dy,
                                            float dz, float tmin, float mag) {
  AnyHitVisit<kRec> visit{ox, oy, oz, dx, dy, dz, tmin, mag};
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
  group_walk<kRec, kCols, kExpand>(tri, T, boxes, w, c, live, o, d, mag, visit);
  return visit.occ;
}

// The closest walk with the normal records: the lane's closest triangle
// hit below `visit.t`, folded into `visit` (t, k), for the lanes that are
// live (valid rays).  K3 and K11a: a list of 8-triangle groups (kExpand
// 1); K8: of 128-triangle chunks (kExpand 16).
template <int kRec, int kExpand = 1>
__device__ __forceinline__ void closest_walk(const float* __restrict__ tri, int T,
                                             const float* __restrict__ boxes,
                                             const int* __restrict__ w, int c, bool live,
                                             ClosestVisit<kRec>& visit) {
  const float o[3] = {visit.ox, visit.oy, visit.oz}, d[3] = {visit.dx, visit.dy, visit.dz};
  group_walk<kRec, kNormalCols, kExpand>(tri, T, boxes, w, c, live, o, d, INFINITY, visit);
}

}  // namespace raytpu_dev
