// K5, K6 and K7: the differentiable soft-shadow path's kernels for Hopper
// (sm_90a).
//
// K5 (soft_trans) replaces raytpu/render/pallas_soft.py:_make_soft_mega_kernel
// and its streamed form _make_soft_stream_kernel (K5s), reached through
// soft_trans_lights_pallas: for shadow origins p and per-light directions
// and distances, each light's transmittance, the product over primitives of
// (1 - occ) with occ = min(sigmoid(beta * margin), 1 - 1e-6) on the gated
// primitives (raytpu_torch/ops/intersect.py:soft_transmittance) -> (L, R).
// K6 (soft_dray) replaces _make_soft_dray_kernel and _make_dray_stream_kernel
// (K6s), reached through soft_dray_pallas: the ray side of K5's VJP, from
// the upstream cotangent g (L, R) and K5's output, -> g_p (R, 3) summed over
// lights, g_dirs (L, R, 3), g_mags (L, R).  K7 (soft_dprim) replaces
// _make_soft_dprim_kernel, reached through soft_dprim_pallas: the triangle
// side, [g_s, g_e1, g_e2] (T, 9) summed over every ray and light, where s =
// p - v0, e1 = v1 - v0, e2 = v2 - v0 (raytpu_torch/grad/soft.py turns them
// into vertex cotangents).  Eager torch glue (raytpu_torch/render/soft.py)
// builds the worklists and the plain versions.
//
// Records: packed.py:soft_packs's, sphere center(3) radius^2 material_id,
// plane normal(3) dot(origin, normal) material_id, triangle v0(3) e1(3) e2(3)
// normal(3) cull material_id.
//
// A tile is 1024 consecutive rays.  Spheres and planes sit in shared
// memory.  Triangles come from device memory through each (tile, light)
// worklist of 8-triangle groups, in ascending order, one launch at any
// triangle count; the group boxes behind the worklists are widened by the
// sigmoid's support (accel.chunk_soft_slack), so a triangle a worklist
// leaves out occludes a ray of the tile by less than sigmoid(-20) ~ 2e-9.
// K5: a thread per (ray, light), eight blocks of 128 a tile and light, each
// warp on an 8x4 pixel block, walking its row with shadow.cuh's soft walk:
// each ray skips the groups whose soft normal record its segment misses
// (accel.normal_boxes with beta), which hold no triangle whose factor 1 -
// occ is not exactly 1.0f, and multiplies the rest in the row's order, so
// its product equals the walk over every listed triangle bit for bit; it
// never stops early.  K7: a thread per (ray, light) as K5, walking K5's
// rows with the gradient records (accel.normal_boxes with beta and
// GRAD_SUPPORT): each ray skips the groups whose record its segment
// misses, which hold no triangle with a partial other than exactly 0.0f
// (expf overflows there, so the sigmoid and its derivative are 0).  K7 is
// the only reduction across rays: after each group some lane of a warp
// visits, the warp sums its lanes' partials of each triangle with
// shuffles and adds the sums into the float32 (T, 9) output with
// atomicAdd, spread over its lanes.  The order in which warps add is the
// scheduler's, so K7's output varies in its last bits from run to run: it
// is NOT deterministic (the TPU kernel is; its grid runs in order).  The
// tests and chip_smoke.py compare it with a tolerance for that.  K6: a
// thread per (ray, light) as K7, walking K7's rows with the same gradient
// records; a lane adds its own partials in registers, in the row's order,
// and crosses no rays; each light's g_p goes to a scratch that a second
// kernel sums over the lights in order.  No atomics: the
// same bits every run, and the sums of the walk over every listed group.
//
// Arithmetic: dot and cross products fused as fmaf chains (common.cuh,
// raytpu_torch/core/math3d.py), IEEE expf, division and sqrtf, no other
// contraction (-fmad=false), as the plain versions round.
//
// What bounds them.  Bytes: the rays (12 B of origin, 16 B of direction and
// distance per ray and light; K6 and K7 read 8 B more of g and trans and K6
// writes 16 B), the worklist entries and 56 B per triangle.  Work: ~70 FP32
// operations per (ray, light, listed triangle) test for K5, more where the
// sigmoid is live for K6 and K7; the bound is the card's FP32 rate
// (chip_smoke.py counts the tests from the run's worklists).  What the
// design does about it: the TPU's split between an SMEM launch chain and a
// DMA-streamed kernel is a layout artifact, gone here; all three test
// boxes before triangles (shadow.cuh), K6 and K7 the gradient records; K6
// and K7 skip the gradient arithmetic where the sigmoid is not live, and
// K7 skips a warp's shuffles where no lane has a partial.

#include <stdint.h>

#include "common.cuh"
#include "shadow.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kBlock = 128;  // K5's threads a block: 4 warps
constexpr int kGroup = 8;
constexpr int kSp = 5;   // sphere / plane record
constexpr int kTr = 14;  // triangle record
constexpr float kOccMax = 0.999999f;  // float32(1 - 1e-6), intersect.OCC_MAX

// cross products as fmaf(p, q, -(r*s)) (math3d.cross3)
__device__ __forceinline__ void cross3(float ax, float ay, float az, float bx, float by,
                                       float bz, float* cx, float* cy, float* cz) {
  *cx = fmaf(ay, bz, -(az * by));
  *cy = fmaf(az, bx, -(ax * bz));
  *cz = fmaf(ax, by, -(ay * bx));
}

// occ = min(sigmoid(beta * margin), kOccMax) where gated, else 0; *docc is
// d occ / d margin, 0 where the clamp or the gate holds it constant
__device__ __forceinline__ float soft_occ(float margin, bool gate, float beta, float* docc) {
  const float sig = 1.0f / (1.0f + expf(-beta * margin));
  *docc = (gate && sig < kOccMax) ? beta * sig * (1.0f - sig) : 0.0f;
  return gate ? fminf(sig, kOccMax) : 0.0f;
}

struct SphereSoft {
  float occ, docc, lx, ly, lz, proj;  // L = center - o, proj = d . L
};

// the margin (r^2 - perp^2) / r^2, gated on [tmin, mag] (pallas_soft.py:_sphere_soft_reg)
__device__ __forceinline__ SphereSoft sphere_soft(const float* s, float ox, float oy, float oz,
                                                  float dx, float dy, float dz, float tmin,
                                                  float mag, float beta) {
  SphereSoft r;
  r.lx = s[0] - ox;
  r.ly = s[1] - oy;
  r.lz = s[2] - oz;
  r.proj = dot3(dx, dy, dz, r.lx, r.ly, r.lz);
  const float perp2 = fmaf(-r.proj, r.proj, sqn(r.lx, r.ly, r.lz));
  const float margin = (s[3] - perp2) / s[3];
  const bool inside = margin > 0.0f;
  const float t = r.proj - sqrtf(inside ? s[3] - perp2 : 1.0f);
  r.occ = soft_occ(margin, inside && t >= tmin && t <= mag, beta, &r.docc);
  return r;
}

struct PlaneSoft {
  float occ, docc, t, den;
  bool near;  // the margin is t - tmin (else mag - t)
};

// the margin min(t - tmin, mag - t) of the crossing (pallas_soft.py:_plane_soft_reg)
__device__ __forceinline__ PlaneSoft plane_soft(const float* p, float ox, float oy, float oz,
                                                float dx, float dy, float dz, float tmin,
                                                float mag, float beta) {
  PlaneSoft r;
  const float denom = dot3(dx, dy, dz, p[0], p[1], p[2]);
  const bool nz = fabsf(denom) > kFltEps;
  r.den = nz ? denom : 1.0f;
  r.t = (p[3] - dot3(ox, oy, oz, p[0], p[1], p[2])) / r.den;
  const float m0 = r.t - tmin, m1 = mag - r.t;
  r.near = m0 <= m1;
  const float margin = fminf(m0, m1);
  r.occ = soft_occ(margin, nz && margin > 0.0f, beta, &r.docc);
  return r;
}

struct TriSoft {
  float occ, docc, u, v, w, inv_a;
  float hx, hy, hz;  // h = d x e2
  float sx, sy, sz;  // s = o - v0
  float qx, qy, qz;  // q = s x e1
};

// the signed barycentric distance to the boundary, min(u, v, 1-u-v), gated on
// [tmin, mag) with shadow-pass culling (pallas_soft.py:_tri_soft_read)
__device__ __forceinline__ TriSoft tri_soft(const float* k, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float tmin, float mag,
                                            float beta) {
  TriSoft r;
  const float cull = k[12];
  const float cull_dot = dot3(k[9], k[10], k[11], dx, dy, dz);
  const bool not_par = fabsf(cull_dot) >= kFltEps;
  const float cull_eff = (cull == 2.0f) ? 2.0f : 1.0f - cull;  // the shadow pass inverts
  const bool culled = (cull_eff == 0.0f && cull_dot < 0.0f) || (cull_eff == 1.0f && cull_dot > 0.0f);
  cross3(dx, dy, dz, k[6], k[7], k[8], &r.hx, &r.hy, &r.hz);
  const float a = dot3(k[3], k[4], k[5], r.hx, r.hy, r.hz);
  const bool det_ok = fabsf(a) >= kFltEps;
  r.inv_a = 1.0f / (det_ok ? a : 1.0f);
  r.sx = ox - k[0];
  r.sy = oy - k[1];
  r.sz = oz - k[2];
  r.u = r.inv_a * dot3(r.sx, r.sy, r.sz, r.hx, r.hy, r.hz);
  cross3(r.sx, r.sy, r.sz, k[3], k[4], k[5], &r.qx, &r.qy, &r.qz);
  r.v = r.inv_a * dot3(dx, dy, dz, r.qx, r.qy, r.qz);
  const float t = r.inv_a * dot3(k[6], k[7], k[8], r.qx, r.qy, r.qz);
  r.w = 1.0f - r.u - r.v;
  const float margin = fminf(fminf(r.u, r.v), r.w);
  const bool gate = not_par && !culled && det_ok && t >= tmin && t < mag;
  r.occ = soft_occ(margin, gate, beta, &r.docc);
  return r;
}

// The cotangents of Nu = s . h, Nv = d . q and a = e1 . h (u = Nu/a,
// v = Nv/a) from g_m, the cotangent of the margin: the margin is whichever
// of u, v, w = 1-u-v is least, the first of them on a tie (pallas_soft.py:1325)
__device__ __forceinline__ void tri_grad(const TriSoft& r, float g_m, float* g_nu, float* g_nv,
                                         float* g_a) {
  const bool su = r.u <= r.v && r.u <= r.w;
  const bool sv = !su && r.v <= r.w;
  const bool sw = !su && !sv;
  const float g_u = g_m * ((su ? 1.0f : 0.0f) - (sw ? 1.0f : 0.0f));
  const float g_v = g_m * ((sv ? 1.0f : 0.0f) - (sw ? 1.0f : 0.0f));
  *g_nu = g_u * r.inv_a;
  *g_nv = g_v * r.inv_a;
  *g_a = -(g_u * r.u + g_v * r.v) * r.inv_a;
}

__device__ __forceinline__ void load_sp(float* sm, const float* sph_g, int S, const float* pln_g,
                                        int P) {
  for (int k = threadIdx.x; k < S * kSp; k += blockDim.x) sm[k] = sph_g[k];
  for (int k = threadIdx.x; k < P * kSp; k += blockDim.x) sm[S * kSp + k] = pln_g[k];
  __syncthreads();
}

// The soft visit: multiplies (1 - occ) of triangles [k0, k1) into the
// lane's product, in order; it never stops early.
template <int kRec>
struct SoftVisit {
  static constexpr bool kStops = false;
  static constexpr bool kShrinks = false;
  static constexpr bool kReduces = false;
  float ox, oy, oz, dx, dy, dz, tmin, mag, beta, tr;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    for (int k = k0; k < k1; ++k)
      tr = tr * (1.0f - tri_soft(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz, tmin, mag,
                                 beta).occ);
  }
  __device__ __forceinline__ bool resolved() const { return false; }
};

// K5: one thread per (ray, light), a grid of (kTile / kBlock blocks a tile)
// x lights; warp w of the tile takes the 8x4 pixel block warp_slot(w,
// lane) of its 32x32 layout.  Spheres and planes multiply in first, then
// the soft group walk over the (tile, light) worklist with the soft normal
// records: a lane skips only groups whose factors are all exactly 1.0f, so
// the product equals the walk over every listed triangle bit for bit.
__global__ void __launch_bounds__(kBlock, 4) soft_trans_kernel(
    const float* __restrict__ p, const float* __restrict__ dirs, const float* __restrict__ mags,
    int R, const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin, float beta,
    float* __restrict__ trans) {
  extern __shared__ float sm[];  // spheres | planes
  load_sp(sm, sph_g, S, pln_g, P);
  const float* sph = sm;
  const float* pln = sm + S * kSp;
  const int L = gridDim.y, l = blockIdx.y;
  const int tile = blockIdx.x / (kTile / kBlock);
  const int warp = (blockIdx.x % (kTile / kBlock)) * (kBlock / 32) + threadIdx.x / 32;
  const int rid = tile * kTile + warp_slot(warp, threadIdx.x % 32);
  const bool valid = rid < R;  // lanes past the rays vote, never write
  const size_t lr = (size_t)l * R + rid;
  SoftVisit<kTr> v{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, tmin, 0.0f, beta, 1.0f};
  if (valid) {
    v.ox = p[3 * rid], v.oy = p[3 * rid + 1], v.oz = p[3 * rid + 2];
    v.dx = dirs[3 * lr], v.dy = dirs[3 * lr + 1], v.dz = dirs[3 * lr + 2];
    v.mag = mags[lr];
    for (int s = 0; s < S; ++s)
      v.tr = v.tr * (1.0f - sphere_soft(sph + s * kSp, v.ox, v.oy, v.oz, v.dx, v.dy, v.dz, tmin,
                                        v.mag, beta).occ);
    for (int q = 0; q < P; ++q)
      v.tr = v.tr * (1.0f - plane_soft(pln + q * kSp, v.ox, v.oy, v.oz, v.dx, v.dy, v.dz, tmin,
                                       v.mag, beta).occ);
  }
  const int row = tile * L + l;
  const float o[3] = {v.ox, v.oy, v.oz}, d[3] = {v.dx, v.dy, v.dz};
  group_walk<kTr, kNormalCols, 1>(tri, T, boxes, wl + (size_t)row * wl_cols,
                                  min(cnt[row], wl_cols), valid, o, d, v.mag, v);
  if (valid) trans[lr] = v.tr;
}

// The ray-side visit (K6): adds the partials of g_p and g_dirs of
// triangles [k0, k1) into the lane's sums, in order, with the arithmetic
// of the plain version; a triangle whose sigmoid derivative is 0.0f adds
// nothing.  It never stops early and crosses no lanes.
template <int kRec>
struct DrayVisit {
  static constexpr bool kStops = false;
  static constexpr bool kShrinks = false;
  static constexpr bool kReduces = false;
  float ox, oy, oz, dx, dy, dz, tmin, mag, beta, gob;
  float gpx, gpy, gpz, glx, gly, glz;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    for (int k = k0; k < k1; ++k) {
      const float* kt = tri + (size_t)k * kRec;
      const TriSoft r = tri_soft(kt, ox, oy, oz, dx, dy, dz, tmin, mag, beta);
      if (r.docc == 0.0f) continue;  // every partial is 0
      const float g_m = gob / (1.0f - r.occ) * r.docc;
      float g_nu, g_nv, g_a;
      tri_grad(r, g_m, &g_nu, &g_nv, &g_a);
      float ax, ay, az, bx, by, bz, cx, cy, cz;
      cross3(kt[3], kt[4], kt[5], dx, dy, dz, &ax, &ay, &az);        // e1 x d
      cross3(kt[6], kt[7], kt[8], r.sx, r.sy, r.sz, &bx, &by, &bz);  // e2 x s
      cross3(kt[6], kt[7], kt[8], kt[3], kt[4], kt[5], &cx, &cy, &cz);  // e2 x e1
      // g_s = g_Nu h + g_Nv (e1 x d); g_d = g_Nu (e2 x s) + g_Nv q + g_a (e2 x e1)
      gpx = gpx + (g_nu * r.hx + g_nv * ax);
      gpy = gpy + (g_nu * r.hy + g_nv * ay);
      gpz = gpz + (g_nu * r.hz + g_nv * az);
      glx = glx + (g_nu * bx + g_nv * r.qx + g_a * cx);
      gly = gly + (g_nu * by + g_nv * r.qy + g_a * cy);
      glz = glz + (g_nu * bz + g_nv * r.qz + g_a * cz);
    }
  }
  __device__ __forceinline__ bool resolved() const { return false; }
};

// K6: a thread per (ray, light), a grid of (kTile / kBlock blocks a tile)
// x lights, warp w of the tile on the 8x4 pixel block warp_slot(w, lane),
// as K7.  Spheres and planes first (the plane's far-end term writes
// g_mags), then the group walk over K5's (tile, light) worklist with the
// gradient records: a lane skips only groups whose sigmoid derivative is
// exactly 0.0f for every triangle, which add nothing, so the sums are the
// walk over every listed group's, in the same order.  This light's g_p
// goes to the scratch (L, R, 3) that soft_dray_sum_kernel adds up in light
// order (soft_dray_plain's order).  No atomics: every output element has
// one writer.  Lanes past R vote in the walk and never write.  A thread
// per ray taking its lights in a loop, g_p summed in registers (the order
// of the 1024-thread fold this kernel replaced), took 1.35-1.98x this
// kernel's time on an H100 (optional, bunny50k, bunny300k;
// shadow_ablation.py's per_ray): a tile's heavy rays took their lights one
// after another at the end of the grid.
__global__ void __launch_bounds__(kBlock, 4) soft_dray_kernel(
    const float* __restrict__ p, const float* __restrict__ dirs, const float* __restrict__ mags,
    int R, int L, const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin, float beta,
    const float* __restrict__ gin, const float* __restrict__ trans, float* __restrict__ g_p,
    float* __restrict__ g_dirs, float* __restrict__ g_mags) {
  extern __shared__ float sm[];  // spheres | planes
  load_sp(sm, sph_g, S, pln_g, P);
  const float* sph = sm;
  const float* pln = sm + S * kSp;
  const int tile = blockIdx.x / (kTile / kBlock);
  const int warp = (blockIdx.x % (kTile / kBlock)) * (kBlock / 32) + threadIdx.x / 32;
  const int rid = tile * kTile + warp_slot(warp, threadIdx.x % 32);
  const bool valid = rid < R;  // lanes past the rays vote, never write
  DrayVisit<kTr> v{};
  v.tmin = tmin;
  v.beta = beta;
  if (valid) v.ox = p[3 * rid], v.oy = p[3 * rid + 1], v.oz = p[3 * rid + 2];
  const int l = blockIdx.y;
  const size_t lr = (size_t)l * R + rid;
  float gmag = 0.0f;
  if (valid) {
    const float ox = v.ox, oy = v.oy, oz = v.oz;
    const float dx = dirs[3 * lr], dy = dirs[3 * lr + 1], dz = dirs[3 * lr + 2];
    const float mag = mags[lr];
    v.dx = dx, v.dy = dy, v.dz = dz, v.mag = mag;
    // d loss / d occ_j = -g * trans / (1 - occ_j): the constant part
    const float gob = -gin[lr] * trans[lr];
    v.gob = gob;
    for (int s = 0; s < S; ++s) {
      const SphereSoft r = sphere_soft(sph + s * kSp, ox, oy, oz, dx, dy, dz, tmin, mag, beta);
      if (r.docc == 0.0f) continue;  // every partial is 0
      const float g_m = gob / (1.0f - r.occ) * r.docc;
      const float c2 = 2.0f * (-g_m / sph[s * kSp + 3]);  // 2 * d loss / d perp^2
      v.gpx = v.gpx + -c2 * (r.lx - r.proj * dx);
      v.gpy = v.gpy + -c2 * (r.ly - r.proj * dy);
      v.gpz = v.gpz + -c2 * (r.lz - r.proj * dz);
      v.glx = v.glx + -c2 * r.proj * r.lx;
      v.gly = v.gly + -c2 * r.proj * r.ly;
      v.glz = v.glz + -c2 * r.proj * r.lz;
    }
    for (int q = 0; q < P; ++q) {
      const float* pl = pln + q * kSp;
      const PlaneSoft r = plane_soft(pl, ox, oy, oz, dx, dy, dz, tmin, mag, beta);
      if (r.docc == 0.0f) continue;
      const float g_m = gob / (1.0f - r.occ) * r.docc;
      const float g_t = r.near ? g_m : -g_m;
      const float g_num = g_t / r.den;
      const float g_den = -g_t * r.t / r.den;
      v.gpx = v.gpx + -g_num * pl[0];
      v.gpy = v.gpy + -g_num * pl[1];
      v.gpz = v.gpz + -g_num * pl[2];
      v.glx = v.glx + g_den * pl[0];
      v.gly = v.gly + g_den * pl[1];
      v.glz = v.glz + g_den * pl[2];
      gmag = gmag + (r.near ? 0.0f : g_m);
    }
  }
  const int row = tile * L + l;
  const float o[3] = {v.ox, v.oy, v.oz}, d[3] = {v.dx, v.dy, v.dz};
  group_walk<kTr, kNormalCols, 1>(tri, T, boxes, wl + (size_t)row * wl_cols,
                                  min(cnt[row], wl_cols), valid, o, d, v.mag, v);
  if (valid) {
    g_dirs[3 * lr] = v.glx;
    g_dirs[3 * lr + 1] = v.gly;
    g_dirs[3 * lr + 2] = v.glz;
    g_mags[lr] = gmag;
    g_p[3 * lr] = v.gpx;  // this light's g_p, into the scratch (L, R, 3)
    g_p[3 * lr + 1] = v.gpy;
    g_p[3 * lr + 2] = v.gpz;
  }
}

// K6's light sum: g_p (R, 3) from the scratch (L, R, 3), 0 + light 0 +
// light 1 + ..., one thread per element.
__global__ void soft_dray_sum_kernel(const float* __restrict__ scratch, int R, int L,
                                     float* __restrict__ g_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * R) return;
  float x = 0.0f;
  for (int l = 0; l < L; ++l) x = x + scratch[(size_t)l * 3 * R + i];
  g_p[i] = x;
}

// The nine partials [g_s, g_e1, g_e2] of triangle record `kt` for one
// (ray, light), gob = -g * trans its constant part; all 0.0f where the
// sigmoid's derivative is (the gate, the clamp, or expf's overflow past
// accel.GRAD_SUPPORT).  Returns whether one of them is not 0.0f.
__device__ __forceinline__ bool dprim_partials(const float* kt, float ox, float oy, float oz,
                                               float dx, float dy, float dz, float tmin,
                                               float mag, float beta, float gob, float* part) {
  for (int j = 0; j < 9; ++j) part[j] = 0.0f;
  const TriSoft r = tri_soft(kt, ox, oy, oz, dx, dy, dz, tmin, mag, beta);
  if (r.docc == 0.0f) return false;
  const float g_m = gob / (1.0f - r.occ) * r.docc;
  float g_nu, g_nv, g_a;
  tri_grad(r, g_m, &g_nu, &g_nv, &g_a);
  float ax, ay, az, bx, by, bz;
  cross3(kt[3], kt[4], kt[5], dx, dy, dz, &ax, &ay, &az);  // e1 x d
  cross3(dx, dy, dz, r.sx, r.sy, r.sz, &bx, &by, &bz);     // d x s
  part[0] = g_nu * r.hx + g_nv * ax;  // g_s
  part[1] = g_nu * r.hy + g_nv * ay;
  part[2] = g_nu * r.hz + g_nv * az;
  part[3] = g_nv * bx + g_a * r.hx;  // g_e1 = g_Nv (d x s) + g_a h
  part[4] = g_nv * by + g_a * r.hy;
  part[5] = g_nv * bz + g_a * r.hz;
  part[6] = -g_nu * bx + g_a * ax;  // g_e2 = g_Nu (s x d) + g_a (e1 x d)
  part[7] = -g_nu * by + g_a * ay;
  part[8] = -g_nu * bz + g_a * az;
  bool any = false;
  for (int j = 0; j < 9; ++j) any = any || part[j] != 0.0f;
  return any;
}

// The gradient visit (K7): adds the partials of triangles [k0, k1) into
// out (T, 9).  The visit marks the lane, and reduce, which group_walk
// calls on every lane after the group, sums the warp's partials of each
// triangle with shuffles where some lane has one, and spreads the group's
// 72 atomics over the lanes (shadow_ablation.py's variant atomics, each
// lane adding its own partials as it visits, took 1.87x as long on
// optional on an H100).
template <int kRec>
struct GradVisit {
  static constexpr bool kStops = false;
  static constexpr bool kShrinks = false;
  static constexpr bool kReduces = true;
  float ox, oy, oz, dx, dy, dz, tmin, mag, beta, gob;
  float* __restrict__ out;
  bool pending = false;
  __device__ __forceinline__ void operator()(const float* __restrict__ tri, int k0, int k1) {
    pending = true;  // reduce computes this lane's partials
  }
  __device__ __forceinline__ void reduce(const float* __restrict__ tri, int k0, int k1) {
    const int lane = threadIdx.x % 32;
    for (int k = k0; k < k1; ++k) {  // k0, k1: the same on every lane
      float part[9];
      const bool nz = pending && dprim_partials(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz,
                                                tmin, mag, beta, gob, part);
      if (!__any_sync(kFullWarp, nz)) continue;
      const int base = (k - k0) * 9;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        float x = nz ? part[j] : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullWarp, x, off);
        if (lane == (base + j) % 32 && x != 0.0f) atomicAdd(out + (size_t)k * 9 + j, x);
      }
    }
    pending = false;
  }
  __device__ __forceinline__ bool resolved() const { return false; }
};

// K7: one thread per (ray, light), a grid of (kTile / kBlock blocks a tile)
// x lights, warp w of the tile on the 8x4 pixel block warp_slot(w, lane),
// as K5.  The group walk over K5's (tile, light) worklist with the
// gradient records: a lane skips only groups whose partials are all
// exactly 0.0f for its ray, so the sums add every nonzero partial of the
// walk over every listed group.  Lanes past R vote and never add.
__global__ void __launch_bounds__(kBlock, 4) soft_dprim_kernel(
    const float* __restrict__ p, const float* __restrict__ dirs, const float* __restrict__ mags,
    int R, const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin, float beta,
    const float* __restrict__ gin, const float* __restrict__ trans, float* __restrict__ out) {
  const int L = gridDim.y, l = blockIdx.y;
  const int tile = blockIdx.x / (kTile / kBlock);
  const int warp = (blockIdx.x % (kTile / kBlock)) * (kBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rid = tile * kTile + warp_slot(warp, lane);
  const bool valid = rid < R;
  const size_t lr = (size_t)l * R + rid;
  GradVisit<kTr> v{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, tmin, 0.0f, beta, 0.0f, out};
  if (valid) {
    v.ox = p[3 * rid], v.oy = p[3 * rid + 1], v.oz = p[3 * rid + 2];
    v.dx = dirs[3 * lr], v.dy = dirs[3 * lr + 1], v.dz = dirs[3 * lr + 2];
    v.mag = mags[lr];
    v.gob = -gin[lr] * trans[lr];  // d loss / d occ_j = gob / (1 - occ_j)
  }
  const int row = tile * L + l;
  const float o[3] = {v.ox, v.oy, v.oz}, d[3] = {v.dx, v.dy, v.dz};
  group_walk<kTr, kNormalCols, 1>(tri, T, boxes, wl + (size_t)row * wl_cols,
                                  min(cnt[row], wl_cols), valid, o, d, v.mag, v);
}

}  // namespace

extern "C" {

// Launches K5 on `stream` over ceil(R/1024) tiles x L lights.  p (R, 3),
// dirs (L, R, 3), mags (L, R) float32; `boxes` (ceil(T/8), 32) the soft
// normal records (accel.normal_boxes with beta), 16-byte aligned; `wl` (nt, L,
// wl_cols) and `cnt` (nt, L) the soft worklists; trans (L, R) float32.
// Returns cudaGetLastError() after the launch.
int raytpu_soft_trans(const float* p, const float* dirs, const float* mags, int R, int L,
                      const float* sph, int S, const float* pln, int P, const float* tri, int T,
                      const float* boxes, const int* wl, const int* cnt, int wl_cols, float tmin,
                      float beta, float* trans, void* stream) {
  if (R == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (R + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * (S + P) * kSp;
  const dim3 grid(tiles * (kTile / kBlock), L);
  soft_trans_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p, dirs, mags, R, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, tmin, beta, trans);
  return static_cast<int>(cudaGetLastError());
}

// Launches K6 on `stream` over ceil(R/1024) tiles: K5's inputs with `boxes`
// (ceil(T/8), 32) the gradient records (accel.normal_boxes with beta and
// GRAD_SUPPORT), 16-byte aligned, plus g and trans (L, R) -> g_p (R, 3),
// g_dirs (L, R, 3), g_mags (L, R), every element written; `scratch` (L,
// R, 3) float32 holds each light's g_p before the light sum, which
// soft_dray_sum_kernel adds up into g_p (zeros where L is 0).  Returns
// cudaGetLastError() after the launches.
int raytpu_soft_dray(const float* p, const float* dirs, const float* mags, int R, int L,
                     const float* sph, int S, const float* pln, int P, const float* tri, int T,
                     const float* boxes, const int* wl, const int* cnt, int wl_cols, float tmin,
                     float beta, const float* g, const float* trans, float* g_p, float* g_dirs,
                     float* g_mags, float* scratch, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    const int tiles = (R + kTile - 1) / kTile;
    const size_t smem = sizeof(float) * (S + P) * kSp;
    const dim3 grid(tiles * (kTile / kBlock), L);
    soft_dray_kernel<<<grid, kBlock, smem, st>>>(p, dirs, mags, R, L, sph, S, pln, P, tri, T,
                                                 boxes, wl, cnt, wl_cols, tmin, beta, g, trans,
                                                 scratch, g_dirs, g_mags);
  }
  soft_dray_sum_kernel<<<(3 * R + 255) / 256, 256, 0, st>>>(scratch, R, L, g_p);
  return static_cast<int>(cudaGetLastError());
}

// Launches K7 on `stream` over ceil(R/1024) tiles x L lights: K5's inputs
// (without spheres and planes) with `boxes` (ceil(T/8), 32) the gradient
// records (accel.normal_boxes with beta and GRAD_SUPPORT), 16-byte
// aligned, plus g and trans (L, R); adds the [g_s, g_e1, g_e2] partials
// into `out` (T, 9) float32, which the caller zeroes first.
int raytpu_soft_dprim(const float* p, const float* dirs, const float* mags, int R, int L,
                      const float* tri, int T, const float* boxes, const int* wl, const int* cnt,
                      int wl_cols, float tmin, float beta, const float* g, const float* trans,
                      float* out, void* stream) {
  if (R == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (R + kTile - 1) / kTile;
  const dim3 grid(tiles * (kTile / kBlock), L);
  soft_dprim_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, dirs, mags, R, tri, T, boxes, wl, cnt, wl_cols, tmin, beta, g, trans, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
