// Device arithmetic shared by the kernels (K1 mega.cu, K2a/K2b mega2.cu,
// K3/K4 packed.cu, K5-K7 soft.cu, K8-K10 chunked.cu, K11a/K11b mega3.cu,
// P1/P2 probes.cu): the primitive tests, camera raygen, the tile layout,
// the shading of a hit and the cp.async helpers of the shared-memory rings.  Each function follows the Pallas kernels' op order and rounds where
// the plain versions (raytpu_torch/render/plain.py) round: dot and cross
// products and the points o + t*d are explicit fmaf calls, as XLA contracts
// them on the CPU where raytpu's goldens were rendered
// (raytpu_torch/core/math3d.py says more).  The kernels are built with
// -fmad=false and without fast math (raytpu_torch/render/build.py), so
// nothing else contracts and division and square root are IEEE-rounded:
// closest-hit and shadow decisions turn on near-ties, and approximations
// would flip pixels.
//
// Records read by the tests: a sphere's first columns are center(3),
// radius^2; a plane's normal(3), dot(origin, normal); a triangle's v0(3)
// e1(3) e2(3) normal(3) cull.  Further columns (materials, ids) differ by
// kernel and are read by the kernels themselves.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace raytpu_dev {

constexpr int kCam = 16, kSph = 11, kPln = 11, kTri = 20, kLight = 8;
constexpr float kFltEps = 1.1920929e-07f;
constexpr float kFltMax = 3.4028235e38f;
constexpr float kPi = 3.14159265358979323846f;

enum Mode { kObservedArea = 0, kRadiance = 1, kBrdf = 2, kCombined = 3 };

// x*x' + y*y' + z*z' fused as fmaf(z, z', fmaf(y, y', x*x')) (math3d.dot3)
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return fmaf(az, bz, fmaf(ay, by, ax * bx));
}
__device__ __forceinline__ float sqn(float x, float y, float z) { return dot3(x, y, z, x, y, z); }

// pallas_kernel.py:_sphere_t_reg; valid on [lo, hi].  kEarly returns a
// miss before the square root once the line passes the sphere by (K1):
// the same answer, with a branch that a warp whose lanes all miss skips by.
template <bool kEarly = false>
__device__ __forceinline__ float sphere_t(const float* s, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float lo, float hi) {
  const float lx = s[0] - ox, ly = s[1] - oy, lz = s[2] - oz;
  const float l2 = sqn(lx, ly, lz);
  const float proj = dot3(dx, dy, dz, lx, ly, lz);
  const float perp2 = fmaf(-proj, proj, l2);
  const bool inside = s[3] >= perp2;
  if (kEarly && !inside) return INFINITY;
  const float tc = proj - sqrtf(inside ? s[3] - perp2 : 1.0f);
  return (inside && tc >= lo && tc <= hi) ? tc : INFINITY;
}

// pallas_kernel.py:_plane_t_reg; valid on [lo, hi)
__device__ __forceinline__ float plane_t(const float* p, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float lo, float hi) {
  const float denom = dot3(dx, dy, dz, p[0], p[1], p[2]);
  const float num = p[3] - dot3(ox, oy, oz, p[0], p[1], p[2]);
  const bool nz = denom != 0.0f;
  const float tc = num / (nz ? denom : 1.0f);
  return (nz && tc >= lo && tc < hi) ? tc : INFINITY;
}

// pallas_kernel.py:_tri_t_read; Moller-Trumbore with cull modes, valid on
// [lo, hi).  A shadow ray swaps front- and back-face culling.  kEarly
// returns a miss as soon as the cull, the determinant or u decides one
// (K1): the same answer, as sphere_t's.
template <bool kEarly = false>
__device__ __forceinline__ float tri_t(const float* k, float ox, float oy, float oz,
                                       float dx, float dy, float dz, float lo, float hi,
                                       bool shadow) {
  const float v0x = k[0], v0y = k[1], v0z = k[2];
  const float e1x = k[3], e1y = k[4], e1z = k[5];
  const float e2x = k[6], e2y = k[7], e2z = k[8];
  const float cull = k[12];
  const float cull_dot = dot3(k[9], k[10], k[11], dx, dy, dz);
  const bool not_par = fabsf(cull_dot) >= kFltEps;
  const float cull_eff = (cull == 2.0f) ? 2.0f : (shadow ? 1.0f - cull : cull);
  const bool culled = (cull_eff == 0.0f && cull_dot < 0.0f) || (cull_eff == 1.0f && cull_dot > 0.0f);
  if (kEarly && (!not_par || culled)) return INFINITY;
  // cross products as fmaf(p, q, -(r*s)) (math3d.cross3)
  const float hx = fmaf(dy, e2z, -(dz * e2y));
  const float hy = fmaf(dz, e2x, -(dx * e2z));
  const float hz = fmaf(dx, e2y, -(dy * e2x));
  const float a = dot3(e1x, e1y, e1z, hx, hy, hz);
  const bool det_ok = fabsf(a) >= kFltEps;
  const float inv_a = 1.0f / (det_ok ? a : 1.0f);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = inv_a * dot3(sx, sy, sz, hx, hy, hz);
  if (kEarly && !(det_ok && u >= 0.0f && u <= 1.0f)) return INFINITY;
  const float qx = fmaf(sy, e1z, -(sz * e1y));
  const float qy = fmaf(sz, e1x, -(sx * e1z));
  const float qz = fmaf(sx, e1y, -(sy * e1x));
  const float v = inv_a * dot3(dx, dy, dz, qx, qy, qz);
  const float tc = inv_a * dot3(e2x, e2y, e2z, qx, qy, qz);
  const bool ok = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
  return (not_par && !culled && det_ok && ok && tc >= lo && tc < hi) ? tc : INFINITY;
}

// The pixel of slot j of 1024-ray tile i of a W x H frame (K2a/K2b, K11a/
// K11b): a 32x32 pixel block in row-major block order when `tiled` (W and H
// multiples of 32), else rays [1024 i, 1024 i + 1024) of the row-major frame.
// False for a slot past the frame: the ragged end of an untiled frame, and
// every slot of a tile past the last (a px-sharded rank's padded tiles).
__device__ __forceinline__ bool tile_pixel(int i, int j, int W, int H, int tiled, int* pxi,
                                           int* pyi) {
  if (tiled) {
    const int TX = W / 32;
    *pxi = (i % TX) * 32 + j % 32;
    *pyi = (i / TX) * 32 + j / 32;
    return *pyi < H;
  }
  const long long rid = (long long)i * 1024 + j;
  if (rid >= (long long)W * H) return false;
  *pxi = (int)(rid % W);
  *pyi = (int)(rid / W);
  return true;
}

// Camera ray through pixel (pxi, pyi) (reference: source/Renderer.cpp:104-114);
// cx = ((2u-1)*aspect)*fov.  cam = origin(3) right(3) up(3) forward(3) fov aspect.
__device__ __forceinline__ void raygen(const float* cam, int pxi, int pyi, int W, int H,
                                       float* rdx, float* rdy, float* rdz) {
  const float ux = ((float)pxi + 0.5f) / (float)W;
  const float uy = ((float)pyi + 0.5f) / (float)H;
  const float fov = cam[12], aspect = cam[13];
  const float cx = (2.0f * ux - 1.0f) * aspect * fov;
  const float cy = (1.0f - 2.0f * uy) * fov;
  const float dx0 = cx * cam[3] + cy * cam[6] + cam[9];
  const float dy0 = cx * cam[4] + cy * cam[7] + cam[10];
  const float dz0 = cx * cam[5] + cy * cam[8] + cam[11];
  const float d_len = sqrtf(sqn(dx0, dy0, dz0));
  *rdx = dx0 / d_len;
  *rdy = dy0 / d_len;
  *rdz = dz0 / d_len;
}

// One light's contribution w[3] (pallas_kernel.py:_shade_one_light).  The
// material m = [kind r g b p0 p1 p2]; kind 0 solid, 1 Lambert, 2
// Lambert+Phong, anything else Cook-Torrance.
__device__ __forceinline__ void shade_one_light(
    int mode, bool is_point, const float* li, float px, float py, float pz,
    float nx, float ny, float nz, float lx, float ly, float lz, float vx, float vy, float vz,
    const float* m, float* w) {
  // radiance at the UNOFFSET hit point (reference: source/Renderer.cpp:150)
  const float rdx = li[0] - px, rdy = li[1] - py, rdz = li[2] - pz;
  const float rad_scale = is_point ? li[6] / sqn(rdx, rdy, rdz) : li[6];
  const float ndl = dot3(nx, ny, nz, lx, ly, lz);
  const float oa = fmaxf(ndl, 0.0f);
  if (mode == kObservedArea) {
    w[0] = w[1] = w[2] = oa;
    return;
  }
  if (mode == kRadiance) {
    for (int c = 0; c < 3; ++c) w[c] = rad_scale * li[3 + c];
    return;
  }
  const float mk = m[0], m0 = m[4], m1 = m[5], m2 = m[6];
  float b[3];
  if (mk == 0.0f) {
    for (int c = 0; c < 3; ++c) b[c] = m[1 + c];
  } else if (mk == 1.0f) {
    for (int c = 0; c < 3; ++c) b[c] = m[1 + c] * m0 / kPi;
  } else if (mk == 2.0f) {
    // Phong lobe with the reference's clamped reflect
    const float two_ndl = 2.0f * oa;
    const float rfx = lx - two_ndl * nx, rfy = ly - two_ndl * ny, rfz = lz - two_ndl * nz;
    const float cosa = fmaxf(dot3(rfx, rfy, rfz, vx, vy, vz), 0.0f);
    const float spec_p = m1 * powf(cosa, m2);
    for (int c = 0; c < 3; ++c) b[c] = m[1 + c] * m0 / kPi + spec_p;
  } else {
    // Cook-Torrance: [metalness, roughness]
    float hx = vx + lx, hy = vy + ly, hz = vz + lz;
    const float h_len = fmaxf(sqrtf(sqn(hx, hy, hz)), 1e-20f);
    hx = hx / h_len;
    hy = hy / h_len;
    hz = hz / h_len;
    const bool dielectric = m0 == 0.0f;
    const float hdv = fmaxf(dot3(hx, hy, hz, vx, vy, vz), 0.0f);
    const float fw = 1.0f - hdv;
    const float fw2 = fw * fw;
    const float fres_w = fw * (fw2 * fw2);  // JAX's integer power: x * (x^2)^2
    const float a = m1 * m1;
    const float sqr_a = a * a;
    const float ndh = fmaxf(dot3(nx, ny, nz, hx, hy, hz), 0.0f);
    const float dden = ndh * ndh * (sqr_a - 1.0f) + 1.0f;
    const float D = sqr_a / (kPi * dden * dden);
    const float kk = (a + 1.0f) * (a + 1.0f) / 8.0f;
    const float ndv = fmaxf(dot3(nx, ny, nz, vx, vy, vz), 0.0f);
    const float G = (ndv / (ndv * (1.0f - kk) + kk)) * (oa / (oa * (1.0f - kk) + kk));
    const float spec_s = D * G / (4.0f * fmaxf(ndv, 1e-4f) * fmaxf(oa, 1e-4f));
    for (int c = 0; c < 3; ++c) {
      const float mc = m[1 + c];
      const float f0 = dielectric ? 0.04f : mc;
      const float F = f0 + (1.0f - f0) * fres_w;
      b[c] = (dielectric ? mc * (1.0f - F) / kPi : 0.0f) + F * spec_s;
    }
  }
  if (mode == kBrdf) {
    for (int c = 0; c < 3; ++c) w[c] = b[c];
    return;
  }
  // COMBINED: ((oa * (color*scale)) * brdf), the jnp path's op order
  for (int c = 0; c < 3; ++c) w[c] = oa * (li[3 + c] * rad_scale) * b[c];
}

// A hit's summed color rgb[3] times its shadow factor, then MaxToOne as a
// division (reference: source/ColorRGB.h:12-17), in place.
__device__ __forceinline__ void dim_and_tonemap(float sf, float* rgb) {
  for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * sf;
  const float mx = fmaxf(rgb[0], fmaxf(rgb[1], rgb[2]));
  if (mx > 1.0f) {
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] / mx;
  }
}

// The shadow ray from the offset hit point (ox, oy, oz) towards light li:
// unit direction and length, kFltMax for a directional light, whose
// direction sits in the position slot.
__device__ __forceinline__ void light_dir(const float* li, float ox, float oy, float oz,
                                          float* lx, float* ly, float* lz, float* mag) {
  if (li[7] == 0.0f) {
    const float ldx = li[0] - ox, ldy = li[1] - oy, ldz = li[2] - oz;
    *mag = sqrtf(sqn(ldx, ldy, ldz));
    *lx = ldx / *mag;
    *ly = ldy / *mag;
    *lz = ldz / *mag;
  } else {
    *mag = kFltMax;
    *lx = -li[0];
    *ly = -li[1];
    *lz = -li[2];
  }
}

// The whole RenderPixel tail of a hit at distance t along (ro, rd) with unit
// normal n and material m: one shadow ray per light from the offset point,
// shading, the shadow dim per occluded light, MaxToOne.  `occluded(l, ox,
// oy, oz, lx, ly, lz, mag)` answers light l's shadow query.  Writes rgb[3].
template <typename Occluded>
__device__ __forceinline__ void shade_hit(const float* lit, int L, int mode, bool shadows,
                                          float normal_offset, float shadow_dim,
                                          float rox, float roy, float roz,
                                          float rdx, float rdy, float rdz, float t,
                                          float nx, float ny, float nz, const float* mat,
                                          Occluded occluded, float* rgb) {
  const float px = fmaf(t, rdx, rox), py = fmaf(t, rdy, roy), pz = fmaf(t, rdz, roz);
  const float ox = fmaf(nx, normal_offset, px);
  const float oy = fmaf(ny, normal_offset, py);
  const float oz = fmaf(nz, normal_offset, pz);
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, sf = 1.0f;
  for (int l = 0; l < L; ++l) {
    const float* li = lit + l * kLight;
    const bool is_point = li[7] == 0.0f;
    float lx, ly, lz, mag;
    light_dir(li, ox, oy, oz, &lx, &ly, &lz, &mag);
    bool lit_here = true;
    if (shadows) {
      lit_here = !occluded(l, ox, oy, oz, lx, ly, lz, mag);
      if (!lit_here) sf = sf * shadow_dim;
    }
    if (lit_here) {
      float w[3];
      shade_one_light(mode, is_point, li, px, py, pz, nx, ny, nz, lx, ly, lz, -rdx, -rdy, -rdz,
                      mat, w);
      cr = cr + w[0];
      cg = cg + w[1];
      cb = cb + w[2];
    }
  }
  rgb[0] = cr;
  rgb[1] = cg;
  rgb[2] = cb;
  dim_and_tonemap(sf, rgb);
}

// cp.async, 16 bytes from global into shared memory, bypassing L1 (mega3.cu's
// and probes.cu's rings).  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// Closes this thread's group of copies issued since the last commit (an
// empty group when it issued none).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace raytpu_dev
