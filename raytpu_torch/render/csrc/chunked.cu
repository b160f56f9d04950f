// K8, K9 and K10: the chunked route's closest hit, all-lights any-hit and
// fused shadow + shade for Hopper (sm_90a), for scenes past the other
// routes' caps (more than 16 spheres or planes, or more than 8 lights) with
// at most 32,768 triangles.
//
// K8 replaces raytpu/render/pallas_kernel.py:_make_scene_kernel, reached
// through scene_min_t, closest_hit_pallas and any_hit_pallas: for arbitrary
// rays (ro, rd) and an optional per-ray tmax, the minimum t over every
// sphere and plane and the triangles of the ray tile's worklist of
// 128-triangle chunks.  The closest mode writes t (inf on a miss), the
// winner's global index (spheres -> planes -> triangles; 2^30 on a miss),
// its normal (a sphere's unnormalized: hit point minus center; the wrapper
// normalizes it) and its material id.  The shadow mode inverts the triangle
// cull, takes t in [tmin, tmax) and stops at the first occluder: it writes
// that occluder's t, the first in primitive order, or inf.
// K9 replaces _make_shadow_kernel (any_hit_lights_pallas): for shadow
// origins p and per-light directions and distances, whether anything lies
// on each light's segment -> (L, R) bytes 0/1.  raytpu packs the answers
// into one f32 bitmask, hence its 24-light cap, which the wrapper keeps.
// K10 replaces _make_shadow_shade_kernel (shadow_shade_pallas): from K8's
// hit records, every light's shadow any-hit (when shadows are on), the
// shading of the lit lights in the four lighting modes, the dim per
// occluded light and MaxToOne -> (R, 3) colors, black on a miss.  It
// takes the material row by index from the material table (M, 7): raytpu's
// one-hot matmul is a TPU gather; on this card its analog would be a TF32
// product.
//
// Records (pallas_soft.py:_soft_packs): sphere center(3) radius^2
// material_id, plane normal(3) dot(origin, normal) material_id, triangle
// v0(3) e1(3) e2(3) normal(3) cull material_id; light pos-or-dir(3) rgb(3)
// intensity kind; material kind rgb(3) p0 p1 p2.  Eager torch glue
// (raytpu_torch/render/chunked.py) builds the worklists from the port's
// ops/accel.py: a tile walks its passing chunks in ascending order, and a
// scene under 256 triangles walks every chunk (raytpu's CULL_MIN_TRIS).
//
// A tile is 1024 consecutive rays (the route feeds camera rays in 32x32
// pixel blocks, raytpu in 512-ray 16x32 blocks).  K8 and K10: eight blocks
// of 128 a tile, one thread per ray, each warp on an 8x4 pixel block.  K9:
// eight blocks of 128 a (tile, light), each warp on 32 consecutive rays,
// one thread per (ray, light).  The three kernels walk shadow.cuh's groups
// (below).  With the strict < update a tie goes to the first primitive in
// sphere -> plane -> triangle order.
//
// What bounds it.  The work is FP32 arithmetic: ~50 operations for each
// ray-triangle test that a worklist passes, ~15 for each sphere and plane,
// which every ray tests, and ~100 of shading per lit light.  The bytes are
// the rays (28-52 B each way), the per-light directions and distances
// (16 B per ray and light), the worklist entries and a scene of at most
// ~1.9 MB.  So the bound is the card's FP32 rate (chip_smoke.py counts the
// tests from this run's worklists).
//
// What the design does about it.  The TPU kernels keep every primitive in
// VMEM and fold (512 x 128) t-matrices; here each thread folds its own ray
// over the primitives, with the culls skipping most chunks.  Spheres and
// planes sit in shared memory when they fit in 48 KB (2,457 of them), else
// the threads read them from device memory; triangles stay in device
// memory, and all threads of a block read the same chunk at the same time,
// which the cache serves as a broadcast.  A shadow query stops at its
// first occluder.  The worklist rows are the union over a whole tile,
// 126-541 groups a query, so the kernels walk each chunk's 16 groups of 8
// with shadow.cuh: the warp's bundle, then each ray, test the groups'
// boxes, widened for the ray by a bound of tri_t's error that its
// triangles' normals narrow for rays far from grazing
// (accel.normal_boxes), so a query visits the triangles of a few groups.
// K8's closest query tests them up to its current closest hit (the
// closest walk), its shadow query up to tmax (the first-occluder walk);
// the winners, first occluders and occlusions are the same, so K8's
// answers, K9's and K10's equal the walk over every listed triangle bit
// for bit.  One normal record build a frame serves K8's worklists, K8 and
// K10 (render/chunked.py: frame_records).  A scene of a few groups
// (render/chunked.py: FEW_GROUPS) takes no records, and the kernels then
// fold every listed triangle, lane by lane.  The arithmetic
// is common.cuh's, so the kernels agree with their plain versions
// (raytpu_torch/render/plain.py) up to powf's last bit.

#include <stdint.h>

#include "common.cuh"
#include "shadow.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kShadeBlock = 128;  // K9's and K10's threads a block: 4 warps
constexpr int kChunk = 128;
constexpr int kSp = 5;    // sphere / plane record
constexpr int kTr = 14;   // triangle record
constexpr int kMat = 7;   // material row
constexpr int kMiss = 1 << 30;  // raytpu's BIG_I: the index of a miss
constexpr int kSmemFloats = 48 * 1024 / 4;

// Stages spheres then planes into shared memory when they fit; returns the
// table to read (shared or device memory) through *sph and *pln.
__device__ __forceinline__ void stage_sp(float* sm, const float* sph_g, int S, const float* pln_g,
                                         int P, const float** sph, const float** pln) {
  if ((S + P) * kSp <= kSmemFloats) {
    for (int k = threadIdx.x; k < S * kSp; k += blockDim.x) sm[k] = sph_g[k];
    for (int k = threadIdx.x; k < P * kSp; k += blockDim.x) sm[S * kSp + k] = pln_g[k];
    __syncthreads();
    *sph = sm;
    *pln = sm + S * kSp;
  } else {
    *sph = sph_g;
    *pln = pln_g;
  }
}

// K8: one thread per ray, blocks of kShadeBlock threads, kTile /
// kShadeBlock blocks to a tile; warp w of the tile takes the 8x4 pixel
// block warp_slot(w, lane) of its 32x32 layout (one answer a ray: the
// order of a tile's rays changes none; shadow_ablation.py measures 32
// consecutive rays against it).  Spheres and planes first, then the tile's
// worklist of 128-triangle chunks: with the normal records (kWalk)
// shadow.cuh's walk, each chunk expanded to its 16 groups in ascending
// order, the closest walk (kShadow false) or the first-occluder walk;
// else every triangle of every listed chunk, lane by lane.  The closest
// mode is unbounded (the wrapper refuses a tmax there); the shadow mode
// takes [tmin, tmax[rid]), or [tmin, inf) without tmax.  Lanes past R vote
// and never write.
template <bool kWalk, bool kShadow>
__global__ void __launch_bounds__(kShadeBlock, 4) chunked_min_t_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd, const float* __restrict__ tmax,
    int R, const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin,
    float* __restrict__ t_out, int* __restrict__ idx_out, float* __restrict__ n_out,
    int* __restrict__ mat_out) {
  extern __shared__ float sm[];
  const float *sph, *pln;
  stage_sp(sm, sph_g, S, pln_g, P, &sph, &pln);
  constexpr int kBlocksPerTile = kTile / kShadeBlock;
  const int tile = blockIdx.x / kBlocksPerTile;
  const int warp = (blockIdx.x % kBlocksPerTile) * (kShadeBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rid = tile * kTile + warp_slot(warp, lane);
  const bool valid = rid < R;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float hi = INFINITY;
  if (valid) {
    ox = ro[3 * rid], oy = ro[3 * rid + 1], oz = ro[3 * rid + 2];
    dx = rd[3 * rid], dy = rd[3 * rid + 1], dz = rd[3 * rid + 2];
    if (kShadow && tmax) hi = tmax[rid];
  }
  const int* w = wl + (size_t)tile * wl_cols;
  const int c = min(cnt[tile], wl_cols);

  if constexpr (kShadow) {  // the first occluder's t in primitive order, or inf
    float t = INFINITY;
    for (int s = 0; s < S && valid && t == INFINITY; ++s)
      t = sphere_t(sph + s * kSp, ox, oy, oz, dx, dy, dz, tmin, hi);
    for (int q = 0; q < P && valid && t == INFINITY; ++q)
      t = plane_t(pln + q * kSp, ox, oy, oz, dx, dy, dz, tmin, hi);
    if constexpr (kWalk) {
      FirstHitVisit<kTr> visit{ox, oy, oz, dx, dy, dz, tmin, hi};
      const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
      group_walk<kTr, kNormalCols, kChunk / 8>(tri, T, boxes, w, c, valid && t == INFINITY, o,
                                               d, hi, visit);
      if (t == INFINITY) t = visit.t;
    } else {
      for (int e = 0; e < c && valid && t == INFINITY; ++e) {
        const int ch = w[e];
        if (ch < 0 || ch > (T - 1) / kChunk) continue;  // not a chunk of this scene
        const int k1 = min(ch * kChunk + kChunk, T);
        for (int k = ch * kChunk; k < k1 && t == INFINITY; ++k)
          t = tri_t(tri + (size_t)k * kTr, ox, oy, oz, dx, dy, dz, tmin, hi, true);
      }
    }
    if (valid) t_out[rid] = t;
    return;
  }

  // strict < keeps the first primitive on ties
  float t = INFINITY;
  int idx = kMiss;
  for (int s = 0; s < S && valid; ++s) {
    const float tc = sphere_t(sph + s * kSp, ox, oy, oz, dx, dy, dz, tmin, INFINITY);
    if (tc < t) {
      t = tc;
      idx = s;
    }
  }
  for (int q = 0; q < P && valid; ++q) {
    const float tc = plane_t(pln + q * kSp, ox, oy, oz, dx, dy, dz, tmin, INFINITY);
    if (tc < t) {
      t = tc;
      idx = S + q;
    }
  }
  if constexpr (kWalk) {
    ClosestVisit<kTr> visit{ox, oy, oz, dx, dy, dz, tmin, t};
    closest_walk<kTr, kChunk / 8>(tri, T, boxes, w, c, valid, visit);
    t = visit.t;
    if (visit.k >= 0) idx = S + P + visit.k;
  } else {
    for (int e = 0; e < c && valid; ++e) {
      const int ch = w[e];
      if (ch < 0 || ch > (T - 1) / kChunk) continue;  // not a chunk of this scene
      const int k1 = min(ch * kChunk + kChunk, T);
      for (int k = ch * kChunk; k < k1; ++k) {
        const float tc = tri_t(tri + (size_t)k * kTr, ox, oy, oz, dx, dy, dz, tmin, INFINITY,
                               false);
        if (tc < t) {
          t = tc;
          idx = S + P + k;
        }
      }
    }
  }
  if (!valid) return;

  // the winner's payload (pallas_kernel.py:_sphere_t_matrix and its kin)
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, mat = 0.0f;
  if (idx < S) {  // hit point minus center, normalized by the wrapper
    const float* r = sph + idx * kSp;
    nx = fmaf(t, dx, ox) - r[0];
    ny = fmaf(t, dy, oy) - r[1];
    nz = fmaf(t, dz, oz) - r[2];
    mat = r[4];
  } else if (idx < S + P) {
    const float* r = pln + (idx - S) * kSp;
    nx = r[0];
    ny = r[1];
    nz = r[2];
    mat = r[4];
  } else if (idx != kMiss) {
    const float* r = tri + (size_t)(idx - S - P) * kTr;
    nx = r[9];
    ny = r[10];
    nz = r[11];
    mat = r[13];
  }
  t_out[rid] = t;
  idx_out[rid] = idx;
  n_out[3 * rid] = nx;
  n_out[3 * rid + 1] = ny;
  n_out[3 * rid + 2] = nz;
  mat_out[rid] = (int)mat;
}

// K9: one thread per (ray, light), blocks of kShadeBlock threads, kTile /
// kShadeBlock blocks to a tile and one grid row per light.  Warp w of the
// tile takes its rays w * 32 to w * 32 + 31: the callers feed row-major
// rays (chunked.shade_rays, the stage profiler), of which these are 32
// neighbours on one row (shadow_ablation.py measures warp_slot's 8x4
// blocks against them; any permutation of a tile's rays gives the same
// answers).  Spheres and planes first, then the (tile, light) worklist of
// 128-triangle chunks: with the normal records (kWalk) shadow.cuh's walk,
// each chunk expanded to its 16 groups, as K10; else every triangle of
// every listed chunk, lane by lane.  Lanes past R vote and never write.
// At most 64 registers a thread (8 blocks of 128 an SM): the walk's kernel
// takes 84 at 4 blocks, and is 1.06-1.14x slower there (shadow_ablation.py).
template <bool kWalk>
__global__ void __launch_bounds__(kShadeBlock, 8) chunked_anyhit_kernel(
    const float* __restrict__ p, const float* __restrict__ dirs, const float* __restrict__ mags,
    int R, const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin,
    uint8_t* __restrict__ occ) {
  extern __shared__ float sm[];
  const float *sph, *pln;
  stage_sp(sm, sph_g, S, pln_g, P, &sph, &pln);
  constexpr int kBlocksPerTile = kTile / kShadeBlock;
  const int L = gridDim.y, l = blockIdx.y;
  const int tile = blockIdx.x / kBlocksPerTile;
  const int warp = (blockIdx.x % kBlocksPerTile) * (kShadeBlock / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rid = tile * kTile + warp * 32 + lane;
  const bool valid = rid < R;
  const size_t lr = (size_t)l * R + rid;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, mag = 0.0f;
  bool hit = false;
  if (valid) {
    ox = p[3 * rid], oy = p[3 * rid + 1], oz = p[3 * rid + 2];
    dx = dirs[3 * lr], dy = dirs[3 * lr + 1], dz = dirs[3 * lr + 2];
    mag = mags[lr];
    for (int s = 0; s < S && !hit; ++s)
      hit = sphere_t(sph + s * kSp, ox, oy, oz, dx, dy, dz, tmin, mag) < INFINITY;
    for (int q = 0; q < P && !hit; ++q)
      hit = plane_t(pln + q * kSp, ox, oy, oz, dx, dy, dz, tmin, mag) < INFINITY;
  }
  const int row = tile * L + l;
  const int* w = wl + (size_t)row * wl_cols;
  const int c = min(cnt[row], wl_cols);
  if constexpr (kWalk) {
    hit = shadow_walk<kTr, kNormalCols, kChunk / 8>(tri, T, boxes, w, c, valid && !hit, ox, oy,
                                                    oz, dx, dy, dz, tmin, mag) || hit;
  } else {
    for (int e = 0; e < c && valid && !hit; ++e) {
      const int ch = w[e];
      if (ch < 0 || ch > (T - 1) / kChunk) continue;  // not a chunk of this scene
      const int k1 = min(ch * kChunk + kChunk, T);
      for (int k = ch * kChunk; k < k1 && !hit; ++k)
        hit = tri_t(tri + (size_t)k * kTr, ox, oy, oz, dx, dy, dz, tmin, mag, true) < INFINITY;
    }
  }
  if (valid) occ[lr] = hit ? 1 : 0;
}

// K10: one thread a ray, blocks of kShadeBlock threads, kTile / kShadeBlock
// to a tile; warp w of the tile takes the 8x4 pixel block warp_slot(w,
// lane) of its 32x32 layout (any permutation of the tile's slots is
// right, so unfolded frames take it too).  Per light in order: spheres and
// planes, then the group walk over the (tile, light) worklist of
// 128-triangle chunks, each expanded to its 16 groups, with the normal
// records (kWalk; else every triangle of every listed chunk, lane by
// lane); then the shading of a lit light or the dim of an occluded one.
// Lanes past R or without a hit take part in every warp collective and are
// never live.
template <bool kWalk>
__global__ void __launch_bounds__(kShadeBlock, kWalk ? 4 : 8) chunked_shadow_shade_kernel(
    const uint8_t* __restrict__ hit, const float* __restrict__ normal,
    const float* __restrict__ point, const int* __restrict__ mat_id, const float* __restrict__ rd,
    const float* __restrict__ p_off, const float* __restrict__ dirs,
    const float* __restrict__ mags, int R, int L, const float* __restrict__ lights,
    const float* __restrict__ mats, int M, const float* __restrict__ sph_g, int S,
    const float* __restrict__ pln_g, int P, const float* __restrict__ tri, int T,
    const float* __restrict__ boxes, const int* __restrict__ wl, const int* __restrict__ cnt,
    int wl_cols, float tmin, int mode, int shadows, float shadow_dim, float* __restrict__ out) {
  extern __shared__ float sm[];
  const float *sph, *pln;
  stage_sp(sm, sph_g, S, pln_g, P, &sph, &pln);
  constexpr int kBlocksPerTile = kTile / kShadeBlock;
  const int tile = blockIdx.x / kBlocksPerTile;
  const int warp = (blockIdx.x % kBlocksPerTile) * (kShadeBlock / 32) + threadIdx.x / 32;
  const int rid = tile * kTile + warp_slot(warp, threadIdx.x % 32);
  const bool lit = rid < R && hit[rid];  // lanes past R vote, never write
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
  const float* m = mats;
  if (lit) {
    nx = normal[3 * rid], ny = normal[3 * rid + 1], nz = normal[3 * rid + 2];
    px = point[3 * rid], py = point[3 * rid + 1], pz = point[3 * rid + 2];
    ox = p_off[3 * rid], oy = p_off[3 * rid + 1], oz = p_off[3 * rid + 2];
    vx = -rd[3 * rid], vy = -rd[3 * rid + 1], vz = -rd[3 * rid + 2];
    m = mats + min(max(mat_id[rid], 0), M - 1) * kMat;
  }
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float sf = 1.0f;
  for (int l = 0; l < L; ++l) {
    const size_t lr = (size_t)l * R + rid;
    float lx = 0.0f, ly = 0.0f, lz = 0.0f, mag = 0.0f;
    if (lit) lx = dirs[3 * lr], ly = dirs[3 * lr + 1], lz = dirs[3 * lr + 2], mag = mags[lr];
    bool occ = false;
    if (shadows) {  // uniform over the grid
      for (int s = 0; s < S && lit && !occ; ++s)
        occ = sphere_t(sph + s * kSp, ox, oy, oz, lx, ly, lz, tmin, mag) < INFINITY;
      for (int q = 0; q < P && lit && !occ; ++q)
        occ = plane_t(pln + q * kSp, ox, oy, oz, lx, ly, lz, tmin, mag) < INFINITY;
      const int row = tile * L + l;
      const int* w = wl + (size_t)row * wl_cols;
      const int c = min(cnt[row], wl_cols);
      if constexpr (kWalk) {
        AnyHitVisit<kTr> visit{ox, oy, oz, lx, ly, lz, tmin, mag};
        const float o[3] = {ox, oy, oz}, d[3] = {lx, ly, lz};
        group_walk<kTr, kNormalCols, kChunk / 8>(tri, T, boxes, w, c, lit && !occ, o, d, mag,
                                                 visit);
        occ = occ || visit.occ;
      } else {
        for (int e = 0; e < c && lit && !occ; ++e) {
          const int ch = w[e];
          if (ch < 0 || ch > (T - 1) / kChunk) continue;  // not a chunk of this scene
          const int k1 = min(ch * kChunk + kChunk, T);
          for (int k = ch * kChunk; k < k1 && !occ; ++k)
            occ = tri_t(tri + (size_t)k * kTr, ox, oy, oz, lx, ly, lz, tmin, mag, true) < INFINITY;
        }
      }
    }
    if (lit && occ) {
      sf = sf * shadow_dim;
    } else if (lit) {
      const float* li = lights + l * kLight;
      float w[3];
      shade_one_light(mode, li[7] == 0.0f, li, px, py, pz, nx, ny, nz, lx, ly, lz, vx, vy, vz, m,
                      w);
      rgb[0] = rgb[0] + w[0];
      rgb[1] = rgb[1] + w[1];
      rgb[2] = rgb[2] + w[2];
    }
  }
  if (lit) dim_and_tonemap(sf, rgb);
  if (rid < R) {
    out[3 * rid] = rgb[0];
    out[3 * rid + 1] = rgb[1];
    out[3 * rid + 2] = rgb[2];
  }
}

size_t sp_smem(int S, int P) {
  return (S + P) * kSp <= kSmemFloats ? sizeof(float) * (S + P) * kSp : 0;
}

}  // namespace

extern "C" {

// Launches K8 on `stream` over ceil(R/1024) tiles.  ro, rd (R, 3) float32;
// `tmax` (R,) float32 or null for no bound, read in the shadow mode only;
// `boxes` (ceil(T/8), 32) the normal records (accel.normal_boxes), 16-byte
// aligned, or null to test every listed triangle without box tests; `wl`
// (nt, wl_cols) and `cnt` (nt,) the tiles' chunk worklists; `shadow`
// selects the shadow mode, which writes t_out (R,) only.  The closest mode
// writes t_out, idx_out (R,) int32, n_out (R, 3) float32 and mat_out (R,)
// int32.  Returns cudaGetLastError() after the launch.
int raytpu_chunked_min_t(const float* ro, const float* rd, const float* tmax, int R,
                         const float* sph, int S, const float* pln, int P, const float* tri, int T,
                         const float* boxes, const int* wl, const int* cnt, int wl_cols,
                         float ray_min, int shadow, float* t_out, int* idx_out, float* n_out,
                         int* mat_out, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (R + kTile - 1) / kTile * (kTile / kShadeBlock);
  // without box records (a scene of a few groups, render/chunked.py): every
  // listed triangle, lane by lane
  auto kernel = shadow ? (boxes ? chunked_min_t_kernel<true, true>
                                : chunked_min_t_kernel<false, true>)
                       : (boxes ? chunked_min_t_kernel<true, false>
                                : chunked_min_t_kernel<false, false>);
  kernel<<<blocks, kShadeBlock, sp_smem(S, P), static_cast<cudaStream_t>(stream)>>>(
      ro, rd, tmax, R, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, ray_min, t_out, idx_out,
      n_out, mat_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches K9 on `stream`.  p (R, 3), dirs (L, R, 3), mags (L, R) float32;
// `boxes` (ceil(T/8), 32) the normal records (accel.normal_boxes), 16-byte
// aligned, or null to test every listed triangle without box tests; `wl`
// (nt, L, wl_cols) and `cnt` (nt, L) the per-light chunk worklists; `occ`
// (L, R) bytes.  Returns cudaGetLastError() after the launch.
int raytpu_chunked_anyhit_lights(const float* p, const float* dirs, const float* mags, int R,
                                 int L, const float* sph, int S, const float* pln, int P,
                                 const float* tri, int T, const float* boxes, const int* wl,
                                 const int* cnt, int wl_cols, float ray_min, uint8_t* occ,
                                 void* stream) {
  if (R == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((R + kTile - 1) / kTile * (kTile / kShadeBlock), L);
  // without box records (a scene of a few groups, render/chunked.py): every
  // listed triangle, at the walk's occupancy, where the box tests cost more
  // than they skip
  auto kernel = boxes ? chunked_anyhit_kernel<true> : chunked_anyhit_kernel<false>;
  kernel<<<grid, kShadeBlock, sp_smem(S, P), static_cast<cudaStream_t>(stream)>>>(
      p, dirs, mags, R, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, ray_min, occ);
  return static_cast<int>(cudaGetLastError());
}

// Launches K10 on `stream`.  hit (R,) bytes; normal, point, rd, p_off (R, 3)
// and dirs (L, R, 3), mags (L, R) float32; mat_id (R,) int32; lights (L, 8)
// and mats (M, 7) float32; `boxes` (ceil(T/8), 32) the normal records
// (accel.normal_boxes), 16-byte aligned, or null to test every listed
// triangle without box tests; `wl` (nt, L, wl_cols) and `cnt` (nt, L) the
// per-light chunk worklists; boxes, wl and cnt are read only when
// `shadows`; out (R, 3) float32.
// Returns cudaGetLastError() after the launch.
int raytpu_chunked_shadow_shade(const uint8_t* hit, const float* normal, const float* point,
                                const int* mat_id, const float* rd, const float* p_off,
                                const float* dirs, const float* mags, int R, int L,
                                const float* lights, const float* mats, int M, const float* sph,
                                int S, const float* pln, int P, const float* tri, int T,
                                const float* boxes, const int* wl, const int* cnt, int wl_cols,
                                float ray_min, int mode, int shadows, float shadow_dim,
                                float* out, void* stream) {
  const int blocks = (R + kTile - 1) / kTile * (kTile / kShadeBlock);
  // without box records (a scene of a few groups, render/chunked.py): every
  // listed triangle, at up to 64 registers a thread, twice the walk's
  // occupancy for the sphere loop that dominates such a scene
  auto kernel = boxes ? chunked_shadow_shade_kernel<true> : chunked_shadow_shade_kernel<false>;
  kernel<<<blocks, kShadeBlock, sp_smem(S, P), static_cast<cudaStream_t>(stream)>>>(
      hit, normal, point, mat_id, rd, p_off, dirs, mags, R, L, lights, mats, M, sph, S, pln, P,
      tri, T, boxes, wl, cnt, wl_cols, ray_min, mode, shadows, shadow_dim, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
