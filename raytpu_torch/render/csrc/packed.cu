// K3 and K4: the packed route's winner search and all-lights any-hit for
// Hopper (sm_90a), for scenes of 9,600 to 1,048,576 triangles.
//
// K3 replaces raytpu/render/pallas_soft.py:_make_mint_kernel (payload=True)
// and its streamed form _make_mint_stream_kernel (K3s), both reached through
// scene_min_t_mega2: for arbitrary rays (ro, rd), the closest hit over every
// sphere and plane and the triangles of the ray tile's worklist of
// 8-triangle groups -> t (inf on a miss), the winner's global index (spheres
// -> planes -> triangles; 0 on a miss), its unit normal and its material id.
// K4 replaces _make_anyhit_kernel and its streamed form
// _make_anyhit_stream_kernel (K4s), reached through any_hit_lights_mega2:
// for shadow origins p and per-light directions and distances, whether
// anything lies on each light's segment, triangle culling inverted ->
// (L, R) bytes 0/1.  Eager torch glue (raytpu_torch/render/packed.py) builds
// the worklists; the eager shade tail shades from K3's records and K4's
// occlusion.
//
// Records: sphere center(3) radius^2 material_id, plane normal(3)
// dot(origin, normal) material_id, triangle v0(3) e1(3) e2(3) normal(3)
// cull material_id (pallas_soft.py:_soft_packs).
//
// A tile is 1024 consecutive rays (the route feeds camera rays in 32x32
// pixel blocks).  K3 runs eight blocks of 128 threads per tile, K4 eight
// per tile and light, one thread per ray (below).  Worklists
// list each tile's passing groups in ascending order, and the
// strict < update then gives a tie to the first primitive: the eager
// argmin's order, stricter than raytpu's streamed K3, which may break
// cross-group ties either way.
//
// What bounds it.  The bytes are the rays (24 B in, 24 B out per ray for
// K3; 12 + 16 B in and 1 B out per ray and light for K4), the worklist
// entries the tiles read and a triangle table of 56 B per triangle (17 MB
// at 299k).  The work is ~50 FP32 operations per ray-triangle test that a
// worklist passes, so the bound is the card's FP32 rate (chip_smoke.py
// counts the tests from this run's worklists, and the box-culled ones).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W,
// bunny300k at 640x480 (2,135 triangle tests per camera ray): the
// 1024-thread K3 and K4 that walked every listed triangle 37.9 and 142.4
// ms, 73x and 56x their bounds of 0.52 and 2.54 ms; PERF.md has the times
// of the walks since.
//
// What the design does about it.  The TPU's split between an SMEM launch
// chain up to 9,600 triangles and a DMA-streamed kernel past it is a layout
// artifact: here one kernel reads the triangles from device memory at any T,
// through the caches.  Spheres and planes sit in shared memory.  Both kernels
// are shadow.cuh's walk: a ray tests only the groups whose box, padded and
// widened for the ray, its segment crosses (a warp tests the listed boxes
// against the bounds of its 32 rays first).  K3's segment ends at the
// ray's current closest hit, so it shrinks as the walk finds hits (the
// closest walk, which returns the fold over every listed triangle bit for
// bit); K4's is the light's, it stops at its first occluder and its warp
// leaves the row once every lane is resolved.  Small blocks leave no
// 27%-full last wave of 1024-thread blocks and let a warp finish without
// its block's slowest.  The arithmetic is common.cuh's, so K3 agrees bit
// for bit with its plain version and with the eager closest hit
// (raytpu_torch/ops/intersect.py) where their formulas agree.

#include <stdint.h>

#include "shadow.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kBlock = 128;  // K3's and K4's threads a block: 4 warps
constexpr int kGroup = 8;
constexpr int kSp = 5;    // sphere / plane record
constexpr int kTr = 14;   // triangle record

// K3: one thread per ray, blocks of kBlock threads, kTile / kBlock blocks
// to a tile; warp w of the tile takes slots warp_slot(w, lane) (one answer
// a ray: the order of a tile's rays changes none).  Spheres and planes
// first, then closest_walk over the tile's worklist with the group
// records, then the winner's payload.
__global__ void __launch_bounds__(kBlock, 4) packed_closest_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd, int R,
    const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin,
    float* __restrict__ t_out, int* __restrict__ idx_out, float* __restrict__ n_out,
    int* __restrict__ mat_out) {
  extern __shared__ float sm[];  // spheres | planes
  for (int k = threadIdx.x; k < S * kSp; k += blockDim.x) sm[k] = sph_g[k];
  for (int k = threadIdx.x; k < P * kSp; k += blockDim.x) sm[S * kSp + k] = pln_g[k];
  __syncthreads();
  const float* sph = sm;
  const float* pln = sm + S * kSp;
  const int tile = blockIdx.x / (kTile / kBlock);
  const int warp = (blockIdx.x % (kTile / kBlock)) * (kBlock / 32) + threadIdx.x / 32;
  const int rid = tile * kTile + warp_slot(warp, threadIdx.x % 32);
  const bool valid = rid < R;  // lanes past the rays vote, never write
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (valid) {
    ox = ro[3 * rid], oy = ro[3 * rid + 1], oz = ro[3 * rid + 2];
    dx = rd[3 * rid], dy = rd[3 * rid + 1], dz = rd[3 * rid + 2];
  }

  // strict < keeps the first primitive on ties
  float t = INFINITY;
  int idx = 0;
  for (int s = 0; s < S && valid; ++s) {
    const float tc = sphere_t(sph + s * kSp, ox, oy, oz, dx, dy, dz, tmin, INFINITY);
    if (tc < t) {
      t = tc;
      idx = s;
    }
  }
  for (int p = 0; p < P && valid; ++p) {
    const float tc = plane_t(pln + p * kSp, ox, oy, oz, dx, dy, dz, tmin, INFINITY);
    if (tc < t) {
      t = tc;
      idx = S + p;
    }
  }
  ClosestVisit<kTr> visit{ox, oy, oz, dx, dy, dz, tmin, t};
  closest_walk<kTr>(tri, T, boxes, wl + (size_t)tile * wl_cols, min(cnt[tile], wl_cols), valid,
                    visit);
  if (!valid) return;
  t = visit.t;
  if (visit.k >= 0) idx = S + P + visit.k;

  // the winner's payload, as intersect.assemble_hit_records forms it
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, mat = 0.0f;
  if (t < INFINITY) {
    if (idx < S) {  // normalized from the hit point (reference: source/Scene.cpp:40)
      const float* r = sph + idx * kSp;
      const float cx = fmaf(t, dx, ox) - r[0];
      const float cy = fmaf(t, dy, oy) - r[1];
      const float cz = fmaf(t, dz, oz) - r[2];
      const float n_len = sqrtf(fmaxf(sqn(cx, cy, cz), 1e-20f));
      nx = cx / n_len;
      ny = cy / n_len;
      nz = cz / n_len;
      mat = r[4];
    } else if (idx < S + P) {
      const float* r = pln + (idx - S) * kSp;
      nx = r[0];
      ny = r[1];
      nz = r[2];
      mat = r[4];
    } else {
      const float* r = tri + (size_t)(idx - S - P) * kTr;
      nx = r[9];
      ny = r[10];
      nz = r[11];
      mat = r[13];
    }
  }
  t_out[rid] = t;
  idx_out[rid] = idx;
  n_out[3 * rid] = nx;
  n_out[3 * rid + 1] = ny;
  n_out[3 * rid + 2] = nz;
  mat_out[rid] = (int)mat;
}

// K4: one thread per (ray, light), blocks of kBlock threads, kTile / kBlock
// blocks to a tile and one grid row per light.  Warp w of the tile takes the
// 8x4 pixel block warp_slot(w, lane) of the tile's 32x32 layout (any
// permutation of a tile's rays gives the same answer; the routes feed 32x32
// blocks).  Spheres and planes first, then shadow_walk over the (tile,
// light) worklist with the group boxes.
__global__ void __launch_bounds__(kBlock, 4) packed_anyhit_kernel(
    const float* __restrict__ p, const float* __restrict__ dirs, const float* __restrict__ mags,
    int R, const float* __restrict__ sph_g, int S, const float* __restrict__ pln_g, int P,
    const float* __restrict__ tri, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, float tmin,
    uint8_t* __restrict__ occ) {
  extern __shared__ float sm[];  // spheres | planes
  for (int k = threadIdx.x; k < S * kSp; k += blockDim.x) sm[k] = sph_g[k];
  for (int k = threadIdx.x; k < P * kSp; k += blockDim.x) sm[S * kSp + k] = pln_g[k];
  __syncthreads();
  const float* sph = sm;
  const float* pln = sm + S * kSp;
  const int L = gridDim.y, l = blockIdx.y;
  const int tile = blockIdx.x / (kTile / kBlock);
  const int warp = (blockIdx.x % (kTile / kBlock)) * (kBlock / 32) + threadIdx.x / 32;
  const int rid = tile * kTile + warp_slot(warp, threadIdx.x % 32);
  const bool valid = rid < R;  // lanes past the rays vote, never write
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
  const bool tri_hit = shadow_walk<kTr>(tri, T, boxes, wl + (size_t)row * wl_cols,
                                        min(cnt[row], wl_cols), valid && !hit, ox, oy, oz, dx, dy,
                                        dz, tmin, mag);
  if (valid) occ[lr] = (hit || tri_hit) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over ceil(R/1024) tiles.  ro, rd, n_out (R, 3)
// float32; t_out (R,) float32; idx_out, mat_out (R,) int32; `boxes`
// (ceil(T/8), 32) float32 the normal records (accel.normal_boxes), 16-byte
// aligned; `wl` (nt, wl_cols) and `cnt` (nt,) the tiles' group worklists.
// Returns cudaGetLastError() after the launch.
int raytpu_packed_closest(const float* ro, const float* rd, int R, const float* sph, int S,
                          const float* pln, int P, const float* tri, int T, const float* boxes,
                          const int* wl, const int* cnt, int wl_cols, float ray_min, float* t_out,
                          int* idx_out, float* n_out, int* mat_out, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (R + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * (S + P) * kSp;
  packed_closest_kernel<<<tiles * (kTile / kBlock), kBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      ro, rd, R, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, ray_min, t_out, idx_out, n_out,
      mat_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches K4 on `stream`.  p (R, 3), dirs (L, R, 3), mags (L, R) float32;
// `boxes` (ceil(T/8), 8) float32 the group box records (accel.shadow_boxes),
// 16-byte aligned;
// `wl` (nt, L, wl_cols) and `cnt` (nt, L) the per-light worklists; `occ`
// (L, R) bytes.  Returns cudaGetLastError() after the launch.
int raytpu_packed_anyhit(const float* p, const float* dirs, const float* mags, int R, int L,
                         const float* sph, int S, const float* pln, int P, const float* tri, int T,
                         const float* boxes, const int* wl, const int* cnt, int wl_cols,
                         float ray_min, uint8_t* occ, void* stream) {
  if (R == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (R + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * (S + P) * kSp;
  const dim3 grid(tiles * (kTile / kBlock), L);
  packed_anyhit_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      p, dirs, mags, R, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, ray_min, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
