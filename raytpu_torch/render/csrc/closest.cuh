// The closest-hit pass of the whole-frame routes, one body for K2a
// (mega2.cu, the mega2 route) and K11a (mega3.cu, the streamed route).
//
// Both compute, from the same worklists of 8-triangle groups: camera rays
// generated in the kernel -> closest hit over every sphere and plane and
// the groups of the tile's worklist -> per ray t, unit normal and
// material(7) into `acc` (11 rows of tiles*1024 floats), and per tile the
// box of the offset hit points into `bounds` (tiles, 6): [min xyz, max
// xyz], empty (+inf/-inf) when no ray of the tile hits.  They differ only
// in where the triangles' 20-float records lie: K2a reads them from the
// scene buffer after the camera, spheres and planes (as K2b does), K11a
// from its blob of groups (mega3.py:pack_groups).
//
// One thread per ray slot, blocks of kClosestBlock threads, kTile /
// kClosestBlock blocks to a tile; warp w of the tile takes slot
// warp_slot(w, lane) (shadow.cuh) and writes its ray to acc column tile *
// 1024 + slot, so the shading pass, whatever its slot order, reads the
// same rays.  In-kernel raygen, spheres and planes, then shadow.cuh's
// closest walk over the tile's worklist with the normal records: each ray
// tests a group's record, widened for the ray, up to its current closest
// hit before the group's triangles, and the walk returns the fold over
// every listed triangle bit for bit (shadow.cuh says why).  Each block
// reduces the box of its rays' offset hit points into part (tiles *
// kBlocksPerTile, 6); the last of a tile's blocks to finish (a per-tile
// counter, zero before the launch) folds the tile's partial boxes in block
// order into `bounds`: min and max are exact in any order, so the boxes
// equal a fold over the tile's rays.  A stale counter gives a wrong tile
// box, not a crash; only the shadow worklists built from it would show it.
#pragma once

#include "shadow.cuh"

namespace raytpu_dev {

constexpr int kClosestTile = 1024;
constexpr int kClosestBlock = 128;  // 4 warps
constexpr int kClosestAccRows = 11;  // t, normal(3), material(7)
constexpr int kClosestBlocksPerTile = kClosestTile / kClosestBlock;

// The pass over tiles [tile0, tile0 + gridDim.x / kClosestBlocksPerTile):
// `scene` the whole-frame kernels' buffer (plain.py: camera, spheres,
// planes, ...), `tri` the T triangles' 20-float records, `boxes` (ceil(T/8),
// 32) the normal records (accel.normal_boxes), 16-byte aligned, `wl`
// (tiles, wl_cols) and `cnt` (tiles,) the tiles' group worklists.  The
// kernel's dynamic shared memory holds the camera, spheres and planes.
__device__ __forceinline__ void closest_pass(
    const float* __restrict__ scene, int S, int P, int T, const float* __restrict__ tri,
    const float* __restrict__ boxes, const int* __restrict__ wl, const int* __restrict__ cnt,
    int wl_cols, int W, int H, int tiled, int tile0, float tmin, float normal_offset,
    float* __restrict__ acc, float* __restrict__ part, unsigned* __restrict__ done,
    float* __restrict__ bounds) {
  extern __shared__ float sm[];  // cam | spheres | planes
  __shared__ float wpart[6][kClosestBlock / 32];
  const int n = kCam + S * kSph + P * kPln;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = scene[k];
  __syncthreads();
  const float* cam = sm;
  const float* sph = cam + kCam;
  const float* pln = sph + S * kSph;
  const int tile = blockIdx.x / kClosestBlocksPerTile;
  const int slots = (gridDim.x / kClosestBlocksPerTile) * kClosestTile;
  const int lane = threadIdx.x % 32, warp_in = threadIdx.x / 32;
  const int j = warp_slot((blockIdx.x % kClosestBlocksPerTile) * (kClosestBlock / 32) + warp_in,
                          lane);

  int pxi = 0, pyi = 0;
  const bool valid = tile_pixel(tile0 + tile, j, W, H, tiled, &pxi, &pyi);
  const float rox = cam[0], roy = cam[1], roz = cam[2];
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  float t = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool is_sph = false;
  const float* mat = nullptr;  // shared memory or the triangle records
  if (valid) {
    raygen(cam, pxi, pyi, W, H, &rdx, &rdy, &rdz);
    for (int s = 0; s < S; ++s) {
      const float* r = sph + s * kSph;
      const float tc = sphere_t(r, rox, roy, roz, rdx, rdy, rdz, tmin, INFINITY);
      if (tc < t) {
        t = tc;
        nx = fmaf(tc, rdx, rox) - r[0];
        ny = fmaf(tc, rdy, roy) - r[1];
        nz = fmaf(tc, rdz, roz) - r[2];
        is_sph = true;
        mat = r + 4;
      }
    }
    for (int p = 0; p < P; ++p) {
      const float* r = pln + p * kPln;
      const float tc = plane_t(r, rox, roy, roz, rdx, rdy, rdz, tmin, INFINITY);
      if (tc < t) {
        t = tc;
        nx = r[0];
        ny = r[1];
        nz = r[2];
        is_sph = false;
        mat = r + 4;
      }
    }
  }
  ClosestVisit<kTri> visit{rox, roy, roz, rdx, rdy, rdz, tmin, t};
  closest_walk<kTri>(tri, T, boxes, wl + (size_t)tile * wl_cols, min(cnt[tile], wl_cols), valid,
                     visit);
  if (visit.k >= 0) {
    const float* r = tri + (size_t)visit.k * kTri;
    t = visit.t;
    nx = r[9];
    ny = r[10];
    nz = r[11];
    is_sph = false;
    mat = r + 13;
  }

  float* a = acc + (size_t)tile * kClosestTile + j;  // row q at a[q * slots]
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (t < INFINITY) {  // never for a slot past the frame
    if (is_sph) {  // normalized after the selection (reference: source/Scene.cpp:40)
      const float n_len = sqrtf(fmaxf(sqn(nx, ny, nz), 1e-20f));
      nx = nx / n_len;
      ny = ny / n_len;
      nz = nz / n_len;
    }
    // the offset hit point, exactly as the shading pass forms its shadow origin
    const float ox = fmaf(nx, normal_offset, fmaf(t, rdx, rox));
    const float oy = fmaf(ny, normal_offset, fmaf(t, rdy, roy));
    const float oz = fmaf(nz, normal_offset, fmaf(t, rdz, roz));
    box[0] = box[3] = ox;
    box[1] = box[4] = oy;
    box[2] = box[5] = oz;
    a[0] = t;
    a[slots] = nx;
    a[2 * slots] = ny;
    a[3 * slots] = nz;
    for (int q = 0; q < 7; ++q) a[(4 + q) * slots] = mat[q];
  } else {
    a[0] = INFINITY;
    for (int q = 1; q < kClosestAccRows; ++q) a[q * slots] = 0.0f;
  }

  // the block's box: min/max over each warp by shuffles, then over its warps
  for (int off = 16; off > 0; off >>= 1) {
    for (int q = 0; q < 3; ++q) box[q] = fminf(box[q], __shfl_xor_sync(kFullWarp, box[q], off));
    for (int q = 3; q < 6; ++q) box[q] = fmaxf(box[q], __shfl_xor_sync(kFullWarp, box[q], off));
  }
  if (lane == 0)
    for (int q = 0; q < 6; ++q) wpart[q][warp_in] = box[q];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kClosestBlock / 32; ++w) {
      for (int q = 0; q < 3; ++q) box[q] = fminf(box[q], wpart[q][w]);
      for (int q = 3; q < 6; ++q) box[q] = fmaxf(box[q], wpart[q][w]);
    }
    for (int q = 0; q < 6; ++q) part[(size_t)blockIdx.x * 6 + q] = box[q];
    __threadfence();  // the partial box is visible before the count says so
    // the tile's last block: every block of the tile has written its box
    if (atomicAdd(done + tile, 1u) == kClosestBlocksPerTile - 1) {
      __threadfence();
      const volatile float* tp = part + (size_t)tile * kClosestBlocksPerTile * 6;
      for (int q = 0; q < 6; ++q) box[q] = tp[q];
      for (int b = 1; b < kClosestBlocksPerTile; ++b) {
        for (int q = 0; q < 3; ++q) box[q] = fminf(box[q], tp[b * 6 + q]);
        for (int q = 3; q < 6; ++q) box[q] = fmaxf(box[q], tp[b * 6 + q]);
      }
      for (int q = 0; q < 6; ++q) bounds[tile * 6 + q] = box[q];
    }
  }
}

}  // namespace raytpu_dev

// The closest pass's blocks a tile, by which the callers size `part`
// (mega2.py:closest_scratch).  Each source that includes this header
// defines it; weak, so that they link as one.
extern "C" __attribute__((weak)) int raytpu_closest_blocks_per_tile() {
  return raytpu_dev::kClosestBlocksPerTile;
}
