// K2a and K2b: the mega2 route's two whole-frame passes for Hopper (sm_90a).
//
// Replace raytpu/render/pallas_kernel.py:_make_mega2_closest_kernel with
// _emit_hit_bounds (K2a) and _make_mega2_shadow_kernel (K2b), the two
// launch chains of render_image_mega2_f32, for scenes of up to 9,600
// triangles.  Between them, eager torch glue (raytpu_torch/render/mega2.py)
// builds each light's shadow worklists from K2a's per-tile boxes.
//
//   K2a: camera rays generated in the kernel -> closest hit over every
//        sphere and plane and the triangles of the tile's worklist of
//        8-triangle groups -> per ray t, unit normal and material(7) into
//        `acc` (11 rows of nt*1024 floats), and per tile the box of the
//        offset hit points into `bounds` (nt, 6): [min xyz, max xyz], empty
//        (+inf/-inf) when no ray of the tile hits.
//   K2b: the same camera rays -> from `acc`, the hit's shading tail: per
//        light a shadow ray against every sphere and plane and the groups
//        of that light's worklist, stopping at the first occluder -> 4
//        lighting modes x 4 material kinds -> 0.95 dim per occluded light
//        -> MaxToOne -> (H, W, 3) float32.
//
// A tile is 1024 rays: a 32x32 pixel block when W and H are multiples of 32
// (a tight cone of directions, which culls well), else 1024 consecutive
// row-major pixels with the ragged end masked (common.cuh:tile_pixel).
// Both passes take a range of the frame's tiles [tile0, tile0 + tiles), the
// per-rank body of the px-sharded render (render_image_mega2_f32's
// tile0/tiles); K2b then writes the range's rays in feed order.  Both:
// eight blocks of 128 a tile, each warp on an 8x4 pixel block
// (shadow.cuh:warp_slot).
// Worklists hold each tile's passing groups in ascending order; with the
// strict < update a tie goes to the first primitive in sphere -> plane ->
// triangle order, as in the eager argmin.
//
// What bounds it.  The bytes are small: a scene of at most ~0.8 MB, 44 B
// of `acc` per ray each way, 12 B of image per ray.  The work is FP32
// arithmetic, ~50 operations for each ray-triangle test that the
// worklists pass and ~100 of shading per light, so the bound is the card's
// FP32 rate (chip_smoke.py counts the tests from this frame's worklists).
//
// What the design does about it.  The culls skip most groups (a tile tests
// only the groups its ray bounds may reach).  The TPU kernel's SMEM budget
// of 1,200 triangles, its chain of launches and its (8,128) register tiles
// are layout artifacts that are not ported: here each pass is one launch at
// any triangle count.  Spheres, planes, the camera and the lights sit in
// shared memory; triangles stay in device memory.  A worklist row is the
// union over a whole tile, so each ray walks it with shadow.cuh's group
// walk and the normal records, which the route builds once a frame for
// both culls and both passes.  K2a is K11a's body (closest.cuh's
// closest_pass, the closest walk: each ray tests a group's record up to
// its current closest hit), reading the triangles from the scene buffer;
// its buffer and boxes equal the fold over every listed triangle, and
// K11a's, bit for bit.  K2b walks its shadow worklists as K11b (mega3.cu)
// does: the warp's bundle, then each ray, test the groups' normal records
// (accel.normal_boxes: the padded box, widened for the ray by a bound of
// tri_t's error that the group's triangle normals narrow for rays far from
// grazing), a warp leaves a row once its rays are resolved, and a query
// runs the triangles of the few groups its segment crosses.  The
// occlusion does not depend on which listed triangles are tested, so the
// image equals the fold over every listed triangle, and K11b's image, bit
// for bit.  A miss skips K2b's lights.  The arithmetic is common.cuh's, so
// the passes agree with their plain versions (mega2.py) up to powf's last
// bit.

#include "closest.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kShadeBlock = 128;  // K2b's threads a block: 4 warps

// K2a: closest.cuh's closest pass (K11a's body), the triangles read from
// the scene buffer as 20-float records.
__global__ void __launch_bounds__(kClosestBlock, 4) mega2_closest_kernel(
    const float* __restrict__ scene, int S, int P, int T, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, int W, int H,
    int tiled, int tile0, float tmin, float normal_offset, float* __restrict__ acc,
    float* __restrict__ part, unsigned* __restrict__ done, float* __restrict__ bounds) {
  closest_pass(scene, S, P, T, scene + kCam + S * kSph + P * kPln, boxes, wl, cnt, wl_cols, W,
               H, tiled, tile0, tmin, normal_offset, acc, part, done, bounds);
}

// K2b: one thread per ray slot, blocks of kShadeBlock threads, kTile /
// kShadeBlock blocks to a tile; warp w of the tile takes slot warp_slot(w,
// lane) (K2a wrote slot j of the tile at acc column tile * 1024 + j, so any
// slot order reads the same rays).  Every light's shadow query first, into
// one bit of a mask: spheres and planes, then shadow.cuh's walk over the
// (tile, light) worklist of 8-triangle groups with the normal records, the
// triangles read from the scene buffer as 20-float records; then the
// shading, which reads the mask.  Lanes past the frame or without a hit
// take part in every warp collective and are never live.
__global__ void __launch_bounds__(kShadeBlock, 4) mega2_shade_kernel(
    const float* __restrict__ scene, int S, int P, int T, int L, const float* __restrict__ boxes,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, int W, int H, int tiled,
    int tile0, int feed, int mode, int shadows, float tmin, float normal_offset,
    float shadow_dim, const float* __restrict__ acc, float* __restrict__ out) {
  extern __shared__ float sm[];  // cam | spheres | planes | lights
  const int n = kCam + S * kSph + P * kPln;
  const float* lit_g = scene + n + (size_t)T * kTri;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = scene[k];
  for (int k = threadIdx.x; k < L * kLight; k += blockDim.x) sm[n + k] = lit_g[k];
  __syncthreads();
  const float* cam = sm;
  const float* sph = cam + kCam;
  const float* pln = sph + S * kSph;
  const float* lit = sm + n;
  const float* tri = scene + n;  // device memory
  constexpr int kBlocksPerTile = kTile / kShadeBlock;
  const int tile = blockIdx.x / kBlocksPerTile;
  const int slots = (gridDim.x / kBlocksPerTile) * kTile;
  const int warp = (blockIdx.x % kBlocksPerTile) * (kShadeBlock / 32) + threadIdx.x / 32;
  const int j = warp_slot(warp, threadIdx.x % 32);

  int pxi = 0, pyi = 0;
  const bool valid = tile_pixel(tile0 + tile, j, W, H, tiled, &pxi, &pyi);
  const float* a = acc + (size_t)tile * kTile + j;
  const float t = a[0];
  const bool hit = valid && t < INFINITY;
  const float rox = cam[0], roy = cam[1], roz = cam[2];
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f, ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (hit) {  // the shadow origin, as shade_hit forms it
    raygen(cam, pxi, pyi, W, H, &rdx, &rdy, &rdz);
    ox = fmaf(a[slots], normal_offset, fmaf(t, rdx, rox));
    oy = fmaf(a[2 * slots], normal_offset, fmaf(t, rdy, roy));
    oz = fmaf(a[3 * slots], normal_offset, fmaf(t, rdz, roz));
  }

  // every light's shadow query first, a warp at a time; a miss needs none
  unsigned occluded = 0u;
  if (shadows) {
    for (int l = 0; l < L; ++l) {
      bool occ = false;
      float lx = 0.0f, ly = 0.0f, lz = 0.0f, mag = 0.0f;
      if (hit) {
        light_dir(lit + l * kLight, ox, oy, oz, &lx, &ly, &lz, &mag);
        for (int s = 0; s < S && !occ; ++s)
          occ = sphere_t(sph + s * kSph, ox, oy, oz, lx, ly, lz, tmin, mag) < INFINITY;
        for (int p = 0; p < P && !occ; ++p)
          occ = plane_t(pln + p * kPln, ox, oy, oz, lx, ly, lz, tmin, mag) < INFINITY;
      }
      const int row = tile * L + l;
      occ = shadow_walk<kTri, kNormalCols>(tri, T, boxes, wl + (size_t)row * wl_cols,
                                           min(cnt[row], wl_cols), hit && !occ, ox, oy, oz, lx,
                                           ly, lz, tmin, mag) || occ;
      if (hit && occ) occluded |= 1u << l;
    }
  }

  // `feed`: the tile range's rays in feed order, (tiles * 1024, 3), black
  // past the frame; else the (H, W, 3) image
  float* o = feed ? out + 3 * ((size_t)tile * kTile + j) : out + 3 * ((size_t)pyi * W + pxi);
  if (!valid) {
    if (feed) o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  if (!hit) {  // miss: black, whatever the lights
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  float mat[7];
  for (int q = 0; q < 7; ++q) mat[q] = a[(4 + q) * slots];
  shade_hit(lit, L, mode, shadows != 0, normal_offset, shadow_dim, rox, roy, roz, rdx, rdy, rdz,
            t, a[slots], a[2 * slots], a[3 * slots], mat,
            [&](int l, float, float, float, float, float, float, float) {
              return ((occluded >> l) & 1u) != 0u;
            },
            o);
}

}  // namespace

extern "C" {

// Launches K2a on `stream` over the frame's tiles [tile0, tile0 + tiles)
// (the whole frame: 0 and ceil(W*H/1024)).  `boxes` (ceil(T/8), 32)
// float32 are the normal records (accel.normal_boxes), 16-byte aligned;
// `wl` (tiles, wl_cols) and `cnt` (tiles,) the tiles' group worklists;
// `acc` is 11 x tiles*1024 float32 and `bounds` tiles x 6; `part` (tiles *
// raytpu_closest_blocks_per_tile(), 6) float32 scratch for the blocks'
// partial boxes and `done` (tiles,) uint32 zeros, the blocks' counts
// (nonzero after it).  Returns cudaGetLastError() after the launch.
int raytpu_mega2_closest(const float* scene, int S, int P, int T, const float* boxes,
                         const int* wl, const int* cnt, int wl_cols, int W, int H, int tiled,
                         int tile0, int tiles, float ray_min, float normal_offset, float* acc,
                         float* part, unsigned* done, float* bounds, void* stream) {
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln);
  mega2_closest_kernel<<<tiles * kClosestBlocksPerTile, kClosestBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, boxes, wl, cnt, wl_cols, W, H, tiled, tile0, ray_min, normal_offset, acc,
      part, done, bounds);
  return static_cast<int>(cudaGetLastError());
}

// Launches K2b on `stream` over tiles [tile0, tile0 + tiles), as K2a.
// `boxes` (ceil(T/8), 32) float32 are the normal records
// (accel.normal_boxes), 16-byte aligned; `wl` (tiles, L, wl_cols) and `cnt`
// (tiles, L) the per-light shadow worklists (read only when `shadows`),
// L <= 32; `acc` is K2a's; `out` is (H, W, 3) float32, or with `feed`
// (tiles * 1024, 3) in feed order.  Returns cudaGetLastError() after the
// launch.
int raytpu_mega2_shade(const float* scene, int S, int P, int T, int L, const float* boxes,
                       const int* wl, const int* cnt, int wl_cols, int W, int H, int tiled,
                       int tile0, int tiles, int feed, int mode, int shadows, float ray_min,
                       float normal_offset, float shadow_dim, const float* acc, float* out,
                       void* stream) {
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln + L * kLight);
  mega2_shade_kernel<<<tiles * (kTile / kShadeBlock), kShadeBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, L, boxes, wl, cnt, wl_cols, W, H, tiled, tile0, feed, mode, shadows,
      ray_min, normal_offset, shadow_dim, acc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
