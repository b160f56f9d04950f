// K11a and K11b: the streamed whole-frame passes for Hopper (sm_90a).
//
// Replace raytpu/render/pallas_kernel.py:_make_mega3_closest_kernel (K11a)
// and _make_mega3_shadow_kernel (K11b), the two launches of
// render_image_mega3_f32, for scenes of up to 1,048,576 triangles.  They
// compute what K2a and K2b (mega2.cu) compute, from the same worklists of
// 8-triangle groups:
//
//   K11a: camera rays generated in the kernel -> closest hit over every
//         sphere and plane and the groups of the tile's worklist -> per ray
//         t, unit normal and material(7) into `acc` (11 rows of
//         tiles*1024 floats), and per tile the box of the offset hit points
//         into `bounds` (tiles, 6);
//   K11b: from `acc`, per light a shadow ray against every sphere and plane
//         and the groups of that light's worklist -> 4 lighting modes x 4
//         material kinds -> 0.95 dim per occluded light -> MaxToOne ->
//         (H, W, 3) float32, or a tile range's rays in feed order.
//
// K11a and K2a are one body, closest.cuh's closest_pass, which reads the
// triangles from the blob here and from the scene buffer there.  K11b
// walks as K2b does, with kappa's 8-float records where K2b reads the
// normal records.  K11a and K11b walk the worklists with shadow.cuh's
// group walk, a warp at a time: each ray tests the boxes of its row's
// groups, padded and widened for the ray (after a test of the warp's
// bundle of rays), and runs the triangles of a group only where its
// segment crosses the box.
// K11a's segment is the ray up to its current closest hit (the closest
// walk: it shrinks as hits are found and never ends a row early); K11b's
// is each light's shadow segment, and a warp leaves the row once all its
// rays are resolved.  Warps then walk different entries, so a block-wide
// shared-memory ring (raytpu's DMA ring, which K11a used to fold through)
// no longer feeds them: the records come from device memory through the
// caches, and blocks are 128 threads, eight to a tile.  The any-hit
// answer does not depend on which listed triangles are tested, so K11b's
// image equals K2b's bit for bit as long as the box tests are conservative
// (shadow.cuh says why they are); K11a's buffer and boxes are K2a's, the
// same function of the same records.
//
// What bounds it.  As K2: FP32 arithmetic, ~50 operations for each
// ray-triangle test and ~100 of shading per light; the bytes (scene, acc,
// image, worklists, records) are small beside it.  The walk skips the
// triangle tests of the groups that a ray's segment does not reach, most
// of a bunny300k row: chip_smoke.py counts both the tests of every listed
// triangle and the box-culled ones.  Measured by chip_smoke.py beside K2's
// times on the same frames (PERF.md).

#include "closest.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kShadeBlock = 128;  // K11b's threads a block: 4 warps
constexpr int kBlocksPerTile = kTile / kShadeBlock;

// K11a: closest.cuh's closest pass, the triangles read from the blob as
// 20-float records.
__global__ void __launch_bounds__(kClosestBlock, 4) mega3_closest_kernel(
    const float* __restrict__ scene, int S, int P, int T, const float* __restrict__ blob,
    const float* __restrict__ boxes, const int* __restrict__ wl, const int* __restrict__ cnt,
    int wl_cols, int W, int H, int tiled, int tile0, float tmin, float normal_offset,
    float* __restrict__ acc, float* __restrict__ part, unsigned* __restrict__ done,
    float* __restrict__ bounds) {
  closest_pass(scene, S, P, T, blob, boxes, wl, cnt, wl_cols, W, H, tiled, tile0, tmin,
               normal_offset, acc, part, done, bounds);
}

// K11b: one thread per ray slot, blocks of kShadeBlock threads, kTile /
// kShadeBlock blocks to a tile; warp w of the tile takes the 8x4 pixel
// block warp_slot(w, lane) (K11a wrote slot j of the tile at acc column
// tile * 1024 + j, so any slot order reads the same rays).  Each light's
// shadow query is shadow.cuh's walk over the (tile, light) worklist with the
// group boxes, the triangles read from the blob as 20-float records.
__global__ void __launch_bounds__(kShadeBlock, 4) mega3_shade_kernel(
    const float* __restrict__ scene, int S, int P, int T, int L, const float* __restrict__ blob,
    const float* __restrict__ boxes, const int* __restrict__ wl, const int* __restrict__ cnt,
    int wl_cols, int W, int H, int tiled, int tile0, int feed, int mode, int shadows, float tmin,
    float normal_offset, float shadow_dim, const float* __restrict__ acc,
    float* __restrict__ out) {
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
      occ = shadow_walk<kTri>(blob, T, boxes, wl + (size_t)row * wl_cols,
                              min(cnt[row], wl_cols), hit && !occ, ox, oy, oz, lx, ly, lz, tmin,
                              mag) || occ;
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

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Launches K11a on `stream` over the frame's tiles [tile0, tile0 + tiles).
// `scene` is the whole-frame kernels' buffer (plain.py), `blob` the
// triangles as (ceil(T/8), 160) float32 groups padded with all-zero
// triangles, `boxes` (ceil(T/8), 32) float32 the normal records
// (accel.normal_boxes), both 16-byte aligned; `wl` (tiles, wl_cols) and
// `cnt` (tiles,) the tiles' group worklists; `acc` 11 x tiles*1024
// float32, `bounds` tiles x 6; `part` (tiles *
// raytpu_closest_blocks_per_tile(), 6) float32 scratch for the blocks'
// partial boxes and `done` (tiles,) uint32 zeros, the blocks' counts
// (nonzero after it).  Returns the CUDA error of the launch.
int raytpu_mega3_closest(const float* scene, int S, int P, int T, const float* blob,
                         const float* boxes, const int* wl, const int* cnt, int wl_cols, int W,
                         int H, int tiled, int tile0, int tiles, float ray_min,
                         float normal_offset, float* acc, float* part, unsigned* done,
                         float* bounds, void* stream) {
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln);
  const cudaError_t err = allow_smem(mega3_closest_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega3_closest_kernel<<<tiles * kClosestBlocksPerTile, kClosestBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, blob, boxes, wl, cnt, wl_cols, W, H, tiled, tile0, ray_min, normal_offset,
      acc, part, done, bounds);
  return static_cast<int>(cudaGetLastError());
}

// Launches K11b on `stream` over tiles [tile0, tile0 + tiles), as K11a.
// `boxes` (ceil(T/8), 8) float32 are the group box records
// (accel.shadow_boxes), 16-byte aligned; `wl` (tiles, L, wl_cols) and `cnt` (tiles, L) the per-light
// shadow worklists (read only when `shadows`), L <= 32; `acc` is K11a's;
// `out` is (H, W, 3) float32, or with `feed` (tiles * 1024, 3) in feed
// order.  Returns the CUDA error of the launch.
int raytpu_mega3_shade(const float* scene, int S, int P, int T, int L, const float* blob,
                       const float* boxes, const int* wl, const int* cnt, int wl_cols, int W,
                       int H, int tiled, int tile0, int tiles, int feed, int mode, int shadows,
                       float ray_min, float normal_offset, float shadow_dim, const float* acc,
                       float* out, void* stream) {
  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln + L * kLight);
  const cudaError_t err = allow_smem(mega3_shade_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega3_shade_kernel<<<tiles * (kTile / kShadeBlock), kShadeBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, L, blob, boxes, wl, cnt, wl_cols, W, H, tiled, tile0, feed, mode, shadows,
      ray_min, normal_offset, shadow_dim, acc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
