// K1: the whole-frame megakernel for Hopper (sm_90a).
//
// Replaces raytpu/render/pallas_kernel.py:_mega_kernel.  One launch renders
// the frame: raygen -> closest hit over S spheres, P planes and T triangles
// with running normal/material selects -> one any-hit shadow ray per light
// (triangle culling inverted) -> shading (4 lighting modes x 4 material
// kinds) -> 0.95 dim per occluded light -> MaxToOne.  It writes (H, W, 3)
// float32, row-major, into a tensor the wrapper allocated; it allocates
// nothing itself.  Given a tile range (the per-rank body of the px-sharded
// render, pallas_kernel.py:render_image_mega_f32's tile0/tiles), it renders
// rays [1024 tile0, 1024 (tile0 + tiles)) of the row-major frame into
// (tiles * 1024, 3), black past the frame's last ray.
//
// What bounds it.  It reads a scene of at most ~6 KB and writes 12 B per
// ray (3.7 MB for 640x480): on an H100 at 3.35 TB/s that is about 1 us.
// Its arithmetic is ~30 FP32 operations per primitive test, run once for
// the primary ray and once per light for shadows, plus ~100 of shading per
// light.  chip_smoke.py counts it from the frame's data: 4.3e8 FP32
// operations for the 640x480 reference frame, 1,400 a ray, 0.0064 ms at
// 67 TFLOP/s and 0.0128 ms at the card's issue rate, at which -fmad=false
// puts every add and multiply.  Issue is the ceiling it meets: with the
// IEEE division and square root, the loads and the selects a test is 42
// (plane), 46-49 (sphere) or 95 (triangle) SASS instructions (cuobjdump,
// chip_smoke.py phase 4), ~2,800 a ray for the tests alone were each to run
// whole.  Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W:
// 0.0379 ms a frame (the first port's layout 0.0457), 3.0x the issue bound.
//
// What the design does about it.  It issues fewer instructions: each test
// returns a miss as soon as the cull, the determinant, u or the line's
// distance from a sphere decides one (common.cuh's kEarly), which a warp
// whose lanes all miss skips by (1.18x on reference, 1.43x on w4_test,
// shadow_ablation.py on that card).  One thread per ray, 128 threads a
// block at 8 blocks an SM; the whole frame in 32x32 pixel tiles, each warp
// on an 8x4 pixel block (shadow.cuh:warp_slot), ragged frames and tile
// ranges on row-major rays (slot_ray).  Each block copies the packed scene
// into shared memory once; every thread then reads the same address, which
// is a broadcast.  Loops over primitives run at run time (nvcc unrolls
// them), so any count up to the wrapper's caps (72 primitives, 8 lights)
// takes the same binary.  A miss skips the lights entirely, a shadow ray
// stops at its first occluder, and each light's shadow query runs right
// before that light's shading: every query first into a mask, K2b's order,
// was 1.035x slower on reference, since the shading then recomputes each
// light's direction.  None of these changes a bit of the image.

// Arithmetic: the primitive tests, raygen and shading live in common.cuh,
// shared with K2a/K2b and K3/K4; its header says how they round and what the
// build flags (-fmad=false, no fast math) cost.  K1 agrees with its plain
// version (cuda_kernel.py:render_image_mega_f32_plain) up to powf's last bit.

#include "shadow.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;  // rays a tile: a 32x32 pixel block, or 1024 row-major rays
constexpr int kBlock = 128;  // threads a block: 4 warps

// Any primitive in [lo, hi) ([lo, hi] for spheres) along the shadow ray.
__device__ bool occluded(const float* sph, int S, const float* pln, int P, const float* tri, int T,
                         float ox, float oy, float oz, float dx, float dy, float dz,
                         float lo, float hi) {
  for (int s = 0; s < S; ++s)
    if (sphere_t<true>(sph + s * kSph, ox, oy, oz, dx, dy, dz, lo, hi) < INFINITY) return true;
  for (int p = 0; p < P; ++p)
    if (plane_t(pln + p * kPln, ox, oy, oz, dx, dy, dz, lo, hi) < INFINITY) return true;
  for (int k = 0; k < T; ++k)
    if (tri_t<true>(tri + k * kTri, ox, oy, oz, dx, dy, dz, lo, hi, true) < INFINITY) return true;
  return false;
}

// The ray of grid slot `slot` (blockIdx.x * kBlock + threadIdx.x) and the
// row of `out` it writes.  `tiled` (the whole frame, W and H multiples of
// 32): warp w of the grid takes the 8x4 pixel block warp_slot(w % 32, lane)
// of 32x32 tile w / 32, and writes its pixel's row of the (H, W, 3) image.
// Else slot j is ray 1024 tile0 + j of the row-major frame, written at row
// j; false for a ray past the frame (a padded tile of the tile range).
__device__ __forceinline__ bool slot_ray(int slot, int W, int H, int tiled, int tile0, int* pxi,
                                         int* pyi, size_t* row) {
  if (tiled) {
    const int warp = slot / 32;
    tile_pixel(warp / 32, warp_slot(warp % 32, slot % 32), W, H, 1, pxi, pyi);
    *row = (size_t)*pyi * W + *pxi;
    return true;
  }
  *row = slot;
  return tile_pixel(tile0 + slot / kTile, slot % kTile, W, H, 0, pxi, pyi);
}

// One ray, whole: raygen, the closest hit, then shade_hit's loop over the
// lights, each light's shadow query right before its shading.  The tests
// return a miss as soon as it is decided (common.cuh's kEarly).  `sm`
// holds the scene buffer (plain.py's layout).
__device__ __forceinline__ void render_ray(
    const float* sm, int S, int P, int T, int L, int W, int H, int mode, int shadows,
    float tmin, float normal_offset, float shadow_dim, int tiled, int tile0, int slot,
    float* __restrict__ out) {
  int pxi = 0, pyi = 0;
  size_t row = 0;
  const bool valid = slot_ray(slot, W, H, tiled, tile0, &pxi, &pyi, &row);
  float* o = out + 3 * row;
  if (!valid) {  // a padded ray past the frame
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  const float* cam = sm;
  const float* sph = cam + kCam;
  const float* pln = sph + S * kSph;
  const float* tri = pln + P * kPln;
  const float* lit = tri + T * kTri;

  const float rox = cam[0], roy = cam[1], roz = cam[2];
  float rdx, rdy, rdz;
  raygen(cam, pxi, pyi, W, H, &rdx, &rdy, &rdz);

  // closest hit; strict < keeps the first primitive on ties
  float t = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool is_sph = false;
  const float* mat = nullptr;
  for (int s = 0; s < S; ++s) {
    const float* r = sph + s * kSph;
    const float tc = sphere_t<true>(r, rox, roy, roz, rdx, rdy, rdz, tmin, INFINITY);
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
  for (int k = 0; k < T; ++k) {
    const float* r = tri + k * kTri;
    const float tc = tri_t<true>(r, rox, roy, roz, rdx, rdy, rdz, tmin, INFINITY, false);
    if (tc < t) {
      t = tc;
      nx = r[9];
      ny = r[10];
      nz = r[11];
      is_sph = false;
      mat = r + 13;
    }
  }
  if (!(t < INFINITY)) {  // miss: black, whatever the lights
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }

  if (is_sph) {  // normalized after the selection (reference: source/Scene.cpp:40)
    const float n_len = sqrtf(fmaxf(sqn(nx, ny, nz), 1e-20f));
    nx = nx / n_len;
    ny = ny / n_len;
    nz = nz / n_len;
  }
  shade_hit(lit, L, mode, shadows != 0, normal_offset, shadow_dim, rox, roy, roz, rdx, rdy, rdz,
            t, nx, ny, nz, mat,
            [&](int, float ox, float oy, float oz, float lx, float ly, float lz, float mag) {
              return occluded(sph, S, pln, P, tri, T, ox, oy, oz, lx, ly, lz, tmin, mag);
            },
            o);
}

__global__ void __launch_bounds__(kBlock, 8) mega_kernel(
    const float* __restrict__ scene, int S, int P, int T, int L, int W, int H, int mode,
    int shadows, float tmin, float normal_offset, float shadow_dim, int tiled, int tile0,
    int n_out, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int n = kCam + S * kSph + P * kPln + T * kTri + L * kLight;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = scene[i];
  __syncthreads();
  const int slot = blockIdx.x * kBlock + threadIdx.x;
  if (slot < n_out)
    render_ray(sm, S, P, T, L, W, H, mode, shadows, tmin, normal_offset, shadow_dim, tiled, tile0,
               slot, out);
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over `n_out` rays from ray 1024 * tile0 of the
// frame (the whole frame: tile0 0, n_out W * H).  Returns
// cudaGetLastError() after the launch.
int raytpu_mega_render(const float* scene, int S, int P, int T, int L, int W, int H, int mode,
                       int shadows, float ray_min, float normal_offset, float shadow_dim,
                       int tile0, int n_out, float* out, void* stream) {
  // the whole frame in 32x32 pixel tiles writes the same rows as row-major rays
  const int tiled = tile0 == 0 && (long long)n_out == (long long)W * H && W % 32 == 0 &&
                    H % 32 == 0;
  const int blocks = (n_out + kBlock - 1) / kBlock;
  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln + T * kTri + L * kLight);
  mega_kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, L, W, H, mode, shadows, ray_min, normal_offset, shadow_dim, tiled, tile0,
      n_out, out);
  return static_cast<int>(cudaGetLastError());
}

const char* raytpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
