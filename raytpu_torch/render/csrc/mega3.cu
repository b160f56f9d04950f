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
// What differs from K2 is how triangles reach the threads.  K2 reads each
// group from device memory, every thread of the block the same address at
// the same time, which the cache serves as a broadcast.  K11a's block walks
// its worklist in stages of kStage groups: the stage's records (640 B a
// group, 8 triangles x 20 floats) are copied into a ring of kRing stage
// slots in shared memory with cp.async, 16 B a thread, while the block
// folds the stage kRing - 1 entries behind, and every thread reads the
// records from shared memory as a broadcast.  This is raytpu's DMA ring
// (_mega3_stream) without its TPU layout: one worklist form (each tile's
// passing groups in ascending order, the port's cull glue), no
// fine/coarse/coarse2 modes, no SMEM entry budget.  The fold order is K2's
// (ascending worklists, strict <, common.cuh's arithmetic), so K11a's
// buffer equals K2a's bit for bit.
//
// K11b answers each light's shadow query with shadow.cuh's walk, a warp at
// a time: each ray tests the boxes of its row's groups, padded and widened
// for the ray (after a test of the warp's bundle of rays), and runs the
// triangles of a group only where its segment crosses the box, and a warp
// leaves the row once all its rays are resolved.  Warps then walk different entries, so a block-wide
// ring no longer serves them: the records come from device memory through
// the caches, and blocks are 128 threads, eight to a tile.  The any-hit
// answer does not depend on which listed triangles are tested, so K11b's
// image equals K2b's bit for bit as long as the box test is conservative
// (shadow.cuh says why it is).
//
// Waiting on the ring: each thread commits one cp.async group per stage
// (empty for threads that copy nothing) and waits until at most kRing - 2
// are pending, so its copies of the stage it folds next have landed; the
// barrier after the wait makes every thread's copies visible and proves
// that every warp has finished the stage whose slot the next copy reuses.
// The ring is drained (wait 0, barrier) before it is walked again.
//
// What bounds it.  As K2: FP32 arithmetic, ~50 operations for each
// ray-triangle test that the worklists pass (chip_smoke.py counts them from
// this frame's worklists, the same count as K2's) and ~100 of shading per
// light; the bytes (scene, acc, image, worklists) are small beside it.
// What the ring does about it (K11a): it takes the triangle records off the
// L1/L2 path and out of the threads' load latency, at the cost of a
// block-wide barrier per kStage groups.  What the box walk does about it
// (K11b): it skips the triangle tests of the groups that no ray of a warp
// can reach, most of a bunny300k row.  Measured by chip_smoke.py beside
// K2's times on the same frames (PERF.md).

#include "shadow.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;
constexpr int kShadeBlock = 128;  // K11b's threads a block: 4 warps
constexpr int kGroup = 8;
constexpr int kAccRows = 11;  // t, normal(3), material(7)
constexpr int kGroupFloats = kGroup * kTri;     // 160 floats, 640 B
constexpr int kGroupCopies = kGroupFloats / 4;  // 16-byte copies a group
constexpr int kStage = 8;                       // worklist entries a stage
constexpr int kRing = 4;                        // stage slots in the ring
constexpr int kStageFloats = kStage * kGroupFloats;
constexpr int kRingFloats = kRing * kStageFloats;  // 20 KB

// Starts the copies of stage s (entries [s*kStage, s*kStage + kStage) of the
// worklist `w` of `c` entries) into ring slot s % kRing.  Entries that are
// not a group of the blob's `ng` are not copied (and not folded).
__device__ __forceinline__ void issue_stage(float* ring, const float* __restrict__ blob,
                                            const int* __restrict__ w, int c, int ng, int s) {
  float* dst = ring + (s % kRing) * kStageFloats;
  for (int q = threadIdx.x; q < kStage * kGroupCopies; q += blockDim.x) {
    const int j = q / kGroupCopies, part = q % kGroupCopies;
    const int e = s * kStage + j;
    if (e >= c) continue;
    const int g = w[e];
    if (g < 0 || g >= ng) continue;
    cp_async16(dst + j * kGroupFloats + part * 4, blob + (size_t)g * kGroupFloats + part * 4);
  }
}

// K11a's walk of the worklist `w` (`c` entries) of the blob's groups through
// the ring: fold(record, k) for every triangle k of every listed group, in
// worklist order, each record read from shared memory.  All threads of the
// block call it; the walk ends early once live() is false for every thread.
template <typename Live, typename Fold>
__device__ __forceinline__ void walk(float* ring, const float* __restrict__ blob,
                                     const int* __restrict__ w, int c, int T, Live live,
                                     Fold fold) {
  const int ng = (T + kGroup - 1) / kGroup;
  const int stages = (c + kStage - 1) / kStage;
  for (int s = 0; s < kRing - 1; ++s) {  // prologue: kRing - 1 stages in flight
    if (s < stages) issue_stage(ring, blob, w, c, ng, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s have landed
    // every thread's have, and every warp is done with stage s - 1's slot
    if (!__syncthreads_or(live())) break;
    if (s + kRing - 1 < stages) issue_stage(ring, blob, w, c, ng, s + kRing - 1);
    cp_async_commit();
    const float* slot = ring + (s % kRing) * kStageFloats;
    const int entries = min(c - s * kStage, kStage);
    for (int j = 0; j < entries; ++j) {
      const int g = w[s * kStage + j];
      if (g < 0 || g >= ng) continue;  // not a group of this scene
      const int n = min(kGroup, T - g * kGroup);
      for (int m = 0; m < n; ++m) fold(slot + j * kGroupFloats + m * kTri, g * kGroup + m);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next walk
}

__global__ void __launch_bounds__(kTile) mega3_closest_kernel(
    const float* __restrict__ scene, int S, int P, int T, const float* __restrict__ blob,
    const int* __restrict__ wl, const int* __restrict__ cnt, int wl_cols, int W, int H,
    int tiled, int tile0, float tmin, float normal_offset, float* __restrict__ acc,
    float* __restrict__ bounds) {
  extern __shared__ float4 smem4[];  // ring | cam | spheres | planes
  float* ring = reinterpret_cast<float*>(smem4);
  float* sm = ring + kRingFloats;
  __shared__ float part[6][32];
  const int n = kCam + S * kSph + P * kPln;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = scene[k];
  __syncthreads();
  const float* cam = sm;
  const float* sph = cam + kCam;
  const float* pln = sph + S * kSph;
  const int tile = blockIdx.x;
  const int slots = gridDim.x * kTile;

  int pxi = 0, pyi = 0;
  const bool valid = tile_pixel(tile0 + tile, threadIdx.x, W, H, tiled, &pxi, &pyi);
  const float rox = cam[0], roy = cam[1], roz = cam[2];
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  float t = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool is_sph = false;
  const float* mat = nullptr;  // shared memory or the blob, never the ring
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
  walk(ring, blob, wl + (size_t)tile * wl_cols, min(cnt[tile], wl_cols), T,
       [&] { return valid; },
       [&](const float* r, int k) {
         if (!valid) return;
         const float tc = tri_t(r, rox, roy, roz, rdx, rdy, rdz, tmin, INFINITY, false);
         if (tc < t) {
           t = tc;
           nx = r[9];
           ny = r[10];
           nz = r[11];
           is_sph = false;
           mat = blob + (size_t)k * kTri + 13;
         }
       });

  float* a = acc + (size_t)tile * kTile + threadIdx.x;  // row q at a[q * slots]
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (t < INFINITY) {
    if (is_sph) {  // normalized after the selection (reference: source/Scene.cpp:40)
      const float n_len = sqrtf(fmaxf(sqn(nx, ny, nz), 1e-20f));
      nx = nx / n_len;
      ny = ny / n_len;
      nz = nz / n_len;
    }
    // the offset hit point, exactly as K11b's shade_hit forms its shadow origin
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
    for (int q = 1; q < kAccRows; ++q) a[q * slots] = 0.0f;
  }

  // the tile's box: min/max over warps by shuffles, then over the 32 warps
  for (int off = 16; off > 0; off >>= 1) {
    for (int q = 0; q < 3; ++q) box[q] = fminf(box[q], __shfl_xor_sync(0xffffffffu, box[q], off));
    for (int q = 3; q < 6; ++q) box[q] = fmaxf(box[q], __shfl_xor_sync(0xffffffffu, box[q], off));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0)
    for (int q = 0; q < 6; ++q) part[q][warp] = box[q];
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < 6; ++q) box[q] = part[q][lane];
    for (int off = 16; off > 0; off >>= 1) {
      for (int q = 0; q < 3; ++q) box[q] = fminf(box[q], __shfl_xor_sync(0xffffffffu, box[q], off));
      for (int q = 3; q < 6; ++q) box[q] = fmaxf(box[q], __shfl_xor_sync(0xffffffffu, box[q], off));
    }
    if (lane == 0)
      for (int q = 0; q < 6; ++q) bounds[tile * 6 + q] = box[q];
  }
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
// triangles, 16-byte aligned; `wl` (tiles, wl_cols) and `cnt` (tiles,) the
// tiles' group worklists; `acc` 11 x tiles*1024 float32, `bounds` tiles x 6.
// Returns the CUDA error of the launch.
int raytpu_mega3_closest(const float* scene, int S, int P, int T, const float* blob,
                         const int* wl, const int* cnt, int wl_cols, int W, int H, int tiled,
                         int tile0, int tiles, float ray_min, float normal_offset, float* acc,
                         float* bounds, void* stream) {
  const size_t smem = sizeof(float) * (kRingFloats + kCam + S * kSph + P * kPln);
  const cudaError_t err = allow_smem(mega3_closest_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega3_closest_kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, S, P, T, blob, wl, cnt, wl_cols, W, H, tiled, tile0, ray_min, normal_offset, acc,
      bounds);
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
