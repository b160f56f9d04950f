// P1 and P2: the two measurement probes, for Hopper (sm_90a).
//
// P1, probe_smem: replaces probes/probe_smem.py:make_kernel (its
// pl.pallas_call at probe_smem.py:60).  Synthetic rays in 1024-ray tiles,
// one a raytpu (8, 128) tile: ray (lane, sub) of tile b has origin and
// direction both (lane * 0.01 + b, sub * 0.1, 1).  Each ray folds T
// triangles (12 floats: 9 vertex coordinates, an id, 2 pads), in order or
// through a worklist, each step a Moller-Trumbore test with t > 1e-4 that
// keeps a running (min t, id) with a strict <, and writes t + id (1e30 on
// a miss).  It is the bare per-(ray, triangle) loop of K2 and K11, with no
// culling and no shading around it.  Four variants, the product of:
//   - where the triangles come from: shared memory (the block stages tri,
//     and the worklist, once, then loops: K11's way), or device memory read
//     as a warp-uniform broadcast through const __restrict__ (K2's way);
//   - in order, or through the worklist (each step reads wl[j] first).
// The arithmetic is raytpu's op order with every operation rounded on its
// own (-fmad=false, render/build.py) and IEEE division, so the plain version
// (raytpu_torch/probes/probe_smem.py) computes the same bits.
//
// What bounds P1: FP32 operations, 53 a test (counted from the source
// below: 6 edge subtractions, 9 for p, 5 for det, |det|, the division, 3
// for s, 6 for u, 9 for q, 6 each for w and t, u + w), against a few
// kilobytes of triangles; chip_smoke.py prints the count over 67 TFLOP/s
// and over the card's non-FMA issue rate, since with -fmad=false each add
// and multiply is one instruction, and the fold loop's SASS instructions
// a test (cuobjdump) at that rate.  What the design does about it: each
// thread folds kFoldRays = 4 rays of one row of 128, 128 threads a block,
// so the four share every triangle's read (three float4s), its edges,
// the worklist entry, the loop and the terms of their common ry (nvcc
// merges the identical operations: the same bits), and four division
// chains are in flight at once: 60 SASS instructions a test.  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, T = 1024 over 300
// tiles, staged / broadcast: in order 0.8173 / 0.7166 ms, through the
// worklist 0.8530 / 0.7616 (the first port's layout, a thread a ray in
// 1024-thread blocks: 0.9776 / 1.1308, 1.0936 / 1.2599), the broadcast
// in order 1.27x its SASS bound of 0.5642 ms.  Staged at T = 1024 a block
// takes 48 KB of shared memory, which holds an SM to 4 blocks.
//
// P2, probe_dma_smem: replaces probes/probe_dma_smem.py:kernel (its
// pl.pallas_call at probe_dma_smem.py:74).  A worklist drives copies of
// 8 KB row-blocks (8 rows of 256 floats) of a blob in device memory into a
// 4-slot ring in shared memory; each block walks the first cnt entries of
// its worklist row (raytpu's four grid steps share one row and one cnt),
// folds slot[0][0] + slot[7][255] of each landed block into a float32 sum in
// worklist order, and writes its (8, 128) output block filled with the sum.
// cnt is read on the device.  The ring is K11's (mega3.cu): cp.async, 16 B a
// thread, not TMA; kRing - 1 entries in flight while the block folds the
// oldest; each thread commits one group per entry, empty or not, so
// cp.async.wait_group counts entries; a slot is refilled only after the
// barrier that follows every warp's read of it.  Entries that
// are not a row-block of the blob are neither copied nor folded.
//
// What bounds P2: bytes, 8 KB a listed entry, read once (chip_smoke.py times
// it on a blob larger than the 50 MB L2, against 3.35 TB/s).  What the design
// does about it: kRing - 1 copies of 8 KB in flight per block, several
// blocks per SM (32 KB of shared memory each), copies that bypass L1.

#include "common.cuh"

namespace {

using namespace raytpu_dev;

constexpr int kTile = 1024;          // rays a tile: one raytpu (8, 128) tile
constexpr int kTriFloats = 12;       // v0, v1, v2, id, 2 pads: three float4s
constexpr int kFoldRays = 4;         // rays a thread
constexpr int kFoldBlock = 128;      // threads a block
constexpr int kRowThreads = 128 / kFoldRays;  // threads a row of 128 rays
constexpr int kRows = 8, kCols = 256;
constexpr int kBlockFloats = kRows * kCols;  // one row-block, 8 KB
constexpr int kBlockCopies = kBlockFloats / 4;
constexpr int kRing = 4;
constexpr int kRingThreads = 256;

// Thread g of the grid takes kFoldRays rays of one row (sub) of tile g /
// (kTile / kFoldRays): lanes lane0 + m * kRowThreads, so each warp writes
// 32 consecutive outputs per ray and a thread's rays share sub, hence ry.
// Each triangle is read once a thread, as three float4s, for all its rays.
template <bool kStaged, bool kWorklist>
__global__ void __launch_bounds__(kFoldBlock, 8) smem_fold_kernel(
    const float* __restrict__ tri, const int* __restrict__ wl, int T, int tiles,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const float4* tris = reinterpret_cast<const float4*>(tri);
  const int* order = wl;
  if (kStaged) {
    float4* s4 = reinterpret_cast<float4*>(smem);
    for (int q = threadIdx.x; q < T * (kTriFloats / 4); q += blockDim.x) s4[q] = tris[q];
    int* swl = reinterpret_cast<int*>(smem + T * kTriFloats);
    if (kWorklist)
      for (int q = threadIdx.x; q < T; q += blockDim.x) swl[q] = wl[q];
    __syncthreads();
    tris = s4;
    order = swl;
  }
  const int g = blockIdx.x * kFoldBlock + threadIdx.x;
  if (g >= tiles * (kTile / kFoldRays)) return;
  const int tile = g / (kTile / kFoldRays);
  const int sub = (g % (kTile / kFoldRays)) / kRowThreads;
  const int lane0 = g % kRowThreads;
  const float ry = static_cast<float>(sub) * 0.1f;
  const float rz = 1.0f;
  float rx[kFoldRays], t_best[kFoldRays], idx_best[kFoldRays];
#pragma unroll
  for (int m = 0; m < kFoldRays; ++m) {
    rx[m] = static_cast<float>(lane0 + m * kRowThreads) * 0.01f + static_cast<float>(tile);
    t_best[m] = 1e30f;
    idx_best[m] = 0.0f;
  }
  for (int j = 0; j < T; ++j) {
    const int jj = kWorklist ? order[j] : j;
    if (kWorklist && (jj < 0 || jj >= T)) continue;  // not a triangle of tri
    const float4 a = tris[3 * jj], b = tris[3 * jj + 1], c = tris[3 * jj + 2];
    const float ex = a.w - a.x, ey = b.x - a.y, ez = b.y - a.z;  // v1 - v0
    const float fx = b.z - a.x, fy = b.w - a.y, fz = c.x - a.z;  // v2 - v0
#pragma unroll
    for (int m = 0; m < kFoldRays; ++m) {
      const float px = ry * fz - rz * fy;
      const float py = rz * fx - rx[m] * fz;
      const float pz = rx[m] * fy - ry * fx;
      const float det = ex * px + ey * py + ez * pz;
      const float inv = 1.0f / (fabsf(det) < 1e-8f ? 1.0f : det);
      const float sx = rx[m] - a.x, sy = ry - a.y, sz = rz - a.z;
      const float u = (sx * px + sy * py + sz * pz) * inv;
      const float qx = sy * ez - sz * ey;
      const float qy = sz * ex - sx * ez;
      const float qz = sx * ey - sy * ex;
      const float w = (rx[m] * qx + ry * qy + rz * qz) * inv;
      const float t = (fx * qx + fy * qy + fz * qz) * inv;
      if (u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > 1e-4f && t < t_best[m]) {
        t_best[m] = t;
        idx_best[m] = c.y;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kFoldRays; ++m)
    out[(size_t)tile * kTile + sub * 128 + lane0 + m * kRowThreads] = t_best[m] + idx_best[m];
}

// Starts the copies of worklist entry j into ring slot j % kRing.
__device__ __forceinline__ void issue_entry(float (*ring)[kBlockFloats],
                                            const float* __restrict__ blob, int ng,
                                            const int* __restrict__ w, int j) {
  const int g = w[j];
  if (g < 0 || g >= ng) return;
  float* dst = ring[j % kRing];
  const float* src = blob + (size_t)g * kBlockFloats;
  for (int q = threadIdx.x; q < kBlockCopies; q += blockDim.x)
    cp_async16(dst + 4 * q, src + 4 * q);
}

__global__ void __launch_bounds__(kRingThreads) dma_ring_kernel(
    const float* __restrict__ blob, int ng, const int* __restrict__ wl, int wl_stride,
    int wl_cols, const int* __restrict__ cnt, int cnt_stride, float* __restrict__ out) {
  __shared__ __align__(16) float ring[kRing][kBlockFloats];  // 32 KB
  const int b = blockIdx.x;
  const int* w = wl + (size_t)b * wl_stride;
  const int c = min(max(cnt[(size_t)b * cnt_stride], 0), wl_cols);
  for (int j = 0; j < kRing - 1; ++j) {  // prologue: kRing - 1 entries in flight
    if (j < c) issue_entry(ring, blob, ng, w, j);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int j = 0; j < c; ++j) {
    cp_async_wait<kRing - 2>();  // this thread's copies of entry j have landed
    // every thread's have, and every warp has read entry j - 1's slot
    __syncthreads();
    if (j + kRing - 1 < c) issue_entry(ring, blob, ng, w, j + kRing - 1);
    cp_async_commit();
    const int g = w[j];
    if (g >= 0 && g < ng) {
      const float* slot = ring[j % kRing];
      acc = acc + slot[0];
      acc = acc + slot[kBlockFloats - 1];
    }
  }
  cp_async_wait<0>();
  for (int q = threadIdx.x; q < kTile; q += blockDim.x) out[(size_t)b * kTile + q] = acc;
}

template <bool kStaged, bool kWorklist>
int launch_fold(const float* tri, const int* wl, int T, int tiles, float* out,
                cudaStream_t stream) {
  size_t smem = 0;
  if (kStaged) {
    smem = sizeof(float) * T * kTriFloats + (kWorklist ? sizeof(int) * T : 0);
    // dynamic shared memory above the default 48 KB needs the kernel's opt-in
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          smem_fold_kernel<kStaged, kWorklist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int blocks = (tiles * (kTile / kFoldRays) + kFoldBlock - 1) / kFoldBlock;
  smem_fold_kernel<kStaged, kWorklist><<<blocks, kFoldBlock, smem, stream>>>(tri, wl, T, tiles,
                                                                             out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches P1 on `stream`: `tiles` tiles of 1024 rays over `T` triangles
// `tri` (T, 12) float32, 16-byte aligned, through `wl` (T,) int32 when `worklist`, the
// triangles staged in shared memory when `staged`; `out` (8 * tiles, 128)
// float32.  Returns the CUDA error of the launch.
int raytpu_probe_smem_fold(const float* tri, const int* wl, int T, int tiles, int worklist,
                           int staged, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged)
    return worklist ? launch_fold<true, true>(tri, wl, T, tiles, out, s)
                    : launch_fold<true, false>(tri, wl, T, tiles, out, s);
  return worklist ? launch_fold<false, true>(tri, wl, T, tiles, out, s)
                  : launch_fold<false, false>(tri, wl, T, tiles, out, s);
}

// Launches P2 on `stream`: `blocks` blocks; block b walks the first
// cnt[b * cnt_stride] (at most wl_cols) entries of the worklist row
// wl + b * wl_stride over the blob's `ng` row-blocks (`blob` (ng * 8, 256)
// float32, 16-byte aligned); `out` (8 * blocks, 128) float32.  Returns the
// CUDA error of the launch.
int raytpu_probe_dma_ring(const float* blob, int ng, const int* wl, int wl_stride, int wl_cols,
                          const int* cnt, int cnt_stride, int blocks, float* out, void* stream) {
  dma_ring_kernel<<<blocks, kRingThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blob, ng, wl, wl_stride, wl_cols, cnt, cnt_stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
