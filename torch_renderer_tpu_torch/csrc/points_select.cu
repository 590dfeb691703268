// Point-splat selection kernel for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// points_select keeps, for every pixel of each active tile, the K candidate
// points of lowest camera z whose splat covers the pixel, as winner slots
// (-1 = dead), ascending in z. A candidate in slot s covers pixel p when
//   s < count,  z > znear  and  dx * dx + dy * dy <= r2
// with dx = px - x, dy = py - y and (px, py) = offs[p] + origin: the local
// offsets the plain version and the differentiable epilogue add
// (binning.tile_pixel_coords). Every step is written with the _rn
// intrinsics in the plain version's order (rasterize/cuda_points.py
// _priority), so nvcc contracts nothing into an FMA and a pixel on a
// splat's boundary is decided bit for bit as the epilogue's recomputed d2
// says. Ties keep the earlier slot: slots are visited in ascending order
// and a candidate enters the sorted list only strictly below an entry,
// which equals the JAX kernel's K argmin passes (first lane of the minimum).
//
// Inputs:  slab   (B, A, P, C) f32 per slot: x, y, z, then r2 in channel
//                                  r2_channel when r2_channel >= 0 (else
//                                  the uniform r2 applies); further
//                                  channels are not read
//          count  (B, A)       i32 live slots per tile (slots >= count are
//                                  never read)
//          origin (B, A, 2)    f32 raster coords of the tile's pixel 0
//          offs   (tp, 2)      f32 pixel offsets within a tile
// Output:  lane   (B, A, K, tp) i32 winner slots, -1 = dead

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // pixels per block
constexpr int kChunk = 256;     // candidates staged per shared-memory pass
constexpr int kMaxK = 64;
constexpr int kMaxPixels = 1024;
constexpr float kInf = 3.0e38f;

// Replaces torch_renderer_tpu/rasterize/pallas_points.py
// _points_select_kernel (reached through points_select_pallas).
// Bound: operations and latency. A tile reads 16 bytes per live candidate
// for tp * count (pixel, candidate) pairs of ~6 operations each (plus an
// insertion for the few that cover), so device memory is far from the
// limit. Design: one block per (view, active tile, group of 256 pixels),
// one thread per pixel; the tile's candidates are staged through shared
// memory in chunks as (x, y, z, r2) with r2 = -1 for a point at or behind
// znear, so it never covers; each thread keeps its K best (z, slot) pairs
// in registers by insertion (KMAX templated, statically indexed). The TPU
// kernel's 128-lane padding, packed origin and trip-count rows and K
// argmin passes over a VMEM priority slab are TPU layout and are not
// carried.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
points_select_kernel(const float* __restrict__ slab,
                     const int* __restrict__ count,
                     const float* __restrict__ origin,
                     const float* __restrict__ offs, int* __restrict__ lane,
                     int A, int P, int C, int K, int tp, float r2u,
                     int r2c, float znear) {
  __shared__ float4 cand[kChunk];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], P));
  const int p = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = p < tp;
  const int q = active ? p : 0;
  const float px = __fadd_rn(offs[2 * q], origin[2 * cell]);
  const float py = __fadd_rn(offs[2 * q + 1], origin[2 * cell + 1]);
  const float* st = slab + cell * P * C;

  float zs[KMAX];
  int ls[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    zs[j] = kInf;
    ls[j] = -1;
  }
  float kth = kInf;   // the K-th entry's z: the bar a candidate must beat
  for (int c0 = 0; c0 < n; c0 += kChunk) {   // n is uniform in the block
    const int m = min(kChunk, n - c0);
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float* c = st + (long)(c0 + i) * C;
      const float z = c[2];
      const float r2 = r2c >= 0 ? c[r2c] : r2u;
      cand[i] = make_float4(c[0], c[1], z, z > znear ? r2 : -1.0f);
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < m; ++i) {
      const float4 c = cand[i];
      const float dx = __fsub_rn(px, c.x);
      const float dy = __fsub_rn(py, c.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      float cz = c.z;
      if (!(d2 <= c.w) || !(cz < kth)) continue;
      int cl = c0 + i;
      bool moved = false;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K && (moved || cz < zs[j])) {
          const float tz = zs[j];
          const int tl = ls[j];
          zs[j] = cz;
          ls[j] = cl;
          cz = tz;
          cl = tl;
          moved = true;
        }
        if (j == K - 1) kth = zs[j];
      }
    }
  }
  if (!active) return;
  int* o = lane + cell * K * tp + p;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < K) o[(long)j * tp] = ls[j];
  }
}

template <int KMAX>
void launch(dim3 grid, int threads, cudaStream_t stream, const float* slab,
            const int* count, const float* origin, const float* offs,
            int* lane, int A, int P, int C, int K, int tp, float r2u, int r2c,
            float znear) {
  points_select_kernel<KMAX><<<grid, threads, 0, stream>>>(
      slab, count, origin, offs, lane, A, P, C, K, tp, r2u, r2c, znear);
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and a later synchronize would not report it.
int trt_points_select(const float* slab, const int* count,
                      const float* origin, const float* offs, int* lane,
                      int B, int A, int P, int C, int K, int tp, float r2u,
                      int r2c, float znear, int device, void* stream) {
  if (B <= 0 || B > 65535 || A <= 0 || P <= 0 || C < 3 || r2c >= C ||
      K <= 0 || K > kMaxK || tp <= 0 || tp > kMaxPixels) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const int threads = tp < kThreads ? tp : kThreads;
  const dim3 grid(A, B, (tp + threads - 1) / threads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (K == 1) {
    launch<1>(grid, threads, s, slab, count, origin, offs, lane, A, P, C, K,
              tp, r2u, r2c, znear);
  } else if (K <= 4) {
    launch<4>(grid, threads, s, slab, count, origin, offs, lane, A, P, C, K,
              tp, r2u, r2c, znear);
  } else if (K <= 8) {
    launch<8>(grid, threads, s, slab, count, origin, offs, lane, A, P, C, K,
              tp, r2u, r2c, znear);
  } else if (K <= 16) {
    launch<16>(grid, threads, s, slab, count, origin, offs, lane, A, P, C, K,
               tp, r2u, r2c, znear);
  } else if (K <= 32) {
    launch<32>(grid, threads, s, slab, count, origin, offs, lane, A, P, C, K,
               tp, r2u, r2c, znear);
  } else {
    launch<kMaxK>(grid, threads, s, slab, count, origin, offs, lane, A, P, C,
                  K, tp, r2u, r2c, znear);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
