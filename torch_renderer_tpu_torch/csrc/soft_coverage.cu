// Soft-silhouette coverage kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// Per (pixel p, candidate face f) of one tile, with corners already in the
// tile's own pixel frame (corner minus tile origin):
//   signed d2 = +min_e dist2(p, edge_e) outside, -min_e inside
//   S(p)      = sum_f softplus(-signed d2 / sigma)
// and the backward gives dS/d(6 corner coords) per candidate slot. The
// inside test and the clamped foot parameter t are not differentiated;
// edges tied at the minimum share the gradient evenly.
//
// Inputs:  q     (B, A, K, 6) f32  tile-frame corners x0 y0 x1 y1 x2 y2
//          count (B, A)       i32  candidates per active tile (slots >= count
//                                  are never read)
// Outputs: S     (B, A, tile*tile) f32      (forward)
//          dq    (B, A, K, 6) f32           (backward; 0 at slots >= count)
// Pixel p of a tile sits at ((p % tile) * inv_s, (p / tile) * inv_s).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPixels = 1024;   // one forward thread per pixel
constexpr int kChunk = 128;        // candidates staged per shared-memory pass
constexpr int kBwdThreads = 256;   // backward: 8 warps, a slot each at a time
constexpr int kBwdWarps = kBwdThreads / 32;

// Per-face constants, hoisted out of the (pixel, face) loop: the divide
// happens once per face and edge, never per pair.
struct Face {
  float ax[3], ay[3];        // edge e runs from corner e to corner (e+1)%3
  float gx[3], gy[3];        // edge vector
  float len2[3], inv_len2[3];
  float area2;               // signed doubled area: orientation of the face
};

__device__ __forceinline__ void load_face(const float* __restrict__ q6,
                                          Face& f) {
  const float x[3] = {q6[0], q6[2], q6[4]};
  const float y[3] = {q6[1], q6[3], q6[5]};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int b = (e + 1) % 3;
    f.ax[e] = x[e];
    f.ay[e] = y[e];
    f.gx[e] = x[b] - x[e];
    f.gy[e] = y[b] - y[e];
    f.len2[e] = fmaxf(f.gx[e] * f.gx[e] + f.gy[e] * f.gy[e], 1e-12f);
    f.inv_len2[e] = 1.0f / f.len2[e];
  }
  f.area2 = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0]);
}

// Terms of one (pixel, face) pair that the backward reuses.
struct Pair {
  float dd[3], t[3], wx[3], wy[3];
  float d2;
  bool inside;
};

__device__ __forceinline__ float signed_d2(const Face& f, float px, float py,
                                           Pair& r) {
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float wx = px - f.ax[e];
    const float wy = py - f.ay[e];
    const float wg = wx * f.gx[e] + wy * f.gy[e];
    const float t = fminf(fmaxf(wg * f.inv_len2[e], 0.0f), 1.0f);
    const float dd = wx * wx + wy * wy - 2.0f * t * wg + t * t * f.len2[e];
    r.dd[e] = fmaxf(dd, 0.0f);   // clamp each edge before the min
    r.t[e] = t;
    r.wx[e] = wx;
    r.wy[e] = wy;
    // every edge cross product must agree with the face orientation
    inside = inside && ((f.gx[e] * wy - f.gy[e] * wx) * f.area2 >= 0.0f);
  }
  r.d2 = fminf(fminf(r.dd[0], r.dd[1]), r.dd[2]);
  r.inside = inside;
  return inside ? -r.d2 : r.d2;
}

// Replaces torch_renderer_tpu/rasterize/pallas_soft.py _fwd_kernel_packed
// (bench route) and _fwd_kernel (lane route).
// Bound: arithmetic. Each (pixel, face) pair costs ~60 flops plus one exp
// and one log1p, and a tile reads only K*24 bytes of corners for tile^2 * K
// pairs, so device memory is never the limit. Design: one block per active
// tile, one thread per pixel; the tile's candidates stream through shared
// memory in chunks of kChunk with their per-face constants precomputed
// there, so every thread of a warp reads the same face at once (a
// broadcast) and the pair loop touches no device memory. The trip count is
// the tile's own candidate count: empty and thin tiles cost almost nothing.
__global__ void __launch_bounds__(kMaxPixels)
soft_coverage_fwd_kernel(const float* __restrict__ q,
                         const int* __restrict__ count,
                         float* __restrict__ S, int A, int K, int tile,
                         float inv_s, float inv_sigma) {
  __shared__ Face faces[kChunk];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], K));
  const int tp = tile * tile;
  const int p = threadIdx.x;
  const float px = (float)(p % tile) * inv_s;
  const float py = (float)(p / tile) * inv_s;
  const float* qt = q + cell * K * 6;

  float acc = 0.0f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {   // n is uniform in the block
    const int m = min(kChunk, n - c0);
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      load_face(qt + (long)(c0 + i) * 6, faces[i]);
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      Pair r;
      const float x = -signed_d2(faces[i], px, py, r) * inv_sigma;
      // stable softplus: inside pixels reach x ~ 1e3, where exp overflows
      acc += fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    }
  }
  if (p < tp) S[cell * tp + p] = acc;
}

// Adds one (pixel, face) pair's dS/d(corners), contracted with the pixel's
// cotangent gp, to out. dS/d(signed) = sigmoid(x) * (-1/sigma), with
// d(signed)/d(d2) = -1 inside and +1 outside; each edge tied at the
// minimum takes an even share of d(d2). With t held fixed and
// u = w - t g the edge's offset from its foot point, dd = |u|^2 gives
//   d(dd)/d(a) = -2 (1 - t) u,   d(dd)/d(b) = -2 t u
// for its corners a and b. Written without branches: every edge's terms
// are computed and scaled by its share (0 off the minimum), as the lanes
// of a warp seldom agree on the nearest edge.
__device__ __forceinline__ void pair_grad(const Face& f, float px, float py,
                                          float gp, float inv_sigma,
                                          float (&out)[6]) {
  Pair r;
  const float x = -signed_d2(f, px, py, r) * inv_sigma;
  const float sig = 1.0f / (1.0f + expf(-x));
  const float alpha = gp * sig * (-inv_sigma) * (r.inside ? -1.0f : 1.0f);
  const bool m0 = r.dd[0] <= r.d2;
  const bool m1 = r.dd[1] <= r.d2;
  const bool m2 = r.dd[2] <= r.d2;
  const int ties = (int)m0 + (int)m1 + (int)m2;
  const float an =
      alpha * (ties <= 1 ? 1.0f : (ties == 2 ? 0.5f : 1.0f / 3.0f));
  const bool me[3] = {m0, m1, m2};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float k = me[e] ? 2.0f * an : 0.0f;
    const float t = r.t[e];
    const float ux = r.wx[e] - t * f.gx[e];
    const float uy = r.wy[e] - t * f.gy[e];
    const float ca = k * (t - 1.0f);   // corner a = e
    const float cb = -k * t;           // corner b = (e + 1) % 3
    const int a = e, b = (e + 1) % 3;
    out[2 * a] += ca * ux;
    out[2 * a + 1] += ca * uy;
    out[2 * b] += cb * ux;
    out[2 * b + 1] += cb * uy;
  }
}

// Replaces torch_renderer_tpu/rasterize/pallas_soft.py _bwd_kernel_packed
// (bench route) and _bwd_kernel (lane route), both built on _moment_dq, and
// the sublane route's _bwd_kernel_t.
// Bound: arithmetic, like the forward (plus a sigmoid and a divide per
// pair); a tile reads its candidates' 24 bytes and its cotangent row once.
// Design: one block of kBwdThreads (8 warps) per active tile. The tile's
// cotangent row, its pixel coordinates and, chunk by chunk, its candidates'
// per-face constants (load_face) are staged in shared memory. Warps take
// slots (warp w: slots w, w + 8, ...) and lanes take pixels (lane l:
// pixels l, l + 32, ..., so tile^2 / 32 each); each lane keeps the six
// corner partials of its pixels in registers, and a fixed-order
// __shfl_xor_sync butterfly sums them across the warp, whose lane 0 writes
// the slot's row. So the serial chain of a lane is tile^2 / 32 pairs per
// slot it visits, not tile^2 pairs per slot, and a block keeps 8 warps in
// flight however few candidates its tile holds. Each slot still has a
// single writer: no atomics, and the result does not depend on scheduling.
// The per-pixel product form replaces the TPU's moment form, which existed
// to save vector ops on that chip; both give the same gradient. The scatter
// from slots back to faces is not here: it is the gather kernel's backward.
__global__ void __launch_bounds__(kBwdThreads)
soft_coverage_bwd_kernel(const float* __restrict__ q,
                         const int* __restrict__ count,
                         const float* __restrict__ g,
                         float* __restrict__ dq, int A, int K, int tile,
                         float inv_s, float inv_sigma) {
  __shared__ float g_s[kMaxPixels], px_s[kMaxPixels], py_s[kMaxPixels];
  __shared__ Face faces[kChunk];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], K));
  const int tp = tile * tile;
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    g_s[p] = g[cell * tp + p];
    px_s[p] = (float)(p % tile) * inv_s;
    py_s[p] = (float)(p / tile) * inv_s;
  }
  const float* qt = q + cell * K * 6;
  float* dqt = dq + cell * K * 6;
  // slots at or beyond count get zeros
  for (long i = (long)n * 6 + threadIdx.x; i < (long)K * 6; i += blockDim.x) {
    dqt[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < n; c0 += kChunk) {   // n is uniform in the block
    const int m = min(kChunk, n - c0);
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      load_face(qt + (long)(c0 + i) * 6, faces[i]);
    }
    __syncthreads();                          // also publishes g_s, px_s, py_s
    for (int i = warp; i < m; i += kBwdWarps) {
      const Face f = faces[i];
      float out[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int p = lane; p < tp; p += 32) {
        pair_grad(f, px_s[p], py_s[p], g_s[p], inv_sigma, out);
      }
      // fixed-order butterfly: every lane ends with the same sums
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          out[c] += __shfl_xor_sync(0xffffffffu, out[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 6; ++c) dqt[(long)(c0 + i) * 6 + c] = out[c];
      }
    }
  }
}

int check_shape(int B, int A, int K, int tile) {
  const int tp = tile * tile;
  if (B <= 0 || B > 65535 || A <= 0 || K <= 0 || tile <= 0 ||
      tp > kMaxPixels) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.

int trt_soft_coverage_fwd(const float* q, const int* count, float* S, int B,
                          int A, int K, int tile, float inv_s,
                          float inv_sigma, int device, void* stream) {
  int err = check_shape(B, A, K, tile);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  soft_coverage_fwd_kernel<<<dim3(A, B), tile * tile, 0,
                             (cudaStream_t)stream>>>(q, count, S, A, K, tile,
                                                     inv_s, inv_sigma);
  return (int)cudaGetLastError();
}

int trt_soft_coverage_bwd(const float* q, const int* count, const float* g,
                          float* dq, int B, int A, int K, int tile,
                          float inv_s, float inv_sigma, int device,
                          void* stream) {
  int err = check_shape(B, A, K, tile);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  soft_coverage_bwd_kernel<<<dim3(A, B), kBwdThreads, 0,
                             (cudaStream_t)stream>>>(q, count, g, dq, A, K,
                                                     tile, inv_s, inv_sigma);
  return (int)cudaGetLastError();
}

const char* trt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
