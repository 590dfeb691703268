// Bilinear texture-sampling kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// Replaces torch_renderer_tpu/ops/pallas_texsample.py _fwd_kernel (reached
// through _sample_core_fwd) and _bwd_kernel (reached through
// _sample_core_bwd). Per (view b, point p), with the corner (y0, x0) clamped
// to [0, Hm - 2] x [0, Wm - 2] and the four taps c00 = map[y0][x0],
// c01 = map[y0][x0 + 1], c10 = map[y0 + 1][x0], c11 = map[y0 + 1][x0 + 1]:
//   forward   out_c = (c00 (1 - wx) + c01 wx) (1 - wy)
//                   + (c10 (1 - wx) + c11 wx) wy
//   backward  d_wy  = sum_c g_c [(1 - wx)(c10 - c00) + wx (c11 - c01)]
//             d_wx  = sum_c g_c [(1 - wy)(c01 - c00) + wy (c11 - c10)]
//             d_map[tap] += g_c * weight(tap)        (float32 atomics)
//
// Bound: bytes, and at the joint fit's sizes launch latency. A point reads
// 16 bytes of corners and weights, 4 * C taps and writes C outputs (the
// backward also reads C cotangents and writes two weight gradients), for
// ~30 (forward) or ~70 (backward) flops at C = 3: far below the card's
// operations-per-byte balance. The joint fit samples 2 x 32768 points of a
// 256 x 256 x 3 map (786 KB, resident in L2) per call: a few MB each way.
// Design: one thread per (view, point), no shared memory. The TPU kernel's
// weighted 2-hot contractions on the matrix unit, with the map resident in
// VMEM, existed because TPU gathers and scatters run nearly scalar; here the
// taps are plain loads that hit L2, and the map gradient is a scatter of
// float32 atomicAdds into a zeroed per-view d_map. Zero contributions are
// skipped: the many empty fragments (cotangent 0, uv 0) would otherwise all
// contend for one texel. The views of one trained map share it through a
// batch stride of 0. Every blend is written with the _rn intrinsics in the
// operation order of the plain PyTorch version (ops/cuda_texsample.py), so
// nvcc contracts nothing into an FMA and the forward equals it bit for bit;
// the atomics make d_map's summation order vary from run to run.
//
// Inputs:  maps (B, Hm, Wm, C) f32, batch stride map_stride elements (0 =
//                                   one map shared by every view)
//          y0, x0 (B, P) i32, wy, wx (B, P) f32; g (B, P, C) f32 (backward)
// Outputs: out (B, P, C) f32 (forward); d_maps (B, Hm, Wm, C) f32, zeroed by
//          the caller, and d_wy, d_wx (B, P) f32 (backward)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Offset of tap c00 of point i in its view's map, and that view's map.
__device__ __forceinline__ long corner(const int* __restrict__ y0,
                                       const int* __restrict__ x0, long i,
                                       int Hm, int Wm, int C) {
  const int y = min(max(y0[i], 0), Hm - 2);
  const int x = min(max(x0[i], 0), Wm - 2);
  return ((long)y * Wm + x) * C;
}

__global__ void __launch_bounds__(kThreads)
texsample_fwd_kernel(const float* __restrict__ maps, long map_stride,
                     const int* __restrict__ y0, const int* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx, float* __restrict__ out,
                     int P, long n, int Hm, int Wm, int C) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* m = maps + (i / P) * map_stride + corner(y0, x0, i, Hm, Wm, C);
  const long row = (long)Wm * C;
  const float ax = wx[i], ay = wy[i];
  const float ux = sub(1.0f, ax), uy = sub(1.0f, ay);
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float top = add(mul(m[c], ux), mul(m[C + c], ax));
    const float bot = add(mul(m[row + c], ux), mul(m[row + C + c], ax));
    o[c] = add(mul(top, uy), mul(bot, ay));
  }
}

__global__ void __launch_bounds__(kThreads)
texsample_bwd_kernel(const float* __restrict__ maps, long map_stride,
                     const int* __restrict__ y0, const int* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const float* __restrict__ g, float* __restrict__ d_maps,
                     float* __restrict__ d_wy, float* __restrict__ d_wx,
                     int P, long n, int Hm, int Wm, int C) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long off = corner(y0, x0, i, Hm, Wm, C);
  const float* m = maps + (i / P) * map_stride + off;
  float* dm = d_maps + (i / P) * ((long)Hm * Wm * C) + off;
  const long row = (long)Wm * C;
  const float ax = wx[i], ay = wy[i];
  const float ux = sub(1.0f, ax), uy = sub(1.0f, ay);
  const float w00 = mul(uy, ux), w01 = mul(uy, ax), w10 = mul(ay, ux),
              w11 = mul(ay, ax);
  const float* gi = g + i * C;
  float dy = 0.0f, dx = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float gc = gi[c];
    const float c00 = m[c], c01 = m[C + c], c10 = m[row + c],
                c11 = m[row + C + c];
    dy = add(dy, mul(gc, add(mul(sub(c10, c00), ux), mul(sub(c11, c01), ax))));
    dx = add(dx, mul(gc, add(mul(sub(c01, c00), uy), mul(sub(c11, c10), ay))));
    if (gc != 0.0f) {
      const float v00 = mul(gc, w00), v01 = mul(gc, w01),
                  v10 = mul(gc, w10), v11 = mul(gc, w11);
      if (v00 != 0.0f) atomicAdd(dm + c, v00);
      if (v01 != 0.0f) atomicAdd(dm + C + c, v01);
      if (v10 != 0.0f) atomicAdd(dm + row + c, v10);
      if (v11 != 0.0f) atomicAdd(dm + row + C + c, v11);
    }
  }
  d_wy[i] = dy;
  d_wx[i] = dx;
}

int check_shape(int B, int P, int Hm, int Wm, int C) {
  if (B <= 0 || P <= 0 || Hm < 2 || Wm < 2 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long blocks = ((long)B * P + kThreads - 1) / kThreads;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.

int trt_texsample_fwd(const float* maps, long map_stride, const int* y0,
                      const int* x0, const float* wy, const float* wx,
                      float* out, int B, int P, int Hm, int Wm, int C,
                      int device, void* stream) {
  int err = check_shape(B, P, Hm, Wm, C);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const long n = (long)B * P;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  texsample_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      maps, map_stride, y0, x0, wy, wx, out, P, n, Hm, Wm, C);
  return (int)cudaGetLastError();
}

int trt_texsample_bwd(const float* maps, long map_stride, const int* y0,
                      const int* x0, const float* wy, const float* wx,
                      const float* g, float* d_maps, float* d_wy, float* d_wx,
                      int B, int P, int Hm, int Wm, int C, int device,
                      void* stream) {
  int err = check_shape(B, P, Hm, Wm, C);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const long n = (long)B * P;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  texsample_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      maps, map_stride, y0, x0, wy, wx, g, d_maps, d_wy, d_wx, P, n, Hm, Wm,
      C);
  return (int)cudaGetLastError();
}

}  // extern "C"
