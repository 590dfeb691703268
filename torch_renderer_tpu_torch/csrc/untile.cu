// Fused scatter + untile kernel for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// untile_scatter writes the cropped image out[b, y, x, c] from compacted
// per-tile rows: with tile (ty, tx) = (y / tile, x / tile) and its slot
// s = tileof[b, ty * TW + tx],
//   out[b, y, x, c] = rows[b, s, (y % tile) * tile + x % tile, c]  if 0 <= s < A
//                   = bg                                           otherwise.
// Values are copied as raw 4- or 8-byte words, so float32, int32 and int64
// fields all go through unchanged (no float round trip for ids).
//
// Inputs:  rows   (B, A, tile^2, C) 4- or 8-byte elements, any strides
//                                   (given in elements)
//          tileof (B, TH * TW)      i32 slot of each tile, A = background
//          bg                       the background word (bg_bits), every
//                                   channel
// Output:  out    (B, H, W, C)      contiguous, H <= TH * tile, W <= TW * tile

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Replaces torch_renderer_tpu/rasterize/pallas_untile.py _untile_kernel
// (reached through untile_scatter_pallas).
// Bound: bytes. It reads the active tiles' rows and writes the image once;
// there is no arithmetic beyond the index math. Design: one block row per
// image row (blockIdx.x = b * H + y) and one thread per (x, c) element of
// it, so consecutive threads store consecutive addresses along W and read
// a tile's pixel row contiguously. The TPU kernel's VMEM strip transpose,
// its float32 slot table with 128-lane padding and its channel padding to
// a multiple of 128 / gcd(128, tile) were Mosaic layout constraints and are
// not carried.
template <typename V>
__global__ void __launch_bounds__(kThreads)
untile_kernel(const V* __restrict__ rows, const int* __restrict__ tileof,
              V bg, V* __restrict__ out,
              int H, int W, int C, int tile, int TW, int T, int A,
              long long sb, long long ss, long long sp, long long sc) {
  const long row = blockIdx.x;              // b * H + y
  const int b = (int)(row / H);
  const int y = (int)(row - (long)b * H);
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= W * C) return;
  const int x = e / C;
  const int c = e - x * C;
  const int ty = y / tile;
  const int tx = x / tile;
  const int s = tileof[(long)b * T + ty * TW + tx];
  V v = bg;
  if (s >= 0 && s < A) {
    const int p = (y - ty * tile) * tile + (x - tx * tile);
    v = rows[b * sb + s * ss + p * sp + c * sc];
  }
  out[row * W * C + e] = v;
}

template <typename V>
void launch(const void* rows, const int* tileof, long long bg_bits,
            void* out, int B, int H, int W, int C,
            int tile, int TW, int T, int A, long long sb, long long ss,
            long long sp, long long sc, cudaStream_t stream) {
  const dim3 grid((unsigned)((long)B * H), (W * C + kThreads - 1) / kThreads);
  untile_kernel<V><<<grid, kThreads, 0, stream>>>(
      (const V*)rows, tileof, (V)bg_bits, (V*)out, H, W, C, tile, TW, T, A,
      sb, ss, sp, sc);
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and a later synchronize would not report it.
int trt_untile_scatter(const void* rows, const int* tileof,
                       long long bg_bits, void* out, int elem_bytes, int B,
                       int H, int W, int C, int tile, int TH, int TW, int A,
                       long long sb, long long ss, long long sp,
                       long long sc, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || tile <= 0 || A < 0 ||
      H > TH * tile || W > TW * tile || (long)W * C > 65535L * kThreads ||
      (long)B * H > 2147483647L || (elem_bytes != 4 && elem_bytes != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    launch<unsigned int>(rows, tileof, bg_bits, out, B, H, W, C, tile, TW,
                         TH * TW, A, sb, ss, sp, sc, s);
  } else {
    launch<unsigned long long>(rows, tileof, bg_bits, out, B, H, W, C, tile,
                               TW, TH * TW, A, sb, ss, sp, sc, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
