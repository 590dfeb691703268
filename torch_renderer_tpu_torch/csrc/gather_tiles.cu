// Tile-slab gather kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// gather_tiles_fwd: out[b, t, s, :] = table[b, idx[b, t, s], :] where
//   0 <= idx < F, and exactly 0 elsewhere (-1 marks an empty slot).
// gather_tiles_bwd: the transpose, dtable[b, f, :] += g[b, t, s, :] over the
//   slots holding f, into a dtable the caller zeroed.
//
// Inputs:  idx    (B, T, S)    i32 or i64 slot ids (idx64 says which)
//          table  (B, F, C)    f32 channels per item          (forward)
//          g      (B, T, S, C) f32 cotangent                  (backward)
// Output:  out    (B, T, S, C) f32                            (forward)
//          dtable (B, F, C)    f32, accumulated               (backward)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 64;   // grid-stride beyond this

// Replaces torch_renderer_tpu/rasterize/pallas_gather.py _fwd_kernel
// (reached through _gather_fwd / gather_tiles).
// Bound: bytes. Each output element is one load and one store, so the
// kernel moves idx, the live table rows and the slab once. Design: one
// thread per output element, consecutive threads on consecutive elements,
// so the stores coalesce and the C threads of a slot share its id (one
// broadcast load). The TPU kernel's per-program one-hot contraction over
// 2048-lane face chunks and its 8-tile programs were a gather workaround
// for the MXU and are not carried.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_fwd_kernel(const I* __restrict__ idx, const float* __restrict__ table,
                  float* __restrict__ out, long n, long slots_per_b, int F,
                  int C) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    const long slot = e / C;
    const int c = (int)(e - slot * C);
    const long id = (long)idx[slot];
    float v = 0.0f;
    if (id >= 0 && id < F) {
      const long b = slot / slots_per_b;
      v = table[(b * F + id) * C + c];
    }
    out[e] = v;
  }
}

// Replaces torch_renderer_tpu/rasterize/pallas_gather.py _bwd_kernel
// (reached through _gather_bwd).
// Bound: bytes (idx and g read once, dtable written once). Design: one
// thread per (slot, channel); empty slots and zero cotangents add nothing,
// the rest add with float32 atomics, so a face's terms sum in an order that
// changes from run to run. The TPU kernel's transposed one-hot dot carried
// across a batch element's sequential tile programs has no counterpart:
// blocks run in no order here.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const I* __restrict__ idx, const float* __restrict__ g,
                  float* __restrict__ dtable, long n, long slots_per_b,
                  int F, int C) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    const long slot = e / C;
    const int c = (int)(e - slot * C);
    const long id = (long)idx[slot];
    if (id < 0 || id >= F) continue;
    const float v = g[e];
    if (v == 0.0f) continue;
    const long b = slot / slots_per_b;
    atomicAdd(dtable + (b * F + id) * C + c, v);
  }
}

int blocks_for(long n) {
  const long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// Each entry point enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.
int trt_gather_tiles_fwd(const void* idx, int idx64, const float* table,
                         float* out, int B, long long slots_per_b, int F,
                         int C, int device, void* stream) {
  if (B <= 0 || slots_per_b <= 0 || F <= 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long n = (long)B * slots_per_b * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    gather_fwd_kernel<long long><<<blocks_for(n), kThreads, 0, s>>>(
        (const long long*)idx, table, out, n, slots_per_b, F, C);
  } else {
    gather_fwd_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(
        (const int*)idx, table, out, n, slots_per_b, F, C);
  }
  return (int)cudaGetLastError();
}

int trt_gather_tiles_bwd(const void* idx, int idx64, const float* g,
                         float* dtable, int B, long long slots_per_b, int F,
                         int C, int device, void* stream) {
  if (B <= 0 || slots_per_b <= 0 || F <= 0 || C <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long n = (long)B * slots_per_b * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    gather_bwd_kernel<long long><<<blocks_for(n), kThreads, 0, s>>>(
        (const long long*)idx, g, dtable, n, slots_per_b, F, C);
  } else {
    gather_bwd_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(
        (const int*)idx, g, dtable, n, slots_per_b, F, C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
