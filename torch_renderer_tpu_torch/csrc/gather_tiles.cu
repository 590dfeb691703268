// Tile-slab gather kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// gather_tiles_fwd: out[b, t, s, :] = table[b, idx[b, t, s], :] where
//   0 <= idx < F, and exactly 0 elsewhere (-1 marks an empty slot).
// gather_tiles_bwd: the transpose, dtable[b, f, :] += g[b, t, s, :] over the
//   slots holding f, into a dtable the caller zeroed.
//
// A row is one (b, t): its S slots of C floats are contiguous in out.
//
// Inputs:  idx    (B, T, S)    i32 or i64 slot ids (idx64 says which)
//          table  (B, F, C)    f32 channels per item          (forward)
//          g      (B, T, S, C) f32 cotangent                  (backward)
// Output:  out    (B, T, S, C) f32                            (forward)
//          dtable (B, F, C)    f32, accumulated               (backward)

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 64;   // grid-stride beyond this
constexpr int kMaxFwdThreads = 1024;

// Replaces torch_renderer_tpu/rasterize/pallas_gather.py _fwd_kernel
// (reached through _gather_fwd / gather_tiles).
// Bound: bytes: idx, the live table rows and the slab, each once. Most
// slots are dead (beyond their tile's count) and only write zeros, so at
// the fits' slabs (a few hundred KB) a launch's fixed cost is most of the
// time. Design, per the host's plan (cuda_gather.gather_plan): a block
// takes one row (blockIdx.x, so b and the row's base pointers come from
// one division) and `chunks` blocks (blockIdx.y) share it; everything
// within a row is 32-bit index math. The block first reads the ids of the
// slots its share spans, once each and coalesced, into shared memory (-1
// for a dead id); then each thread writes one unit of 4 floats with a
// 16-byte store. A row whose start is not 16-byte aligned (S * C not a
// multiple of 4) begins with a head of up to 3 floats, written by the
// row's first block, and every row ends with a tail of up to 3, written
// by its last. A live slot's floats are read from its table row; a dead
// slot's are exact zeros, and its table row is never read. The TPU
// kernel's per-program one-hot contraction over 2048-lane face chunks and
// its 8-tile programs were a gather workaround for the MXU and are not
// carried.
template <typename I>
__global__ void __launch_bounds__(kMaxFwdThreads)
gather_fwd_kernel(const I* __restrict__ idx, const float* __restrict__ table,
                  float* __restrict__ out, int T, int S, int F, int C) {
  extern __shared__ int sid[];      // the ids of this block's slots
  const int row = blockIdx.x;
  const int L = S * C;              // floats in a row
  const float* tb = table + (long long)(row / T) * F * C;
  const I* ir = idx + (long long)row * S;
  float* o = out + (long long)row * L;
  // the row's split: head floats up to a 16-byte boundary, nv units of 4
  // floats, then the tail
  const int head =
      min((int)((16u - ((unsigned)(uintptr_t)o & 15u)) & 15u) / 4, L);
  const int nv = (L - head) / 4;
  const int tail = L - head - nv * 4;
  const int u0 = min((int)blockIdx.y * (int)blockDim.x, nv);
  const int u1 = min(u0 + (int)blockDim.x, nv);
  const bool first = blockIdx.y == 0, last = blockIdx.y == gridDim.y - 1;
  const int e0 = first ? 0 : head + u0 * 4;   // this block's floats
  const int e1 = last ? L : head + u1 * 4;
  if (e1 <= e0) return;
  const int s0 = e0 / C, ns = (e1 - 1) / C - s0 + 1;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const long long id = (long long)ir[s0 + i];
    sid[i] = id >= 0 && id < F ? (int)id : -1;
  }
  __syncthreads();
  // float e of the row: its slot's table row, or 0 in a dead slot
  auto at = [&](int e) {
    const int s = e / C;
    const int id = sid[s - s0];
    return id >= 0 ? tb[id * C + (e - s * C)] : 0.0f;
  };
  const int u = u0 + (int)threadIdx.x;
  if (u < u1) {
    const int e = head + u * 4;
    int s = e / C, c = e - s * C;
    int id = sid[s - s0];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = id >= 0 ? tb[id * C + c] : 0.0f;
      if (++c == C && k < 3) {
        c = 0;
        id = sid[++s - s0];
      }
    }
    *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (first && (int)threadIdx.x < head) o[threadIdx.x] = at(threadIdx.x);
  if (last && (int)threadIdx.x < tail) {
    const int e = head + nv * 4 + (int)threadIdx.x;
    o[e] = at(e);
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
// The forward takes the host's plan (cuda_gather.gather_plan): `threads`
// threads a block, `chunks` blocks a row.
int trt_gather_tiles_fwd(const void* idx, int idx64, const float* table,
                         float* out, int B, int T, int S, int F, int C,
                         int threads, int chunks, int device, void* stream) {
  // a row's and a view's table floats are indexed in 32 bits, and the
  // rows are blocks of one grid dimension
  if (B <= 0 || T <= 0 || S <= 0 || F <= 0 || C <= 0 ||
      (long long)S * C > INT_MAX || (long long)F * C > INT_MAX ||
      (long long)B * T > INT_MAX || threads < 32 ||
      threads > kMaxFwdThreads || threads % 32 || chunks <= 0 ||
      chunks > 65535 || (long long)chunks * threads < (long long)S * C / 4) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  // the ids a block's floats span: at most (4 * threads + 6) / C + 2
  const size_t smem = ((4 * threads + 6) / C + 2) * sizeof(int);
  const dim3 grid(B * T, chunks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (idx64) {
    gather_fwd_kernel<long long><<<grid, threads, smem, st>>>(
        (const long long*)idx, table, out, T, S, F, C);
  } else {
    gather_fwd_kernel<int><<<grid, threads, smem, st>>>(
        (const int*)idx, table, out, T, S, F, C);
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
