// Tile-slab gather kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// gather_tiles_fwd: out[b, t, s, :] = table[b, idx[b, t, s], :] where
//   0 <= idx < F, and exactly 0 elsewhere (-1 marks an empty slot).
// gather_tiles_bwd: the transpose, dtable[b, f, :] = the sum of g[b, t, s, :]
//   over the slots holding f; the kernel zeroes dtable itself.
//
// A row is one (b, t): its S slots of C floats are contiguous in out.
//
// Inputs:  idx    (B, T, S)    i32 or i64 slot ids (idx64 says which)
//          table  (B, F, C)    f32 channels per item          (forward)
//          g      (B, T, S, C) f32 cotangent                  (backward)
// Output:  out    (B, T, S, C) f32                            (forward)
//          dtable (B, F, C)    f32, every element written     (backward)

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

constexpr int kMaxFwdThreads = 1024;
constexpr int kBwdThreads = 256;          // a backward block's threads
constexpr int kBwdBigThreads = 1024;      // and on a big slab
constexpr long long kBwdBigSlots = 1 << 16;   // slots from which it is big

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

// W floats at p (p aligned to 4 W bytes): a vector of W, W in {1, 2, 4}.
template <int W> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ bool nonzero(T v) { return v != 0.0f; }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ bool nonzero(T v) {
    return v.x != 0.0f || v.y != 0.0f;
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ bool nonzero(T v) {
    return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
  }
};

// Replaces torch_renderer_tpu/rasterize/pallas_gather.py _bwd_kernel
// (reached through _gather_bwd).
// Bound: bytes (idx read once, g read at live slots, dtable written once);
// at the fits' slabs a launch's fixed cost. Design: one launch does the
// whole backward, as the TPU kernel zeroes its output in its first program:
// a cooperative launch of no more blocks than are resident at once, whose
// threads first zero dtable with 16-byte stores, then meet at a grid-wide
// barrier, then add. The add pass gives each thread one slot at a time
// (grid-stride): it reads the slot's id once, and a dead slot (-1, or any
// id outside [0, F)) costs that read alone, wherever it lies in its row
// (the binned paths put a row's live slots first, but the contract does
// not ask it, so dead slots are skipped one by one, not as a tail). A
// live slot's C floats are read and added as C / W vectors of W floats
// (W = 4, 2 or 1, the widest that divides C and both rows' alignment: the
// card's vector float atomics), and a vector of zeros adds nothing. Float32
// atomics sum a row's terms in an order that changes from run to run. The
// TPU kernel's transposed one-hot dot carried across a batch element's
// sequential tile programs has no counterpart: blocks run in no order
// here.
template <typename I, int W>
__global__ void __launch_bounds__(kBwdBigThreads)
gather_bwd_kernel(const I* __restrict__ idx, const float* __restrict__ g,
                  float* __restrict__ dtable, long long n_slots,
                  long long slots_per_b, long long n_out, int F, int C) {
  using V = typename Vec<W>::T;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  // zero pass (dtable is a fresh allocation: 16-byte aligned)
  float4* d4 = reinterpret_cast<float4*>(dtable);
  for (long long e = t0; e < n_out / 4; e += nt) {
    d4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (long long e = n_out / 4 * 4 + t0; e < n_out; e += nt) {
    dtable[e] = 0.0f;
  }
  cooperative_groups::this_grid().sync();
  // add pass
  const bool narrow = n_slots <= INT_MAX;       // 32-bit division suffices
  for (long long s = t0; s < n_slots; s += nt) {
    const long long id = (long long)idx[s];
    if (id < 0 || id >= F) continue;
    const long long b =
        narrow ? (long long)((unsigned)s / (unsigned)slots_per_b)
               : s / slots_per_b;
    const V* src = reinterpret_cast<const V*>(g + s * C);
    V* dst = reinterpret_cast<V*>(dtable + (b * F + id) * C);
    for (int k = 0; k < C / W; ++k) {
      const V v = src[k];
      if (Vec<W>::nonzero(v)) atomicAdd(dst + k, v);
    }
  }
}

// Blocks of `threads` threads of the backward an SM holds at once, per
// device, instance and block size, read once.
template <typename I, int W>
int bwd_resident(int device, int threads, int* blocks) {
  static int cached[64][2] = {};
  const int big = threads == kBwdBigThreads;
  if (device >= 0 && device < 64 && cached[device][big]) {
    *blocks = cached[device][big];
    return 0;
  }
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gather_bwd_kernel<I, W>, threads, 0);
  if (!err && device >= 0 && device < 64) cached[device][big] = *blocks;
  return err;
}

// One cooperative launch of the backward: as many blocks as the larger
// pass needs, at most the resident ones. A big slab takes blocks of 1024
// threads, so that a quarter as many blocks meet at the barrier; a small
// one keeps blocks of 256, so that more SMs share its few slots.
template <typename I, int W>
int launch_bwd(const void* idx, const float* g, float* dtable,
               long long n_slots, long long slots_per_b, long long n_out,
               int F, int C, int device, cudaStream_t stream) {
  const int threads =
      n_slots >= kBwdBigSlots ? kBwdBigThreads : kBwdThreads;
  int sms = 0, resident = 0;
  int err = sm_count(device, &sms);
  if (err) return err;
  err = bwd_resident<I, W>(device, threads, &resident);
  if (err) return err;
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long work = n_slots > n_out / 4 ? n_slots : n_out / 4 + 1;
  long long blocks = (work + threads - 1) / threads;
  const long long most = (long long)resident * sms;
  if (blocks > most) blocks = most;
  const I* ip = static_cast<const I*>(idx);
  void* args[] = {(void*)&ip, (void*)&g, (void*)&dtable, (void*)&n_slots,
                  (void*)&slots_per_b, (void*)&n_out, (void*)&F, (void*)&C};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)gather_bwd_kernel<I, W>, dim3((unsigned)blocks),
      dim3(threads), args, 0, stream);
}

template <typename I>
int launch_bwd_w(const void* idx, const float* g, float* dtable,
                 long long n_slots, long long slots_per_b, long long n_out,
                 int F, int C, int device, cudaStream_t stream) {
  // the widest vector that divides C and keeps both rows' starts aligned
  const uintptr_t a = (uintptr_t)g | (uintptr_t)dtable;
  if (C % 4 == 0 && a % 16 == 0) {
    return launch_bwd<I, 4>(idx, g, dtable, n_slots, slots_per_b, n_out, F,
                            C, device, stream);
  }
  if (C % 2 == 0 && a % 8 == 0) {
    return launch_bwd<I, 2>(idx, g, dtable, n_slots, slots_per_b, n_out, F,
                            C, device, stream);
  }
  return launch_bwd<I, 1>(idx, g, dtable, n_slots, slots_per_b, n_out, F, C,
                          device, stream);
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
  if (B <= 0 || slots_per_b < 0 || F <= 0 || C <= 0 ||
      (uintptr_t)dtable % 16) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long long n_slots = (long long)B * slots_per_b;
  const long long n_out = (long long)B * F * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    err = launch_bwd_w<long long>(idx, g, dtable, n_slots, slots_per_b,
                                  n_out, F, C, device, s);
  } else {
    err = launch_bwd_w<int>(idx, g, dtable, n_slots, slots_per_b, n_out, F,
                            C, device, s);
  }
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
