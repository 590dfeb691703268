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
// Bound: bytes, and at the joint fit's sizes a launch's fixed cost. A point
// reads 16 bytes of corners and weights and 4 * C taps and writes C outputs
// (the backward also reads C cotangents and writes two weight gradients),
// for ~30 (forward) or ~70 (backward) flops at C = 3: far below the card's
// operations-per-byte balance. The joint fit samples 2 x 32768 points of a
// 256 x 256 x 3 map (786 KB, resident in L2) per call.
//
// Design. The TPU kernels' weighted 2-hot contractions on the matrix unit,
// with the map resident in VMEM, existed because TPU gathers and scatters
// run nearly scalar; here the taps are loads that hit L2 and the map
// gradient is a scatter of float32 atomics into a zeroed per-view d_map.
// - One thread per point, blocks of 128 points of one view: the view is
//   blockIdx.y (and blockIdx.z past 65535 views), so no thread divides, and
//   the joint fit's 2 x 256 blocks spread over all 132 SMs.
// - The taps are scalar loads through the read-only path. A tap row
//   (c00 || c01, or c10 || c11) is 2C contiguous floats, but 16-, 8- and
//   4-byte vector loads split by the row's alignment read no faster at
//   uniform uv and slower at the joint fit's fragments, and so did staging
//   a block's outputs or cotangents through shared memory for 16-byte
//   stores and loads (PERF.md, kernel table, rows 14 and 15): a point reads
//   and writes its C floats directly.
// - Backward: the lanes of a warp whose c00 texel is the same
//   (__match_any_sync) add their 4C contributions in a tree over the lane
//   order (`reduce_peers`), and one leader a group makes the atomics: the
//   joint fit's neighbouring fragments, which often sample one texel, stop
//   serialising on its addresses. A lane whose contributions are all
//   exactly zero (the empty fragments: uv 0 and cotangent 0) is a group of
//   its own and adds nothing, so they do not pile onto texel (Hm - 2, 0).
//   The leader adds each tap row with vector atomics in pieces of 4, 2 or
//   1 floats: from the row's first float on, the widest piece that the
//   address's alignment and the floats left allow (`pieces`; C = 3 takes 2
//   to 4 a row instead of 6), and a piece of zeros adds nothing. Float32
//   atomics make d_map's summation order vary from run to run.
// - Every blend is written with the _rn intrinsics in the operation order
//   of the plain PyTorch version (ops/cuda_texsample.py), so nvcc contracts
//   nothing into an FMA and the forward equals it bit for bit; d_wy and d_wx
//   keep that order per point.
// - C = 1..8 have their own instances (the rows' pieces fixed at compile
//   time); more channels take one kernel of the same arithmetic with a
//   scalar atomic per nonzero value.
//
// Inputs:  maps (B, Hm, Wm, C) f32, batch stride map_stride elements (0 =
//                                   one map shared by every view)
//          y0, x0 (B, P) i32, wy, wx (B, P) f32; g (B, P, C) f32 (backward)
// Outputs: out (B, P, C) f32 (forward); d_maps (B, Hm, Wm, C) f32, zeroed by
//          the caller, and d_wy, d_wx (B, P) f32 (backward)

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // points a block, both kernels
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// The view of this block, or -1 past the last one.
__device__ __forceinline__ int view_of_block(int B) {
  const int b = (int)(blockIdx.z * gridDim.y + blockIdx.y);
  return b < B ? b : -1;
}

// Texel index y * Wm + x of tap c00, with the corner clamped.
__device__ __forceinline__ int corner(int y, int x, int Hm, int Wm) {
  return min(max(y, 0), Hm - 2) * Wm + min(max(x, 0), Wm - 2);
}

template <int V> struct Int { static constexpr int value = V; };

// Calls op(Int<K>, Int<W>) for each piece [K, K + W) of a run of N floats
// whose first float lies R floats past a 16-byte boundary: W is 4 where the
// piece starts on a 16-byte boundary and 4 floats are left, else 2 where
// it starts on an 8-byte boundary and 2 are left, else 1.
template <int N, int R, int K = 0, typename Op>
__device__ __forceinline__ void pieces(Op& op) {
  if constexpr (K < N) {
    constexpr int a = (R + K) & 3;
    constexpr int W = (a == 0 && N - K >= 4) ? 4
                      : (a % 2 == 0 && N - K >= 2) ? 2 : 1;
    op(Int<K>{}, Int<W>{});
    pieces<N, R, K + W>(op);
  }
}

// The pieces of the run of N floats at p.
template <int N, typename Op>
__device__ __forceinline__ void split_run(const float* p, Op op) {
  switch ((unsigned)((uintptr_t)p >> 2) & 3u) {
    case 0: pieces<N, 0>(op); break;
    case 1: pieces<N, 1>(op); break;
    case 2: pieces<N, 2>(op); break;
    default: pieces<N, 3>(op); break;
  }
}

// Adds v to the run at p, one vector atomic a piece; a piece of zeros adds
// nothing.
template <int N>
__device__ __forceinline__ void add_run(float* p, const float (&v)[N]) {
  split_run<N>(p, [&](auto k, auto w) {
    constexpr int K = decltype(k)::value, W = decltype(w)::value;
    if constexpr (W == 4) {
      if (v[K] != 0.0f || v[K + 1] != 0.0f || v[K + 2] != 0.0f ||
          v[K + 3] != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(p + K),
                  make_float4(v[K], v[K + 1], v[K + 2], v[K + 3]));
      }
    } else if constexpr (W == 2) {
      if (v[K] != 0.0f || v[K + 1] != 0.0f) {
        atomicAdd(reinterpret_cast<float2*>(p + K),
                  make_float2(v[K], v[K + 1]));
      }
    } else {
      if (v[K] != 0.0f) atomicAdd(p + K, v[K]);
    }
  });
}

// Sums a and b over the lanes of `peers` (this lane's group; every lane of
// the warp calls it) into the group's lowest lane, in a tree over the
// group's lane order: in round r, the lane of rank k (k a multiple of 2^r)
// adds the partial sum of rank k + 2^r. Other lanes end with partial sums.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             float (&a)[N], float (&b)[N]) {
  unsigned above = peers & (0xfffffffeu << lane);   // the group's higher lanes
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(kFull, above != 0u)) {
    const int next = above ? __ffs(above) - 1 : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float ta = __shfl_sync(kFull, a[k], next);
      const float tb = __shfl_sync(kFull, b[k], next);
      if (above) {
        a[k] = add(a[k], ta);
        b[k] = add(b[k], tb);
      }
    }
    above &= __ballot_sync(kFull, (rank & 1u) == 0u);
    rank >>= 1;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
texsample_fwd_kernel(const float* __restrict__ maps, long long map_stride,
                     const int* __restrict__ y0, const int* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx, float* __restrict__ out,
                     int B, int P, int Hm, int Wm) {
  const int b = view_of_block(B);
  const int p = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  if (b < 0 || p >= P) return;
  const long long i = (long long)b * P + p;
  const float ax = __ldg(wx + i), ay = __ldg(wy + i);
  const float* m = maps + b * map_stride +
      (long long)corner(__ldg(y0 + i), __ldg(x0 + i), Hm, Wm) * C;
  const long long row = (long long)Wm * C;
  float top[2 * C], bot[2 * C];
#pragma unroll
  for (int k = 0; k < 2 * C; ++k) {
    top[k] = __ldg(m + k);
    bot[k] = __ldg(m + row + k);
  }
  const float ux = sub(1.0f, ax), uy = sub(1.0f, ay);
  float* o = out + i * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float tp = add(mul(top[c], ux), mul(top[C + c], ax));
    const float bt = add(mul(bot[c], ux), mul(bot[C + c], ax));
    o[c] = add(mul(tp, uy), mul(bt, ay));
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
texsample_bwd_kernel(const float* __restrict__ maps, long long map_stride,
                     const int* __restrict__ y0, const int* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const float* __restrict__ g, float* __restrict__ d_maps,
                     float* __restrict__ d_wy, float* __restrict__ d_wx,
                     int B, int P, int Hm, int Wm) {
  constexpr int N = 2 * C;
  const int b = view_of_block(B);
  if (b < 0) return;
  const int p = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  const int lane = (int)threadIdx.x & 31;
  const long long row = (long long)Wm * C;
  // this point's contributions to the rows c00 || c01 and c10 || c11
  float top[N], bot[N];
  int key = -1 - lane;     // nothing to add: a group of one
  int texel = 0;
  if (p < P) {             // every lane stays for the warp's exchanges
    const long long i = (long long)b * P + p;
    const float ax = __ldg(wx + i), ay = __ldg(wy + i);
    texel = corner(__ldg(y0 + i), __ldg(x0 + i), Hm, Wm);
    const float* m = maps + b * map_stride + (long long)texel * C;
    const float* gi = g + i * C;
    float mt[N], mb[N], gc[C];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      mt[k] = __ldg(m + k);
      mb[k] = __ldg(m + row + k);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) gc[c] = __ldg(gi + c);
    const float ux = sub(1.0f, ax), uy = sub(1.0f, ay);
    const float w00 = mul(uy, ux), w01 = mul(uy, ax), w10 = mul(ay, ux),
                w11 = mul(ay, ax);
    float dy = 0.0f, dx = 0.0f;
    bool live = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float c00 = mt[c], c01 = mt[C + c], c10 = mb[c], c11 = mb[C + c];
      dy = add(dy, mul(gc[c], add(mul(sub(c10, c00), ux),
                                  mul(sub(c11, c01), ax))));
      dx = add(dx, mul(gc[c], add(mul(sub(c01, c00), uy),
                                  mul(sub(c11, c10), ay))));
      top[c] = mul(gc[c], w00);
      top[C + c] = mul(gc[c], w01);
      bot[c] = mul(gc[c], w10);
      bot[C + c] = mul(gc[c], w11);
      live |= top[c] != 0.0f || top[C + c] != 0.0f || bot[c] != 0.0f ||
              bot[C + c] != 0.0f;
    }
    d_wy[i] = dy;
    d_wx[i] = dx;
    if (live) key = texel;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) top[k] = bot[k] = 0.0f;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  reduce_peers<N>(peers, lane, top, bot);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    float* dm = d_maps + ((long long)b * Hm * Wm + texel) * C;
    add_run<N>(dm, top);
    add_run<N>(dm + row, bot);
  }
}

// More than 8 channels: the same arithmetic, channel by channel.
__global__ void __launch_bounds__(kThreads)
texsample_fwd_any_kernel(const float* __restrict__ maps, long long map_stride,
                         const int* __restrict__ y0,
                         const int* __restrict__ x0,
                         const float* __restrict__ wy,
                         const float* __restrict__ wx,
                         float* __restrict__ out, int B, int P, int Hm,
                         int Wm, int C) {
  const int b = view_of_block(B);
  const int p = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  if (b < 0 || p >= P) return;
  const long long i = (long long)b * P + p;
  const float* m = maps + b * map_stride +
      (long long)corner(y0[i], x0[i], Hm, Wm) * C;
  const long long row = (long long)Wm * C;
  const float ax = wx[i], ay = wy[i];
  const float ux = sub(1.0f, ax), uy = sub(1.0f, ay);
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float tp = add(mul(m[c], ux), mul(m[C + c], ax));
    const float bt = add(mul(m[row + c], ux), mul(m[row + C + c], ax));
    o[c] = add(mul(tp, uy), mul(bt, ay));
  }
}

__global__ void __launch_bounds__(kThreads)
texsample_bwd_any_kernel(const float* __restrict__ maps, long long map_stride,
                         const int* __restrict__ y0,
                         const int* __restrict__ x0,
                         const float* __restrict__ wy,
                         const float* __restrict__ wx,
                         const float* __restrict__ g,
                         float* __restrict__ d_maps,
                         float* __restrict__ d_wy, float* __restrict__ d_wx,
                         int B, int P, int Hm, int Wm, int C) {
  const int b = view_of_block(B);
  const int p = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  if (b < 0 || p >= P) return;
  const long long i = (long long)b * P + p;
  const long long off = (long long)corner(y0[i], x0[i], Hm, Wm) * C;
  const float* m = maps + b * map_stride + off;
  float* dm = d_maps + (long long)b * Hm * Wm * C + off;
  const long long row = (long long)Wm * C;
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
    const float v00 = mul(gc, w00), v01 = mul(gc, w01), v10 = mul(gc, w10),
                v11 = mul(gc, w11);
    if (v00 != 0.0f) atomicAdd(dm + c, v00);
    if (v01 != 0.0f) atomicAdd(dm + C + c, v01);
    if (v10 != 0.0f) atomicAdd(dm + row + c, v10);
    if (v11 != 0.0f) atomicAdd(dm + row + C + c, v11);
  }
  d_wy[i] = dy;
  d_wx[i] = dx;
}

// The grid, or an error: views on y (and z past 65535), blocks of points on
// x; texel indices are 32-bit.
int plan(int B, int P, int Hm, int Wm, int C, dim3* grid) {
  if (B <= 0 || P <= 0 || Hm < 2 || Wm < 2 || C <= 0 ||
      (long long)Hm * Wm > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int gy = min(B, kMaxGridY);
  *grid = dim3((unsigned)((P + kThreads - 1) / kThreads), (unsigned)gy,
               (unsigned)((B + gy - 1) / gy));
  return 0;
}

// cudaSetDevice only where the calling thread's device differs.
int use_device(int device) {
  int cur = -1;
  const int err = (int)cudaGetDevice(&cur);
  if (err) return err;
  return cur == device ? 0 : (int)cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One launch's arguments, packed by the wrapper (ops/cuda_texsample.py
// _ARGS, struct format "@PqPPPPPPPPPiiiiii": this field order, C layout):
// one pointer crosses ctypes instead of fourteen converted arguments. The
// forward leaves g, d_wy and d_wx at 0; out is the forward's output and
// the backward's d_maps.
struct TexArgs {
  const float* maps;
  long long map_stride;
  const int* y0;
  const int* x0;
  const float* wy;
  const float* wx;
  const float* g;
  float* out;
  float* d_wy;
  float* d_wx;
  void* stream;
  int B, P, Hm, Wm, C, device;
};

int trt_texsample_args_size() { return (int)sizeof(TexArgs); }

// Each launcher enqueues on the stream and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.

int trt_texsample_fwd(const TexArgs* a) {
  dim3 grid;
  int err = plan(a->B, a->P, a->Hm, a->Wm, a->C, &grid);
  if (!err) err = use_device(a->device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)a->stream;
#define TRT_FWD(c)                                                         \
  case c:                                                                  \
    texsample_fwd_kernel<c><<<grid, kThreads, 0, s>>>(                     \
        a->maps, a->map_stride, a->y0, a->x0, a->wy, a->wx, a->out, a->B,  \
        a->P, a->Hm, a->Wm);                                               \
    break;
  switch (a->C) {
    TRT_FWD(1) TRT_FWD(2) TRT_FWD(3) TRT_FWD(4)
    TRT_FWD(5) TRT_FWD(6) TRT_FWD(7) TRT_FWD(8)
    default:
      texsample_fwd_any_kernel<<<grid, kThreads, 0, s>>>(
          a->maps, a->map_stride, a->y0, a->x0, a->wy, a->wx, a->out, a->B,
          a->P, a->Hm, a->Wm, a->C);
  }
#undef TRT_FWD
  return (int)cudaGetLastError();
}

int trt_texsample_bwd(const TexArgs* a) {
  dim3 grid;
  int err = plan(a->B, a->P, a->Hm, a->Wm, a->C, &grid);
  if (!err) err = use_device(a->device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)a->stream;
#define TRT_BWD(c)                                                         \
  case c:                                                                  \
    texsample_bwd_kernel<c><<<grid, kThreads, 0, s>>>(                     \
        a->maps, a->map_stride, a->y0, a->x0, a->wy, a->wx, a->g, a->out,  \
        a->d_wy, a->d_wx, a->B, a->P, a->Hm, a->Wm);                       \
    break;
  switch (a->C) {
    TRT_BWD(1) TRT_BWD(2) TRT_BWD(3) TRT_BWD(4)
    TRT_BWD(5) TRT_BWD(6) TRT_BWD(7) TRT_BWD(8)
    default:
      texsample_bwd_any_kernel<<<grid, kThreads, 0, s>>>(
          a->maps, a->map_stride, a->y0, a->x0, a->wy, a->wx, a->g, a->out,
          a->d_wy, a->d_wx, a->B, a->P, a->Hm, a->Wm, a->C);
  }
#undef TRT_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
