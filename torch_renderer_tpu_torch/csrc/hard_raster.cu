// Hard (nearest-face) rasterization kernels for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// Both kernels visit one active tile's candidate faces, in ascending slot
// order (= ascending face id), for every pixel of the tile:
//   * hard_k1 keeps the covering face with the lowest selection z and
//     interpolates it: zbuf, perspective-correct barycentrics, signed
//     squared boundary distance, global face id, live, winner slot;
//   * topk_select keeps the K covering faces with the lowest selection z,
//     in ascending order, as winner slots only (-1 = dead).
// A face covers a pixel when the pixel is inside it (or, with blur > 0,
// within squared distance blur of its boundary), and its selection z
//   zsel = sum relu(b) / max(sum relu(b) * invz, 1e-12)
// is above znear. Ties keep the earlier slot: strict < while visiting slots
// in ascending order, and a stable insertion for top-K.
//
// Every selection and interpolation formula is written with the _rn
// intrinsics in the operation order of the plain PyTorch versions
// (rasterize/cuda_hard.py; geometry.channel_edge_bary,
// channel_min_edge_dist2 and fragment_math), so nvcc contracts nothing into
// an FMA and the kernel's winners and values equal the plain version's bit
// for bit.
//
// Inputs:  slab   (B, A, F, 13) f32  per slot: qx0 qy0 qx1 qy1 qx2 qy2
//                                     z0 z1 z2 invz0 invz1 invz2 face_id
//          count  (B, A)        i32  live slots per tile (slots >= count are
//                                     never read)
//          origin (B, A, 2)     f32  raster coords of the tile's pixel (0, 0)
// Pixel p of a tile sits at origin + ((p % tile) * inv_s, (p / tile) * inv_s):
// absolute raster coordinates, as the JAX kernels use, so the edge
// functions round as they do there.
// Outputs: hard_k1     out  (B, A, 8, tile^2) f32: zbuf, pc0, pc1, pc2,
//                           dists, face id, live, slot
//          topk_select lane (B, A, K, tile^2) i32: winner slots, -1 = dead

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPixels = 1024;   // one thread per pixel of a tile
constexpr int kChunk = 128;        // candidates staged per shared-memory pass
constexpr int kChannels = 13;
constexpr int kMaxK = 64;
constexpr float kInf = 3.0e38f;
constexpr float kEmptyDist = 1e10f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Per-face values that do not depend on the pixel, staged in shared memory.
struct Face {
  float qx[3], qy[3];
  float invz[3];
  float gx[3], gy[3];   // edge a runs from corner a to corner (a + 1) % 3
  float len2[3];        // max(gx^2 + gy^2, 1e-12)
  float inv_area;       // 1 / (area2 if |area2| > 1e-12 else 1)
};

__device__ __forceinline__ void load_face(const float* __restrict__ c,
                                          Face& f) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.qx[k] = c[2 * k];
    f.qy[k] = c[2 * k + 1];
    f.invz[k] = c[9 + k];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b = (a + 1) % 3;
    f.gx[a] = sub(f.qx[b], f.qx[a]);
    f.gy[a] = sub(f.qy[b], f.qy[a]);
    f.len2[a] = fmaxf(add(mul(f.gx[a], f.gx[a]), mul(f.gy[a], f.gy[a])),
                      1e-12f);
  }
  const float area2 = sub(mul(sub(f.qx[1], f.qx[0]), sub(f.qy[2], f.qy[0])),
                          mul(sub(f.qy[1], f.qy[0]), sub(f.qx[2], f.qx[0])));
  f.inv_area = dvd(1.0f, fabsf(area2) > 1e-12f ? area2 : 1.0f);
}

// Screen-space barycentrics of pixel (px, py); wx/wy are the pixel minus
// each corner. Edge function k is opposite corner k, i.e. it runs along
// edge a = (k + 1) % 3.
__device__ __forceinline__ void bary(const Face& f, float px, float py,
                                     float wx[3], float wy[3], float b[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    wx[a] = sub(px, f.qx[a]);
    wy[a] = sub(py, f.qy[a]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = (k + 1) % 3;
    const float e = sub(mul(f.gx[a], wy[a]), mul(f.gy[a], wx[a]));
    b[k] = mul(e, f.inv_area);
  }
}

// Min over the edges of the clamped point-to-segment squared distance.
__device__ __forceinline__ float edge_dist2(const Face& f, const float wx[3],
                                            const float wy[3]) {
  float d2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float wg = add(mul(wx[a], f.gx[a]), mul(wy[a], f.gy[a]));
    const float t = fminf(fmaxf(dvd(wg, f.len2[a]), 0.0f), 1.0f);
    const float dd = add(sub(add(mul(wx[a], wx[a]), mul(wy[a], wy[a])),
                             mul(mul(2.0f, t), wg)),
                         mul(mul(t, t), f.len2[a]));
    d2 = a == 0 ? dd : fminf(d2, dd);
  }
  return fmaxf(d2, 0.0f);
}

// Selection priority: zsel where the face covers the pixel, kInf elsewhere.
__device__ __forceinline__ float priority(const Face& f, float px, float py,
                                          float blur, float znear) {
  float wx[3], wy[3], b[3];
  bary(f, px, py, wx, wy, b);
  const bool inside = b[0] >= 0.0f && b[1] >= 0.0f && b[2] >= 0.0f;
  const float r0 = fmaxf(b[0], 0.0f), r1 = fmaxf(b[1], 0.0f),
              r2 = fmaxf(b[2], 0.0f);
  const float den = fmaxf(
      add(add(mul(r0, f.invz[0]), mul(r1, f.invz[1])), mul(r2, f.invz[2])),
      1e-12f);
  const float zsel = dvd(add(add(r0, r1), r2), den);
  bool cover = inside;
  if (blur > 0.0f && !inside) cover = edge_dist2(f, wx, wy) < blur;
  return (cover && zsel > znear) ? zsel : kInf;
}

__device__ __forceinline__ void stage_chunk(const float* __restrict__ st,
                                            int c0, int m, Face* faces) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    load_face(st + (long)(c0 + i) * kChannels, faces[i]);
  }
}

// Replaces torch_renderer_tpu/rasterize/pallas_hard.py _hard_kernel (reached
// through _tile_hard_fwd).
// Bound: arithmetic and latency. A tile reads F * 52 bytes of candidates
// for tile^2 * F (pixel, face) pairs of ~40 flops each, so device memory is
// never the limit; at the pose fit's sizes (a few dozen tiles) the card is
// far from full and launch latency dominates. Design: one block per
// (batch, active tile), one thread per pixel; the tile's candidates stream
// through shared memory in chunks with their per-face constants staged
// there (every warp reads one face at a time: a broadcast). The trip count
// is the tile's own count. Selection keeps only (priority, slot) per
// thread; the winner is interpolated once at the end from its slab row,
// instead of picking 5 interpolated values per chunk as the TPU kernel did.
__global__ void __launch_bounds__(kMaxPixels)
hard_k1_kernel(const float* __restrict__ slab, const int* __restrict__ count,
               const float* __restrict__ origin, float* __restrict__ out,
               int A, int F, int tile, float inv_s, float blur, float znear,
               int clip_bary) {
  __shared__ Face faces[kChunk];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], F));
  const int tp = tile * tile;
  const int p = threadIdx.x;
  const float px = add(origin[2 * cell], mul((float)(p % tile), inv_s));
  const float py = add(origin[2 * cell + 1], mul((float)(p / tile), inv_s));
  const float* st = slab + cell * F * kChannels;

  float best = kInf;
  int lane = 0;
  for (int c0 = 0; c0 < n; c0 += kChunk) {   // n is uniform in the block
    const int m = min(kChunk, n - c0);
    __syncthreads();                          // previous chunk consumed
    stage_chunk(st, c0, m, faces);
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float pr = priority(faces[i], px, py, blur, znear);
      if (pr < best) {
        best = pr;
        lane = c0 + i;
      }
    }
  }
  if (p >= tp) return;

  float* o = out + cell * 8 * tp + p;
  if (!(best < kInf)) {
    o[0] = -1.0f;
    o[tp] = 0.0f;
    o[2 * tp] = 0.0f;
    o[3 * tp] = 0.0f;
    o[4 * tp] = kEmptyDist;
    o[5 * tp] = -1.0f;
    o[6 * tp] = 0.0f;
    o[7 * tp] = 0.0f;
    return;
  }
  const float* c = st + (long)lane * kChannels;
  Face f;
  load_face(c, f);
  float wx[3], wy[3], b[3];
  bary(f, px, py, wx, wy, b);
  const bool inside = b[0] >= 0.0f && b[1] >= 0.0f && b[2] >= 0.0f;
  float pc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pc[k] = mul(b[k], f.invz[k]);
  const float denom = fmaxf(add(add(pc[0], pc[1]), pc[2]), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) pc[k] = dvd(pc[k], denom);
  if (clip_bary) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = fmaxf(pc[k], 0.0f);
    const float rden = fmaxf(add(add(pc[0], pc[1]), pc[2]), 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[k] = dvd(pc[k], rden);
  }
  const float zbuf =
      add(add(mul(pc[0], c[6]), mul(pc[1], c[7])), mul(pc[2], c[8]));
  const float d2 = edge_dist2(f, wx, wy);
  o[0] = zbuf;
  o[tp] = pc[0];
  o[2 * tp] = pc[1];
  o[3 * tp] = pc[2];
  o[4 * tp] = inside ? -d2 : d2;
  o[5 * tp] = c[12];
  o[6 * tp] = 1.0f;
  o[7 * tp] = (float)lane;
}

// Replaces torch_renderer_tpu/rasterize/pallas_hard.py _topk_select_kernel
// (reached through _tile_topk_reinterp).
// Bound: arithmetic, like hard_k1, plus a KMAX-step insertion per covering
// candidate (few candidates cover a pixel: ~K of them). Design: as
// hard_k1, with a per-thread sorted list of (zsel, slot) of KMAX entries in
// registers (statically indexed, unrolled; a runtime K <= KMAX uses the
// first K). A candidate enters only below the K-th entry, at the first
// entry it is strictly below, shifting the rest: ties keep the earlier
// slot, the JAX kernel's first-lane rule. The TPU kernel's K extraction
// passes over a (pixel, face) priority slab become this one pass.
template <int KMAX>
__global__ void __launch_bounds__(kMaxPixels)
topk_select_kernel(const float* __restrict__ slab,
                   const int* __restrict__ count,
                   const float* __restrict__ origin, int* __restrict__ lane,
                   int A, int F, int K, int tile, float inv_s, float blur,
                   float znear) {
  __shared__ Face faces[kChunk];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], F));
  const int tp = tile * tile;
  const int p = threadIdx.x;
  const float px = add(origin[2 * cell], mul((float)(p % tile), inv_s));
  const float py = add(origin[2 * cell + 1], mul((float)(p / tile), inv_s));
  const float* st = slab + cell * F * kChannels;

  float zs[KMAX];
  int ls[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    zs[j] = kInf;
    ls[j] = -1;
  }
  float kth = kInf;   // the K-th entry's z: the bar a candidate must beat
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();
    stage_chunk(st, c0, m, faces);
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      float cz = priority(faces[i], px, py, blur, znear);
      if (!(cz < kth)) continue;
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
  if (p >= tp) return;
  int* o = lane + cell * K * tp + p;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < K) o[(long)j * tp] = ls[j];
  }
}

int check_shape(int B, int A, int F, int tile) {
  if (B <= 0 || B > 65535 || A <= 0 || F <= 0 || tile <= 0 ||
      tile * tile > kMaxPixels) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int KMAX>
void launch_topk(dim3 grid, int threads, cudaStream_t stream,
                 const float* slab, const int* count, const float* origin,
                 int* lane, int A, int F, int K, int tile, float inv_s,
                 float blur, float znear) {
  topk_select_kernel<KMAX><<<grid, threads, 0, stream>>>(
      slab, count, origin, lane, A, F, K, tile, inv_s, blur, znear);
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronize would not report it.

int trt_hard_k1(const float* slab, const int* count, const float* origin,
                float* out, int B, int A, int F, int tile, float inv_s,
                float blur, float znear, int clip_bary, int device,
                void* stream) {
  int err = check_shape(B, A, F, tile);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  hard_k1_kernel<<<dim3(A, B), tile * tile, 0, (cudaStream_t)stream>>>(
      slab, count, origin, out, A, F, tile, inv_s, blur, znear, clip_bary);
  return (int)cudaGetLastError();
}

int trt_topk_select(const float* slab, const int* count, const float* origin,
                    int* lane, int B, int A, int F, int K, int tile,
                    float inv_s, float blur, float znear, int device,
                    void* stream) {
  int err = check_shape(B, A, F, tile);
  if (err) return err;
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const dim3 grid(A, B);
  const int threads = tile * tile;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) {
    launch_topk<4>(grid, threads, s, slab, count, origin, lane, A, F, K,
                   tile, inv_s, blur, znear);
  } else if (K <= 8) {
    launch_topk<8>(grid, threads, s, slab, count, origin, lane, A, F, K,
                   tile, inv_s, blur, znear);
  } else if (K <= 16) {
    launch_topk<16>(grid, threads, s, slab, count, origin, lane, A, F, K,
                    tile, inv_s, blur, znear);
  } else if (K <= 32) {
    launch_topk<32>(grid, threads, s, slab, count, origin, lane, A, F, K,
                    tile, inv_s, blur, znear);
  } else {
    launch_topk<kMaxK>(grid, threads, s, slab, count, origin, lane, A, F, K,
                       tile, inv_s, blur, znear);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
