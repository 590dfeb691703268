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
// Any tile: past 1024 pixels the forward splits a tile's rows over several
// blocks and the backward walks its pixels in chunks of 1024.

#include <cuda_runtime.h>

#include <cmath>

namespace {

// a forward block's pixels at most, and a backward pixel chunk's
constexpr int kMaxPixels = 1024;
constexpr int kChunk = 128;        // backward: candidates staged per pass
constexpr int kBwdThreads = 256;   // backward: 8 warps, a slot each at a time
constexpr int kBwdWarps = kBwdThreads / 32;

// The backward's per-face constants, hoisted out of the (pixel, face)
// loop: the divide happens once per face and edge, never per pair.
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

// Terms of one (pixel, face) pair that the backward's gradient reuses.
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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kFwdMaxGroups = 4; // slot groups per tile at most
constexpr int kFwdChunk = 128;   // candidates staged per shared-memory pass
constexpr int kFwdVec = 7;       // float4s of staged constants per face

// x = -(signed d2) / sigma below which a pair's term is exactly +0.0:
// exp(x) < exp(-104) < 2^-150, half the smallest subnormal float, so the
// softplus rounds to +0.0 in float32 (the plain version's term too).
constexpr float kCutoff = -104.0f;

// softplus_term's constants (scalars: device code may read a constexpr
// scalar, not an array). tests/test_torch_soft_fwd.py reads them, by name,
// from this file and repeats softplus_term's arithmetic on the CPU.
constexpr float kLog2e = 1.442695022e+00f;
constexpr float kRound = 12582912.0f;         // 1.5 * 2^23: rounds to integers
constexpr float kLn2Hi = 6.931457520e-01f;    // 15 significant bits
constexpr float kLn2Lo = 1.428606765e-06f;
// e^r = 1 + r + r^2 (kExpR0 + kExpR1 r + ... + kExpR4 r^4)
constexpr float kExpR0 = 4.999999404e-01f;
constexpr float kExpR1 = 1.666651964e-01f;
constexpr float kExpR2 = 4.166839272e-02f;
constexpr float kExpR3 = 8.368755691e-03f;
constexpr float kExpR4 = 1.381451730e-03f;
// log1p(e) = e + e^2 (kLog1pQ0 + kLog1pQ1 e + ... + kLog1pQ7 e^7)
constexpr float kLog1pQ0 = -4.999964833e-01f;
constexpr float kLog1pQ1 = 3.332132399e-01f;
constexpr float kLog1pQ2 = -2.485716343e-01f;
constexpr float kLog1pQ3 = 1.915365458e-01f;
constexpr float kLog1pQ4 = -1.375380009e-01f;
constexpr float kLog1pQ5 = 7.920450717e-02f;
constexpr float kLog1pQ6 = -3.006577305e-02f;
constexpr float kLog1pQ7 = 5.364818964e-03f;

// softplus(x) = max(x, 0) + log1p(e), e = exp(-|x|), for x >= kCutoff,
// every float32 operation written out (the _rn intrinsics are neither
// contracted nor reordered), so the CPU model repeats it bit for bit.
//  * e: with y = max(-|x|, kCutoff), j = rint(y log2(e)) by the rounding
//    constant, r = y - j ln2 in two steps (Cody-Waite: the first is exact),
//    e^r = 1 + r + r^2 R(r), R a degree-4 minimax fit on |r| <= 0.3468,
//    then e = (e^r 2^(j + 64)) 2^-64: j + 64 >= -86 keeps the first
//    product exact and normal, and the second rounds once, subnormal e
//    included. (For x > 104 the clamp leaves e < 2^-149, below half an
//    ulp of x.)
//  * log1p(e) = e + e^2 Q(e), Q a degree-7 fit of (log1p(e) - e) / e^2 on
//    [0, 1], minimax in the relative error of the sum.
// Error bound, from the CPU model's sweep of float32 x in [-104, 128]
// against the float64 softplus: at most 2.3 ulp where the result is a
// normal float, at most 0.83 of the smallest subnormal step where it is
// subnormal; the library's expf (2 ulp) followed by log1pf, which this
// replaces, allows about 3. The build keeps subnormals (no
// --use_fast_math), which the subnormal results and the cutoff rely on.
// 14 + 9 + 2 operations and no special-function unit, against a branchy
// log1pf with a division on top of expf.
__device__ __forceinline__ float softplus_term(float x) {
  const float y = fmaxf(-fabsf(x), kCutoff);
  const float t = __fmaf_rn(y, kLog2e, kRound);   // 1.5 * 2^23 + j exactly
  const float j = __fadd_rn(t, -kRound);
  float r = __fmaf_rn(j, -kLn2Hi, y);
  r = __fmaf_rn(j, -kLn2Lo, r);
  float h = __fmaf_rn(kExpR4, r, kExpR3);
  h = __fmaf_rn(h, r, kExpR2);
  h = __fmaf_rn(h, r, kExpR1);
  h = __fmaf_rn(h, r, kExpR0);
  h = __fmaf_rn(h, r, 1.0f);
  const float er = __fmaf_rn(h, r, 1.0f);
  const float scale =   // 2^(j + 64): j sits in t's low mantissa bits
      __int_as_float((__float_as_int(t) - __float_as_int(kRound) + 191) << 23);
  const float e = __fmul_rn(__fmul_rn(er, scale), 0x1p-64f);
  float qe = __fmaf_rn(kLog1pQ7, e, kLog1pQ6);
  qe = __fmaf_rn(qe, e, kLog1pQ5);
  qe = __fmaf_rn(qe, e, kLog1pQ4);
  qe = __fmaf_rn(qe, e, kLog1pQ3);
  qe = __fmaf_rn(qe, e, kLog1pQ2);
  qe = __fmaf_rn(qe, e, kLog1pQ1);
  qe = __fmaf_rn(qe, e, kLog1pQ0);
  const float l = __fmaf_rn(__fmul_rn(qe, e), e, e);
  return __fadd_rn(fmaxf(x, 0.0f), l);
}

// A face's forward constants, kFwdVec float4s in shared memory, so a pair
// reads them as 16-byte broadcasts. For edge e from corner a = e to
// b = (e + 1) % 3, g = b - a, len2 = max(|g|^2, 1e-12), and s = 2 sign(area2)
// (0 for a degenerate face, which covers every pixel: its edge functions
// are all 0, so it is inside everywhere, as in the backward's test
// (cross * area2 >= 0) and the plain version's):
//   v[2e]     = (ax, ay, 2 gx, 2 gy)
//   v[2e + 1] = (0.5 / len2, len2, s gx, s gy)
//   v[6]      = the cull box (x0, x1, y0, y1)
// With w = p - a, 2 w.g is one product and one FMA, t = clamp(w.g / len2)
// one product (exactly the plain form's t), and the orientation-signed
// edge function one product and one FMA.
//
// The cull box is the face's bounding box grown by a margin M past which
// every pixel's computed x lies below kCutoff: M is the top-K kernel's
// (cull_box in hard_raster.cu, where it is argued) with sqrt(blur)
// replaced by r_cut = sqrt(104.5 sigma):
//   M = 1.001 (1.002 r_cut + 4e-3 L + 40 eps L^3 / A) + 4 eps C,
// eps = 2^-24, L the longest edge, A = |area2|, C the largest |corner
// coordinate|, and no cull (M = inf) where A <= 4e-12 or A < 64 eps L^2.
// For a pixel at distance D >= M from the face, that argument gives a
// computed edge function of the wrong sign for some edge (so not inside)
// and a computed clamped distance of at least D^2 - 10 eps (D + 2L)^2 >=
// r_cut^2 for every edge: its error terms are the top-K form's (w and g
// rounded once each, two products and a sum for |w|^2 and 2 w.g, and the
// two FMAs of dd = |w|^2 + t (t len2 - 2 w.g) add at most 2 eps (D + 2L)^2
// more, under the 10 eps there). Then x <= -(104.5 sigma (1 - 2 eps)) /
// sigma < -104. A NaN box culls nothing. (A table of (face, warp) cull
// bits built after staging, with a test against each edge's line as well,
// culled more pairs but made the kernel slower on the card: PERF.md.)
__device__ __forceinline__ void stage_face(const float* __restrict__ q6,
                                           float r_cut,
                                           float4* __restrict__ v) {
  constexpr float kEps = 5.9604645e-08f;   // 2^-24
  const float x[3] = {q6[0], q6[2], q6[4]};
  const float y[3] = {q6[1], q6[3], q6[5]};
  // the plain version's area2, operation for operation
  const float area2 =
      __fsub_rn(__fmul_rn(__fsub_rn(x[1], x[0]), __fsub_rn(y[2], y[0])),
                __fmul_rn(__fsub_rn(y[1], y[0]), __fsub_rn(x[2], x[0])));
  const float s = area2 > 0.0f ? 2.0f : (area2 < 0.0f ? -2.0f : 0.0f);
  float L2 = 0.0f, C = 0.0f;
  float x0 = x[0], x1 = x[0], y0 = y[0], y1 = y[0];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int b = (e + 1) % 3;
    const float gx = __fsub_rn(x[b], x[e]);
    const float gy = __fsub_rn(y[b], y[e]);
    const float len2 =
        fmaxf(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), 1e-12f);
    v[2 * e] = make_float4(x[e], y[e], 2.0f * gx, 2.0f * gy);
    v[2 * e + 1] = make_float4(__fdiv_rn(0.5f, len2), len2, s * gx, s * gy);
    L2 = fmaxf(L2, len2);
    C = fmaxf(C, fmaxf(fabsf(x[e]), fabsf(y[e])));
    x0 = fminf(x0, x[e]);
    x1 = fmaxf(x1, x[e]);
    y0 = fminf(y0, y[e]);
    y1 = fmaxf(y1, y[e]);
  }
  const float area = fabsf(area2);
  float M = __int_as_float(0x7f800000);    // +inf: no cull
  if (area > 4e-12f && area >= 64.0f * kEps * L2) {
    const float L = sqrtf(L2);
    M = 1.001f * (r_cut * 1.002f + 4e-3f * L + 40.0f * kEps * L * L2 / area)
        + 4.0f * kEps * C;
  }
  v[6] = make_float4(x0 - M, x1 + M, y0 - M, y1 + M);
}

// x = -(signed d2) / sigma of pixel (px, py) against a staged face: the
// plain version's clamped point-to-segment distances, their minimum and
// the inside test, from the staged constants.
__device__ __forceinline__ float pair_x(const float4* __restrict__ v,
                                        float px, float py,
                                        float inv_sigma) {
  float d2 = __int_as_float(0x7f800000);
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float4 a = v[2 * e];
    const float4 c = v[2 * e + 1];
    const float wx = __fsub_rn(px, a.x);
    const float wy = __fsub_rn(py, a.y);
    const float ww = __fmaf_rn(wx, wx, __fmul_rn(wy, wy));
    const float wg2 = __fmaf_rn(wx, a.z, __fmul_rn(wy, a.w));
    const float t = __saturatef(__fmul_rn(wg2, c.x));
    d2 = fminf(d2, __fmaf_rn(t, __fmaf_rn(t, c.y, -wg2), ww));
    inside = inside && __fmaf_rn(c.z, wy, -__fmul_rn(c.w, wx)) >= 0.0f;
  }
  // clamping the minimum is clamping each edge first
  return __fmul_rn(fmaxf(d2, 0.0f), inside ? inv_sigma : -inv_sigma);
}

// The pixel (column, row) of thread tid of a slot group, in a block's
// rectangle of cols x rows pixels, and the box of its warp's pixels
// (columns c0..c1, rows r0..r1). Where cols is a multiple of 8 and rows of
// 4, a warp holds an 8-column by 4-row block of pixels: a squarer box than
// two rows of 16, so more faces lie wholly outside it for the cull; else
// threads take pixels in row-major order.
__device__ __forceinline__ void fwd_pixel(int tid, int cols, int rows,
                                          int& col, int& row, int& c0,
                                          int& c1, int& r0, int& r1) {
  const int w = tid >> 5;
  if ((cols & 7) == 0 && (rows & 3) == 0) {
    const int across = cols / 8;
    c0 = (w % across) * 8;
    r0 = (w / across) * 4;
    col = c0 + (tid & 7);
    row = r0 + ((tid & 31) >> 3);
    c1 = c0 + 7;
    r1 = r0 + 3;
    return;
  }
  const int np = cols * rows;
  const int lo = 32 * w, hi = min(32 * w + 31, np - 1);
  col = tid % cols;
  row = tid / cols;
  r0 = lo / cols;
  r1 = hi / cols;
  c0 = r0 == r1 ? lo % cols : 0;
  c1 = r0 == r1 ? hi % cols : cols - 1;
}

// Slot groups per tile: G groups of tile^2 threads share a tile's block,
// group g taking slots g, g + G, ... of each chunk. A tile's candidates
// are a serial chain of about 90 instructions each per thread; where few
// tiles share the card (the pose fit's 64) that chain, not the card's
// issue rate, sets the time, and groups split it. Where tiles are many,
// larger blocks fit fewer to an SM and leave a longer tail. So a launch
// takes the most groups, up to kFwdMaxGroups within a 1024-thread block,
// that keep its warps within two waves of the card's warp slots (64 an
// SM): 4 for the pose fit's 64 tiles, 2 for the bench's 1024. Where
// tile^2 is not a multiple of 32 (tile not a multiple of 8) a warp would
// span two groups: one group. G sets the order in which a pixel's terms
// are summed, and G follows the launch's tile count and the card's SM
// count: the same view's S may differ in its last bits between launches of
// different batch sizes, or between cards (each within the plain version's
// tolerance). One launch shape on one card gives the same bits every run.
int fwd_groups(int tile, long long tiles, int sms) {
  if (tile % 8 || tile * tile > kMaxPixels) return 1;
  const long long warps = (long long)tile * tile / 32;   // per group
  int G = 1;
  while (2 * G <= kFwdMaxGroups && 2 * G * tile * tile <= kMaxPixels &&
         tiles * 2 * G * warps <= 2LL * 64 * sms) {
    G *= 2;
  }
  return G;
}

// The SM count of a device into *sms, read once; returns a CUDA error.
int sm_count(int device, int* sms) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device]) {
    *sms = cached[device];
    return 0;
  }
  const int err = (int)cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device);
  if (!err && device >= 0 && device < 64) cached[device] = *sms;
  return err;
}

// The block plan of a forward launch: a block holds a rectangle of cols x
// rows pixels of a tile, P of them cover it. Up to kMaxPixels pixels, the
// whole tile (P = 1, slot groups by fwd_groups); past it, one group and
// blocks of up to kMaxPixels pixels: whole rows (a multiple of 4 of them
// where tile is a multiple of 8, for the warps' 8 x 4 boxes) up to 1024
// columns, a part of a row beyond.
void fwd_plan(int tile, int* cols, int* rows, int* P) {
  if (tile * tile <= kMaxPixels) {
    *cols = *rows = tile;
    *P = 1;
    return;
  }
  const int c = min(tile, kMaxPixels);
  int r = min(tile, max(1, kMaxPixels / c));
  if (c % 8 == 0 && r >= 4) r -= r % 4;
  *cols = c;
  *rows = r;
  *P = ((tile + c - 1) / c) * ((tile + r - 1) / r);
}

// Replaces torch_renderer_tpu/rasterize/pallas_soft.py _fwd_kernel_packed
// (bench route) and _fwd_kernel (lane route).
// Bound: arithmetic. Each live (pixel, face) pair costs its three clamped
// edge distances, the inside test and a softplus, and a tile reads only
// K * 24 bytes of corners for tile^2 * K pairs, so device memory is never
// the limit. Design: one block per active tile (P = gridDim.z blocks of
// whole rows past 1024 pixels, fwd_plan: 4 blocks of 16 rows at tile 64,
// each staging the tile's faces and writing its own rows), a thread per
// pixel in each of G slot groups (fwd_groups); the tile's candidates
// stream through shared memory in chunks of kFwdChunk with their per-pair
// constants folded at staging (stage_face), read as float4 broadcasts, so
// a pair is about 45 operations of edge math and 25 of softplus
// (softplus_term) with no special-function unit. A warp skips a face whose
// cull box its pixels' box misses (uniform across the warp), and a pixel
// skips the softplus of a pair below kCutoff (it saves time where a whole
// warp agrees; the two skip about a third of the bench slab's live pairs,
// as tests/test_torch_soft_fwd.py counts them). Each skipped term is
// exactly +0.0, so a group's sum is the one over its slots in slot order,
// bit for bit; group 0 adds the other groups' sums in group order through
// shared memory (no atomics: the result does not depend on scheduling). The
// trip count is the tile's own candidate count: empty and thin tiles cost
// almost nothing.
__global__ void __launch_bounds__(kMaxPixels)
soft_coverage_fwd_kernel(const float* __restrict__ q,
                         const int* __restrict__ count,
                         float* __restrict__ S, int A, int K, int tile,
                         int cols, int rows, float inv_s, float inv_sigma,
                         float r_cut) {
  __shared__ float4 faces[kFwdChunk * kFwdVec];
  __shared__ float part[kMaxPixels];
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], K));
  const int tp = tile * tile;
  const int np = cols * rows;              // the block's pixels
  const int G = blockDim.x / np;           // np threads a group (launcher)
  const int g = threadIdx.x / np;
  const int tid = threadIdx.x - g * np;
  int col, row, c0, c1, r0, r1;
  fwd_pixel(tid, cols, rows, col, row, c0, c1, r0, r1);
  {   // the block's rectangle of the tile (pixels past it are computed and
      // not written)
    const int across = (tile + cols - 1) / cols;
    const int x0 = (blockIdx.z % across) * cols;
    const int y0 = (blockIdx.z / across) * rows;
    col += x0;
    c0 += x0;
    c1 += x0;
    row += y0;
    r0 += y0;
    r1 += y0;
  }
  const float px = (float)col * inv_s, py = (float)row * inv_s;
  const float bx0 = (float)c0 * inv_s, bx1 = (float)c1 * inv_s;
  const float by0 = (float)r0 * inv_s, by1 = (float)r1 * inv_s;
  const float* qt = q + cell * K * 6;

  float acc = 0.0f;
  for (int c = 0; c < n; c += kFwdChunk) {   // n is uniform in the block
    const int m = min(kFwdChunk, n - c);
    __syncthreads();                         // previous chunk consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      stage_face(qt + (long)(c + i) * 6, r_cut, &faces[i * kFwdVec]);
    }
    __syncthreads();
    for (int i = g; i < m; i += G) {
      const float4* v = &faces[i * kFwdVec];
      const float4 box = v[6];
      // uniform in the warp; comparisons with NaN are false: no cull
      if (bx1 < box.x || bx0 > box.y || by1 < box.z || by0 > box.w) {
        continue;
      }
      const float x = pair_x(v, px, py, inv_sigma);
      if (!(x < kCutoff)) acc = __fadd_rn(acc, softplus_term(x));
    }
  }
  if (g > 0) part[(g - 1) * np + tid] = acc;
  __syncthreads();
  if (g == 0 && row < tile && col < tile) {
    for (int h = 1; h < G; ++h) acc = __fadd_rn(acc, part[(h - 1) * np + tid]);
    S[cell * tp + row * tile + col] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

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
// CHUNKED (past 1024 pixels, tile 64: 4096): the tile's pixels are staged
// and walked in chunks of kMaxPixels for each chunk of slots; each face's
// partials of a pixel chunk are added, in chunk order, to its sums in
// shared memory by the warp that owns the face, and its row is written
// once, after the last pixel chunk. Up to 1024 pixels the instance without
// it runs the tile as one chunk, as before.
// The per-pixel product form replaces the TPU's moment form, which existed
// to save vector ops on that chip; both give the same gradient. The scatter
// from slots back to faces is not here: it is the gather kernel's backward.
template <bool CHUNKED>
__global__ void __launch_bounds__(kBwdThreads)
soft_coverage_bwd_kernel(const float* __restrict__ q,
                         const int* __restrict__ count,
                         const float* __restrict__ g,
                         float* __restrict__ dq, int A, int K, int tile,
                         float inv_s, float inv_sigma) {
  __shared__ float g_s[kMaxPixels], px_s[kMaxPixels], py_s[kMaxPixels];
  __shared__ Face faces[kChunk];
  __shared__ float sums[kChunk * 6];         // past one pixel chunk
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], K));
  const int tp = tile * tile;
  const int chunks = CHUNKED ? (tp + kMaxPixels - 1) / kMaxPixels : 1;
  // a chunk's pixels p0 .. p0 + np - 1 into shared memory
  const auto stage_pixels = [&](int p0, int np) {
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      const int p = p0 + i;
      g_s[i] = g[cell * tp + p];
      px_s[i] = (float)(p % tile) * inv_s;
      py_s[i] = (float)(p / tile) * inv_s;
    }
  };
  if (!CHUNKED) stage_pixels(0, tp);
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
    for (int k = 0; k < chunks; ++k) {
      const int p0 = k * kMaxPixels, np = min(kMaxPixels, tp - p0);
      if (CHUNKED) {
        __syncthreads();                      // the last chunk's pixels read
        stage_pixels(p0, np);
      }
      __syncthreads();                        // faces, pixels published
      for (int i = warp; i < m; i += kBwdWarps) {
        const Face f = faces[i];
        float out[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int p = lane; p < np; p += 32) {
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
          float* row = CHUNKED ? sums + i * 6 : dqt + (long)(c0 + i) * 6;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            row[c] = (!CHUNKED || k == 0) ? out[c] : row[c] + out[c];
          }
        }
      }
    }
    if (CHUNKED) {   // each face's sums over the pixel chunks, once
      __syncthreads();
      for (int i = threadIdx.x; i < m * 6; i += blockDim.x) {
        dqt[(long)c0 * 6 + i] = sums[i];
      }
    }
  }
}

// Any tile whose pixel count is an int.
int check_shape(int B, int A, int K, int tile) {
  if (B <= 0 || B > 65535 || A <= 0 || K <= 0 || tile <= 0 ||
      (long long)tile * tile > 0x7fffffffLL) {
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
  // the cull's r_cut = sqrt(104.5 sigma), in double
  const float r_cut = (float)sqrt(104.5 / (double)inv_sigma);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err) return err;
  int cols = 0, rows = 0, P = 0;
  fwd_plan(tile, &cols, &rows, &P);
  const int threads = fwd_groups(tile, (long long)A * B, sms) * cols * rows;
  soft_coverage_fwd_kernel<<<dim3(A, B, P), threads, 0,
                             (cudaStream_t)stream>>>(
      q, count, S, A, K, tile, cols, rows, inv_s, inv_sigma, r_cut);
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
  if (tile * tile > kMaxPixels) {
    soft_coverage_bwd_kernel<true><<<dim3(A, B), kBwdThreads, 0,
                                     (cudaStream_t)stream>>>(
        q, count, g, dq, A, K, tile, inv_s, inv_sigma);
  } else {
    soft_coverage_bwd_kernel<false><<<dim3(A, B), kBwdThreads, 0,
                                      (cudaStream_t)stream>>>(
        q, count, g, dq, A, K, tile, inv_s, inv_sigma);
  }
  return (int)cudaGetLastError();
}

const char* trt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
