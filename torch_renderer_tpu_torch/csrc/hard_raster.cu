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
// is above znear. Ties keep the earlier slot: each thread group visits its
// share of the slots in ascending order with strict < (a stable insertion
// for top-K), and the groups merge in (zsel, slot) order.
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
// Any tile and any K: a tile's pixels split over as many blocks as the
// launch plans need, and the top-K lists move to device memory where not
// even one warp's fit in shared memory.

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

constexpr int kMaxPixels = 1024;   // threads of a block at most
constexpr int kChunk = 256;        // candidates staged per shared-memory pass
constexpr int kListPixels = 256;   // top-K block pixels, lists in device memory
constexpr int kK1Chunk = 128;      // the same for hard_k1
constexpr int kK1BlockPixels = 128;  // a hard_k1 block's pixels at most
constexpr int kK1MaxGroups = 4;    // and its thread groups per pixel
constexpr int kChannels = 13;
constexpr float kEmptyDist = 1e10f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Per-face values that do not depend on the pixel.
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

// A Face as staged in shared memory: five float4s, so that a warp reads a
// staged face with five broadcast 16-byte loads (four at blur 0, where the
// edge lengths are not read), not nineteen of 4 bytes: the scan's loads of
// shared memory, not its arithmetic, set its pace otherwise.
struct __align__(16) FaceS {
  float4 a;   // qx0 qy0 qx1 qy1
  float4 b;   // qx2 qy2 gx0 gy0
  float4 c;   // gx1 gy1 gx2 gy2
  float4 d;   // inv_area invz0 invz1 invz2
  float4 e;   // len2_0 len2_1 len2_2 -
};

__device__ __forceinline__ FaceS pack(const Face& f) {
  return {make_float4(f.qx[0], f.qy[0], f.qx[1], f.qy[1]),
          make_float4(f.qx[2], f.qy[2], f.gx[0], f.gy[0]),
          make_float4(f.gx[1], f.gy[1], f.gx[2], f.gy[2]),
          make_float4(f.inv_area, f.invz[0], f.invz[1], f.invz[2]),
          make_float4(f.len2[0], f.len2[1], f.len2[2], 0.0f)};
}

__device__ __forceinline__ Face unpack(const FaceS& s) {
  const float4 a = s.a, b = s.b, c = s.c, d = s.d, e = s.e;
  return {{a.x, a.z, b.x}, {a.y, a.w, b.y}, {d.y, d.z, d.w},
          {b.z, c.x, c.z}, {b.w, c.y, c.w}, {e.x, e.y, e.z}, d.x};
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

// Selection priority: zsel where the face covers the pixel, kInf elsewhere
// (zsel, and its divide, only for a covering pair: most pairs miss).
__device__ __forceinline__ float priority(const Face& f, float px, float py,
                                          float blur, float znear) {
  float wx[3], wy[3], b[3];
  bary(f, px, py, wx, wy, b);
  const bool inside = b[0] >= 0.0f && b[1] >= 0.0f && b[2] >= 0.0f;
  bool cover = inside;
  if (blur > 0.0f && !inside) cover = edge_dist2(f, wx, wy) < blur;
  if (!cover) return kInf;
  const float r0 = fmaxf(b[0], 0.0f), r1 = fmaxf(b[1], 0.0f),
              r2 = fmaxf(b[2], 0.0f);
  const float den = fmaxf(
      add(add(mul(r0, f.invz[0]), mul(r1, f.invz[1])), mul(r2, f.invz[2])),
      1e-12f);
  const float zsel = dvd(add(add(r0, r1), r2), den);
  return zsel > znear ? zsel : kInf;
}

// The cull box of a staged face (both kernels): its screen bounding box
// grown by a margin M past which no pixel can be covered, so a warp none of
// whose pixels lies in the box skips the face and loses no winner (each
// skipped pair would have had priority kInf). With eps = 2^-24, L the
// longest edge (sqrt of the largest len2), A = |area2| and C the largest
// |corner coordinate|:
//   M = 1.001 * (sqrt(blur) * 1.002 + 4e-3 * L + 40 * eps * L^3 / A)
//       + 4 * eps * C,
// and no cull (M = inf) when A <= 4e-12 or A < 64 * eps * L^2, where the
// computed orientation is not to be trusted. Why this is conservative for a
// pixel P at distance D >= M - (the box's rounding) from the face:
//  * inside: P lies outside some edge line by h >= D sin(theta_min / 2)
//    >= D * A / (2 L^2) (in the region of a corner, the outward normals of
//    its edges span the angle pi - theta). The computed edge function of
//    that edge differs from the exact |g| h by at most 4.0001 eps |g| |w|
//    (w, g rounded once each, two products and a difference), with |w| <=
//    D + L, and the computed area2 is within 4 eps L^2 of the exact one,
//    so its sign is right once A >= 64 eps L^2. Then the edge function
//    keeps its sign, and inside is false, once D >= 10 eps L^3 / A.
//  * blur band: the computed clamped segment distance, however t rounds
//    within [0, 1], is at least D^2 - 10 eps (D + 2L)^2 (w and g rounded
//    once each, then an expanded square), which is >= blur once
//    D >= sqrt(blur) (1 + 2a) + 4aL with a = sqrt(10 eps) < 7.8e-4.
//  * the box: 1.001 covers the rounding of M itself, and 4 eps C that of
//    the corner coordinates minus M.
// Both kernels stage the box with each face, and a warp skips a face whose
// box lies wholly above, below, left or right of the box of its pixels
// (the warp's pixel span). A NaN box culls nothing (its comparisons are
// false), and neither does a NaN tile origin; a NaN pixel is covered by no
// face. tests/test_torch_topk_split.py cull_boxes copies this formula for
// the CPU models of both kernels.
__device__ __forceinline__ float grid_at(float o, int r, float inv_s) {
  return add(o, mul((float)r, inv_s));
}

// Whether box b (x0, x1, y0, y1) may cover a pixel of the span (x0, x1,
// y0, y1): false only when it lies wholly to one side.
__device__ __forceinline__ bool box_meets(float4 b, float4 w) {
  return !(w.w < b.z || w.z > b.w || w.y < b.x || w.x > b.y);
}

// The grown box (x0, x1, y0, y1) of a face: infinite without a cull, NaN
// for a NaN corner.
__device__ __forceinline__ float4 cull_box(const Face& f, float sqrt_blur) {
  constexpr float kEps = 5.9604645e-08f;   // 2^-24
  const float L2 = fmaxf(fmaxf(f.len2[0], f.len2[1]), f.len2[2]);
  const float L = sqrtf(L2);
  // area2 as load_face computes it (inv_area is 1 for a tiny area2)
  const float area = fabsf(
      sub(mul(sub(f.qx[1], f.qx[0]), sub(f.qy[2], f.qy[0])),
          mul(sub(f.qy[1], f.qy[0]), sub(f.qx[2], f.qx[0]))));
  float C = 0.0f;
  float x0 = f.qx[0], x1 = f.qx[0], y0 = f.qy[0], y1 = f.qy[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    C = fmaxf(C, fmaxf(fabsf(f.qx[k]), fabsf(f.qy[k])));
    x0 = fminf(x0, f.qx[k]);
    x1 = fmaxf(x1, f.qx[k]);
    y0 = fminf(y0, f.qy[k]);
    y1 = fmaxf(y1, f.qy[k]);
  }
  float M = __int_as_float(0x7f800000);   // +inf: no cull
  if (area > 4e-12f && area >= 64.0f * kEps * L2) {
    M = 1.001f * (sqrt_blur * 1.002f + 4e-3f * L + 40.0f * kEps * L * L2 / area)
        + 4.0f * kEps * C;
  }
  return make_float4(x0 - M, x1 + M, y0 - M, y1 + M);
}

constexpr int kStageBytes = kChunk * (int)(sizeof(float4) + sizeof(FaceS));

// The warp-uniform cull and the scan of one group's share of the tile's
// candidates; returns with the list filled. The block's groups each hold
// np pixels of the tile, from pixel pb on.
__device__ __forceinline__ void topk_scan(
    const float* __restrict__ st, int n, int S, int grp, int np, int pb,
    int tile, float ox, float oy, float px, float py, float inv_s,
    float blur, float znear, float4* boxes, FaceS* faces, TopkList& list) {
  // This warp's pixel span (x0, x1, y0, y1): its rows, and its columns
  // where it holds part of one row; the whole tile when it spans two
  // groups.
  float4 span;
  {
    const int t0 = threadIdx.x & ~31;
    const int t1 = min(t0 + 31, (int)blockDim.x - 1);
    int c_lo = 0, c_hi = tile - 1, r_lo = 0, r_hi = tile - 1;
    if (t0 / np == t1 / np) {
      // a block's threads past the tile's last pixel hold no row (the
      // first of a warp always holds one)
      const int p0 = pb + t0 % np, p1 = min(pb + t1 % np, tile * tile - 1);
      r_lo = p0 / tile;
      r_hi = p1 / tile;
      if (r_lo == r_hi) {
        c_lo = p0 % tile;
        c_hi = p1 % tile;
      }
    }
    span = make_float4(grid_at(ox, c_lo, inv_s), grid_at(ox, c_hi, inv_s),
                       grid_at(oy, r_lo, inv_s), grid_at(oy, r_hi, inv_s));
  }
  const float sqrt_blur = sqrtf(fmaxf(blur, 0.0f));
  for (int c0 = 0; c0 < n; c0 += kChunk) {   // n is uniform in the block
    const int m = min(kChunk, n - c0);
    __syncthreads();                             // previous chunk consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      Face f;
      load_face(st + (long)(c0 + i) * kChannels, f);
      faces[i] = pack(f);
      boxes[i] = cull_box(f, sqrt_blur);
    }
    __syncthreads();
    for (int i = grp; i < m; i += S) {
      if (!box_meets(boxes[i], span)) continue;  // one face for the warp
      const float cz = priority(unpack(faces[i]), px, py, blur, znear);
      if (cz < list.kth) list.push<false>(cz, c0 + i);
    }
  }
}

// Replaces torch_renderer_tpu/rasterize/pallas_hard.py _topk_select_kernel
// (reached through _tile_topk_reinterp).
// Bound: arithmetic (a priority per (pixel, candidate) pair, four IEEE
// divides in the blur band) and latency: a level-4 face covers a few of a
// tile's pixels, so almost every pair is a miss, and one thread per pixel
// walking every candidate leaves most of the SM idle. Design, per block =
// (batch, active tile, a share of its pixels):
//  * S thread groups per pixel: the largest power of two with S * np <=
//    1024 whose lists fit in shared memory (4 at tile 16 for K <= 16, 2
//    for K = 50, 1 at tile 32). Where a tile has more than 1024 pixels or
//    even one group's lists do not fit (tile 32 with K > 25, tile 64), P
//    blocks (gridDim.z) share the tile, each with np = tile^2 / P of its
//    pixels. The tile's candidates stream through shared memory in chunks
//    with their per-face constants and cull boxes; group s takes chunk
//    entries s, s + S, ... (ascending slot order within a group, balanced
//    shares) and keeps its sorted list of K (zsel, slot) entries in shared
//    memory (TopkList): no list in registers, so nothing spills, and the
//    list is only touched by a candidate that beats the K-th entry (kept
//    in a register).
//  * DEVICE_LISTS (where not even one warp's lists fit in shared memory,
//    K > 812): one group, blocks of kListPixels pixels, and each pixel's
//    list in device memory: its slots in the output column the kernel
//    writes anyway, its depths in the wrapper's scratch of that layout.
//    The same scan and insertion; a push costs device-memory traffic.
//  * Warp-uniform cull: a warp's threads share a group, and their pixels
//    some rows of the tile (two full rows at tile 16, one at tile 32, half
//    of one at tile 64); the warp skips a face whose grown box (cull_box)
//    lies wholly to one side of its pixel span, without evaluating it.
//  * Merge: a tree over the groups: at each level each group of the lower
//    half inserts its partner's entries in (zsel, slot) lexicographic
//    order, stopping at the first that does not enter. That order is the
//    one the stable sequential insertion produces, so the K winners are the
//    same; group 0 writes them.
// The TPU kernel's K extraction passes over a (pixel, face) priority slab
// become this one pass.
template <bool DEVICE_LISTS>
__global__ void __launch_bounds__(kMaxPixels)
topk_select_kernel(const float* __restrict__ slab,
                   const int* __restrict__ count,
                   const float* __restrict__ origin, int* __restrict__ lane,
                   float* __restrict__ zs, int A, int F, int K, int tile,
                   float inv_s, float blur, float znear) {
  extern __shared__ float4 smem[];   // staging, then each thread's list
  float4* boxes = smem;
  FaceS* faces = reinterpret_cast<FaceS*>(boxes + kChunk);
  const int nt = blockDim.x;
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], F));
  const int tp = tile * tile;
  const int np = (tp + gridDim.z - 1) / gridDim.z;   // this block's pixels
  const int pb = blockIdx.z * np;
  const int S = nt / np;
  const int t = threadIdx.x;
  const int grp = t / np, p = pb + t % np;
  const float ox = origin[2 * cell], oy = origin[2 * cell + 1];
  TopkList list;
  if (DEVICE_LISTS) {
    const long at = cell * K * tp + min(p, tp - 1);
    list = TopkList{zs + at, lane + at, tp, K};
    if (p < tp) {
      list.init();
    } else {
      list.close();
    }
  } else {
    float* zl = reinterpret_cast<float*>(
        reinterpret_cast<char*>(smem) + kStageBytes);
    list = TopkList{zl + t, reinterpret_cast<int*>(zl + nt * K) + t, nt, K};
    list.init();
  }
  topk_scan(slab + cell * F * kChannels, n, S, grp, np, pb, tile, ox, oy,
            grid_at(ox, p % tile, inv_s), grid_at(oy, p / tile, inv_s),
            inv_s, blur, znear, boxes, faces, list);
  merge_groups(list, S, grp, np);   // tree merge of the S groups' lists
  // device lists are the output already
  if (DEVICE_LISTS || grp != 0 || p >= tp) return;
  int* o = lane + cell * K * tp + p;
  for (int j = 0; j < K; ++j) o[(long)j * tp] = list.slot(j);
}

// Replaces torch_renderer_tpu/rasterize/pallas_hard.py _hard_kernel (reached
// through _tile_hard_fwd; _tile_select_packed is routed here).
// Bound: latency and issue; device memory only at the depth call's size. A
// tile reads F * 52 bytes of candidates and writes 8 rows of tile^2
// floats; a live pair costs ~35 operations, and only the pairs whose pixel
// lies near the face need them. At the pose fit's 64 tiles a block's fixed
// latency (the tile's loads, its staging, barriers, the epilogue) and the
// serial work of the busiest tile set the time; at the depth call's 4032
// tiles of 32^2 the instructions of the (pixel, face) tests and of the
// epilogue do, against a bound of its 8 output rows (132 MB).
// Design, per block = (batch, active tile, rows of the tile):
//  * Threads are (column, row, group): blockDim = (C, R, S) with C = tile
//    up to 1024 columns, so a thread finds its pixel and group with no
//    division (WIDE, past 1024 columns: C = 1024 and rows_groups_pixel).
//    P = gridDim.z blocks of R rows share a tile, with S thread groups per
//    pixel (k1_plan): blocks of at most kK1BlockPixels pixels (two rows of
//    64 at tile 64, one row past 128 columns), split further
//    while the launch has fewer blocks than the card has SMs (the busiest
//    tile's work then spreads over several SMs), then the most groups that
//    keep every block resident at once.
//  * Staging: the chunk's live slab rows, contiguous in device memory, are
//    copied into shared memory by all threads at once (cp.async, every
//    copy in flight together); then each row becomes a packed face (FaceS)
//    and its grown box (cull_box, as topk_select stages it).
//  * Scan: group s takes chunk entries s, s + S, ... in ascending slot
//    order. A warp's lanes first test as many of its entries at once
//    against the warp's pixel span (a face whose box lies wholly above,
//    below, left or right of every pixel of the warp covers none: its
//    priority would be kInf); a ballot gives the warp the faces it must
//    evaluate, in slot order, so a skipped face costs nothing. Each thread
//    keeps (zsel, slot) in registers; strict < keeps a group's lowest slot
//    among equal zsel.
//  * Merge: group 0 takes the (zsel, slot) lexicographic minimum over the
//    groups through shared memory: the lowest slot among the lowest zsel,
//    as one pass in slot order finds.
//  * Epilogue: group 0 interpolates the winner from its staged face and
//    slab row where the last chunk holds it (always when the count is at
//    most kK1Chunk), else from device memory, and writes the 8 rows (a
//    warp's pixels are neighbours in each row).
// Winners and values equal hard_k1_reference bit for bit: the same _rn
// arithmetic, and the same winner.
template <bool WIDE>
__global__ void __launch_bounds__(kMaxPixels)
hard_k1_kernel(const float* __restrict__ slab, const int* __restrict__ count,
               const float* __restrict__ origin, float* __restrict__ out,
               int A, int F, int tile, float inv_s, float blur, float znear,
               int clip_bary) {
  __shared__ float raw[kK1Chunk * kChannels];  // the chunk's slab rows
  __shared__ FaceS faces[kK1Chunk];
  __shared__ float4 boxes[kK1Chunk];         // x0 x1 y0 y1, grown
  extern __shared__ float4 k1_merge[];       // the groups' entries (S > 1)
  const int np = blockDim.x * blockDim.y;    // the block's pixels
  const int nt = np * blockDim.z;            // the block's threads
  const int t = threadIdx.x
      + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int grp = threadIdx.z;
  // a thread past the tile's last row or column (where a block overhangs
  // it) holds no pixel: its span grows the warp's, and it writes nothing
  int col = threadIdx.x, row = blockIdx.z * blockDim.y + threadIdx.y;
  if (WIDE) rows_groups_pixel(tile, col, row);
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const float* st = slab + cell * F * kChannels;
  const int n = max(0, min(count[cell], F));
  const float ox = origin[2 * cell], oy = origin[2 * cell + 1];
  const float px = grid_at(ox, col, inv_s);
  const float py = grid_at(oy, row, inv_s);
  const float sqrt_blur = sqrtf(fmaxf(blur, 0.0f));
  // This warp's pixel span: the box of its threads' rows and columns (the
  // launcher keeps a warp within one group).
  const int nl = min(32, nt - (t & ~31));    // the warp's threads
  const unsigned lanes = nl == 32 ? 0xffffffffu : (1u << nl) - 1u;
  const float wy0 = grid_at(oy, __reduce_min_sync(lanes, row), inv_s);
  const float wy1 = grid_at(oy, __reduce_max_sync(lanes, row), inv_s);
  const float wx0 = grid_at(ox, __reduce_min_sync(lanes, col), inv_s);
  const float wx1 = grid_at(ox, __reduce_max_sync(lanes, col), inv_s);
  float best = kInf;
  int lane = 0;
  for (int c0 = 0; c0 < n; c0 += kK1Chunk) {   // n is uniform in the block
    const int m = min(kK1Chunk, n - c0);     // live entries of the chunk
    if (c0) __syncthreads();                 // previous chunk consumed
    copy_rows(st + (long)c0 * kChannels, raw, t, m * kChannels, nt);
    copy_wait();
    __syncthreads();
    for (int i = t; i < m; i += nt) {
      Face f;
      load_face(raw + i * kChannels, f);
      faces[i] = pack(f);
      boxes[i] = cull_box(f, sqrt_blur);
    }
    __syncthreads();
    for (int k0 = grp; k0 < m; k0 += nl * (int)blockDim.z) {
      // lane j tests entry k0 + j * S against the warp's pixel span
      const int i = k0 + (t & 31) * blockDim.z;
      bool keep = false;
      if (i < m) {
        const float4 b = boxes[i];
        keep = !(wy1 < b.z || wy0 > b.w || wx1 < b.x || wx0 > b.y);
      }
      for (unsigned todo = __ballot_sync(lanes, keep); todo;
           todo &= todo - 1) {
        const int e = k0 + (__ffs(todo) - 1) * blockDim.z;
        const float cz = priority(unpack(faces[e]), px, py, blur, znear);
        if (cz < best) {
          best = cz;
          lane = c0 + e;
        }
      }
    }
  }
  if (blockDim.z > 1) {
    float* mz = reinterpret_cast<float*>(k1_merge);
    int* ms = reinterpret_cast<int*>(mz + nt);
    mz[t] = best;
    ms[t] = lane;
    __syncthreads();
    if (grp == 0) {
      for (int g = 1; g < (int)blockDim.z; ++g) {
        const float cz = mz[t + g * np];
        const int cl = ms[t + g * np];
        if (cz < best || (cz == best && cl < lane)) {
          best = cz;
          lane = cl;
        }
      }
    }
  }
  if (grp != 0 || row >= tile || col >= tile) return;

  const int tp = tile * tile;
  float* o = out + cell * 8 * tp + row * tile + col;
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
  const int staged = lane - (n - 1) / kK1Chunk * kK1Chunk;  // last chunk
  Face f;
  const float* c;
  if (staged >= 0) {
    f = unpack(faces[staged]);
    c = raw + staged * kChannels;
  } else {
    c = st + (long)lane * kChannels;
    load_face(c, f);
  }
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
  const float zbuf = add(add(mul(pc[0], c[6]), mul(pc[1], c[7])),
                         mul(pc[2], c[8]));
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

// Any tile whose pixel count is an int; a launch past the grid's limits
// (gridDim.z) is refused by the card and reported.
int check_shape(int B, int A, int F, int tile) {
  if (B <= 0 || B > 65535 || A <= 0 || F <= 0 || tile <= 0 ||
      (long long)tile * tile > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Shared memory of a top-K block of nt threads: the staging buffer and
// each thread's K entries of 8 bytes.
long topk_smem(int nt, int K) {
  return kStageBytes + (long)nt * K * (sizeof(float) + sizeof(int));
}

// Dynamic shared memory of a hard_k1 block of `threads` threads in S > 1
// groups: each thread's (zsel, slot) for the merge.
size_t k1_smem(int threads, int S) {
  return S > 1 ? (size_t)threads * (sizeof(float) + sizeof(int)) : 0;
}

// Blocks of `threads` threads of hard_k1 in several groups an SM holds at
// once (registers and shared memory), per device and warp count, read once.
int k1_resident(int device, int threads, int* blocks) {
  static int cached[64][kMaxPixels / 32 + 1] = {};
  const int w = (threads + 31) / 32;
  if (device >= 0 && device < 64 && cached[device][w]) {
    *blocks = cached[device][w];
    return 0;
  }
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, hard_k1_kernel<false>, threads, k1_smem(threads, 2));
  if (!err && device >= 0 && device < 64) cached[device][w] = *blocks;
  return err;
}

// A hard_k1 launch's plan for `tiles` tiles (rows_groups_plan): blocks of
// at most kK1BlockPixels pixels, up to kK1MaxGroups thread groups.
int k1_plan(int device, int tile, long long tiles, int* P, int* R,
            int* S) {
  return rows_groups_plan(
      device, tile, tiles, kK1BlockPixels, kMaxPixels, kK1MaxGroups,
      kMaxPixels,
      [](int) { return true; },
      [device](int threads, int* blocks) {
        return k1_resident(device, threads, blocks);
      },
      P, R, S);
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
  int P = 0, R = 0, S = 0;
  err = k1_plan(device, tile, (long long)A * B, &P, &R, &S);
  if (err) return err;
  const int C = block_cols(tile, kMaxPixels);
  const dim3 grid(A, B, P), block(C, R, S);
  if (C < tile) {
    hard_k1_kernel<true><<<grid, block, k1_smem(C * R * S, S),
                           (cudaStream_t)stream>>>(
        slab, count, origin, out, A, F, tile, inv_s, blur, znear, clip_bary);
  } else {
    hard_k1_kernel<false><<<grid, block, k1_smem(C * R * S, S),
                            (cudaStream_t)stream>>>(
        slab, count, origin, out, A, F, tile, inv_s, blur, znear, clip_bary);
  }
  return (int)cudaGetLastError();
}

// The plan a hard_k1 launch over `tiles` tiles takes on `device`
// (k1_plan): P, R and S into plan[0], plan[1], plan[2]. The card tests
// read it to reach every plan.
int trt_hard_k1_plan(int tile, long long tiles, int* plan, int device) {
  if (check_shape(1, 1, 1, tile) || tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaSetDevice(device);
  if (err) return err;
  return k1_plan(device, tile, tiles, plan, plan + 1, plan + 2);
}

// Whether a top-K launch keeps its lists in device memory (not even one
// warp's fit in shared memory): the wrapper then passes a float32 scratch
// of the output's shape for their depths.
int trt_topk_device_lists(int K) {
  return device_lists(K, kStageBytes) ? 1 : 0;
}

int trt_topk_select(const float* slab, const int* count, const float* origin,
                    int* lane, float* zs, int B, int A, int F, int K,
                    int tile, float inv_s, float blur, float znear,
                    int device, void* stream) {
  int err = check_shape(B, A, F, tile);
  if (err) return err;
  const bool dev = device_lists(K, kStageBytes);
  if (K <= 0 || (dev && zs == nullptr)) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  // above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // device (setting it twice is harmless)
  static bool opted[64];
  if (device < 0 || device >= 64 || !opted[device]) {
    err = (int)cudaFuncSetAttribute(
        topk_select_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err) return err;
    if (device >= 0 && device < 64) opted[device] = true;
  }
  const int tp = tile * tile;
  if (dev) {   // one group, blocks of kListPixels pixels
    const int np = min(tp, kListPixels);
    topk_select_kernel<true><<<dim3(A, B, (tp + np - 1) / np), np,
                               kStageBytes, (cudaStream_t)stream>>>(
        slab, count, origin, lane, zs, A, F, K, tile, inv_s, blur, znear);
    return (int)cudaGetLastError();
  }
  // P blocks per tile, each over np of its pixels: the fewest that hold at
  // most 1024 pixels and whose lists fit in shared memory (np >= 256 fits
  // K = 64, np >= 32 K = 812); then S groups per pixel: the most (a power
  // of two) that 1024 threads and shared memory allow
  int P = 1;
  while ((tp + P - 1) / P > kMaxPixels ||
         topk_smem((tp + P - 1) / P, K) > kMaxSmem) {
    P *= 2;
  }
  const int np = (tp + P - 1) / P;
  int S = 1;
  while (2 * S * np <= kMaxPixels && topk_smem(2 * S * np, K) <= kMaxSmem) {
    S *= 2;
  }
  topk_select_kernel<false><<<dim3(A, B, P), S * np, topk_smem(S * np, K),
                              (cudaStream_t)stream>>>(
      slab, count, origin, lane, nullptr, A, F, K, tile, inv_s, blur, znear);
  return (int)cudaGetLastError();
}

}  // extern "C"
