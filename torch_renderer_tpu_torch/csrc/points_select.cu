// Point-splat selection kernel for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// points_select keeps, for every pixel of each active tile, the K candidate
// points of lowest camera z whose splat covers the pixel, as winner slots
// (-1 = dead), ascending in z. A candidate in slot s covers pixel p when
//   s < count,  z > znear  and  dx * dx + dy * dy <= r2
// with dx = px - x, dy = py - y and (px, py) = offs[p] + origin: the local
// offsets the plain version and the differentiable epilogue add
// (binning.tile_pixel_coords). Every step is written with the _rn
// intrinsics in the plain version's order (rasterize/cuda_points.py
// _priority), so nvcc contracts nothing into an FMA and a pixel on a
// splat's boundary is decided bit for bit as the epilogue's recomputed d2
// says. Ties keep the earlier slot: each thread group visits its share of
// the slots in ascending order with a stable insertion, and the groups
// merge in (z, slot) order, which equals the JAX kernel's K argmin passes
// (first lane of the minimum).
//
// Inputs:  slab   (B, A, P, C) f32 per slot: x, y, z, then r2 in channel
//                                  r2_channel when r2_channel >= 0 (else
//                                  the uniform r2 applies); further
//                                  channels are not read
//          count  (B, A)       i32 live slots per tile (slots >= count are
//                                  never read)
//          origin (B, A, 2)    f32 raster coords of the tile's pixel 0
//          offs   (tp, 2)      f32 pixel offsets within a tile, row-major
//                                  (pixel p at row p / tile, column
//                                  p % tile)
//          zs     (B, A, K, tp) f32 the depths of the lists where they live
//                                  in device memory (points_device_lists),
//                                  else null
// Output:  lane   (B, A, K, tp) i32 winner slots, -1 = dead
// Any tile and any K: a tile's pixels split over as many blocks as the
// launch plan needs, and the lists move to device memory where not even
// one warp's fit in shared memory.

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

constexpr int kMaxPixels = 1024;   // threads of a block at most
constexpr int kChunk = 256;        // candidates staged per shared-memory pass
constexpr int kBlockPixels = 128;  // a block's pixels at most
constexpr int kMaxGroups = 4;      // thread groups per pixel at most
constexpr int kBatch = 4;          // kept candidates evaluated together

// The cull box of a staged candidate (x, y, z, r2) whose r2 is already -1
// at or behind znear: x0 x1 y0 y1 such that a pixel outside it is not
// covered. With eps = 2^-24, a covered pixel has, by the monotone rounding
// of each step, fl(dx^2) <= fl(dx^2 + dy^2) <= r2, so |dx| <=
// sqrt(r2 + 2^-149) (1 + eps) and |px - x| <= |dx| (1 + 2 eps). The half
// width 1.001 sqrt(r2) + 1e-6 (|x| + |y| + 1) exceeds that bound plus the
// rounding of sqrtf, of the sums and of x -+ half (each within eps of
// |x| + half), so the box is conservative. A candidate that never covers
// (r2 < 0 or NaN) gets an empty box; a NaN or infinite bound compares
// false and culls nothing. tests/test_torch_points_split.py copies this
// formula for the CPU model of the decomposition.
__device__ __forceinline__ float4 splat_box(float4 c) {
  if (!(c.w >= 0.0f)) {
    return make_float4(kInf, -kInf, kInf, -kInf);
  }
  const float h = 1.001f * sqrtf(c.w)
      + 1e-6f * (fabsf(c.x) + fabsf(c.y) + 1.0f);
  return make_float4(c.x - h, c.x + h, c.y - h, c.y + h);
}

// An order-preserving map of a float to an int (an involution): the warp
// reductions of the pixel span run on ints. A NaN maps beyond +-inf, and
// then the span's comparisons are false and cull nothing.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float order_val(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Replaces torch_renderer_tpu/rasterize/pallas_points.py
// _points_select_kernel (reached through points_select_pallas).
// Bound: bytes at the bench slab (the K winner rows of tp int32 per tile
// are most of them); what sets the time is latency: a splat of ~1.3 px
// covers a few of a tile's pixels, so most (pixel, candidate) tests miss,
// and the busiest tiles (3-4x the mean count) run longest. Design, per
// block = (batch, active tile, rows of the tile):
//  * Threads are (column, row, group): blockDim = (C, R, S) with C = tile
//    up to the block's pixel cap (rows_groups_pixel); P = gridDim.z blocks
//    of R rows (and of C columns past the cap) share a tile (points_plan:
//    blocks of at most kBlockPixels pixels, fewer where K's lists need it,
//    split further while the launch has fewer blocks than the card has
//    SMs), with S thread groups per pixel (the most, up to kMaxGroups,
//    that keep every block resident at once).
//  * Staging: each chunk's live rows come into shared memory by cp.async,
//    the four words x, y, z, r2 of each, every copy in flight at once; then
//    each becomes (x, y, z, r2 or -1 at or behind znear) and its cull box
//    (splat_box).
//  * Scan: group s takes chunk entries s, s + S, ... in ascending slot
//    order. A warp's lanes first test as many of its entries at once
//    against the box of the warp's pixels (min and max of px and py over
//    its lanes); a ballot gives the warp the candidates it must evaluate,
//    in slot order, so a culled candidate costs nothing. They are read and
//    tested kBatch at a time (independent loads and arithmetic), then
//    pushed in slot order. Each thread keeps its K best (z, slot) in a
//    list in shared memory (TopkList), touched only by a covering
//    candidate below its K-th entry. DEVICE_LISTS (where not even one
//    warp's lists fit in shared memory, K > 876): one group, and each
//    pixel's list in device memory, its slots in the output column and
//    its depths in the wrapper's scratch.
//  * Merge: a tree over the groups in (z, slot) order (merge_groups), the
//    order of one stable pass; group 0 writes the K rows.
// Winners equal points_select_reference bit for bit. The TPU kernel's
// 128-lane padding, packed origin and trip-count rows and K argmin passes
// over a VMEM priority slab are TPU layout and are not carried.
template <bool DEVICE_LISTS>
__global__ void __launch_bounds__(kMaxPixels)
points_select_kernel(const float* __restrict__ slab,
                     const int* __restrict__ count,
                     const float* __restrict__ origin,
                     const float* __restrict__ offs, int* __restrict__ lane,
                     float* __restrict__ zs, int A, int P, int C, int K,
                     int tile, float r2u, int r2c, float znear) {
  extern __shared__ float4 smem[];
  float4* cand = smem;                        // the chunk's (x, y, z, r2)
  float4* boxes = smem + kChunk;              // and cull boxes
  const int np = blockDim.x * blockDim.y;     // the block's pixels
  const int nt = np * blockDim.z;             // the block's threads
  const int t = threadIdx.x
      + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int grp = threadIdx.z;
  int col, row;
  const bool live = rows_groups_pixel(tile, col, row);
  // a thread past the tile's last row or column holds no pixel; it takes
  // the nearest one's, which keeps the warp's span within the tile
  const int p = min(row, tile - 1) * tile + min(col, tile - 1);
  const int tp = tile * tile;
  const long cell = (long)blockIdx.y * A + blockIdx.x;
  const int n = max(0, min(count[cell], P));
  const float* st = slab + cell * P * C;
  const float px = __fadd_rn(offs[2 * p], origin[2 * cell]);
  const float py = __fadd_rn(offs[2 * p + 1], origin[2 * cell + 1]);
  // This warp's pixel span (the launcher keeps a warp within one group).
  const int nl = min(32, nt - (t & ~31));     // the warp's threads
  const unsigned lanes = nl == 32 ? 0xffffffffu : (1u << nl) - 1u;
  const float wx0 = order_val(__reduce_min_sync(lanes, order_key(px)));
  const float wx1 = order_val(__reduce_max_sync(lanes, order_key(px)));
  const float wy0 = order_val(__reduce_min_sync(lanes, order_key(py)));
  const float wy1 = order_val(__reduce_max_sync(lanes, order_key(py)));
  const int r2src = r2c >= 0 ? r2c : 2;       // a word copied, not read
  TopkList list;
  if (DEVICE_LISTS) {
    const long at = cell * K * tp + p;
    list = TopkList{zs + at, lane + at, tp, K};
    if (live) {
      list.init();
    } else {
      list.close();
    }
  } else {
    float* zl = reinterpret_cast<float*>(smem + 2 * kChunk);
    list = TopkList{zl + t, reinterpret_cast<int*>(zl + nt * K) + t, nt, K};
    list.init();
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {    // n is uniform in the block
    const int m = min(kChunk, n - c0);        // live entries of the chunk
    if (c0) __syncthreads();                  // previous chunk consumed
    float* raw = reinterpret_cast<float*>(cand);
    for (int k = t; k < 4 * m; k += nt) {
      const int ch = k & 3;
      copy_async4(raw + k, st + (long)(c0 + (k >> 2)) * C
                               + (ch < 3 ? ch : r2src));
    }
    copy_wait();
    __syncthreads();
    for (int i = t; i < m; i += nt) {
      float4 c = cand[i];
      c.w = c.z > znear ? (r2c >= 0 ? c.w : r2u) : -1.0f;
      cand[i] = c;
      boxes[i] = splat_box(c);
    }
    __syncthreads();
    for (int k0 = grp; k0 < m; k0 += nl * (int)blockDim.z) {
      // lane j tests entry k0 + j * S against the warp's pixel span
      const int i = k0 + (t & 31) * blockDim.z;
      bool keep = false;
      if (i < m) {
        const float4 b = boxes[i];
        keep = !(wx1 < b.x || wx0 > b.y || wy1 < b.z || wy0 > b.w);
      }
      // the kept entries, kBatch at a time: their loads and coverage
      // tests are independent, so they overlap; then the pushes, in slot
      // order
      for (unsigned todo = __ballot_sync(lanes, keep); todo;) {
        int es[kBatch];
        float4 cs[kBatch];
        bool hit[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          es[u] = todo ? k0 + (__ffs(todo) - 1) * (int)blockDim.z : -1;
          todo &= todo - 1;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          cs[u] = es[u] >= 0 ? cand[es[u]] : make_float4(0, 0, 0, -1.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float dx = __fsub_rn(px, cs[u].x);
          const float dy = __fsub_rn(py, cs[u].y);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          hit[u] = d2 <= cs[u].w;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (hit[u] && cs[u].z < list.kth) {
            list.push<false>(cs[u].z, c0 + es[u]);
          }
        }
      }
    }
  }
  merge_groups(list, blockDim.z, grp, np);
  // device lists are the output already
  if (DEVICE_LISTS || grp != 0 || !live) return;
  int* o = lane + cell * K * tp + p;
  for (int j = 0; j < K; ++j) o[(long)j * tp] = list.slot(j);
}

// Dynamic shared memory of a block of nt threads: the staged chunk and
// its boxes, and each thread's K entries of 8 bytes (none where the lists
// live in device memory).
constexpr long kStageBytes = 2 * kChunk * sizeof(float4);

size_t points_smem(int nt, int K, bool dev) {
  return kStageBytes
      + (dev ? 0 : (size_t)nt * K * (sizeof(float) + sizeof(int)));
}

// Blocks of nt threads with K entries a thread that an SM holds at once
// (registers and shared memory), read once per (device, warps, K): a
// small table, filled in order, searched by key (a plan is asked for a
// handful of shapes a run).
int points_resident(int device, int nt, int K, int* blocks) {
  struct Entry {
    int device, warps, K, blocks;
  };
  static Entry cached[64];
  static int filled = 0;
  const int w = (nt + 31) / 32;
  for (int i = 0; i < filled; ++i) {
    if (cached[i].device == device && cached[i].warps == w &&
        cached[i].K == K) {
      *blocks = cached[i].blocks;
      return 0;
    }
  }
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, points_select_kernel<false>, nt, points_smem(nt, K, false));
  if (!err && filled < 64) cached[filled++] = {device, w, K, *blocks};
  return err;
}

// A block's pixels at most, and its columns: kBlockPixels, halved (to one
// warp) until a block's lists of K fit in shared memory; kBlockPixels
// with the lists in device memory.
int points_block_pixels(int K) {
  int bp = kBlockPixels;
  while (!device_lists(K, kStageBytes) && bp > 32 &&
         points_smem(bp, K, false) > (size_t)kMaxSmem) {
    bp /= 2;
  }
  return bp;
}

// A launch's plan for `tiles` tiles (rows_groups_plan): blocks of at most
// points_block_pixels(K) pixels, up to kMaxGroups thread groups whose
// lists fit in shared memory; one group with the lists in device memory.
int points_plan(int device, int tile, int K, long long tiles, int* P, int* R,
                int* S) {
  // above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // device (setting it twice is harmless); the occupancy calculator reads it
  static bool opted[64];
  if (device < 0 || device >= 64 || !opted[device]) {
    const int err = (int)cudaFuncSetAttribute(
        points_select_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err) return err;
    if (device >= 0 && device < 64) opted[device] = true;
  }
  const int bp = points_block_pixels(K);
  return rows_groups_plan(
      device, tile, tiles, bp, bp,
      device_lists(K, kStageBytes) ? 1 : kMaxGroups, kMaxPixels,
      [K](int threads) {
        return points_smem(threads, K, false) <= (size_t)kMaxSmem;
      },
      [device, K](int threads, int* blocks) {
        return points_resident(device, threads, K, blocks);
      },
      P, R, S);
}

// Any tile whose pixel count is an int, and any K.
int check_shape(int B, int A, int P, int C, int K, int tile, int r2c) {
  if (B <= 0 || B > 65535 || A <= 0 || P <= 0 || C < 3 || r2c >= C ||
      K <= 0 || tile <= 0 || (long long)tile * tile > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and a later synchronize would not report it.
int trt_points_select(const float* slab, const int* count,
                      const float* origin, const float* offs, int* lane,
                      float* zs, int B, int A, int P, int C, int K, int tile,
                      float r2u, int r2c, float znear, int device,
                      void* stream) {
  int err = check_shape(B, A, P, C, K, tile, r2c);
  if (err) return err;
  const bool dev = device_lists(K, kStageBytes);
  if (dev && zs == nullptr) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  int Pb = 0, R = 0, S = 0;
  err = points_plan(device, tile, K, (long long)A * B, &Pb, &R, &S);
  if (err) return err;
  const int Cb = block_cols(tile, points_block_pixels(K));
  const dim3 grid(A, B, Pb), block(Cb, R, S);
  const size_t smem = points_smem(Cb * R * S, K, dev);
  if (dev) {
    points_select_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        slab, count, origin, offs, lane, zs, A, P, C, K, tile, r2u, r2c,
        znear);
  } else {
    points_select_kernel<false><<<grid, block, smem,
                                  (cudaStream_t)stream>>>(
        slab, count, origin, offs, lane, nullptr, A, P, C, K, tile, r2u, r2c,
        znear);
  }
  return (int)cudaGetLastError();
}

// The plan a launch over `tiles` tiles with K winners takes on `device`
// (points_plan): P, R and S into plan[0], plan[1], plan[2]. The card tests
// read it to reach every plan.
int trt_points_plan(int tile, int K, long long tiles, int* plan,
                    int device) {
  if (check_shape(1, 1, 1, 3, K, tile, -1) || tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  return points_plan(device, tile, K, tiles, plan, plan + 1, plan + 2);
}

// Whether a launch with K winners keeps its lists in device memory: the
// wrapper then passes a float32 scratch of the output's shape for their
// depths.
int trt_points_device_lists(int K) {
  return device_lists(K, kStageBytes) ? 1 : 0;
}

}  // extern "C"
