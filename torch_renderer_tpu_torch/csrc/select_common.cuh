// Pieces shared by the selection kernels (hard_raster.cu: topk_select and
// hard_k1; points_select.cu) and the gather (gather_tiles.cu): the sorted
// per-thread list of K (depth, slot) entries and its merge over thread
// groups, asynchronous staging copies, the SM count and the rows-and-groups
// launch plan. Each including file gets its own copy (an anonymous
// namespace): the kernels stay in separate translation units.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr int kMaxSmem = 232448;  // the most shared memory a block may opt into

// A thread's sorted list of (depth, slot) entries, K of them, in shared
// memory (entry j of thread t at j * stride + t: neighbouring threads on
// neighbouring words). A candidate is pushed only when it is below the K-th
// entry; it enters after every entry it is not below: with slots pushed in
// ascending order that is the stable insertion, ties to the earlier slot,
// and with LEX it is (depth, slot) lexicographic order, as a merge needs.
// Entries from `fill` on are empty (kInf, -1), so a push shifts only the
// filled entries above it.
struct TopkList {
  float* z;
  int* s;
  int stride, K;
  float kth = kInf;   // the K-th entry's depth: the bar a candidate must beat
  int kl = -1;        // and its slot
  int fill = 0;       // entries filled

  __device__ __forceinline__ void init() {
    for (int j = 0; j < K; ++j) {
      z[j * stride] = kInf;
      s[j * stride] = -1;
    }
  }
  template <bool LEX>
  __device__ __forceinline__ void push(float cz, int cl) {
    int j = min(fill, K - 1);
    for (; j > 0; --j) {
      const float pz = z[(j - 1) * stride];
      const int ps = s[(j - 1) * stride];
      if (!(cz < pz || (LEX && cz == pz && cl < ps))) break;
      z[j * stride] = pz;
      s[j * stride] = ps;
    }
    z[j * stride] = cz;
    s[j * stride] = cl;
    fill = min(fill + 1, K);
    if (fill == K) {
      kth = z[(K - 1) * stride];
      kl = s[(K - 1) * stride];
    }
  }
  __device__ __forceinline__ int slot(int j) const { return s[j * stride]; }
};

// Tree merge of the S thread groups' lists of each pixel (S a power of
// two; group g's list of a pixel sits `np` threads after group g - 1's):
// at each level each group of the lower half inserts its partner's entries
// in (depth, slot) order, stopping at the first that does not enter (the
// partner's list is sorted). That order is the one the stable sequential
// insertion produces, so group 0 ends with the same K entries. Every
// thread of the block calls it.
__device__ __forceinline__ void merge_groups(TopkList& list, int S, int grp,
                                             int np) {
  for (int half = S / 2; half >= 1; half /= 2) {
    __syncthreads();                             // the partners' lists done
    if (grp < half) {
      const int off = half * np;                 // the partner thread
      for (int j = 0; j < list.K; ++j) {
        const float cz = list.z[j * list.stride + off];
        const int cl = list.s[j * list.stride + off];
        if (!(cz < list.kth || (cz == list.kth && cl < list.kl))) break;
        list.push<true>(cz, cl);
      }
    }
  }
}

// *dst = *src, 4 bytes from device to shared memory by cp.async (a plain
// copy outside device code); the caller waits with copy_wait.
__device__ __forceinline__ void copy_async4(float* dst,
                                            const float* __restrict__ src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

// raw[k] = src[k] for k < nk, k = t, t + nt, ...: copies that go straight
// to shared memory, all in flight at once.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          float* raw, int t, int nk,
                                          int nt) {
  for (int k = t; k < nk; k += nt) copy_async4(raw + k, src + k);
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// The SM count of a device into *sms, read once; returns a CUDA error.
inline int sm_count(int device, int* sms) {
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

// The plan of a launch over `tiles` tiles of tile^2 pixels whose blocks
// are (column, row, group) threads (hard_k1, points_select): P blocks of R
// whole rows share a tile, with S thread groups per pixel. Blocks hold at
// most block_pixels pixels, and R halves (to two warps of pixels at least)
// while the launch has fewer blocks than the card has SMs: the busiest
// tile's work then spreads over several SMs. S is the largest power of two
// up to max_groups with S * R * tile <= max_threads for which fits(threads)
// holds and every block of the launch is resident at once
// (resident(threads, &blocks) asks the occupancy calculator); 1 where
// R * tile is not a whole number of warps (a warp never spans two groups).
// The kernels' results do not depend on the plan.
template <typename Fits, typename Resident>
int rows_groups_plan(int device, int tile, long long tiles, int block_pixels,
                     int max_groups, int max_threads, Fits fits,
                     Resident resident, int* P, int* R, int* S) {
  int sms = 0;
  int err = sm_count(device, &sms);
  if (err) return err;
  int r = min(tile, max(1, block_pixels / tile));
  while (tiles * ((tile + r - 1) / r) < sms && r % 2 == 0 &&
         (r / 2) * tile % 64 == 0) {
    r /= 2;
  }
  const int np = r * tile;
  int s = 1;
  while (np % 32 == 0 && 2 * s <= max_groups &&
         2 * s * np <= max_threads && fits(2 * s * np)) {
    int blocks = 0;
    err = resident(2 * s * np, &blocks);
    if (err) return err;
    if (tiles * ((tile + r - 1) / r) > (long long)blocks * sms) break;
    s *= 2;
  }
  *P = (tile + r - 1) / r;
  *R = r;
  *S = s;
  return 0;
}

}  // namespace
