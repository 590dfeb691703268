// Fused scatter + untile kernel for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// For each field of a raster, untile_scatter writes the cropped image
// out[b, y, x, c] from compacted per-tile rows: with tile
// (ty, tx) = (y / tile, x / tile) and its slot s = tileof[b, ty * TW + tx],
//   out[b, y, x, c] = rows[b, s, (y % tile) * tile + x % tile, c]  if 0 <= s < A
//                   = bg                                           otherwise.
// Values are copied as raw 4- or 8-byte words, so float32, int32 and int64
// fields all go through unchanged (no float round trip for ids). One launch
// serves every field of a raster: the fields share B, H, W, the tile grid
// and the slot table, and each brings its own rows, strides, element size,
// channel count, background and output.
//
// Inputs:  rows   (B, A, tile^2, C) 4- or 8-byte elements, any strides
//                                   (given in elements), per field
//          tileof (B, TH * TW)      i32 slot of each tile, A = background
//          bg                       the background word (bg_bits), every
//                                   channel, per field
// Output:  out    (B, H, W, C)      contiguous, H <= TH * tile, W <= TW * tile,
//                                   per field

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxFields = 8;

// How a field's threads cut an output row (W * C elements, contiguous).
enum Mode : int {
  kScalar = 0,   // a thread per element: any tile, width and strides
  kRun = 1,      // a thread per V pixels (V * C * es a multiple of 16 bytes,
                 // tile and W multiples of V): whole 16-byte stores
  kWord = 2,     // C * es a multiple of 16: a thread per 16-byte word of a
                 // pixel
};

// How a kRun or kWord thread reads its elements.
enum Load : int {
  kElement = 0,  // one load per element, at any strides
  kPlanar = 1,   // kRun, pixel stride 1: one vector load per channel
  kBlock = 2,    // kRun with sc = 1 and sp = C, or kWord with sc = 1: the
                 // output's bytes are contiguous in rows too: 16-byte loads
};

struct Field {
  const char* rows;
  char* out;
  long long sb, ss, sp, sc;   // rows' strides, in elements
  unsigned long long bg;      // background word (the low half for es = 4)
  int es, C;                  // element bytes (4 or 8), channels
  int mode, load;
  int V;                      // kRun: pixels per thread
  int G;                      // kWord: 16-byte words per pixel
  int units;                  // threads' units per output row
  int first;                  // first blockIdx.y of the field
};

struct Fields {
  Field f[kMaxFields];
  int n;
};

// Element k of the output row (pixel k / C, channel k % C) in rows, at
// pixel p of slot s of view b: its byte offset.
__device__ __forceinline__ long long elem_at(const Field& f, int b, int s,
                                             int p, int c) {
  return (b * f.sb + s * f.ss + p * f.sp + c * f.sc) * f.es;
}

// The element at byte offset `at` of rows as one (ES = 4) or two words.
template <int ES>
__device__ __forceinline__ void load_elem(const Field& f, long long at,
                                          unsigned& lo, unsigned& hi) {
  if constexpr (ES == 4) {
    lo = *reinterpret_cast<const unsigned*>(f.rows + at);
  } else {
    const unsigned long long v =
        *reinterpret_cast<const unsigned long long*>(f.rows + at);
    lo = (unsigned)v;
    hi = (unsigned)(v >> 32);
  }
}

__device__ __forceinline__ void store_bg(const Field& f, char* dst, int nw) {
  const unsigned lo = (unsigned)f.bg;
  const unsigned hi = f.es == 8 ? (unsigned)(f.bg >> 32) : lo;
  for (int j = 0; j < nw; ++j) {
    reinterpret_cast<uint4*>(dst)[j] = make_uint4(lo, hi, lo, hi);
  }
}

// kRun, kPlanar: V pixels of C <= 3 planes. Each channel's V elements
// are one 8- or 16-byte load; they interleave in registers into
// V * C * ES / 16 16-byte stores.
template <int ES, int C, int V>
__device__ __forceinline__ void run_planar(const Field& f, long long at,
                                           char* dst) {
  constexpr int EW = ES / 4;          // words per element
  constexpr int NW = V * EW;          // words per channel's vector
  unsigned w[C][NW];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const char* src = f.rows + at + c * f.sc * ES;
    if constexpr (NW == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      w[c][0] = u.x; w[c][1] = u.y; w[c][2] = u.z; w[c][3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      w[c][0] = u.x; w[c][1] = u.y;
    }
  }
  constexpr int OW = V * C * EW;      // output words, a multiple of 4
  unsigned o[OW];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = 0; k < EW; ++k) o[(v * C + c) * EW + k] = w[c][v * EW + k];
    }
  }
#pragma unroll
  for (int j = 0; j < OW / 4; ++j) {
    reinterpret_cast<uint4*>(dst)[j] =
        make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
}

// nw 16-byte words of output elements k0, k0 + 1, ... whose pixels all
// lie in one tile (pixel x0 at tile pixel p0), one load per element.
template <int ES>
__device__ __forceinline__ void run_elements(const Field& f, int b, int s,
                                             int p0, int x0, int k0,
                                             char* dst, int nw) {
  constexpr int kPerWord = 16 / ES;
  int c = k0 - x0 * f.C;              // channel of element k0
  int p = p0;
  for (int j = 0; j < nw; ++j) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < kPerWord; ++i) {
      load_elem<ES>(f, elem_at(f, b, s, p, c), u[i * ES / 4],
                    u[(i * ES / 4) + ES / 4 - 1]);
      if (++c == f.C) {
        c = 0;
        ++p;
      }
    }
    reinterpret_cast<uint4*>(dst)[j] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// Replaces torch_renderer_tpu/rasterize/pallas_untile.py _untile_kernel
// (reached through untile_scatter_pallas).
// Bound: bytes. It reads the active tiles' rows and writes each image once;
// there is no arithmetic beyond the index math. Design: one launch for all
// of a raster's fields (four Fragments fields: at the fits' 128^2 shape a
// launch's fixed device time is about ten times its bytes' time, PERF.md).
// Block row blockIdx.x
// is one image row (b * H + y); blockIdx.y walks the fields' chunks of
// kThreads threads, a field's chunks contiguous, so the field is uniform
// in a block. A kRun thread writes V pixels' C channels as whole 16-byte
// stores (4 pixels of a float32 plane, 2 of an int64 one, 4 pixels x 3
// channels of bary as three), reading each channel's V pixels with one
// vector load from the tile row where the pixel stride is 1, so a channel
// stride of tile^2 (the raster's transposed fields) costs nothing extra;
// a kWord thread writes one 16-byte word of a pixel's channels (K > 1
// fields). A thread reads its tile's slot once and stores the background
// without reading where the tile has no row (most of a 720p frame). The
// kScalar path, a thread per element, covers tiles and widths that are not
// multiples of V and runs longer than 48 bytes (odd channel counts above
// 3), where whole stores would leave a warp's stores far apart.
// The TPU kernel's VMEM strip transpose, its float32 slot table with
// 128-lane padding and its channel padding were Mosaic layout constraints
// and are not carried.
__global__ void __launch_bounds__(kThreads)
untile_kernel(const Fields fs, const int* __restrict__ tileof, int H, int W,
              int tile, int TW, int T, int A) {
  int fi = 0;
  while (fi + 1 < fs.n && (int)blockIdx.y >= fs.f[fi + 1].first) ++fi;
  const Field& f = fs.f[fi];
  const int u = ((int)blockIdx.y - f.first) * kThreads + threadIdx.x;
  if (u >= f.units) return;
  const long long row = blockIdx.x;   // b * H + y
  const int b = (int)(row / H);
  const int y = (int)(row - (long long)b * H);
  const int ty = y / tile;
  const int py = (y - ty * tile) * tile;
  const int* slots = tileof + (long long)b * T + ty * TW;
  char* out_row = f.out + row * W * f.C * f.es;

  if (f.mode == kScalar) {
    const int x = u / f.C;
    const int c = u - x * f.C;
    const int tx = x / tile;
    const int s = slots[tx];
    const bool live = s >= 0 && s < A;
    const long long at = elem_at(f, b, s, py + x - tx * tile, c);
    unsigned lo = (unsigned)f.bg, hi = (unsigned)(f.bg >> 32);
    if (f.es == 4) {
      if (live) load_elem<4>(f, at, lo, hi);
      reinterpret_cast<unsigned*>(out_row)[u] = lo;
    } else {
      if (live) load_elem<8>(f, at, lo, hi);
      reinterpret_cast<unsigned long long*>(out_row)[u] =
          ((unsigned long long)hi << 32) | lo;
    }
    return;
  }
  // kRun: pixels x0 .. x0 + V - 1; kWord: pixel x0, word g of it
  const int x0 = f.mode == kRun ? u * f.V : u / f.G;
  const int g = f.mode == kRun ? 0 : u - x0 * f.G;
  const int k0 = x0 * f.C + g * (16 / f.es);
  const int nw = f.mode == kRun ? f.V * f.C * f.es / 16 : 1;
  char* dst = out_row + (long long)k0 * f.es;
  const int tx = x0 / tile;
  const int s = slots[tx];
  if (!(s >= 0 && s < A)) {
    store_bg(f, dst, nw);
    return;
  }
  const int p0 = py + x0 - tx * tile;
  const long long at = elem_at(f, b, s, p0, k0 - x0 * f.C);
  if (f.load == kBlock) {
    for (int j = 0; j < nw; ++j) {
      reinterpret_cast<uint4*>(dst)[j] =
          reinterpret_cast<const uint4*>(f.rows + at)[j];
    }
  } else if (f.load == kPlanar) {
    // (es, C) -> V: (4, 1) 4, (4, 2) 2, (4, 3) 4, (8, 1) 2, (8, 3) 2
    if (f.es == 4) {
      if (f.C == 1) run_planar<4, 1, 4>(f, at, dst);
      else if (f.C == 2) run_planar<4, 2, 2>(f, at, dst);
      else run_planar<4, 3, 4>(f, at, dst);
    } else {
      if (f.C == 1) run_planar<8, 1, 2>(f, at, dst);
      else run_planar<8, 3, 2>(f, at, dst);
    }
  } else if (f.es == 4) {
    run_elements<4>(f, b, s, p0, x0, k0, dst, nw);
  } else {
    run_elements<8>(f, b, s, p0, x0, k0, dst, nw);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

bool aligned(const void* p, long long bytes) {
  return ((unsigned long long)p) % (unsigned long long)bytes == 0;
}

// Chooses the field's mode and load (see the enums) from its shape,
// strides and pointers; returns false for a shape the kernel does not take.
bool plan(Field& f, int W, int tile) {
  if ((f.es != 4 && f.es != 8) || f.C <= 0 || !aligned(f.out, 16) ||
      !aligned(f.rows, f.es)) {
    return false;
  }
  const int bytes = f.C * f.es;
  const int V = 16 / gcd(16, bytes);   // pixels to a whole 16-byte run
  const int ew = 16 / f.es;            // elements per 16-byte word
  f.load = kElement;
  f.V = V;
  f.G = bytes / 16;
  if (V == 1) {
    f.mode = kWord;
    f.units = W * f.G;
    if (f.sc == 1 && aligned(f.rows, 16) && f.sb % ew == 0 &&
        f.ss % ew == 0 && f.sp % ew == 0) {
      f.load = kBlock;
    }
  } else if (tile % V == 0 && W % V == 0 && V * bytes <= 48) {
    f.mode = kRun;
    f.units = W / V;
    if (f.C <= 3 && f.sp == 1 && aligned(f.rows, V * f.es) &&
        f.sb % V == 0 && f.ss % V == 0 && (f.C == 1 || f.sc % V == 0)) {
      f.load = kPlanar;
    } else if (f.sc == 1 && f.sp == f.C && aligned(f.rows, 16) &&
               f.sb % ew == 0 && f.ss % ew == 0) {
      f.load = kBlock;
    }
  } else {
    f.mode = kScalar;
    f.units = W * f.C;
  }
  return true;
}

}  // namespace

extern "C" {

// Untiles n fields of one raster in one launch. desc holds 9 int64 per
// field: rows pointer, out pointer, element bytes, C, the four strides of
// rows (elements) and the background word. Enqueues on `stream` and
// returns cudaGetLastError(): a refused launch never runs, and a later
// synchronize would not report it.
int trt_untile_scatter_fields(const long long* desc, int n,
                              const int* tileof, int B, int H, int W,
                              int tile, int TH, int TW, int A, int device,
                              void* stream) {
  if (n <= 0 || n > kMaxFields || B <= 0 || H <= 0 || W <= 0 || tile <= 0 ||
      A < 0 || H > TH * tile || W > TW * tile ||
      (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  Fields fs;
  fs.n = n;
  int chunks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + 9 * i;
    Field& f = fs.f[i];
    f.rows = (const char*)d[0];
    f.out = (char*)d[1];
    f.es = (int)d[2];
    f.C = (int)d[3];
    f.sb = d[4];
    f.ss = d[5];
    f.sp = d[6];
    f.sc = d[7];
    f.bg = (unsigned long long)d[8];
    if ((long long)W * f.C > 65535LL * kThreads || !plan(f, W, tile)) {
      return (int)cudaErrorInvalidValue;
    }
    f.first = chunks;
    chunks += (f.units + kThreads - 1) / kThreads;
  }
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  untile_kernel<<<dim3((unsigned)((long long)B * H), (unsigned)chunks),
                  kThreads, 0, (cudaStream_t)stream>>>(
      fs, tileof, H, W, tile, TW, TH * TW, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
