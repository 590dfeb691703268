// Span markers: one-thread kernels that do nothing, launched on the
// current stream where a span of the program opens and closes
// (utils/timing.py). The profiler names each launch by its template
// arguments, trt_span_marker<id, open>, so its own kernel records place
// the span on the device's clock; under CUDA graph capture each marker is
// a node of the graph, recorded again by every replay.

#include <cuda_runtime.h>

namespace {

constexpr int kSpanIds = 16;   // ids utils/timing.py DEVICE_SPANS may use

template <int ID, int OPEN>
__global__ void trt_span_marker() {}

template <int ID>
int launch_marker(int open, cudaStream_t stream) {
  if (open) {
    trt_span_marker<ID, 1><<<1, 1, 0, stream>>>();
  } else {
    trt_span_marker<ID, 0><<<1, 1, 0, stream>>>();
  }
  return (int)cudaGetLastError();
}

template <int... IDS>
struct Markers;

template <>
struct Markers<> {
  static int launch(int, int, cudaStream_t) {
    return (int)cudaErrorInvalidValue;
  }
};

template <int ID, int... REST>
struct Markers<ID, REST...> {
  static int launch(int id, int open, cudaStream_t stream) {
    return id == ID ? launch_marker<ID>(open, stream)
                    : Markers<REST...>::launch(id, open, stream);
  }
};

}  // namespace

extern "C" {

// Enqueues the marker of span `id` (0 <= id < 16), opening or closing, on
// `stream`, and returns cudaGetLastError().
int trt_span_marker_launch(int id, int open, int device, void* stream) {
  if (id < 0 || id >= kSpanIds) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  return Markers<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                 15>::launch(id, open, (cudaStream_t)stream);
}

}  // extern "C"
