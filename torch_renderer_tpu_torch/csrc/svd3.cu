// Batched 3x3 singular value decomposition for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (torch_renderer_tpu_torch/_build.py).
//
// It replaces no Pallas kernel. The JAX package's ICP calls jnp.linalg.svd
// in umeyama (torch_renderer_tpu/ops/icp.py:68), which XLA lowers itself,
// inside the one compiled program of the whole registration. The port
// needs a kernel of its own because torch.linalg.svd on a CUDA tensor waits
// for the host (it reads the solver's status back): ICP's 100 steps would
// cost 100 host round trips, and a step that holds one cannot be captured
// as a CUDA graph.
//
//   a (n, 3, 3) row-major float32 -> u (n, 3, 3), s (n, 3), vt (n, 3, 3)
//   with a = u diag(s) vt, s descending and >= 0, u and vt orthogonal.
//
// One thread a matrix, everything in registers: one-sided (Hestenes)
// Jacobi on the columns b_j of B = A V, kSweeps cyclic sweeps over the
// pairs (0, 1), (0, 2), (1, 2), each rotation making its pair orthogonal
// (skipped where the pair's dot product is exactly 0); then the columns
// sorted by norm (a three-comparator network), s_j = |b_j|,
// u_0 = b_0 / s_0, u_1 = b_1 minus its u_0 part, normalized (where that is
// zero: the unit axis least aligned with u_0, minus its u_0 part),
// u_2 = u_0 x u_1, negated where u_2 . b_2 < 0. So u stays orthogonal for
// rank-2 and rank-1 inputs. cuda_svd3.svd3_jacobi repeats this arithmetic
// in plain PyTorch.
//
// Bound: latency. The ICP's 300 matrices move 36 KB in and 84 KB out, and
// 8 sweeps of 3 rotations take about 1,650 operations a matrix: far under
// a microsecond at the card's rates. What sets the time is one thread's
// chain of dependent operations (square roots and divides in every
// rotation), about 8 us on an H100; the design is no more than one thread
// a matrix in blocks of 128, with no shared memory and no synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 8;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void rotate(float (&b)[3][3], float (&v)[3][3],
                                       int p, int q) {
  const float alpha = dot3(b[p], b[p]);
  const float beta = dot3(b[q], b[q]);
  const float gamma = dot3(b[p], b[q]);
  if (gamma == 0.0f) return;
  const float zeta = (beta - alpha) / (2.0f * gamma);
  const float t =
      copysignf(1.0f, zeta) / (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = c * t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bp = b[p][i], bq = b[q][i];
    b[p][i] = c * bp - s * bq;
    b[q][i] = s * bp + c * bq;
    const float vp = v[p][i], vq = v[q][i];
    v[p][i] = c * vp - s * vq;
    v[q][i] = s * vp + c * vq;
  }
}

// Swap columns i and j of b and v (and their norms) where n[i] < n[j].
__device__ __forceinline__ void order(float (&b)[3][3], float (&v)[3][3],
                                      float (&n)[3], int i, int j) {
  if (!(n[i] < n[j])) return;
  const float t = n[i];
  n[i] = n[j];
  n[j] = t;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float x = b[i][k];
    b[i][k] = b[j][k];
    b[j][k] = x;
    x = v[i][k];
    v[i][k] = v[j][k];
    v[j][k] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
svd3_kernel(const float* __restrict__ a, float* __restrict__ u,
            float* __restrict__ s, float* __restrict__ vt, int n) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= n) return;
  const float* am = a + 9 * (long long)m;
  // b[j] is column j of B = A V, v[j] column j of V
  float b[3][3], v[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b[j][i] = am[3 * i + j];
      v[j][i] = i == j ? 1.0f : 0.0f;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate(b, v, 0, 1);
    rotate(b, v, 0, 2);
    rotate(b, v, 1, 2);
  }
  float nrm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) nrm[j] = sqrtf(dot3(b[j], b[j]));
  order(b, v, nrm, 0, 1);
  order(b, v, nrm, 1, 2);
  order(b, v, nrm, 0, 1);

  float u0[3], u1[3], u2[3];
  if (nrm[0] > 0.0f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u0[i] = b[0][i] / nrm[0];
  } else {
    u0[0] = 1.0f;
    u0[1] = 0.0f;
    u0[2] = 0.0f;
  }
  float d = dot3(u0, b[1]);
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = b[1][i] - d * u0[i];
  float n1 = sqrtf(dot3(u1, u1));
  if (!(n1 > 0.0f)) {
    // the unit axis least aligned with u0, minus its u0 part
    const float ax = fabsf(u0[0]), ay = fabsf(u0[1]), az = fabsf(u0[2]);
    const int k = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
#pragma unroll
    for (int i = 0; i < 3; ++i) u1[i] = (i == k ? 1.0f : 0.0f) - u0[k] * u0[i];
    n1 = sqrtf(dot3(u1, u1));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] / n1;
  u2[0] = u0[1] * u1[2] - u0[2] * u1[1];
  u2[1] = u0[2] * u1[0] - u0[0] * u1[2];
  u2[2] = u0[0] * u1[1] - u0[1] * u1[0];
  if (dot3(u2, b[2]) < 0.0f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] = -u2[i];
  }

  float* um = u + 9 * (long long)m;
  float* vm = vt + 9 * (long long)m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    um[3 * i + 0] = u0[i];
    um[3 * i + 1] = u1[i];
    um[3 * i + 2] = u2[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) vm[3 * j + i] = v[j][i];
    s[3 * (long long)m + i] = nrm[i];
  }
}

}  // namespace

extern "C" {

// Decomposes n matrices. Enqueues on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and a later synchronize
// would not report it.
int trt_svd3(const float* a, float* u, float* s, float* vt, int n,
             int device, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  svd3_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(a, u, s, vt, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
