// Block-DIA stiffness action y = A u on Hopper, in float and double.
//
// Replaces safeincave_tpu/fem/dia.py:BlockDIA._make_pallas_call (the Pallas
// TPU kernel).  That kernel multiplies the offset value planes against a
// materialised stack of shifted copies of u (_shift_stack), because Mosaic
// wants static slices; a GPU thread reads u at i + off_d directly, so the
// stack is gone:
//
//   y[i, c] = sum_d sum_c' vals[(9d + 3c + c') N + i] * u[3 (i + off_d) + c']
//
// One thread per node i accumulates its three components over the Dn
// offsets (<= 96) and the three c' in a fixed order and writes y (N, 3).
// Reads of u outside [0, N) are skipped: by the assembly's padding contract
// their coefficients are exact zeros.  No atomics, so two launches on the
// same input give bitwise-identical output.
//
// Bound: every matvec streams the 9 Dn planes once (vals is node-last, so a
// warp's plane reads are coalesced) plus u and y.  At nx = 44 (91,125 nodes,
// Dn = 15) the f32 planes are 135 * 91,125 * 4 B = 49.2 MB and u, y ~2.2 MB:
// ~15 us at the H100's 3.35 TB/s, memory-bound.  At nx = 17 the planes are
// 3.1 MB and stay in the 50 MB L2, so there launch latency bounds it.  u is
// read 15 times per node through L1/L2 (neighbouring threads read
// neighbouring nodes).  Vectorised loads, fusing the Dirichlet mask and a
// CUDA graph of the Krylov loop are the follow-ups.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_matvec(const T* __restrict__ vals,
                           const T* __restrict__ u,
                           const int* __restrict__ offsets, int Dn, int N,
                           T* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t n = static_cast<size_t>(N);
  T a0 = 0, a1 = 0, a2 = 0;
  for (int d = 0; d < Dn; ++d) {
    const int j = i + offsets[d];
    if (j < 0 || j >= N) continue;
    const T u0 = u[3 * j], u1 = u[3 * j + 1], u2 = u[3 * j + 2];
    const T* v = vals + 9 * d * n + i;
    a0 += v[0] * u0 + v[n] * u1 + v[2 * n] * u2;
    a1 += v[3 * n] * u0 + v[4 * n] * u1 + v[5 * n] * u2;
    a2 += v[6 * n] * u0 + v[7 * n] * u1 + v[8 * n] * u2;
  }
  y[3 * i] = a0;
  y[3 * i + 1] = a1;
  y[3 * i + 2] = a2;
}

template <typename T>
int launch(const T* vals, const T* u, const int* offsets, int Dn, int N,
           T* y, void* stream) {
  dia_matvec<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(vals, u, offsets, Dn,
                                                       N, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; all pointers are device pointers: vals (9 Dn, N),
// u and y (N, 3), offsets (Dn,) int32.  Returns cudaGetLastError() as an int
// (0 on success).
extern "C" int dia_matvec_f32(const float* vals, const float* u,
                              const int* offsets, int Dn, int N, float* y,
                              void* stream) {
  return launch(vals, u, offsets, Dn, N, y, stream);
}

extern "C" int dia_matvec_f64(const double* vals, const double* u,
                              const int* offsets, int Dn, int N, double* y,
                              void* stream) {
  return launch(vals, u, offsets, Dn, N, y, stream);
}

extern "C" const char* dia_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
