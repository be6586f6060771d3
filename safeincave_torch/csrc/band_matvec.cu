// f32 matrix-free CG1 tetrahedron stiffness action y = A(CT) u on Hopper.
//
// Replaces safeincave_tpu/fem/bandkernel.py:_band_kernel (the Pallas TPU
// kernel).  That kernel's RCM lane shuffles, roll prefix sums and slab
// schedule exist only because Mosaic has no scatter and no general gather;
// a GPU has both, so the computation is laid out afresh in two passes:
//
//   element_forces  one thread per element: gather u at the 4 nodes,
//                   grad = sum_a u_a (x) dN_a, tensorial Voigt strain,
//                   sigma = (CT vol) : eps with vol folded into CT once per
//                   linear solve, f_a,c = sum_j sigma_cj dN_a,j, written to
//                   a (12, E) scratch (coalesced: element axis last).
//   node_sums       one thread per node: sums that node's contributions in
//                   the fixed destination-sorted order of the cumsum plan
//                   (safeincave_tpu/fem/kernels.py _scat_perm/_scat_starts/
//                   _scat_ends) and writes f (N, 3).
//
// No atomics: two launches on the same input give bitwise-identical output,
// which keeps the Krylov iteration counts reproducible.
//
// Bound: per element the first pass reads 36 + 12 floats of tangent and
// gradients, 4 node ids, 12 gathered displacements, and writes 12 forces
// (~290 B).  At cavern600 (16,148 tets, 3,360 nodes) one matvec moves about
// 4.7 MB, which sits in the 50 MB L2; with 63 blocks of 256 threads the card
// is far from saturated, so launch latency, not HBM bandwidth, is the
// expected limit.  Fusing the passes (atomics or a segmented reduction in
// shared memory) and capturing the Krylov loop in a CUDA graph are the
// follow-ups.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void element_forces(const float* __restrict__ ctv,
                               const float* __restrict__ gn,
                               const int* __restrict__ conn,
                               const float* __restrict__ u,
                               float* __restrict__ fe, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;

  float g[4][3];
  float ue[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int node = conn[4 * e + a];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ue[a][c] = u[3 * node + c];
      g[a][c] = gn[(a * 3 + c) * E + e];
    }
  }

  float grad[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = ue[0][i] * g[0][j];
#pragma unroll
      for (int a = 1; a < 4; ++a) s += ue[a][i] * g[a][j];
      grad[i][j] = s;
    }
  }
  const float eps[6] = {grad[0][0], grad[1][1], grad[2][2],
                        0.5f * (grad[0][1] + grad[1][0]),
                        0.5f * (grad[0][2] + grad[2][0]),
                        0.5f * (grad[1][2] + grad[2][1])};

  float sig[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    float s = ctv[(m * 6) * E + e] * eps[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) s += ctv[(m * 6 + k) * E + e] * eps[k];
    sig[m] = s;
  }

  // Voigt index of tensor entry (c, j)
  const int t2v[3][3] = {{0, 3, 4}, {3, 1, 5}, {4, 5, 2}};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fe[(a * 3 + c) * E + e] = sig[t2v[c][0]] * g[a][0] +
                                sig[t2v[c][1]] * g[a][1] +
                                sig[t2v[c][2]] * g[a][2];
    }
  }
}

__global__ void node_sums(const float* __restrict__ fe,
                          const int* __restrict__ perm,
                          const int* __restrict__ starts,
                          const int* __restrict__ ends,
                          float* __restrict__ f, int E, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  const int k1 = ends[n];
  for (int k = starts[n]; k < k1; ++k) {
    const int p = perm[k];          // a * E + e
    const int a = p / E;
    const float* src = fe + (3 * a) * E + (p - a * E);
    s0 += src[0];
    s1 += src[E];
    s2 += src[2 * E];
  }
  f[3 * n] = s0;
  f[3 * n + 1] = s1;
  f[3 * n + 2] = s2;
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() as an int
// (0 on success).  All pointers are device pointers; `fe` is (12, E) scratch.
extern "C" int band_matvec_f32(const float* ctv, const float* gn,
                               const int* conn, const int* perm,
                               const int* starts, const int* ends,
                               const float* u, float* fe, float* f, int E,
                               int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  element_forces<<<(E + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      ctv, gn, conn, u, fe, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  node_sums<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      fe, perm, starts, ends, f, E, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* band_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
