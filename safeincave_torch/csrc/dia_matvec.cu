// Block-DIA stiffness action y = A u on Hopper, in float and double.
//
// Replaces safeincave_tpu/fem/dia.py:BlockDIA._make_pallas_call (the Pallas
// TPU kernel).  That kernel multiplies the offset value planes against a
// materialised stack of shifted copies of u (_shift_stack), because Mosaic
// wants static slices; a GPU thread reads u at i + off_d directly, so the
// stack is gone:
//
//   y[i, c] = sum_d sum_c' vals[(9d + 3c + c') ld + i] * u[3 (i + off_d) + c']
//
// Bound: bytes.  A matvec has to read the true nonzeros of the 9 Dn planes
// once, plus u and y: at nx = 44 (91,125 nodes, Dn = 15) ~49.5 MB in f32,
// 14.8 us at the H100's 3.35 TB/s; the operations are under 2% of that.
// What the design does about it:
//
//   - each thread owns 4 consecutive nodes and reads each of its 9 plane
//     rows per offset as one 16-byte vector (float4; two double2 in
//     double).  The node stride `ld` of the planes is padded to a multiple
//     of 4 with zero columns, so every vector is aligned, and a warp reads
//     512 contiguous bytes of a row;
//   - the planes are read with streaming loads (ld.global.cs, evict-first),
//     so that u, read Dn times per node by neighbouring threads, stays in
//     L1 and L2 while the planes stream past;
//   - the offsets travel in the kernel's parameter block, which lives in
//     constant memory (__grid_constant__: no per-thread copy);
//   - a block is 32 node groups (one warp wide) by S offset slices: slice s
//     sums offsets [s Dn / S, (s + 1) Dn / S) and the slices are added in
//     shared memory in slice order.  The host picks S so that the grid has
//     16 warps per SM, enough loads in flight to cover HBM's latency: at
//     nx = 44 (22,782 groups, 5.4 warps per SM when S = 1) S = 3; at
//     nx = 17 (1,458 groups, 46 warps when S = 1: 86 SMs idle) S = 8.
//
// Reads of u outside [0, N) are not made: by the assembly's padding
// contract their coefficients are exact zeros, and a zero stands in for
// u.  Each node sums its three components over the offsets and the three
// c' in a fixed order (the offsets of each slice, then the slices), with
// no atomics, and S depends on N alone, so two launches on the same input
// give bitwise-identical output.

#include <cuda_runtime.h>

constexpr int kMaxOffsets = 96;   // MAX_OFFSETS in fem/dia.py

// Mirrored field by field by _DiaParams in fem/dia.py.  At file scope: a
// type of an anonymous namespace would give the extern "C" launchers
// internal linkage.
struct DiaParams {
  int n;                  // nodes
  int ld;                 // node stride of the planes, a multiple of 4
  int dn;                 // offsets
  int off[kMaxOffsets];   // column offsets j - i, sorted
};

namespace {

constexpr int kNodes = 4;         // nodes per thread
constexpr int kLanes = 32;        // node groups per block
constexpr int kMaxSlices = 8;     // offset slices per block
constexpr int kSMs = 132;

__device__ __forceinline__ void load4(const float* p, float (&v)[kNodes]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[kNodes]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store12(float* p, const float (&a)[kNodes][3]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(a[0][0], a[0][1], a[0][2], a[1][0]);
  q[1] = make_float4(a[1][1], a[1][2], a[2][0], a[2][1]);
  q[2] = make_float4(a[2][2], a[3][0], a[3][1], a[3][2]);
}

__device__ __forceinline__ void store12(double* p,
                                        const double (&a)[kNodes][3]) {
  double2* q = reinterpret_cast<double2*>(p);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    q[k] = make_double2(a[(2 * k) / 3][(2 * k) % 3],
                        a[(2 * k + 1) / 3][(2 * k + 1) % 3]);
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxSlices)
dia_matvec(const __grid_constant__ DiaParams p, const T* __restrict__ vals,
           const T* __restrict__ u, T* __restrict__ y) {
  __shared__ T part[kMaxSlices - 1][kNodes * 3][kLanes];
  const int lane = threadIdx.x, s = threadIdx.y, S = blockDim.y;
  const int i0 = (blockIdx.x * kLanes + lane) * kNodes;
  const bool live = i0 < p.n;
  const size_t ld = static_cast<size_t>(p.ld);
  T acc[kNodes][3];
#pragma unroll
  for (int m = 0; m < kNodes; ++m) acc[m][0] = acc[m][1] = acc[m][2] = T(0);

  const int d1 = live ? (s + 1) * p.dn / S : 0;
#pragma unroll 3
  for (int d = s * p.dn / S; d < d1; ++d) {
    const int j0 = i0 + p.off[d];
    T uj[kNodes][3];
    if (j0 >= 0 && j0 + kNodes <= p.n) {
      const T* up = u + 3 * static_cast<size_t>(j0);
#pragma unroll
      for (int m = 0; m < kNodes; ++m)
#pragma unroll
        for (int c = 0; c < 3; ++c) uj[m][c] = __ldg(up + 3 * m + c);
    } else {
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
        const int j = j0 + m;
        const bool in = j >= 0 && j < p.n;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          uj[m][c] = in ? __ldg(u + 3 * static_cast<size_t>(j) + c) : T(0);
      }
    }
    const T* v = vals + 9 * static_cast<size_t>(d) * ld + i0;
    T r[9][kNodes];
#pragma unroll
    for (int k = 0; k < 9; ++k) load4(v + k * ld, r[k]);
#pragma unroll
    for (int m = 0; m < kNodes; ++m)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[m][c] += r[3 * c][m] * uj[m][0] + r[3 * c + 1][m] * uj[m][1] +
                     r[3 * c + 2][m] * uj[m][2];
  }

  if (S > 1) {                 // slice 0 adds the others, in slice order
    if (s > 0) {
#pragma unroll
      for (int m = 0; m < kNodes; ++m)
#pragma unroll
        for (int c = 0; c < 3; ++c) part[s - 1][3 * m + c][lane] = acc[m][c];
    }
    __syncthreads();
    if (s > 0) return;
    for (int t = 0; t < S - 1; ++t)
#pragma unroll
      for (int m = 0; m < kNodes; ++m)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[m][c] += part[t][3 * m + c][lane];
  }
  if (!live) return;
  T* yp = y + 3 * static_cast<size_t>(i0);
  if (i0 + kNodes <= p.n) {
    store12(yp, acc);          // 12 values at a 16-byte aligned address
  } else {
#pragma unroll
    for (int m = 0; m < kNodes; ++m)
      if (i0 + m < p.n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) yp[3 * m + c] = acc[m][c];
      }
  }
}

template <typename T>
int launch(const DiaParams* p, const T* vals, const T* u, T* y,
           void* stream) {
  const int blocks = (p->ld / kNodes + kLanes - 1) / kLanes;
  // the fewest offset slices that give >= 16 warps per SM, at most 8 and
  // at least one offset per slice
  int slices = (16 * kSMs + blocks - 1) / blocks;
  slices = slices < kMaxSlices ? slices : kMaxSlices;
  slices = slices < p->dn ? slices : p->dn;
  slices = slices > 1 ? slices : 1;
  dia_matvec<T><<<blocks, dim3(kLanes, slices), 0,
                  static_cast<cudaStream_t>(stream)>>>(*p, vals, u, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; `p` is a host struct, all other pointers are device
// pointers: vals (9 Dn, ld), u and y (N, 3).  Returns cudaGetLastError() as
// an int (0 on success).
extern "C" int dia_matvec_f32(const DiaParams* p, const float* vals,
                              const float* u, float* y, void* stream) {
  return launch(p, vals, u, y, stream);
}

extern "C" int dia_matvec_f64(const DiaParams* p, const double* vals,
                              const double* u, double* y, void* stream) {
  return launch(p, vals, u, y, stream);
}

extern "C" const char* dia_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
