// f32 y = P x for the dense preconditioner's symmetric inverse P, from its
// packed upper triangle, on Hopper.
//
// Replaces no TPU kernel.  The dense preconditioner (fem/momentum.py,
// build_preconditioner, mode "dense") inverts the masked elastic operator;
// that inverse is symmetric, and the port applied it as torch.mv over the
// full (3N)^2 matrix (cuBLAS gemv).  That gemv took the most device time of
// both benchmark cells: 129.5 ms of a 211 ms step at the 38,542-tet nobian
// mesh (69% of device time) and 29.8 ms of 114 ms at cavern600 (31%), about
// two applies per BiCGStab iteration.  Half of the bytes it read were the
// other half again.
//
// Bound: bytes.  The function needs the triangle, 4 n (n + 1) / 2 bytes: at
// n = 3N = 23,007 1.059 GB, 316 us at the H100's 3.35 TB/s (n = 10,080:
// 203 MB, 61 us); 2 n^2 flops are ~5% of that.  Each element of the
// triangle is read from HBM once and used twice:
//
//   sym_tiles   a persistent grid (one block per SM) over the flat index
//               of the packed chunks, equal runs of chunks per block.  A
//               tile (I, J >= I) of B x B (B = 128) lies in 4 chunks of
//               128 rows x 32 columns, 16 KB each, each fetched whole into a
//               ring of shared-memory stages by one TMA bulk copy
//               (cp.async.bulk, L2 evict-first) that completes on the
//               stage's mbarrier.
//               Thread (warp w, lane c) reads column c of rows
//               16 w .. 16 w + 15 of a chunk (no bank conflicts) and
//               (1) adds T[r][c] x[col c] to its row sums, which stay in
//               registers while the run stays in row block I, and (2) sums
//               T[r][c] x_I[r] over its rows: the column partial T^T x_I,
//               reduced over the 8 warps in a fixed order.  A chunk of the
//               diagonal tile (the whole symmetric block) gives row sums
//               only.  A block writes one column partial (32 floats) per
//               off-diagonal chunk and one row partial (128 floats) per
//               row block its run touches;
//   sym_sums    one block per 32 outputs sums their row partials (in
//               block order) and column partials (8 strided runs, then
//               the runs in warp order) and writes y.
//
// Beyond the triangle the traffic is the partials (written and read:
// 2 / B of the triangle, 1.6%), the diagonal tiles' lower halves
// and the zero padding to a multiple of B (0.8% at n = 23,007), and x and y.
// No atomics anywhere: two launches on the same input give bitwise-identical
// output, which keeps the Krylov iteration counts reproducible.

#include <cuda_runtime.h>

#include <cstdint>

// Mirrored field by field by _SymPlanC in fem/symdense.py.  Device
// pointers; the ints are host values.
struct SymPlan {
  const float* tiles;     // (n_chunks, B, 32) packed upper triangle
  const int* cta_row;     // (grid,) row block of each block's first chunk
  const int* cta_seg;     // (grid + 1,) first row-partial slot of each block
  const int* seg_row;     // (nb + 1,) row-partial slots of each row block
  float* colpart;         // (n_off, 32) scratch: column partials
  float* rowpart;         // (n_seg, B) scratch: row partials
  int n, nb, n_chunks, grid;
};

namespace {

constexpr int B = 128;                    // tile size
constexpr int P = B / 32;                 // chunks per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = B / kWarps;         // rows of a chunk per warp
constexpr int kChunk = B * 32;            // floats per chunk
// Shared-memory stages in flight per SM: two 16 KB chunks at B = 128.  On
// an H100 with the evict-first hint, rings of 32, 48, 64 and 128 KB, and
// 2 or 4 blocks per SM, all read 343-354 us at n = 23,007, as a variant
// that computes nothing does (343.5); 32 KB was the fastest at n = 10,080
// (72.0 us against 74.8 at 64 KB) and keeps the block under 48 KB of
// shared memory.
constexpr int kRingBytes = 32 * 1024;
constexpr int kStages = kRingBytes / (kChunk * 4);
constexpr size_t kSmem = kRingBytes + 2 * kThreads * 4 + kStages * 8;
static_assert(kSmem <= 48 * 1024, "the ring needs no shared-memory attribute");

// first chunk of row block I: P sum_{I' < I} (nb - I')
__device__ __forceinline__ int row_offset(int I, int nb) {
  return P * (I * nb - I * (I - 1) / 2);
}

// first column-partial slot of column chunk j: sum_{j' < j} floor(j' / P)
__device__ __forceinline__ int col_offset(int j) {
  const int q = j / P, s = j - q * P;
  return P * (q * (q - 1) / 2) + s * q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An L2 policy that evicts the streamed tiles first, so that they do not
// push x, y and the partials out of L2 (and write back dirty lines) on their
// way through: 89.8% of the bound at n = 23,007 against 80.8% without it on
// an H100.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// one TMA bulk copy of `bytes` into a stage, completing on its mbarrier
__device__ __forceinline__ void fetch(float* dst, const float* src,
                                      uint32_t bytes, uint64_t* bar,
                                      uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy)
      : "memory");
}

__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads, 1)
sym_tiles(const __grid_constant__ SymPlan p, const float* __restrict__ x) {
  constexpr int R = kRows, C = kChunk, NS = kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* red = ring + NS * C;                         // 2 x (8 warps x 32)
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * kThreads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, n = p.n, nb = p.nb;
  const int k0 = static_cast<int>(
      static_cast<long long>(p.n_chunks) * b / p.grid);
  const int count = static_cast<int>(
      static_cast<long long>(p.n_chunks) * (b + 1) / p.grid) - k0;
  const float* src = p.tiles + static_cast<size_t>(k0) * C;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t policy = evict_first();
  if (tid == 0)
    for (int s = 0; s < NS && s < count; ++s)
      fetch(ring + s * C, src + static_cast<size_t>(s) * C, C * 4, full + s,
            policy);

  int I = p.cta_row[b];
  int j = P * I + (k0 - row_offset(I, nb));           // column chunk
  int seg = p.cta_seg[b];
  const int r0 = warp * R;                            // this warp's rows
  float xr[R], racc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = I * B + r0 + r;
    xr[r] = i < n ? __ldg(x + i) : 0.f;
    racc[r] = 0.f;
  }
  int col = 32 * j + lane;
  float xc = col < n ? __ldg(x + col) : 0.f;

  for (int t = 0; t < count; ++t) {
    const int s = t % NS;
    wait_stage(full + s, static_cast<uint32_t>(t / NS) & 1u);
    const float* ch = ring + s * C + r0 * 32 + lane;
    float cacc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = ch[r * 32];
      racc[r] = fmaf(v, xc, racc[r]);
      cacc = fmaf(v, xr[r], cacc);
    }
    float* red_t = red + (t & 1) * kThreads;
    red_t[tid] = cacc;
    __syncthreads();            // stage s read by every warp; red_t written
    if (tid == 0 && t + NS < count)
      fetch(ring + s * C, src + static_cast<size_t>(t + NS) * C, C * 4,
            full + s, policy);
    if (warp == 0 && j >= P * (I + 1)) {              // off-diagonal chunk
      float sum = red_t[lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red_t[w * 32 + lane];
      p.colpart[(static_cast<size_t>(col_offset(j)) + I) * 32 + lane] = sum;
    }
    ++j;
    const bool row_end = j == P * nb;
    if (row_end || t == count - 1) {
      // this run's row partial of row block I: each row summed over the
      // warp's 32 lanes (a butterfly, the same bits in every lane)
      float* out = p.rowpart + static_cast<size_t>(seg) * B + r0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = racc[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == r) out[r] = v;
        racc[r] = 0.f;
      }
      ++seg;
      if (row_end) {
        ++I;
        j = P * I;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = I * B + r0 + r;
          xr[r] = i < n ? __ldg(x + i) : 0.f;
        }
      }
    }
    col = 32 * j + lane;        // the next chunk's x, loaded ahead
    xc = col < n ? __ldg(x + col) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
sym_sums(const __grid_constant__ SymPlan p, float* __restrict__ y) {
  __shared__ float red[kThreads];
  const int j = blockIdx.x, I = j / P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cp = p.colpart + static_cast<size_t>(col_offset(j)) * 32;
  float s = 0.f;
  for (int q = warp; q < I; q += kWarps) s += cp[q * 32 + lane];
  red[tid] = s;
  __syncthreads();
  if (warp != 0) return;
  const int rr = (j - P * I) * 32 + lane;             // row within block I
  float v = 0.f;
  for (int g = p.seg_row[I]; g < p.seg_row[I + 1]; ++g)
    v += p.rowpart[static_cast<size_t>(g) * B + rr];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w * 32 + lane];
  const int i = 32 * j + lane;
  if (i < p.n) y[i] = v;
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() as an int
// (0 on success).  `p` is a host struct; x and y (n,) are device pointers.
extern "C" int sym_dense_matvec_f32(const SymPlan* p, const float* x,
                                    float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->grid < 1 || p->n_chunks < p->grid)
    return static_cast<int>(cudaErrorInvalidValue);
  sym_tiles<<<p->grid, kThreads, kSmem, s>>>(*p, x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_sums<<<P * p->nb, kThreads, 0, s>>>(*p, y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sym_dense_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
