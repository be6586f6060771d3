// f32 matrix-free CG1 tetrahedron stiffness action y = A(CT) u on Hopper.
//
// Replaces safeincave_tpu/fem/bandkernel.py:_band_kernel (the Pallas TPU
// kernel).  That kernel's RCM lane shuffles, roll prefix sums and slab
// schedule exist only because Mosaic has no scatter and no general gather;
// a GPU has both, so the computation is laid out afresh.
//
// Per element: gather u at the 4 nodes, grad = sum_a u_a (x) dN_a,
// tensorial Voigt strain, sigma = (CT vol) : eps with vol folded into CT
// once per linear solve, f_a,c = sum_j sigma_cj dN_a,j; then every node sums
// the forces of the elements around it.
//
// Bound: bytes.  The function has to read the tangent and the gradients
// (36 + 12 floats per element), the connectivity (4 ints) and u, and write
// f: at the band-ordered GridBox nx = 44 (511,104 tets, 91,125 nodes)
// 108.5 MB, 32.4 us at the H100's 3.35 TB/s; the operations are ~2% of
// that.  The node sums are what costs bytes beyond that: written per
// element and gathered back per node they add ~57 MB at nx = 44.  The
// design keeps them on chip instead, with the host tile plan of
// fem/bandkernel.py:BandTilePlan:
//
//   tile_forces   one block per tile of T consecutive elements (band order
//                 keeps a tile's nodes few).  (1) Each thread issues the
//                 loads of its element's corner ids (one 8-byte load) and
//                 48 tangent and gradient floats, and the block stages u of
//                 the tile's local nodes and the tile's tables in shared
//                 memory, all loads in flight together; (2) each thread
//                 writes its element's 12 forces to shared memory; (3) one
//                 thread per local node sums its contributions in the
//                 plan's fixed order, from shared memory only, and writes
//                 one partial (3 floats) to its slot;
//   node_sums     one thread per node sums its partials (3.1 per node at
//                 nx = 44), which lie contiguous and in tile order, and
//                 writes f.
//
// The connectivity is replaced by 2-byte local ids (corner, contrib), so
// the plan's tables are about the size of the int32 connectivity.  No
// atomics anywhere: two launches on the same input give bitwise-identical
// output, which keeps the Krylov iteration counts reproducible.
//
// The f64 action (band_matvec_f64: tile_forces_f64, node_sums_f64) is the
// defect-correction residual b - A u of fem/solvers.py on a band-ordered
// mesh.  It replaces the cumsum plan (fem/kernels.py: scatter and
// segment_sum, a gather, a 3-row prefix sum over the 4E contributions that
// ATen runs in one block, and a difference of boundary rows; some 24
// launches in all), not a TPU kernel: the JAX package's f64 action is that
// plan.  Its bound is bytes too: 8 (48 E + 6 N) B, 15.2 MB and 4.5 us at
// cavern_interlayer_1200.  It keeps the host tile plan, so the sums run in
// the same fixed two-level order, without atomics.  In f64 one thread per
// element would hold 96 registers of loads, so each element takes two
// adjacent lanes: lane h loads the gradients of corners 2h, 2h + 1 (6
// values) and tangent rows 3h .. 3h + 2 (18), 24 loads in flight; the
// lanes add their halves of grad u and trade their three stresses by
// __shfl_xor, and each writes the forces of its two corners.  The kernels
// have their own names (not instances of a template of tile_forces), so a
// profiler trace keeps the two precisions apart.

#include <cuda_runtime.h>

// Mirrored field by field by _BandPlanC in fem/bandkernel.py.  Device
// pointers; the ints are host values.  At file scope: a type of an
// anonymous namespace would give the extern "C" launcher internal linkage.
struct BandPlan {
  const float* gn;        // (12, E) gradients, row 3a + j
  const short* corner;    // (E, 4) local node of each corner
  const short* contrib;   // (4 T n_tiles,) per tile: 4 e_local + a, by
                          // local node; zero after the last element
  const int* tile_lo;     // (n_tiles + 1,) local node range of each tile
  const int* lnode;       // (n_local,) node of each local node
  const int* dst;         // (n_local,) partial slot
  const short* lend;      // (n_local,) end of its contributions in the tile
  const int* pstart;      // (N + 1,) partials of each node
  float* partials;        // (n_local, 3) scratch, owned by the plan
  int n_elems, n_nodes, tile, n_tiles, max_local;
};

namespace {

constexpr int kMaxTile = 256;
constexpr int kThreads = 256;     // node_sums

// At most 64 registers, so that 4 blocks (32 warps) fit on an SM: with its
// 48 element loads in flight a thread would take 80, 3 blocks per SM and
// ~8% more time at nx = 44 on an H100.
__global__ void __launch_bounds__(kMaxTile, 4)
tile_forces(const __grid_constant__ BandPlan p, const float* __restrict__ ctv,
            const float* __restrict__ u) {
  extern __shared__ float smem[];
  const int T = p.tile, ML = p.max_local;
  // forces (12, T), row 3a + c; u (ML, 3); 4T 2-byte contributions; the
  // local nodes' contribution ends and partial slots (ML each)
  float* fe_s = smem;
  float* u_s = fe_s + 12 * T;
  int* contrib_s = reinterpret_cast<int*>(u_s + 3 * ML);
  int* lend_s = contrib_s + 2 * T;
  int* dst_s = lend_s + ML;
  const int t = blockIdx.x, el = threadIdx.x;
  const int e = t * T + el;
  const bool live = e < p.n_elems;
  const size_t E = static_cast<size_t>(p.n_elems);

  // 1. this element's corner ids and 48 tangent and gradient floats
  //    (coalesced, element axis last, ld.global.cs so that the reused u and
  //    tables stay cached), then the tile's tables into shared memory: all
  //    these loads are in flight together
  short4 cn = make_short4(0, 0, 0, 0);
  float g[4][3] = {};
  float cv[36];
  if (live) {
    cn = __ldg(reinterpret_cast<const short4*>(p.corner) + e);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) g[a][c] = __ldcs(p.gn + (a * 3 + c) * E + e);
#pragma unroll
    for (int k = 0; k < 36; ++k) cv[k] = __ldcs(ctv + k * E + e);
  }
  const int lo = p.tile_lo[t];
  const int nl = p.tile_lo[t + 1] - lo;
  for (int l = el; l < nl; l += T) {
    const int n = p.lnode[lo + l];
#pragma unroll
    for (int c = 0; c < 3; ++c) u_s[3 * l + c] = __ldg(u + 3 * n + c);
    lend_s[l] = p.lend[lo + l];
    dst_s[l] = p.dst[lo + l];
  }
  const int* contrib =
      reinterpret_cast<const int*>(p.contrib) + 2 * static_cast<size_t>(t) * T;
  for (int k = el; k < 2 * T; k += T) contrib_s[k] = __ldg(contrib + k);
  __syncthreads();

  // 2. the element's 12 forces into shared memory
  if (live) {
    const int cl[4] = {cn.x, cn.y, cn.z, cn.w};
    float ue[4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) ue[a][c] = u_s[3 * cl[a] + c];
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
      float s = cv[m * 6] * eps[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) s += cv[m * 6 + k] * eps[k];
      sig[m] = s;
    }
    // Voigt index of tensor entry (c, j)
    const int t2v[3][3] = {{0, 3, 4}, {3, 1, 5}, {4, 5, 2}};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        fe_s[(a * 3 + c) * T + el] = sig[t2v[c][0]] * g[a][0] +
                                     sig[t2v[c][1]] * g[a][1] +
                                     sig[t2v[c][2]] * g[a][2];
      }
    }
  }
  __syncthreads();

  // 3. one thread per local node sums its contributions in the plan's
  //    order and writes its partial
  const short* cs = reinterpret_cast<const short*>(contrib_s);
  for (int l = el; l < nl; l += T) {
    const int k1 = lend_s[l];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = l ? lend_s[l - 1] : 0; k < k1; ++k) {
      const int q = cs[k];                       // 4 e_local + a
      const float* src = fe_s + 3 * (q & 3) * T + (q >> 2);
      s0 += src[0];
      s1 += src[T];
      s2 += src[2 * T];
    }
    float* out = p.partials + 3 * static_cast<size_t>(dst_s[l]);
    out[0] = s0;
    out[1] = s1;
    out[2] = s2;
  }
}

__global__ void __launch_bounds__(kThreads)
node_sums(const __grid_constant__ BandPlan p, float* __restrict__ f) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.n_nodes) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  const int q1 = p.pstart[n + 1];
  for (int q = p.pstart[n]; q < q1; ++q) {
    const float* src = p.partials + 3 * static_cast<size_t>(q);
    s0 += src[0];
    s1 += src[1];
    s2 += src[2];
  }
  float* out = f + 3 * static_cast<size_t>(n);
  out[0] = s0;
  out[1] = s1;
  out[2] = s2;
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() as an
// int (0 on success).  `p` is a host struct; ctv (36, E), u and f (N, 3)
// are device pointers.
extern "C" int band_matvec_f32(const BandPlan* p, const float* ctv,
                               const float* u, float* f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  // fe_s, u_s, contrib_s, lend_s, dst_s of tile_forces, in 4-byte words
  const size_t smem = (14 * static_cast<size_t>(p->tile) +
                       5 * static_cast<size_t>(p->max_local)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_forces, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_forces<<<p->n_tiles, p->tile, smem, s>>>(*p, ctv, u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  node_sums<<<(p->n_nodes + kThreads - 1) / kThreads, kThreads, 0, s>>>(*p,
                                                                        f);
  return static_cast<int>(cudaGetLastError());
}

// The f64 action's plan: the f32 plan's tables, the f64 gradients and an
// f64 partials buffer of its own.  Mirrored by _BandPlan64C in
// fem/bandkernel.py.
struct BandPlan64 {
  const double* gn;       // (12, E) gradients, row 3a + j
  const short* corner;    // the tables of BandPlan, shared
  const short* contrib;
  const int* tile_lo;
  const int* lnode;
  const int* dst;
  const short* lend;
  const int* pstart;
  double* partials;       // (n_local, 3) scratch, owned by the plan
  int n_elems, n_nodes, tile, n_tiles, max_local;
};

namespace {

// Two lanes per element: 2T threads, at most 512.  At most 80 registers: a
// lane's 24 loads stay in flight without spilling, and three blocks of 256
// (T = 128, the tile of every cell's mesh) fit on an SM, so the 302 tiles of
// cavern_interlayer_1200 run in one wave.  __launch_bounds__(512) alone makes
// ptxas cap at 64 registers and spill 44 bytes; (512, 1) takes 90 registers,
// two blocks per SM.
__global__ void __maxnreg__(80)
tile_forces_f64(const __grid_constant__ BandPlan64 p,
                const double* __restrict__ ctv,
                const double* __restrict__ u) {
  extern __shared__ double smem64[];
  const int T = p.tile, ML = p.max_local;
  // forces (12, T), row 3a + c; u (ML, 3); 4T 2-byte contributions; the
  // local nodes' contribution ends and partial slots (ML each)
  double* fe_s = smem64;
  double* u_s = fe_s + 12 * T;
  int* contrib_s = reinterpret_cast<int*>(u_s + 3 * ML);
  int* lend_s = contrib_s + 2 * T;
  int* dst_s = lend_s + ML;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int el = tid >> 1, h = tid & 1;     // element of the tile, lane
  const int e = t * T + el;
  const bool live = e < p.n_elems;
  const size_t E = static_cast<size_t>(p.n_elems);

  // 1. the local ids of corners 2h, 2h + 1, their 6 gradients and tangent
  //    rows 3h .. 3h + 2 (a warp's two lanes of an element read two rows,
  //    each 16 consecutive elements: whole sectors), then the tables
  short2 cn = make_short2(0, 0);
  double g[2][3] = {};
  double cv[18] = {};
  if (live) {
    cn = __ldg(reinterpret_cast<const short2*>(p.corner) + 2 * e + h);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g[b][c] = __ldcs(p.gn + ((2 * h + b) * 3 + c) * E + e);
#pragma unroll
    for (int k = 0; k < 18; ++k) cv[k] = __ldcs(ctv + (18 * h + k) * E + e);
  }
  const int lo = p.tile_lo[t];
  const int nl = p.tile_lo[t + 1] - lo;
  for (int l = tid; l < nl; l += 2 * T) {
    const int n = p.lnode[lo + l];
#pragma unroll
    for (int c = 0; c < 3; ++c) u_s[3 * l + c] = __ldg(u + 3 * n + c);
    lend_s[l] = p.lend[lo + l];
    dst_s[l] = p.dst[lo + l];
  }
  const int* contrib =
      reinterpret_cast<const int*>(p.contrib) + 2 * static_cast<size_t>(t) * T;
  for (int k = tid; k < 2 * T; k += 2 * T) contrib_s[k] = __ldg(contrib + k);
  __syncthreads();

  // 2. grad u from both lanes' corners, the stress, the forces of this
  //    lane's corners into shared memory.  Every lane of the warp takes
  //    part in the shuffles (a dead element computes on zeros); both lanes
  //    of an element add the same two halves, so they hold the same grad.
  const int cl[2] = {cn.x, cn.y};
  double grad[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double u0 = u_s[3 * cl[0] + i], u1 = u_s[3 * cl[1] + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double s = u0 * g[0][j] + u1 * g[1][j];
      grad[i][j] = s + __shfl_xor_sync(0xffffffffu, s, 1);
    }
  }
  const double eps[6] = {grad[0][0], grad[1][1], grad[2][2],
                         0.5 * (grad[0][1] + grad[1][0]),
                         0.5 * (grad[0][2] + grad[2][0]),
                         0.5 * (grad[1][2] + grad[2][1])};
  double mine[3], other[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    double s = cv[r * 6] * eps[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) s += cv[r * 6 + k] * eps[k];
    mine[r] = s;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) other[r] = __shfl_xor_sync(0xffffffffu, mine[r], 1);
  double sig[6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    sig[r] = h ? other[r] : mine[r];
    sig[3 + r] = h ? mine[r] : other[r];
  }
  if (live) {
    const int t2v[3][3] = {{0, 3, 4}, {3, 1, 5}, {4, 5, 2}};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        fe_s[((2 * h + b) * 3 + c) * T + el] = sig[t2v[c][0]] * g[b][0] +
                                               sig[t2v[c][1]] * g[b][1] +
                                               sig[t2v[c][2]] * g[b][2];
      }
    }
  }
  __syncthreads();

  // 3. one thread per local node sums its contributions in the plan's
  //    order and writes its partial
  const short* cs = reinterpret_cast<const short*>(contrib_s);
  for (int l = tid; l < nl; l += 2 * T) {
    const int k1 = lend_s[l];
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int k = l ? lend_s[l - 1] : 0; k < k1; ++k) {
      const int q = cs[k];                       // 4 e_local + a
      const double* src = fe_s + 3 * (q & 3) * T + (q >> 2);
      s0 += src[0];
      s1 += src[T];
      s2 += src[2 * T];
    }
    double* out = p.partials + 3 * static_cast<size_t>(dst_s[l]);
    out[0] = s0;
    out[1] = s1;
    out[2] = s2;
  }
}

__global__ void __launch_bounds__(kThreads)
node_sums_f64(const __grid_constant__ BandPlan64 p, double* __restrict__ f) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.n_nodes) return;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  const int q1 = p.pstart[n + 1];
  for (int q = p.pstart[n]; q < q1; ++q) {
    const double* src = p.partials + 3 * static_cast<size_t>(q);
    s0 += src[0];
    s1 += src[1];
    s2 += src[2];
  }
  double* out = f + 3 * static_cast<size_t>(n);
  out[0] = s0;
  out[1] = s1;
  out[2] = s2;
}

}  // namespace

// The f64 action: as band_matvec_f32, on double ctv (36, E), u and f.
extern "C" int band_matvec_f64(const BandPlan64* p, const double* ctv,
                               const double* u, double* f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  // fe_s and u_s in 8-byte words, contrib_s, lend_s and dst_s in 4-byte
  const size_t smem = (12 * static_cast<size_t>(p->tile) +
                       3 * static_cast<size_t>(p->max_local)) * 8 +
                      (2 * static_cast<size_t>(p->tile) +
                       2 * static_cast<size_t>(p->max_local)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_forces_f64, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_forces_f64<<<p->n_tiles, 2 * p->tile, smem, s>>>(*p, ctv, u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  node_sums_f64<<<(p->n_nodes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      *p, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* band_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
