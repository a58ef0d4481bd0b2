// Whole-loop Sinkhorn on matrices held in shared memory, for sm_90a.
//
// Replaces otgan_tpu/ops/sinkhorn_pallas.py::_sinkhorn_kernel (launched by
// _sinkhorn_pallas_batched). Given costs C, shape (b, n, m) float32
// row-major, one launch per match
//
//   1. reads C once and forms x = -lam * C in shared memory, each row shifted
//      by its max (absorbed by the row potential; keeps lam = 500 near 0,
//      where float32 spacing is fine);
//   2. runs n_iters iterations of
//          u_i = -logsumexp_j(x_ij + v_j)          (row step)
//          v_j = -logsumexp_i(x_ij + u_i)          (column step; REPLACES v)
//      from v = 0;
//   3. writes P = softmax_rows(x + v) once (the row potential drops out of a
//      row softmax) and ent[b] = mean_i(-sum_j P_ij logP_ij), with
//      logP = (y - rowmax) - log(rowsum), never log(P).
//
// The TPU kernel keeps the whole matrix in VMEM and carries y = x + v only
// because Mosaic cannot carry a (1, M) vector. Here one thread-block cluster
// owns one matrix: its `cs` blocks each keep a band of whole rows of x in
// their own shared memory for the whole loop, with u (band) and v (m). The
// row step is local to a block. For the column step each block writes its
// band's per-column (max, rescaled sum) partials to its shared memory,
// cluster.sync(), then reads every block's partials through distributed
// shared memory (map_shared_rank) and forms the whole v itself. The partials
// are double-buffered by iteration parity, so one cluster barrier per
// iteration suffices: a block can only overwrite a buffer after every block
// has passed the next iteration's barrier, i.e. finished reading it.
//
// What bounds it on an H100: nothing leaves the SMs inside the loop; C is
// read once and P written once (2 x 2.36 MB at 768^2), so the bound is the
// ~10 float32 operations per cell per iteration, and at the small shapes
// this tier serves (6 x 128^2, 6 x 256^2) the per-iteration barriers. One
// launch replaces kernel 1's 2 x n_iters launches. This first version is
// simple: scalar shared-memory loads, two passes per step (max, then sum),
// no TMA, no register residency.
//
// Numerics: expf/logf, never the fast-math intrinsics. A max starts at -inf
// with a sum of 0, and a -inf partial contributes nothing. Ragged n and m
// are bounds-masked: a block whose band starts past n holds no rows and
// contributes (-inf, 0) partials.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;              // non-portable above 8
constexpr size_t kMaxSmem = 232448;          // 227 KB a block on sm_90
constexpr int kErrNoCluster = 100001;        // no cluster of this size fits

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block, in floats: the band of x, v, two parities of
// the (max, sum) partials, u, and kWarps + 1 slots for the entropy sum (the
// layout resident_sinkhorn carves out; ops/sinkhorn_resident_cuda.py plans
// with the same sum).
inline size_t smem_floats(int band, int m) {
  return (size_t)band * m + 5 * (size_t)m + band + kWarps + 1;
}

// Grid (cs, b), cluster (cs, 1, 1): cluster `blockIdx.y` owns matrix
// blockIdx.y; block blockIdx.x of it owns rows [blockIdx.x * band, + band).
__global__ void __launch_bounds__(kThreads)
resident_sinkhorn(const float* __restrict__ cost, float* __restrict__ p_out,
                  float* __restrict__ ent_out, int n, int m, int band, int cs,
                  float lam, int n_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* xs = smem;                          // band * m
  float* v = xs + (size_t)band * m;          // m
  float* part_m = v + m;                     // 2 * m
  float* part_s = part_m + 2 * (size_t)m;    // 2 * m
  float* u = part_s + 2 * (size_t)m;         // band
  float* red = u + band;                     // kWarps + 1

  const int rank = blockIdx.x;
  const int mat = blockIdx.y;
  const int row0 = rank * band;
  const int rows = max(0, min(band, n - row0));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // 1. x = -lam * C, each row shifted by its max
  const float* cm = cost + ((size_t)mat * n + row0) * m;
  for (int r = warp; r < rows; r += kWarps) {
    float* xr = xs + (size_t)r * m;
    const float* cr = cm + (size_t)r * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) {
      const float t = -lam * cr[j];
      xr[j] = t;
      mx = fmaxf(mx, t);
    }
    mx = warp_max(mx);
    for (int j = lane; j < m; j += 32) xr[j] -= mx;
  }
  for (int j = tid; j < m; j += kThreads) v[j] = 0.f;
  __syncthreads();

  // 2. the loop; nothing leaves the cluster
  for (int it = 0; it < n_iters; ++it) {
    for (int r = warp; r < rows; r += kWarps) {
      const float* xr = xs + (size_t)r * m;
      float mx = -INFINITY;
      for (int j = lane; j < m; j += 32) mx = fmaxf(mx, xr[j] + v[j]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < m; j += 32) s += expf(xr[j] + v[j] - mx);
      s = warp_sum(s);
      if (lane == 0) u[r] = -(mx + logf(s));
    }
    __syncthreads();
    float* pm = part_m + (size_t)(it & 1) * m;
    float* ps = part_s + (size_t)(it & 1) * m;
    for (int j = tid; j < m; j += kThreads) {
      float mx = -INFINITY;
      for (int r = 0; r < rows; ++r) mx = fmaxf(mx, xs[(size_t)r * m + j] + u[r]);
      float s = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < rows; ++r) s += expf(xs[(size_t)r * m + j] + u[r] - mx);
      }
      pm[j] = mx;
      ps[j] = s;
    }
    cluster.sync();  // every block's partials of this parity are visible
    for (int j = tid; j < m; j += kThreads) {
      float mx = -INFINITY;
      for (int q = 0; q < cs; ++q) mx = fmaxf(mx, cluster.map_shared_rank(pm, q)[j]);
      float s = 0.f;
      for (int q = 0; q < cs; ++q) {
        const float mq = cluster.map_shared_rank(pm, q)[j];
        if (mq != -INFINITY) s += cluster.map_shared_rank(ps, q)[j] * expf(mq - mx);
      }
      v[j] = -(mx + logf(s));
    }
    __syncthreads();
  }

  // 3. P = softmax_rows(x + v) and the band's sum of row entropies
  float ent = 0.f;  // lane 0's running sum over this warp's rows
  float* pb = p_out + ((size_t)mat * n + row0) * m;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = xs + (size_t)r * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, xr[j] + v[j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < m; j += 32) s += expf(xr[j] + v[j] - mx);
    s = warp_sum(s);
    const float log_s = logf(s);
    float h = 0.f;
    float* pr = pb + (size_t)r * m;
    for (int j = lane; j < m; j += 32) {
      const float y = xr[j] + v[j] - mx;
      const float p = expf(y) / s;
      pr[j] = p;
      h += p * (y - log_s);
    }
    h = warp_sum(h);
    if (lane == 0) ent -= h;
  }
  if (lane == 0) red[warp] = ent;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    red[kWarps] = t;
  }
  cluster.sync();  // every block's band sum is visible
  if (rank == 0 && tid == 0) {
    float t = 0.f;
    for (int q = 0; q < cs; ++q) t += cluster.map_shared_rank(red + kWarps, q)[0];
    ent_out[mat] = t / (float)n;
  }
  cluster.sync();  // no block leaves while rank 0 still reads its memory
}

}  // namespace

extern "C" {

// One launch on `stream`: cost (b, n, m) -> p (b, n, m), ent (b), all
// float32, allocated by the caller; `cs` blocks a cluster, one cluster a
// matrix (the wrapper plans cs with the same shared-memory sum). Returns 0,
// a cudaError_t (cudaErrorInvalidValue for a shape or cluster whose band does
// not fit), or kErrNoCluster when the card cannot hold one cluster of this
// size and shared memory.
int otgan_resident_sinkhorn(const float* cost, float* p, float* ent, int b, int n, int m,
                            int cs, float lam, int n_iters, void* stream_ptr) {
  if (b < 1 || b > 65535 || n < 1 || m < 1 || n_iters < 0 || cs < 1 || cs > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  const int band = (n + cs - 1) / cs;
  const size_t smem = smem_floats(band, m) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)resident_sinkhorn;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, b, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kErrNoCluster;
  err = cudaLaunchKernelEx(&cfg, resident_sinkhorn, cost, p, ent, n, m, band, cs, lam,
                           n_iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* otgan_resident_error_string(int err) {
  if (err == kErrNoCluster) return "no thread-block cluster of this size and shared memory fits";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
