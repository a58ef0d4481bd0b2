// Whole-loop Sinkhorn on matrices held in the shared memory of the whole
// card, for sm_90a: one cooperative launch per match.
//
// Replaces otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel (through
// _col_potential) for every matrix the card's shared memory holds: on an
// H100 (132 SMs, 232,448 B a block) every square up to 2640^2, the
// reference batch 5000's 6 x 2500^2 included. Given costs C, shape
// (b, n, m) float32 row-major, one launch
//
//   1. reads C once and forms x = -lam * C in shared memory, each row shifted
//      by its max, in kernel 1's float32 order (csrc/sinkhorn_resident.cu);
//   2. runs n_iters iterations of
//          u_i = -logsumexp_j(x_ij + v_j)          (row step)
//          v_j = -logsumexp_i(x_ij + u_i)          (column step; REPLACES v)
//      from v = 0;
//   3. writes P = softmax_rows(x + v) once and ent[b] = mean_i(-sum_j P_ij
//      logP_ij), with logP = (y - rowmax) - log(rowsum), never log(P).
//
// Design. A matrix is owned by G blocks (normally one per SM), each holding
// a band of ceil(n / G) whole rows of x, with v and u, in dynamic shared
// memory for the whole loop: 19 rows of 2500 columns is 190,000 B. The row
// step is local to a block. For the column step each block writes its
// band's per-column (max, rescaled sum) pairs to a (G, m) scratch in L2
// (2.6 MB at G = 132, m = 2500); after a grid barrier each block folds the G
// pairs of its own slice of ceil(m / G) columns into v and writes that
// slice; after a second barrier every block reads the whole v (10 KB). Two
// barriers per iteration, the grid's own (cg::this_grid().sync() under a
// cooperative launch; no -rdc needed). Where G blocks per matrix leave SMs
// free, `groups` matrices run at once, one per row of the grid
// (blockIdx.y), and the b matrices are walked in rounds of `groups`.
//
// What bounds it on an H100: nothing leaves the SMs inside the loop but the
// partials and v, so the work is 2 expf per cell per iteration, each one
// MUFU.EX2 (16 a clock per SM) among ~10 FP32/INT instructions. At 6 x
// 2500^2 x 500 the 3.75e10 expf take 8.97 ms at the MUFU rate (1.98 GHz);
// the bytes (C once, P once) 0.09 ms. The design spends one expf per element
// and step and nothing else of note: the row step gives each warp a whole
// row, read once as float4, with an online (max, sum) rescaled once per 16
// values of a lane and summed as a tree; the column step gives each thread a
// column, walked once in chunks of 16, 8, 4, 2 and 1 rows (no masked slots).
// The fold loads each thread's share of the (max, sum) pairs at once (8 bytes
// each), then a warp per column reduces the threads' pairs by shuffles. 1024
// threads a block (64 registers a thread). On an H100 at 700 W an iteration
// at 6 x 2500^2 takes 13.8 us and a match 41 ms (kernel 1's path: 114 ms);
// the row and column steps take about two thirds of an iteration, the fold
// and the two barriers the rest (a barrier alone is 1.14 us,
// otgan_grid_barrier_loop; PERF.md has the breakdown). Splitting rows or
// columns over more warps and threads, 16 or 24 warps a block, 16-byte loads
// of u, and v passed in words tagged with their iteration instead of the
// second barrier were each slower or no faster.
//
// Numerics: expf/logf, never the fast-math intrinsics. A max starts at -inf
// with a sum of 0, and a -inf partial contributes nothing. Ragged n and m are
// bounds-masked: rows of shared memory are padded to a multiple of 4 floats
// with -inf (so the float4 row step needs no tail), and a block whose band
// starts past n holds no rows and writes (-inf, 0) partials. Data written by
// other blocks (partials, v, band entropies) is read with ld.global.cg, past
// the SM's incoherent L1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sinkhorn_loops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;       // 227 KB a block on sm_90
constexpr int kErrNotResident = 100002;   // the grid's blocks cannot all be resident
constexpr int kRowChunk = 4;              // float4 a lane per online step of the row step
constexpr int kFoldRegs = 8;              // partials a thread loads at once in the fold

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared memory of one block, in floats: the band of x (rows padded to a
// multiple of 4), v, u, the fold's (max, sum) per thread, and kWarps + 4
// slots for the entropy sums. ops/sinkhorn_grid_cuda.py plans with the same
// sum.
inline size_t smem_floats(int band, int m) {
  const size_t ldm = round4(m);
  return band * ldm + ldm + round4(band) + 2 * kThreads + kWarps + 4;
}

// Grid (G, groups), kThreads threads: block (blockIdx.x, blockIdx.y) owns rows
// [blockIdx.x * band, + band) of matrices blockIdx.y, blockIdx.y + groups, ...
// Scratch: part (groups, G, m) of (max, sum) pairs, 8-byte aligned; v_glob
// (groups, round4(m)), 16-byte aligned; ent_part (b, G).
__global__ void __launch_bounds__(kThreads, 1)
grid_sinkhorn(const float* __restrict__ cost, float* __restrict__ p_out,
              float* __restrict__ ent_out, float2* __restrict__ part,
              float* __restrict__ v_glob, float* __restrict__ ent_part, int b, int n, int m,
              int band, float lam, int n_iters, int vec_ok) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int ldm = round4(m);
  constexpr int threads = kThreads;
  constexpr int n_warps = kWarps;
  float* xs = smem;                          // band * ldm
  float* v = xs + (size_t)band * ldm;        // ldm
  float* u = v + ldm;                        // round4(band)
  float* fold_m = u + round4(band);          // threads
  float* fold_s = fold_m + threads;          // threads
  float* red = fold_s + threads;             // kWarps + 4

  const int n_blocks = gridDim.x;
  const int blk = blockIdx.x;
  const int groups = gridDim.y;
  const int grp = blockIdx.y;
  const int row0 = blk * band;
  const int rows = max(0, min(band, n - row0));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // this block's slice of columns in the fold
  const int slice = (m + n_blocks - 1) / n_blocks;
  const int c0 = blk * slice;
  const int cn = max(0, min(slice, m - c0));
  float2* part_g = part + (size_t)grp * n_blocks * m;
  float* vg = v_glob + (size_t)grp * ldm;

  for (int mat0 = 0; mat0 < b; mat0 += groups) {
    const int mat = mat0 + grp;
    if (mat >= b) {  // a group with no matrix this round keeps the barrier count
      for (int it = 0; it < n_iters; ++it) {
        grid.sync();
        grid.sync();
      }
      grid.sync();
      continue;
    }

    // 1. x = -lam * C, each row shifted by its max; pad columns -inf
    const float* cm = cost + ((size_t)mat * n + row0) * m;
    for (int r = warp; r < rows; r += n_warps) {
      float* xr = xs + (size_t)r * ldm;
      const float* cr = cm + (size_t)r * m;
      float mx = -INFINITY;
      if (vec_ok) {
        const float4* c4 = reinterpret_cast<const float4*>(cr);
        float4* x4 = reinterpret_cast<float4*>(xr);
        for (int j = lane; j < m / 4; j += 32) {
          const float4 c = c4[j];
          const float4 t = make_float4(-lam * c.x, -lam * c.y, -lam * c.z, -lam * c.w);
          x4[j] = t;
          mx = fmaxf(mx, fmaxf(fmaxf(t.x, t.y), fmaxf(t.z, t.w)));
        }
      } else {
        for (int j = lane; j < m; j += 32) {
          const float t = -lam * cr[j];
          xr[j] = t;
          mx = fmaxf(mx, t);
        }
      }
      mx = warp_max(mx);
      for (int j = lane; j < m; j += 32) xr[j] -= mx;
      for (int j = m + lane; j < ldm; j += 32) xr[j] = -INFINITY;
    }
    for (int j = tid; j < ldm; j += threads) v[j] = 0.f;
    __syncthreads();

    // 2. the loop
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const int m4 = ldm / 4;
    for (int it = 0; it < n_iters; ++it) {
      // row step: a warp per row, one pass, one expf per element
      for (int r = warp; r < rows; r += n_warps) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + (size_t)r * ldm);
        float mx = -INFINITY, s = 0.f;
        for (int j0 = lane; j0 < m4; j0 += 32 * kRowChunk) {
          float y[4 * kRowChunk];
#pragma unroll
          for (int q = 0; q < kRowChunk; ++q) {
            const int j = j0 + 32 * q;
            float4 a = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
            float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j < m4) {
              a = x4[j];
              w = v4[j];
            }
            y[4 * q] = a.x + w.x;
            y[4 * q + 1] = a.y + w.y;
            y[4 * q + 2] = a.z + w.z;
            y[4 * q + 3] = a.w + w.w;
          }
          online_rescale(tree_max<4 * kRowChunk>(y), mx, s);
          if (mx != -INFINITY) s += tree_exp_sum<4 * kRowChunk>(y, mx);
        }
        const float mw = warp_max(mx);
        s = (mx == -INFINITY) ? 0.f : s * expf(mx - mw);
        s = warp_sum(s);
        if (lane == 0) u[r] = -(mw + logf(s));
      }
      __syncthreads();

      // column step: a thread per column walks the band's rows once
      float2* po = part_g + (size_t)blk * m;
      for (int j = tid; j < m; j += threads) {
        float mx = -INFINITY, s = 0.f;
        walk_column(xs, u, ldm, j, rows, mx, s);
        __stcg(po + j, make_float2(mx, s));
      }
      grid.sync();  // every block's partials are in L2

      // fold: this block's slice of columns over the G partials
      for (int jc = 0; jc < cn; jc += threads) {
        const int cc = min(cn - jc, threads);
        const int groups_q = threads / cc;
        const int jj = tid % cc;
        const int q = tid / cc;
        if (q < groups_q) {
          const int j = c0 + jc + jj;
          float mx = -INFINITY, s = 0.f;
          for (int p0 = q; p0 < n_blocks; p0 += groups_q * kFoldRegs) {
            float pm[kFoldRegs], ps[kFoldRegs];
            float cmx = -INFINITY;
#pragma unroll
            for (int k = 0; k < kFoldRegs; ++k) {
              const int p = p0 + k * groups_q;
              pm[k] = -INFINITY;
              ps[k] = 0.f;
              if (p < n_blocks) {
                const float2 t = __ldcg(part_g + (size_t)p * m + j);
                pm[k] = t.x;
                ps[k] = t.y;
              }
              cmx = fmaxf(cmx, pm[k]);
            }
            online_rescale(cmx, mx, s);
#pragma unroll
            for (int k = 0; k < kFoldRegs; ++k) {
              if (pm[k] != -INFINITY) s += ps[k] * expf(pm[k] - mx);
            }
          }
          fold_m[tid] = mx;
          fold_s[tid] = s;
        }
        __syncthreads();
        for (int c = warp; c < cc; c += n_warps) {  // a warp per column
          float mx = -INFINITY, s = 0.f;
          for (int g = lane; g < groups_q; g += 32) combine(fold_m[g * cc + c], fold_s[g * cc + c], mx, s);
          const float mw = warp_max(mx);
          s = (mx == -INFINITY) ? 0.f : s * expf(mx - mw);
          s = warp_sum(s);
          if (lane == 0) __stcg(vg + c0 + jc + c, -(mw + logf(s)));
        }
        __syncthreads();
      }
      grid.sync();  // the whole v is in L2
      for (int j = tid; j < m4; j += threads) {
        float4 t = __ldcg(reinterpret_cast<const float4*>(vg) + j);
        if (4 * j + 1 >= m) t.y = 0.f;  // pad columns of v stay 0
        if (4 * j + 2 >= m) t.z = 0.f;
        if (4 * j + 3 >= m) t.w = 0.f;
        reinterpret_cast<float4*>(v)[j] = t;
      }
      __syncthreads();
    }

    // 3. P = softmax_rows(x + v) and the band's sum of row entropies
    float ent = 0.f;  // lane 0's running sum over this warp's rows
    float* pb = p_out + ((size_t)mat * n + row0) * m;
    for (int r = warp; r < rows; r += n_warps) {
      const float* xr = xs + (size_t)r * ldm;
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
      for (int w = 0; w < n_warps; ++w) t += red[w];
      __stcg(ent_part + (size_t)mat * n_blocks + blk, t);
    }
    grid.sync();  // every band's entropy sum is in L2
    if (blk == 0 && tid == 0) {
      float t = 0.f;
      for (int q = 0; q < n_blocks; ++q) t += __ldcg(ent_part + (size_t)mat * n_blocks + q);
      ent_out[mat] = t / (float)n;
    }
  }
}

// n grid barriers and nothing else: the barrier's cost, measured alone.
__global__ void grid_barrier_loop(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

int launch_cooperative(const void* fn, dim3 grid, int threads, size_t smem, void** args,
                       void* stream_ptr) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < (long long)grid.x * grid.y) return kErrNotResident;
  err = cudaLaunchCooperativeKernel(fn, grid, dim3(threads, 1, 1), args, smem,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The card's numbers the plan needs, for the current device: SM count and
// the shared memory a block may opt into. Whether the planned blocks are
// co-resident is asked again at each launch (launch_cooperative).
int otgan_grid_device_limits(int* sm_count, int* smem_per_block) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// One cooperative launch on `stream`: cost (b, n, m) -> p (b, n, m), ent (b),
// all float32, allocated by the caller with the scratch part (groups, blocks,
// m, 2), v_glob (groups, m rounded up to a multiple of 4, 16-byte aligned),
// ent_part (b, blocks). `blocks`
// blocks a matrix, `groups` matrices at once. Returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape or plan whose band does not fit), or
// kErrNotResident when the card cannot hold blocks x groups blocks at once.
int otgan_grid_sinkhorn(const float* cost, float* p, float* ent, float* part, float* v_glob,
                        float* ent_part, int b, int n, int m, int blocks, int groups, float lam,
                        int n_iters, void* stream_ptr) {
  if (b < 1 || n < 1 || m < 1 || n_iters < 0 || blocks < 1 || groups < 1 || groups > b ||
      blocks > 65535 || groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int band = (n + blocks - 1) / blocks;
  const size_t smem = smem_floats(band, m) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int vec_ok = (m % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0) ? 1 : 0;
  void* args[] = {&cost, &p, &ent, &part, &v_glob, &ent_part, &b, &n, &m,
                  &band, &lam, &n_iters, &vec_ok};
  return launch_cooperative((const void*)grid_sinkhorn, dim3(blocks, groups, 1), kThreads, smem,
                            args, stream_ptr);
}

// `n` grid barriers on `blocks` blocks of `threads` threads, cooperative.
int otgan_grid_barrier_loop(int blocks, int threads, int n, void* stream_ptr) {
  if (blocks < 1 || threads < 32 || threads > kThreads || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&n};
  return launch_cooperative((const void*)grid_barrier_loop, dim3(blocks, 1, 1), threads, 0, args,
                            stream_ptr);
}

const char* otgan_grid_error_string(int err) {
  if (err == kErrNotResident) {
    return "the card cannot hold every block of this grid at once (cooperative launch)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
