// One local Sinkhorn step of the row-sharded matcher, for sm_90a: one
// cooperative launch per step.
//
// Replaces the two TPU kernels of otgan_tpu/ops/sinkhorn_pallas_step.py:
// _local_step_kernel (tier "fused", via fused_local_sinkhorn_step) and
// _streaming_step_kernel (tier "stream", via streaming_local_sinkhorn_step).
// Both compute, for a rank's row block x = -lam * C[rows, :] of shape
// (b, n, m) float32 and the replicated column potential v (b, m),
//
//     u_i  = -logsumexp_j(x_ij + v_j)
//     m_j  = max_i(x_ij + u_i),   s_j = sum_i exp(x_ij + u_i - m_j)
//
// the LOCAL column partials (m, s), shape (b, m) each, that the caller
// combines across ranks (all-reduce MAX of m, SUM of s * exp(m - m_glob)).
// The row potential u never leaves the kernel. The two TPU tiers are one
// function, so both tiers launch this kernel; ops/sinkhorn_step_cuda.py
// counts each tier's launches.
//
// The v mode replaces otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel (TPU
// kernel 1, via _col_potential) for matrices above what the grid kernel
// (sinkhorn_grid.cu) holds, e.g. batch 8000's 6 x 4000^2: on a whole matrix
// one local step is one Sinkhorn iteration, and the fold writes the new
// column potential v' = -(m + log s) in place of (m, s), in the same fixed
// order, so v is bitwise repeatable. otgan_col_potential runs the n_iters
// loop, one launch an iteration, from one C call a match
// (ops/sinkhorn_cuda.py counts it as kernel 1). Its bound at 6 x 4000^2 is
// the 2 expf a cell of each iteration (23 ms a match of 500 iterations at
// the MUFU rate); 384 MB do not stay in the 50 MB L2, so each iteration
// reads x once from device memory (0.115 ms): one pass of the TMA ring.
//
// What bounds it: one read of the block from device memory (96 MB at (6,
// 1000, 4000): 28.7 us at 3.35 TB/s; 18.8 MB at (6, 313, 2500): 5.6 us), and
// 2 expf per cell (11.5 us at (6, 1000, 4000) at the MUFU rate). The design
// reads each cell from device memory once and spends one expf on it in each
// step:
//
//   Plan (ops/sinkhorn_step_cuda.py::step_plan, from the SM count and the
//   shared memory a block may use): G blocks a matrix (about SMs / b: 22 at
//   b = 6 on 132 SMs), each owning a band of `band` consecutive rows, which
//   is one contiguous span of memory; `groups` matrices at once, the rest in
//   rounds.
//
//   Ring (the "ring" plan, while v, the accumulators and one stage of one
//   row fit: m up to 14,254 on an H100): thread 0 streams the band into
//   `stages` shared-memory stages of `rows` rows each with one 1D TMA bulk
//   copy a stage (cp.async.bulk, completion counted in bytes on an
//   mbarrier), and refills a stage as soon as it is consumed, so stages - 1
//   copies are in flight while one is computed; a band that fits one stage
//   is one copy. v is copied into shared memory once a launch.
//
//   Row step, from the stage: the rows of a stage go to groups of W warps
//   (W = 16 / rows, at least 1); each thread walks its float4s of the row
//   with an online (max, sum), rescaled once per 16 values (the 4-12 left
//   as one chunk), the warps' partials meet in shared memory: u for the
//   stage's rows.
//
//   Column step, on the same stage: a thread per 4 adjacent columns (float4
//   loads, 4 chains at once; chunks of 8 rows, the rows left as one chunk),
//   or per column where rows are not 16-byte aligned (chunks of 16, 8, 4,
//   2, 1), folds the stage's rows into the columns' running (max, sum): one
//   expf per cell, one rescale per chunk. On the ring with float4 rows and m
//   up to 4096 (KQ = 1 or 2 quads of columns a thread) the running pairs
//   stay in registers for the whole band; otherwise in shared memory.
//
//   Fold, in the same launch: each block writes its (max, sum) pair per
//   column to a (b, G, m) float2 scratch (st.global.cg), one grid barrier
//   (cg::this_grid().sync(): the launch is cooperative, every block is
//   resident), then each block folds its slice of ceil(m / G) columns over
//   the G partials in a fixed order (ld.global.cg; deterministic, no float
//   atomics). A ticket that makes the last-arriving block fold would put a
//   whole matrix's fold (4000 x 22 pairs) on the one block that finished
//   last; the barrier spreads it over all G.
//
//   Direct (the plan for rows too wide for a ring, e.g. (2, 8, 40000) or
//   the stream tier's 28,928 columns): the same loops read the band straight
//   from device memory in stages of `rows` rows (the column step's second
//   read of a stage hits L2), with v read from device memory and each
//   block's accumulators kept in its own slot of the scratch.
//
// Alignment: a bulk copy needs 16-byte aligned addresses and sizes, so a
// stage copies the aligned superset of its span (at most 12 bytes either
// side, inside the tensor's 512-byte allocation granule) and reads from an
// offset into it. The float4 row step runs where m % 4 == 0 and x and v are
// 16-byte aligned (vec_ok); otherwise the same loops take scalar loads.
//
// Numerics (csrc/sinkhorn_loops.cuh): expf/logf, never the fast-math
// intrinsics. A max starts at -inf with a sum of 0, and a -inf partial adds
// nothing. A block that owns no rows writes (-inf, 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sinkhorn_loops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStages = 8;
constexpr int kMaxStageRows = 32;
constexpr int kBarrierFloats = 2 * kMaxStages;  // kMaxStages mbarriers of 8 bytes
constexpr size_t kMaxSmem = 232448;             // 227 KB a block on sm_90
constexpr int kErrNotResident = 100002;         // the grid's blocks cannot all be resident
constexpr int kFoldRegs = 8;                    // partials a thread loads at once in the fold

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t k) {
  return (x + k - 1) / k * k;
}

// Floats of one ring stage: `rows` rows and the slack of the aligned
// superset, in whole 128-byte lines.
__host__ __device__ __forceinline__ size_t stage_floats(int rows, int m) {
  return round_up((size_t)rows * m + 8, 32);
}

// Shared memory of one block: the mbarriers, then (ring plan) the stages, v
// and the (max, sum) accumulators, then u, the row step's warp partials and
// the fold's (max, sum) per thread. ops/sinkhorn_step_cuda.py::smem_bytes
// plans with the same sum.
inline size_t smem_bytes(int m, int rows, int stages) {
  size_t f = kBarrierFloats;
  if (stages > 0) f += stages * stage_floats(rows, m) + round_up(m, 4) + 2 * (size_t)m;
  f += round_up(rows, 4) + 2 * (size_t)rows * kWarps + 2 * kThreads;
  return f * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Thread 0: copies `count` floats from src into ring stage `slot` (its
// aligned superset), counted on the stage's mbarrier.
__device__ __forceinline__ void issue_stage(float* stage, uint64_t* bar, const float* src,
                                            size_t count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const uint32_t bytes = (uint32_t)(((a + 4 * count + 15) & ~(uintptr_t)15) - lo);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(stage)),
      "l"(lo), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Q float4s x4[j + q T] + v4[j + q T], q < Q (kZero: v = 0, not read), as
// one chunk of the online (max, sum).
template <int Q, bool kZero>
__device__ __forceinline__ void row_quads(const float4* __restrict__ x4,
                                          const float4* __restrict__ v4, int j, int T,
                                          float& mx, float& s) {
  float y[4 * Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 a = x4[j + q * T];
    const float4 w = kZero ? make_float4(0.f, 0.f, 0.f, 0.f) : v4[j + q * T];
    y[4 * q] = a.x + w.x;
    y[4 * q + 1] = a.y + w.y;
    y[4 * q + 2] = a.z + w.z;
    y[4 * q + 3] = a.w + w.w;
  }
  online_chunk<4 * Q>(y, mx, s);
}

// One thread's share of row xr: its float4s (vec; chunks of 4 float4s, the
// 1-3 left as one chunk) or floats, strided by the T threads of its warp
// group, into the online (max, sum). kZero: the column potential is 0 (the
// first iteration of the v mode), vm is not read.
template <bool kVec, bool kZero>
__device__ __forceinline__ void row_share(const float* __restrict__ xr,
                                          const float* __restrict__ vm, int m, int t, int T,
                                          float& mx, float& s) {
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* v4 = reinterpret_cast<const float4*>(vm);
    const int m4 = m / 4;
    int j = t;
    for (; j + 3 * T < m4; j += 4 * T) row_quads<4, kZero>(x4, v4, j, T, mx, s);
    if (j + 2 * T < m4) {
      row_quads<3, kZero>(x4, v4, j, T, mx, s);
    } else if (j + T < m4) {
      row_quads<2, kZero>(x4, v4, j, T, mx, s);
    } else if (j < m4) {
      row_quads<1, kZero>(x4, v4, j, T, mx, s);
    }
  } else {
    int j = t;
    for (; j + 15 * T < m; j += 16 * T) {
      float y[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) y[q] = xr[j + q * T] + (kZero ? 0.f : vm[j + q * T]);
      online_chunk<16>(y, mx, s);
    }
    for (; j < m; j += T) {
      const float y = xr[j] + (kZero ? 0.f : vm[j]);
      online_chunk<1>(&y, mx, s);
    }
  }
}

// Row step of one stage of rk rows (row stride m) starting at xs: u[r] for
// r < rk; vm nullptr: v = 0. Each row goes to W = kWarps / rows warps (at
// least 1); red_m and red_s hold rows x W warp partials, which a warp per
// row combines.
__device__ __forceinline__ void row_step(const float* __restrict__ xs,
                                         const float* __restrict__ vm, float* u, float* red_m,
                                         float* red_s, int rk, int m, int rows, int vec_ok) {
  const int W = max(1, kWarps / rows);
  const int rgroups = kWarps / W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / W, wi = warp % W;
  for (int r = rg; r < rk && rg < rgroups; r += rgroups) {
    const float* xr = xs + (size_t)r * m;
    float mx = -INFINITY, s = 0.f;
    const int t = wi * 32 + lane;
    if (vm == nullptr) {
      if (vec_ok) {
        row_share<true, true>(xr, vm, m, t, W * 32, mx, s);
      } else {
        row_share<false, true>(xr, vm, m, t, W * 32, mx, s);
      }
    } else if (vec_ok) {
      row_share<true, false>(xr, vm, m, t, W * 32, mx, s);
    } else {
      row_share<false, false>(xr, vm, m, t, W * 32, mx, s);
    }
    const float mw = warp_max(mx);
    s = (mx == -INFINITY) ? 0.f : s * expf(mx - mw);
    s = warp_sum(s);
    if (lane == 0) {
      red_m[r * W + wi] = mw;
      red_s[r * W + wi] = s;
    }
  }
  __syncthreads();
  for (int r = warp; r < rk; r += kWarps) {
    const float mx = lane < W ? red_m[r * W + lane] : -INFINITY;
    const float mw = warp_max(mx);
    float s = (mx == -INFINITY) ? 0.f : red_s[r * W + lane] * expf(mx - mw);
    s = warp_sum(s);
    if (lane == 0) u[r] = -(mw + logf(s));
  }
  __syncthreads();
}

// Column step over rows [r0, r0 + R) for the 4 columns of the float4 x4[0]
// (row stride m4 float4s): 4 independent running (max, sum).
template <int R>
__device__ __forceinline__ void quad_chunk(const float4* __restrict__ x4,
                                           const float* __restrict__ u, int m4, int r0,
                                           float* mx, float* s) {
  float z[4][R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float4 t = x4[(size_t)(r0 + q) * m4];
    const float uq = u[r0 + q];
    z[0][q] = t.x + uq;
    z[1][q] = t.y + uq;
    z[2][q] = t.z + uq;
    z[3][q] = t.w + uq;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) online_chunk<R>(z[k], mx[k], s[k]);
}

// The rk rows of the 4 columns of x4[0] (row stride m4 float4s) in chunks of
// 8 rows, the rows left as one chunk: one rescale each.
__device__ __forceinline__ void quad_rows(const float4* __restrict__ x4,
                                          const float* __restrict__ u, int m4, int rk, float* mx,
                                          float* s) {
  int r0 = 0;
  for (; r0 + 8 <= rk; r0 += 8) quad_chunk<8>(x4, u, m4, r0, mx, s);
  switch (rk - r0) {
    case 7: quad_chunk<7>(x4, u, m4, r0, mx, s); break;
    case 6: quad_chunk<6>(x4, u, m4, r0, mx, s); break;
    case 5: quad_chunk<5>(x4, u, m4, r0, mx, s); break;
    case 4: quad_chunk<4>(x4, u, m4, r0, mx, s); break;
    case 3: quad_chunk<3>(x4, u, m4, r0, mx, s); break;
    case 2: quad_chunk<2>(x4, u, m4, r0, mx, s); break;
    case 1: quad_chunk<1>(x4, u, m4, r0, mx, s); break;
    default: break;
  }
}

// Column step of one stage of rk rows: a thread per column (scalar), or per
// 4 adjacent columns (vec_ok: float4 loads, 4 chains at once), folding the
// rows into the running (max, sum) pairs acc (shared memory on the ring
// plan, the block's scratch slot otherwise) in chunks of rows.
template <bool kRing>
__device__ __forceinline__ void column_step(const float* __restrict__ xs,
                                            const float* __restrict__ u, float2* acc, int rk,
                                            int m, int vec_ok) {
  if (vec_ok) {
    const int m4 = m / 4;
    for (int c = threadIdx.x; c < m4; c += kThreads) {
      float4* a4 = reinterpret_cast<float4*>(acc + 4 * c);
      const float4 a01 = kRing ? a4[0] : __ldcg(a4);
      const float4 a23 = kRing ? a4[1] : __ldcg(a4 + 1);
      float mx[4] = {a01.x, a01.z, a23.x, a23.z};
      float s[4] = {a01.y, a01.w, a23.y, a23.w};
      quad_rows(reinterpret_cast<const float4*>(xs) + c, u, m4, rk, mx, s);
      const float4 b01 = make_float4(mx[0], s[0], mx[1], s[1]);
      const float4 b23 = make_float4(mx[2], s[2], mx[3], s[3]);
      if (kRing) {
        a4[0] = b01;
        a4[1] = b23;
      } else {
        __stcg(a4, b01);
        __stcg(a4 + 1, b23);
      }
    }
    return;
  }
  for (int j = threadIdx.x; j < m; j += kThreads) {
    float2 a = kRing ? acc[j] : __ldcg(acc + j);
    walk_column(xs, u, m, j, rk, a.x, a.y);
    if (kRing) {
      acc[j] = a;
    } else {
      __stcg(acc + j, a);
    }
  }
}

// Column step of one ring stage with float4 rows (KQ > 0): thread t keeps
// the running (max, sum) of the quads t, t + kThreads, ... (KQ of them, 4
// columns each) in registers for the whole band.
template <int KQ>
__device__ __forceinline__ void column_step_regs(const float* __restrict__ xs,
                                                 const float* __restrict__ u, int rk, int m4,
                                                 float (&mx)[KQ][4], float (&s)[KQ][4]) {
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < m4) quad_rows(reinterpret_cast<const float4*>(xs) + c, u, m4, rk, mx[k], s[k]);
  }
}

// Grid (G, groups), kThreads threads, cooperative: block (blockIdx.x,
// blockIdx.y) owns rows [blockIdx.x * band, + band) of matrices blockIdx.y,
// blockIdx.y + groups, ... Scratch: part (b, G, m) of (max, sum) pairs.
// v nullptr: the column potential is 0. v_out nullptr: the (m, s) mode,
// the fold writes m_out and s_out; otherwise the v mode, it writes the new
// column potential v_out = -(m + log s) (the caller ping-pongs v and v_out).
// kRing: the band streams through `stages` shared-memory stages of `rows`
// rows (TMA); otherwise it is read in place, stages of `rows` rows. KQ > 0
// (ring, float4 rows, m / 4 <= KQ * kThreads): the column accumulators live
// in registers, KQ quads of columns a thread.
template <bool kRing, int KQ>
__global__ void __launch_bounds__(kThreads, 1)
local_step(const float* __restrict__ x, const float* __restrict__ v, float* __restrict__ m_out,
           float* __restrict__ s_out, float* __restrict__ v_out, float2* __restrict__ part,
           int b, int n, int m, int band, int rows, int stages, int vec_ok) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const size_t sf = stage_floats(rows, m);
  float* ring = smem + kBarrierFloats;
  float* vs = ring + (kRing ? stages * sf : 0);
  float2* acc_s = reinterpret_cast<float2*>(vs + (kRing ? round_up(m, 4) : 0));
  float* u = reinterpret_cast<float*>(acc_s + (kRing ? m : 0));
  float* red_m = u + round_up(rows, 4);
  float* red_s = red_m + rows * kWarps;
  float* fold_m = red_s + rows * kWarps;
  float* fold_s = fold_m + kThreads;

  const int tid = threadIdx.x;
  const int n_blocks = gridDim.x, blk = blockIdx.x;
  const int groups = gridDim.y, grp = blockIdx.y;
  const int row0 = blk * band;
  const int own = max(0, min(band, n - row0));  // rows this block owns
  const int n_stages = (own + rows - 1) / rows;
  const int slice = (m + n_blocks - 1) / n_blocks;  // this block's columns in the fold
  const int c0 = blk * slice;
  const int c1 = min(m, c0 + slice);

  if (kRing) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  constexpr int kq = KQ > 0 ? KQ : 1;
  float cm[kq][4], cs[kq][4];
  uint32_t q = 0;  // stages consumed so far: stage q sits in slot q % stages, parity (q / stages) & 1

  for (int mat0 = 0; mat0 < b; mat0 += groups) {
    const int mat = mat0 + grp;
    if (mat < b) {
      const float* xb = x + ((size_t)mat * n + (size_t)min(row0, n)) * m;
      float2* pb = part + ((size_t)mat * n_blocks + blk) * m;
      const float* vm = v ? v + (size_t)mat * m : nullptr;
      float2* acc = pb;
      if (kRing) {
        if (tid == 0) {
          for (int k = 0; k < min(stages, n_stages); ++k) {
            const uint32_t slot = (q + k) % stages;
            issue_stage(ring + slot * sf, &bars[slot], xb + (size_t)k * rows * m,
                        (size_t)min(rows, own - k * rows) * m);
          }
        }
        if (KQ > 0) {
#pragma unroll
          for (int k = 0; k < kq; ++k) {
#pragma unroll
            for (int c = 0; c < 4; ++c) cm[k][c] = -INFINITY, cs[k][c] = 0.f;
          }
        }
        for (int j = tid; j < m; j += kThreads) {
          vs[j] = vm ? vm[j] : 0.f;
          if (KQ == 0) acc_s[j] = make_float2(-INFINITY, 0.f);
        }
        vm = vs;
        acc = acc_s;
        __syncthreads();
      } else {
        for (int j = tid; j < m; j += kThreads) __stcg(acc + j, make_float2(-INFINITY, 0.f));
      }

      for (int k = 0; k < n_stages; ++k, ++q) {
        const int rk = min(rows, own - k * rows);
        const float* src = xb + (size_t)k * rows * m;
        const float* xs = src;
        if (kRing) {
          const uint32_t slot = q % stages;
          mbar_wait(&bars[slot], (q / stages) & 1);
          xs = ring + slot * sf + (reinterpret_cast<uintptr_t>(src) & 15) / 4;
        }
        row_step(xs, vm, u, red_m, red_s, rk, m, rows, vec_ok);
        if constexpr (KQ > 0) {
          column_step_regs<KQ>(xs, u, rk, m / 4, cm, cs);
        } else {
          column_step<kRing>(xs, u, acc, rk, m, vec_ok);
        }
        __syncthreads();  // the stage and u are free
        if (kRing && tid == 0 && k + stages < n_stages) {
          const uint32_t slot = q % stages;
          issue_stage(ring + slot * sf, &bars[slot], xb + (size_t)(k + stages) * rows * m,
                      (size_t)min(rows, own - (k + stages) * rows) * m);
        }
      }
      if (KQ > 0) {
#pragma unroll
        for (int k = 0; k < kq; ++k) {
          const int c = tid + k * kThreads;
          if (c < m / 4) {
            float4* p4 = reinterpret_cast<float4*>(pb + 4 * c);
            __stcg(p4, make_float4(cm[k][0], cs[k][0], cm[k][1], cs[k][1]));
            __stcg(p4 + 1, make_float4(cm[k][2], cs[k][2], cm[k][3], cs[k][3]));
          }
        }
      } else if (kRing) {
        for (int j = tid; j < m; j += kThreads) __stcg(pb + j, acc_s[j]);
      }
    }
    grid.sync();  // every block's partials of this round are in L2

    // fold: this block's slice of columns over the G partials, in a fixed
    // order: Q = kThreads / cc threads a column, thread q folding partials
    // q, q + Q, ... (kFoldRegs loads in flight), then a thread per column
    // folding the Q pairs
    if (mat < b) {
      const float2* pm = part + (size_t)mat * n_blocks * m;
      for (int jc = c0; jc < c1; jc += kThreads) {
        const int cc = min(c1 - jc, kThreads);
        const int Q = kThreads / cc;
        const int qq = tid / cc;
        if (qq < Q) {
          const float2* pc = pm + jc + tid % cc;
          float mx = -INFINITY, s = 0.f;
          for (int p0 = qq; p0 < n_blocks; p0 += Q * kFoldRegs) {
            float2 t[kFoldRegs];
            float cmx = -INFINITY;
#pragma unroll
            for (int k = 0; k < kFoldRegs; ++k) {
              const int p = p0 + k * Q;
              t[k] = p < n_blocks ? __ldcg(pc + (size_t)p * m) : make_float2(-INFINITY, 0.f);
              cmx = fmaxf(cmx, t[k].x);
            }
            online_rescale(cmx, mx, s);
#pragma unroll
            for (int k = 0; k < kFoldRegs; ++k) {
              if (t[k].x != -INFINITY) s += t[k].y * expf(t[k].x - mx);
            }
          }
          fold_m[tid] = mx;  // tid == qq * cc + column
          fold_s[tid] = s;
        }
        __syncthreads();
        if (tid < cc) {
          float mx = fold_m[tid], s = fold_s[tid];
          for (int g = 1; g < Q; ++g) combine(fold_m[g * cc + tid], fold_s[g * cc + tid], mx, s);
          const size_t o = (size_t)mat * m + jc + tid;
          if (v_out) {
            v_out[o] = -(mx + logf(s));
          } else {
            m_out[o] = mx;
            s_out[o] = s;
          }
        }
        __syncthreads();
      }
    }
  }
}

constexpr int kMaxKQ = 2;  // register accumulators up to 2 * 4 * kThreads columns

// The kernel of a plan: in place (stages 0), or the ring with kq quads of
// register accumulators a thread (0: in shared memory).
const void* kernel_for(int stages, int kq) {
  if (stages == 0) return (const void*)local_step<false, 0>;
  if (kq == 1) return (const void*)local_step<true, 1>;
  if (kq == 2) return (const void*)local_step<true, 2>;
  return (const void*)local_step<true, 0>;
}

int check_plan(int b, int n, int m, int blocks, int groups, int band, int rows, int stages) {
  if (b < 1 || n < 1 || m < 1 || blocks < 1 || blocks > 65535 || groups < 1 || groups > b ||
      groups > 65535 || band < 1 || (long long)band * blocks < n || rows < 1 ||
      rows > kMaxStageRows || stages < 0 || stages > kMaxStages ||
      smem_bytes(m, rows, stages) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One cooperative launch of the kernel of a checked plan; vec_ok is the
// caller's (float4 rows: m % 4 == 0 and every row pointer 16-byte aligned).
int launch_step(const float* x, const float* v, float* m_out, float* s_out, float* v_out,
                float* part, int b, int n, int m, int blocks, int groups, int band, int rows,
                int stages, int vec_ok, cudaStream_t stream) {
  const int quads = (m / 4 + kThreads - 1) / kThreads;
  const int kq = (stages > 0 && vec_ok && quads <= kMaxKQ) ? quads : 0;
  float2* part2 = reinterpret_cast<float2*>(part);
  void* args[] = {&x,  &v, &m_out, &s_out, &v_out, &part2,  &b,
                  &n,  &m, &band,  &rows,  &stages, &vec_ok};
  cudaError_t e = cudaLaunchCooperativeKernel(kernel_for(stages, kq), dim3(blocks, groups, 1),
                                              dim3(kThreads, 1, 1), args,
                                              smem_bytes(m, rows, stages), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Checks a plan on the current device once, before its launches: the shape
// and plan are valid, the kernel may use the card's shared memory, and the
// blocks x groups blocks are resident at once (a cooperative launch needs
// them all). Returns 0, a cudaError_t, or kErrNotResident.
int otgan_local_step_prepare(int b, int n, int m, int blocks, int groups, int band, int rows,
                             int stages) {
  int err = check_plan(b, n, m, blocks, groups, band, rows, stages);
  if (err != 0) return err;
  int device = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t smem = smem_bytes(m, rows, stages);
  if (e == cudaSuccess && smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // every kernel the plan may launch (its kq depends on the pointers); the
  // largest a block may ask for, so that no plan's prepare lowers another's
  for (int kq = 0; kq <= (stages > 0 ? kMaxKQ : 0); ++kq) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel_for(stages, kq),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(stages, kq),
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)per_sm * sms < (long long)blocks * groups) return kErrNotResident;
  }
  return (int)e;
}

// One step on `stream`, one cooperative launch: x (b, n, m), v (b, m) ->
// m_out, s_out (b, m); part (b, blocks, m, 2) is scratch; all float32,
// allocated by the caller. The plan is ops/sinkhorn_step_cuda.py's
// step_plan, checked by otgan_local_step_prepare. Returns the cudaError_t of
// the launch (0 on success).
int otgan_local_step(const float* x, const float* v, float* m_out, float* s_out, float* part,
                     int b, int n, int m, int blocks, int groups, int band, int rows, int stages,
                     void* stream_ptr) {
  int err = check_plan(b, n, m, blocks, groups, band, rows, stages);
  if (err != 0) return err;
  const int vec_ok = (m % 4 == 0 && aligned16(x) && aligned16(v)) ? 1 : 0;
  return launch_step(x, v, m_out, s_out, nullptr, part, b, n, m, blocks, groups, band, rows,
                     stages, vec_ok, static_cast<cudaStream_t>(stream_ptr));
}

// The whole column-potential loop on `stream` (TPU kernel 1 above the grid
// kernel's ceiling): n_iters Sinkhorn iterations on x (b, n, m) from v = 0,
// one cooperative launch of the kernel's v mode an iteration, the column
// potential ping-ponging between v and v_next (b, m) so that the last
// iteration writes v; part (b, blocks, m, 2) is scratch; all float32,
// allocated by the caller. The plan is step_plan's on the whole (b, n, m),
// checked here once before the first launch. Returns 0, a cudaError_t or
// kErrNotResident.
int otgan_col_potential(const float* x, float* v, float* v_next, float* part, int b, int n,
                        int m, int blocks, int groups, int band, int rows, int stages,
                        int n_iters, void* stream_ptr) {
  if (n_iters < 0) return (int)cudaErrorInvalidValue;
  int err = otgan_local_step_prepare(b, n, m, blocks, groups, band, rows, stages);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_iters == 0) return (int)cudaMemsetAsync(v, 0, sizeof(float) * (size_t)b * m, stream);
  const int vec_ok =
      (m % 4 == 0 && aligned16(x) && aligned16(v) && aligned16(v_next)) ? 1 : 0;
  const float* v_in = nullptr;  // the first iteration reads v = 0
  for (int it = 0; it < n_iters; ++it) {
    float* v_out = (n_iters - 1 - it) % 2 == 0 ? v : v_next;
    err = launch_step(x, v_in, nullptr, nullptr, v_out, part, b, n, m, blocks, groups, band,
                      rows, stages, vec_ok, stream);
    if (err != 0) return err;
    v_in = v_out;
  }
  return 0;
}

const char* otgan_step_error_string(int err) {
  if (err == kErrNotResident) {
    return "the card cannot hold every block of this plan at once (cooperative launch)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
