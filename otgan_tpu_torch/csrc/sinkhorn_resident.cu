// Whole-loop Sinkhorn on matrices held by one thread-block cluster, for
// sm_90a.
//
// Replaces otgan_tpu/ops/sinkhorn_pallas.py::_sinkhorn_kernel (launched by
// _sinkhorn_pallas_batched). Given costs C, shape (b, n, m) float32
// row-major, one launch per match
//
//   1. reads C once and forms x = -lam * C, each row shifted by its max
//      (absorbed by the row potential; keeps lam = 500 near 0, where float32
//      spacing is fine);
//   2. runs n_iters iterations of
//          u_i = -logsumexp_j(x_ij + v_j)          (row step)
//          v_j = -logsumexp_i(x_ij + u_i)          (column step; REPLACES v)
//      from v = 0;
//   3. writes P = softmax_rows(x + v) once (the row potential drops out of a
//      row softmax) and ent[b] = mean_i(-sum_j P_ij logP_ij), with
//      logP = (y - rowmax) - log(rowsum), never log(P).
//
// What bounds it on an H100: C is read once and P written once (2 x 1.57 MB
// at 6 x 256^2), so the bound is the 2 expf a cell and iteration at the MUFU
// rate (0.094 ms a match at 6 x 256^2, 0.024 at 6 x 128^2). What a small
// matrix really pays per iteration is latency: the row and column
// reductions, and making each block's column values visible to the other
// blocks of its cluster. The design keeps both short:
//
//   One cluster of cs blocks (ops/sinkhorn_resident_cuda.py::resident_plan)
//   owns a matrix; block q a band of whole rows. Warp w of a block owns the
//   band's rows w, w + 16, ..., and lane l of the warp the columns
//   4 (l + 32 k) + e (k < Q quads, e < 4) of each of them, so a row lies in
//   one warp: the row step is a warp's shuffles (the max one redux.sync),
//   u never leaves registers.
//
//   x in registers: where a warp's rows hold at most 16 cells a thread (Q
//   and RR rows a warp fixed at compile time: 6 x 128^2 on 8 blocks, 6 x
//   256^2 on 16), x and the thread's v live in registers for the whole loop
//   and shared memory holds only column values. Elsewhere (forced small
//   clusters, up to 768^2 cells) x sits in shared memory and each row is
//   read from it once an iteration, with float4 loads.
//
//   One pass per step: the row's cells in registers give u_r (one expf a
//   cell), then z = x + u_r folds into the lane's column (max, sum): with x
//   in registers over the warp's RR rows at once (the max first, so no
//   rescale; one row needs no expf), from shared memory one row at a time
//   (one expf a cell, the larger of the old max and z rescaling the other).
//
//   Column step across warps and blocks, all without branches so the expf
//   overlap: each warp writes its columns' values, one barrier of the
//   block, then a thread a column folds the 16 warps' values into the
//   block's value. One barrier more, and thread 0 copies the block's values
//   whole into the receive buffer of every block of the cluster: one TMA
//   bulk copy (cp.async.bulk shared::cta to shared::cluster) a peer,
//   counted in bytes on that block's mbarrier (no remote load, no cluster
//   barrier in the loop). Each block waits on its own mbarrier (acquire,
//   cluster scope), a thread a column folds the cs values from its own
//   shared memory into v, one barrier of the block, and each lane takes its
//   columns of v into registers. The receive buffers, the block's sent
//   values and the mbarriers are double-buffered by iteration parity: a
//   block's values of iteration it + 2 can only be sent after their sender
//   received this block's values of it + 1, which this block sends after it
//   read parity it. An mbarrier's expected bytes are posted before any of
//   its values can arrive. Where the cs x m receive buffers do not fit
//   beside x (768^2), block q receives only its slice of columns (stores
//   through map_shared_rank), folds it into v and stores that slice into
//   every block: two cluster barriers (arrive.release, wait.acquire) an
//   iteration.
//
//   Measured on an H100 (PERF.md; measure_resident.py): the loop is latency
//   bound, about 1.45 us an iteration at 6 x 128^2 and 2.7 at 6 x 256^2,
//   against 0.7 us for a cluster barrier alone.
//
// Numerics: expf/logf, never the fast-math intrinsics. A max starts at -inf
// with a sum of 0, and a -inf value contributes nothing. Ragged n and m are
// bounds-masked: columns past m hold -inf, a block whose band starts past n
// holds no rows and contributes -inf. The entropy is summed in a fixed
// order: rows in a warp, warps in a block, blocks in the cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sinkhorn_loops.cuh"  // warp_max, warp_sum, tree_max, tree_exp_sum

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 16;        // non-portable above 8
constexpr int kMaxQuads = 6;           // columns a row: up to 4 x 32 x 6 = 768
constexpr int kRegCells = 16;          // x in registers up to this many cells a thread
constexpr size_t kMaxSmem = 232448;    // 227 KB a block on sm_90
constexpr int kErrNoCluster = 100001;  // no cluster of this size fits
constexpr int kErrPlan = 100003;       // the caller's plan is not the kernel's
static_assert(kWarps <= kMaxCluster, "a fold's slots cover the warps of a block");

// The plan of one matrix on a cluster of cs blocks; the same rule as
// ops/sinkhorn_resident_cuda.py::resident_plan, which the launch checks.
struct Plan {
  int band;     // rows a block
  int quads;    // float4 columns a lane
  int regs;     // rows a warp in registers (0: x in shared memory)
  int push;     // 1: every block receives every column (an mbarrier); 0: its slice
  size_t smem;  // bytes of shared memory a block
};

// Row stride, in values, of each warp's and each block's column values: m
// rounded up to a 128-byte line. A value is a (max, sum) pair (8 bytes)
// with x in registers, a log-sum-exp float (4) otherwise.
__host__ __device__ constexpr int value_stride(int m, int value_bytes) {
  return (m + 128 / value_bytes - 1) / (128 / value_bytes) * (128 / value_bytes);
}

// Bytes of shared memory a block: x where it is not in registers, v, the
// entropy sums and two mbarriers, each warp's column values, the receive
// buffers (two parities of every block's values, or every block's values
// of this block's slice of columns) and, where every block receives every
// value, the block's own values in two parities.
inline size_t smem_bytes(int band, int m, int cs, int regs, int push) {
  const size_t ldm = (m + 3) / 4 * 4;
  const size_t slice = (m + cs - 1) / cs;
  const int value = regs ? 8 : 4;
  const size_t stride = value_stride(m, value);
  return 4 * ((regs ? 0 : (size_t)band * ldm) + ldm + kWarps + 8) +
         value * ((size_t)kWarps * stride +
                  (push ? 2 * ((size_t)cs + 1) * stride : (size_t)cs * slice));
}

inline bool make_plan(int n, int m, int cs, Plan* p) {
  if (n < 1 || m < 1 || cs < 1 || cs > kMaxCluster) return false;
  p->band = (n + cs - 1) / cs;
  p->quads = (m + 127) / 128;
  if (p->quads > kMaxQuads) return false;
  const int rows = (p->band + kWarps - 1) / kWarps;
  p->regs = (p->quads <= 2 && 4 * p->quads * rows <= kRegCells) ? rows : 0;
  p->push = smem_bytes(p->band, m, cs, p->regs, 1) <= kMaxSmem ? 1 : 0;
  p->smem = smem_bytes(p->band, m, cs, p->regs, p->push);
  return p->smem <= kMaxSmem;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// This block's one arrival on `bar` for the current phase, which then also
// waits for `bytes` of remote bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete; the stores it
// counted, from any block of the cluster, are then visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copies `bytes` (a multiple of 16) from `src` in this block's shared memory
// to the same place as `dst` in block `rank`, by the TMA engine, counted in
// bytes on that block's mbarrier at `bar`.
__device__ __forceinline__ void bulk_to_peer(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(peer_addr(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(peer_addr(bar, rank))
      : "memory");
}

// Warp max in one redux.sync: floats mapped to ints of the same order.
__device__ __forceinline__ float warp_max_redux(float x) {
  int i = __float_as_int(x);
  i = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ float2 as_pair(float2 p) { return p; }
__device__ __forceinline__ float2 as_pair(float lse) { return make_float2(lse, 1.f); }
__device__ __forceinline__ float lse_of(float2 p) {
  return p.x == -INFINITY ? -INFINITY : p.x + logf(p.y);
}

// The finite stand-in for a max in exp(z - max): 0 for a max of -inf, whose
// terms are all exp(-inf) = 0. It keeps the reductions free of branches, so
// the expf of independent terms overlap.
__device__ __forceinline__ float finite_max(float mx) { return mx == -INFINITY ? 0.f : mx; }

// The (max, sum) of the K <= NV values src[k * stride] of one column (a
// (max, sum) pair, or a log-sum-exp taken as (L, 1)), in the order k = 0,
// 1, ...: all loads, the max, then the terms, so the expf overlap. No
// branch: an empty slot is (-inf, 0). `ok` false: no column, (-inf, 0).
template <int NV, typename T>
__device__ __forceinline__ float2 fold_values(const T* src, int stride, int K, bool ok) {
  float2 t[NV];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    t[k] = (ok && k < K) ? as_pair(src[(size_t)k * stride]) : make_float2(-INFINITY, 0.f);
    mx = fmaxf(mx, t[k].x);
  }
  const float ms = finite_max(mx);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) s += t[k].y * expf(t[k].x - ms);
  return make_float2(mx, s);
}

// The lane's Q quads of one row of x = -lam * C, shifted by the row's max
// (a warp's shuffles); columns past m hold -inf.
template <int Q>
__device__ __forceinline__ void load_row(const float* __restrict__ cr, float lam, int m, int lane,
                                         float4 (&t)[Q]) {
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int c = 4 * (lane + 32 * k);
    float a[4];
    if (m % 4 == 0 && c < m) {  // the row starts 16-byte aligned
      const float4 g = *reinterpret_cast<const float4*>(cr + c);
      a[0] = -lam * g.x, a[1] = -lam * g.y, a[2] = -lam * g.z, a[3] = -lam * g.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = c + e < m ? -lam * cr[c + e] : -INFINITY;
    }
    t[k] = make_float4(a[0], a[1], a[2], a[3]);
    mx = fmaxf(mx, fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])));
  }
  mx = warp_max_redux(mx);
#pragma unroll
  for (int k = 0; k < Q; ++k) t[k].x -= mx, t[k].y -= mx, t[k].z -= mx, t[k].w -= mx;
}

// The row potential u = -logsumexp(x + v) of one row of a warp, from the
// lane's Q quads of x and of v (warp reductions; every lane gets u).
template <int Q>
__device__ __forceinline__ float row_potential(const float4 (&x)[Q], const float4 (&v)[Q]) {
  float y[4 * Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    y[4 * k] = x[k].x + v[k].x;
    y[4 * k + 1] = x[k].y + v[k].y;
    y[4 * k + 2] = x[k].z + v[k].z;
    y[4 * k + 3] = x[k].w + v[k].w;
  }
  const float mx = tree_max<4 * Q>(y);
  float s = tree_exp_sum<4 * Q>(y, finite_max(mx));  // 0 for a lane past m
  const float mw = warp_max_redux(mx);
  s = warp_sum(s * expf(mx - mw));  // the row max mw is finite
  return -(mw + logf(s));
}

// Folds z = x + u of one more row into the lane's running column (max,
// sum) cm, cs: one expf a cell, the larger of the old max and z rescaling
// the other term. Columns past m hold -inf and are never read.
template <int Q>
__device__ __forceinline__ void column_online(const float4 (&x)[Q], float u, float (&cm)[4 * Q],
                                              float (&cs)[4 * Q]) {
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float xs[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = xs[e] + u;
      const float nm = fmaxf(cm[4 * k + e], z);
      const float t = expf(fminf(cm[4 * k + e], z) - nm);
      cs[4 * k + e] = z > cm[4 * k + e] ? cs[4 * k + e] * t + 1.f : cs[4 * k + e] + t;
      cm[4 * k + e] = nm;
    }
  }
}

// The lane's column (max, sum) over the R rows of a warp held in registers,
// z = x[i] + u[i] for the rows i < rows (the rest -inf): the max is known
// before the sum, so no rescale, and one row needs no expf at all.
template <int Q, int R>
__device__ __forceinline__ void column_rows(const float4 (&x)[R][Q], const float (&u)[R], int rows,
                                            float (&cm)[4 * Q], float (&cs)[4 * Q]) {
#pragma unroll
  for (int k = 0; k < Q; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float z[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 q = x[i][k];
        const float xe = e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
        z[i] = i < rows ? xe + u[i] : -INFINITY;
      }
      const float mx = tree_max<R>(z);
      cm[4 * k + e] = mx;
      cs[4 * k + e] = R == 1 ? 1.f : tree_exp_sum<R>(z, finite_max(mx));
    }
  }
}

// One row of the epilogue: P = softmax(x + v) stored to pr (m columns), and
// the row's entropy, returned on every lane.
template <int Q>
__device__ __forceinline__ float row_out(const float4 (&x)[Q], const float4 (&v)[Q],
                                         float* __restrict__ pr, int m, int lane) {
  float y[4 * Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    y[4 * k] = x[k].x + v[k].x;
    y[4 * k + 1] = x[k].y + v[k].y;
    y[4 * k + 2] = x[k].z + v[k].z;
    y[4 * k + 3] = x[k].w + v[k].w;
  }
  const float mx = tree_max<4 * Q>(y);
  float s = tree_exp_sum<4 * Q>(y, finite_max(mx));  // 0 for a lane past m
  const float mw = warp_max_redux(mx);
  s = warp_sum(s * expf(mx - mw));  // the row max mw is finite
  const float log_s = logf(s);
  float h = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane + 32 * k) + e;
      if (c < m) {
        const float t = y[4 * k + e] - mw;
        const float p = expf(t) / s;
        pr[c] = p;
        h += p * (t - log_s);
      }
    }
  }
  return -warp_sum(h);
}

// Grid (cs, b), cluster (cs, 1, 1): cluster blockIdx.y owns matrix
// blockIdx.y; block blockIdx.x of it owns rows [blockIdx.x * band, + band).
// Q: float4 columns a lane; RR: rows a warp held in registers (0: x in
// shared memory; then the column values are log-sum-exp floats, which take
// half the memory of (max, sum) pairs).
template <int Q, int RR>
__global__ void __launch_bounds__(kThreads, 1)
resident_sinkhorn(const float* __restrict__ cost, float* __restrict__ p_out,
                  float* __restrict__ ent_out, int n, int m, int band, int cs, int push,
                  float lam, int n_iters) {
  using Value = std::conditional_t<(RR > 0), float2, float>;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int ldm = (m + 3) / 4 * 4;
  const int slice = (m + cs - 1) / cs;
  float* xs = smem;                                   // band x ldm (RR == 0)
  float* v_s = xs + (RR ? 0 : (size_t)band * ldm);    // ldm
  float* red = v_s + ldm;                                 // kWarps + 4: the entropy sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kWarps + 4);  // 2, one a parity
  Value* wp = reinterpret_cast<Value*>(red + kWarps + 8);             // kWarps x S
  constexpr int vb = sizeof(Value);
  const int S = value_stride(m, vb);
  Value* recv = wp + (size_t)kWarps * S;  // 2 x cs x S (push) or cs x slice
  Value* bp = recv + 2 * (size_t)cs * S;   // push: 2 x S, the block's values by parity

  const int rank = blockIdx.x;
  const int mat = blockIdx.y;
  const int row0 = rank * band;
  const int own = max(0, min(band, n - row0));  // rows this block owns
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rows_w = warp < own ? (own - warp + kWarps - 1) / kWarps : 0;  // this warp's rows
  const int groups = min(kWarps, own);  // warps with rows: the values of the block fold
  const uint32_t row_bytes = (uint32_t)((m * sizeof(Value) + 15) / 16 * 16);  // a block's values
  const uint32_t value_bytes = (uint32_t)cs * row_bytes;  // received an iteration

  // 1. x = -lam * C, each row shifted by its max; columns past m hold -inf
  float4 xr[RR ? RR : 1][Q];
  const float* cm0 = cost + ((size_t)mat * n + row0) * m;
  if (RR) {
#pragma unroll
    for (int i = 0; i < (RR ? RR : 1); ++i) {
      if (i < rows_w) load_row<Q>(cm0 + (size_t)(warp + kWarps * i) * m, lam, m, lane, xr[i]);
    }
  } else {
    for (int i = 0; i < rows_w; ++i) {
      const int r = warp + kWarps * i;
      float4 t[Q];
      load_row<Q>(cm0 + (size_t)r * m, lam, m, lane, t);
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        float4* xr4 = reinterpret_cast<float4*>(xs + (size_t)r * ldm);
        if (4 * (lane + 32 * k) < m) xr4[lane + 32 * k] = t[k];
      }
    }
  }
  for (int j = tid; j < ldm; j += kThreads) v_s[j] = 0.f;
  float4 vr[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) vr[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (push && n_iters > 0) mbar_expect(&bars[0], value_bytes);
  }
  cluster.sync();  // every block has started (its shared memory, mbarriers included)

  // 2. the loop; nothing leaves the cluster
  for (int it = 0; it < n_iters; ++it) {
    float cmx[4 * Q], csm[4 * Q];
#pragma unroll
    for (int q = 0; q < 4 * Q; ++q) cmx[q] = -INFINITY, csm[q] = 0.f;
    if (RR) {
      float u[RR ? RR : 1];
#pragma unroll
      for (int i = 0; i < (RR ? RR : 1); ++i) u[i] = i < rows_w ? row_potential<Q>(xr[i], vr) : 0.f;
      column_rows<Q>(xr, u, rows_w, cmx, csm);
    } else {
      for (int i = 0; i < rows_w; ++i) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + (size_t)(warp + kWarps * i) * ldm);
        const float4* v4 = reinterpret_cast<const float4*>(v_s);
        float4 xq[Q], vq[Q];
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const bool in = 4 * (lane + 32 * k) < m;
          xq[k] = in ? x4[lane + 32 * k] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          vq[k] = in ? v4[lane + 32 * k] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        column_online<Q>(xq, row_potential<Q>(xq, vq), cmx, csm);
      }
    }
    if (rows_w > 0) {
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int c = 4 * (lane + 32 * k);  // a quad past m is not written; one across it is whole
        if (c < m) {
          float4* w4 = reinterpret_cast<float4*>(wp + (size_t)warp * S + c);
          const float* a = cmx + 4 * k;
          const float* b = csm + 4 * k;
          if constexpr (RR > 0) {
            w4[0] = make_float4(a[0], b[0], a[1], b[1]);
            w4[1] = make_float4(a[2], b[2], a[3], b[3]);
          } else {
            w4[0] = make_float4(a[0] + logf(b[0]), a[1] + logf(b[1]), a[2] + logf(b[2]),
                                a[3] + logf(b[3]));
          }
        }
      }
    }
    // this block's arrival for the next iteration on its parity's mbarrier
    // (whose phase of iteration it - 1 is over), which then waits for cs x m
    // values from the cluster; before any value of this iteration leaves
    // the block, so before any peer can send one of the next
    if (push && tid == 0 && it + 1 < n_iters) mbar_expect(&bars[(it + 1) & 1], value_bytes);
    __syncthreads();  // every warp's column values are in wp

    // the block's value of each column: into bp, sent whole below (push),
    // or into the receive buffer of the column's owner
    Value* rb = recv + (push ? (size_t)(it & 1) * cs * S : 0);
    for (int j = tid; j < m; j += kThreads) {
      const float2 pr = fold_values<kWarps>(wp + j, S, groups, true);
      Value L;
      if constexpr (RR > 0) {
        L = pr;
      } else {
        L = lse_of(pr);
      }
      if (push) {
        bp[(it & 1) * S + j] = L;
      } else {
        const int o = j / slice;
        cluster.map_shared_rank(rb, o)[(size_t)rank * slice + (j - o * slice)] = L;
      }
    }
    if (push) {
      // the block's values, whole, to every block of the cluster: one bulk
      // copy a peer. bp is double-buffered: its parity is written again
      // only after every peer has received these (it waited for values that
      // the peers sent after receiving these)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        for (int q = 0; q < cs; ++q) {
          bulk_to_peer(rb + (size_t)rank * S, bp + (it & 1) * S, row_bytes, &bars[it & 1], q);
        }
      }
      mbar_wait(&bars[it & 1], (it >> 1) & 1);  // every block's values of this iteration are here
      for (int j = tid; j < m; j += kThreads) {
        const float2 pr = cs <= 8 ? fold_values<8>(rb + j, S, cs, true)
                                  : fold_values<kMaxCluster>(rb + j, S, cs, true);
        v_s[j] = -lse_of(pr);
      }
      __syncthreads();
    } else {
      cluster_arrive();
      cluster_wait();  // every block's values of this column slice are here
      const int c0 = rank * slice, cn = max(0, min(slice, m - c0));
      for (int j = tid; j < cn; j += kThreads) {
        const float L = lse_of(fold_values<kMaxCluster>(rb + j, slice, cs, true));
        for (int q = 0; q < cs; ++q) cluster.map_shared_rank(v_s, q)[c0 + j] = -L;
      }
      cluster_arrive();
      cluster_wait();  // every slice of v is in every block
    }
    if (RR) {
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        if (4 * (lane + 32 * k) < m) vr[k] = reinterpret_cast<const float4*>(v_s)[lane + 32 * k];
      }
    }
  }

  // 3. P = softmax_rows(x + v) and the band's sum of row entropies
  float ent = 0.f;  // this warp's rows, in order
  float* pb = p_out + ((size_t)mat * n + row0) * m;
  if (RR) {
#pragma unroll
    for (int i = 0; i < (RR ? RR : 1); ++i) {
      if (i < rows_w) ent += row_out<Q>(xr[i], vr, pb + (size_t)(warp + kWarps * i) * m, m, lane);
    }
  } else {
    for (int i = 0; i < rows_w; ++i) {
      const int r = warp + kWarps * i;
      const float4* x4 = reinterpret_cast<const float4*>(xs + (size_t)r * ldm);
      const float4* v4 = reinterpret_cast<const float4*>(v_s);
      float4 xq[Q], vq[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const bool in = 4 * (lane + 32 * k) < m;
        xq[k] = in ? x4[lane + 32 * k] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        vq[k] = in ? v4[lane + 32 * k] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      ent += row_out<Q>(xq, vq, pb + (size_t)r * m, m, lane);
    }
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

// n cluster barriers (arrive, then wait) and nothing else: the latency floor
// of the loop's barrier, measured alone.
__global__ void __launch_bounds__(kThreads, 1) cluster_barrier_loop(int n) {
  for (int i = 0; i < n; ++i) {
    cluster_arrive();
    cluster_wait();
  }
}

using Kernel = void (*)(const float*, float*, float*, int, int, int, int, int, float, int);

// The kernel of a plan: quads 1-2 with 1-4 rows a warp in registers (at most
// kRegCells a thread), or x in shared memory with 1-6 quads.
Kernel kernel_for(int quads, int regs) {
  if (regs) {
    if (quads == 1) {
      const Kernel k[4] = {resident_sinkhorn<1, 1>, resident_sinkhorn<1, 2>,
                           resident_sinkhorn<1, 3>, resident_sinkhorn<1, 4>};
      return regs <= 4 ? k[regs - 1] : nullptr;
    }
    if (quads == 2 && regs <= 2) {
      return regs == 1 ? resident_sinkhorn<2, 1> : resident_sinkhorn<2, 2>;
    }
    return nullptr;
  }
  const Kernel k[kMaxQuads] = {resident_sinkhorn<1, 0>, resident_sinkhorn<2, 0>,
                               resident_sinkhorn<3, 0>, resident_sinkhorn<4, 0>,
                               resident_sinkhorn<5, 0>, resident_sinkhorn<6, 0>};
  return quads >= 1 && quads <= kMaxQuads ? k[quads - 1] : nullptr;
}

// Sets the shared memory and cluster attributes of fn and fills cfg for a
// grid (cs, b) of clusters of cs; returns 0, a cudaError_t, or
// kErrNoCluster when the card cannot hold one such cluster.
int configure(const void* fn, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cs, int b,
              size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  *cfg = {};
  cfg->gridDim = dim3(cs, b, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, cfg);
  if (err != cudaSuccess) return (int)err;
  return clusters < 1 ? kErrNoCluster : 0;
}

}  // namespace

extern "C" {

// One launch on `stream`: cost (b, n, m) -> p (b, n, m), ent (b), all
// float32, allocated by the caller; `cs` blocks a cluster, one cluster a
// matrix. The caller's plan (band, quads, regs, push: resident_plan
// of ops/sinkhorn_resident_cuda.py) must be the kernel's own for (n, m, cs).
// Returns 0, a cudaError_t (cudaErrorInvalidValue for a shape or cluster
// the kernel cannot hold), kErrPlan, or kErrNoCluster when the card cannot
// hold one cluster of this size and shared memory.
int otgan_resident_sinkhorn(const float* cost, float* p, float* ent, int b, int n, int m, int cs,
                            int band, int quads, int regs, int push, float lam, int n_iters,
                            void* stream_ptr) {
  Plan plan;
  if (b < 1 || b > 65535 || n_iters < 0 || !make_plan(n, m, cs, &plan)) {
    return (int)cudaErrorInvalidValue;
  }
  if (band != plan.band || quads != plan.quads || regs != plan.regs || push != plan.push) {
    return kErrPlan;
  }
  const Kernel fn = kernel_for(plan.quads, plan.regs);
  if (fn == nullptr) return kErrPlan;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure((const void*)fn, &cfg, attr, cs, b, plan.smem,
                      static_cast<cudaStream_t>(stream_ptr));
  if (err != 0) return err;
  cudaError_t e = cudaLaunchKernelEx(&cfg, fn, cost, p, ent, n, m, plan.band, cs, plan.push, lam,
                                     n_iters);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `n` cluster barriers on b clusters of `cs` blocks of the kernel's threads
// and nothing else, on `stream`.
int otgan_resident_barrier_loop(int cs, int b, int n, void* stream_ptr) {
  if (cs < 1 || cs > kMaxCluster || b < 1 || b > 65535 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure((const void*)cluster_barrier_loop, &cfg, attr, cs, b, 0,
                      static_cast<cudaStream_t>(stream_ptr));
  if (err != 0) return err;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_barrier_loop, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* otgan_resident_error_string(int err) {
  if (err == kErrNoCluster) return "no thread-block cluster of this size and shared memory fits";
  if (err == kErrPlan) return "the plan is not the kernel's own for this shape and cluster";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
