// The one-pass Sinkhorn loops shared by csrc/sinkhorn_grid.cu (the whole
// loop, the matrix in the card's shared memory) and csrc/sinkhorn_step.cu
// (one local step of the row-sharded matcher, streamed through a ring of
// shared-memory stages).
//
// Numerics: expf/logf, never the fast-math intrinsics (lam = 500 amplifies
// error 500x). A max starts at -inf with a sum of 0, and a -inf partial
// contributes nothing.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Online (max, sum of exp(z - max)): before a chunk whose max is `cmx` is
// added, rescales the running sum once if the max grows.
__device__ __forceinline__ void online_rescale(float cmx, float& mx, float& s) {
  if (cmx > mx) {
    s = (mx == -INFINITY) ? 0.f : s * expf(mx - cmx);
    mx = cmx;
  }
}

template <int R>
__device__ __forceinline__ float tree_max(const float* z) {
  if constexpr (R == 1) {
    return z[0];
  } else {
    return fmaxf(tree_max<R / 2>(z), tree_max<R - R / 2>(z + R / 2));
  }
}

// sum of expf(z[q] - mx), as a tree (no serial chain of adds)
template <int R>
__device__ __forceinline__ float tree_exp_sum(const float* z, float mx) {
  if constexpr (R == 1) {
    return expf(z[0] - mx);
  } else {
    return tree_exp_sum<R / 2>(z, mx) + tree_exp_sum<R - R / 2>(z + R / 2, mx);
  }
}

// Folds the R values z into the running (max, sum) with no branch: one
// rescale (an expf of 0 when the max stays), R expf. Without the branches
// of online_rescale the compiler overlaps the expf of successive chunks (the
// local-step kernel's loops).
template <int R>
__device__ __forceinline__ void online_chunk(const float* z, float& mx, float& s) {
  const float nm = fmaxf(mx, tree_max<R>(z));
  const float sc = expf(mx - nm);
  const float t = tree_exp_sum<R>(z, nm);
  s = (nm == -INFINITY) ? 0.f : ((mx == -INFINITY) ? 0.f : s * sc) + t;
  mx = nm;
}

// Column step over rows [r0, r0 + R) of a row-major band x (row stride ldm)
// for column j: folds z = x + u into the running (max, sum).
template <int R>
__device__ __forceinline__ void column_chunk(const float* __restrict__ xs,
                                             const float* __restrict__ u, int ldm, int j,
                                             int r0, float& mx, float& s) {
  float z[R];
#pragma unroll
  for (int q = 0; q < R; ++q) z[q] = xs[(size_t)(r0 + q) * ldm + j] + u[r0 + q];
  online_rescale(tree_max<R>(z), mx, s);
  if (mx != -INFINITY) s += tree_exp_sum<R>(z, mx);
}

// Column step for column j over `rows` rows, in chunks of 16 rows, then 8,
// 4, 2, 1: no masked slots.
__device__ __forceinline__ void walk_column(const float* __restrict__ xs,
                                            const float* __restrict__ u, int ldm, int j, int rows,
                                            float& mx, float& s) {
  int r0 = 0;
  for (; r0 + 16 <= rows; r0 += 16) column_chunk<16>(xs, u, ldm, j, r0, mx, s);
  if (rows - r0 >= 8) column_chunk<8>(xs, u, ldm, j, r0, mx, s), r0 += 8;
  if (rows - r0 >= 4) column_chunk<4>(xs, u, ldm, j, r0, mx, s), r0 += 4;
  if (rows - r0 >= 2) column_chunk<2>(xs, u, ldm, j, r0, mx, s), r0 += 2;
  if (rows - r0 >= 1) column_chunk<1>(xs, u, ldm, j, r0, mx, s);
}

// Folds the partial (pm, ps) into the running (max, sum).
__device__ __forceinline__ void combine(float pm, float ps, float& mx, float& s) {
  online_rescale(pm, mx, s);
  if (pm != -INFINITY) s += ps * expf(pm - mx);
}

}  // namespace
