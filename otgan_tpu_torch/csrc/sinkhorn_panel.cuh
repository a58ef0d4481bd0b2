// One Sinkhorn row panel on a CUDA block, for csrc/sinkhorn.cu (the whole
// column-potential loop, TPU kernel ops/sinkhorn_pallas_tiled.py).
//
// A panel is kRows consecutive rows of one (n, m) float32 matrix of
// pre-scaled logits x = -lam * C, row-major. For those rows,
//
//     u_i = -logsumexp_j(x_ij + v_j)                     (panel_row_potentials)
//
// then the panel's column partials of z = x + u (the old v is not in z),
//
//     m_p[j] = max_i z_ij,  s_p[j] = sum_i exp(z_ij - m_p[j])   (panel_partials)
//
// which is the (x, v) -> (m, s) contract of
// otgan_tpu/ops/sinkhorn_pallas_step.py::_local_step_kernel on one panel.
//
// Numerics: expf/logf, never the fast-math intrinsics (lam = 500 amplifies
// error 500x). A max starts at -inf with a sum of 0, and a -inf partial
// contributes nothing (the guard of the Pallas kernels' rescale).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "sinkhorn_loops.cuh"  // warp_max, warp_sum

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // rows per panel

// Row step of one panel: a warp per row writes u_s[r] for r < rows.
// xp points at the panel's first row, vm at the matrix's column potential.
__device__ __forceinline__ void panel_row_potentials(const float* __restrict__ xp,
                                                     const float* __restrict__ vm,
                                                     float* u_s, int rows, int m) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = xp + (size_t)r * m;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, xr[j] + vm[j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < m; j += 32) s += expf(xr[j] + vm[j] - mx);
    s = warp_sum(s);
    if (lane == 0) u_s[r] = -(mx + logf(s));
  }
}

// Grid (row panels, b): each block writes its panel's column partials to
// m_part and s_part, shape (b, n_panels, m).
__global__ void __launch_bounds__(kThreads)
panel_partials(const float* __restrict__ x, const float* __restrict__ v,
               float* __restrict__ m_part, float* __restrict__ s_part,
               int n, int m, int n_panels) {
  __shared__ float u_s[kRows];
  const int p = blockIdx.x;
  const int mat = blockIdx.y;
  const int row0 = p * kRows;
  const int rows = min(kRows, n - row0);
  const float* xp = x + ((size_t)mat * n + row0) * m;

  panel_row_potentials(xp, v + (size_t)mat * m, u_s, rows, m);
  __syncthreads();

  // this panel's column partials of z = x + u (the old v is excluded)
  float* mp = m_part + ((size_t)mat * n_panels + p) * m;
  float* sp = s_part + ((size_t)mat * n_panels + p) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    float mx = -INFINITY;
    for (int r = 0; r < rows; ++r) mx = fmaxf(mx, xp[(size_t)r * m + j] + u_s[r]);
    float s = 0.f;
    if (mx != -INFINITY) {
      for (int r = 0; r < rows; ++r) s += expf(xp[(size_t)r * m + j] + u_s[r] - mx);
    }
    mp[j] = mx;
    sp[j] = s;
  }
}

// Folds the (b, n_parts, m) partials of column j of matrix mat into that
// column's (max, rescaled sum): *mx_out = max_p m_p, *s_out = sum_p s_p *
// exp(m_p - max). An all -inf column gives (-inf, 0).
__device__ __forceinline__ void fold_partials(const float* __restrict__ m_part,
                                              const float* __restrict__ s_part,
                                              int mat, int j, int m, int n_parts,
                                              float* mx_out, float* s_out) {
  const float* mp = m_part + (size_t)mat * n_parts * m + j;
  const float* sp = s_part + (size_t)mat * n_parts * m + j;
  float mx = -INFINITY;
  for (int p = 0; p < n_parts; ++p) mx = fmaxf(mx, mp[(size_t)p * m]);
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    const float mpp = mp[(size_t)p * m];
    if (mpp != -INFINITY) s += sp[(size_t)p * m] * expf(mpp - mx);
  }
  *mx_out = mx;
  *s_out = s;
}

}  // namespace
