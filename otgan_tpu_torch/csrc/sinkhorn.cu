// Column potential of log-domain Sinkhorn on a batch of matrices, for sm_90a.
//
// Replaces otgan_tpu/ops/sinkhorn_pallas_tiled.py::_kernel (launched by
// _col_potential). Given pre-scaled logits x = -lam * C, shape (b, n, m)
// float32 row-major, it runs n_iters iterations of
//
//     u_i = -logsumexp_j(x_ij + v_j)          (row step)
//     v_j = -logsumexp_i(x_ij + u_i)          (column step; REPLACES v)
//
// from v = 0 and leaves the final v, shape (b, m).
//
// A TPU grid runs in order, so the Pallas kernel carries online column
// accumulators in VMEM from one row panel to the next. Blocks of a CUDA
// grid run in parallel and in no order, so each iteration is two launches:
//
//   (a) panel_partials, grid (row panels, b): a warp per row finds u_i over
//       its panel's rows, then a thread per column folds the panel into
//       m_p[j] = max_i(x_ij + u_i) and s_p[j] = sum_i exp(x_ij + u_i - m_p[j]),
//       written to a (b, n_panels, m) scratch. This is the (x, v) -> (m, s)
//       contract of otgan_tpu/ops/sinkhorn_pallas_step.py::_local_step_kernel.
//   (b) combine_partials, grid (column blocks, b): v_j = -(m* + log sum_p
//       s_p exp(m_p - m*)), with m* = max_p m_p.
//
// What bounds it: at the reference batch 5000 one match is 6 x 2500^2 f32 =
// 150 MB, more than the 50 MB L2, so each iteration streams x from device
// memory (each panel is read four times; the later reads hit L1/L2). The
// design does nothing more about that yet: no shared-memory panel, no TMA,
// no L2 residency control, and 2 launches per iteration; at small matrices
// the launch latency dominates. Ragged edges are masked by bounds, so any
// n, m.
//
// Launch (a) and the numerics live in sinkhorn_panel.cuh. The row-sharded
// matcher's local step (sinkhorn_step.cu) computes (a)'s contract on a whole
// row block in one launch.

#include "sinkhorn_panel.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
combine_partials(const float* __restrict__ m_part, const float* __restrict__ s_part,
                 float* __restrict__ v, int m, int n_panels) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int mat = blockIdx.y;
  if (j >= m) return;
  float mx, s;
  fold_partials(m_part, s_part, mat, j, m, n_panels, &mx, &s);
  v[(size_t)mat * m + j] = -(mx + logf(s));
}

}  // namespace

extern "C" {

// Rows per panel: the wrapper sizes the (b, n_panels, m) scratch with it.
int otgan_sinkhorn_rows_per_panel(void) { return kRows; }

// Runs the whole n_iters loop on `stream`; returns the first cudaError_t
// (0 on success). v, m_part and s_part are allocated by the caller:
// v (b, m), m_part and s_part (b, ceil(n / kRows), m), all float32.
int otgan_sinkhorn_col_potential(const float* x, float* v, float* m_part,
                                 float* s_part, int b, int n, int m,
                                 int n_iters, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(v, 0, sizeof(float) * (size_t)b * m, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_panels = (n + kRows - 1) / kRows;
  const dim3 grid_a(n_panels, b);
  const dim3 grid_b((m + kThreads - 1) / kThreads, b);
  for (int it = 0; it < n_iters; ++it) {
    panel_partials<<<grid_a, kThreads, 0, stream>>>(x, v, m_part, s_part, n, m, n_panels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    combine_partials<<<grid_b, kThreads, 0, stream>>>(m_part, s_part, v, m, n_panels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* otgan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
