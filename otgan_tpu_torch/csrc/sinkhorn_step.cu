// One local Sinkhorn step of the row-sharded matcher, for sm_90a.
//
// Replaces the two TPU kernels of otgan_tpu/ops/sinkhorn_pallas_step.py:
// _local_step_kernel (tier "fused", via fused_local_sinkhorn_step) and
// _streaming_step_kernel (tier "stream", via streaming_local_sinkhorn_step).
// Both compute, for a rank's row block x = -lam * C[rows, :] of shape
// (b, n_loc, m) float32 and the replicated column potential v (b, m),
//
//     u_i  = -logsumexp_j(x_ij + v_j)
//     m_j  = max_i(x_ij + u_i),   s_j = sum_i exp(x_ij + u_i - m_j)
//
// the LOCAL column partials (m, s), shape (b, m) each, that the caller
// combines across ranks (all-reduce MAX of m, SUM of s * exp(m - m_glob)).
// The row potential u never leaves the kernel. Ragged edges are masked by
// bounds: the block runs unpadded, with no TPU tile padding.
//
// Each step is two launches:
//
//   fused:  (a) panel_partials (sinkhorn_panel.cuh), grid (n_panels, b), one
//           16-row panel per block, partials to a (b, n_panels, m) scratch;
//   stream: (a) stream_partials, grid (G, b) with G sized to fill the SMs:
//           each block walks panels c, c + G, ... and keeps a running
//           (max, rescaled sum) per column in shared memory, the Pallas
//           kernel's online accumulation, then writes one partial per
//           block to a (b, G, m) scratch;
//   both:   (b) combine_step, grid (column blocks, b): folds the partials of
//           each column into (m_j, s_j).
//
// What bounds it: a step reads its block once from device memory (18.8 MB
// at (6, 313, 2500), 96 MB at (6, 1000, 4000); 5.6 and 28.7 us at 3.35 TB/s),
// and each panel three more times from L1/L2. The operations (10 float32
// per cell) take 0.70 us and 3.6 us at 67 TFLOP/s. At these sizes two
// launches (~4 us each) and the two all-reduces between steps are of the
// same order, so this first version keeps the kernels simple; the stream
// tier's scratch is G x m in place of n_panels x m.

#include "sinkhorn_panel.cuh"

namespace {

// The stream tier's accumulators: 2 floats per column in dynamic shared
// memory, within the 227 KB (232,448 B) a block can have on sm_90, less room
// for the static u_s.
constexpr int kMaxDynamicBytes = 232448 - 1024;

__global__ void __launch_bounds__(kThreads)
stream_partials(const float* __restrict__ x, const float* __restrict__ v,
                float* __restrict__ m_part, float* __restrict__ s_part,
                int n, int m, int n_panels, int n_ctas) {
  extern __shared__ float acc[];  // m_acc[m], then s_acc[m]
  __shared__ float u_s[kRows];
  float* m_acc = acc;
  float* s_acc = acc + m;
  const int c = blockIdx.x;
  const int mat = blockIdx.y;
  const float* vm = v + (size_t)mat * m;

  // each thread owns columns threadIdx.x + k * kThreads across all panels,
  // so the accumulators need no synchronisation, only u_s does
  for (int j = threadIdx.x; j < m; j += kThreads) {
    m_acc[j] = -INFINITY;
    s_acc[j] = 0.f;
  }
  for (int p = c; p < n_panels; p += n_ctas) {
    const int row0 = p * kRows;
    const int rows = min(kRows, n - row0);
    const float* xp = x + ((size_t)mat * n + row0) * m;
    __syncthreads();  // the previous panel's column pass is done with u_s
    panel_row_potentials(xp, vm, u_s, rows, m);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      float pm = -INFINITY;
      for (int r = 0; r < rows; ++r) pm = fmaxf(pm, xp[(size_t)r * m + j] + u_s[r]);
      const float m_old = m_acc[j];
      const float m_new = fmaxf(m_old, pm);
      if (m_new == -INFINITY) continue;  // nothing finite seen yet
      float s = m_old == -INFINITY ? 0.f : s_acc[j] * expf(m_old - m_new);
      for (int r = 0; r < rows; ++r) s += expf(xp[(size_t)r * m + j] + u_s[r] - m_new);
      m_acc[j] = m_new;
      s_acc[j] = s;
    }
  }
  float* mp = m_part + ((size_t)mat * n_ctas + c) * m;
  float* sp = s_part + ((size_t)mat * n_ctas + c) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    mp[j] = m_acc[j];
    sp[j] = s_acc[j];
  }
}

__global__ void __launch_bounds__(kThreads)
combine_step(const float* __restrict__ m_part, const float* __restrict__ s_part,
             float* __restrict__ m_out, float* __restrict__ s_out, int m,
             int n_parts) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int mat = blockIdx.y;
  if (j >= m) return;
  float mx, s;
  fold_partials(m_part, s_part, mat, j, m, n_parts, &mx, &s);
  m_out[(size_t)mat * m + j] = mx;
  s_out[(size_t)mat * m + j] = s;
}

int combine(const float* m_part, const float* s_part, float* m_out, float* s_out,
            int b, int m, int n_parts, cudaStream_t stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  combine_step<<<grid, kThreads, 0, stream>>>(m_part, s_part, m_out, s_out, m, n_parts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per panel: the wrapper sizes the fused tier's scratch with it.
int otgan_step_rows_per_panel(void) { return kRows; }

// Widest row block the stream tier takes (its accumulators' shared memory).
int otgan_step_stream_max_cols(void) { return kMaxDynamicBytes / (2 * (int)sizeof(float)); }

// Tier "fused": x (b, n, m), v (b, m) -> m_out, s_out (b, m), with m_part
// and s_part (b, ceil(n / kRows), m) as scratch; all float32, allocated by
// the caller. Returns the first cudaError_t (0 on success).
int otgan_local_step_fused(const float* x, const float* v, float* m_out, float* s_out,
                           float* m_part, float* s_part, int b, int n, int m,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_panels = (n + kRows - 1) / kRows;
  panel_partials<<<dim3(n_panels, b), kThreads, 0, stream>>>(x, v, m_part, s_part, n, m,
                                                              n_panels);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(m_part, s_part, m_out, s_out, b, m, n_panels, stream);
}

// Tier "stream": as the fused tier, with n_ctas blocks per matrix and
// m_part, s_part (b, n_ctas, m) as scratch.
int otgan_local_step_stream(const float* x, const float* v, float* m_out, float* s_out,
                            float* m_part, float* s_part, int b, int n, int m, int n_ctas,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = 2 * sizeof(float) * (size_t)m;
  if (smem > (size_t)kMaxDynamicBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stream_partials,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_panels = (n + kRows - 1) / kRows;
  stream_partials<<<dim3(n_ctas, b), kThreads, smem, stream>>>(x, v, m_part, s_part, n, m,
                                                               n_panels, n_ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine(m_part, s_part, m_out, s_out, b, m, n_ctas, stream);
}

const char* otgan_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
