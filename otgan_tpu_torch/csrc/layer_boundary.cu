// Layer boundaries of the DCGAN's bf16 convs: one kernel forward, one (and a
// short sum of the bias partials) backward.
//
// Replaces no TPU kernel: in the JAX package XLA fuses this elementwise chain
// into its neighbours. In PyTorch each link of it is a kernel of its own that
// reads and writes the whole activation: the conv output's upcast to float32,
// the float32 bias, the cast back to bf16, and then either the CReLU's
// negation, concatenation and relu and the copy that pads for XLA's SAME
// (1, 2) stride-2 padding, or the GLU in float32 and the 2x nearest-neighbour
// upsample's copy; autograd runs the same chain backwards.
//
// crelu_pad, forward: reads the previous conv's raw bf16 output y (N, H, W, C)
// once; r = bf16(float(y) + bias), rounded to nearest even where the plain
// chain rounds; writes relu([r, -r]) on 2C channels into the next conv's
// padded input (N, H + pt + pb, W + pl + pr, 2C), zero border included, so
// the conv pads nothing. Backward: reads the gradient of that input and the
// input itself (the conv keeps it) once, and writes
//   g = (x_pos <= 0 ? 0 : g_pos) - (x_neg <= 0 ? 0 : g_neg),
// relu's threshold_backward on each half and the negation's sum.
//
// glu_upsample, forward: y holds halves [h, gate], per pixel for a conv
// (N, H, W, 2C) or over the whole row for the dense layer (N, 2HWC, viewed as
// (H, W, C) after the gate); x = bf16(hb * (1 / (1 + expf(-gb)))), hb =
// float(h) + bias_h and gb = float(gate) + bias_g, the expression of
// PyTorch's float sigmoid, rounded once; written to its f x f
// nearest-neighbour positions of (N, fH, fW, C), f 1 or 2. Backward: the
// f x f gradient summed in float32 in the order PyTorch's reduction of the
// expand takes on the card, ((g00 + g01) + g10) + g11 (read with +1, -1 and
// tiny terms at each pair of positions), and rounded to bf16 (the sum's
// dtype); then in float32 dh = ga * s, dgate = (ga * hb) * (1 - s) * s.
//
// Both backwards write the bf16 gradient of y once and sum the float32
// gradient of float(y) + bias over rows for the bias: each block sums its
// rows in a fixed order and writes one partial a column, and
// bias_grad_sum adds the partials in block order. No atomics, so a replay
// repeats bit for bit.
//
// Layout of a launch: a row is a pixel of y (crelu_pad's forward: of the
// padded output; the dense GLU: an image), a group 8 channels of it, 16
// bytes of bf16. blockIdx.x takes a tile of tg groups, blockIdx.y a chunk of
// rows_per_chunk rows; thread (lane, gl) takes group blockIdx.x * tg + gl
// and rows lane, lane + lanes, ... of the chunk. The tiling is planned in
// Python (nn/layer_boundary.py::tiling) for a fixed count of blocks, so the
// partials' order depends on the shapes alone, not on the card.
//
// Bound: bytes. Each kernel reads its inputs and writes its outputs once, a
// few float32 operations a byte, one expf a GLU value: memory-bound on an
// H100 (3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 8;            // bf16 values a thread moves at once: 16 bytes
constexpr int MAX_THREADS = 256;  // threads a block: tg * lanes

__device__ __forceinline__ void unpack(uint4 u, float (&f)[VEC]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// round each to bf16 (nearest even) and pack, element 0 in the low half
__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// PyTorch's relu (clamp_min at 0), which keeps a NaN
__device__ __forceinline__ float relu(float v) { return (v > 0.f || v != v) ? v : 0.f; }

__device__ __forceinline__ void load_bias(const float* b, float (&f)[VEC]) {
  const float4 lo = *reinterpret_cast<const float4*>(b);
  const float4 hi = *reinterpret_cast<const float4*>(b + 4);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// PyTorch's float sigmoid (UnarySpecialOpsKernel.cu): one / (one + exp(-a))
__device__ __forceinline__ float sigmoid(float a) { return 1.0f / (1.0f + expf(-a)); }

struct Tiling {
  int tg, lanes, rows_per_chunk;
};

// rows [first, end) of this thread: its lane's rows of the block's chunk
__device__ __forceinline__ void chunk_rows(int rows, const Tiling& t, int lane, int& first,
                                           int& end) {
  const long long r0 = static_cast<long long>(blockIdx.y) * t.rows_per_chunk;
  end = static_cast<int>(min(static_cast<long long>(rows), r0 + t.rows_per_chunk));
  first = static_cast<int>(r0) + lane;
}

// the block's column sums: red holds each thread's `width` sums (lane-major);
// the lanes are added in order and written, one partial a column, at
// part[blockIdx.y][col(group, k)]
template <int WIDTH, class Col>
__device__ __forceinline__ void write_partials(float* red, const float* acc, float* part,
                                               int groups, int cols, const Tiling& t, Col col) {
  const int gl = threadIdx.x % t.tg, lane = threadIdx.x / t.tg;
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) red[(lane * t.tg + gl) * WIDTH + k] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < t.tg * WIDTH; i += blockDim.x) {
    const int g = blockIdx.x * t.tg + i / WIDTH;
    if (g >= groups) continue;
    float s = 0.f;
    for (int l = 0; l < t.lanes; ++l) s += red[l * t.tg * WIDTH + i];
    part[static_cast<size_t>(blockIdx.y) * cols + col(g, i % WIDTH)] = s;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    crelu_pad_forward(const uint4* __restrict__ y, const float* __restrict__ bias,
                      uint4* __restrict__ x, int h, int w, int groups, int pt, int pl, int hp,
                      int wp, int rows, Tiling t) {
  const int gl = threadIdx.x % t.tg, lane = threadIdx.x / t.tg;
  const int g = blockIdx.x * t.tg + gl;
  if (g >= groups) return;
  float b[VEC];
  load_bias(bias + g * VEC, b);
  int r, end;
  chunk_rows(rows, t, lane, r, end);
  for (; r < end; r += t.lanes) {
    const int img = r / (hp * wp), p = r - img * hp * wp;
    const int iy = p / wp - pt, ix = p % wp - pl;
    float pos[VEC], neg[VEC];
    if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
      float v[VEC];
      unpack(y[(static_cast<size_t>(img * h + iy) * w + ix) * groups + g], v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float rk = round_bf16(v[k] + b[k]);
        pos[k] = relu(rk);
        neg[k] = relu(-rk);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) pos[k] = neg[k] = 0.f;
    }
    uint4* out = x + static_cast<size_t>(r) * 2 * groups;
    out[g] = pack(pos);
    out[groups + g] = pack(neg);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    crelu_pad_backward(const uint4* __restrict__ gx, const uint4* __restrict__ x,
                       uint4* __restrict__ gy, float* __restrict__ part, int h, int w,
                       int groups, int pt, int pl, int hp, int wp, int rows, Tiling t) {
  __shared__ float red[MAX_THREADS * VEC];
  const int gl = threadIdx.x % t.tg, lane = threadIdx.x / t.tg;
  const int g = blockIdx.x * t.tg + gl;
  float acc[VEC] = {};
  if (g < groups) {
    int r, end;
    chunk_rows(rows, t, lane, r, end);
    for (; r < end; r += t.lanes) {
      const int img = r / (h * w), p = r - img * h * w;
      const int iy = p / w, ix = p - iy * w;
      const size_t q = (static_cast<size_t>(img * hp + iy + pt) * wp + ix + pl) * 2 * groups;
      float gp[VEC], gn[VEC], xp[VEC], xn[VEC], d[VEC];
      unpack(gx[q + g], gp);
      unpack(gx[q + groups + g], gn);
      unpack(x[q + g], xp);
      unpack(x[q + groups + g], xn);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        d[k] = round_bf16((xp[k] <= 0.f ? 0.f : gp[k]) - (xn[k] <= 0.f ? 0.f : gn[k]));
        acc[k] += d[k];
      }
      if (gy) gy[static_cast<size_t>(r) * groups + g] = pack(d);
    }
  }
  if (part)
    write_partials<VEC>(red, acc, part, groups, groups * VEC, t,
                        [](int g, int k) { return g * VEC + k; });
}

// The output pixel (img, iy, ix) and 8-channel group cg of row r, group g:
// a conv's rows are pixels; the dense layer's rows are images, its groups
// run over the (H, W, C) view of the gated half
__device__ __forceinline__ void glu_site(int r, int g, int h_w, int w, int c8, bool dense,
                                         int& img, int& iy, int& ix, int& cg) {
  int p;
  if (dense) {
    img = r;
    p = g / c8;
    cg = g - p * c8;
  } else {
    img = r / h_w;
    p = r - img * h_w;
    cg = g;
  }
  iy = p / w;
  ix = p - iy * w;
}

__global__ void __launch_bounds__(MAX_THREADS)
    glu_upsample_forward(const uint4* __restrict__ y, const float* __restrict__ bias,
                         uint4* __restrict__ x, int h, int w, int c8, int factor, int dense,
                         int rows, int groups, Tiling t) {
  const int gl = threadIdx.x % t.tg, lane = threadIdx.x / t.tg;
  const int g = blockIdx.x * t.tg + gl;
  if (g >= groups) return;
  float bh[VEC], bg[VEC];
  load_bias(bias + g * VEC, bh);
  load_bias(bias + (groups + g) * VEC, bg);
  const int fh = h * factor, fw = w * factor;
  int r, end;
  chunk_rows(rows, t, lane, r, end);
  for (; r < end; r += t.lanes) {
    int img, iy, ix, cg;
    glu_site(r, g, h * w, w, c8, dense, img, iy, ix, cg);
    const uint4* row = y + static_cast<size_t>(r) * 2 * groups;
    float vh[VEC], vg[VEC], o[VEC];
    unpack(row[g], vh);
    unpack(row[groups + g], vg);
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = (vh[k] + bh[k]) * sigmoid(vg[k] + bg[k]);
    const uint4 packed = pack(o);
    for (int dy = 0; dy < factor; ++dy)
      for (int dx = 0; dx < factor; ++dx)
        x[(static_cast<size_t>(img * fh + iy * factor + dy) * fw + ix * factor + dx) * c8 + cg] =
            packed;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    glu_upsample_backward(const uint4* __restrict__ gx, const uint4* __restrict__ y,
                          const float* __restrict__ bias, uint4* __restrict__ gy,
                          float* __restrict__ part, int h, int w, int c8, int factor, int dense,
                          int rows, int groups, Tiling t) {
  __shared__ float red[MAX_THREADS * 2 * VEC];
  const int gl = threadIdx.x % t.tg, lane = threadIdx.x / t.tg;
  const int g = blockIdx.x * t.tg + gl;
  float acc[2 * VEC] = {};
  if (g < groups) {
    float bh[VEC], bg[VEC];
    load_bias(bias + g * VEC, bh);
    load_bias(bias + (groups + g) * VEC, bg);
    const int fh = h * factor, fw = w * factor;
    int r, end;
    chunk_rows(rows, t, lane, r, end);
    for (; r < end; r += t.lanes) {
      int img, iy, ix, cg;
      glu_site(r, g, h * w, w, c8, dense, img, iy, ix, cg);
      const size_t at = (static_cast<size_t>(img * fh + iy * factor) * fw + ix * factor) * c8 + cg;
      float ga[VEC];
      if (factor == 1) {
        unpack(gx[at], ga);
      } else {
        float g00[VEC], g01[VEC], g10[VEC], g11[VEC];
        const size_t down = static_cast<size_t>(fw) * c8;
        unpack(gx[at], g00);
        unpack(gx[at + c8], g01);
        unpack(gx[at + down], g10);
        unpack(gx[at + down + c8], g11);
#pragma unroll
        for (int k = 0; k < VEC; ++k) ga[k] = round_bf16(((g00[k] + g01[k]) + g10[k]) + g11[k]);
      }
      const size_t row = static_cast<size_t>(r) * 2 * groups;
      float vh[VEC], vg[VEC], dh[VEC], dg[VEC];
      unpack(y[row + g], vh);
      unpack(y[row + groups + g], vg);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float hb = vh[k] + bh[k], s = sigmoid(vg[k] + bg[k]);
        dh[k] = ga[k] * s;
        const float dsig = ga[k] * hb;
        dg[k] = dsig * (1.0f - s) * s;  // PyTorch's sigmoid_backward: a * (1 - b) * b
        acc[k] += dh[k];
        acc[VEC + k] += dg[k];
      }
      if (gy) {
        gy[row + g] = pack(dh);
        gy[row + groups + g] = pack(dg);
      }
    }
  }
  if (part)
    write_partials<2 * VEC>(red, acc, part, groups, 2 * groups * VEC, t,
                            [groups](int g, int k) {
                              return k < VEC ? g * VEC + k : (groups + g) * VEC + k - VEC;
                            });
}

__global__ void bias_grad_sum(const float* __restrict__ part, float* __restrict__ gb,
                              int chunks, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int i = 0; i < chunks; ++i) s += part[static_cast<size_t>(i) * cols + c];
  gb[c] = s;
}

int check_tiling(int tg, int lanes, int tiles, int chunks, int rows_per_chunk, int groups,
                 int rows) {
  if (tg < 1 || lanes < 1 || tg * lanes > MAX_THREADS || tiles < 1 || chunks < 1 ||
      chunks > 65535 || rows_per_chunk < 1 || static_cast<long long>(tiles) * tg < groups ||
      static_cast<long long>(chunks) * rows_per_chunk < rows) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

int sum_partials(const float* part, float* gb, int chunks, int cols, cudaStream_t stream) {
  bias_grad_sum<<<(cols + MAX_THREADS - 1) / MAX_THREADS, MAX_THREADS, 0, stream>>>(
      part, gb, chunks, cols);
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns the CUDA error (0 on success).
// Sizes are checked by the Python wrapper; the tiling again here. A null
// `gy` skips the gradient of y, a null `part` the bias gradient.

extern "C" int otgan_crelu_pad_forward(const void* y, const void* bias, void* x, int n, int h,
                                       int w, int c, int pt, int pl, int hp, int wp, int tg,
                                       int lanes, int tiles, int chunks, int rows_per_chunk,
                                       void* stream) {
  const int groups = c / VEC, rows = n * hp * wp;
  int err = check_tiling(tg, lanes, tiles, chunks, rows_per_chunk, groups, rows);
  if (err || c % VEC) return err ? err : cudaErrorInvalidValue;
  crelu_pad_forward<<<dim3(tiles, chunks), tg * lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const float*>(bias), static_cast<uint4*>(x), h,
      w, groups, pt, pl, hp, wp, rows, Tiling{tg, lanes, rows_per_chunk});
  return cudaGetLastError();
}

extern "C" int otgan_crelu_pad_backward(const void* gx, const void* x, void* gy, void* part,
                                        void* gb, int n, int h, int w, int c, int pt, int pl,
                                        int hp, int wp, int tg, int lanes, int tiles,
                                        int chunks, int rows_per_chunk, void* stream) {
  const int groups = c / VEC, rows = n * h * w;
  int err = check_tiling(tg, lanes, tiles, chunks, rows_per_chunk, groups, rows);
  if (err || c % VEC || (part == nullptr) != (gb == nullptr))
    return err ? err : cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  crelu_pad_backward<<<dim3(tiles, chunks), tg * lanes, 0, s>>>(
      static_cast<const uint4*>(gx), static_cast<const uint4*>(x), static_cast<uint4*>(gy),
      static_cast<float*>(part), h, w, groups, pt, pl, hp, wp, rows,
      Tiling{tg, lanes, rows_per_chunk});
  err = cudaGetLastError();
  if (err || part == nullptr) return err;
  return sum_partials(static_cast<const float*>(part), static_cast<float*>(gb), chunks, c, s);
}

extern "C" int otgan_glu_upsample_forward(const void* y, const void* bias, void* x, int n,
                                          int h, int w, int c, int factor, int dense, int tg,
                                          int lanes, int tiles, int chunks, int rows_per_chunk,
                                          void* stream) {
  const int groups = dense ? h * w * c / VEC : c / VEC, rows = dense ? n : n * h * w;
  int err = check_tiling(tg, lanes, tiles, chunks, rows_per_chunk, groups, rows);
  if (err || c % VEC || factor < 1 || factor > 2) return err ? err : cudaErrorInvalidValue;
  glu_upsample_forward<<<dim3(tiles, chunks), tg * lanes, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const float*>(bias), static_cast<uint4*>(x), h,
      w, c / VEC, factor, dense, rows, groups, Tiling{tg, lanes, rows_per_chunk});
  return cudaGetLastError();
}

extern "C" int otgan_glu_upsample_backward(const void* gx, const void* y, const void* bias,
                                           void* gy, void* part, void* gb, int n, int h, int w,
                                           int c, int factor, int dense, int tg, int lanes,
                                           int tiles, int chunks, int rows_per_chunk,
                                           void* stream) {
  const int groups = dense ? h * w * c / VEC : c / VEC, rows = dense ? n : n * h * w;
  int err = check_tiling(tg, lanes, tiles, chunks, rows_per_chunk, groups, rows);
  if (err || c % VEC || factor < 1 || factor > 2 || (part == nullptr) != (gb == nullptr))
    return err ? err : cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  glu_upsample_backward<<<dim3(tiles, chunks), tg * lanes, 0, s>>>(
      static_cast<const uint4*>(gx), static_cast<const uint4*>(y),
      static_cast<const float*>(bias), static_cast<uint4*>(gy), static_cast<float*>(part), h, w,
      c / VEC, factor, dense, rows, groups, Tiling{tg, lanes, rows_per_chunk});
  err = cudaGetLastError();
  if (err || part == nullptr) return err;
  return sum_partials(static_cast<const float*>(part), static_cast<float*>(gb), chunks,
                      2 * groups * VEC, s);
}

extern "C" const char* otgan_layer_boundary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
