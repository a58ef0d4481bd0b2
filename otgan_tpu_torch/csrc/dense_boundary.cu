// The DenseNet's list-conv boundaries: one bf16 slab a dense block, and each
// conv's input gathered from it, forward and backward.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the chain into the
// conv. In PyTorch each conv j of a dense block rebuilds its input from the
// list of every earlier output: a float32-to-bf16 cast and a negation per
// element, one concatenation of 2k tensors and a relu; autograd runs the same
// chain backwards (relu backward, the negations' backward, a bf16 add and a
// cast back per element, and a float32 add into each element's gradient) and
// keeps every conv's relu output, O(L^2) bytes a block.
//
// slab_write: element e of a block is rounded once into the block's slab
// (N, H, W, C) bf16, at its channels [o_e, o_e + f_e): a conv's or the dense
// layer's raw bf16 output y plus its float32 bias, s = bf16(float(y) + b)
// (round to nearest even: today's (y.float() + b).to(bfloat16)), or a float32
// tensor (a noise) rounded alone. The dense layer's bias runs over its whole
// row: bias_rows = H * W biases of f_e values, one set a pixel.
//
// gather: the input conv j passes to cuDNN, from the slab's first K channels
// (the elements 0..k-1 it takes): (N, Ho, Wo, 2K) bf16, per element
// [relu(s_e), relu(-s_e)] at channels [2 o_e, 2 o_e + 2 f_e) ("interleaved",
// the list conv's order), or [relu(s), relu(-s)] over the whole prefix
// ("halves": the up convs, which concatenate and upsample first); factor 2
// repeats each pixel at its 2x2 nearest-neighbour positions; (pt, pl) and
// Ho, Wo write the zero border of the stride-2 convs' asymmetric SAME pads.
// relu is PyTorch's on the card (a NaN passes; a zero of either sign gives +0).
//
// scatter: reads conv j's input gradient g (cuDNN's dgrad output) once, and
// the slab for each value's sign; per value
//   d = bf16((s <= 0 ? 0 : g_pos) - (s >= 0 ? 0 : g_neg)),
// relu's threshold_backward on each half and the negation's bf16 sum (one
// of the two terms is 0, so the add is exact); at factor 2 the four d of a
// pixel summed as PyTorch's reduction of the expand does on the card,
// ((0 + d00) + (0 + d01)) + (0 + d10)) + (0 + d11) in float32, and rounded.
// float(d) is stored into element e's float32 gradient (its first consumer
// in the backward) or added to it: one float32 add a consumer, in the order
// autograd runs the consumers. Elements with a null accumulator (a noise)
// are skipped. No atomics: each value is one thread's.
//
// Layout of a launch: one thread a (pixel, group of V channels) of the
// output (gather) or of the slab (scatter, slab_write), V the largest of 8,
// 4, 2 and 1 that divides every element's width (16 bytes of bf16 a load at
// V = 8, the DenseNet's widths at F = 16). A gather or scatter launch takes
// a run of at most MAX_ELEMS consecutive elements of the prefix (the
// wrapper launches once a run: once a conv at the DenseNet's sizes); runs
// touch disjoint channels, so their order does not matter. Each block
// copies its run's group offsets into shared memory, and a thread finds its
// element by binary search.
//
// Bound: bytes. gather reads 2 and writes 4 bytes a slab value (x4 writes at
// factor 2); scatter reads 4 of gradient and 2 of slab, and reads and writes
// 4 of accumulator (writes only, on a store); slab_write reads 2 (+4 of a
// float32 input) and writes 2. A few float32 operations a value:
// memory-bound on an H100 (3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // threads a block
constexpr int MAX_ELEMS = 64;      // elements a launch (the scatter's store mask is 64 bits)

}  // namespace

// what the wrapper passes (nn/dense_boundary.py's ctypes structures); sizes
// in groups of V channels
struct DenseGeometry {
  int n, h, w;         // the slab's images and pixels
  int slab_groups;     // the slab's channels / V
  int k_groups;        // the prefix the conv takes / V
  int factor;          // 1, or 2: nearest-neighbour upsample
  int pt, pl;          // the zero border above and to the left
  int ho, wo;          // the conv input's pixels: factor * (h, w) + the border
  int halves;          // 1: [relu(s), relu(-s)] over the prefix; 0: per element
};

struct DenseElements {
  int n;                      // elements in the launch's run
  int off[MAX_ELEMS + 1];     // each one's first group in the slab; off[n]: the run's end
};

struct DenseAccs {
  float* ptr[MAX_ELEMS];      // the run's float32 gradients (N, H, W, f_e), or null
  unsigned long long store;   // bit e: the first contribution (a store, not an add)
};

namespace {

// V bf16 values as one load: 16, 8, 4 or 2 bytes
template <int V> struct Raw;
template <> struct Raw<8> { using T = uint4; };
template <> struct Raw<4> { using T = uint2; };
template <> struct Raw<2> { using T = unsigned; };
template <> struct Raw<1> { using T = unsigned short; };

template <int V>
__device__ __forceinline__ void load_bf16(const unsigned short* p, float (&f)[V]) {
  const typename Raw<V>::T u = *reinterpret_cast<const typename Raw<V>::T*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = __uint_as_float(static_cast<unsigned>(h[k]) << 16);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// round each to bf16 (nearest even) and store
template <int V>
__device__ __forceinline__ void store_bf16(unsigned short* p, const float (&f)[V]) {
  typename Raw<V>::T u;
  unsigned short* h = reinterpret_cast<unsigned short*>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = bf16_bits(f[k]);
  *reinterpret_cast<typename Raw<V>::T*>(p) = u;
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      f[i] = q.x; f[i + 1] = q.y; f[i + 2] = q.z; f[i + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    f[0] = q.x; f[1] = q.y;
  } else {
    f[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// PyTorch's relu on the card (clamp_min at 0, through fmaxf): a NaN passes,
// and a zero of either sign gives +0
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// the element that holds group g: the last e with off[e] <= g
__device__ __forceinline__ int element_of(const int* off, int n, int g) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void load_offsets(const DenseElements& el, int* off) {
  for (int i = threadIdx.x; i <= el.n; i += blockDim.x) off[i] = el.off[i];
  __syncthreads();
}

// the output groups of slab group g (element e): relu(s) and relu(-s)
__device__ __forceinline__ void out_groups(const DenseGeometry& geo, const int* off, int e,
                                           int g, int& pos, int& neg) {
  if (geo.halves) {
    pos = g;
    neg = geo.k_groups + g;
  } else {
    pos = g + off[e];
    neg = g + off[e + 1];
  }
}

template <int V, bool F32>
__global__ void __launch_bounds__(THREADS)
    slab_write(const void* __restrict__ y, const float* __restrict__ bias,
               unsigned short* __restrict__ slab, int rows, int groups, int slab_groups,
               int off_groups, int bias_rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * groups) return;
  const int r = t / groups, g = t - r * groups;
  float v[V];
  if constexpr (F32) {
    load_f32<V>(static_cast<const float*>(y) + static_cast<size_t>(t) * V, v);
  } else {
    load_bf16<V>(static_cast<const unsigned short*>(y) + static_cast<size_t>(t) * V, v);
  }
  if (bias) {
    float b[V];
    load_f32<V>(bias + (static_cast<size_t>(r % bias_rows) * groups + g) * V, b);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] += b[k];
  }
  store_bf16<V>(slab + (static_cast<size_t>(r) * slab_groups + off_groups + g) * V, v);
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    gather(const unsigned short* __restrict__ slab, unsigned short* __restrict__ out,
           DenseGeometry geo, DenseElements el) {
  __shared__ int off[MAX_ELEMS + 1];
  load_offsets(el, off);
  const int G = geo.k_groups, run = off[el.n] - off[0];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= geo.n * geo.ho * geo.wo * run) return;
  const int p = t / run, g = off[0] + t - p * run;
  const int img = p / (geo.ho * geo.wo), q = p - img * geo.ho * geo.wo;
  const int sy = q / geo.wo - geo.pt, sx = q % geo.wo - geo.pl;
  float pos[V], neg[V];
  if (sy >= 0 && sy < geo.factor * geo.h && sx >= 0 && sx < geo.factor * geo.w) {
    const int iy = sy / geo.factor, ix = sx / geo.factor;
    float s[V];
    load_bf16<V>(
        slab + ((static_cast<size_t>(img * geo.h + iy) * geo.w + ix) * geo.slab_groups + g) * V,
        s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pos[k] = relu(s[k]);
      neg[k] = relu(-s[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) pos[k] = neg[k] = 0.f;
  }
  int gp, gn;
  out_groups(geo, off, geo.halves ? 0 : element_of(off, el.n, g), g, gp, gn);
  unsigned short* row = out + static_cast<size_t>(p) * 2 * G * V;
  store_bf16<V>(row + gp * V, pos);
  store_bf16<V>(row + gn * V, neg);
}

// d = bf16(P - N) at one conv-input pixel, row q (bf16 values from the start)
template <int V>
__device__ __forceinline__ void signed_grad(const unsigned short* gin, size_t q, int gp, int gn,
                                            const float (&s)[V], float (&d)[V]) {
  float a[V], b[V];
  load_bf16<V>(gin + q + gp * V, a);
  load_bf16<V>(gin + q + gn * V, b);
#pragma unroll
  for (int k = 0; k < V; ++k)
    d[k] = round_bf16((s[k] <= 0.f ? 0.f : a[k]) - (s[k] >= 0.f ? 0.f : b[k]));
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    scatter(const unsigned short* __restrict__ gin, const unsigned short* __restrict__ slab,
            DenseGeometry geo, DenseElements el, DenseAccs accs) {
  __shared__ int off[MAX_ELEMS + 1];
  load_offsets(el, off);
  const int G = geo.k_groups, run = off[el.n] - off[0];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= geo.n * geo.h * geo.w * run) return;
  const int p = t / run, g = off[0] + t - p * run;
  const int e = element_of(off, el.n, g);
  float* acc = accs.ptr[e];
  if (acc == nullptr) return;
  const int img = p / (geo.h * geo.w), q = p - img * geo.h * geo.w;
  const int y = q / geo.w, x = q - y * geo.w;
  float s[V], d[V];
  load_bf16<V>(slab + (static_cast<size_t>(p) * geo.slab_groups + g) * V, s);
  int gp, gn;
  out_groups(geo, off, e, g, gp, gn);
  const size_t row = 2 * static_cast<size_t>(G) * V;
  const size_t q0 =
      (static_cast<size_t>(img * geo.ho + geo.factor * y + geo.pt) * geo.wo + geo.factor * x +
       geo.pl) * row;
  if (geo.factor == 1) {
    signed_grad<V>(gin, q0, gp, gn, s, d);
  } else {
    float d00[V], d01[V], d10[V], d11[V];
    const size_t down = static_cast<size_t>(geo.wo) * row;
    signed_grad<V>(gin, q0, gp, gn, s, d00);
    signed_grad<V>(gin, q0 + row, gp, gn, s, d01);
    signed_grad<V>(gin, q0 + down, gp, gn, s, d10);
    signed_grad<V>(gin, q0 + down + row, gp, gn, s, d11);
#pragma unroll
    for (int k = 0; k < V; ++k)
      d[k] = round_bf16((((0.f + d00[k]) + (0.f + d01[k])) + (0.f + d10[k])) + (0.f + d11[k]));
  }
  const int width = (off[e + 1] - off[e]) * V;
  float* a = acc + static_cast<size_t>(p) * width + (g - off[e]) * V;
  if (!((accs.store >> e) & 1ull)) {
    float old[V];
    load_f32<V>(a, old);
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] = old[k] + d[k];
  }
  store_f32<V>(a, d);
}

int check(const DenseGeometry& geo, const DenseElements& el) {
  if (geo.n < 1 || geo.h < 1 || geo.w < 1 || geo.k_groups < 1 ||
      geo.k_groups > geo.slab_groups || (geo.factor != 1 && geo.factor != 2) || geo.pt < 0 ||
      geo.pl < 0 || geo.ho < geo.factor * geo.h + geo.pt ||
      geo.wo < geo.factor * geo.w + geo.pl || el.n < 1 || el.n > MAX_ELEMS || el.off[0] < 0 ||
      el.off[el.n] > geo.k_groups) {
    return cudaErrorInvalidValue;
  }
  for (int e = 0; e < el.n; ++e)
    if (el.off[e + 1] <= el.off[e]) return cudaErrorInvalidValue;
  if (static_cast<long long>(geo.n) * geo.ho * geo.wo * 2 * geo.k_groups >= (1ll << 31))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

unsigned blocks(long long items) { return static_cast<unsigned>((items + THREADS - 1) / THREADS); }

bool vec_ok(int v) { return v == 1 || v == 2 || v == 4 || v == 8; }

template <int V>
int write_v(const void* y, int y_f32, const float* bias, int bias_rows, unsigned short* slab,
            int rows, int groups, int slab_groups, int off_groups, cudaStream_t s) {
  const long long items = static_cast<long long>(rows) * groups;
  if (y_f32)
    slab_write<V, true><<<blocks(items), THREADS, 0, s>>>(y, bias, slab, rows, groups,
                                                          slab_groups, off_groups, bias_rows);
  else
    slab_write<V, false><<<blocks(items), THREADS, 0, s>>>(y, bias, slab, rows, groups,
                                                           slab_groups, off_groups, bias_rows);
  return cudaGetLastError();
}

template <int V>
int gather_v(const void* slab, void* out, const DenseGeometry& geo, const DenseElements& el,
             cudaStream_t s) {
  const long long items =
      static_cast<long long>(geo.n) * geo.ho * geo.wo * (el.off[el.n] - el.off[0]);
  gather<V><<<blocks(items), THREADS, 0, s>>>(static_cast<const unsigned short*>(slab),
                                              static_cast<unsigned short*>(out), geo, el);
  return cudaGetLastError();
}

template <int V>
int scatter_v(const void* gin, const void* slab, const DenseGeometry& geo,
              const DenseElements& el, const DenseAccs& accs, cudaStream_t s) {
  const long long items =
      static_cast<long long>(geo.n) * geo.h * geo.w * (el.off[el.n] - el.off[0]);
  scatter<V><<<blocks(items), THREADS, 0, s>>>(static_cast<const unsigned short*>(gin),
                                               static_cast<const unsigned short*>(slab), geo, el,
                                               accs);
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns the CUDA error (0 on success).
// `vec` is V; sizes are checked by the Python wrapper, the geometry again
// here.

extern "C" int otgan_dense_write(const void* y, int y_f32, const void* bias, int bias_rows,
                                 void* slab, int rows, int width, int slab_channels, int offset,
                                 int vec, void* stream) {
  if (!vec_ok(vec) || rows < 1 || width < vec || width % vec || slab_channels % vec ||
      offset % vec || offset + width > slab_channels ||
      (bias && (bias_rows < 1 || rows % bias_rows)) ||
      static_cast<long long>(rows) * slab_channels >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int groups = width / vec, sg = slab_channels / vec, og = offset / vec;
  const auto* b = static_cast<const float*>(bias);
  auto* out = static_cast<unsigned short*>(slab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: return write_v<8>(y, y_f32, b, bias_rows, out, rows, groups, sg, og, s);
    case 4: return write_v<4>(y, y_f32, b, bias_rows, out, rows, groups, sg, og, s);
    case 2: return write_v<2>(y, y_f32, b, bias_rows, out, rows, groups, sg, og, s);
    default: return write_v<1>(y, y_f32, b, bias_rows, out, rows, groups, sg, og, s);
  }
}

extern "C" int otgan_dense_gather(const void* slab, void* out, const DenseGeometry* geo,
                                  const DenseElements* el, int vec, void* stream) {
  int err = check(*geo, *el);
  if (err || !vec_ok(vec)) return err ? err : cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: return gather_v<8>(slab, out, *geo, *el, s);
    case 4: return gather_v<4>(slab, out, *geo, *el, s);
    case 2: return gather_v<2>(slab, out, *geo, *el, s);
    default: return gather_v<1>(slab, out, *geo, *el, s);
  }
}

extern "C" int otgan_dense_scatter(const void* gin, const void* slab, const DenseGeometry* geo,
                                   const DenseElements* el, const DenseAccs* accs, int vec,
                                   void* stream) {
  int err = check(*geo, *el);
  if (err || !vec_ok(vec)) return err ? err : cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: return scatter_v<8>(gin, slab, *geo, *el, *accs, s);
    case 4: return scatter_v<4>(gin, slab, *geo, *el, *accs, s);
    case 2: return scatter_v<2>(gin, slab, *geo, *el, *accs, s);
    default: return scatter_v<1>(gin, slab, *geo, *el, *accs, s);
  }
}

extern "C" const char* otgan_dense_boundary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
