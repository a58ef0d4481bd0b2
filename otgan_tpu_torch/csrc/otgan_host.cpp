// otgan_host: the host-side batch assembler of otgan_tpu_torch, built with
// g++ at first use by otgan_tpu_torch/kernels/build.py (build_host) and
// bound with ctypes in otgan_tpu_torch/data/native.py. It is this package's
// own copy of the JAX package's runtime/otgan_host.cpp, with the same C ABI.
//
// The reference assembles every feed_dict with a per-image Python loop
// (train.py:163-170 maybe_flip) over a float64->float32 numpy dataset. Here
// the dataset stays uint8 in RAM and batch assembly is ONE fused pass:
// gather(indices) + optional horizontal flip + uint8 -> [-1, 1] conversion
// (or none: raw uint8, normalised on the card), multithreaded across batch
// rows. ctypes releases the interpreter lock for the call, so a prefetch
// thread assembling here overlaps the trainer's launches.
//
// Output dtype is float32, bfloat16 (uint16 bit patterns, round-to-nearest
// even of the float32 values, bit-identical to torch's and ml_dtypes'
// casts) or uint8. The uint8 -> value mapping goes through a 256-entry
// lookup table.
//
// Layout: dataset NHWC uint8 (n, h, w, c); output NHWC.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint16_t f32_to_bf16_rne(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even into the top 16 bits (values are finite)
  bits += 0x7FFFu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>(bits >> 16);
}

template <typename T>
struct Lut {
  T table[256];
};

template <typename T>
Lut<T> make_lut();

template <>
Lut<float> make_lut<float>() {
  Lut<float> lut;
  for (int k = 0; k < 256; ++k) {
    lut.table[k] = static_cast<float>(k) / 127.5f - 1.0f;  // matches numpy
  }
  return lut;
}

template <>
Lut<uint16_t> make_lut<uint16_t>() {
  Lut<uint16_t> lut;
  for (int k = 0; k < 256; ++k) {
    lut.table[k] = f32_to_bf16_rne(static_cast<float>(k) / 127.5f - 1.0f);
  }
  return lut;
}

// identity table: uint8 passthrough (gather + flip only, no conversion):
// the normalisation happens on the card inside the step, so the host
// ships 3072 B an image instead of 6144 (bf16) over the H2D link
template <>
Lut<uint8_t> make_lut<uint8_t>() {
  Lut<uint8_t> lut;
  for (int k = 0; k < 256; ++k) {
    lut.table[k] = static_cast<uint8_t>(k);
  }
  return lut;
}

template <typename T>
inline void convert_row_fwd(const uint8_t* src, T* dst, int64_t count,
                            const T* lut) {
  for (int64_t i = 0; i < count; ++i) {
    dst[i] = lut[src[i]];
  }
}

// flip along W for one image: rows of w pixels, c channels each
template <typename T>
inline void convert_image_flipped(const uint8_t* src, T* dst, int h, int w,
                                  int c, const T* lut) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<int64_t>(y) * w * c;
    T* drow = dst + static_cast<int64_t>(y) * w * c;
    for (int x = 0; x < w; ++x) {
      const uint8_t* spix = srow + static_cast<int64_t>(w - 1 - x) * c;
      T* dpix = drow + static_cast<int64_t>(x) * c;
      for (int ch = 0; ch < c; ++ch) {
        dpix[ch] = lut[spix[ch]];
      }
    }
  }
}

template <typename T>
void assemble_range(const uint8_t* data, const int64_t* indices,
                    const uint8_t* flip_mask, int64_t begin, int64_t end,
                    int h, int w, int c, T* out) {
  static const Lut<T> lut = make_lut<T>();
  const int64_t img = static_cast<int64_t>(h) * w * c;
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* src = data + indices[i] * img;
    T* dst = out + i * img;
    if (flip_mask != nullptr && flip_mask[i]) {
      convert_image_flipped(src, dst, h, w, c, lut.table);
    } else {
      convert_row_fwd(src, dst, img, lut.table);
    }
  }
}

template <typename T>
void assemble_batch(const uint8_t* data, const int64_t* indices,
                    const uint8_t* flip_mask, int64_t batch, int h, int w,
                    int c, T* out, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || batch < 2 * n_threads) {
    assemble_range(data, indices, flip_mask, 0, batch, h, w, c, out);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(batch, b + chunk);
    if (b >= e) break;
    workers.emplace_back(assemble_range<T>, data, indices, flip_mask, b, e,
                         h, w, c, out);
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Fused gather + flip + normalize. data: (n_data, h, w, c) uint8 NHWC;
// indices: (batch,) int64 into n_data; flip_mask: (batch,) uint8 or null;
// out: (batch, h, w, c) float32. n_threads <= 0 -> hardware concurrency.
void otgan_assemble_batch_u8(const uint8_t* data, const int64_t* indices,
                             const uint8_t* flip_mask, int64_t batch, int h,
                             int w, int c, float* out, int n_threads) {
  assemble_batch(data, indices, flip_mask, batch, h, w, c, out, n_threads);
}

// Same, emitting bfloat16 (as uint16 bit patterns, RNE — bit-identical
// to astype(bfloat16) of the float32 output).
void otgan_assemble_batch_u8_bf16(const uint8_t* data,
                                  const int64_t* indices,
                                  const uint8_t* flip_mask, int64_t batch,
                                  int h, int w, int c, uint16_t* out,
                                  int n_threads) {
  assemble_batch(data, indices, flip_mask, batch, h, w, c, out, n_threads);
}

// Same, emitting raw uint8 (gather + flip fused, NO normalization): the
// device-side training step fuses the [0,255] -> [-1,1] conversion into
// its first ops, halving host->device bytes vs bf16 emission.
void otgan_assemble_batch_u8_raw(const uint8_t* data, const int64_t* indices,
                                 const uint8_t* flip_mask, int64_t batch,
                                 int h, int w, int c, uint8_t* out,
                                 int n_threads) {
  assemble_batch(data, indices, flip_mask, batch, h, w, c, out, n_threads);
}

// NCHW uint8 -> NHWC uint8 (dataset ingestion transpose, one pass,
// replaces np.transpose(...,(0,2,3,1)) at reference train.py:158)
void otgan_nchw_to_nhwc_u8(const uint8_t* src, int64_t n, int c, int h,
                           int w, uint8_t* dst) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = src + i * c * hw;
    uint8_t* d = dst + i * hw * c;
    for (int64_t p = 0; p < hw; ++p) {
      for (int ch = 0; ch < c; ++ch) {
        d[p * c + ch] = s[ch * hw + p];
      }
    }
  }
}

}  // extern "C"
