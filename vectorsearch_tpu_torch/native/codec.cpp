// Native host-side wire codec.
//
// The reference's native acceleration lives in its dependencies (Gonum's
// AVX BLAS kernels, go-sqlite3's C core — SURVEY.md preamble). In this
// rebuild the device hot path is XLA/Pallas; the host hot path — the wire
// codec used at the provider boundary, engine boot (packing millions of
// SQL rows into the HBM layout) and snapshot export — is this C++ library,
// OpenMP-parallel across rows, loaded via ctypes with a numpy fallback
// (vectorsearch_tpu/native/__init__.py).
//
// Wire format parity (reference: compute/quantization.go:71-80):
//   [4B LE f32 min][4B LE f32 max][D x uint8],
//   range folded from 0, truncating quantize, q = (v-min)/(max-min)*255.
//
// Build: make -C vectorsearch_tpu/native   (g++ -O3 -march=native -fopenmp)

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline void write_f32_le(uint8_t* dst, float v) {
  std::memcpy(dst, &v, 4);  // x86-64 is little-endian
}

inline float read_f32_le(const uint8_t* src) {
  float v;
  std::memcpy(&v, src, 4);
  return v;
}

}  // namespace

extern "C" {

// float32[n, d] -> uint8[n, 8 + d]
void vs_quantize_f32(const float* v, int64_t n, int64_t d, uint8_t* out) {
  const int64_t stride = 8 + d;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float* row = v + i * d;
    float mn = 0.0f, mx = 0.0f;  // range always includes 0
    for (int64_t j = 0; j < d; ++j) {
      const float x = row[j];
      if (x < mn) mn = x;
      if (x > mx) mx = x;
    }
    uint8_t* o = out + i * stride;
    write_f32_le(o, mn);
    write_f32_le(o + 4, mx);
    const float span = mx - mn;
    if (span == 0.0f) {
      std::memset(o + 8, 0, d);
      continue;
    }
    for (int64_t j = 0; j < d; ++j) {
      float x = row[j];
      if (x < mn) x = mn;
      if (x > mx) x = mx;
      // divide (not reciprocal-multiply): byte-exact with the Go/numpy path
      const float scaled = ((x - mn) / span) * 255.0f;
      o[8 + j] = (uint8_t)scaled;  // trunc toward zero (Go conversion)
    }
  }
}

// uint8[n, 8 + d] -> float32[n, d]
void vs_dequantize_f32(const uint8_t* wire, int64_t n, int64_t d, float* out) {
  const int64_t stride = 8 + d;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = wire + i * stride;
    const float mn = read_f32_le(row);
    const float mx = read_f32_le(row + 4);
    const float span = mx - mn;
    float* o = out + i * d;
    for (int64_t j = 0; j < d; ++j) {
      o[j] = mn + ((float)row[8 + j] / 255.0f) * span;
    }
  }
}

// uint8[n, 8 + d] wire -> device layout:
//   codes int8[n, d] (q - 128), scale f32[n], offset f32[n], inv_norm f32[n]
// (see vectorsearch_tpu/quant/layout.py for the affine identity)
void vs_pack_wire(const uint8_t* wire, int64_t n, int64_t d, int8_t* codes,
                  float* scale, float* offset, float* inv_norm) {
  const int64_t stride = 8 + d;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = wire + i * stride;
    const float mn = read_f32_le(row);
    const float mx = read_f32_le(row + 4);
    const float s = (mx - mn) / 255.0f;
    const float o = mn + 128.0f * s;
    scale[i] = s;
    offset[i] = o;
    int8_t* c = codes + i * d;
    double norm_sq = 0.0;
    for (int64_t j = 0; j < d; ++j) {
      const int cij = (int)row[8 + j] - 128;
      c[j] = (int8_t)cij;
      const float val = o + s * (float)cij;
      norm_sq += (double)val * (double)val;
    }
    const float norm = (float)std::sqrt((float)norm_sq);
    inv_norm[i] = (norm == 0.0f) ? 0.0f : 1.0f / norm;
  }
}

int vs_abi_version() { return 1; }

}  // extern "C"
