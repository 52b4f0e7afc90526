// Grouped IVF bucket-scan scores for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_grouped_kernel` in
// vectorsearch_tpu/kernels/pallas_scan.py (body :162-201, launched from
// `_grouped_scan` at :539-544). It computes the same result, not a
// block-by-block copy of it. For group g probing cluster c = gcl[g]:
//
//   scores[g, i, r] = a[c, r] * <qg[g, i, :], codes[c, r, :]>
//                   + qsum[g, i] * bv[c, r] + bias[c, r]
//
// with a = scale * inv_norm, bv = offset * inv_norm, and bias 0 for a live
// slot or -inf for padding and tombstones. With `bmax` it also writes the
// maximum of every bs-column block of each score row (bs = 128, or 64 when
// cap is not a multiple of 128), compact as [G, QT, cap / bs].
//
// What bounds it on this card: the int8 code bytes. Each code byte read
// from device memory feeds 2 * QT flops (QT = 8..32 query rows of a group
// share one read), far below the ~295 flops per byte the H100's bf16
// tensor cores need before they, and not the memory, are the limit. So
// the design spends nothing to be clever about arithmetic and reads each
// code byte of a (group, 128-column slice) exactly once:
//   * one block of 4 warps per (group, 128 columns of the bucket); the
//     block reads its own cluster id gcl[g] (the TPU kernel prefetched it
//     as a scalar);
//   * the contraction runs in 64-dim chunks: the QT query rows (bf16) and
//     the slice's 128 code rows, widened int8 -> bf16 (exact), are staged
//     in 23 KB of static shared memory, and the tensor cores (WMMA,
//     bf16 x bf16 -> f32) take the products. A bf16 x int8 product is
//     exact in f32, so the result differs from the plain version only in
//     the order of the f32 sums;
//   * the epilogue applies the affine sidecars while the tile sits in
//     shared memory, writes the scores once, and reduces the block maxima
//     from the same registers with warp shuffles, so blockexact reads no
//     score twice.
// Groups are the fastest grid axis: groups of one cluster are adjacent,
// so their blocks read the same code slice back to back from L2.
// Left for later work: a TMA/cp.async pipeline that overlaps the next
// chunk's loads with this chunk's products, and wgmma.
//
// C interface (loaded with ctypes): vs_grouped_scores launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int COLS = 128;       // bucket columns per block
constexpr int DC = 64;          // contraction dims staged per step
constexpr int LDS = DC + 8;     // staged row stride, bf16 (144 B: spreads banks)
constexpr int LDA = COLS + 4;   // accumulator row stride, f32
constexpr int WARPS = 4;        // each warp owns 32 of the 128 columns
constexpr int THREADS = WARPS * 32;

// WMMA tile shape per group height: QT=8 uses the 8x32x16 shape so no
// half-empty 16-row tiles are computed.
template <int QT> struct Frag { static constexpr int M = 16, N = 16; };
template <> struct Frag<8> { static constexpr int M = 8, N = 32; };

template <int QT>
__global__ void __launch_bounds__(THREADS)
grouped_scores_kernel(const __nv_bfloat16* __restrict__ qg,
                      const float* __restrict__ qsum,
                      const int32_t* __restrict__ gcl,
                      const int8_t* __restrict__ codes,
                      const float* __restrict__ a,
                      const float* __restrict__ bv,
                      const float* __restrict__ bias,
                      float* __restrict__ out,
                      float* __restrict__ bmax,
                      int D, int K, int cap, int bs) {
  constexpr int FM = Frag<QT>::M, FN = Frag<QT>::N, FK = 16;
  constexpr int RF = QT / FM;                // tile rows per warp
  constexpr int CF = (COLS / WARPS) / FN;    // tile columns per warp
  constexpr int Q_BYTES = QT * LDS * 2;
  constexpr int C_BYTES = COLS * LDS * 2;
  constexpr int A_BYTES = QT * LDA * 4;
  constexpr int SMEM =
      (Q_BYTES + C_BYTES) > A_BYTES ? (Q_BYTES + C_BYTES) : A_BYTES;
  // the staged operands and, after the last chunk, the f32 accumulators
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);
  float* acc_s = reinterpret_cast<float*>(smem);

  const int g = blockIdx.x;
  const int col0 = blockIdx.y * COLS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = gcl[g];
  const int nblk = cap / bs;
  const size_t out_row0 = (size_t)g * QT;

  if (c < 0 || c >= K) {
    // no such cluster: the group scores nothing (uniform per block, so
    // no thread is left waiting at a barrier)
    for (int i = warp; i < QT; i += WARPS) {
      const int col = col0 + lane * 4;
      if (col < cap) {
        *reinterpret_cast<float4*>(out + (out_row0 + i) * cap + col) =
            make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (bmax != nullptr && lane % (bs / 4) == 0)
          bmax[(out_row0 + i) * nblk + col / bs] = -INFINITY;
      }
    }
    return;
  }

  wmma::fragment<wmma::accumulator, FM, FN, FK, float> acc[RF][CF];
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int f = 0; f < CF; ++f) wmma::fill_fragment(acc[r][f], 0.0f);

  const __nv_bfloat16* qbase = qg + out_row0 * D;
  const int8_t* cbase = codes + (size_t)c * cap * D;

  for (int k0 = 0; k0 < D; k0 += DC) {
    // QT query rows x DC dims, 8 bf16 (16 B) per load; zero past D
    for (int u = tid; u < QT * (DC / 8); u += THREADS) {
      const int r = u / (DC / 8), part = u % (DC / 8);
      const int k = k0 + part * 8;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < D) v = *reinterpret_cast<const int4*>(qbase + (size_t)r * D + k);
      *reinterpret_cast<int4*>(q_s + r * LDS + part * 8) = v;
    }
    // 128 code rows x DC dims, 16 int8 (16 B) per load, widened to bf16;
    // zero past D and past the bucket's last column
    for (int u = tid; u < COLS * (DC / 16); u += THREADS) {
      const int r = u / (DC / 16), part = u % (DC / 16);
      const int k = k0 + part * 16;
      const int col = col0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < D && col < cap)
        v = __ldg(reinterpret_cast<const int4*>(cbase + (size_t)col * D + k));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 p =
            __floats2bfloat162_rn((float)b[2 * j], (float)b[2 * j + 1]);
        w[j] = *reinterpret_cast<uint32_t*>(&p);
      }
      int4* dst = reinterpret_cast<int4*>(c_s + r * LDS + part * 16);
      dst[0] = make_int4(w[0], w[1], w[2], w[3]);
      dst[1] = make_int4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DC; kk += FK) {
      wmma::fragment<wmma::matrix_a, FM, FN, FK, __nv_bfloat16,
                     wmma::row_major> fa[RF];
      wmma::fragment<wmma::matrix_b, FM, FN, FK, __nv_bfloat16,
                     wmma::col_major> fb[CF];
#pragma unroll
      for (int r = 0; r < RF; ++r)
        wmma::load_matrix_sync(fa[r], q_s + r * FM * LDS + kk, LDS);
#pragma unroll
      for (int f = 0; f < CF; ++f)
        wmma::load_matrix_sync(fb[f], c_s + (warp * 32 + f * FN) * LDS + kk,
                               LDS);
#pragma unroll
      for (int r = 0; r < RF; ++r)
#pragma unroll
        for (int f = 0; f < CF; ++f)
          wmma::mma_sync(acc[r][f], fa[r], fb[f], acc[r][f]);
    }
    __syncthreads();
  }

  // the staging buffers are dead: the accumulators take their place
#pragma unroll
  for (int r = 0; r < RF; ++r)
#pragma unroll
    for (int f = 0; f < CF; ++f)
      wmma::store_matrix_sync(acc_s + r * FM * LDA + warp * 32 + f * FN,
                              acc[r][f], LDA, wmma::mem_row_major);
  __syncthreads();

  // epilogue: one warp per score row, 4 columns per lane (cap % 64 == 0,
  // so a lane's 4 columns are all inside the bucket or all past it)
  const size_t side0 = (size_t)c * cap;
  for (int i = warp; i < QT; i += WARPS) {
    const int j = lane * 4;
    const int col = col0 + j;
    float m = -INFINITY;
    if (col < cap) {
      const float qs = qsum[out_row0 + i];
      const float4 d4 = *reinterpret_cast<const float4*>(acc_s + i * LDA + j);
      const float4 a4 = *reinterpret_cast<const float4*>(a + side0 + col);
      const float4 b4 = *reinterpret_cast<const float4*>(bv + side0 + col);
      const float4 z4 = *reinterpret_cast<const float4*>(bias + side0 + col);
      float4 s;
      s.x = d4.x * a4.x + qs * b4.x + z4.x;
      s.y = d4.y * a4.y + qs * b4.y + z4.y;
      s.z = d4.z * a4.z + qs * b4.z + z4.z;
      s.w = d4.w * a4.w + qs * b4.w + z4.w;
      *reinterpret_cast<float4*>(out + (out_row0 + i) * cap + col) = s;
      m = fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w));
    }
    if (bmax != nullptr) {
      // 16 lanes span 64 columns; bs=128 also folds the two half-warps
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (bs == 128) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (col < cap && lane % (bs / 4) == 0)
        bmax[(out_row0 + i) * nblk + col / bs] = m;
    }
  }
}

}  // namespace

// the library's ABI version: bumped whenever an entry point of any source
// under csrc/ is added or changes its arguments
extern "C" int vs_abi_version() { return 3; }

extern "C" int vs_grouped_scores(const void* qg, const void* qsum,
                                 const void* gcl, const void* codes,
                                 const void* a, const void* bv,
                                 const void* bias, void* out, void* bmax,
                                 int G, int QT, int D, int K, int cap, int bs,
                                 void* stream) {
  const dim3 grid(G, (cap + COLS - 1) / COLS);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(QTV)                                                       \
  grouped_scores_kernel<QTV><<<grid, THREADS, 0, st>>>(                      \
      static_cast<const __nv_bfloat16*>(qg), static_cast<const float*>(qsum), \
      static_cast<const int32_t*>(gcl), static_cast<const int8_t*>(codes),   \
      static_cast<const float*>(a), static_cast<const float*>(bv),           \
      static_cast<const float*>(bias), static_cast<float*>(out),             \
      static_cast<float*>(bmax), D, K, cap, bs)
  switch (QT) {
    case 8: VS_LAUNCH(8); break;
    case 16: VS_LAUNCH(16); break;
    case 32: VS_LAUNCH(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}
