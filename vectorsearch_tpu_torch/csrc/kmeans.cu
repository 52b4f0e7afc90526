// Lloyd's pass of the k-means build for Hopper (sm_90a): assign and
// accumulate.
//
// Replaces the TPU kernels `_assign_kernel` (vectorsearch_tpu/kernels/
// pallas_kmeans.py:58, launched at :168) and `_accumulate_kernel` (:100,
// launched at :193). Each computes what its TPU kernel computes; neither
// is a block-by-block copy.
//
// vs_kmeans_assign, over packed rows (codes int8 [N, D] with f32 scale,
// offset and inv_norm [N]) against bf16 normalized centroids cn [K, D]
// with csum[k] = sum of the f32 normalized centroid k:
//
//   cid[n] = argmax_k (offset[n] * csum[k] + scale[n] * <cn[k], codes[n]>)
//                     * inv_norm[n]
//
// What bounds it on this card: arithmetic. It does 2 * K flops per code
// byte (K = 1024 .. 16384), far above the ~295 flops per byte at which the
// bf16 tensor cores, not the memory, become the limit. So the products run
// on the tensor cores: one block of 8 warps per 64 rows walks all K in
// tiles of 128 centroids; per 64-dim slice the codes are widened int8 ->
// bf16 in shared memory (exact) beside the slice of cn, and WMMA
// (bf16 x bf16 -> f32) takes the products. The epilogue applies the
// affine sidecars with the same roundings as the plain version and keeps
// a running (max, argmax) per row, so nothing of size N x K reaches
// memory. Ties go to the lowest k, as torch.argmax does: the lowest index
// within a tile, and only a strictly greater value across tiles. A bf16 x
// int8 product is exact in f32, so a cid differs from the plain version's
// only where two sims differ in the order of their f32 sums (a near-tie).
// The TPU kernel keeps a padding mask kmask; the port pads no centroid
// set, so the kernel masks only its own K tail. It has no VMEM bound on K.
//
// vs_kmeans_accumulate, given the rows ordered by cluster (`order`, a
// stable sort of cid) and each cluster's segment [seg[k], seg[k+1]) of
// that order, with scale and offset gathered in the same order:
//
//   sums[k, :] = sum over the segment of (offset + scale * codes[row, :])
//   counts[k]  = seg[k+1] - seg[k]
//
// The TPU kernel multiplies a [1024, T] one-hot by the dequantized tile on
// the MXU and reads the codes K / 1024 times; here the sum is a segmented
// sum that reads each code row once, so it is bound by the code bytes.
// One block of 8 warps per (cluster, 128 dims): warp w takes members w,
// w + 8, ... of the segment, each lane 4 dims of a member's row (one
// 128-byte line per warp), summed in f32 with Kahan compensation; the 8
// warps' partials are added in warp order. No float atomics: two launches
// on the same input give bit-identical sums. The TPU kernel splits each
// value into hi + lo bf16 (about 16 mantissa bits); this kernel keeps the
// full f32 value, as the plain version does. Clusters with no members get
// zero sums and a zero count.
//
// Any N, K >= 1 and D >= 1: tails in N, K and D are zero in shared memory
// or masked, never read out of bounds. D % 16 == 0 takes 16-byte loads,
// any other D element loads.
//
// Left for later work: keeping a row tile's widened codes resident across
// the K tiles, a cp.async/TMA pipeline, and wgmma.
//
// C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

using namespace nvcuda;

namespace {

// ------------------------------------------------------------------ assign

constexpr int A_ROWS = 64;          // data rows per block
constexpr int A_CENT = 128;         // centroids per K tile
constexpr int A_DC = 64;            // contraction dims staged per step
constexpr int A_LDS = A_DC + 8;     // staged row stride, bf16 (144 B)
constexpr int A_LDA = A_CENT + 4;   // accumulator row stride, f32
constexpr int A_WARPS = 8;          // 2 x 4 warps of 32 rows x 32 centroids
constexpr int A_THREADS = A_WARPS * 32;
constexpr int A_TPR = A_THREADS / A_ROWS;  // epilogue threads per row (4)

template <bool VEC>
__global__ void __launch_bounds__(A_THREADS)
kmeans_assign_kernel(const int8_t* __restrict__ codes,
                     const float* __restrict__ scale,
                     const float* __restrict__ offset,
                     const float* __restrict__ inv_norm,
                     const __nv_bfloat16* __restrict__ cn,
                     const float* __restrict__ csum,
                     int32_t* __restrict__ cid,
                     int N, int D, int K) {
  constexpr int X_BYTES = A_ROWS * A_LDS * 2;
  constexpr int C_BYTES = A_CENT * A_LDS * 2;
  constexpr int ACC_BYTES = A_ROWS * A_LDA * 4;
  constexpr int SMEM =
      (X_BYTES + C_BYTES) > ACC_BYTES ? (X_BYTES + C_BYTES) : ACC_BYTES;
  // the staged operands and, after a tile's last slice, its f32 products
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float cs_s[A_CENT];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* acc_s = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 4;  // the warp's 32 of the 64 rows
  const int wc = warp % 4;  // the warp's 32 of the 128 centroids
  const int64_t row0 = (int64_t)blockIdx.x * A_ROWS;

  // epilogue: A_TPR adjacent threads per row; thread `part` takes the
  // columns part, part + A_TPR, ... (bank-conflict free)
  const int er = tid / A_TPR, part = tid % A_TPR;
  const int64_t grow = row0 + er;
  const bool live = grow < N;
  float r_sc = 0.f, r_of = 0.f, r_in = 0.f;
  if (live) {
    r_sc = scale[grow];
    r_of = offset[grow];
    r_in = inv_norm[grow];
  }
  float best = -INFINITY;
  int barg = 0;

  for (int k0 = 0; k0 < K; k0 += A_CENT) {
    if (tid < A_CENT) cs_s[tid] = (k0 + tid < K) ? csum[k0 + tid] : 0.f;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[r][f], 0.0f);

    for (int d0 = 0; d0 < D; d0 += A_DC) {
      if (VEC) {
        // 64 rows x 64 dims of codes, 16 int8 per load, widened to bf16
        for (int u = tid; u < A_ROWS * (A_DC / 16); u += A_THREADS) {
          const int r = u / (A_DC / 16), p = u % (A_DC / 16);
          const int d = d0 + p * 16;
          const int64_t gr = row0 + r;
          int4 v = make_int4(0, 0, 0, 0);
          if (gr < N && d < D)
            v = __ldg(reinterpret_cast<const int4*>(codes + gr * D + d));
          const int8_t* b = reinterpret_cast<const int8_t*>(&v);
          uint32_t w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            __nv_bfloat162 pr =
                __floats2bfloat162_rn((float)b[2 * j], (float)b[2 * j + 1]);
            memcpy(&w[j], &pr, 4);
          }
          int4* dst = reinterpret_cast<int4*>(x_s + r * A_LDS + p * 16);
          dst[0] = make_int4(w[0], w[1], w[2], w[3]);
          dst[1] = make_int4(w[4], w[5], w[6], w[7]);
        }
        // 128 centroids x 64 dims of cn, 8 bf16 per load
        for (int u = tid; u < A_CENT * (A_DC / 8); u += A_THREADS) {
          const int r = u / (A_DC / 8), p = u % (A_DC / 8);
          const int d = d0 + p * 8;
          const int k = k0 + r;
          int4 v = make_int4(0, 0, 0, 0);
          if (k < K && d < D)
            v = __ldg(reinterpret_cast<const int4*>(cn + (int64_t)k * D + d));
          *reinterpret_cast<int4*>(c_s + r * A_LDS + p * 8) = v;
        }
      } else {
        for (int u = tid; u < A_ROWS * A_DC; u += A_THREADS) {
          const int r = u / A_DC, j = u % A_DC;
          const int d = d0 + j;
          const int64_t gr = row0 + r;
          const float x = (gr < N && d < D) ? (float)codes[gr * D + d] : 0.f;
          x_s[r * A_LDS + j] = __float2bfloat16_rn(x);
        }
        for (int u = tid; u < A_CENT * A_DC; u += A_THREADS) {
          const int r = u / A_DC, j = u % A_DC;
          const int d = d0 + j;
          const int k = k0 + r;
          c_s[r * A_LDS + j] = (k < K && d < D) ? cn[(int64_t)k * D + d]
                                                : __float2bfloat16_rn(0.f);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < A_DC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::load_matrix_sync(fa[r], x_s + (wr * 32 + r * 16) * A_LDS + kk,
                                 A_LDS);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::load_matrix_sync(fb[f], c_s + (wc * 32 + f * 16) * A_LDS + kk,
                                 A_LDS);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int f = 0; f < 2; ++f)
            wmma::mma_sync(acc[r][f], fa[r], fb[f], acc[r][f]);
      }
      __syncthreads();
    }

    // the staging buffers are dead: the tile's products take their place
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(acc_s + (wr * 32 + r * 16) * A_LDA + wc * 32 +
                                    f * 16,
                                acc[r][f], A_LDA, wmma::mem_row_major);
    __syncthreads();

    // sims with the plain version's roundings:
    // ((offset * csum) + (scale * dot)) * inv_norm
    float tb = -INFINITY;
    int ta = 0x7fffffff;
    for (int i = 0; i < A_CENT / A_TPR; ++i) {
      const int j = part + A_TPR * i;
      if (k0 + j < K) {
        const float s = __fmul_rn(
            __fadd_rn(__fmul_rn(r_of, cs_s[j]),
                      __fmul_rn(r_sc, acc_s[er * A_LDA + j])),
            r_in);
        if (s > tb) {
          tb = s;
          ta = k0 + j;
        }
      }
    }
    // the A_TPR threads of a row are adjacent lanes: the larger wins, the
    // lower index on a tie
#pragma unroll
    for (int off = 1; off < A_TPR; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, tb, off);
      const int oa = __shfl_xor_sync(0xffffffffu, ta, off);
      if (ob > tb || (ob == tb && oa < ta)) {
        tb = ob;
        ta = oa;
      }
    }
    if (tb > best) {  // strict: an equal value in a later tile has a higher k
      best = tb;
      barg = ta;
    }
    __syncthreads();  // acc_s and cs_s are staged into again
  }
  if (live && part == 0) cid[grow] = barg;
}

// -------------------------------------------------------------- accumulate

constexpr int S_DIMS = 128;   // dims per block, 4 per lane
constexpr int S_WARPS = 8;
constexpr int S_THREADS = S_WARPS * 32;
constexpr int S_UNROLL = 4;   // member rows in flight per warp

template <bool VEC>
__global__ void __launch_bounds__(S_THREADS)
kmeans_accumulate_kernel(const int8_t* __restrict__ codes,
                         const float* __restrict__ scale_s,
                         const float* __restrict__ offset_s,
                         const int64_t* __restrict__ order,
                         const int64_t* __restrict__ seg,
                         float* __restrict__ sums,
                         float* __restrict__ counts,
                         int D) {
  __shared__ float part_s[S_WARPS][S_DIMS];
  const int k = blockIdx.x;
  const int d0 = blockIdx.y * S_DIMS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dl = d0 + lane * 4;  // this lane's first dim
  const int64_t m0 = seg[k], m1 = seg[k + 1];

  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float c[4] = {0.f, 0.f, 0.f, 0.f};  // Kahan compensation
  for (int64_t mb = m0 + warp; mb < m1; mb += S_WARPS * S_UNROLL) {
    // issue the loads of up to S_UNROLL members, then add them in order
    float sc[S_UNROLL], of[S_UNROLL];
    int8_t b[S_UNROLL][4];
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      const int64_t m = mb + (int64_t)u * S_WARPS;
      sc[u] = 0.f;
      of[u] = 0.f;
      uint32_t w = 0;
      if (m < m1) {
        const int64_t row = order[m];
        sc[u] = scale_s[m];
        of[u] = offset_s[m];
        const int8_t* src = codes + row * D + dl;
        if (VEC) {
          if (dl < D) w = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
          uint8_t e[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (dl + j < D) e[j] = (uint8_t)src[j];
          memcpy(&w, e, 4);
        }
      }
      memcpy(b[u], &w, 4);
    }
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      if (mb + (int64_t)u * S_WARPS < m1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = __fadd_rn(of[u], __fmul_rn(sc[u], (float)b[u][j]));
          const float y = __fsub_rn(v, c[j]);
          const float t = __fadd_rn(s[j], y);
          c[j] = __fsub_rn(__fsub_rn(t, s[j]), y);
          s[j] = t;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part_s[warp][lane * 4 + j] = __fsub_rn(s[j], c[j]);
  __syncthreads();
  if (threadIdx.x < S_DIMS) {
    const int d = d0 + threadIdx.x;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < S_WARPS; ++w) t = __fadd_rn(t, part_s[w][threadIdx.x]);
    if (d < D) sums[(int64_t)k * D + d] = t;
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[k] = (float)(m1 - m0);
}

}  // namespace

extern "C" int vs_kmeans_assign(const void* codes, const void* scale,
                                const void* offset, const void* inv_norm,
                                const void* cn, const void* csum, void* cid,
                                int N, int D, int K, void* stream) {
  if (N <= 0 || D <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + A_ROWS - 1) / A_ROWS);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(V)                                                          \
  kmeans_assign_kernel<V><<<grid, A_THREADS, 0, st>>>(                        \
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale),    \
      static_cast<const float*>(offset), static_cast<const float*>(inv_norm), \
      static_cast<const __nv_bfloat16*>(cn), static_cast<const float*>(csum), \
      static_cast<int32_t*>(cid), N, D, K)
  if (D % 16 == 0)
    VS_LAUNCH(true);
  else
    VS_LAUNCH(false);
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int vs_kmeans_accumulate(const void* codes, const void* scale_s,
                                    const void* offset_s, const void* order,
                                    const void* seg, void* sums, void* counts,
                                    int D, int K, void* stream) {
  if (D <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, (D + S_DIMS - 1) / S_DIMS);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(V)                                                          \
  kmeans_accumulate_kernel<V><<<grid, S_THREADS, 0, st>>>(                    \
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale_s),  \
      static_cast<const float*>(offset_s),                                    \
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(seg),   \
      static_cast<float*>(sums), static_cast<float*>(counts), D)
  if (D % 4 == 0)
    VS_LAUNCH(true);
  else
    VS_LAUNCH(false);
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}
