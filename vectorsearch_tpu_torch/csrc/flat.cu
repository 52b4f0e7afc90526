// Band-max flat scan for Hopper (sm_90a): the s8 and bf16 band kernels.
//
// Replace the TPU kernels `_flat_kernel_s8` (vectorsearch_tpu/kernels/
// pallas_flat.py:85, launched at :194) and `_flat_kernel` (:54, launched
// at :201). Each computes what its TPU kernel computes; neither is a
// block-by-block copy of the Pallas grid. Over a corpus of N packed rows
// cut into tiles of 1024, with a = scale * inv_norm, bv = offset *
// inv_norm and bias 0 for a live row or -inf for a dead one:
//
//   vs_flat_bands_s8    s[b, r] = (sq[b] * a[r]) * <qc[b], codes[r]> + qsum[b] * bv[r] + bias[r]
//                       (qc int8 query codes with per-query scale sq, s8 x s8 -> s32)
//   vs_flat_bands_bf16  s[b, r] = a[r] * <q[b], codes[r]> + qsum[b] * bv[r] + bias[r]
//                       (q bf16, codes widened to bf16, f32 sums)
//
//   bands[b, t * 128 + lane] = max over j < 8 of s[b, t * 1024 + j * 128 + lane]
//
// Band `lane` of tile t is the 8 rows congruent to lane mod 128. The bands
// are written query-major, f32 [B, tiles * 128], the layout the band top-k
// reads (the TPU kernel wrote [tiles, B, 128] and moved the axis after).
//
// What bounds it on this card: arithmetic. Each code byte feeds 2 * B
// operations (B = 512 at the bench's batch), above the ~295 per byte at
// which the tensor cores, not the memory, become the limit. So the
// products run on the tensor cores (WMMA: s8 x s8 -> s32, exact as the
// MXU's s32; bf16 x bf16 -> f32), and the [B, 1024] scores of a tile never
// reach memory: one block of 8 warps per (tile, 64 queries) walks the
// tile's 8 groups of 128 rows. Group j holds rows j * 128 .. j * 128 + 127,
// so the band maximum is an elementwise maximum over the groups: each
// thread keeps 32 running maxima in registers for fixed (query, lane)
// pairs, and no reduction across threads is needed. The query blocks of a
// tile are adjacent in the grid, so their blocks read the tile's codes
// from L2 after the first.
//
// Per group the contraction runs in steps of 128 bytes of each row (128
// int8 or 64 bf16 elements): the 64 query rows and the 128 code rows are
// staged in shared memory as planes of 16 elements per row (the WMMA k),
// so every fragment pointer is 32-byte aligned and the rows a fragment
// load reads fall in distinct banks. The int32 or f32 products
// go through shared memory, and the epilogue applies the sidecars with
// __fmul_rn / __fadd_rn in the plain version's order: the s8 band maxima
// are bit-equal to it, and the bf16 ones differ only in the order of the
// f32 sums.
//
// Any N, B and D: rows past N score -inf without being read (the corpus is
// not padded; a group wholly past N is skipped), query rows past B are
// zero and never written, and D % 16 == 0 takes 16-byte loads, any other D
// element loads with zero tails.
//
// Left for later work: keeping a query block resident across the tile's
// groups, a cp.async/TMA pipeline, wgmma, and mma.sync with the epilogue
// in registers.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 1024;                    // corpus rows per tile
constexpr int LANES = 128;                    // bands per tile = rows per group
constexpr int GROUPS = TILE / LANES;          // 8
constexpr int QB = 64;                        // queries per block
constexpr int WARPS = 8;                      // 2 x 4 warps of 32 queries x 32 rows
constexpr int THREADS = WARPS * 32;
constexpr int LDA = LANES + 4;                // product row stride, 32-bit
constexpr int QSTEP = THREADS / LANES;        // epilogue: queries qh, qh + 2, ...
constexpr int PER_THREAD = QB / QSTEP;        // running maxima per thread (32)
constexpr int KE = 16;                        // elements per plane row (WMMA k)

template <bool S8> struct Op;
// KS: the stride of a plane row, in elements. Eight 16-byte s8 rows are
// 128 contiguous bytes; 32-byte bf16 rows are padded to 48 bytes, so the
// eight rows a fragment load reads at once fall in distinct banks.
template <> struct Op<true> {   // int8 x int8 -> int32
  using In = signed char;
  using Acc = int;
  static constexpr int KS = KE;
};
template <> struct Op<false> {  // bf16 x bf16 -> f32
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr int KS = KE + 8;
};

// 16 int8 codes as a staged plane row: as they are, or widened to bf16
// (exact)
template <bool S8>
__device__ __forceinline__ void put_codes(typename Op<S8>::In* dst, int4 v) {
  if constexpr (S8) {
    *reinterpret_cast<int4*>(dst) = v;
  } else {
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 pr =
          __floats2bfloat162_rn((float)b[2 * j], (float)b[2 * j + 1]);
      memcpy(&w[j], &pr, 4);
    }
    int4* d4 = reinterpret_cast<int4*>(dst);
    d4[0] = make_int4(w[0], w[1], w[2], w[3]);
    d4[1] = make_int4(w[4], w[5], w[6], w[7]);
  }
}

template <bool S8>
__device__ __forceinline__ typename Op<S8>::In code_elem(int8_t x) {
  if constexpr (S8)
    return x;
  else
    return __float2bfloat16_rn((float)x);
}

template <bool S8, bool VEC>
__global__ void __launch_bounds__(THREADS)
flat_bands_kernel(const typename Op<S8>::In* __restrict__ q,  // [B, D]
                  const float* __restrict__ sq,                // [B], s8 only
                  const float* __restrict__ qsum,              // [B]
                  const int8_t* __restrict__ codes,            // [N, D]
                  const float* __restrict__ a,                 // [N]
                  const float* __restrict__ bv,                // [N]
                  const float* __restrict__ bias,              // [N]
                  float* __restrict__ out,                     // [B, tiles * 128]
                  int B, int N, int D, int qblocks, int tiles) {
  using In = typename Op<S8>::In;
  using Acc = typename Op<S8>::Acc;
  constexpr int KS = Op<S8>::KS;
  constexpr int DC = 128 / (int)sizeof(In);  // contraction elements per step
  constexpr int P = DC / KE;                 // planes per step
  constexpr int QPL = QB * KS;               // elements per query plane
  constexpr int CPL = LANES * KS;            // elements per code plane
  constexpr int STAGE = P * (QPL + CPL) * (int)sizeof(In);
  constexpr int PROD = QB * LDA * 4;
  constexpr int SMEM = STAGE > PROD ? STAGE : PROD;
  // the staged planes and, after a group's last step, its products
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float sq_s[QB], qs_s[QB];
  In* q_s = reinterpret_cast<In*>(smem);  // [P][QB][KS]
  In* c_s = q_s + P * QPL;                // [P][LANES][KS]
  Acc* acc_s = reinterpret_cast<Acc*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 4;  // the warp's 32 of the 64 queries
  const int wc = warp % 4;  // the warp's 32 of the group's 128 rows
  const int qb = blockIdx.x % qblocks;
  const int tile = blockIdx.x / qblocks;
  const int q0 = qb * QB;
  const int64_t row0 = (int64_t)tile * TILE;

  if (tid < QB) {
    const int qi = q0 + tid;
    sq_s[tid] = (S8 && qi < B) ? sq[qi] : 0.f;
    qs_s[tid] = qi < B ? qsum[qi] : 0.f;
  }
  // epilogue: thread (qh, lane) owns queries qh, qh + QSTEP, ... of band lane
  const int lane = tid % LANES, qh = tid / LANES;
  float best[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) best[i] = -INFINITY;

  for (int j = 0; j < GROUPS; ++j) {
    const int64_t g0 = row0 + j * LANES;
    if (g0 >= N) break;  // the same for every thread of the block
    const int64_t row = g0 + lane;
    float ra = 0.f, rb = 0.f, rz = -INFINITY;  // rows past N score -inf
    if (row < N) {
      ra = a[row];
      rb = bv[row];
      rz = bias[row];
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[r][f], (Acc)0);

    for (int d0 = 0; d0 < D; d0 += DC) {
      if (VEC) {
        // unit u = (plane p, row r): 8 adjacent threads take 8 adjacent
        // rows of one plane, so each quarter-warp's stores are contiguous
        for (int u = tid; u < QB * P; u += THREADS) {
          const int p = (u / 8) % P, r = u % 8 + 8 * (u / (8 * P));
          const int qi = q0 + r, d = d0 + p * KE;
          int4 v0 = make_int4(0, 0, 0, 0), v1 = v0;
          if (qi < B && d < D) {
            const int4* src = reinterpret_cast<const int4*>(q + (int64_t)qi * D + d);
            v0 = __ldg(src);
            if (!S8) v1 = __ldg(src + 1);
          }
          int4* dst = reinterpret_cast<int4*>(q_s + p * QPL + r * KS);
          dst[0] = v0;
          if (!S8) dst[1] = v1;
        }
        for (int u = tid; u < LANES * P; u += THREADS) {
          const int p = (u / 8) % P, r = u % 8 + 8 * (u / (8 * P));
          const int64_t gr = g0 + r;
          const int d = d0 + p * KE;
          int4 v = make_int4(0, 0, 0, 0);
          if (gr < N && d < D)
            v = __ldg(reinterpret_cast<const int4*>(codes + gr * D + d));
          put_codes<S8>(c_s + p * CPL + r * KS, v);
        }
      } else {
        for (int u = tid; u < QB * DC; u += THREADS) {
          const int r = u / DC, k = u % DC;
          const int qi = q0 + r, d = d0 + k;
          q_s[(k / KE) * QPL + r * KS + k % KE] =
              (qi < B && d < D) ? q[(int64_t)qi * D + d] : code_elem<S8>(0);
        }
        for (int u = tid; u < LANES * DC; u += THREADS) {
          const int r = u / DC, k = u % DC;
          const int64_t gr = g0 + r;
          const int d = d0 + k;
          c_s[(k / KE) * CPL + r * KS + k % KE] =
              code_elem<S8>((gr < N && d < D) ? codes[gr * D + d] : (int8_t)0);
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, In, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, In, wmma::col_major> fb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wmma::load_matrix_sync(fa[r], q_s + p * QPL + (wr * 32 + r * 16) * KS, KS);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::load_matrix_sync(fb[f], c_s + p * CPL + (wc * 32 + f * 16) * KS, KS);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int f = 0; f < 2; ++f)
            wmma::mma_sync(acc[r][f], fa[r], fb[f], acc[r][f]);
      }
      __syncthreads();
    }

    // the staged planes are dead: the group's products take their place
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(acc_s + (wr * 32 + r * 16) * LDA + wc * 32 + f * 16,
                                acc[r][f], LDA, wmma::mem_row_major);
    __syncthreads();

    // scores with the plain version's roundings, folded into the maxima
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int qi = qh + QSTEP * i;
      const float dot = (float)acc_s[qi * LDA + lane];  // int32 -> f32: nearest
      float s;
      if constexpr (S8)
        s = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(sq_s[qi], ra), dot),
                                __fmul_rn(qs_s[qi], rb)),
                      rz);
      else
        s = __fadd_rn(__fadd_rn(__fmul_rn(ra, dot), __fmul_rn(qs_s[qi], rb)), rz);
      best[i] = fmaxf(best[i], s);
    }
    __syncthreads();  // acc_s is staged into again
  }

  const int64_t width = (int64_t)tiles * LANES;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int qi = q0 + qh + QSTEP * i;
    if (qi < B) out[qi * width + (int64_t)tile * LANES + lane] = best[i];
  }
}

template <bool S8>
int launch(const void* q, const void* sq, const void* qsum, const void* codes,
           const void* a, const void* bv, const void* bias, void* out, int B,
           int N, int D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int qblocks = (B + QB - 1) / QB;
  const int64_t tiles = ((int64_t)N + TILE - 1) / TILE;
  if (tiles * qblocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * qblocks));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using In = typename Op<S8>::In;
#define VS_LAUNCH(V)                                                            \
  flat_bands_kernel<S8, V><<<grid, THREADS, 0, st>>>(                           \
      static_cast<const In*>(q), static_cast<const float*>(sq),                 \
      static_cast<const float*>(qsum), static_cast<const int8_t*>(codes),       \
      static_cast<const float*>(a), static_cast<const float*>(bv),              \
      static_cast<const float*>(bias), static_cast<float*>(out), B, N, D,       \
      qblocks, (int)tiles)
  if (D % 16 == 0)
    VS_LAUNCH(true);
  else
    VS_LAUNCH(false);
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_flat_bands_s8(const void* qc, const void* sq,
                                const void* qsum, const void* codes,
                                const void* a, const void* bv, const void* bias,
                                void* out, int B, int N, int D, void* stream) {
  return launch<true>(qc, sq, qsum, codes, a, bv, bias, out, B, N, D, stream);
}

extern "C" int vs_flat_bands_bf16(const void* q, const void* qsum,
                                  const void* codes, const void* a,
                                  const void* bv, const void* bias, void* out,
                                  int B, int N, int D, void* stream) {
  return launch<false>(q, nullptr, qsum, codes, a, bv, bias, out, B, N, D,
                       stream);
}
