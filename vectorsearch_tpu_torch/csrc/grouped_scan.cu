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
// share one read), far below the ~295 flops per byte at which the H100's
// bf16 tensor cores, and not the memory, become the limit. So the time is
// the bytes that have to move over the rate at which the kernel keeps them
// moving, and the design reads no byte it does not need and keeps many
// bytes in flight while it computes:
//
// - It reads only the live part of a bucket. Slots at or past counts[c]
//   are padding whose bias is -inf, so a 128-column tile that starts at or
//   past counts[c] is written as -inf scores and -inf maxima without one
//   code byte or sidecar read. A store is filled to a third or so of its
//   capacity (cap has headroom over the largest cluster), so most tiles
//   are of this kind.
// - One block per (group, 1 to 8 consecutive 128-column tiles): two
//   consumer warpgroups of 64 columns each and one producer warp. A single
//   producer thread streams the live tiles' codes, still int8, through a
//   ring of 16 KB stages (128 columns x 128 dims, one TMA box with the
//   128-byte swizzle) with full and empty mbarriers. The ring runs on
//   across the block's tiles, so the next tile's loads are in flight during
//   this tile's epilogue, and two blocks share an SM. The launch gives a
//   block 8 tiles where the groups are many enough to fill the card with
//   such blocks, and fewer, down to 1, for a small batch.
// - The group's QT query rows (bf16) are loaded once a block by TMA, as
//   D / 64 swizzled slices, and stay in shared memory as wgmma's B operand.
// - The product is computed transposed, codes_tile[128, D] x qg^T[D, QT],
//   by wgmma.mma_async m64nQTk16 (bf16 x bf16 -> f32) with the code rows as
//   the A operand in registers: each k-step's codes are widened int8 ->
//   bf16 straight into wgmma's A-fragment layout. The widening is exact:
//   the low seven bits of the byte go into the mantissa of 128.0, and -128
//   or -256, by the sign bit, is added in bf16 (the result has at most 8
//   significant bits). The swizzle makes a warp's shared-memory loads hit
//   16 distinct banks. A bf16 x int8 product is exact in f32, so the result
//   differs from the plain version only in the order of the f32 sums.
// - The epilogue passes the accumulators (columns along M) through 4-8 KB
//   of shared memory, transposed, so that a warp applies the sidecars to
//   one score row at a time, writes it as one 512-byte run, and reduces
//   the block maxima from the same registers with shuffles. The sidecars
//   of a tile are fetched before its products start.
// - Groups are the fastest grid axis: the groups of one cluster are
//   adjacent, so their blocks read the same codes back to back from L2.
//
// Where QT x D bf16 query rows and three stages do not fit in shared
// memory (D > 2688 at QT = 32), the query slices travel through the ring
// with the codes instead of staying resident: the same kernel, with B read
// from the stage.
//
// Tails: TMA fills dims past D and rows past the end of the store with
// zeros, which add exactly 0; rows of a tile past cap (cap = 64 or 192)
// belong to the next cluster and are computed but not stored. D % 16 == 0
// (TMA's 16-byte row stride) and cap % 64 == 0 are the wrapper's rules.
//
// Groups past the count: the grid is sized by a bound on the number of
// groups that the caller computes from the batch's shape, so that the
// group build never reads its exact count back to the host. The exact
// count stays on the card (`gcount`, one int32); a block whose group lies
// at or past it returns before it reads or writes anything, and nobody
// reads those rows.
//
// C interface (loaded with ctypes): vs_grouped_scores launches on the
// given stream and returns cudaGetLastError() (or the error that stopped
// it before the launch).

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int COLS = 128;              // bucket columns per tile (2 x 64)
constexpr int STAGE_DIMS = 128;        // contraction dims per ring stage
constexpr int STAGE_CODES = COLS * STAGE_DIMS;  // 16 KB of int8 codes
constexpr int SLICE = 64;              // dims per query slice (128 B of bf16)
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int MAX_TILES = 8;           // tiles per block, at most
constexpr int SMEM_SLACK = 1024 + 256;   // 1024-byte alignment, barriers
// the most shared memory a block may take for two blocks to share an SM
// (228 KB an SM, 1 KB of it reserved for each block)
constexpr int SMEM_TWO_BLOCKS = (233472 - 2 * 1024) / 2;

// the consumers' own barrier: the producer warp never joins it
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// d[64 x N] (+)= a[64 x 16] (registers, bf16) x b[16 x N] (shared, bf16),
// N = 8, 16 or 32: a thread holds N / 2 sums
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// pins the accumulators in program order around the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the staging tile of the epilogue is [rows][128 columns] f32 with the
// 8-column groups of row n exchanged by n's bits 1-2: the accumulators'
// transposing stores and the rows' 16-byte loads both hit every bank once
__device__ __forceinline__ int stage_col(int n, int m) {
  return m ^ (((n >> 1) & 3) << 3);
}

template <int QT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
grouped_scores_kernel(const __grid_constant__ CUtensorMap map_codes,
                      const __grid_constant__ CUtensorMap map_q,
                      const float* __restrict__ qsum,
                      const int32_t* __restrict__ gcl,
                      const int32_t* __restrict__ gcount,
                      const int32_t* __restrict__ counts,
                      const float* __restrict__ a,
                      const float* __restrict__ bv,
                      const float* __restrict__ bias,
                      float* __restrict__ out,
                      float* __restrict__ bmax,
                      int D, int K, int cap, int bs, int tiles, int stages,
                      int stage_bytes) {
  constexpr int ACC = QT / 2;                  // sums a thread holds
  constexpr int PASS_ROWS = QT < 16 ? QT : 16; // score rows per epilogue pass
  constexpr int Q_SLICE = QT * SLICE * 2;      // one query slice, bytes

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nks = D / 16;                      // k-steps of 16 dims
  const int nsl = (nks + 3) / 4;               // 64-dim slices
  const int nst = (nks + 7) / 8;               // 128-dim stages per tile
  uint8_t* ring = smem;                        // stages x stage_bytes
  uint8_t* q_s = ring + stages * stage_bytes;  // RESIDENT: nsl x Q_SLICE
  float* acc_s = reinterpret_cast<float*>(q_s + (RESIDENT ? nsl * Q_SLICE : 0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(acc_s + PASS_ROWS * COLS);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* q_full = bars + 2 * MAX_STAGES;

  const int g = blockIdx.x;
  if (g >= *gcount) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = gcl[g];
  const int nblk = cap / bs;
  const size_t out_row0 = (size_t)g * QT;

  // this block's tiles [t0, t1), the first `nlive` of them live: a tile at
  // or past the cluster's count holds nothing but padding
  const int ntiles = (cap + COLS - 1) / COLS;
  const int t0 = blockIdx.y * tiles;
  const int t1 = min(ntiles, t0 + tiles);
  const bool known = c >= 0 && c < K;
  const int cnt = known ? min(max(counts[c], 0), cap) : 0;
  const int nlive = max(0, min(t1, (cnt + COLS - 1) / COLS) - t0);

  // dead tiles: -inf scores and maxima, nothing read. One warp a row.
  for (int u = warp; u < (t1 - t0 - nlive) * QT; u += THREADS / 32) {
    const int col = (t0 + nlive + u / QT) * COLS + lane * 4;
    const size_t row = out_row0 + u % QT;
    if (col < cap) {
      *reinterpret_cast<float4*>(out + row * cap + col) =
          make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (bmax != nullptr && lane % (bs / 4) == 0)
        bmax[row * nblk + col / bs] = -INFINITY;
    }
  }
  if (nlive == 0) return;  // uniform over the block

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- producer: one thread starts every TMA load, the group's query
    // slices once, then the live tiles' code stages
    if (lane != 0) return;
    if (RESIDENT) {
      mbar_expect_tx(q_full, nsl * Q_SLICE);
      for (int sl = 0; sl < nsl; ++sl)
        tma_load_2d(q_s + sl * Q_SLICE, &map_q, SLICE * sl, g * QT, q_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t0 + nlive; ++t) {
      const int row0 = c * cap + t * COLS;
      for (int ks = 0; ks < nst; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* dst = ring + stage * stage_bytes;
        mbar_expect_tx(&full[stage], stage_bytes);
        tma_load_2d(dst, &map_codes, STAGE_DIMS * ks, row0, &full[stage]);
        if (!RESIDENT) {
          tma_load_2d(dst + STAGE_CODES, &map_q, STAGE_DIMS * ks, g * QT,
                      &full[stage]);
          tma_load_2d(dst + STAGE_CODES + Q_SLICE, &map_q,
                      STAGE_DIMS * ks + SLICE, g * QT, &full[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes columns 64 wg .. 64 wg + 63 of the
  // tile as wgmma's M; this thread rows rloc and rloc + 8, k columns 2q,
  // 2q + 1 of each group of 8
  const int wg = warp / 4;
  const int q = lane & 3;
  const int rloc = wg * 64 + (warp % 4) * 16 + (lane >> 2);
  const uint32_t sel = 0x4140u | ((q & 1) * 2) | (((q & 1) * 2 + 1) << 8);
  const uint32_t swz = lane >> 2;  // rloc & 7: the row's 16-byte chunk swizzle
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t q_u = smem_u32(q_s);
  const uint32_t row_off = rloc * STAGE_DIMS + 4 * (q >> 1);
  int stage = 0;
  uint32_t phase = 0;
  if (RESIDENT) mbar_wait(q_full, 0);

  for (int t = t0; t < t0 + nlive; ++t) {
    const int col0 = t * COLS;
    // the sidecars of this lane's 4 columns of the epilogue's rows, fetched
    // now so that they arrive while the products run
    const int ecol = col0 + lane * 4;
    float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = a4, z4 = a4;
    if (ecol < cap) {
      const size_t side = (size_t)c * cap + ecol;
      a4 = *reinterpret_cast<const float4*>(a + side);
      b4 = *reinterpret_cast<const float4*>(bv + side);
      z4 = *reinterpret_cast<const float4*>(bias + side);
    }

    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    for (int ks = 0; ks < nst; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t stage_u = ring_u + stage * stage_bytes;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int sl = 2 * ks + half;
        if (sl < nsl) {  // uniform; a partial slice multiplies TMA's zeros
          uint32_t af[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t p =
                stage_u + row_off + (((4 * half + kk) ^ swz) << 4);
            const uint32_t w00 = lds_u32(p);
            const uint32_t w01 = lds_u32(p + 8);
            const uint32_t w10 = lds_u32(p + 8 * STAGE_DIMS);
            const uint32_t w11 = lds_u32(p + 8 * STAGE_DIMS + 8);
            af[kk][0] = widen2(w00, sel);  // row r, dims 2q, 2q + 1
            af[kk][1] = widen2(w10, sel);  // row r + 8
            af[kk][2] = widen2(w01, sel);  // row r, dims 2q + 8, 2q + 9
            af[kk][3] = widen2(w11, sel);  // row r + 8
          }
          const uint64_t desc = sw128_desc(
              RESIDENT ? q_u + sl * Q_SLICE
                       : stage_u + STAGE_CODES + half * Q_SLICE);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<QT>::mma(acc, af[kk], desc + 2 * kk, (sl > 0 || kk > 0) ? 1u : 0u);
          wgmma_commit();
          wgmma_wait0();
          fence_acc(acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue, PASS_ROWS score rows a pass: the accumulators go to the
    // staging tile transposed, then warp w takes rows w, w + 8 of the pass
#pragma unroll
    for (int pass = 0; pass < QT / PASS_ROWS; ++pass) {
      consumer_sync();  // the staging tile's last readers are done
#pragma unroll
      for (int j = 0; j < PASS_ROWS / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * j + 2 * q + e;  // row within the pass
            acc_s[n * COLS + stage_col(n, rloc + 8 * h)] =
                acc[4 * (pass * (PASS_ROWS / 8) + j) + 2 * h + e];
          }
        }
      }
      consumer_sync();
      for (int n = warp; n < PASS_ROWS; n += CONSUMER_WARPS) {
        const int i = pass * PASS_ROWS + n;
        float m = -INFINITY;
        if (ecol < cap) {
          const float qs = qsum[out_row0 + i];
          const float4 d4 = *reinterpret_cast<const float4*>(
              acc_s + n * COLS + stage_col(n, lane * 4));
          float4 s;
          s.x = d4.x * a4.x + qs * b4.x + z4.x;
          s.y = d4.y * a4.y + qs * b4.y + z4.y;
          s.z = d4.z * a4.z + qs * b4.z + z4.z;
          s.w = d4.w * a4.w + qs * b4.w + z4.w;
          *reinterpret_cast<float4*>(out + (out_row0 + i) * cap + ecol) = s;
          m = fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w));
        }
        if (bmax != nullptr) {
          // 16 lanes span 64 columns; bs=128 also folds the two half-warps
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if (bs == 128) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (ecol < cap && lane % (bs / 4) == 0)
            bmax[(out_row0 + i) * nblk + ecol / bs] = m;
        }
      }
    }
  }
}

}  // namespace

// the library's ABI version: bumped whenever an entry point of any source
// under csrc/ is added or changes its arguments
extern "C" int vs_abi_version() { return 7; }

extern "C" int vs_grouped_scores(const void* qg, const void* qsum,
                                 const void* gcl, const void* gcount,
                                 const void* counts,
                                 const void* codes, const void* a,
                                 const void* bv, const void* bias, void* out,
                                 void* bmax, int G, int QT, int D, int K,
                                 int cap, int bs, void* stream) {
  if (G <= 0 || D <= 0 || D % 16 != 0 || K <= 0 || cap <= 0 || cap % 64 != 0 ||
      (QT != 8 && QT != 16 && QT != 32))
    return (int)cudaErrorInvalidValue;
  const int nsl = (D / 16 + 3) / 4;
  const int q_slice = QT * SLICE * 2;
  const int fixed = SMEM_SLACK + (QT < 16 ? QT : 16) * COLS * 4;
  // the query rows stay resident where they leave room for three stages;
  // else they travel with the codes, two slices a stage. As many stages as
  // let two blocks share an SM, at least three, at most MAX_STAGES.
  const bool resident = fixed + nsl * q_slice + 3 * STAGE_CODES <= SMEM_MAX;
  const int stage_bytes = STAGE_CODES + (resident ? 0 : 2 * q_slice);
  const int rest = fixed + (resident ? nsl * q_slice : 0);
  int stages = (SMEM_TWO_BLOCKS - rest) / stage_bytes;
  if (stages < 3) stages = (SMEM_MAX - rest) / stage_bytes;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = rest + stages * stage_bytes;

  CUtensorMap map_codes, map_q;
  if (!make_map(&map_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes,
                (uint64_t)K * cap, D, COLS, STAGE_DIMS,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qg,
                (uint64_t)G * QT, D, QT, SLICE, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (cap + COLS - 1) / COLS;
  // tiles per block: 8 where there are groups enough to fill the card with
  // such blocks (a block then loads its query rows once for all the live
  // tiles of a bucket filled to a third), fewer for fewer groups, down to 1.
  // G is the grid's groups, the caller's bound on the count
  int tiles = MAX_TILES;
  while (tiles > 1 && (long)G * ntiles < 1600L * tiles) tiles /= 2;
  const dim3 grid(G, (ntiles + tiles - 1) / tiles);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(QTV, R)                                                      \
  do {                                                                         \
    cudaError_t e = cudaFuncSetAttribute(                                      \
        grouped_scores_kernel<QTV, R>,                                         \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                    \
    if (e != cudaSuccess) return (int)e;                                       \
    grouped_scores_kernel<QTV, R><<<grid, THREADS, smem, st>>>(                \
        map_codes, map_q, static_cast<const float*>(qsum),                     \
        static_cast<const int32_t*>(gcl), static_cast<const int32_t*>(gcount), \
        static_cast<const int32_t*>(counts),                                   \
        static_cast<const float*>(a), static_cast<const float*>(bv),           \
        static_cast<const float*>(bias), static_cast<float*>(out),             \
        static_cast<float*>(bmax), D, K, cap, bs, tiles, stages, stage_bytes); \
  } while (0)
#define VS_LAUNCH_QT(QTV)  \
  do {                     \
    if (resident)          \
      VS_LAUNCH(QTV, true); \
    else                   \
      VS_LAUNCH(QTV, false); \
  } while (0)
  switch (QT) {
    case 8: VS_LAUNCH_QT(8); break;
    case 16: VS_LAUNCH_QT(16); break;
    default: VS_LAUNCH_QT(32); break;
  }
#undef VS_LAUNCH_QT
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}
