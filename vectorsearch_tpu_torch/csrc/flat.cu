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
// What bounds it on this card: arithmetic, by the count. Each code byte
// feeds 2 * B operations (B = 512 at the bench's batch), above the ~295 per
// byte (bf16; twice that in int8) at which the tensor cores, not the memory,
// become the limit. A block of 128 queries re-reads the corpus B / 128 times,
// all but once from L2, and a quarter of all bytes are the band maxima
// written. Measured on an H100 SXM at 700 W (B = 512, N = 1M, D = 768) the s8
// kernel runs at a little over half of the int8 peak and the bf16 kernel at
// under half of the bf16 peak; what holds each back is in PERF.md.
//
// The design keeps the tensor cores fed and keeps everything of size B x N
// out of memory:
//
// - The product is computed transposed, codes[128 rows, D] x queries^T[D, QN],
//   one row group (rows j * 128 .. j * 128 + 127 of a tile) at a time: two
//   consumer warpgroups take 64 rows each as wgmma's M, the block's QN = 128
//   (or 64) queries are N. Band `lane` is row `lane` of every group, so for a
//   fixed thread sum i of group j and sum i of group j + 1 belong to the same
//   (band, query): the running maxima live in registers in the accumulators'
//   own layout, best[i] = max(best[i], score(acc[i])). Nothing of a score
//   goes through shared memory and no barrier spans the block.
// - One producer thread streams the codes, still int8, through a ring of 16 KB
//   stages (128 rows x 128 dims, one TMA box with the 128-byte swizzle) with
//   full and empty mbarriers. The producer's warpgroup gives its registers to
//   the consumers (setmaxnreg 40 / 232).
// - The block's query rows are loaded once by TMA, as swizzled slices of 128
//   bytes a row, and stay in shared memory as wgmma's B operand for every
//   group of every tile the block walks.
// - s8: wgmma m64nQNk32 s8 x s8 -> s32 with both operands K-major in shared
//   memory, as TMA wrote them: no widening at all. A stage's four k-steps are
//   one wgmma group, and the group before is waited for after the next is
//   committed. int32 sums are exact in any order; they leave the accumulators
//   as f32 (rounded to nearest, as the plain version's) and are folded into
//   the maxima after the next row group's first stage is committed, so the
//   epilogue runs under that group's products. The sidecars are applied with
//   __fmul_rn / __fadd_rn in the plain version's order: the band maxima are
//   bit-equal to it.
// - bf16: wgmma m64nQNk16 bf16 x bf16 -> f32 with the codes as the register A
//   operand: each 64-dim slice is widened int8 -> bf16 (widen2 of hopper.cuh,
//   exact) straight into the A-fragment layout, the next slice while this
//   slice's four wgmmas run, in two register sets. A bf16 x int8 product is
//   exact in f32, so the maxima differ from the plain version's only in the
//   order of the f32 sums.
// - A persistent schedule: one block an SM where the work allows. Block (lane,
//   query block) walks tiles lane, lane + tile_lanes, ...; the ring runs on
//   across groups and tiles, so loads are in flight during every epilogue and
//   store. The query blocks of a tile are adjacent in the grid and walk the
//   same tiles at the same time: all but the first read of a tile come from
//   L2.
// - Each band is written once, from the accumulator layout: a warp's store
//   covers 8 adjacent bands of 4 queries, four whole 32-byte sectors.
//
// The launch rule: QN = 128 where the batch has more than 64 queries, else
// 64; the query rows resident where they leave room for two stages (with 64
// queries where 128 do not fit), else travelling through the ring with the
// codes, the same kernel with B read from the stage; as many stages as fit,
// at most 8. At D = 768 that is 128 resident queries with 8 stages (s8) or 2
// (bf16, whose rows take 192 KB).
//
// Tails: any N (TMA fills rows past N with zeros; a row at or past N scores
// -inf by its index, its sidecars never read; a group wholly past N is
// skipped), any B (query rows past B are zeros and never written), bias
// -inf for a dead row, a wholly dead tile gives -inf bands. TMA needs 16-byte
// row strides, so D % 16 == 0: for any other D the wrapper pads the codes
// and the query rows with zero columns, which add exactly 0 (a copy of the
// corpus a call, as kernels/kmeans.py pays for assign).
//
// Tried and not faster on the card (times in PERF.md): two accumulator sets
// for the s8 epilogue (ptxas serializes the wgmmas, C7514), a 2-CTA cluster
// that multicasts each code stage, TMA prefetch into L2 ahead of the ring,
// 104 queries a block for a deeper bf16 ring, the bf16 warpgroups made to
// take turns with named barriers, ldmatrix loads against reordered query
// dims, 16-byte shared loads, and eight wgmmas a wait. 256 queries a block
// do not fit: accumulators and maxima alone would be 256 registers a thread.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns cudaGetLastError() (or the error that stopped it
// before the launch). `tile_lanes`, `stages` and `qn` are 0 for the launch
// rule above, or force the tile lanes of the grid, the ring's depth and the
// queries a block (for measurements and tests).

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 1024;                  // corpus rows per tile
constexpr int LANES = 128;                  // bands per tile = rows per group
constexpr int GROUPS = TILE / LANES;        // 8
constexpr int STAGE_DIMS = 128;             // contraction dims per ring stage
constexpr int STAGE_CODES = LANES * STAGE_DIMS;  // 16 KB of int8 codes
constexpr int HALF_CODES = STAGE_CODES / 2;      // a warpgroup's 64 rows
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_WARPS = 8;           // two warpgroups
constexpr int THREADS = (CONSUMER_WARPS + 4) * 32;  // + the producer warpgroup
constexpr int BAR_BYTES = (2 * MAX_STAGES + 1) * 8;
constexpr int SMEM_ALIGN = 1024;            // the swizzle's alignment

template <bool S8> struct Op;
template <> struct Op<true> {   // int8 x int8 -> int32
  using Acc = int;
  static constexpr int ESIZE = 1;
};
template <> struct Op<false> {  // bf16 x bf16 -> f32
  using Acc = float;
  static constexpr int ESIZE = 2;
};

// d[64 x N] (+)= a[64 x 32] (shared, int8) x b[32 x N] (shared, int8), N = 64
// or 128: a thread holds N / 2 sums
template <int N> struct MmaS8;
// d[64 x N] (+)= a[64 x 16] (registers, bf16) x b[16 x N] (shared, bf16)
template <int N> struct MmaBf16;

template <> struct MmaS8<64> {
  __device__ static __forceinline__ void mma(int (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct MmaS8<128> {
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p;\n}\n"
        :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct MmaBf16<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct MmaBf16<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};


// pins the accumulators in program order around the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the sidecars of this thread's two rows of the group that starts at row
// g0; a row at or past N scores -inf by its index and is never read
__device__ __forceinline__ void load_sidecars(const float* __restrict__ a,
                                              const float* __restrict__ bv,
                                              const float* __restrict__ bias,
                                              int64_t g0, int rloc, int N,
                                              float (&ra)[2], float (&rb)[2],
                                              float (&rz)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = g0 + rloc + 8 * h;
    const bool live = r < N;
    ra[h] = live ? __ldg(a + r) : 0.f;
    rb[h] = live ? __ldg(bv + r) : 0.f;
    rz[h] = live ? __ldg(bias + r) : -INFINITY;
  }
}

// a group's scores with the plain version's roundings, folded into the
// running maxima. Dot 4 c + 2 h + e is (row rloc + 8 h, query 8 c + 2 q + e):
// the same band and query in every group of a tile
template <bool S8, int ACC>
__device__ __forceinline__ void fold_group(const float (&dot)[ACC],
                                           float (&best)[ACC],
                                           const float (&ra)[2],
                                           const float (&rb)[2],
                                           const float (&rz)[2],
                                           const float* sq_s, const float* qs_s,
                                           int q) {
#pragma unroll
  for (int c = 0; c < ACC / 4; ++c) {
    const float2 qs2 = *reinterpret_cast<const float2*>(qs_s + 8 * c + 2 * q);
    float2 sq2 = make_float2(0.f, 0.f);
    if constexpr (S8) sq2 = *reinterpret_cast<const float2*>(sq_s + 8 * c + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * c + 2 * h + e;
        const float qs = e ? qs2.y : qs2.x;
        float s;
        if constexpr (S8)
          s = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(e ? sq2.y : sq2.x, ra[h]), dot[i]),
                                  __fmul_rn(qs, rb[h])),
                        rz[h]);
        else
          s = __fadd_rn(__fadd_rn(__fmul_rn(ra[h], dot[i]), __fmul_rn(qs, rb[h])),
                        rz[h]);
        best[i] = fmaxf(best[i], s);
      }
    }
  }
}

// a tile's band maxima, each written once: a warp's store covers 8 adjacent
// bands of 4 queries (four whole 32-byte sectors)
template <int ACC>
__device__ __forceinline__ void store_bands(float (&best)[ACC],
                                            float* __restrict__ out,
                                            int64_t width, int64_t col, int q0,
                                            int q, int B) {
#pragma unroll
  for (int c = 0; c < ACC / 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = q0 + 8 * c + 2 * q + e;
      if (qi < B) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcs(out + qi * width + col + 8 * h, best[4 * c + 2 * h + e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) best[i] = -INFINITY;
}

// the groups of tile t that hold a row below N
__device__ __forceinline__ int live_groups(int t, int N) {
  const int left = N - t * TILE;
  return left >= TILE ? GROUPS : (left + LANES - 1) / LANES;
}

template <bool S8, int QN, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
flat_bands_kernel(const __grid_constant__ CUtensorMap map_codes,
                  const __grid_constant__ CUtensorMap map_q,
                  const float* __restrict__ sq,    // [B], s8 only
                  const float* __restrict__ qsum,  // [B]
                  const float* __restrict__ a,     // [N]
                  const float* __restrict__ bv,    // [N]
                  const float* __restrict__ bias,  // [N]
                  float* __restrict__ out,         // [B, tiles * 128]
                  int B, int N, int D, int qblocks, int tiles, int tile_lanes,
                  int stages, int stage_bytes) {
  using Acc = typename Op<S8>::Acc;
  constexpr int ACC = QN / 2;                       // sums a thread holds
  constexpr int SLICE = 128 / Op<S8>::ESIZE;        // dims per query slice
  constexpr int Q_SLICE = QN * 128;                 // one query slice, bytes

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~uintptr_t(SMEM_ALIGN - 1));
  const int nsl = (D + SLICE - 1) / SLICE;          // query slices
  const int nst = (D + STAGE_DIMS - 1) / STAGE_DIMS;  // ring stages per group
  uint8_t* ring = smem;                             // stages x stage_bytes
  uint8_t* q_s = ring + stages * stage_bytes;       // RESIDENT: nsl x Q_SLICE
  float* sq_s = reinterpret_cast<float*>(q_s + (RESIDENT ? nsl * Q_SLICE : 0));
  float* qs_s = sq_s + QN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(qs_s + QN);
  uint64_t* full = bars;
  uint64_t* empty = bars + MAX_STAGES;
  uint64_t* q_full = bars + 2 * MAX_STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (blockIdx.x % qblocks) * QN;       // this block's queries
  const int t_first = blockIdx.x / qblocks;         // and its tiles: every
                                                    // tile_lanes-th from here
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < QN) {
    const int qi = q0 + tid;
    sq_s[tid] = (S8 && qi < B) ? sq[qi] : 0.f;
    qs_s[tid] = qi < B ? qsum[qi] : 0.f;
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: one thread starts every TMA load, the block's
    // query slices once, then the code stages of its tiles' live groups; the
    // rest only give their registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp != CONSUMER_WARPS || lane != 0) return;
    if (RESIDENT) {
      mbar_expect_tx(q_full, nsl * Q_SLICE);
      for (int sl = 0; sl < nsl; ++sl)
        tma_load_2d(q_s + sl * Q_SLICE, &map_q, SLICE * sl, q0, q_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_first; t < tiles; t += tile_lanes) {
      const int ng = live_groups(t, N);
      for (int j = 0; j < ng; ++j) {
        for (int ks = 0; ks < nst; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* dst = ring + stage * stage_bytes;
          mbar_expect_tx(&full[stage], stage_bytes);
          tma_load_2d(dst, &map_codes, STAGE_DIMS * ks, t * TILE + j * LANES,
                      &full[stage]);
          if (!RESIDENT) {
#pragma unroll
            for (int s = 0; s < STAGE_DIMS / SLICE; ++s)
              tma_load_2d(dst + STAGE_CODES + s * Q_SLICE, &map_q,
                          STAGE_DIMS * ks + SLICE * s, q0, &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each
  // group as wgmma's M; this thread rows rloc and rloc + 8, queries 2q,
  // 2q + 1 of each 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp / 4;
  const int q = lane & 3;
  const int rloc = wg * 64 + (warp % 4) * 16 + (lane >> 2);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t q_u = smem_u32(q_s);
  const int64_t width = (int64_t)tiles * LANES;
  int stage = 0;
  uint32_t phase = 0;
  float ra[2], rb[2], rz[2];
  float best[ACC];
  Acc acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    best[i] = -INFINITY;
    acc[i] = 0;
  }
  if (RESIDENT) mbar_wait(q_full, 0);

  if constexpr (S8) {
    // both operands from shared memory. A stage's four k-steps are one
    // wgmma group; the group before it is waited for after this one is
    // committed, so the tensor cores always have a group queued. A row
    // group's sums leave the accumulators as f32 (int32 -> f32 rounds to
    // nearest, as the plain version's) and are folded into the maxima
    // after the next row group's first stage is committed, under its
    // products
    float dot[ACC], pa[2], pb[2], pz[2];  // the row group waiting to be folded
    int pend_t = -1;                      // its tile, -1 for none
    bool pend_last = false;               // it ends its tile
    auto fold_pending = [&]() {
      fold_group<true>(dot, best, pa, pb, pz, sq_s, qs_s, q);
      if (pend_last)
        store_bands(best, out, width, (int64_t)pend_t * LANES + rloc, q0, q, B);
    };
    for (int t = t_first; t < tiles; t += tile_lanes) {
      const int ng = live_groups(t, N);
      for (int j = 0; j < ng; ++j) {
        load_sidecars(a, bv, bias, (int64_t)t * TILE + j * LANES, rloc, N, ra,
                      rb, rz);
        int prev = -1;
        for (int ks = 0; ks < nst; ++ks) {
          mbar_wait(&full[stage], phase);
          const uint32_t stage_u = ring_u + stage * stage_bytes;
          const uint64_t desc_a = sw128_desc(stage_u + wg * HALF_CODES);
          const uint64_t desc_b =
              sw128_desc(RESIDENT ? q_u + ks * Q_SLICE : stage_u + STAGE_CODES);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            MmaS8<QN>::mma(acc, desc_a + 2 * kk, desc_b + 2 * kk,
                           (ks > 0 || kk > 0) ? 1u : 0u);
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait1();
            if (lane == 0) mbar_arrive(&empty[prev]);
          } else if (pend_t >= 0) {
            fold_pending();
          }
          prev = stage;
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait0();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) dot[i] = __int2float_rn(acc[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pa[h] = ra[h];
          pb[h] = rb[h];
          pz[h] = rz[h];
        }
        pend_t = t;
        pend_last = j + 1 == ng;
      }
    }
    fold_pending();
  } else {
    // the codes are wgmma's A operand in registers: each 64-dim slice (four
    // k-steps) is widened int8 -> bf16 from the stage straight into the
    // A-fragment layout, the next slice while this slice's wgmmas run. Two
    // register sets, so no copy and no register reuse inside a wgmma's flight
    const uint32_t sel = 0x4140u | ((q & 1) * 2) | (((q & 1) * 2 + 1) << 8);
    const uint32_t swz = lane >> 2;  // rloc & 7: the row's 16-byte chunk swizzle
    const uint32_t row_off = rloc * STAGE_DIMS + 4 * (q >> 1);
    auto widen_slice = [&](uint32_t (&af)[4][4], uint32_t stage_u, int half) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t p = stage_u + row_off + (((4 * half + kk) ^ swz) << 4);
        const uint32_t w00 = lds_u32(p);
        const uint32_t w01 = lds_u32(p + 8);
        const uint32_t w10 = lds_u32(p + 8 * STAGE_DIMS);
        const uint32_t w11 = lds_u32(p + 8 * STAGE_DIMS + 8);
        af[kk][0] = widen2(w00, sel);  // row r, dims 2q, 2q + 1
        af[kk][1] = widen2(w10, sel);  // row r + 8
        af[kk][2] = widen2(w01, sel);  // row r, dims 2q + 8, 2q + 9
        af[kk][3] = widen2(w11, sel);  // row r + 8
      }
    };
    uint32_t a_even[4][4], a_odd[4][4];
    int t = t_first, j = 0, sl = 0;
    int ng = live_groups(t, N);

    // slice (t, j, sl)'s four wgmmas from `cur`, and the block's next slice
    // widened into `next` while they run. After the block's last slice the
    // widening reads a stage that no load filled, into fragments that
    // nothing multiplies. A step past the last slice (`live` false, for an
    // odd count) does nothing
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&next)[4][4], bool live) {
      if (!live) return;
      const uint32_t stage_u = ring_u + stage * stage_bytes;
      const uint64_t desc = sw128_desc(
          RESIDENT ? q_u + sl * Q_SLICE
                   : stage_u + STAGE_CODES + (sl & 1) * Q_SLICE);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        MmaBf16<QN>::mma(acc, cur[kk], desc + 2 * kk, (sl > 0 || kk > 0) ? 1u : 0u);
      wgmma_commit();
      // a stage holds two slices; the last of an odd count has one
      const bool stage_done = (sl & 1) || sl + 1 == nsl;
      int nstage = stage;
      uint32_t nphase = phase;
      if (stage_done && ++nstage == stages) {
        nstage = 0;
        nphase ^= 1;
      }
      const bool more =
          !(sl + 1 == nsl && j + 1 == ng && t + tile_lanes >= tiles);
      if (more && stage_done) mbar_wait(&full[nstage], nphase);
      widen_slice(next, ring_u + nstage * stage_bytes, stage_done ? 0 : 1);
      wgmma_wait0();
      fence_acc(acc);
      if (stage_done) {
        if (lane == 0) mbar_arrive(&empty[stage]);
        stage = nstage;
        phase = nphase;
      }
      if (++sl < nsl) return;
      // the group is complete
      fold_group<false>(acc, best, ra, rb, rz, sq_s, qs_s, q);
      sl = 0;
      if (++j == ng) {
        store_bands(best, out, width, (int64_t)t * LANES + rloc, q0, q, B);
        j = 0;
        t += tile_lanes;
        if (t >= tiles) return;
        ng = live_groups(t, N);
      }
      load_sidecars(a, bv, bias, (int64_t)t * TILE + j * LANES, rloc, N, ra, rb,
                    rz);
    };

    load_sidecars(a, bv, bias, (int64_t)t * TILE, rloc, N, ra, rb, rz);
    mbar_wait(&full[0], 0);
    widen_slice(a_even, ring_u, 0);
    while (t < tiles) {
      step(a_even, a_odd, true);
      step(a_odd, a_even, t < tiles);
    }
  }
}

// the SM count of the current device
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    return 1;
  return sms;
}

template <bool S8>
int launch(const void* q, const void* sq, const void* qsum, const void* codes,
           const void* a, const void* bv, const void* bias, void* out, int B,
           int N, int D, int tile_lanes, int stages, int qn, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || D % 16 != 0 || tile_lanes < 0 ||
      stages < 0 || stages == 1 || stages > MAX_STAGES ||
      (qn != 0 && qn != 64 && qn != 128))
    return (int)cudaErrorInvalidValue;
  constexpr int ESIZE = Op<S8>::ESIZE;
  const int nsl = (D * ESIZE + 127) / 128;
  // queries a block: 128 where the batch has more than 64, else 64; the
  // block's query rows stay resident in shared memory where they leave room
  // for two stages, with 64 queries where 128 do not; else they travel
  // through the ring with the codes
  auto rest = [&](int n, bool res) {
    return SMEM_ALIGN + (res ? nsl * n * 128 : 0) + 2 * n * 4 + BAR_BYTES;
  };
  auto fits = [&](int n) { return rest(n, true) + 2 * STAGE_CODES <= SMEM_MAX; };
  const int want = qn ? qn : (B > 64 ? 128 : 64);
  int QN = want;
  bool resident = fits(QN);
  if (!resident && QN == 128 && qn == 0 && fits(64)) {
    QN = 64;
    resident = true;
  }
  const int stage_bytes =
      STAGE_CODES + (resident ? 0 : STAGE_DIMS * ESIZE * QN);
  const int room = (SMEM_MAX - rest(QN, resident)) / stage_bytes;
  if (room < 2 || stages > room) return (int)cudaErrorInvalidValue;
  if (stages == 0) stages = room < MAX_STAGES ? room : MAX_STAGES;
  const int smem = rest(QN, resident) + stages * stage_bytes;

  const int qblocks = (B + QN - 1) / QN;
  const int tiles = (int)(((int64_t)N + TILE - 1) / TILE);
  // a persistent schedule: one block an SM where the work allows, block
  // (lane, query block) walking tiles lane, lane + tile_lanes, ... with its
  // queries loaded once. The query blocks of a tile are adjacent in the
  // grid: they walk the same tiles at the same time, so all but the first
  // read of a code tile come from L2
  if (tile_lanes == 0) tile_lanes = sm_count() / qblocks;
  if (tile_lanes < 1) tile_lanes = 1;
  if (tile_lanes > tiles) tile_lanes = tiles;
  if ((int64_t)tile_lanes * qblocks > INT32_MAX) return (int)cudaErrorInvalidValue;

  CUtensorMap map_codes, map_q;
  if (!make_map(&map_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, N, D,
                LANES, STAGE_DIMS, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_q,
                S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                ESIZE, q, B, D, QN, 128 / ESIZE, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tile_lanes * qblocks));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(QNV, R)                                                     \
  do {                                                                        \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        flat_bands_kernel<S8, QNV, R>,                                        \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                   \
    if (e != cudaSuccess) return (int)e;                                      \
    flat_bands_kernel<S8, QNV, R><<<grid, THREADS, smem, st>>>(               \
        map_codes, map_q, static_cast<const float*>(sq),                      \
        static_cast<const float*>(qsum), static_cast<const float*>(a),        \
        static_cast<const float*>(bv), static_cast<const float*>(bias),       \
        static_cast<float*>(out), B, N, D, qblocks, tiles, tile_lanes, stages, \
        stage_bytes);                                                              \
  } while (0)
  if (QN == 128) {
    if (resident)
      VS_LAUNCH(128, true);
    else
      VS_LAUNCH(128, false);
  } else {
    if (resident)
      VS_LAUNCH(64, true);
    else
      VS_LAUNCH(64, false);
  }
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_flat_bands_s8(const void* qc, const void* sq,
                                const void* qsum, const void* codes,
                                const void* a, const void* bv, const void* bias,
                                void* out, int B, int N, int D, int tile_lanes,
                                int stages, int qn, void* stream) {
  return launch<true>(qc, sq, qsum, codes, a, bv, bias, out, B, N, D,
                      tile_lanes, stages, qn, stream);
}

extern "C" int vs_flat_bands_bf16(const void* q, const void* qsum,
                                  const void* codes, const void* a,
                                  const void* bv, const void* bias, void* out,
                                  int B, int N, int D, int tile_lanes,
                                  int stages, int qn, void* stream) {
  return launch<false>(q, nullptr, qsum, codes, a, bv, bias, out, B, N, D,
                       tile_lanes, stages, qn, stream);
}
