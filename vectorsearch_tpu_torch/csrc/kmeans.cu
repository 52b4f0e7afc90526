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
// bf16 tensor cores, not the memory, become the limit; cn (6 MB at K=4096,
// 25 MB at K=16384) stays in the 50 MB L2. So the design keeps the tensor
// cores fed and reads each code byte from device memory once:
//
// - One block per tile of A_ROWS = 128 rows: two consumer warpgroups of 64
//   rows each and one producer warpgroup (384 threads, one block per SM),
//   which gives its registers to the consumers (setmaxnreg 40 / 232).
// - The tile's int8 codes stay resident in shared memory across every K
//   tile. TMA loads them once, as D / 16 boxes of [128 rows x 16 bytes],
//   so that a thread's A-fragment bytes of one k-step are one 32-bit word
//   per row half and a warp's loads hit 16 distinct banks.
// - One producer thread streams cn tiles of A_CENT = 256 centroids x 64 dims
//   (32 KB, 128-byte swizzle) through a ring of up to 4 stages with full
//   and empty mbarriers.
// - The consumers run wgmma.mma_async m64n256k16 (bf16 x bf16 -> f32) with
//   A in registers: each k-step's codes are widened int8 -> bf16 straight
//   into wgmma's A-fragment layout (exact: x + 128 in the mantissa of
//   2^23, less 2^23 + 128, whose top half is the bf16). B is the swizzled
//   cn tile. The next 64-dim slice is widened while the current slice's
//   four wgmmas run.
// - The epilogue stays in registers: the sidecars are applied to the
//   accumulators with the plain version's roundings, a running (max,
//   argmax) is kept per row, and the four lanes that share a row reduce
//   with shuffles once, at the end. Nothing of size N x K and no
//   accumulator tile goes through shared memory.
//
// Operand arrangement: codes as the register A operand, widened once per K
// tile, rather than widened once into shared memory as bf16. The bf16 copy
// of a 128 x 768 tile would take 192 KB and leave room for only one cn
// stage; the int8 tile takes 96 KB beside a ring of four 32 KB stages.
// The price is the widening, ~5 integer and float instructions per pair of
// codes per K tile, which runs beside the tensor cores.
//
// Ties go to the lowest k, as torch.argmax does: a thread walks its
// columns in increasing k with a strict `>`, and the lanes of a row take
// the lower index on an equal value. A bf16 x int8 product is exact in
// f32, so a cid differs from the plain version's only where two sims
// differ in the order of their f32 sums (a near-tie). The TPU kernel keeps
// a padding mask kmask; the port pads no centroid set, so the kernel masks
// only its own K tail. It has no VMEM bound on K.
//
// Tails: TMA fills rows past N, centroids past K and dims past D with
// zeros; the epilogue masks k >= K and stores no row >= N. TMA needs 16-
// byte global strides, so D % 16 == 0: the wrapper pads codes and cn with
// zero columns otherwise (exact). Where the 128-row int8 tile and two cn
// stages do not fit in shared memory (D >= 1296), the codes are streamed
// with each cn slice through the ring instead of resident: the same
// kernel, read from the stage rather than from the resident tile.
//
// Left for later work. Tried and slower on the card: blocks paired in
// 2-CTA clusters that multicast each cn tile (half the L2 reads), L2
// eviction hints, and two slices of wgmmas in flight per warpgroup (ptxas
// then serializes them). Not tried: a persistent schedule that loads the
// next row tile's codes under the current tile's products, and the two
// warpgroups' epilogues kept out of step.
//
// vs_kmeans_accumulate, given the stable sort of cid (`order`, the row
// numbers by cluster, and `scid`, the sorted ids):
//
//   sums[k, :] = sum over the rows of cluster k of (offset + scale * codes[row, :])
//   counts[k]  = the number of such rows
//
// The TPU kernel multiplies a [1024, T] one-hot by the dequantized tile on
// the MXU and reads the codes K / 1024 times; here the sum is a segmented
// sum that reads each code row once, so it is bound by the code bytes (N x
// D of them), and the design is about keeping those bytes moving:
//
// - Balanced work whatever K: the sorted positions whose id lies in [0, K)
//   are cut into chunks of a fixed number of members (64 to 512, the
//   wrapper's rule), and about three persistent blocks an SM take chunks
//   from a counter. A 12-member cluster costs a flush, not a block; a
//   3000-member one is spread over several blocks.
// - Whole rows in long bursts, many in flight: a producer warp, one lane a
//   member, reads the member's row number, id and sidecars and starts one
//   1D bulk copy of the row's D bytes (cp.async.bulk, completion on an
//   mbarrier) into a ring of 32-row stages in shared memory: 24 KB a stage
//   at D=768, three stages a block. The code rows carry an evict-first L2
//   policy, so that the sidecars' 32-byte sectors stay in L2 for the seven
//   other rows that share them.
// - Six consumer warps: a thread owns 4 dims (one 32-bit word; up to 8
//   words at D=6144) of every row of the chunk and adds them in the sorted
//   order, with the plain version's roundings (offset + (scale * code)).
//   The producer marks where a stage's runs begin, so the loop over a run's
//   rows has no branch in it.
// - Deterministic, no float atomics: a cluster that lies inside one chunk is
//   written by that chunk alone. A run cut by a chunk's edge goes to one of
//   the chunk's two partial rows (its first run, its last), and a second
//   kernel adds a cluster's partials in chunk order, in f64, writes the
//   counts and zeroes the empty clusters. The order of the adds is fixed by
//   the layout (chunk, stage, row), never by arrival: two launches on the
//   same input give bit-identical sums.
// - Kahan compensation is kept, on every add: without it inside a ring
//   stage (the stages' sums still compensated) 65,537 rows of one cluster
//   whose sum nearly cancels came out 2.5e-4 from the plain version's, past
//   the tolerance (rtol 1e-5, atol 1e-4). Measured on an NVIDIA H100 80GB
//   HBM3 (700 W) at 1M x 768 rows and K=1024 against the plain version: max
//   |sum err| 1.95e-3 on sums near 10^3, the same as the plain-load kernel
//   below, so what is left there is the plain version's own error.
// - The segment table seg[k] (the first position with an id >= k) comes from
//   one pass over scid by a third small kernel, which also zeroes the chunk
//   counter. The TPU kernel splits each value into hi + lo bf16 (about 16
//   mantissa bits); these kernels keep the full f32 value.
//
// Bulk copies need 16-byte rows: D % 16 == 0 and D <= 6144 take this path.
// Any other D takes vs_kmeans_accumulate_loads, the first port's kernel:
// one block of 8 warps per (cluster, 128 dims) over each cluster's segment
// of the order, with the sidecars gathered in that order; warp w takes
// members w, w + 8, ..., each lane 4 dims with plain loads (byte loads when
// D % 4 != 0), Kahan-compensated, the 8 warps' partials added in warp
// order. Clusters with no members get zero sums and a zero count on both
// paths; any K >= 1 and D >= 1.
//
// C interface (loaded with ctypes): each entry point launches on the
// given stream and returns cudaGetLastError() (or the error that stopped
// it before the launch).

#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------------ assign

constexpr int A_ROWS = 128;             // data rows per block (2 x 64)
constexpr int A_CENT = 256;             // centroids per K tile (wgmma N)
constexpr int A_SLICE = 64;             // dims per ring stage (128 B of bf16)
constexpr int A_CHUNK = A_ROWS * 16;    // one k-step's codes: 128 rows x 16 B
constexpr int A_CN_STAGE = A_CENT * A_SLICE * 2;  // 32 KB
constexpr int A_MAX_STAGES = 4;
constexpr int A_CONSUMER_WARPS = 8;
constexpr int A_THREADS = (A_CONSUMER_WARPS + 4) * 32;  // + the producer WG
constexpr int A_SMEM_SLACK = 1024 + 128;  // 1024-byte alignment, barriers

// pins the accumulators in program order around the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= a[64 x 16] (registers, bf16) x b[16 x 256] (shared, bf16)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// two signed codes (bytes s and s + 1 of w) -> a bf16x2, exactly: x + 128
// in the low mantissa of 2^23, less 2^23 + 128, is x in f32, and x has at
// most 8 significant bits, so the top half of the f32 is x in bf16
__device__ __forceinline__ uint32_t widen2_f32(uint32_t w, uint32_t s) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f0, f1, out;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(f0) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | s));
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(f1) : "r"(u), "r"(0x4B000000u), "r"(0x7440u | (s + 1)));
  const float x0 = __fsub_rn(__uint_as_float(f0), 8388736.0f);
  const float x1 = __fsub_rn(__uint_as_float(f1), 8388736.0f);
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(out) : "r"(__float_as_uint(x0)), "r"(__float_as_uint(x1)));
  return out;
}

// the A fragments of one 64-dim slice (4 k-steps) of this thread's two
// rows, from [k-step][128 rows][16 bytes] codes at shared address `base`.
// K-steps past the slice's `nk` read chunk 0 again and are zeroed: no
// branch, so the fragments are defined on every path to the wgmmas
__device__ __forceinline__ void widen_slice(uint32_t (&a)[4][4],
                                            uint32_t base, int nk, int rloc,
                                            int q) {
  const uint32_t s = (q & 1) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t keep = kk < nk ? 0xffffffffu : 0u;
    const uint32_t c =
        base + (kk < nk ? kk : 0) * A_CHUNK + rloc * 16 + 4 * (q >> 1);
    const uint32_t w00 = lds_u32(c);
    const uint32_t w01 = lds_u32(c + 8);
    const uint32_t w10 = lds_u32(c + 8 * 16);
    const uint32_t w11 = lds_u32(c + 8 * 16 + 8);
    a[kk][0] = widen2_f32(w00, s) & keep;  // row r, dims 2q, 2q + 1
    a[kk][1] = widen2_f32(w10, s) & keep;  // row r + 8
    a[kk][2] = widen2_f32(w01, s) & keep;  // row r, dims 2q + 8, 2q + 9
    a[kk][3] = widen2_f32(w11, s) & keep;  // row r + 8
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(A_THREADS, 1)
kmeans_assign_kernel(const __grid_constant__ CUtensorMap map_codes,
                     const __grid_constant__ CUtensorMap map_cn,
                     const float* __restrict__ scale,
                     const float* __restrict__ offset,
                     const float* __restrict__ inv_norm,
                     const float* __restrict__ csum,
                     int32_t* __restrict__ cid, int N, int D, int K,
                     int stages, int stage_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;                              // stages x stage_bytes
  uint8_t* codes_s = smem + stages * stage_bytes;    // RESIDENT: 128 x D
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      codes_s + (RESIDENT ? A_ROWS * D : 0));
  uint64_t* full = bars;
  uint64_t* empty = bars + A_MAX_STAGES;
  uint64_t* codes_full = bars + 2 * A_MAX_STAGES;

  const int nks = D / 16;                 // k-steps of 16 dims
  const int nsl = (nks + 3) / 4;          // 64-dim slices
  const int total = ((K + A_CENT - 1) / A_CENT) * nsl;
  const int row0 = blockIdx.x * A_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], A_CONSUMER_WARPS);
    }
    mbar_init(codes_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= A_CONSUMER_WARPS) {
    // ---- producer warpgroup: one thread issues every TMA load, the
    // resident codes once, then the cn slices; the rest only give their
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == A_CONSUMER_WARPS && lane == 0) {
      if (RESIDENT) {
        mbar_expect_tx(codes_full, nks * A_CHUNK);
        for (int c = 0; c < nks; ++c)
          tma_load_2d(codes_s + c * A_CHUNK, &map_codes, 16 * c, row0,
                      codes_full);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int g = 0; g < total; ++g) {
        const int t = g / nsl, sl = g % nsl;
        const int nk = min(4, nks - 4 * sl);
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* dst = ring + stage * stage_bytes;
        mbar_expect_tx(&full[stage], A_CN_STAGE + (RESIDENT ? 0 : nk * A_CHUNK));
        tma_load_2d(dst, &map_cn, A_SLICE * sl, A_CENT * t, &full[stage]);
        if (!RESIDENT)
          for (int c = 0; c < nk; ++c)
            tma_load_2d(dst + A_CN_STAGE + c * A_CHUNK, &map_codes,
                        16 * (4 * sl + c), row0, &full[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the
    // tile; this thread rows rloc and rloc + 8, columns 2q, 2q + 1 of each
    // group of 8
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp / 4;
    const int q = lane & 3;
    const int rloc = wg * 64 + (warp % 4) * 16 + (lane >> 2);
    float r_sc[2], r_of[2], r_in[2], best[2];
    int barg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = row0 + rloc + 8 * h;
      const bool live = grow < N;
      r_sc[h] = live ? scale[grow] : 0.f;
      r_of[h] = live ? offset[grow] : 0.f;
      r_in[h] = live ? inv_norm[grow] : 0.f;
      best[h] = -INFINITY;
      barg[h] = 0;
    }

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a_even[4][4], a_odd[4][4];
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t codes_u = smem_u32(codes_s);
    int stage = 0, sl = 0, k0 = 0;
    uint32_t phase = 0;

    // slice g's four wgmmas from `cur`, and slice g + 1 widened into `next`
    // while they run. Two register sets, so no copy and no register reuse
    // inside a wgmma's flight. A step past the last slice (`live` false,
    // for an odd count) multiplies zero fragments: it adds exactly 0.
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&next)[4][4], int g,
                    bool live) {
      const uint32_t stage_s = ring_s + stage * stage_bytes;
      if (live) mbar_wait(&full[stage], phase);
      const uint64_t desc = sw128_desc(stage_s);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16(acc, cur[kk], desc + 2 * kk,
                         (!live || sl > 0 || kk > 0) ? 1u : 0u);
      wgmma_commit();
      int nstage = stage + 1;
      uint32_t nphase = phase;
      if (nstage == stages) {
        nstage = 0;
        nphase ^= 1;
      }
      const bool more = g + 1 < total;
      const int nsl2 = sl + 1 < nsl ? sl + 1 : 0;
      if (!RESIDENT && more) mbar_wait(&full[nstage], nphase);
      widen_slice(next,
                  RESIDENT ? codes_u + 4 * nsl2 * A_CHUNK
                           : ring_s + nstage * stage_bytes + A_CN_STAGE,
                  more ? min(4, nks - 4 * nsl2) : 0, rloc, q);
      wgmma_wait0();
      fence_acc(acc);
      if (!live) return;
      if (lane == 0) mbar_arrive(&empty[stage]);
      stage = nstage;
      phase = nphase;
      if (++sl < nsl) return;
      // the K tile is complete: sims with the plain version's roundings,
      // ((offset * csum) + (scale * dot)) * inv_norm, and the running
      // argmax; columns in increasing k, so a strict > keeps the lowest
#pragma unroll
      for (int j = 0; j < A_CENT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 8 * j + 2 * q + e;
          if (k < K) {
            const float cs = __ldg(csum + k);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = __fmul_rn(
                  __fadd_rn(__fmul_rn(r_of[h], cs),
                            __fmul_rn(r_sc[h], acc[4 * j + 2 * h + e])),
                  r_in[h]);
              if (s > best[h]) {
                best[h] = s;
                barg[h] = k;
              }
            }
          }
        }
      }
      sl = 0;
      k0 += A_CENT;
    };

    if (RESIDENT)
      mbar_wait(codes_full, 0);
    else
      mbar_wait(&full[0], 0);
    widen_slice(a_even, RESIDENT ? codes_u : ring_s + A_CN_STAGE, min(4, nks),
                rloc, q);
    for (int g = 0; g < total; g += 2) {
      step(a_even, a_odd, g, true);
      step(a_odd, a_even, g + 1, g + 1 < total);
    }

    // the four lanes of a row: the larger wins, the lower index on a tie
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, barg[h], off);
        if (ob > best[h] || (ob == best[h] && oa < barg[h])) {
          best[h] = ob;
          barg[h] = oa;
        }
      }
      const int grow = row0 + rloc + 8 * h;
      if (q == 0 && grow < N) cid[grow] = barg[h];
    }
  }
}

// -------------------------------------------------------------- accumulate

// ---- the chunked path (D % 16 == 0): bulk copies of whole rows

constexpr int C_ROWS = 32;     // member rows a ring stage, one producer lane each
constexpr int C_WARPS = 6;     // consumer warps: 192 threads, 4 dims a word
constexpr int C_CONSUMERS = C_WARPS * 32;
constexpr int C_THREADS = C_CONSUMERS + 32;  // + the producer warp
constexpr int C_MAX_STAGES = 8;
constexpr int C_MAX_WORDS = 8;  // words a consumer thread: D <= 6144
// a stage's sidecars: {scale, offset, cid, -} a row, then its edge: {the
// clusters of the members just before and just after the chunk, a bit for
// each row past the first that begins a run, the chunk}
constexpr int C_META = C_ROWS * 16 + 16;
constexpr int C_BARS = 2 * C_MAX_STAGES * 8;

// seg[k] = the first position of the sorted cids that holds an id >= k, for
// k = 0 .. K: position m writes every k in (cid[m - 1], cid[m]], with -1
// before the first position and K after the last, ids clamped to [-1, K]
__global__ void accumulate_segments_kernel(const int32_t* __restrict__ scid,
                                           int N, int K,
                                           int32_t* __restrict__ seg) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m > N) return;
  if (m == 0) seg[K + 1] = 0;  // the chunk counter
  const int prev = m == 0 ? -1 : min(max(scid[m - 1], -1), K);
  const int cur = m == N ? K : min(max(scid[m], -1), K);
  for (int k = prev + 1; k <= cur; ++k) seg[k] = m;
}

template <int WORDS>
__global__ void __launch_bounds__(C_THREADS)
accumulate_chunks_kernel(const int8_t* __restrict__ codes,
                         const float* __restrict__ scale,
                         const float* __restrict__ offset,
                         const int64_t* __restrict__ order,
                         const int32_t* __restrict__ scid,
                         int32_t* __restrict__ seg,
                         float* __restrict__ sums, float* __restrict__ part,
                         int D, int K, int chunk_rows, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int stage_bytes = C_ROWS * D;
  uint8_t* ring = smem;
  uint8_t* meta = smem + stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + stages * C_META);
  uint64_t* empty = full + C_MAX_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the positions whose cid lies in [0, K), cut into chunks of chunk_rows
  const int v0 = seg[0], v1 = seg[K];
  const int n_chunks = (v1 - v0 + chunk_rows - 1) / chunk_rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp == C_WARPS) {
    // ---- producer warp: lane i takes member i of a stage. It reads the
    // member's row number, cluster and sidecars, then asks for the whole
    // row. It takes its chunks from a counter, so that no block waits on a
    // slower one's share; after the last it sends one stage that names
    // chunk -1. The rows are read once: they leave L2 first, which keeps the
    // sidecars' sectors there for the seven other rows that share each
    const uint64_t policy = l2_evict_first();
    auto next_chunk = [&]() {
      return __shfl_sync(0xffffffffu, lane == 0 ? atomicAdd(seg + K + 1, 1) : 0, 0);
    };
    for (int chunk = next_chunk();; chunk = next_chunk()) {
      const bool stop = chunk >= n_chunks;
      const int lo = v0 + chunk * chunk_rows;
      const int hi = stop ? lo + 1 : min(lo + chunk_rows, v1);
      for (int m0 = lo; m0 < hi; m0 += C_ROWS) {
        const int cnt = stop ? 0 : min(C_ROWS, hi - m0);
        const bool live = lane < cnt;
        int64_t row = 0;
        int c = -1;
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
          row = order[m0 + lane];
          c = scid[m0 + lane];
          m.x = scale[row];
          m.y = offset[row];
          m.z = __int_as_float(c);
        }
        // the stage's edge: the clusters just before and after the chunk (no
        // valid id is -1), the rows past the first that begin a run, and the
        // chunk
        int4 edge = make_int4(-1, -1, 0, stop ? -1 : chunk);
        const int up = __shfl_up_sync(0xffffffffu, c, 1);
        edge.z = (int)__ballot_sync(0xffffffffu, live && lane > 0 && c != up);
        if (m0 == lo && lane == 0 && !stop) {
          if (lo > v0) edge.x = scid[lo - 1];
          if (hi < v1) edge.y = scid[hi];
        }
        mbar_wait(&empty[stage], phase ^ 1);
        if (live)
          bulk_load_1d(ring + stage * stage_bytes + lane * D, codes + row * D, D,
                       &full[stage], policy);
        float4* ms = reinterpret_cast<float4*>(meta + stage * C_META);
        if (live) ms[lane] = m;
        if (lane == 0) *reinterpret_cast<int4*>(ms + C_ROWS) = edge;
        __syncwarp();
        if (lane == 0) mbar_expect_tx(&full[stage], cnt * D);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (stop) break;
    }
  } else {
    // ---- consumers: thread t owns words t, t + 192, ... (4 dims each) of
    // every member row of a chunk, added in the sorted order
    const int tid = threadIdx.x;
    // a thread whose words lie past D adds word 0 again and stores nothing
    int off[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      off[w] = 4 * (tid + w * C_CONSUMERS) < D ? 4 * (tid + w * C_CONSUMERS) : 0;
    // a run's sum and its Kahan compensation
    float run[WORDS][4], comp[WORDS][4];
    auto clear = [&]() {
#pragma unroll
      for (int w = 0; w < WORDS; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) run[w][j] = comp[w][j] = 0.f;
    };
    auto flush = [&](float* dst) {
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        const int i = tid + w * C_CONSUMERS;
        if (4 * i < D)
          reinterpret_cast<float4*>(dst)[i] = make_float4(
              __fsub_rn(run[w][0], comp[w][0]), __fsub_rn(run[w][1], comp[w][1]),
              __fsub_rn(run[w][2], comp[w][2]), __fsub_rn(run[w][3], comp[w][3]));
      }
      clear();
    };
    clear();
    int chunk = 0, m0 = 0, hi = 0;  // m0 >= hi: the next stage opens a chunk
    int cur = -1, prev_c = -1, next_c = -1;
    bool first = true;  // the running sum is the chunk's first run
    for (;;) {
      mbar_wait(&full[stage], phase);
      const uint8_t* src = ring + stage * stage_bytes;
      const float4* ms = reinterpret_cast<const float4*>(meta + stage * C_META);
      const int4 edge = *reinterpret_cast<const int4*>(ms + C_ROWS);
      if (m0 >= hi) {
        chunk = edge.w;
        if (chunk < 0) break;
        m0 = v0 + chunk * chunk_rows;
        hi = min(m0 + chunk_rows, v1);
        prev_c = edge.x;
        next_c = edge.y;
        cur = -1;
        first = true;
      }
      const int cnt = min(C_ROWS, hi - m0);
      const uint32_t cuts = (uint32_t)edge.z;
      for (int r = 0; r < cnt;) {
        // rows r .. e - 1 are one run: `cuts` marks where the next begins
        const uint32_t rest = cuts & (0xfffffffeu << r);
        const int e = rest ? __ffs(rest) - 1 : cnt;
        const int c = __float_as_int(ms[r].z);
        if (c != cur) {
          // a run ended inside the chunk: whole, unless it is the first run
          // and began in an earlier chunk
          if (cur >= 0) {
            flush(first && cur == prev_c ? part + (size_t)(2 * chunk) * D
                                         : sums + (size_t)cur * D);
            first = false;
          }
          cur = c;
        }
        const uint8_t* p = src + r * D;
#pragma unroll(WORDS > 2 ? 1 : 4)
        for (; r < e; ++r, p += D) {
          const float2 so = *reinterpret_cast<const float2*>(ms + r);
#pragma unroll
          for (int w = 0; w < WORDS; ++w) {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(p + off[w]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // the plain version's roundings: offset + (scale * code)
              const float x = (float)(int8_t)(u >> (8 * j));
              const float y =
                  __fsub_rn(__fadd_rn(so.y, __fmul_rn(so.x, x)), comp[w][j]);
              const float t = __fadd_rn(run[w][j], y);
              comp[w][j] = __fsub_rn(__fsub_rn(t, run[w][j]), y);
              run[w][j] = t;
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
      m0 += C_ROWS;
      // the chunk's last run: a partial sum if its cluster began before the
      // chunk (then it is also the first run) or goes on after it
      if (m0 >= hi) {
        const bool partial = (first && cur == prev_c) || cur == next_c;
        flush(partial ? part + (size_t)(2 * chunk + (first ? 0 : 1)) * D
                      : sums + (size_t)cur * D);
      }
    }
  }
}

// One block a cluster: its count; zeros where it is empty; where it spans
// chunks c0 .. c1, its partial sums added in chunk order, in f64. Chunk c0's
// piece is that chunk's last run (slot 2 c0 + 1) unless the cluster begins
// with the chunk; every later piece is a chunk's first run (slot 2 c)
__global__ void __launch_bounds__(C_CONSUMERS)
accumulate_finish_kernel(const int32_t* __restrict__ seg,
                         const float* __restrict__ part,
                         float* __restrict__ sums, float* __restrict__ counts,
                         int D, int K, int chunk_rows) {
  const int k = blockIdx.x;
  const int v0 = seg[0], s = seg[k], e = seg[k + 1];
  if (threadIdx.x == 0) counts[k] = (float)(e - s);
  float4* out = reinterpret_cast<float4*>(sums + (size_t)k * D);
  if (e == s) {
    for (int i = threadIdx.x; 4 * i < D; i += C_CONSUMERS)
      out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int c0 = (s - v0) / chunk_rows, c1 = (e - 1 - v0) / chunk_rows;
  if (c0 == c1) return;  // the chunk wrote the whole sum
  const int head = s > v0 + c0 * chunk_rows ? 1 : 0;
  for (int i = threadIdx.x; 4 * i < D; i += C_CONSUMERS) {
    double a0 = 0., a1 = 0., a2 = 0., a3 = 0.;
    for (int c = c0; c <= c1; ++c) {
      const size_t slot = 2 * (size_t)c + (c == c0 ? head : 0);
      const float4 p = reinterpret_cast<const float4*>(part + slot * D)[i];
      a0 += p.x;
      a1 += p.y;
      a2 += p.z;
      a3 += p.w;
    }
    out[i] = make_float4((float)a0, (float)a1, (float)a2, (float)a3);
  }
}

// ---- the plain-load path (any D): one block a (cluster, 128 dims)

constexpr int S_DIMS = 128;   // dims per block, 4 per lane
constexpr int S_WARPS = 8;
constexpr int S_THREADS = S_WARPS * 32;
constexpr int S_UNROLL = 4;   // member rows in flight per warp

template <bool VEC>
__global__ void __launch_bounds__(S_THREADS)
accumulate_loads_kernel(const int8_t* __restrict__ codes,
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
  if (N <= 0 || D <= 0 || K <= 0 || D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int budget = SMEM_MAX - A_SMEM_SLACK;
  const int codes_bytes = A_ROWS * D;
  const bool resident = codes_bytes + 2 * A_CN_STAGE <= budget;
  const int stage_bytes = resident ? A_CN_STAGE : A_CN_STAGE + 4 * A_CHUNK;
  int stages = A_MAX_STAGES;
  if (resident) stages = min(A_MAX_STAGES, (budget - codes_bytes) / A_CN_STAGE);
  const int smem = 1024 + stages * stage_bytes + (resident ? codes_bytes : 0) +
                   (2 * A_MAX_STAGES + 1) * 8;
  CUtensorMap map_codes, map_cn;
  if (!make_map(&map_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, N, D,
                A_ROWS, 16, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_cn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cn, K, D, A_CENT,
                A_SLICE, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + A_ROWS - 1) / A_ROWS);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(R)                                                          \
  do {                                                                        \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        kmeans_assign_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        smem);                                                                \
    if (e != cudaSuccess) return (int)e;                                      \
    kmeans_assign_kernel<R><<<grid, A_THREADS, smem, st>>>(                   \
        map_codes, map_cn, static_cast<const float*>(scale),                  \
        static_cast<const float*>(offset),                                    \
        static_cast<const float*>(inv_norm), static_cast<const float*>(csum), \
        static_cast<int32_t*>(cid), N, D, K, stages, stage_bytes);            \
  } while (0)
  if (resident)
    VS_LAUNCH(true);
  else
    VS_LAUNCH(false);
#undef VS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int vs_kmeans_accumulate_loads(const void* codes,
                                          const void* scale_s,
                                          const void* offset_s,
                                          const void* order, const void* seg,
                                          void* sums, void* counts, int D,
                                          int K, void* stream) {
  if (D <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, (D + S_DIMS - 1) / S_DIMS);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VS_LAUNCH(V)                                                          \
  accumulate_loads_kernel<V><<<grid, S_THREADS, 0, st>>>(                    \
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

// The chunked accumulate: the segment table, the chunk sums, the partials'
// sum. `order` (int64) and `scid` (int32) are the stable sort of cid and its
// sorted values; `seg` (int32 [K + 2]) and `part` (f32 [2 * ceil(N /
// chunk_rows), D]) are scratch. stages 0 takes the rule's ring depth.
extern "C" int vs_kmeans_accumulate(const void* codes, const void* scale,
                                    const void* offset, const void* order,
                                    const void* scid, void* seg, void* part,
                                    void* sums, void* counts, int N, int D,
                                    int K, int chunk_rows, int stages,
                                    void* stream) {
  const int words = (D / 4 + C_CONSUMERS - 1) / C_CONSUMERS;
  if (N < 0 || D <= 0 || K <= 0 || D % 16 != 0 || words > C_MAX_WORDS ||
      chunk_rows <= 0 || chunk_rows % C_ROWS != 0 || stages < 0 ||
      stages > C_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  accumulate_segments_kernel<<<N / 256 + 1, 256, 0, st>>>(
      static_cast<const int32_t*>(scid), N, K, static_cast<int32_t*>(seg));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if (N > 0) {
    const int stage_smem = C_ROWS * D + C_META;
    if (stages == 0) {
      // three blocks an SM where a ring of two stages or more fits in a
      // third of its shared memory, else the deepest ring up to two stages
      stages = (SMEM_MAX / 3 - 1024 - C_BARS) / stage_smem;
      if (stages < 2) stages = min(2, (SMEM_MAX - 1024 - C_BARS) / stage_smem);
      stages = min(stages, C_MAX_STAGES);
    }
    const int smem = stages * stage_smem + C_BARS;
    if (stages < 1 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    using Kernel = void (*)(const int8_t*, const float*, const float*,
                            const int64_t*, const int32_t*, int32_t*, float*,
                            float*, int, int, int, int);
    Kernel fn = words <= 1   ? accumulate_chunks_kernel<1>
                : words <= 2 ? accumulate_chunks_kernel<2>
                : words <= 4 ? accumulate_chunks_kernel<4>
                             : accumulate_chunks_kernel<8>;
    int dev = 0, sms = 0, blocks = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fn, C_THREADS, smem)) != cudaSuccess)
      return (int)e;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    const int max_chunks = (N + chunk_rows - 1) / chunk_rows;
    fn<<<min(max_chunks, blocks * sms), C_THREADS, smem, st>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
        static_cast<const float*>(offset), static_cast<const int64_t*>(order),
        static_cast<const int32_t*>(scid), static_cast<int32_t*>(seg),
        static_cast<float*>(sums), static_cast<float*>(part), D, K, chunk_rows,
        stages);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  accumulate_finish_kernel<<<K, C_CONSUMERS, 0, st>>>(
      static_cast<const int32_t*>(seg), static_cast<const float*>(part),
      static_cast<float*>(sums), static_cast<float*>(counts), D, K, chunk_rows);
  return (int)cudaGetLastError();
}
