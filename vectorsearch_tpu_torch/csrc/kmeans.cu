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
// zero sums and a zero count. Any K >= 1 and D >= 1; D % 4 == 0 takes
// 4-byte loads, any other D byte loads.
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
