// Exact C = (L @ R) mod 2^32 for an L of uint8 or uint32 and an R of uint32,
// both on Hopper's int8 tensor cores.
//
// modmatmul_u8 replaces the TPU kernel repro/kernels/modmatmul.py (_kernel
// :53, modmatmul_pallas :95): the server's answer D.Q and the offline hint
// D.A.  It keeps that kernel's limb identity and runs it on Hopper's int8
// tensor cores.  D's entries fit one byte (p <= 256); every u32 word of R
// splits into four u8 limbs, R = sum_l R_l 2^(8l), so
//
//     D.R mod 2^32 = sum_l (D.R_l) << 8l   (mod 2^32).
//
// wgmma takes u8 x u8 -> s32 directly, so the TPU's zero point of 128 and
// its rank-1 corrections (needed only because the MXU is s8) are dropped.
// One limb sum is at most 255 * 255 * n, below 2^31 for n <= 32,768: the
// contraction runs in chunks of 32,768 and later chunks are added to C in
// u32, so no sum ever depends on how the s32 accumulator overflows.
//
// Two launches, one entry:
//   1. limb_planes_kernel writes R's four limb planes, stacked and
//      transposed, into a u8 scratch (4 b_pad, n16) that the caller
//      allocates (wgmma wants 8-bit operands K-major).  For each tile of BNO
//      output columns the scratch holds four blocks of BNO rows, limb 0 to
//      3, so the accumulator registers of (row r, column c) for the four
//      limbs sit in the same thread and recombine there.
//   2. limb_gemm_kernel: a persistent CTA per SM walks (128-row band of D,
//      column tile) with the column tiles of a band back to back, so a band
//      is read from HBM once and from L2 for its other tiles (the hint has
//      16 of them; the answer at b <= 64 one).  One producer warpgroup fills
//      a ring of 4-8 stages (D 128 x 128 bytes, scratch N x 128 bytes, both
//      in the 128-byte swizzle) on mbarriers; two consumer warpgroups run
//      wgmma.m64nNk32.s32.u8.u8 on 64 rows each, N = 4 BNO stacked columns
//      (N = 32, 64, 128 or 256, chosen by the caller from b: BNO >= 8 keeps
//      a thread's four limbs of an output together).  The epilogue
//      forms sum_l acc_l << 8l in registers and writes only u32.
//
// D comes in by TMA where its row stride is a multiple of 16 bytes and its
// base 16-byte aligned (every main-path width: n = 128, 256, 1024, 4096);
// otherwise the producer warpgroup loads D's bytes with predicated loads and
// stores them in the same swizzle, into the same ring.  The scratch, whose
// rows are padded to n16 = 16 ceil(n/16), always comes by TMA.  Ragged rows
// and columns are masked; TMA fills what lies outside D and the scratch with
// zeros.
//
// Bound on this card: the hint (b = 1024) by the int8 tensor cores, the
// answer (b <= 64) by reading D once.
//
// modmatmul_u32 (A.S and H.S, which the JAX package leaves to XLA: lwe.py
// :141, :147, :179) runs on the same limb tile.  An int32-held u32 matrix
// H (m, k) is, read as bytes, a little-endian u8 matrix H8 (m, 4k) whose
// byte 4 kk + i is limb i of word kk.  For each shift j = 0..3 the prep
// kernel (shift_planes_kernel) stacks a u8 plane P_j (4k, b) with
// P_j[4 kk + i][c] = byte (j - i) of R[kk][c] where i <= j and 0 where
// i > j, so
//
//     H.R mod 2^32 = sum_j (H8.P_j) << 8j   (mod 2^32),
//
// the terms with i + l >= 4 vanishing mod 2^32.  That is the recombination
// the limb tile already does, so H8 goes through limb_gemm_kernel<N> as D
// does: the read of H sets the time (C's H.S is, byte for byte, the shape
// of C's answer).  A row stride 4k that is not a multiple of 16 bytes, or a
// base off 16 bytes (a row-slice view), takes the predicated producer.
//
// Layout: L (m, n) row-major, R (n, b) row-major, C (m, b) row-major; all
// u32 data is the int32 tensor with the same bits.  64-bit indexing: the
// production DB has m*n > 2^31.

#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums; the encoder is
#include <cuda_runtime.h>   // looked up at run time, so no -lcuda

namespace {

// ---------------------------------------------------------------------------
// the limb tile: u8 x u8 on wgmma (modmatmul_u8 and modmatmul_u32)
// ---------------------------------------------------------------------------

constexpr int LBM = 128;            // rows of D per tile: two warpgroups of 64
constexpr int LBK = 128;            // contraction bytes per stage (one swizzle row)
constexpr int WK = 32;              // contraction of one wgmma
constexpr int CHUNK_STAGES = 32768 / LBK;   // limb sums < 2^31 within a chunk
constexpr int LTHREADS = 384;       // consumers 0-255, producer 256-383
constexpr int SMEM_BUDGET = 196608;

template <int N>
struct Cfg {
  static constexpr int BNO = N / 4;                  // output columns per tile
  static constexpr int A_BYTES = LBM * LBK;
  static constexpr int B_BYTES = N * LBK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE_BYTES < 8 ? SMEM_BUDGET / STAGE_BYTES : 8;
  // + 1 KB to align the ring to the 1024-byte swizzle atom, + the barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a wait that lasts 10 s is a deadlock: trap, so the launch fails instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int32_t c0,
                                            int32_t c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// K-major operand in the 128-byte swizzle: 8-row atoms of 1024 bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // LBO (unused when swizzled)
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // SBO: next 8-row atom
         (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

// keeps the compiler from moving register reads across the wait that ends
// the asynchronous wgmma owning the registers
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int N>
struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(uint32_t (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(uint32_t (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(uint32_t (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(uint32_t (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// C[rows, cols] = (or +=) sum_l acc_l << 8l, u32, masked to (m, b)
template <int N>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[N / 2],
                                           uint32_t* __restrict__ C, int64_t m,
                                           int64_t b, int64_t row, int64_t col,
                                           bool accumulate) {
  constexpr int G = Cfg<N>::BNO / 8;                 // 8-column groups a limb
  const bool pairs = (b % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = row + 8 * i;
    if (r >= m) continue;
    uint32_t* crow = C + r * b;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t c = col + 8 * g;
      uint32_t v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t s = 0u;
#pragma unroll
        for (int l = 0; l < 4; ++l) s += acc[(l * G + g) * 4 + i * 2 + j] << (8 * l);
        v[j] = s;                                    // wraps mod 2^32
      }
      if (accumulate) {
        if (c < b) v[0] += crow[c];
        if (c + 1 < b) v[1] += crow[c + 1];
      }
      if (pairs && c + 1 < b) {
        *reinterpret_cast<uint2*>(crow + c) = make_uint2(v[0], v[1]);
      } else {
        if (c < b) crow[c] = v[0];
        if (c + 1 < b) crow[c + 1] = v[1];
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(LTHREADS, 1)
limb_gemm_kernel(const __grid_constant__ CUtensorMap map_d,
                 const __grid_constant__ CUtensorMap map_s,
                 const uint8_t* __restrict__ D, uint32_t* __restrict__ C,
                 int64_t m, int64_t n, int64_t b, int64_t n_ct,
                 int64_t n_tiles, int tma_d) {
  using G = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + G::STAGES * G::STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * G::STAGES;
  const int kb_n = static_cast<int>((n + LBK - 1) / LBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);                // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - 256;
    if (tma_d && pt != 0) return;                    // TMA needs one thread
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t band = t / n_ct;
      const int64_t ct = t % n_ct;
      for (int kb = 0; kb < kb_n; ++kb) {
        const uint32_t sa = ring + stage * G::STAGE_BYTES;
        const uint32_t sb = sa + G::A_BYTES;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        if (tma_d) {
          mbar_expect_tx(full, G::STAGE_BYTES);
          tma_load_2d(sa, &map_d, full, kb * LBK, static_cast<int32_t>(band * LBM));
          tma_load_2d(sb, &map_s, full, kb * LBK, static_cast<int32_t>(ct * N));
        } else {
          // the swizzle TMA would produce: 16-byte chunk c of row r lands at
          // chunk c ^ (r % 8)
          for (int i = pt; i < LBM * (LBK / 16); i += 128) {
            const int r = i / (LBK / 16);
            const int c = i % (LBK / 16);
            const int64_t gr = band * LBM + r;
            const int64_t gk = static_cast<int64_t>(kb) * LBK + c * 16;
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (gr < m) {
              const uint8_t* src = D + gr * n + gk;
#pragma unroll
              for (int x = 0; x < 16; ++x) {
                if (gk + x < n) w[x / 4] |= static_cast<uint32_t>(src[x]) << (8 * (x % 4));
              }
            }
            const uint32_t dst = sa + r * LBK + ((c ^ (r & 7)) << 4);
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                         :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                         : "memory");
          }
          // generic-proxy stores, then the async proxy (wgmma) reads them
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
          if (pt == 0) {
            mbar_expect_tx(full, G::B_BYTES);
            tma_load_2d(sb, &map_s, full, kb * LBK, static_cast<int32_t>(ct * N));
          }
        }
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---------------- two consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;                // rows 64 wg .. 64 wg + 63
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    uint32_t acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0u;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t band = t / n_ct;
      const int64_t ct = t % n_ct;
      const int64_t row = band * LBM + wg * 64 + warp * 16 + lane / 4;
      const int64_t col = ct * G::BNO + 2 * (lane % 4);
      int prev = -1;
      for (int kb = 0; kb < kb_n; ++kb) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = ring + stage * G::STAGE_BYTES + wg * 64 * LBK;
        const uint32_t sb = ring + stage * G::STAGE_BYTES + G::A_BYTES;
        const int fresh = (kb % CHUNK_STAGES) == 0;
        // the accumulators are touched only by wgmma until wait_group 0:
        // any other use makes ptxas wait for every product in flight
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < LBK / WK; ++kk) {
          Wgmma<N>::run(acc, sw128_desc(sa + kk * WK), sw128_desc(sb + kk * WK),
                        (fresh && kk == 0) ? 0 : 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (prev >= 0) {
          // the previous stage's products are done: hand its buffers back
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1u;
        }
        if ((kb + 1) % CHUNK_STAGES == 0 || kb + 1 == kb_n) {
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs(acc);
          mbar_arrive(empty0 + 8 * prev);
          prev = -1;
          store_tile<N>(acc, C, m, b, row, col, kb >= CHUNK_STAGES);
        }
      }
    }
  }
}

constexpr int PT = 64;                               // R tile of the prep kernel

// S[(c / bno) 4 bno + l bno + c % bno][k] = byte l of R[k][c]; zero where
// k >= n or c >= b
__global__ void __launch_bounds__(256)
limb_planes_kernel(const uint32_t* __restrict__ R, uint8_t* __restrict__ S,
                   int64_t n, int64_t b, int64_t n16, int64_t b_pad, int bno) {
  __shared__ uint32_t T[PT][PT + 1];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * PT;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * PT;
  for (int i = threadIdx.x; i < PT * PT; i += 256) {
    const int kk = i / PT;
    const int cc = i % PT;
    const int64_t k = k0 + kk;
    const int64_t c = c0 + cc;
    T[kk][cc] = (k < n && c < b) ? R[k * b + c] : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * PT * (PT / 4); i += 256) {
    const int quad = i % (PT / 4);
    const int rs = i / (PT / 4);
    const int l = rs / PT;
    const int cc = rs % PT;
    const int64_t c = c0 + cc;
    const int64_t k = k0 + 4 * quad;
    if (c >= b_pad || k >= n16) continue;
    uint32_t w = 0u;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      w |= ((T[4 * quad + x][cc] >> (8 * l)) & 0xFFu) << (8 * x);
    }
    const int64_t srow = (c / bno) * 4 * bno + l * bno + c % bno;
    *reinterpret_cast<uint32_t*>(S + srow * n16 + k) = w;
  }
}

// The shift planes of R (k, b) against a u32 left operand read as bytes:
// S[(c / bno) 4 bno + j bno + c % bno][4 kk + i] = byte (j - i) of R[kk][c]
// where i <= j, else 0; zero where kk >= k or c >= b.  The four bytes of
// (j, c, kk) are the low j + 1 bytes of R[kk][c] in reverse order, i.e.
// bswap(R[kk][c]) >> 8 (3 - j): one u32 store each.
__global__ void __launch_bounds__(256)
shift_planes_kernel(const uint32_t* __restrict__ R, uint8_t* __restrict__ S,
                    int64_t k, int64_t b, int64_t n16, int64_t b_pad,
                    int bno) {
  __shared__ uint32_t T[PT][PT + 1];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * PT;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * PT;
  for (int i = threadIdx.x; i < PT * PT; i += 256) {
    const int kk = i / PT;
    const int cc = i % PT;
    const int64_t w = k0 + kk;
    const int64_t c = c0 + cc;
    T[kk][cc] = (w < k && c < b) ? R[w * b + c] : 0u;
  }
  __syncthreads();
  const int64_t words = n16 / 4;
  for (int i = threadIdx.x; i < 4 * PT * PT; i += 256) {
    const int kk = i % PT;                           // consecutive words
    const int rs = i / PT;
    const int j = rs / PT;
    const int cc = rs % PT;
    const int64_t c = c0 + cc;
    const int64_t w = k0 + kk;
    if (c >= b_pad || w >= words) continue;
    const uint32_t v = __byte_perm(T[kk][cc], 0u, 0x0123) >> (8 * (3 - j));
    const int64_t srow = (c / bno) * 4 * bno + j * bno + c % bno;
    *reinterpret_cast<uint32_t*>(S + srow * n16 + 4 * w) = v;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// error codes of this file beside cudaError_t's (all >= 0)
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_ENCODE = -2;
constexpr int ERR_WIDTH = -3;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D u8 map of (rows, cols) with a row stride of `stride` bytes, read in
// boxes of box_rows x 128 bytes in the 128-byte swizzle
bool encode_u8(CUtensorMap* map, const void* base, int64_t rows, int64_t cols,
               int64_t stride, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(LBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                   const_cast<void*>(base), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool d_by_tma(const void* D, int64_t n) {
  return n % 16 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0;
}

// R's planes into S: the limb planes against a u8 D of n bytes a row, or
// (shifts) the shift planes against a u32 L of n / 4 words a row
template <int N>
int launch_limbs(const void* D, const void* R, void* S, void* C, int64_t m,
                 int64_t n, int64_t b, bool shifts, cudaStream_t stream) {
  using G = Cfg<N>;
  const int64_t b_pad = (b + G::BNO - 1) / G::BNO * G::BNO;
  const int64_t n16 = (n + 15) / 16 * 16;
  if (shifts) {
    const dim3 pgrid(static_cast<unsigned>((n16 / 4 + PT - 1) / PT),
                     static_cast<unsigned>((b_pad + PT - 1) / PT));
    shift_planes_kernel<<<pgrid, 256, 0, stream>>>(
        static_cast<const uint32_t*>(R), static_cast<uint8_t*>(S), n / 4, b,
        n16, b_pad, G::BNO);
  } else {
    const dim3 pgrid(static_cast<unsigned>((n16 + PT - 1) / PT),
                     static_cast<unsigned>((b_pad + PT - 1) / PT));
    limb_planes_kernel<<<pgrid, 256, 0, stream>>>(
        static_cast<const uint32_t*>(R), static_cast<uint8_t*>(S), n, b, n16,
        b_pad, G::BNO);
  }
  const cudaError_t prep = cudaGetLastError();
  if (prep != cudaSuccess) return static_cast<int>(prep);

  if (encoder() == nullptr) return ERR_NO_ENCODER;
  const bool tma_d = d_by_tma(D, n);
  CUtensorMap map_d{}, map_s{};
  if (tma_d && !encode_u8(&map_d, D, m, n, n, LBM)) return ERR_ENCODE;
  if (!encode_u8(&map_s, S, 4 * b_pad, n16, n16, N)) return ERR_ENCODE;
  if (!tma_d) map_d = map_s;                        // unused on that path

  const int64_t n_ct = b_pad / G::BNO;
  const int64_t n_tiles = (m + LBM - 1) / LBM * n_ct;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t grid = n_tiles < sms ? n_tiles : sms;
  cudaFuncSetAttribute(limb_gemm_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  limb_gemm_kernel<N><<<static_cast<unsigned>(grid), LTHREADS, G::SMEM,
                        stream>>>(map_d, map_s,
                                  static_cast<const uint8_t*>(D),
                                  static_cast<uint32_t*>(C), m, n, b, n_ct,
                                  n_tiles, tma_d ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// the entries' common part: an empty product, then the width dispatch
int limb_entry(const void* D, const void* R, void* S, void* C, int64_t m,
               int64_t n, int64_t b, int64_t n_stacked, bool shifts,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0 || b == 0) return 0;
  if (n == 0) {
    cudaMemsetAsync(C, 0, static_cast<size_t>(m * b) * 4, st);
    return static_cast<int>(cudaGetLastError());
  }
  switch (n_stacked) {
    case 32: return launch_limbs<32>(D, R, S, C, m, n, b, shifts, st);
    case 64: return launch_limbs<64>(D, R, S, C, m, n, b, shifts, st);
    case 128: return launch_limbs<128>(D, R, S, C, m, n, b, shifts, st);
    case 256: return launch_limbs<256>(D, R, S, C, m, n, b, shifts, st);
    default: return ERR_WIDTH;
  }
}

}  // namespace

// C (m, b) = D (m, n) u8 . R (n, b) u32 mod 2^32 with n_stacked = N stacked
// columns per wgmma (32, 64, 128 or 256; the caller picks it from b).  S is
// the caller's u8 scratch of 4 b_pad rows of n16 bytes for R's limb planes,
// b_pad = b rounded up to a multiple of N / 4.
extern "C" int modmatmul_u8(const void* D, const void* R, void* S, void* C,
                            int64_t m, int64_t n, int64_t b, int64_t n_stacked,
                            void* stream) {
  return limb_entry(D, R, S, C, m, n, b, n_stacked, false, stream);
}

// 1 where the limb kernel reads D (n bytes a row) by TMA, 0 where by
// predicated loads
extern "C" int modmatmul_u8_tma(const void* D, int64_t n) {
  return d_by_tma(D, n) ? 1 : 0;
}

// C (m, b) = L (m, k) u32 . R (k, b) u32 mod 2^32: L read as u8 (m, 4k)
// against R's shift planes, in the caller's scratch S of 4 b_pad rows of
// n16 = 16 ceil(4k / 16) bytes; n_stacked as for modmatmul_u8.
extern "C" int modmatmul_u32(const void* L, const void* R, void* S, void* C,
                             int64_t m, int64_t k, int64_t b,
                             int64_t n_stacked, void* stream) {
  return limb_entry(L, R, S, C, m, 4 * k, b, n_stacked, true, stream);
}
