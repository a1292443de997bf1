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
//   2. limb_gemm_kernel<N, false, false> (limb_tile.cuh, the tile
//      delta_gemm.cu and bucketed_modmatmul.cu run too): a persistent CTA
//      per SM walks (128-row band of D, column tile) with the column tiles
//      of a band back to back, so a band is read from HBM once and from L2
//      for its other tiles (the hint has 16 of them; the answer at b <= 64
//      one).  One producer warpgroup fills a ring of 4-8 stages (D 128 x 128
//      bytes, scratch N x 128 bytes, both in the 128-byte swizzle) on
//      mbarriers; two consumer warpgroups run wgmma.m64nNk32.s32.u8.u8 on 64
//      rows each, N = 4 BNO stacked columns (N = 32, 64, 128 or 256, chosen
//      by the caller from b: BNO >= 8 keeps a thread's four limbs of an
//      output together).  The epilogue forms sum_l acc_l << 8l in registers
//      and writes only u32, straight from the registers.
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

#include "limb_tile.cuh"

namespace {

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
    const cudaError_t prep = cudaGetLastError();
    if (prep != cudaSuccess) return static_cast<int>(prep);
  } else {
    const int prep = launch_planes<N>(R, S, n, b, n16, NO_NEG, 1, stream);
    if (prep != 0) return prep;
  }

  if (encoder() == nullptr) return ERR_NO_ENCODER;
  const bool tma_d = d_by_tma(D, n);
  CUtensorMap map_d{}, map_s{};
  if (tma_d && !encode_u8(&map_d, D, m, n, n, LBM)) return ERR_ENCODE;
  if (!encode_u8(&map_s, S, 4 * b_pad, n16, n16, N)) return ERR_ENCODE;
  if (!tma_d) map_d = map_s;                        // unused on that path

  TileArgs a{};
  a.d = static_cast<const uint8_t*>(D);
  a.c = static_cast<uint32_t*>(C);
  a.m = m;
  a.n = n;
  a.b = b;
  a.n_ct = b_pad / G::BNO;
  a.n_tiles = (m + LBM - 1) / LBM * a.n_ct;
  a.tma_all = tma_d ? 1 : 0;
  a.split = NO_SPLIT;
  return launch_tile<N, false, false>(map_d, map_d, map_s, a, stream);
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
