// Sparse hint delta dH = (NEW - OLD) @ A_J mod 2^32 as ONE product on the
// u8 limb tile, and the exact u32 add that folds dH into the hint.
//
// Replaces the Pallas branch of repro/kernels/ops.py delta_gemm (:184,
// :204-206), which runs modmatmul_pallas twice on the TPU (NEW @ A_J and
// OLD @ A_J, each through the int8 MXU with four u8 limbs of A_J) and
// subtracts the two products.  Here the subtraction moves into the right
// operand:
//
//     NEW.A - OLD.A = [NEW | OLD] . [A ; (0 - A) mod 2^32]   (mod 2^32),
//
// both halves u8 against u32, so the contraction 2J runs on limb_tile.cuh's
// limb_gemm_kernel<N, false, true> as D.Q does and dH is written once.
// A limb sum is at most 255 * 255 * 2J, below 2^31 while 2J <= 32,768; past
// that the tile's later contraction chunks are added in u32.  dH is bitwise
// the TPU's: the same ring element, computed exactly.
//
// Bound on this card: dH is a dense (m, k) u32 matrix the size of the hint
// (3.7 GB at m = 902,656, k = 1024) while J is a few percent of the
// clusters, so writing dH bounds it at small J (one 128-byte stage a tile:
// the epilogue is the kernel) and the int8 tensor cores at large J (8 limb
// MACs a MAC: 1.9 10^12 at J = 256).  The tile keeps both near their rate:
// wgmma on u8 limbs, TMA for both operands, dH written once.  Where the
// whole contraction is one 128-byte stage (2J <= 128, packed) the epilogue
// is the kernel, and from the registers wgmma's layout writes dH at 1.27
// TB/s on an H100; there dH goes out through the tile's staged epilogue in
// whole 16-byte words instead.
//
// The left operand reaches the tile one of two ways (the caller chooses):
//   * two maps (J % 16 == 0, NEW and OLD 16-byte aligned): stages below
//     sj = ceil(J/128) read NEW, the rest OLD, each zero-filled by TMA past
//     J; the contraction is laid out as [NEW | 0 | OLD], OLD at 128 sj, and
//     the planes to match, so nothing is copied;
//   * packed (any J): delta_pack_kernel writes P (m, n2) = [NEW | OLD | 0],
//     n2 = 16 ceil(2J/16), so the row stride suits TMA whatever J is, and
//     at 2J <= 128 the contraction is one stage where two maps make two.
//     At J = 256 the pack costs 0.33 ms beside a 3.4 ms product.
// The prep (limb_planes_kernel) writes the limb planes of [A ; 0 - A] with
// the negation in uint32 (0 - 0x80000000 = 0x80000000, 0 - 0 = 0).
//
// add_delta_u32 computes D = H + D elementwise on u32 words, writing into
// dH's buffer: the hint is never written because in-flight decodes still
// read it.  No int64 temporaries.  It is bound by bytes (two words read,
// one written); where both bases are 16-byte aligned each thread keeps four
// 16-byte loads of each operand in flight with streaming cache hints, and
// the grid covers the array in one pass; otherwise one word at a time.
//
// Layout: NEW, OLD (m, J) u8 row-major; A (J, k) and C (m, k) u32 row-major,
// held by the caller as int32 tensors with the same bits.  64-bit indexing.

#include "limb_tile.cuh"

namespace {

// P (m, n2) = [NEW | OLD | 0]: one 16-byte chunk of P a thread; VEC where
// J % 16 == 0 and both bases are 16-byte aligned (16-byte loads), else byte
// loads
template <bool VEC>
__global__ void __launch_bounds__(256)
delta_pack_kernel(const uint8_t* __restrict__ NEW,
                  const uint8_t* __restrict__ OLD, uint8_t* __restrict__ P,
                  int64_t m, int64_t j, int64_t n2) {
  const int64_t chunks = n2 / 16;
  const int64_t total = m * chunks;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / chunks;
    const int64_t c0 = (i % chunks) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (VEC) {
      if (c0 < j) v = *reinterpret_cast<const uint4*>(NEW + r * j + c0);
      else if (c0 < 2 * j) v = *reinterpret_cast<const uint4*>(OLD + r * j + c0 - j);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int64_t c = c0 + x;
        uint32_t byte = 0u;
        if (c < j) byte = NEW[r * j + c];
        else if (c < 2 * j) byte = OLD[r * j + c - j];
        w[x / 4] |= byte << (8 * (x % 4));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(P + r * n2 + c0) = v;
  }
}

int launch_pack(const void* NEW, const void* OLD, void* P, int64_t m,
                int64_t j, cudaStream_t stream) {
  const int64_t n2 = (2 * j + 15) / 16 * 16;
  const int64_t total = m * (n2 / 16);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (total + 255) / 256;
  if (blocks > 16 * static_cast<int64_t>(sms)) blocks = 16 * sms;
  const bool vec = j % 16 == 0 && reinterpret_cast<uintptr_t>(NEW) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(OLD) % 16 == 0;
  const auto* nw = static_cast<const uint8_t*>(NEW);
  const auto* od = static_cast<const uint8_t*>(OLD);
  auto* p = static_cast<uint8_t*>(P);
  if (vec)
    delta_pack_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        nw, od, p, m, j, n2);
  else
    delta_pack_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        nw, od, p, m, j, n2);
  return static_cast<int>(cudaGetLastError());
}

// dH (m, k) = [NEW | OLD] . [A ; 0 - A]: packed into P first where P is
// given, else the two maps
template <int N>
int launch_delta(const void* NEW, const void* OLD, void* P, const void* A,
                 void* S, void* C, int64_t m, int64_t j, int64_t k,
                 cudaStream_t stream) {
  using G = Cfg<N>;
  const int64_t b_pad = (k + G::BNO - 1) / G::BNO * G::BNO;
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map_d{}, map_d2{}, map_s{};
  int64_t n, neg_at;
  int split;
  if (P != nullptr) {
    const int packed = launch_pack(NEW, OLD, P, m, j, stream);
    if (packed != 0) return packed;
    n = (2 * j + 15) / 16 * 16;
    neg_at = j;
    split = NO_SPLIT;
    if (!encode_u8(&map_d, P, m, n, n, LBM)) return ERR_ENCODE;
    map_d2 = map_d;
  } else {
    if (!d_by_tma(NEW, j) || !d_by_tma(OLD, j)) return ERR_ALIGN;
    split = static_cast<int>((j + LBK - 1) / LBK);
    neg_at = static_cast<int64_t>(split) * LBK;
    n = neg_at + j;
    if (!encode_u8(&map_d, NEW, m, j, j, LBM)) return ERR_ENCODE;
    if (!encode_u8(&map_d2, OLD, m, j, j, LBM)) return ERR_ENCODE;
  }
  const int64_t n16 = (n + 15) / 16 * 16;
  const int prep = launch_planes<N>(A, S, j, k, n16, neg_at, 1, stream);
  if (prep != 0) return prep;
  if (!encode_u8(&map_s, S, 4 * b_pad, n16, n16, N)) return ERR_ENCODE;

  TileArgs a{};
  a.d = static_cast<const uint8_t*>(P != nullptr ? P : NEW);
  a.c = static_cast<uint32_t*>(C);
  a.m = m;
  a.n = n;
  a.b = k;
  a.n_ct = b_pad / G::BNO;
  a.n_tiles = (m + LBM - 1) / LBM * a.n_ct;
  a.tma_all = 1;
  a.split = split;
  // one 128-byte stage a tile: the epilogue is the kernel, so it goes
  // through shared memory (1.92 against 2.89 ms at 902,656 x 51 x 1024 on an
  // H100); with more stages the direct stores are faster (3.42 against
  // 3.61 ms at J = 256)
  if (n <= LBK) return launch_tile<N, false, true>(map_d, map_d2, map_s, a, stream);
  return launch_tile<N, false, false>(map_d, map_d2, map_s, a, stream);
}

constexpr int ADD_THREADS = 256;
constexpr int ADD_UNROLL = 4;      // 16-byte words of each operand in flight

// D = H + D on 16-byte vectors: each thread loads ADD_UNROLL vectors of H
// and of D before it adds and stores, and the grid covers the array (one
// pass, no grid stride).  Block 0 adds the 0-3 words past the last vector.
__global__ void __launch_bounds__(ADD_THREADS)
add_u32_vec_kernel(const uint32_t* __restrict__ H, uint32_t* __restrict__ D,
                   int64_t n) {
  const int64_t n4 = n / 4;
  const uint4* h4 = reinterpret_cast<const uint4*>(H);
  uint4* d4 = reinterpret_cast<uint4*>(D);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ADD_THREADS * ADD_UNROLL
                     + threadIdx.x;
  uint4 h[ADD_UNROLL];
  uint4 d[ADD_UNROLL];
#pragma unroll
  for (int u = 0; u < ADD_UNROLL; ++u) {
    const int64_t i = i0 + u * ADD_THREADS;
    if (i < n4) {
      h[u] = __ldcs(h4 + i);                       // streamed: read once
      d[u] = __ldcs(d4 + i);
    }
  }
#pragma unroll
  for (int u = 0; u < ADD_UNROLL; ++u) {
    const int64_t i = i0 + u * ADD_THREADS;
    if (i < n4) {
      uint4 v = d[u];
      v.x += h[u].x;                               // each wraps mod 2^32
      v.y += h[u].y;
      v.z += h[u].z;
      v.w += h[u].w;
      __stcs(d4 + i, v);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    D[4 * n4 + threadIdx.x] += H[4 * n4 + threadIdx.x];
  }
}

// D = H + D one word at a time: a base off the 16-byte alignment
__global__ void __launch_bounds__(ADD_THREADS)
add_u32_kernel(const uint32_t* __restrict__ H, uint32_t* __restrict__ D,
               int64_t n) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * ADD_THREADS * ADD_UNROLL
                     + threadIdx.x;
#pragma unroll
  for (int u = 0; u < ADD_UNROLL; ++u) {
    const int64_t i = i0 + u * ADD_THREADS;
    if (i < n) D[i] += H[i];
  }
}

}  // namespace

// C (m, k) = (NEW - OLD) (m, j) . A (j, k) mod 2^32 on the limb tile, with
// n_stacked = N from the caller's limb plan of k.  S is the caller's u8
// scratch for the planes of [A ; 0 - A]: 4 b_pad rows of n16 bytes, n16 =
// 16 ceil((2j)/16) with P (the caller's (m, n16) u8 pack of [NEW | OLD | 0])
// and 16 ceil((128 ceil(j/128) + j)/16) without it (then j % 16 == 0 and
// NEW, OLD 16-byte aligned, else ERR_ALIGN).
extern "C" int delta_gemm_u8(const void* NEW, const void* OLD, void* P,
                             const void* A, void* S, void* C, int64_t m,
                             int64_t j, int64_t k, int64_t n_stacked,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0 || k == 0) return 0;
  if (j == 0) {
    cudaMemsetAsync(C, 0, static_cast<size_t>(m * k) * 4, st);
    return static_cast<int>(cudaGetLastError());
  }
  switch (n_stacked) {
    case 32: return launch_delta<32>(NEW, OLD, P, A, S, C, m, j, k, st);
    case 64: return launch_delta<64>(NEW, OLD, P, A, S, C, m, j, k, st);
    case 128: return launch_delta<128>(NEW, OLD, P, A, S, C, m, j, k, st);
    case 256: return launch_delta<256>(NEW, OLD, P, A, S, C, m, j, k, st);
    default: return ERR_WIDTH;
  }
}

// The pack alone, P (m, 16 ceil(2j/16)) = [NEW | OLD | 0], as delta_gemm_u8
// writes it
extern "C" int delta_pack_u8(const void* NEW, const void* OLD, void* P,
                             int64_t m, int64_t j, void* stream) {
  if (m == 0 || j == 0) return 0;
  return launch_pack(NEW, OLD, P, m, j, static_cast<cudaStream_t>(stream));
}

extern "C" int add_delta_u32(const void* H, void* D, int64_t n, void* stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(H) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(D) % 16 == 0);
  const int64_t items = vec ? n / 4 : n;
  int64_t blocks = (items + ADD_THREADS * ADD_UNROLL - 1) /
                   (ADD_THREADS * ADD_UNROLL);
  if (blocks < 1) blocks = 1;                      // the tail of n < 4 words
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    add_u32_vec_kernel<<<static_cast<unsigned>(blocks), ADD_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(H), static_cast<uint32_t*>(D), n);
  } else {
    add_u32_kernel<<<static_cast<unsigned>(blocks), ADD_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(H), static_cast<uint32_t*>(D), n);
  }
  return static_cast<int>(cudaGetLastError());
}
