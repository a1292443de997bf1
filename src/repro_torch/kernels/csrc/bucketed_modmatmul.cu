// Grouped bucketed exact product: for every bucket b, C_b = (D_b @ Q_b) mod 2^32,
// with D_b (m_b, W) uint8, Q_b (W, C) uint32 and C_b (m_b, C) uint32, in ONE
// pass whatever the number of buckets.
//
// Replaces the Pallas branch of repro/kernels/ops.py bucketed_modmatmul (:263),
// which row-pads every bucket to the tallest one, stacks them as (B, m', W) and
// vmaps the limb kernel modmatmul_pallas over the bucket axis (:317-331).  The
// padded rows are read and multiplied there; here they do not exist.
//
// Bound on this card: the batch answer reads every sub-DB once (sum m_b * W
// bytes, 2.5 GB at phase P's 12 buckets) and writes sum m_b * C words; its 4
// int8 limb MACs a MAC are far below the tensor cores' rate at C <= 64.  So
// the design is the one that reads D at the card's rate: the u8 limb tile of
// limb_tile.cuh (TMA ring, wgmma u8 x u8 -> s32, limbs recombined in
// registers), walking every bucket in one persistent launch:
//   1. limb_planes_kernel writes each bucket's limb planes of Q_b, laid out
//      as ref.limb_planes, into one scratch of (B 4 b_pad, W16): bucket b's
//      planes start at row b 4 b_pad, so one tensor map covers them all (one
//      launch, a grid axis over the buckets).
//   2. limb_gemm_kernel<N, true, false> walks the tiles (bucket, 128-row band,
//      column tile) back to back; a CTA finds a tile's bucket by binary search
//      over the groups' tile offsets.  No bucket is padded: each bucket has
//      its own u8 tensor map with rows = m_b, so TMA zero-fills its last band
//      and never reads the next bucket's rows, and the store masks them.  At
//      C <= 16 (a served batch) N = 64 gives one column tile, so each sub-DB
//      byte is read once.  The outputs leave from the registers: a staged
//      epilogue was slower here (0.66 against 0.61 ms at phase K's pass on
//      an H100).  A bucket whose base or W is not a multiple of 16 bytes
//      takes the predicated producer, from its base in the table.
// The table of groups (maps, bases, rows, offsets) is encoded on the host by
// bucketed_modmatmul_groups into a buffer the caller then copies to the card.
//
// Layout: each D_b row-major (m_b, W); Q (B, W, C) row-major; the output is one
// (sum m_b, C) row-major buffer whose rows row_off[b] .. row_off[b+1] are C_b.
// 64-bit indexing throughout: the served sub-DBs hold > 2^31 bytes together.

#include <cstring>

#include "limb_tile.cuh"

namespace {

template <int N>
int launch_grouped(const void* groups, int64_t n_b, int64_t tma_all,
                   const void* Q, void* S, void* C, int64_t n_tiles,
                   int64_t w, int64_t c, cudaStream_t stream) {
  using G = Cfg<N>;
  const int64_t b_pad = (c + G::BNO - 1) / G::BNO * G::BNO;
  const int64_t n16 = (w + 15) / 16 * 16;
  const int prep = launch_planes<N>(Q, S, w, c, n16, NO_NEG, n_b, stream);
  if (prep != 0) return prep;
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map_s{};
  if (!encode_u8(&map_s, S, n_b * 4 * b_pad, n16, n16, N)) return ERR_ENCODE;

  TileArgs a{};
  a.c = static_cast<uint32_t*>(C);
  a.n = w;
  a.b = c;
  a.n_ct = b_pad / G::BNO;
  a.n_tiles = n_tiles;
  a.s_rows = 4 * b_pad;
  a.groups = static_cast<const Group*>(groups);
  a.n_groups = n_b;
  a.tma_all = tma_all ? 1 : 0;
  a.split = NO_SPLIT;
  // the bucket maps come from the table; map_s stands in for the unused two
  return launch_tile<N, true, false>(map_s, map_s, map_s, a, stream);
}

}  // namespace

// Rows of one tile: the wrapper counts each bucket's tiles with it.
extern "C" int bucketed_modmatmul_tile_rows() { return LBM; }

// Bytes of one bucket's entry in the groups table (a multiple of 64).
extern "C" int bucketed_modmatmul_group_bytes() {
  return static_cast<int>(sizeof(Group));
}

// Fill the host buffer `out` with the groups table of n_b buckets of width
// w from `info`, n_b rows of (base pointer, m_b, first output row, first
// tile): a tensor map of D_b where TMA can read it.  Returns how many
// non-empty buckets take the predicated producer, or an error (< 0).
extern "C" int bucketed_modmatmul_groups(void* out, const int64_t* info,
                                         int64_t n_b, int64_t w) {
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  int predicated = 0;
  for (int64_t i = 0; i < n_b; ++i) {
    Group g;
    std::memset(&g, 0, sizeof(g));
    g.d = reinterpret_cast<const uint8_t*>(info[4 * i]);
    g.rows = info[4 * i + 1];
    g.row_off = info[4 * i + 2];
    g.tile_off = info[4 * i + 3];
    g.tma = 1;                                   // an empty bucket has no tile
    if (g.rows > 0) {
      g.tma = d_by_tma(g.d, w) ? 1 : 0;
      if (g.tma && !encode_u8(&g.map, g.d, g.rows, w, w, LBM)) return ERR_ENCODE;
      predicated += g.tma ? 0 : 1;
    }
    std::memcpy(static_cast<uint8_t*>(out) + i * sizeof(Group), &g, sizeof(g));
  }
  return predicated;
}

// groups: the device copy of bucketed_modmatmul_groups' table; tma_all: 1
// where no bucket is predicated.  Q (n_b, w, c) u32; S the caller's u8
// scratch of n_b * 4 b_pad rows of 16 ceil(w/16) bytes (b_pad: c rounded up
// to a multiple of n_stacked / 4); C (rows, c) u32 with rows = sum m_b.
extern "C" int bucketed_modmatmul_u8(const void* groups, int64_t n_b,
                                     int64_t tma_all, const void* Q, void* S,
                                     void* C, int64_t rows, int64_t n_tiles,
                                     int64_t w, int64_t c, int64_t n_stacked,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0 || c == 0) return 0;
  if (w == 0) {
    cudaMemsetAsync(C, 0, static_cast<size_t>(rows * c) * 4, st);
    return static_cast<int>(cudaGetLastError());
  }
  switch (n_stacked) {
    case 32: return launch_grouped<32>(groups, n_b, tma_all, Q, S, C, n_tiles, w, c, st);
    case 64: return launch_grouped<64>(groups, n_b, tma_all, Q, S, C, n_tiles, w, c, st);
    case 128: return launch_grouped<128>(groups, n_b, tma_all, Q, S, C, n_tiles, w, c, st);
    case 256: return launch_grouped<256>(groups, n_b, tma_all, Q, S, C, n_tiles, w, c, st);
    default: return ERR_WIDTH;
  }
}
