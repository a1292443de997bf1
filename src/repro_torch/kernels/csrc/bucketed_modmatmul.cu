// Grouped bucketed exact product: for every bucket b, C_b = (D_b @ Q_b) mod 2^32,
// with D_b (m_b, W) uint8, Q_b (W, C) uint32 and C_b (m_b, C) uint32, in ONE
// launch whatever the number of buckets.
//
// Replaces the Pallas branch of repro/kernels/ops.py bucketed_modmatmul (:263),
// which row-pads every bucket to the tallest one, stacks them as (B, m', W) and
// vmaps the limb kernel modmatmul_pallas over the bucket axis (:317-331).  The
// padded rows are read and multiplied there; here they do not exist.
//
// Design: the grid's x axis walks the row tiles of all buckets back to back.
// A device table, built by the wrapper for each call, holds per bucket the base
// pointer of its sub-DB, its first row in the shared output and its first row
// tile.  A block finds its bucket by binary search over the tile offsets, then
// runs the tiled IMAD loop of modmatmul.cu on that bucket alone: the last tile
// of a bucket masks its missing rows, so no row beyond m_b is read and no
// bucket is padded.  Unsigned 32-bit multiply-add wraps, which is exactly
// arithmetic mod 2^32: no limbs, no zero points.  The grid's y axis covers the
// C client columns in tiles of BN (16 for C <= 16, as a served batch is, else
// 64).  Where W is a multiple of 4 the sub-DB is read in 32-bit words.
//
// Bound on this card: the batch answer reads every sub-DB once (sum m_b * W
// bytes over 3.35 TB/s) unless C is large enough that the 4 int8-limb MACs
// per u8 x u32 MAC on the int8 tensor cores take longer.  This first version
// runs on the CUDA cores' integer pipe, far from either; the tensor-core
// redesign is later work.
//
// Layout: each D_b row-major (m_b, W); Q (B, W, C) row-major; the output is one
// (sum m_b, C) row-major buffer whose rows row_off[b] .. row_off[b+1] are C_b.
// 64-bit indexing throughout: the served sub-DBs hold > 2^31 bytes together.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output rows per block (one row tile)
constexpr int BK = 32;    // contraction per stage
constexpr int TM = 8;     // rows per thread
constexpr int TN = 4;     // columns per thread

template <int BN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bucketed_kernel(const int64_t* __restrict__ table, int64_t n_buckets,
                const uint32_t* __restrict__ Q, uint32_t* __restrict__ C,
                int64_t w, int64_t c) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  __shared__ uint32_t As[BK][BM + 1];
  __shared__ uint32_t Bs[BK][BN];
  __shared__ int s_bucket;

  const int64_t* ptrs = table;                       // B base pointers
  const int64_t* row_off = table + n_buckets;        // B + 1 output rows
  const int64_t* tile_off = row_off + n_buckets + 1; // B + 1 row tiles
  const int64_t tile = blockIdx.x;
  if (threadIdx.x == 0) {
    // the last bucket whose first tile is at or before this one; empty
    // buckets share their successor's offset and are skipped over
    int lo = 0;
    int hi = static_cast<int>(n_buckets) - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tile_off[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    s_bucket = lo;
  }
  __syncthreads();
  const int b = s_bucket;
  const uint8_t* D = reinterpret_cast<const uint8_t*>(ptrs[b]);
  const int64_t m = row_off[b + 1] - row_off[b];
  const int64_t row0 = (tile - tile_off[b]) * BM;
  const uint32_t* Qb = Q + static_cast<int64_t>(b) * w * c;
  uint32_t* Cb = C + row_off[b] * c;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int64_t k0 = 0; k0 < w; k0 += BK) {
    if (VEC) {
      // W % 4 == 0: a word lies wholly inside the row or wholly past its end
#pragma unroll
      for (int i = 0; i < (BM * BK / 4) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / (BK / 4);
        const int kk = (idx % (BK / 4)) * 4;
        const int64_t gr = row0 + r;
        const int64_t gk = k0 + kk;
        uint32_t v = 0u;
        if (gr < m && gk < w)
          v = *reinterpret_cast<const uint32_t*>(D + gr * w + gk);
        As[kk][r] = v & 0xFFu;
        As[kk + 1][r] = (v >> 8) & 0xFFu;
        As[kk + 2][r] = (v >> 16) & 0xFFu;
        As[kk + 3][r] = v >> 24;
      }
    } else {
#pragma unroll 8
      for (int i = 0; i < (BM * BK) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BK;
        const int kk = idx % BK;
        const int64_t gr = row0 + r;
        const int64_t gk = k0 + kk;
        uint32_t v = 0u;
        if (gr < m && gk < w) v = static_cast<uint32_t>(D[gr * w + gk]);
        As[kk][r] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + cc;
      uint32_t v = 0u;
      if (gk < w && gc < c) v = Qb[gk * c + gc];
      Bs[kk][cc] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t a[TM];
      uint32_t q[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) q[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * q[j];  // wraps mod 2^32
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx * TN + j;
      if (gc < c) Cb[gr * c + gc] = acc[i][j];
    }
  }
}

template <int BN>
void launch(const int64_t* table, int64_t n_buckets, const uint32_t* Q,
            uint32_t* C, int64_t n_tiles, int64_t w, int64_t c,
            cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((c + BN - 1) / BN));
  if (w % 4 == 0)
    bucketed_kernel<BN, true><<<grid, THREADS, 0, stream>>>(
        table, n_buckets, Q, C, w, c);
  else
    bucketed_kernel<BN, false><<<grid, THREADS, 0, stream>>>(
        table, n_buckets, Q, C, w, c);
}

}  // namespace

// Rows of one tile: the wrapper counts each bucket's tiles with it.
extern "C" int bucketed_modmatmul_tile_rows() { return BM; }

// table: device int64 [ptr_0 .. ptr_{B-1}, row_off_0 .. row_off_B,
// tile_off_0 .. tile_off_B]; every sub-DB base pointer 4-byte aligned.
extern "C" int bucketed_modmatmul_u8(const void* table, int64_t n_buckets,
                                     const void* Q, void* C, int64_t n_tiles,
                                     int64_t w, int64_t c, void* stream) {
  const auto* t = static_cast<const int64_t*>(table);
  const auto* q = static_cast<const uint32_t*>(Q);
  auto* out = static_cast<uint32_t*>(C);
  auto s = static_cast<cudaStream_t>(stream);
  if (c <= 16)
    launch<16>(t, n_buckets, q, out, n_tiles, w, c, s);
  else
    launch<64>(t, n_buckets, q, out, n_tiles, w, c, s);
  return static_cast<int>(cudaGetLastError());
}
