// Exact C = (L @ R) mod 2^32 for an L of uint8 or uint32 and an R of uint32.
//
// Replaces the TPU kernel repro/kernels/modmatmul.py (_kernel :53,
// modmatmul_pallas :95), which splits every u32 query word into four 8-bit
// limbs, runs them through the int8 MXU around a zero point of 128 and adds
// rank-1 corrections back.  It also serves the two u32 x u32 products the
// JAX package leaves to XLA (lwe.py :141 A.s, :147 and :179 H.s), since
// torch has no integer matmul on CUDA.
//
// Design: a shared-memory tiled GEMM whose threads hold unsigned int
// register tiles and multiply-add with native 32-bit IMAD.  Unsigned
// overflow wraps by definition, which is exactly arithmetic mod 2^32, so
// no limbs and no zero-point corrections are needed.  The kernel masks the
// ragged edges itself: callers pass unpadded operands.
//
// Bound on this card: the online answer (b = 64 queries) reads the u8 DB
// once and is memory-bound in principle (m*n bytes over 3.35 TB/s); the
// offline hint (b = 1024) is operation-bound.  This first version runs on
// the CUDA cores' integer pipe, far below the int8 tensor-core rate that a
// limb design with mma/wgmma could reach.
//
// Layout: L (m, n) row-major, R (n, b) row-major, C (m, b) row-major; all
// u32 data is the int32 tensor with the same bits.  64-bit indexing: the
// production DB has m*n > 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                          // output rows per block
constexpr int BN = 64;                           // output columns per block
constexpr int BK = 32;                           // contraction per stage
constexpr int TM = 8;                            // rows per thread
constexpr int TN = 4;                            // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

template <typename TL>
__global__ void __launch_bounds__(THREADS)
modmatmul_kernel(const TL* __restrict__ L, const uint32_t* __restrict__ R,
                 uint32_t* __restrict__ C, int64_t m, int64_t n, int64_t b) {
  // +1 column of padding: the transposed store below hits distinct banks
  __shared__ uint32_t As[BK][BM + 1];
  __shared__ uint32_t Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int64_t k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      uint32_t v = 0u;
      if (gr < m && gk < n) v = static_cast<uint32_t>(L[gr * n + gk]);
      As[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN;
      const int c = idx % BN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + c;
      uint32_t v = 0u;
      if (gk < n && gc < b) v = R[gk * b + gc];
      Bs[kk][c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t a[TM];
      uint32_t w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * w[j];  // wraps mod 2^32
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
      if (gc < b) C[gr * b + gc] = acc[i][j];
    }
  }
}

template <typename TL>
int launch(const void* L, const void* R, void* C, int64_t m, int64_t n,
           int64_t b, void* stream) {
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((b + BN - 1) / BN));
  modmatmul_kernel<TL><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TL*>(L), static_cast<const uint32_t*>(R),
      static_cast<uint32_t*>(C), m, n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int modmatmul_u8(const void* L, const void* R, void* C, int64_t m,
                            int64_t n, int64_t b, void* stream) {
  return launch<uint8_t>(L, R, C, m, n, b, stream);
}

extern "C" int modmatmul_u32(const void* L, const void* R, void* C, int64_t m,
                             int64_t n, int64_t b, void* stream) {
  return launch<uint32_t>(L, R, C, m, n, b, stream);
}
