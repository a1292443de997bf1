// Sparse hint delta dH = (NEW - OLD) @ A_J mod 2^32 in one pass, and the
// exact u32 add that folds dH into the hint.
//
// Replaces the Pallas branch of repro/kernels/ops.py delta_gemm (:184,
// :204-206), which runs modmatmul_pallas twice on the TPU (NEW @ A_J and
// OLD @ A_J, each through the int8 MXU with four u8 limbs of A_J) and
// subtracts the two products.  Here each block loads the u8 tiles of NEW and
// OLD for the same columns, forms (uint32)(int(new) - int(old)) in registers
// -- a value in [-255, 255] whose cast is its mod-2^32 residue -- and
// multiplies it by the A_J tile in unsigned int arithmetic, whose wraparound
// is the modulus.  One product instead of two gives the same ring element,
// so dH is bitwise the TPU's.
//
// Bound on this card: dH is a dense (m, k) u32 matrix the size of the hint
// (3.7 GB at m = 902,656, k = 1024) while the contraction J is small (a few
// percent of the clusters), so writing dH bounds the kernel at small J and
// the multiply-adds at large J.  This first version keeps modmatmul.cu's
// shared-memory tiled IMAD structure on the CUDA cores (no tensor cores, no
// TMA) and stores each thread's four output words as one 16-byte vector
// where the row width allows.  It masks ragged m, J and k itself: callers
// pass unpadded operands.
//
// add_delta_u32 computes D = H + D elementwise on u32 words (16-byte vectors
// where both buffers allow), writing into dH's buffer: the hint is never
// written because in-flight decodes still read it.  No int64 temporaries.
//
// Layout: NEW, OLD (m, J) u8 row-major; A (J, k) and C (m, k) u32 row-major,
// held by the caller as int32 tensors with the same bits.  64-bit indexing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                          // output rows per block
constexpr int BN = 64;                           // output columns per block
constexpr int BK = 32;                           // contraction per stage
constexpr int TM = 8;                            // rows per thread
constexpr int TN = 4;                            // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS)
delta_gemm_kernel(const uint8_t* __restrict__ NEW,
                  const uint8_t* __restrict__ OLD,
                  const uint32_t* __restrict__ A, uint32_t* __restrict__ C,
                  int64_t m, int64_t j, int64_t k) {
  // +1 column of padding: the transposed store below hits distinct banks
  __shared__ uint32_t Ds[BK][BM + 1];
  __shared__ uint32_t As[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0u;

  for (int64_t k0 = 0; k0 < j; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      const int64_t gk = k0 + kk;
      uint32_t v = 0u;
      if (gr < m && gk < j) {
        const int64_t o = gr * j + gk;
        // the difference in int, then its mod-2^32 residue
        const int d = static_cast<int>(NEW[o]) - static_cast<int>(OLD[o]);
        v = static_cast<uint32_t>(d);
      }
      Ds[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN;
      const int c = idx % BN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + c;
      uint32_t v = 0u;
      if (gk < j && gc < k) v = A[gk * k + gc];
      As[kk][c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t a[TM];
      uint32_t w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Ds[kk][ty * TM + i];
#pragma unroll
      for (int c = 0; c < TN; ++c) w[c] = As[kk][tx * TN + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] += a[i] * w[c];  // wraps mod 2^32
    }
    __syncthreads();
  }

  const int64_t gc0 = col0 + tx * TN;
  // 16-byte stores need k % 4 == 0 (then every gc0 is a multiple of 4)
  const bool vec = (k % TN == 0) && (gc0 + TN <= k);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= m) continue;
    if (vec) {
      *reinterpret_cast<uint4*>(C + gr * k + gc0) =
          make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      continue;
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      if (gc0 + c < k) C[gr * k + gc0 + c] = acc[i][c];
    }
  }
}

constexpr int ADD_THREADS = 256;

__global__ void __launch_bounds__(ADD_THREADS)
add_u32_kernel(const uint32_t* __restrict__ H, uint32_t* __restrict__ D,
               int64_t n, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * ADD_THREADS;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * ADD_THREADS +
                    threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const uint4* h4 = reinterpret_cast<const uint4*>(H);
    uint4* d4 = reinterpret_cast<uint4*>(D);
    for (int64_t i = t; i < n4; i += stride) {
      const uint4 h = h4[i];
      uint4 d = d4[i];
      d.x += h.x;                                  // each wraps mod 2^32
      d.y += h.y;
      d.z += h.z;
      d.w += h.w;
      d4[i] = d;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + t; i < n; i += stride) D[i] += H[i];
}

}  // namespace

extern "C" int delta_gemm_u8(const void* NEW, const void* OLD, const void* A,
                             void* C, int64_t m, int64_t j, int64_t k,
                             void* stream) {
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((k + BN - 1) / BN));
  delta_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(NEW), static_cast<const uint8_t*>(OLD),
      static_cast<const uint32_t*>(A), static_cast<uint32_t*>(C), m, j, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int add_delta_u32(const void* H, void* D, int64_t n, void* stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(H) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(D) % 16 == 0);
  const int64_t items = vec ? (n + 3) / 4 : n;
  int64_t blocks = (items + ADD_THREADS - 1) / ADD_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;        // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  add_u32_kernel<<<static_cast<unsigned>(blocks), ADD_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(H), static_cast<uint32_t*>(D), n, vec);
  return static_cast<int>(cudaGetLastError());
}
