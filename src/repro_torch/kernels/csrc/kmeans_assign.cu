// Fused k-means assignment: for each point, the nearest centroid and its
// squared distance, without the (N, K) distance matrix in device memory.
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py (_kernel :29,
// kmeans_assign_pallas :58).  Same arithmetic: d2 = |x|^2 - 2 x.c + |c|^2,
// in that order of terms, in fp32 with FMA and no TF32, and a running
// (min, argmin) with strict < so the earliest centroid wins a tie, as
// jnp.argmin and torch.argmin do.
//
// Design: one block owns 64 points and sweeps the centroids in tiles of
// 64; the (64, 64) score tile lives in registers (4 x 4 per thread).  The
// feature axis is walked in chunks of 32 through shared memory, so any d
// works (64, 128, 768, ...).  |x|^2 and |c|^2 are summed from the same
// shared chunks.  Ragged N and K are masked here, not padded by the caller.
// The 16 threads that share a point merge their running minima at the end,
// smaller distance first and smaller index on equal distance.
//
// Bound on this card: 2*N*K*d fp32 operations, at the build's shapes far
// above the bytes it must move (N*d + K*d floats in, 2*N words out); the
// fp32 FMA rate of the CUDA cores is the ceiling.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BP = 64;                          // points per block
constexpr int BC = 64;                          // centroids per tile
constexpr int BD = 32;                          // features per chunk
constexpr int TP = 4;                           // points per thread
constexpr int TC = 4;                           // centroids per thread
constexpr int GROUPS = BC / TC;                 // threads sharing a point
constexpr int THREADS = (BP / TP) * GROUPS;     // 256
static_assert(BP == BC, "one load loop fills both tiles");
static_assert(BC + BP <= THREADS, "one thread per |c|^2 and |x|^2 sum");

__global__ void __launch_bounds__(THREADS)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ assign, float* __restrict__ mind2,
                     int64_t n, int64_t k, int64_t d) {
  __shared__ float Xs[BD][BP + 1];
  __shared__ float Cs[BD][BC + 1];
  __shared__ float x2s[BP];
  __shared__ float c2s[BC];
  __shared__ float red_d[BP][GROUPS];
  __shared__ int32_t red_i[BP][GROUPS];

  const int tid = threadIdx.x;
  const int tc = tid % GROUPS;
  const int tp = tid / GROUPS;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * BP;

  float best_d[TP];
  int32_t best_i[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    best_d[i] = __int_as_float(0x7f800000);  // +inf
    best_i[i] = INT_MAX;
  }

  for (int64_t c0 = 0; c0 < k; c0 += BC) {
    float dot[TP][TC];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int q = 0; q < TC; ++q) dot[i][q] = 0.f;
    float sq = 0.f;  // |c|^2 (threads < BC) or, on the first tile, |x|^2

    for (int64_t d0 = 0; d0 < d; d0 += BD) {
#pragma unroll
      for (int i = 0; i < (BP * BD) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BD;
        const int j = idx % BD;
        const int64_t gj = d0 + j;
        const int64_t gp = p0 + r;
        const int64_t gc = c0 + r;
        Xs[j][r] = (gp < n && gj < d) ? x[gp * d + gj] : 0.f;
        Cs[j][r] = (gc < k && gj < d) ? c[gc * d + gj] : 0.f;
      }
      __syncthreads();

      if (tid < BC) {
#pragma unroll 8
        for (int j = 0; j < BD; ++j) sq = fmaf(Cs[j][tid], Cs[j][tid], sq);
      } else if (c0 == 0 && tid < BC + BP) {
#pragma unroll 8
        for (int j = 0; j < BD; ++j)
          sq = fmaf(Xs[j][tid - BC], Xs[j][tid - BC], sq);
      }

#pragma unroll 8
      for (int j = 0; j < BD; ++j) {
        float xa[TP];
        float ca[TC];
#pragma unroll
        for (int i = 0; i < TP; ++i) xa[i] = Xs[j][tp * TP + i];
#pragma unroll
        for (int q = 0; q < TC; ++q) ca[q] = Cs[j][tc * TC + q];
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int q = 0; q < TC; ++q) dot[i][q] = fmaf(xa[i], ca[q], dot[i][q]);
      }
      __syncthreads();
    }

    if (tid < BC) {
      c2s[tid] = sq;
    } else if (c0 == 0 && tid < BC + BP) {
      x2s[tid - BC] = sq;
    }
    __syncthreads();

    // scan this thread's centroids in ascending index order: strict < keeps
    // the earliest index among equal distances
#pragma unroll
    for (int i = 0; i < TP; ++i) {
#pragma unroll
      for (int q = 0; q < TC; ++q) {
        const int64_t gc = c0 + tc * TC + q;
        if (gc < k) {
          const float s = __fadd_rn(
              __fsub_rn(x2s[tp * TP + i], __fmul_rn(2.f, dot[i][q])),
              c2s[tc * TC + q]);
          if (s < best_d[i]) {
            best_d[i] = s;
            best_i[i] = static_cast<int32_t>(gc);
          }
        }
      }
    }
    // the next tile writes c2s only after its first __syncthreads, which
    // every thread reaches only once its scan above is done
  }

#pragma unroll
  for (int i = 0; i < TP; ++i) {
    red_d[tp * TP + i][tc] = best_d[i];
    red_i[tp * TP + i][tc] = best_i[i];
  }
  __syncthreads();
  if (tid < BP) {
    const int64_t gp = p0 + tid;
    if (gp < n) {
      float bd = red_d[tid][0];
      int32_t bi = red_i[tid][0];
      for (int t = 1; t < GROUPS; ++t) {
        const float v = red_d[tid][t];
        const int32_t vi = red_i[tid][t];
        if (v < bd || (v == bd && vi < bi)) {
          bd = v;
          bi = vi;
        }
      }
      assign[gp] = (bi == INT_MAX) ? 0 : bi;
      mind2[gp] = bd;
    }
  }
}

}  // namespace

extern "C" int kmeans_assign_f32(const void* x, const void* c, void* assign,
                                 void* mind2, int64_t n, int64_t k, int64_t d,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned>((n + BP - 1) / BP));
  kmeans_assign_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<int32_t*>(assign), static_cast<float*>(mind2), n, k, d);
  return static_cast<int>(cudaGetLastError());
}
