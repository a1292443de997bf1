// Fused k-means assignment: for each point, the nearest centroid and its
// squared distance, without the (N, K) distance matrix in device memory.
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py (_kernel :29,
// kmeans_assign_pallas :58).  Same arithmetic: d2 = (|x|^2 - 2 x.c) + |c|^2,
// in that order of terms, every sum by fmaf in ascending feature order, in
// fp32 with no TF32, and a running (min, argmin) with strict < so the
// earliest centroid wins a tie, as jnp.argmin and torch.argmin do.
//
// Bound on this card: 2*N*K*d fp32 operations, at the build's shapes far
// above the bytes it must move (N*d + K*d floats in, 2*N words out); the
// fp32 FMA rate of the CUDA cores is the ceiling, so the design keeps the
// FMA pipe fed from registers:
//
//   * A block owns 128 points and sweeps the centroids in tiles of 128;
//     256 threads, an 8 x 8 register tile each (points 4 tp + i and
//     64 + 4 tp + i, centroids 4 tc + q and 64 + 4 tc + q).  Operands come
//     as float4 loads from feature-major shared tiles: 4 LDS.128 per 64
//     FMAs.  A warp covers 4 point groups x 8 centroid groups, so each of
//     its float4 loads touches at most 128 distinct bytes.
//   * The block's points stay in shared memory, transposed, for the whole
//     sweep where 128 * d_pad floats fit beside the ring (d <= 384: at the
//     build's d = 128 that is 64 KB, two blocks an SM); otherwise (d = 768)
//     the feature axis is walked in chunks of 32 and the points reloaded.
//   * Centroids stream through a two-stage cp.async ring of 32 features x
//     128 centroids, from a transposed, zero-padded copy cT (d_pad, k_pad)
//     that a pre-pass writes once per launch together with |c|^2; |x|^2 is
//     summed once per block.
//   * Ragged N and K are masked here (zero points past N, centroids past K
//     skipped in the scan), not padded by the caller.
//   * After each centroid tile the 16 threads that share a point merge
//     their minima (smaller distance first, smaller index on equal
//     distance) into one running (min, argmin) a point, so no thread keeps
//     per-point minima in registers beside its 64 accumulators.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BP = 128;                         // points per block
constexpr int BC = 128;                         // centroids per tile
constexpr int BD = 32;                          // features per ring stage
constexpr int THREADS = 256;                    // 16 x 16 threads, 8 x 8 each
constexpr int RING = 2;                         // cp.async stages
constexpr int SMEM_MAX = 232448;                // a block's shared memory

__host__ __device__ constexpr int64_t k_padded(int64_t k) {
  return (k + BC - 1) / BC * BC;
}

__host__ __device__ constexpr int64_t d_padded(int64_t d) {
  return d <= BD ? BD : (d + BD - 1) / BD * BD;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// cT[j][c] = c[c][j], zero past K and past d; c2[c] = sum_j c[c][j]^2 by
// fmaf in ascending j (0 past K).  A block owns 32 centroids and walks d in
// tiles of 32 x 32 through shared memory: rows of c are read and rows of cT
// written 128 bytes at a time, and c2 sums from the tile.
__global__ void __launch_bounds__(256)
centroid_prep_kernel(const float* __restrict__ c, float* __restrict__ cT,
                     float* __restrict__ c2, int64_t k, int64_t d,
                     int64_t k_pad, int64_t d_pad) {
  __shared__ float T[32][33];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int tid = threadIdx.x;
  float s = 0.f;                                   // c2 of c0 + tid, tid < 32
  for (int64_t j0 = 0; j0 < d_pad; j0 += 32) {
    for (int i = tid; i < 32 * 32; i += 256) {
      const int r = i / 32;                        // centroid
      const int f = i % 32;                        // feature, fastest
      T[r][f] = (c0 + r < k && j0 + f < d) ? c[(c0 + r) * d + j0 + f] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < 32 * 32; i += 256) {
      const int f = i / 32;
      const int r = i % 32;                        // centroid, fastest
      cT[(j0 + f) * k_pad + c0 + r] = T[r][f];
    }
    if (tid < 32) {
      for (int f = 0; f < 32 && j0 + f < d; ++f) s = fmaf(T[tid][f], T[tid][f], s);
    }
    __syncthreads();
  }
  if (tid < 32) c2[c0 + tid] = s;
}

// features [f0, f0 + nf) of the block's points into dst (nf, BP), feature
// major, zero past N and past d; the point index is the fastest, so the
// transposed stores hit distinct banks
__device__ __forceinline__ void load_points(const float* __restrict__ x,
                                            float* dst, int64_t p0, int64_t n,
                                            int64_t d, int f0, int nf,
                                            bool vec) {
  if (vec) {                                     // d % 4 == 0, 16-byte base
    for (int q = threadIdx.x; q < BP * nf / 4; q += THREADS) {
      const int p = q % BP;
      const int f = 4 * (q / BP);
      const int64_t gp = p0 + p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gp < n && f0 + f < d)
        v = *reinterpret_cast<const float4*>(x + gp * d + f0 + f);
      dst[(f + 0) * BP + p] = v.x;
      dst[(f + 1) * BP + p] = v.y;
      dst[(f + 2) * BP + p] = v.z;
      dst[(f + 3) * BP + p] = v.w;
    }
  } else {
    for (int q = threadIdx.x; q < BP * nf; q += THREADS) {
      const int p = q % BP;
      const int f = q / BP;
      const int64_t gp = p0 + p;
      dst[f * BP + p] = (gp < n && f0 + f < d) ? x[gp * d + f0 + f] : 0.f;
    }
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ cT,
                     const float* __restrict__ c2, int32_t* __restrict__ assign,
                     float* __restrict__ mind2, int64_t n, int64_t k, int64_t d,
                     int64_t k_pad, int64_t d_pad, int vec) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);       // (RESIDENT ? d_pad : BD, BP)
  float* ring = Xs + (RESIDENT ? d_pad : BD) * BP;   // RING x (BD, BC)
  float* x2s = ring + RING * BD * BC;                // BP
  float* red_d = x2s + BP;                           // (BP, 2) per tile
  int32_t* red_i = reinterpret_cast<int32_t*>(red_d + 2 * BP);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tp = (warp / 2) * 4 + lane / 8;          // point group, 0..15
  const int tc = (warp % 2) * 8 + lane % 8;          // centroid group, 0..15
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * BP;
  const int chunks = static_cast<int>(d_pad / BD);
  const int total = static_cast<int>(k_pad / BC) * chunks;

  // ring stage it % RING <- cT rows [ch BD, ch BD + BD), columns of tile t
  auto issue = [&](int it) {
    const int t = it / chunks;
    const int ch = it % chunks;
    const uint32_t base = smem_u32(ring + (it % RING) * BD * BC);
#pragma unroll
    for (int i = 0; i < BD * BC / 4 / THREADS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BC / 4);
      const int c4 = q % (BC / 4);
      cp_async16(base + (r * BC + 4 * c4) * 4,
                 cT + (static_cast<int64_t>(ch) * BD + r) * k_pad +
                     static_cast<int64_t>(t) * BC + 4 * c4);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  issue(0);
  if (RESIDENT) {
    load_points(x, Xs, p0, n, d, 0, static_cast<int>(d_pad), vec != 0);
    __syncthreads();
    if (tid < BP) {
      float s = 0.f;
      for (int64_t j = 0; j < d; ++j) s = fmaf(Xs[j * BP + tid], Xs[j * BP + tid], s);
      x2s[tid] = s;
    }
  }

  float acc[8][8];
  float x2_run = 0.f;                               // |x|^2 while not resident
  // the running (min, argmin) of point tid, for tid < BP
  float run_d = __int_as_float(0x7f800000);         // +inf
  int32_t run_i = INT_MAX;

  for (int it = 0; it < total; ++it) {
    const int t = it / chunks;
    const int ch = it % chunks;
    if (it + 1 < total) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (!RESIDENT) load_points(x, Xs, p0, n, d, ch * BD, BD, vec != 0);
    __syncthreads();

    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    }
    if (!RESIDENT && t == 0 && tid < BP) {
      for (int jj = 0; jj < BD && ch * BD + jj < d; ++jj)
        x2_run = fmaf(Xs[jj * BP + tid], Xs[jj * BP + tid], x2_run);
      if (ch == chunks - 1) x2s[tid] = x2_run;
    }

    const float* xs = Xs + (RESIDENT ? ch * BD : 0) * BP;
    const float* cs = ring + (it % RING) * BD * BC;
#pragma unroll
    for (int jj = 0; jj < BD; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + jj * BP + 4 * tp);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + jj * BP + 64 + 4 * tp);
      const float4 b0 = *reinterpret_cast<const float4*>(cs + jj * BC + 4 * tc);
      const float4 b1 = *reinterpret_cast<const float4*>(cs + jj * BC + 64 + 4 * tc);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
    // every thread is done with this ring stage (and point chunk) before
    // the next iteration's cp.async or load overwrites it
    __syncthreads();
    if (ch != chunks - 1) continue;

    // the tile's minimum per point: this thread's 8 centroids in ascending
    // index order (strict < keeps the earliest among equal distances), then
    // the 8 lanes of this warp that share the point by shuffles, then the
    // two warps that share it through red (smaller distance first, smaller
    // index on equal distance)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = (i < 4 ? 0 : 64) + 4 * tp + i % 4;
      const float x2 = x2s[p];
      float bd = __int_as_float(0x7f800000);
      int32_t bi = INT_MAX;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t gc = static_cast<int64_t>(t) * BC + (q < 4 ? 0 : 64) +
                           4 * tc + q % 4;
        if (gc < k) {
          const float sq = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, acc[i][q])),
                                     __ldg(c2 + gc));
          if (sq < bd) {
            bd = sq;
            bi = static_cast<int32_t>(gc);
          }
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int32_t oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (lane % 8 == 0) {
        red_d[p * 2 + warp % 2] = bd;
        red_i[p * 2 + warp % 2] = bi;
      }
    }
    __syncthreads();
    // earlier tiles hold smaller indices: a later tile wins only by a
    // strictly smaller distance.  red is rewritten only after the next
    // tile's barriers, which this thread reaches after these reads.
    if (tid < BP) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float od = red_d[tid * 2 + w];
        const int32_t oi = red_i[tid * 2 + w];
        if (od < run_d || (od == run_d && oi < run_i)) {
          run_d = od;
          run_i = oi;
        }
      }
    }
  }

  if (tid < BP && p0 + tid < n) {
    assign[p0 + tid] = (run_i == INT_MAX) ? 0 : run_i;
    mind2[p0 + tid] = run_d;
  }
}

template <bool RESIDENT>
int launch_assign(const float* x, const float* cT, const float* c2,
                  int32_t* assign, float* mind2, int64_t n, int64_t k,
                  int64_t d, int64_t k_pad, int64_t d_pad, int vec,
                  int smem, cudaStream_t stream) {
  cudaFuncSetAttribute(kmeans_assign_kernel<RESIDENT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(static_cast<unsigned>((n + BP - 1) / BP));
  kmeans_assign_kernel<RESIDENT><<<grid, THREADS, smem, stream>>>(
      x, cT, c2, assign, mind2, n, k, d, k_pad, d_pad, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// floats of the scratch kmeans_assign_f32 takes: cT (d_pad, k_pad), then
// |c|^2 (k_pad)
extern "C" int kmeans_assign_scratch_floats(int64_t k, int64_t d) {
  return static_cast<int>(d_padded(d) * k_padded(k) + k_padded(k));
}

// assign (n,) i32, mind2 (n,) f32 of x (n, d) against c (k, d), k >= 1;
// `scratch` holds kmeans_assign_scratch_floats(k, d) floats
extern "C" int kmeans_assign_f32(const void* x, const void* c, void* scratch,
                                 void* assign, void* mind2, int64_t n,
                                 int64_t k, int64_t d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t k_pad = k_padded(k);
  const int64_t d_pad = d_padded(d);
  float* cT = static_cast<float*>(scratch);
  float* c2 = cT + d_pad * k_pad;
  centroid_prep_kernel<<<static_cast<unsigned>(k_pad / 32), 256, 0, st>>>(
      static_cast<const float*>(c), cT, c2, k, d, k_pad, d_pad);
  const cudaError_t prep = cudaGetLastError();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  if (n == 0) return 0;

  const int vec = (d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  // the ring, |x|^2 and the per-tile minima (red_d, red_i)
  const int64_t ring_bytes = (static_cast<int64_t>(RING) * BD * BC + 5 * BP) * 4;
  const int64_t resident = d_pad * BP * 4 + ring_bytes;
  if (resident <= SMEM_MAX) {
    return launch_assign<true>(static_cast<const float*>(x), cT, c2,
                               static_cast<int32_t*>(assign),
                               static_cast<float*>(mind2), n, k, d, k_pad,
                               d_pad, vec, static_cast<int>(resident), st);
  }
  return launch_assign<false>(static_cast<const float*>(x), cT, c2,
                              static_cast<int32_t*>(assign),
                              static_cast<float*>(mind2), n, k, d, k_pad,
                              d_pad, vec,
                              static_cast<int>(BD * BP * 4 + ring_bytes), st);
}
