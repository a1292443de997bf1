// The u8 limb tile: C = sum_l (D . R_l) << 8l (mod 2^32) on Hopper's int8
// tensor cores, for a u8 left operand D (m, n) and the stacked u8 planes R_l
// of a u32 right operand that a prep kernel wrote.  modmatmul.cu,
// delta_gemm.cu and bucketed_modmatmul.cu each include it and compile their
// own copy (each source is its own library); the ring, the producer, the
// consumers, the epilogue and the TMA encoder are written here once.
//
// limb_gemm_kernel<N, GROUPED, STAGED>: a persistent CTA per SM walks
// output tiles (128-row band of D, column tile) with the column tiles of a
// band back to back, so a band is read from HBM once and from L2 for its
// other tiles.  One producer warpgroup fills a ring of 4-8 stages (D 128 x
// 128 bytes, planes N x 128 bytes, both in the 128-byte swizzle) on
// mbarriers; two consumer warpgroups run wgmma.m64nNk32.s32.u8.u8 on 64 rows
// each, N = 4 BNO stacked columns (N = 32, 64, 128 or 256, from the caller's
// limb plan: BNO >= 8 keeps a thread's four limbs of an output together).
// The epilogue forms sum_l acc_l << 8l in registers and writes only u32:
// from the registers, or (STAGED) through shared memory as whole 16-byte
// words, which a product whose tiles are one stage deep needs
// (store_tile_staged).  One limb sum is at most 255 * 255 * n, below 2^31
// for n <= 32,768: the contraction runs in chunks of 32,768 bytes and later
// chunks are added to C in u32, so no sum ever depends on how the s32
// accumulator overflows.
//
// GROUPED = false: one D, read by TMA where its row stride is a multiple of
// 16 bytes and its base 16-byte aligned, else by predicated byte loads in the
// same swizzle, into the same ring.  A second D map may take over from a
// given stage on (`split`): delta_gemm reads [new | old] that way.
//
// GROUPED = true: many D_b (the batch-PIR buckets) of one width, each with
// its own height, output rows and planes, in ONE launch.  Tile t belongs to
// the last bucket whose first tile is at or before t (a binary search of the
// groups' tile offsets).  Each bucket's D map lives in device memory (see
// Group), so TMA zero-fills its last band and never reads the next bucket's
// rows; a bucket that TMA cannot read takes the predicated producer.
//
// Layout: D (m, n) row-major u8; the planes (rows, n16) u8, n16 = 16
// ceil(n/16), laid out as ref.limb_planes; C (m, b) row-major u32 (int32
// bits).  64-bit indexing: the production DB has m*n > 2^31.

#pragma once

#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums; the encoder is
#include <cuda_runtime.h>   // looked up at run time, so no -lcuda

namespace {

constexpr int LBM = 128;            // rows of D per tile: two warpgroups of 64
constexpr int LBK = 128;            // contraction bytes per stage (one swizzle row)
constexpr int WK = 32;              // contraction of one wgmma
constexpr int CHUNK_STAGES = 32768 / LBK;   // limb sums < 2^31 within a chunk
constexpr int LTHREADS = 384;       // consumers 0-255, producer 256-383
constexpr int SMEM_BUDGET = 196608;
constexpr int NO_SPLIT = 1 << 30;   // `split` of a single-operand D
constexpr int64_t NO_NEG = INT64_MAX;  // `neg_at` of planes with no (0 - R) rows

template <int N>
struct Cfg {
  static constexpr int BNO = N / 4;                  // output columns per tile
  static constexpr int A_BYTES = LBM * LBK;
  static constexpr int B_BYTES = N * LBK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      SMEM_BUDGET / STAGE_BYTES < 8 ? SMEM_BUDGET / STAGE_BYTES : 8;
  // the staged epilogue's buffer: a tile's LBM x BNO u32 outputs
  static constexpr int OUT_BYTES = LBM * BNO * 4;
  // + 1 KB to align the ring to the 1024-byte swizzle atom, + the barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
  static constexpr int smem(bool staged) {
    return SMEM + (staged ? OUT_BYTES : 0);
  }
};

// One bucket of a grouped walk.  The maps live in device memory, not in the
// kernel's parameters: a lookup of kappa = 26 ids needs 78 buckets, more
// 128-byte maps than the 4 KB parameter space of CUDA before 12.1 holds,
// and device memory sets no such cap.  64-byte aligned, as TMA wants a map.
struct alignas(64) Group {
  CUtensorMap map;        // D_b (rows, n) where tma, else unused
  const uint8_t* d;       // D_b's base, for the predicated producer
  int64_t rows;           // m_b
  int64_t row_off;        // its first row in the shared output
  int64_t tile_off;       // its first tile
  int64_t tma;            // 1: D_b by TMA
};

struct TileArgs {
  const uint8_t* d;       // D (single operand)
  uint32_t* c;            // the output
  int64_t m;              // D's rows (single operand)
  int64_t n;              // contraction bytes: the row stride of D and D_b
  int64_t b;              // output columns
  int64_t n_ct;           // column tiles a band
  int64_t n_tiles;
  int64_t s_rows;         // plane rows a bucket (grouped): 4 b_pad
  const Group* groups;    // grouped walk: its buckets
  int64_t n_groups;
  int tma_all;            // every tile's D by TMA: the producer is one thread
  int split;              // stages from `split` on read map_d2 at kb - split
};

// where one output tile reads its D and its planes and writes its outputs
struct Tile {
  const CUtensorMap* map;
  const uint8_t* d;
  uint32_t* c;
  int64_t m;              // rows of its D
  int64_t row0;           // first row of its band in that D
  int64_t s_row;          // first row of its planes' box
  int64_t col;            // first output column
  int tma;
  int g;                  // bucket
};

template <int N, bool GROUPED>
__device__ __forceinline__ Tile locate(int64_t t, const TileArgs& a,
                                       const CUtensorMap* map_d) {
  Tile x;
  int64_t local = t;
  x.s_row = 0;
  if constexpr (GROUPED) {
    // the last bucket whose first tile is at or before t; an empty bucket
    // shares its successor's offset and is passed over
    int lo = 0;
    int hi = static_cast<int>(a.n_groups) - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (a.groups[mid].tile_off <= t) lo = mid; else hi = mid - 1;
    }
    const Group* g = a.groups + lo;
    local = t - g->tile_off;
    x.map = &g->map;
    x.d = g->d;
    x.c = a.c + g->row_off * a.b;
    x.m = g->rows;
    x.tma = static_cast<int>(g->tma);
    x.g = lo;
    x.s_row = static_cast<int64_t>(lo) * a.s_rows;
  } else {
    x.map = map_d;
    x.d = a.d;
    x.c = a.c;
    x.m = a.m;
    x.tma = a.tma_all;
    x.g = 0;
  }
  const int64_t ct = local % a.n_ct;
  x.row0 = (local / a.n_ct) * LBM;
  x.s_row += ct * N;
  x.col = ct * Cfg<N>::BNO;
  return x;
}

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

// a map in device memory was written by a copy before the launch: order
// that write before the tensor-map proxy reads it (no stale cached map)
__device__ __forceinline__ void tensormap_acquire(const CUtensorMap* map) {
  asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
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

// output (row 8i, column 8g + j) of a thread's fragment: sum_l acc_l << 8l,
// which wraps mod 2^32
template <int N>
__device__ __forceinline__ uint32_t limb_sum(const uint32_t (&acc)[N / 2],
                                             int i, int g, int j) {
  constexpr int G = Cfg<N>::BNO / 8;                 // 8-column groups a limb
  uint32_t s = 0u;
#pragma unroll
  for (int l = 0; l < 4; ++l) s += acc[(l * G + g) * 4 + i * 2 + j] << (8 * l);
  return s;
}

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
      uint32_t v[2] = {limb_sum<N>(acc, i, g, 0), limb_sum<N>(acc, i, g, 1)};
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

// The staged epilogue: one warpgroup's 64 x BNO outputs go through shared
// memory and leave as whole 16-byte words, a warp's stores covering whole
// rows.  wgmma's register layout gives a thread 8-byte pieces of 8 rows, and
// stored from registers those write ΔH (902,656 x 1024 u32) at 1.27 TB/s on
// an H100, where one pass of 16-byte stores reaches 3.27.  The buffer holds
// 16-byte chunk ch of row r at chunk ch ^ (r % SW), so the registers' 8-byte
// writes and the rows' 16-byte reads are both free of bank conflicts.
// `buf` is the warpgroup's half of the buffer; `vec`: C's rows are 16-byte
// words (b % 4 == 0, C 16-byte aligned).
template <int N>
__device__ __forceinline__ void store_tile_staged(
    const uint32_t (&acc)[N / 2], uint32_t* buf, uint32_t* __restrict__ C,
    int64_t m, int64_t b, int64_t row0, int64_t col0, bool accumulate,
    int wg, bool vec) {
  constexpr int BNO = Cfg<N>::BNO;
  constexpr int G = BNO / 8;                         // 8-column groups a limb
  constexpr int CH = BNO / 4;                        // 16-byte chunks a row
  constexpr int SW = CH < 8 ? CH : 8;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid / 32) * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 8 * g + 2 * (lane % 4);
      const int at = r * BNO + (((c / 4) ^ (r % SW)) * 4) + c % 4;
      *reinterpret_cast<uint2*>(buf + at) =
          make_uint2(limb_sum<N>(acc, i, g, 0), limb_sum<N>(acc, i, g, 1));
    }
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
  for (int q = tid; q < 64 * CH; q += 128) {
    const int r = q / CH;
    const int ch = q % CH;
    const int64_t gr = row0 + r;
    const int64_t gc = col0 + 4 * ch;
    if (gr >= m || gc >= b) continue;
    uint4 v = *reinterpret_cast<const uint4*>(buf + r * BNO + ((ch ^ (r % SW)) * 4));
    uint32_t* dst = C + gr * b + gc;
    if (vec) {                                       // gc + 4 <= b
      if (accumulate) {
        const uint4 o = *reinterpret_cast<const uint4*>(dst);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (gc + x < b) dst[x] = (accumulate ? dst[x] : 0u) + w[x];
      }
    }
  }
  // the buffer is free for the next tile
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

template <int N, bool GROUPED, bool STAGED>
__global__ void __launch_bounds__(LTHREADS, 1)
limb_gemm_kernel(const __grid_constant__ CUtensorMap map_d,
                 const __grid_constant__ CUtensorMap map_d2,
                 const __grid_constant__ CUtensorMap map_s,
                 const __grid_constant__ TileArgs a) {
  using G = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // the staged epilogue's buffer sits between the ring and the barriers
  const uint32_t out0 = ring + G::STAGES * G::STAGE_BYTES;
  const uint32_t full0 = out0 + (STAGED ? G::OUT_BYTES : 0);
  const uint32_t empty0 = full0 + 8 * G::STAGES;
  const int kb_n = static_cast<int>((a.n + LBK - 1) / LBK);

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
    // TMA needs one thread; where some tile is predicated, all 128 run in
    // step (a named barrier every stage), so none laps a barrier's phase
    if (a.tma_all && pt != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    int fenced = -1;
    for (int64_t t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      const Tile x = locate<N, GROUPED>(t, a, &map_d);
      if (GROUPED && x.tma && pt == 0 && x.g != fenced) {
        tensormap_acquire(x.map);
        fenced = x.g;
      }
      for (int kb = 0; kb < kb_n; ++kb) {
        const uint32_t sa = ring + stage * G::STAGE_BYTES;
        const uint32_t sb = sa + G::A_BYTES;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        if (x.tma) {
          if (pt == 0) {
            mbar_expect_tx(full, G::STAGE_BYTES);
            if (kb < a.split)
              tma_load_2d(sa, x.map, full, kb * LBK, static_cast<int32_t>(x.row0));
            else
              tma_load_2d(sa, &map_d2, full, (kb - a.split) * LBK,
                          static_cast<int32_t>(x.row0));
            tma_load_2d(sb, &map_s, full, kb * LBK, static_cast<int32_t>(x.s_row));
          }
          if (!a.tma_all) asm volatile("bar.sync 1, 128;\n" ::: "memory");
        } else {
          // the swizzle TMA would produce: 16-byte chunk c of row r lands at
          // chunk c ^ (r % 8)
          for (int i = pt; i < LBM * (LBK / 16); i += 128) {
            const int r = i / (LBK / 16);
            const int c = i % (LBK / 16);
            const int64_t gr = x.row0 + r;
            const int64_t gk = static_cast<int64_t>(kb) * LBK + c * 16;
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (gr < x.m) {
              const uint8_t* src = x.d + gr * a.n + gk;
#pragma unroll
              for (int q = 0; q < 16; ++q) {
                if (gk + q < a.n) w[q / 4] |= static_cast<uint32_t>(src[q]) << (8 * (q % 4));
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
            tma_load_2d(sb, &map_s, full, kb * LBK, static_cast<int32_t>(x.s_row));
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
    uint32_t* buf = reinterpret_cast<uint32_t*>(
        smem_raw + (out0 - smem_u32(smem_raw)) + wg * (G::OUT_BYTES / 2));
    const bool vec = a.b % 4 == 0 && reinterpret_cast<uintptr_t>(a.c) % 16 == 0;
    uint32_t acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0u;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      const Tile x = locate<N, GROUPED>(t, a, &map_d);
      const int64_t row = x.row0 + wg * 64 + warp * 16 + lane / 4;
      const int64_t col = x.col + 2 * (lane % 4);
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
          if constexpr (STAGED)
            store_tile_staged<N>(acc, buf, x.c, x.m, a.b, x.row0 + wg * 64,
                                 x.col, kb >= CHUNK_STAGES, wg, vec);
          else
            store_tile<N>(acc, x.c, x.m, a.b, row, col, kb >= CHUNK_STAGES);
        }
      }
    }
  }
}

constexpr int PT = 64;                               // R tile of the prep kernel

// S[(c / bno) 4 bno + l bno + c % bno][k] = byte l of R'[k][c], where R'
// holds R's n rows at [0, n), (0 - R) mod 2^32 at [neg_at, neg_at + n) and
// zero elsewhere, past n16 and past b.  Grid z walks buckets: bucket z reads
// R + z r_step and writes S + z s_step.
__global__ void __launch_bounds__(256)
limb_planes_kernel(const uint32_t* __restrict__ R, uint8_t* __restrict__ S,
                   int64_t n, int64_t b, int64_t n16, int64_t b_pad, int bno,
                   int64_t neg_at, int64_t r_step, int64_t s_step) {
  __shared__ uint32_t T[PT][PT + 1];
  R += blockIdx.z * r_step;
  S += blockIdx.z * s_step;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * PT;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * PT;
  for (int i = threadIdx.x; i < PT * PT; i += 256) {
    const int kk = i / PT;
    const int cc = i % PT;
    const int64_t k = k0 + kk;
    const int64_t c = c0 + cc;
    uint32_t v = 0u;
    if (c < b) {
      if (k < n) v = R[k * b + c];
      else if (k >= neg_at && k - neg_at < n) v = 0u - R[(k - neg_at) * b + c];
    }
    T[kk][cc] = v;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// error codes of these files beside cudaError_t's (all >= 0)
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_ENCODE = -2;
constexpr int ERR_WIDTH = -3;
constexpr int ERR_ALIGN = -4;

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

// TMA reads a u8 operand of n bytes a row where the stride and the base are
// multiples of 16 bytes
bool d_by_tma(const void* D, int64_t n) {
  return n % 16 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0;
}

// R's limb planes into S (4 b_pad rows of n16 bytes; `groups` of them, one
// a bucket, R advancing n * b words and S 4 b_pad * n16 bytes between them),
// with (0 - R) at contraction rows [neg_at, neg_at + n)
template <int N>
int launch_planes(const void* R, void* S, int64_t n, int64_t b, int64_t n16,
                  int64_t neg_at, int64_t groups, cudaStream_t stream) {
  constexpr int BNO = Cfg<N>::BNO;
  const int64_t b_pad = (b + BNO - 1) / BNO * BNO;
  const dim3 grid(static_cast<unsigned>((n16 + PT - 1) / PT),
                  static_cast<unsigned>((b_pad + PT - 1) / PT),
                  static_cast<unsigned>(groups));
  limb_planes_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const uint32_t*>(R), static_cast<uint8_t*>(S), n, b, n16,
      b_pad, BNO, neg_at, n * b, 4 * b_pad * n16);
  return static_cast<int>(cudaGetLastError());
}

// one persistent CTA per SM (at most one per tile)
template <int N, bool GROUPED, bool STAGED>
int launch_tile(const CUtensorMap& map_d, const CUtensorMap& map_d2,
                const CUtensorMap& map_s, const TileArgs& a,
                cudaStream_t stream) {
  if (a.n_tiles == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t grid = a.n_tiles < sms ? a.n_tiles : sms;
  constexpr int smem = Cfg<N>::smem(STAGED);
  cudaFuncSetAttribute(limb_gemm_kernel<N, GROUPED, STAGED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  limb_gemm_kernel<N, GROUPED, STAGED><<<static_cast<unsigned>(grid),
                                         LTHREADS, smem, stream>>>(
      map_d, map_d2, map_s, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
