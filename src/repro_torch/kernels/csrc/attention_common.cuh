// Helpers shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, paged_attention.cu): f32 <-> input-type
// conversion and 16-byte chunk loads of one row of a (.., D) tensor with a
// contiguous, 16-byte aligned D axis; and the Hopper machinery of the bf16
// tensor-core kernels (sm_90a): mbarriers, TMA tile loads through 4-D
// tensor maps over (D, S, heads, B) views, wgmma shared-memory descriptors
// for 64-column (128-byte swizzle) or 32-column (64-byte swizzle) boxes
// (and the 32- or 16-column tail boxes at D 96 and 80), the
// m64nNk16 bf16 products (N up to 256), and register shares by
// setmaxnreg.  At D 80 and 96 a row is a 64-column box and a tail box of
// its last 16 or 32 columns; at D 112 two 64-column boxes, the second
// reaching 16 columns past the row, which TMA fills with zeros (Cols<D>):
// both flash kernels, forward and backward, load and read their tiles
// through the same helpers.
//
// Each kernel is compiled at a few widths W, its instances; a head dim D
// up to 256 whose rows are whole 16-byte chunks runs on the smallest W at
// or above it.  The tensor maps cover the view's true D columns in W's
// boxes (encode_cols), so TMA fills every tile's columns D .. W - 1 with
// zeros, every product runs at W over those zeros (which add nothing),
// and no kernel stores a column at or past D.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (one chunk) as f32, in one vector load: the launchers
// require every row to start on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* src, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
}

struct Strides {  // element strides of a (B, S, heads, D) view
  long long b, s, h;
};

constexpr int kErrTensorMap = -1;  // cuTensorMapEncodeTiled refused a map

// ---------------------------------------------------------------------------
// Hopper: tiles in shared memory, TMA, wgmma
// ---------------------------------------------------------------------------

// the instances at which bf16 runs the tensor-core kernels (every one; f32
// runs the CUDA cores): both directions load a row of D 80 or 96 as a
// whole box and a narrower tail box, and one of D 112 as two whole boxes
// (Cols<D>); at D 256 each direction
// runs a geometry of its own (Geom<D> of each source): the forward two K/V
// stages and a producer warpgroup that hands its registers to the
// consumers, the backward 64-row blocks whose two consumer warpgroups
// split each tile pair's products between them, since one warpgroup's f32
// dK and dV of 64 keys x 256 columns would not fit its 240 registers
template <int D>
constexpr bool kTensorCoresFwd = D == 32 || D == 64 || D == 80 || D == 96 ||
                                 D == 112 || D == 128 || D == 256;
template <int D>
constexpr bool kTensorCoresBwd = D == 32 || D == 64 || D == 80 || D == 96 ||
                                 D == 112 || D == 128 || D == 256;

// the key tiles [lo, hi) of `tile` keys that hold an unmasked key for some
// query row of [r_lo, r_hi) (r_lo < r_hi <= S)
template <int TILE>
__device__ __forceinline__ void key_tiles(int r_lo, int r_hi, int S,
                                          int causal, int window, int& lo,
                                          int& hi) {
  hi = (S + TILE - 1) / TILE;
  if (causal) hi = min(hi, (r_hi + TILE - 1) / TILE);
  lo = window > 0 ? max(0, r_lo - window + 1) / TILE : 0;
}

// the wgmma descriptor's code of a swizzle of `sw` bytes (128, 64 or 32)
constexpr int swizzle_layout(int sw) {
  return sw == 128 ? 1 : sw == 64 ? 2 : 3;
}

// The box geometry of a bf16 tile with D columns (D 32, 64, 112, 128 or
// 256): boxes of AC columns (SW bytes a row, swizzled by SW), NB boxes a
// row (at D 112 the second box's last 16 columns lie past the row: TMA
// fills them with zeros); LAYOUT is the wgmma descriptor's code for that
// swizzle.  A tile of R rows holds its boxes one after another, R * SW
// bytes each, and starts on a 1024-byte boundary.
template <int D>
struct Swz {
  static constexpr int SW = D == 32 ? 64 : 128;
  static constexpr int AC = SW / 2;
  static constexpr int NB = (D + AC - 1) / AC;
  static constexpr int LAYOUT = swizzle_layout(SW);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the NB boxes of rows [row, row + rows) of (head, batch) into the tile at
// `dst` (`rows` rows a box), completing on `bar`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row,
                                         int head, int batch) {
  using W = Swz<D>;
#pragma unroll
  for (int c = 0; c < W::NB; ++c)
    tma_load(dst + c * rows * W::SW, map, bar, c * W::AC, row, head, batch);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// Columns 16 kk .. 16 kk + 15 of the 64 rows at `rows0` of a tile of
// `rows` rows a box, as a K-major operand (the tile's rows are M or N, its
// columns the reduction): 32-byte steps inside a box.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t rows0, int rows,
                                                int kk) {
  using W = Swz<D>;
  const int box = kk / (W::AC / 16);
  const uint32_t off = box * rows * W::SW + (kk % (W::AC / 16)) * 32;
  // the start address is the low field: an offset adds to it (shared
  // memory addresses stay below 2^18), so the base descriptor is shared
  return desc(rows0, 16, 8 * W::SW, W::LAYOUT) + (off >> 4);
}

// Rows 16 kk .. 16 kk + 15 of a tile of `rows` rows a box, as an N-major B
// operand (the tile's rows are the reduction, its D columns N): boxes are
// the 64-column atoms along N (LBO), 8-row groups along K (SBO).
template <int D>
__device__ __forceinline__ uint64_t desc_nmajor(uint32_t tile, int rows,
                                                int kk) {
  using W = Swz<D>;
  return desc(tile, rows * W::SW, 8 * W::SW, W::LAYOUT) + kk * W::SW;
}

// The columns of a bf16 tile at head dim D as TMA loads them and wgmma
// reads them: a main part of MAIN columns in whole boxes (Swz<MAIN>: 64
// columns and the 128-byte swizzle, or one 32-column box and the 64-byte
// swizzle at D 32) and, at D 80 and 96, a tail box of the last TAIL = 16
// or 32 columns, whose row of TSW = 32 or 64 bytes is its own swizzle.  At
// D 112 the last 48 columns (96 bytes) have no swizzle of their width, so
// the main part is all 112 in two 64-column boxes, the second of which TMA
// fills past column 111 with zeros.  A tile of R rows holds the main part
// (R * MAIN_BYTES bytes), then the tail box (R * TSW bytes).  Every
// product runs at the true width: a reduction over D takes MAIN / 16
// k-steps through the main part and TAIL / 16 through the tail box (the
// zero columns are never read); a product with N = D is an n-MAIN product
// (n112 reads the second box's first 48 columns) and an n-TAIL one into
// an accumulator of its own.
template <int D>
struct Cols {
  static constexpr int MAIN = D == 32 || D % 64 == 48 ? D : D / 64 * 64;
  static constexpr int TAIL = D - MAIN;
  static constexpr int TSW = 2 * TAIL;
  static constexpr int TLAYOUT = swizzle_layout(TSW);
  // a row of the main part, and of the whole tile, in shared memory
  static constexpr int MAIN_BYTES = Swz<MAIN>::NB * Swz<MAIN>::SW;
  static constexpr int ROW_BYTES = MAIN_BYTES + TSW;
  static_assert(TAIL == 0 || TAIL == 16 || TAIL == 32,
                "a tail box of 16 or 32 columns");
};

// Rows [row, row + rows) of (head, batch) into the tile at `dst`: the main
// part's boxes from `map`, the tail box from `tail` (a map over the view
// from column MAIN on), completing on `bar`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          const CUtensorMap* tail,
                                          uint32_t bar, int rows, int row,
                                          int head, int batch) {
  using C = Cols<D>;
  tma_tile<C::MAIN>(dst, map, bar, rows, row, head, batch);
  if constexpr (C::TAIL > 0)
    tma_load(dst + rows * C::MAIN_BYTES, tail, bar, 0, row, head, batch);
}

// Columns 16 kk .. 16 kk + 15 of the 64 rows at `rows0` of a tail box, as
// a K-major operand
template <int D>
__device__ __forceinline__ uint64_t desc_tail_kmajor(uint32_t rows0, int kk) {
  using C = Cols<D>;
  return desc(rows0, 16, 8 * C::TSW, C::TLAYOUT) + kk * 2;
}

// Rows 16 kk .. 16 kk + 15 of a tail box of `rows` rows, as an N-major B
// operand (its TAIL columns N)
template <int D>
__device__ __forceinline__ uint64_t desc_tail_nmajor(uint32_t box, int rows,
                                                     int kk) {
  using C = Cols<D>;
  return desc(box, rows * C::TSW, 8 * C::TSW, C::TLAYOUT) + kk * C::TSW;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of wgmma accumulators above the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// this warpgroup's registers a thread: raise (consumers) or lower
// (producer) to N; every warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[0..32) += A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..8) += A (64 x 16, registers) * B (16 x 16, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..16) += A (64 x 16, registers) * B (16 x 32, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..32) += A (64 x 16, registers) * B (16 x 64, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..56) += A (64 x 16, registers) * B (16 x 112, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A (64 x 16, registers) * B (16 x 128, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..128) += A (64 x 16, registers) * B (16 x 256, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..D/2) += A (64 x 16, registers) * B (16 x D, shared, N-major)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  if constexpr (D == 112) wgmma_rs_n112(d, a, db);
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  if constexpr (D == 256) wgmma_rs_n256(d, a, db);
}

// One warpgroup's 64 rows at row `row` of a tile of `rows` rows at `tile`:
// its main part's rows and its tail box's (Cols<D>).
template <int D>
struct Rows64 {
  uint32_t main, tail;
  __device__ __forceinline__ Rows64(uint32_t tile, int rows, int row) {
    using C = Cols<D>;
    main = tile + row * Swz<C::MAIN>::SW;
    tail = tile + rows * C::MAIN_BYTES + row * C::TSW;
  }
};

// d[0..32) += A B^T over the D columns of both (64 rows each, K-major):
// MAIN / 16 k-steps through the main parts, TAIL / 16 through the tail
// boxes; `a_rows` and `b_rows` are the row counts of the tiles A and B
// lie in (the main part's box stride)
template <int D>
__device__ __forceinline__ void wgmma_over_d(float (&d)[32], Rows64<D> a,
                                             int a_rows, Rows64<D> b,
                                             int b_rows) {
  using C = Cols<D>;
#pragma unroll
  for (int kk = 0; kk < C::MAIN / 16; ++kk)
    wgmma_ss_n64(d, desc_kmajor<C::MAIN>(a.main, a_rows, kk),
                 desc_kmajor<C::MAIN>(b.main, b_rows, kk));
#pragma unroll
  for (int kk = 0; kk < C::TAIL / 16; ++kk)
    wgmma_ss_n64(d, desc_tail_kmajor<D>(a.tail, kk),
                 desc_tail_kmajor<D>(b.tail, kk));
}

// (acc, acc_t) += (hi + lo) B over rows 16 kk .. 16 kk + 15 of the tile
// of `rows` rows at `tile` read N-major (its D columns N): the main part's
// n-MAIN product into acc, the tail box's n-TAIL product into acc_t (one
// element, unused, at TAIL 0)
template <int D>
__device__ __forceinline__ void wgmma_rs_d(
    float (&acc)[Cols<D>::MAIN / 2],
    float (&acc_t)[Cols<D>::TAIL > 0 ? Cols<D>::TAIL / 2 : 1],
    const uint32_t* hi, const uint32_t* lo, uint32_t tile, int rows,
    int kk) {
  using C = Cols<D>;
  const uint64_t b = desc_nmajor<C::MAIN>(tile, rows, kk);
  wgmma_rs<C::MAIN>(acc, hi, b);
  wgmma_rs<C::MAIN>(acc, lo, b);
  if constexpr (C::TAIL > 0) {
    const uint64_t bt =
        desc_tail_nmajor<D>(tile + rows * C::MAIN_BYTES, rows, kk);
    wgmma_rs<C::TAIL>(acc_t, hi, bt);
    wgmma_rs<C::TAIL>(acc_t, lo, bt);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 (neighbouring columns of an accumulator row) as a register
// operand of bf16 hi = bf16(x) and lo = bf16(x - hi), summed by multiplying
// both into one f32 accumulator
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime, so that
// the library links without -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-D map over the bf16 (cols, S, heads, B) view at `ptr`, read in boxes
// of (`box_cols` columns, `rows` rows) swizzled by `sw` bytes (128, 64 or
// 32; box_cols * 2 <= sw); rows past S and columns past `cols` read as
// zeros
inline bool encode_box(CUtensorMap* map, const void* ptr, int cols, int S,
                       int heads, int B, Strides st, int rows, int box_cols,
                       int sw) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  // the stride of an axis of length 1 is never stepped (PyTorch may give
  // it as 0); TMA wants a nonzero one
  auto stride = [](long long s, int n) {
    return static_cast<cuuint64_t>(n == 1 && s == 0 ? 16 : 2 * s);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {stride(st.s, S), stride(st.h, heads),
                                 stride(st.b, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of a tile of the instance with D columns and `rows` rows over
// the bf16 (cols, S, heads, B) view at `ptr`, cols <= D (Cols<D>): the
// main part's boxes over the view's first min(cols, MAIN) columns into
// `map` and, at D 80 and 96, the tail box over the view from column MAIN
// on (cols > MAIN there) into `tail`, which is left as it is otherwise.
// Columns cols .. D - 1 of every box read as zeros (at D 112 and cols 112,
// the second box's last 16).
template <int D>
bool encode_cols(CUtensorMap* map, CUtensorMap* tail, const void* ptr,
                 int cols, int S, int heads, int B, Strides st, int rows) {
  using C = Cols<D>;
  using W = Swz<C::MAIN>;
  if (!encode_box(map, ptr, cols < C::MAIN ? cols : C::MAIN, S, heads, B, st,
                  rows, W::AC, W::SW))
    return false;
  if constexpr (C::TAIL > 0)
    return cols > C::MAIN &&
           encode_box(tail, static_cast<const __nv_bfloat16*>(ptr) + C::MAIN,
                      cols - C::MAIN, S, heads, B, st, rows, C::TAIL, C::TSW);
  return true;
}

}  // namespace attn
