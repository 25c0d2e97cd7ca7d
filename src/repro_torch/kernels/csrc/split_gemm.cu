// Ozaki INT8 split-GEMM kernels for Hopper (sm_90a).
//
// Three kernels compute the compensated-f32 (df32) fold of the Ozaki
// scheme's slice-pair products:
//
//   for each output tile, for each pair p = (ii[p], jj[p]) with
//   ii + jj < s in schedule order, for each k-tile of width block_k:
//     part = A_slice[ii[p]][:, ktile] @ B_slice[jj[p]][ktile, :]  (int32)
//     term = float(part) * 2**wexp[p]
//     (hi, err) = TwoSum(hi, term);  lo += err
//
// K1 and K2 index the slices through the pair schedule; K3 reads
// pre-gathered pair copies and a per-pair f32 weight array instead.
//
// The fold order (pair-major, then k-tile, then TwoSum) is part of the
// result's bits and follows the reference exactly.  Inside one k-tile
// the int32 partial is exact (|part| <= 512 * 2**12 < 2**24) and may be
// summed in any order, and the partials of different pairs may be
// computed in any order: only the order of the folds is fixed.  All
// float arithmetic in the fold and in the slicing recurrence uses the
// explicit round-to-nearest intrinsics (__fadd_rn, __fsub_rn,
// __fmul_rn), so no FMA contraction or reassociation can change a bit;
// the library is also built with -fmad=false and never with
// --use_fast_math.
//
// All kernels launch from plain C functions (no PyTorch headers) that
// return the cudaError_t of cudaGetLastError(); the Python wrapper in
// repro_torch/kernels/ops.py binds them with ctypes and raises on a
// non-zero code.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int CTA_M = 64;     // output rows per CTA
constexpr int CTA_N = 64;     // output cols per CTA
constexpr int KC = 128;       // k-chunk staged in shared memory (bytes)
constexpr int LDS = KC + 16;  // padded smem row stride (bytes)
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid, 32x32 each
constexpr int MAX_PAIRS = 136;  // s <= 16

// The pair schedule travels as a kernel parameter (__grid_constant__),
// i.e. in the parameter constant bank: every thread reads the same entry
// each step, and no thread copies it to local memory.
struct PairSchedule {
  int num_pairs;
  signed char ii[MAX_PAIRS];
  signed char jj[MAX_PAIRS];
  short wexp[MAX_PAIRS];
};

// Exact f32 2**e from its exponent bits (e in [0, 127) here).
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// Knuth TwoSum folded into (hi, lo): the reference's _accumulate.
__device__ __forceinline__ void fold(float& hi, float& lo, int part,
                                     float w) {
  const float term = __fmul_rn(__int2float_rn(part), w);
  const float s = __fadd_rn(hi, term);
  const float bp = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bp)),
                              __fsub_rn(term, bp));
  hi = s;
  lo = __fadd_rn(lo, err);
}
// 1.5 * 2**23.  For |x| < 2**22, x + ROUND_MAGIC rounds x to an integer
// (half to even, as rintf) held in the low mantissa bits, on the
// full-rate FP32 pipe instead of the conversion unit's.
constexpr float ROUND_MAGIC = 12582912.0f;

// One step of the reference's slice_step recurrence on the f32 pair
// (h, l): q = rint(h*radix + l*radix) (round half to even, as
// jnp.round), residue renormalized by TwoSum into (h, l).  Returns an
// int whose low byte is q's two's complement (|q| <= 2**7 here).
__device__ __forceinline__ int slice_step(float& h, float& l, float radix) {
  const float yh = __fmul_rn(h, radix);
  const float yl = __fmul_rn(l, radix);
  const float big = __fadd_rn(__fadd_rn(yh, yl), ROUND_MAGIC);
  const float q = __fsub_rn(big, ROUND_MAGIC);
  const float r = __fsub_rn(yh, q);
  const float s = __fadd_rn(r, yl);
  const float bp = __fsub_rn(s, r);
  l = __fadd_rn(__fsub_rn(r, __fsub_rn(s, bp)), __fsub_rn(yl, bp));
  h = s;
  return __float_as_int(big);
}

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) |
         ((uint32_t)(q2 & 0xff) << 16) | ((uint32_t)(q3 & 0xff) << 24);
}

// ---- PTX building blocks --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
// (src-size 0: nothing is read from `src`).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy, for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x16-byte matrices from shared memory; lane l gives the address
// of row (l % 8) of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* src) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(src)));
}

// Not volatile: a pure function of its registers, so the compiler may
// interleave it with the (volatile, ordered) ldmatrix loads.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16x32-byte A fragment (rows r0.., k-major rows of stride lds) for
// mma m16n8k32: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7,
// 16-31), (8-15, 16-31) are a0..a3.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const int8_t* base, int lds,
                                            int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(a, base + row * lds + (lane >> 4) * 16);
}

// B fragments of two n8 tiles from k-major rows Bs[n][k]: b[0], b[1]
// for columns 0-7 and b[2], b[3] for columns 8-15.
__device__ __forceinline__ void load_b_frag(uint32_t (&b)[4],
                                            const int8_t* base, int lds,
                                            int lane) {
  const int row = (lane & 7) + (lane >> 4) * 8;
  ldmatrix_x4(b, base + row * lds + ((lane >> 3) & 1) * 16);
}

// ---- K1 ----------------------------------------------------------------
//
// K1 — replaces src/repro/kernels/ops.py::split_gemm_pallas (body
// _split_gemm_kernel_v2, helpers _accumulate, _pow2_f32).
//
// Inputs: a_sl (s, m, k) and, k-major, b_sl_t (s, n, k) int8 slice
// stacks (ozaki_matmul slices B k-major directly: no transpose pass).
// Output: the pair (hi, lo), or, in ozaki_matmul's float32 and float64
// calls, the finished product (see the epilogue below).
//
// Bound on an H100 SXM: int8 ops 2*m*n*k*P (P = s(s+1)/2) at 1,979 TOPS
// dense, against bytes s*(m*k + k*n) + 8*m*n at 3.35 TB/s (4*m*n for a
// finished float32 product); the ops are the larger at every shape the
// main paths give it.  What held K1's
// first, simple design far above that bound: mma.sync fed by synchronous
// staging with a byte-wise transpose of B, every CTA re-reading the slice
// layers once per pair (P times, not s), and one serial chain of
// P*chunks steps per CTA whatever the grid.
//
// Design.  A CTA of WM warpgroups owns a (64*WM) x BN output tile; each
// warpgroup owns 64 rows and runs wgmma m64nBNk32 (s8, both operands
// K-major in shared memory), and hi/lo stay in registers (ldmatrix-fed
// mma.sync on the same bytes was no faster anywhere and 1.4x slower at
// the MuST shape, PERF.md).  Operands reach shared memory by TMA (one
// thread issues a 128-byte-wide box per operand, completion counted on
// an mbarrier) in wgmma's 128-byte-swizzled K-major layout; rows whose k
// is not a multiple of 16 (TMA needs 16-byte strides) are written byte
// by byte into the same layout.  Two partial buffers alternate, so the
// MMAs of one (pair, k-tile) run while the previous one folds: the fold
// stays pair-major, then k-tile, then TwoSum.  Two modes, picked per
// launch by tile_model.k1_plan:
//
// * resident (one k-tile, every MuST GEMM): the CTA loads its rows of
//   all s slice layers once, one mbarrier per layer, and runs the pairs
//   in schedule order from shared memory, waiting for layers 0..d
//   when the first pair that reads layer d comes.  Each CTA moves s
//   layers, not P: s*(BM+BN)*k bytes (196,608 at 64x64, k = 256, s = 6;
//   s = 8, 9 take the 64x32 tile or stream).
// * streamed (several k-tiles, the LM's GEMMs): the k-tiles of the pairs
//   in fold order, each as 128-byte chunks through a ring released by
//   an mbarrier once every warp's MMAs on a stage are done (k1_stages
//   deep, so that three single-warpgroup CTAs share an SM).  A CTA reads
//   P*(BM+BN)*k bytes: at (512, 960, 2560), s = 6, 64x64 tiles, 320 x
//   21 x 128 x 960 = 826 MB of L2 per launch (the 64x32 tile 1.24 GB,
//   128x64 619 MB, but on fewer CTAs than SMs).
//
// What bounds it now (PERF.md): at the MuST shape the resident CTAs'
// per-pair chain (eight dependent wgmmas and a fold, one CTA per SM);
// on the LM's large GEMMs the L2 reads (~5 TB/s reached), on its small
// grids one CTA's chain of chunks (~0.6 us each).
//
// Epilogue.  Each thread holds its elements' hi and lo in registers at
// the end.  With K1_OUT_PAIR it stores them; with K1_OUT_F32 or _F64
// (K1Args::out_kind, a runtime branch, so the instances stay
// split_gemm_kernel<WM,BN,RESIDENT>) it stores the finished product
// instead, repeating the torch combine that ozaki_matmul ran after the
// kernel, one rounding for one:
//   c = (hi + lo) * deferred;  sc = out(sigma_a[row] * sigma_b[col]);
//   store c * sc
// with deferred = 2**(-slice_bits*(s+1)), the sigma product in float64
// and everything else in the output's type (hi and lo widen exactly to
// float64).  Each step is one _rn intrinsic, so the bits are the torch
// combine's.  That drops five elementwise kernels over (m, n) and the
// (hi, lo) round trip through device memory per call.
//
// One k-tile's int32 partial is exact, so the order of the MMAs inside
// it is free; only the folds are ordered.
constexpr int K1_KC = 128;     // k-bytes of one swizzled block / chunk
constexpr int K1_KSTEP = 32;   // k-bytes per MMA step
constexpr int K1_MAX_LAYERS = 16;

// Streamed ring depth per tile: as many 128-byte chunks as leave room
// for three CTAs per SM (64 x 32: 6, 64 x 64: 4), and 8 for 128 x 64,
// which runs one CTA per SM.
__host__ __device__ constexpr int k1_stages(int bm, int bn) {
  return bm + bn == 96 ? 6 : bm + bn == 128 ? 4 : 8;
}

// Shared-memory layout of an operand block of R rows: k-blocks of R
// rows x 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8) of its row (TMA's and wgmma's 128-byte swizzle; the block
// starts 1024-byte aligned, since the swizzle reads address bits 7-9 as
// the row within eight).
__device__ __forceinline__ int k1_at(int R, int row, int kb) {
  return ((kb >> 7) * R + row) * 128 + ((((kb >> 4) & 7) ^ (row & 7)) << 4) +
         (kb & 15);
}

// Rows [r0, r0 + R) x k-bytes [kc, kc + kb_len) of a row-major (rows,
// k) int8 matrix into that layout byte by byte, zero outside (rows,
// k): the path for k % 16 != 0, where TMA cannot address the rows.
template <int R, int NT>
__device__ __forceinline__ void k1_bytes(int8_t* dst,
                                         const int8_t* __restrict__ src,
                                         int r0, int rows, int kc,
                                         int kb_len, int k) {
  for (int idx = threadIdx.x; idx < R * kb_len; idx += NT) {
    const int row = idx / kb_len, kb = idx % kb_len;
    const int gr = r0 + row, gk = kc + kb;
    dst[k1_at(R, row, kb)] =
        (gr < rows && gk < k) ? src[(size_t)gr * k + gk] : 0;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of asynchronous copies on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// TMA: the box at (c0 = k-byte, c1 = row, c2 = layer) of a 3-D (k, rows,
// layers) tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy writes to shared memory (the byte path) ordered before
// the async proxy's wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator written by an
// asynchronous wgmma above the wait that completes it.
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 128-byte-swizzle K-major wgmma descriptor: p is the operand's first
// row, plus the k step's byte offset (0, 32, 64, 96) inside its
// 128-byte block; 8-row groups lie SBO = 1024 bytes apart (LBO is not
// used by swizzled K-major layouts).
__device__ __forceinline__ uint64_t k1_desc(const int8_t* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma m64n64k32, s8 x s8 -> s32, both operands K-major in shared
// memory; d (the warpgroup's accumulator fragment) is overwritten when
// scale_d == 0 and accumulated into otherwise.
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma m64n32k32, s8 x s8 -> s32, both operands K-major in shared
// memory; d (the warpgroup's accumulator fragment) is overwritten when
// scale_d == 0 and accumulated into otherwise.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One 32-byte k step (step st of the operands' k range) of a
// warpgroup's 64 x BN partial: as is the A block (ra rows) at the
// warpgroup's first row, bs the B block (rb rows); `first` starts the
// partial.
template <int BN>
__device__ __forceinline__ void k1_mma(int (&acc)[BN / 2], const int8_t* as,
                                       int ra, const int8_t* bs, int rb,
                                       int st, bool first) {
  const int off = (st >> 2) * 128, kb = (st & 3) * 32;
  const uint64_t da = k1_desc(as + off * ra + kb);
  const uint64_t db = k1_desc(bs + off * rb + kb);
  if constexpr (BN == 64)
    wgmma_n64(acc, da, db, first ? 0 : 1);
  else
    wgmma_n32(acc, da, db, first ? 0 : 1);
}

template <int N>
__device__ __forceinline__ void fold_all(float (&hi)[N], float (&lo)[N],
                                         int (&acc)[N], float w) {
  pin(acc);
#pragma unroll
  for (int i = 0; i < N; ++i) fold(hi[i], lo[i], acc[i], w);
}

// What K1's epilogue writes (K1Args::out_kind): the pair (hi, lo) as it
// stands, or the finished product in float32 or float64.
constexpr int K1_OUT_PAIR = 0;
constexpr int K1_OUT_F32 = 1;
constexpr int K1_OUT_F64 = 2;

// The finished product's factors: deferred = 2**(-slice_bits*(s+1))
// and the operands' float64 sigma vectors, m and n long (unused for
// K1_OUT_PAIR).
struct K1Epilogue {
  const double* sigma_a;
  const double* sigma_b;
  double deferred;
  int kind;
};

// A thread's elements of its warpgroup's 64 x BN tile that lie inside
// (m, n): f(at, row, col, i) with i the element's index in hi/lo.
// Element c of n8 tile j sits at row r0 + 8 * (c >= 2), column c0 + 8j
// + (c & 1) (the wgmma accumulator fragment).
template <int NA, typename F>
__device__ __forceinline__ void k1_each(int r0, int c0, int m, int n,
                                        F&& f) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + (c >= 2 ? 8 : 0), col = c0 + 8 * j + (c & 1);
      if (row < m && col < n) f((size_t)row * n + col, row, col, 4 * j + c);
    }
}

// Streamed single-warpgroup tiles are held to 170 registers, so that
// three CTAs share an SM.
template <int WM, int BN, bool RESIDENT>
__global__ void __launch_bounds__(128 * WM, RESIDENT || WM > 1 ? 1 : 3)
split_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const int8_t* __restrict__ a_sl,
                  const int8_t* __restrict__ b_sl_t,
                  void* __restrict__ out, float* __restrict__ lo_out,
                  int m, int k, int n, int block_k, int num_layers,
                  int use_tma, const __grid_constant__ PairSchedule sched,
                  const K1Epilogue ep) {
  constexpr int BM = 64 * WM, NT = 128 * WM, NA = BN / 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ uint64_t bars[2 * K1_MAX_LAYERS];
  // The swizzle atoms need 1024-byte alignment; the launcher adds the
  // slack.
  int8_t* sm = reinterpret_cast<int8_t*>(smem) +
               ((1024 - (smem_u32(smem) & 1023)) & 1023);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (threadIdx.x >> 7) * 64;
  const size_t a_layer = (size_t)m * k, b_layer = (size_t)n * k;
  const bool tma = use_tma != 0;
  const bool leader = threadIdx.x == 0;
  const int num_pairs = sched.num_pairs;

  // Resident: one "full" barrier per layer.  Streamed: per stage a
  // "full" barrier (the leader's TMA, or every thread's byte stores)
  // and an "empty" one (every warp done with the stage).
  if (leader) {
    for (int i = 0; i < K1_MAX_LAYERS; ++i) {
      mbar_init(&bars[i], RESIDENT || tma ? 1 : NT);
      mbar_init(&bars[K1_MAX_LAYERS + i], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float hi[NA], lo[NA];
  int acc0[NA], acc1[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    hi[i] = lo[i] = 0.0f;
    acc0[i] = acc1[i] = 0;
  }

  if constexpr (RESIDENT) {
    const int kp = (k + K1_KC - 1) / K1_KC * K1_KC;
    const int layer = (BM + BN) * kp;
    if (tma) {
      if (leader) {
        for (int t = 0; t < num_layers; ++t) {
          int8_t* dst = sm + t * layer;
          mbar_expect(&bars[t], layer);
          for (int kc = 0; kc < kp; kc += K1_KC) {
            tma_load(dst + kc * BM, &map_a, &bars[t], kc, m0, t);
            tma_load(dst + BM * kp + kc * BN, &map_b, &bars[t], kc, n0, t);
          }
        }
      }
    } else {
      for (int t = 0; t < num_layers; ++t) {
        k1_bytes<BM, NT>(sm + t * layer, a_sl + t * a_layer, m0, m, 0, kp,
                         k);
        k1_bytes<BN, NT>(sm + t * layer + BM * kp, b_sl_t + t * b_layer,
                         n0, n, 0, kp, k);
      }
      fence_proxy_async();
      __syncthreads();
    }
    const int steps = kp / K1_KSTEP;
    int ready = -1;
#pragma unroll 1
    for (int p = 0; p < num_pairs; ++p) {
      const int i = sched.ii[p], j = sched.jj[p];
      while (ready < max(i, j)) {  // layers this pair is first to need
        ++ready;
        if (tma) mbar_wait(&bars[ready], 0);
      }
      const int8_t* as = sm + i * layer + wm0 * 128;
      const int8_t* bs = sm + j * layer + BM * kp;
      auto issue = [&](int (&acc)[NA]) {
        wgmma_fence();
#pragma unroll 1
        for (int st = 0; st < steps; ++st)
          k1_mma<BN>(acc, as, BM, bs, BN, st, st == 0);
        wgmma_commit();
      };
      // Pair p - 1 folds from the other buffer while pair p multiplies
      // (written per buffer, so that ptxas sees the fold read only
      // registers no pending wgmma writes).
      const float w = p > 0 ? pow2f(sched.wexp[p - 1]) : 0.0f;
      if (p & 1) {
        issue(acc1);
        wgmma_wait<1>();  // pair p - 1 is done
        fold_all(hi, lo, acc0, w);
      } else {
        issue(acc0);
        wgmma_wait<1>();
        if (p > 0) fold_all(hi, lo, acc1, w);
      }
    }
    wgmma_wait<0>();
    const float w = pow2f(sched.wexp[num_pairs - 1]);
    if ((num_pairs - 1) & 1)
      fold_all(hi, lo, acc1, w);
    else
      fold_all(hi, lo, acc0, w);
  } else {
    constexpr int S = k1_stages(BM, BN);
    constexpr int SB = (BM + BN) * K1_KC;
    uint64_t* full = bars;
    uint64_t* empty = bars + K1_MAX_LAYERS;
    const int nck = (k + K1_KC - 1) / K1_KC;
    const int per_tile = block_k / K1_KC;
    const int nkt = (k + block_k - 1) / block_k;
    const int total = num_pairs * nck;
    // Stage chunk f into slot f % S once every thread has released the
    // slot's previous chunk: by TMA from the leader, or byte by byte by
    // all threads.
    auto load = [&](int f) {
      const int slot = f % S, use = f / S;
      const int p = f / nck, kc = (f % nck) * K1_KC;
      int8_t* st = sm + slot * SB;
      if (tma) {
        if (leader) {
          if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
          mbar_expect(&full[slot], SB);
          tma_load(st, &map_a, &full[slot], kc, m0, sched.ii[p]);
          tma_load(st + BM * K1_KC, &map_b, &full[slot], kc, n0,
                   sched.jj[p]);
        }
      } else {
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        k1_bytes<BM, NT>(st, a_sl + sched.ii[p] * a_layer, m0, m, kc, K1_KC,
                         k);
        k1_bytes<BN, NT>(st + BM * K1_KC, b_sl_t + sched.jj[p] * b_layer,
                         n0, n, kc, K1_KC, k);
        fence_proxy_async();
        mbar_arrive(&full[slot]);
      }
    };
    for (int f = 0; f < S && f < total; ++f) load(f);
    // The k-tiles of all pairs in fold order, alternating the two
    // partial buffers; f counts chunks.  Tile u - 1 folds from the other
    // buffer while tile u's first chunk multiplies (the buffers are
    // fixed per call, so that ptxas sees the fold read only registers
    // no pending wgmma writes).
    int f = 0;
    auto run_tile = [&](int (&acc)[NA], int (&prev)[NA], int u) {
      const int c0 = (u % nkt) * per_tile;
      const int c1 = min(nck, c0 + per_tile);
#pragma unroll 1
      for (int c = c0; c < c1; ++c, ++f) {
        mbar_wait(&full[f % S], (f / S) & 1);
        const int8_t* st = sm + (f % S) * SB;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < K1_KC / K1_KSTEP; ++q)
          k1_mma<BN>(acc, st + wm0 * 128, BM, st + BM * K1_KC, BN, q,
                     c == c0 && q == 0);
        wgmma_commit();
        wgmma_wait<1>();
        // Chunk f - 1's MMAs are done: release its slot (one arrival
        // per warp), and refill it.
        if (f > 0) {
          __syncwarp();
          if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[(f - 1) % S]);
          if (f - 1 + S < total) load(f - 1 + S);
        }
        if (c == c0 && u > 0)
          fold_all(hi, lo, prev, pow2f(sched.wexp[(u - 1) / nkt]));
      }
    };
    const int tiles = num_pairs * nkt;
#pragma unroll 1
    for (int u = 0; u < tiles; u += 2) {
      run_tile(acc0, acc1, u);
      if (u + 1 < tiles) run_tile(acc1, acc0, u + 1);
    }
    wgmma_wait<0>();
    const float w = pow2f(sched.wexp[num_pairs - 1]);
    if ((tiles - 1) & 1)
      fold_all(hi, lo, acc1, w);
    else
      fold_all(hi, lo, acc0, w);
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = m0 + wm0 + warp * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  if (ep.kind == K1_OUT_F32) {
    const float d = __double2float_rn(ep.deferred);
    float* o = static_cast<float*>(out);
    k1_each<NA>(r0, c0, m, n, [&](size_t at, int row, int col, int i) {
      const float c = __fmul_rn(__fadd_rn(hi[i], lo[i]), d);
      const float sc = __double2float_rn(
          __dmul_rn(__ldg(ep.sigma_a + row), __ldg(ep.sigma_b + col)));
      o[at] = __fmul_rn(c, sc);
    });
  } else if (ep.kind == K1_OUT_F64) {
    double* o = static_cast<double*>(out);
    k1_each<NA>(r0, c0, m, n, [&](size_t at, int row, int col, int i) {
      const double c = __dmul_rn(
          __dadd_rn((double)hi[i], (double)lo[i]), ep.deferred);
      o[at] = __dmul_rn(
          c, __dmul_rn(__ldg(ep.sigma_a + row), __ldg(ep.sigma_b + col)));
    });
  } else {
    float* o = static_cast<float*>(out);
    k1_each<NA>(r0, c0, m, n, [&](size_t at, int, int, int i) {
      o[at] = hi[i];
      lo_out[at] = lo[i];
    });
  }
}

// K2 — replaces src/repro/kernels/ops.py::split_gemm_pallas_fused (body
// _split_gemm_kernel_fused, in-kernel slicing.quantize_tile and
// slice_step).
//
// Bound on an H100 SXM: the same int8 ops as K1, 2*m*n*k*P at 1,979
// TOPS, against bytes 8*(m*k + k*n) + 8*m*n (the f32 hi/lo halves in,
// hi/lo out) at 3.35 TB/s; the ops are the larger at the MuST shape.
//
// Design: slice once, not once per pair.  A 32x32 CTA (4 warps of
// 16x16) walks its pairs in groups of G consecutive pairs of the
// schedule.  For each group it streams k in chunks of F_KC: the f32
// hi/lo halves of the chunk arrive by cp.async into one of two stage
// buffers (the next chunk loads while this one is used), the slicing
// recurrence runs once per element and writes every slice the group
// needs into shared memory as int8, A as As[m][k] and B k-major as
// Bs[n][k], four k at a time per 32-bit store; then each pair of the
// group runs ldmatrix-fed mma.sync m16n8k32 on the staged slices into
// its own int32 partial, held in registers.  The group's first pair
// folds at the end of each k-tile (every earlier pair is folded); the
// others hold one partial per k-tile, 1 + (G-1)*nkt partials in all,
// and fold in schedule order, then k-tile order, when the group ends.
// So the fold is the reference's, and with one k-tile (every MuST GEMM)
// and s <= 6 (G = P) each element is sliced once per CTA instead of
// ii+1 times for each of the P pairs.  tile_model.fused_plan picks G
// from (s, nkt) and the held-partial budget F_HOLD_MAX; the launcher
// takes G and instantiates the smallest compiled capacity that holds
// it.  F_KC = 32 keeps all s <= 16 slices of a chunk (3,072 B each)
// beside the two f32 stages (34,816 B) in shared memory, so every s is
// staged whole and two CTAs fit an SM for every s.  The slicing step
// rounds with ROUND_MAGIC, not the quarter-rate rintf and
// __float2int_rn.  What bounds it now is that slicing, repeated by
// every CTA of an element's row or column band (PERF.md).
constexpr int F_M = 32;
constexpr int F_N = 32;
constexpr int F_KC = 32;
constexpr int F_LDS = F_KC + 16;   // slice row stride (bytes)
constexpr int F_SA = F_KC;         // f32 A stage row stride (floats)
constexpr int F_SB = F_N + 4;      // f32 B stage row stride (floats)
constexpr int F_STAGE_FLOATS = 2 * F_M * F_SA + 2 * F_KC * F_SB;
constexpr int F_SLICE_BYTES = (F_M + F_N) * F_LDS;
constexpr int F_HOLD_MAX = 21;

// Stage the f32 halves of chunk [kc, kc + F_KC) into `st`: A rows m0..
// as [m][k], B rows kc.. as [k][n]; out-of-range elements are zero,
// which slices to zero.  vec_a: k % 4 == 0, vec_b: n % 4 == 0.
__device__ __forceinline__ void fused_stage(
    float* st, const float* __restrict__ ah, const float* __restrict__ al,
    const float* __restrict__ bh, const float* __restrict__ bl, int m0,
    int n0, int kc, int m, int k, int n, bool vec_a, bool vec_b) {
  float* sah = st;
  float* sal = st + F_M * F_SA;
  float* sbh = st + 2 * F_M * F_SA;
  float* sbl = sbh + F_KC * F_SB;
  const int tid = threadIdx.x;
  if (vec_a) {
#pragma unroll
    for (int i = 0; i < (F_M * F_KC / 4) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / (F_KC / 4), col = (v % (F_KC / 4)) * 4;
      const int gm = m0 + row, gk = kc + col;
      const bool ok = gm < m && gk < k;
      const size_t off = ok ? (size_t)gm * k + gk : 0;
      cp_async_16(sah + row * F_SA + col, ah + off, ok);
      cp_async_16(sal + row * F_SA + col, al + off, ok);
    }
  } else {
    for (int i = 0; i < (F_M * F_KC) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / F_KC, col = v % F_KC;
      const int gm = m0 + row, gk = kc + col;
      const bool ok = gm < m && gk < k;
      const size_t off = ok ? (size_t)gm * k + gk : 0;
      cp_async_4(sah + row * F_SA + col, ah + off, ok);
      cp_async_4(sal + row * F_SA + col, al + off, ok);
    }
  }
  if (vec_b) {
#pragma unroll
    for (int i = 0; i < (F_KC * F_N / 4) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / (F_N / 4), col = (v % (F_N / 4)) * 4;
      const int gk = kc + kr, gn = n0 + col;
      const bool ok = gk < k && gn < n;
      const size_t off = ok ? (size_t)gk * n + gn : 0;
      cp_async_16(sbh + kr * F_SB + col, bh + off, ok);
      cp_async_16(sbl + kr * F_SB + col, bl + off, ok);
    }
  } else {
    for (int i = 0; i < (F_KC * F_N) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / F_N, col = v % F_N;
      const int gk = kc + kr, gn = n0 + col;
      const bool ok = gk < k && gn < n;
      const size_t off = ok ? (size_t)gk * n + gn : 0;
      cp_async_4(sbh + kr * F_SB + col, bh + off, ok);
      cp_async_4(sbl + kr * F_SB + col, bl + off, ok);
    }
  }
}

// Slice the staged chunk once: slices 0..nsa-1 of A into
// sl[t][0..F_M)[k] and 0..nsb-1 of B k-major into sl[t][F_M..)[k],
// each thread running the recurrence on four k of one row at a time.
__device__ __forceinline__ void fused_quantize(const float* st, int8_t* sl,
                                               int nsa, int nsb,
                                               float radix) {
  const float* sah = st;
  const float* sal = st + F_M * F_SA;
  const float* sbh = st + 2 * F_M * F_SA;
  const float* sbl = sbh + F_KC * F_SB;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int i = 0; i < (F_M * F_KC / 4) / THREADS; ++i) {
    const int v = tid + i * THREADS;
    const int row = v / (F_KC / 4), col = (v % (F_KC / 4)) * 4;
    const float4 h4 =
        *reinterpret_cast<const float4*>(sah + row * F_SA + col);
    const float4 l4 =
        *reinterpret_cast<const float4*>(sal + row * F_SA + col);
    float h[4] = {h4.x, h4.y, h4.z, h4.w};
    float l[4] = {l4.x, l4.y, l4.z, l4.w};
    int8_t* dst = sl + row * F_LDS + col;
    for (int t = 0; t < nsa; ++t) {
      const int q0 = slice_step(h[0], l[0], radix);
      const int q1 = slice_step(h[1], l[1], radix);
      const int q2 = slice_step(h[2], l[2], radix);
      const int q3 = slice_step(h[3], l[3], radix);
      *reinterpret_cast<uint32_t*>(dst + t * F_SLICE_BYTES) =
          pack4(q0, q1, q2, q3);
    }
  }
  // B: a warp covers 8 columns x 4 k-quads per step, so its 32-bit
  // stores into the k-major rows fall in 32 distinct banks.
  const int lane = tid & 31;
#pragma unroll 1
  for (int i = 0; i < (F_N * F_KC / 4) / THREADS; ++i) {
    const int w = (tid >> 5) + i * (THREADS / 32);
    const int col = (lane & 7) + (w & 3) * 8;
    const int kq = ((lane >> 3) + (w >> 2) * 4) * 4;
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = sbh[(kq + e) * F_SB + col];
      l[e] = sbl[(kq + e) * F_SB + col];
    }
    int8_t* dst = sl + F_M * F_LDS + col * F_LDS + kq;
    for (int t = 0; t < nsb; ++t) {
      const int q0 = slice_step(h[0], l[0], radix);
      const int q1 = slice_step(h[1], l[1], radix);
      const int q2 = slice_step(h[2], l[2], radix);
      const int q3 = slice_step(h[3], l[3], radix);
      *reinterpret_cast<uint32_t*>(dst + t * F_SLICE_BYTES) =
          pack4(q0, q1, q2, q3);
    }
  }
}

// Held partial h of a group: h == 0 is the group's first pair at the
// current k-tile; h >= 1 is pair 1 + (h-1)/nkt at k-tile (h-1) % nkt,
// so ascending h is the reference's fold order for pairs 1.. of the
// group.
template <int CAP>
__global__ void __launch_bounds__(THREADS)
split_gemm_fused_kernel(const float* __restrict__ a_hi,
                        const float* __restrict__ a_lo,
                        const float* __restrict__ b_hi,
                        const float* __restrict__ b_lo,
                        float* __restrict__ hi_out,
                        float* __restrict__ lo_out, int m, int k, int n,
                        int block_k, int slice_bits, int group,
                        const __grid_constant__ PairSchedule sched) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  int8_t* sl = reinterpret_cast<int8_t*>(smem) +
               2 * F_STAGE_FLOATS * (int)sizeof(float);

  const float radix = (float)(1 << slice_bits);
  const bool vec_a = (k % 4) == 0, vec_b = (n % 4) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;
  const int m0 = blockIdx.y * F_M, n0 = blockIdx.x * F_N;
  const int num_pairs = sched.num_pairs;
  const int nkt = (k + block_k - 1) / block_k;
  const int hold = 1 + (group - 1) * nkt;
  const int nck = (k + F_KC - 1) / F_KC;
  const int per_tile = block_k / F_KC;
  const int total = ((num_pairs + group - 1) / group) * nck;

  float hi[2][4], lo[2][4];
  int acc[CAP][2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hi[ni][c] = lo[ni][c] = 0.0f;
#pragma unroll
      for (int h = 0; h < CAP; ++h) acc[h][ni][c] = 0;
    }

  fused_stage(stage, a_hi, a_lo, b_hi, b_lo, m0, n0, 0, m, k, n, vec_a,
              vec_b);
  cp_async_commit();
#pragma unroll 1
  for (int f = 0; f < total; ++f) {
    const int p0 = (f / nck) * group;
    const int q = f % nck;
    if (f + 1 < total)
      fused_stage(stage + ((f + 1) & 1) * F_STAGE_FLOATS, a_hi, a_lo, b_hi,
                  b_lo, m0, n0, ((f + 1) % nck) * F_KC, m, k, n, vec_a,
                  vec_b);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk f landed; the last chunk's MMAs are done

    const int last = min(num_pairs, p0 + group);
    int nsa = 0, nsb = 0;
    for (int p = p0; p < last; ++p) {
      nsa = max(nsa, (int)sched.ii[p] + 1);
      nsb = max(nsb, (int)sched.jj[p] + 1);
    }
    fused_quantize(stage + (f & 1) * F_STAGE_FLOATS, sl, nsa, nsb, radix);
    __syncthreads();

    const int t_cur = q / per_tile;
#pragma unroll
    for (int h = 0; h < CAP; ++h) {
      const int g = h == 0 ? 0 : 1 + (h - 1) / nkt;
      const int t = h == 0 ? t_cur : (h - 1) % nkt;
      if (h < hold && t == t_cur && p0 + g < last) {
        const int8_t* as = sl + sched.ii[p0 + g] * F_SLICE_BYTES +
                           wm * F_LDS;
        const int8_t* bs = sl + sched.jj[p0 + g] * F_SLICE_BYTES +
                           (F_M + wn) * F_LDS;
#pragma unroll
        for (int kk = 0; kk < F_KC; kk += 32) {
          uint32_t a[4], b[4];
          load_a_frag(a, as + kk, F_LDS, lane);
          load_b_frag(b, bs + kk, F_LDS, lane);
          mma_s8(acc[h][0], a, b[0], b[1]);
          mma_s8(acc[h][1], a, b[2], b[3]);
        }
      }
    }

    if ((q + 1) % per_tile == 0 || q + 1 == nck) {
      const float w = pow2f(sched.wexp[p0]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fold(hi[ni][c], lo[ni][c], acc[0][ni][c], w);
          acc[0][ni][c] = 0;
        }
    }
    if (q + 1 == nck) {
#pragma unroll
      for (int h = 1; h < CAP; ++h) {
        const int g = 1 + (h - 1) / nkt;
        if (h < hold && p0 + g < last) {
          const float w = pow2f(sched.wexp[p0 + g]);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              fold(hi[ni][c], lo[ni][c], acc[h][ni][c], w);
              acc[h][ni][c] = 0;
            }
        }
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = m0 + wm + g8 + (c >= 2 ? 8 : 0);
      const int col = n0 + wn + ni * 8 + 2 * t4 + (c & 1);
      if (row < m && col < n) {
        hi_out[(size_t)row * n + col] = hi[ni][c];
        lo_out[(size_t)row * n + col] = lo[ni][c];
      }
    }
}

// K3 — replaces src/repro/kernels/ops.py::split_gemm_pallas_v1 (body
// _split_gemm_kernel_v1): K1's fold over pair copies the wrapper
// gathered beforehand, a_pairs[p] = A_slice[ii[p]] (P, m, k) and,
// k-major, b_pairs[p] = B_slice[jj[p]]^T (P, n, k), with pair p's
// weight read from the device array w[p].
//
// Bound on an H100 SXM: K1's int8 ops against bytes P*(m*k + k*n) +
// 4*P + 8*m*n (every pair copy read once): the bytes are the larger at
// the MuST shape.  Design: both operands arrive k-major, so one 64x64
// CTA streams the flattened (pair, k-chunk) sequence through a
// V_STAGES-deep ring of cp.async.cg 16-byte copies into padded shared
// rows (no transpose), and 4 warps of 32x32 feed mma.sync m16n8k32
// from ldmatrix; the int32 partial folds with w[p] at each k-tile's
// end, as K1's.  Rows whose k is not a multiple of 16 are staged by
// plain byte loads into the same ring.
constexpr int V_STAGES = 4;
constexpr int V_STAGE_BYTES = (CTA_M + CTA_N) * LDS;

// Stage chunk [kc, kc + KC) of pair copies pa (m, k) and pb (n, k).
__device__ __forceinline__ void v1_stage(int8_t* st,
                                         const int8_t* __restrict__ pa,
                                         const int8_t* __restrict__ pb,
                                         int m0, int n0, int kc, int m,
                                         int k, int n, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < ((CTA_M + CTA_N) * KC / 16) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / (KC / 16), col = (v % (KC / 16)) * 16;
      const bool is_a = row < CTA_M;
      const int gr = is_a ? m0 + row : n0 + row - CTA_M;
      const int gk = kc + col;
      const bool ok = gr < (is_a ? m : n) && gk < k;
      const int8_t* src = is_a ? pa : pb;
      cp_async_16(st + row * LDS + col, src + (ok ? (size_t)gr * k + gk : 0),
                  ok);
    }
  } else {
    for (int i = 0; i < ((CTA_M + CTA_N) * KC) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / KC, col = v % KC;
      const bool is_a = row < CTA_M;
      const int gr = is_a ? m0 + row : n0 + row - CTA_M;
      const int gk = kc + col;
      const int8_t* src = is_a ? pa : pb;
      st[row * LDS + col] =
          (gr < (is_a ? m : n) && gk < k) ? src[(size_t)gr * k + gk] : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
split_gemm_v1_kernel(const int8_t* __restrict__ a_pairs,
                     const int8_t* __restrict__ b_pairs,
                     const float* __restrict__ weights,
                     float* __restrict__ hi_out, float* __restrict__ lo_out,
                     int m, int k, int n, int block_k, int num_pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);

  const size_t a_layer = (size_t)m * k, b_layer = (size_t)n * k;
  const bool vec = (k % 16) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * CTA_M, n0 = blockIdx.x * CTA_N;
  const int nck = (k + KC - 1) / KC;
  const int per_tile = block_k / KC;
  const int total = num_pairs * nck;

  float hi[2][4][4], lo[2][4][4];
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hi[mi][ni][c] = lo[mi][ni][c] = 0.0f;
        acc[mi][ni][c] = 0;
      }

#pragma unroll
  for (int f = 0; f < V_STAGES - 1; ++f) {
    if (f < total) {
      const int p = f / nck;
      v1_stage(ring + f * V_STAGE_BYTES, a_pairs + p * a_layer,
               b_pairs + p * b_layer, m0, n0, (f % nck) * KC, m, k, n, vec);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int f = 0; f < total; ++f) {
    cp_async_wait<V_STAGES - 2>();
    __syncthreads();  // chunk f landed; chunk f-1's stage is free
    {
      const int fn = f + V_STAGES - 1;
      if (fn < total) {
        const int p = fn / nck;
        v1_stage(ring + (fn % V_STAGES) * V_STAGE_BYTES,
                 a_pairs + p * a_layer, b_pairs + p * b_layer, m0, n0,
                 (fn % nck) * KC, m, k, n, vec);
      }
      cp_async_commit();
    }
    const int8_t* as = ring + (f % V_STAGES) * V_STAGE_BYTES + wm * LDS;
    const int8_t* bs =
        ring + (f % V_STAGES) * V_STAGE_BYTES + (CTA_M + wn) * LDS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {
      uint32_t a[2][4], b[2][4];
      load_a_frag(a[0], as + kk, LDS, lane);
      load_a_frag(a[1], as + 16 * LDS + kk, LDS, lane);
      load_b_frag(b[0], bs + kk, LDS, lane);
      load_b_frag(b[1], bs + 16 * LDS + kk, LDS, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                 b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    const int q = f % nck;
    if ((q + 1) % per_tile == 0 || q + 1 == nck) {
      const float w = __ldg(weights + f / nck);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            fold(hi[mi][ni][c], lo[mi][ni][c], acc[mi][ni][c], w);
            acc[mi][ni][c] = 0;
          }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + mi * 16 + g8 + (c >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + 2 * t4 + (c & 1);
        if (row < m && col < n) {
          hi_out[(size_t)row * n + col] = hi[mi][ni][c];
          lo_out[(size_t)row * n + col] = lo[mi][ni][c];
        }
      }
}

// K3's staging — replaces the jnp.take gathers that
// src/repro/kernels/ops.py::split_gemm_pallas_v1 runs before its Pallas
// call: a_pairs[p] = a_sl[ii[p]] (m, k) copied as is and b_pairs[p] =
// b_sl[jj[p]]^T (n, k), transposed through a 64x64-byte shared tile.
// Bound: bytes, s*(m*k + k*n) read and P*(m*k + k*n) written at 3.35
// TB/s.  One launch covers both operands: blocks below b_tiles
// transpose B tiles, the rest copy 4 KB runs of A, 16 bytes a thread.
constexpr int G_THREADS = 256;
constexpr int GT = 64;
constexpr int G_A_BYTES = G_THREADS * 16;

__global__ void __launch_bounds__(G_THREADS)
gather_pairs_kernel(const int8_t* __restrict__ a_sl,
                    const int8_t* __restrict__ b_sl,
                    int8_t* __restrict__ a_pairs,
                    int8_t* __restrict__ b_pairs, int m, int k, int n,
                    int b_tiles_n, int b_tiles,
                    const __grid_constant__ PairSchedule sched) {
  __shared__ __align__(16) int8_t tile[GT][GT + 4];  // [k][n]
  const int p = blockIdx.y, tid = threadIdx.x;
  if ((int)blockIdx.x < b_tiles) {
    const int k0 = (blockIdx.x / b_tiles_n) * GT;
    const int n0 = (blockIdx.x % b_tiles_n) * GT;
    const int8_t* src = b_sl + (size_t)sched.jj[p] * k * n;
    int8_t* dst = b_pairs + (size_t)p * n * k;
    // Load 64 k-rows of 64 bytes; thread: row tid/4, bytes (tid%4)*16.
    const int r = tid >> 2, c = (tid & 3) * 16;
    const int gk = k0 + r, gn = n0 + c;
    if (n % 16 == 0) {
      int4 v = make_int4(0, 0, 0, 0);
      if (gk < k && gn < n)
        v = *reinterpret_cast<const int4*>(src + (size_t)gk * n + gn);
      uint32_t* t32 = reinterpret_cast<uint32_t*>(&tile[r][c]);
      t32[0] = v.x, t32[1] = v.y, t32[2] = v.z, t32[3] = v.w;
    } else {
      for (int e = 0; e < 16; ++e)
        tile[r][c + e] = (gk < k && gn + e < n)
                             ? src[(size_t)gk * n + gn + e] : 0;
    }
    __syncthreads();
    // Store 64 n-rows of 64 k-bytes; thread: row tid/4, k (tid%4)*16.
    const int on = n0 + r, ok0 = k0 + c;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = pack4(tile[c + 4 * j][r], tile[c + 4 * j + 1][r],
                   tile[c + 4 * j + 2][r], tile[c + 4 * j + 3][r]);
    if (on < n) {
      int8_t* out = dst + (size_t)on * k + ok0;
      if (k % 16 == 0) {
        if (ok0 < k)
          *reinterpret_cast<int4*>(out) = make_int4(w[0], w[1], w[2], w[3]);
      } else {
        for (int e = 0; e < 16 && ok0 + e < k; ++e)
          out[e] = (int8_t)(w[e >> 2] >> (8 * (e & 3)));
      }
    }
  } else {
    const size_t layer = (size_t)m * k;
    const size_t off =
        (size_t)(blockIdx.x - b_tiles) * G_A_BYTES + (size_t)tid * 16;
    const int8_t* src = a_sl + (size_t)sched.ii[p] * layer;
    int8_t* dst = a_pairs + (size_t)p * layer;
    if (layer % 16 == 0) {
      if (off < layer)
        *reinterpret_cast<int4*>(dst + off) =
            *reinterpret_cast<const int4*>(src + off);
    } else {
      for (size_t e = off; e < off + 16 && e < layer; ++e) dst[e] = src[e];
    }
  }
}

cudaError_t make_schedule(const int* ii, const int* jj, const int* wexp,
                          int num_pairs, PairSchedule* sched) {
  if (num_pairs < 1 || num_pairs > MAX_PAIRS) return cudaErrorInvalidValue;
  sched->num_pairs = num_pairs;
  for (int p = 0; p < num_pairs; ++p) {
    if (wexp[p] < 0 || wexp[p] > 126) return cudaErrorInvalidValue;
    sched->ii[p] = (signed char)ii[p];
    sched->jj[p] = (signed char)jj[p];
    sched->wexp[p] = (short)wexp[p];
  }
  return cudaSuccess;
}

cudaError_t check_dims(int m, int k, int n, int block_k) {
  if (m < 1 || k < 1 || n < 1 || block_k < KC || block_k % KC != 0)
    return cudaErrorInvalidValue;
  if ((m + CTA_M - 1) / CTA_M > 65535) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Launch K2 with the compiled capacity CAP (>= the held partials).
template <int CAP>
cudaError_t launch_fused(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* a_hi, const float* a_lo,
                         const float* b_hi, const float* b_lo, float* hi,
                         float* lo, int m, int k, int n, int block_k,
                         int slice_bits, int group,
                         const PairSchedule& sched) {
  cudaError_t err = cudaFuncSetAttribute(
      split_gemm_fused_kernel<CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  split_gemm_fused_kernel<CAP><<<grid, THREADS, smem, stream>>>(
      a_hi, a_lo, b_hi, b_lo, hi, lo, m, k, n, block_k, slice_bits, group,
      sched);
  return cudaGetLastError();
}

// Shared memory one block may use on an H100 (227 KB).
constexpr size_t K1_SMEM_MAX = 232448;
// Dynamic shared memory K1 asks for beyond its operands, to align them.
constexpr size_t K1_ALIGN_SLACK = 1024;

// Driver-API entry points, reached through the runtime so that the
// library links no more than the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

// Tensor map of a (layers, rows, k) int8 slice stack as a 3-D (k, rows,
// layers) tensor, read in boxes of K1_KC bytes x box_rows rows x one
// layer into 128-byte-swizzled shared rows; out-of-range bytes read as
// zero.  k must be a multiple of 16 (TMA's stride unit).  A map is
// encoded once per (layers, rows, k, box_rows) and each call's copy
// only takes the stack's address (both main paths are host-bound).
cudaError_t k1_map(CUtensorMap* map, const void* base, int layers, int rows,
                   int k, int box_rows) {
  static const EncodeTiled encode =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  static const ReplaceAddress replace = reinterpret_cast<ReplaceAddress>(
      driver_entry("cuTensorMapReplaceAddress"));
  struct Entry {
    int layers, rows, k, box_rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 128;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  if (!encode || !replace) return cudaErrorNotSupported;
  void* addr = const_cast<void*>(base);
  std::lock_guard<std::mutex> hold(lock);
  for (int e = 0; e < used; ++e) {
    const Entry& c = cache[e];
    if (c.layers == layers && c.rows == rows && c.k == k &&
        c.box_rows == box_rows) {
      *map = c.map;
      return replace(map, addr) == CUDA_SUCCESS ? cudaSuccess
                                                : cudaErrorInvalidValue;
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)rows,
                              (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)k, (cuuint64_t)rows * k};
  const cuuint32_t box[3] = {K1_KC, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, addr, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cache[next] = Entry{layers, rows, k, box_rows, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return cudaSuccess;
}

// Launch one K1 instance; its dynamic shared memory limit is raised
// once per device to the largest size asked for so far.
template <int WM, int BN, bool RES>
cudaError_t launch_k1(dim3 grid, size_t smem, cudaStream_t stream,
                      const CUtensorMap& map_a, const CUtensorMap& map_b,
                      const int8_t* a, const int8_t* b, void* out,
                      float* lo, int m, int k, int n, int block_k,
                      int layers, int use_tma, int device,
                      const PairSchedule& sched, const K1Epilogue& ep) {
  static size_t raised[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        split_gemm_kernel<WM, BN, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised[device] = smem;
  }
  split_gemm_kernel<WM, BN, RES><<<grid, 128 * WM, smem, stream>>>(
      map_a, map_b, a, b, out, lo, m, k, n, block_k, layers, use_tma, sched,
      ep);
  return cudaGetLastError();
}

}  // namespace

// K1's launch arguments after the pointers, fixed per launch shape, plan
// and output kind: the wrapper builds them once per shape
// (ops._k1_launch_args) and passes their address, so a call converts
// nine arguments, not 21.  out_kind is K1_OUT_PAIR, _F32 or _F64;
// deferred is 2**(-slice_bits*(s+1)).
struct K1Args {
  int m, k, n, block_k, num_pairs, block_m, block_n, resident;
  int ii[MAX_PAIRS], jj[MAX_PAIRS], wexp[MAX_PAIRS];
  int out_kind;
  double deferred;
};

extern "C" {

// K1 launcher: a_sl (s, m, k) int8, k-major b_sl_t (s, n, k) int8 ->
// with out_kind K1_OUT_PAIR, out = hi and lo (m, n) f32; with K1_OUT_F32
// or _F64, out = the finished product (m, n) in that type from sigma_a
// (m,) and sigma_b (n,) f64, and lo unused.  All contiguous on
// `device`; runs on `stream` with the plan tile_model.k1_plan gave
// (block_m x block_n tile, resident or streamed).  A plan the kernel does
// not take, or whose shared memory does not fit, is refused.
cudaError_t split_gemm_launch(const void* a_sl, const void* b_sl_t,
                              void* out, void* lo, const void* sigma_a,
                              const void* sigma_b, const K1Args* args,
                              int device, void* stream) {
  const int m = args->m, k = args->k, n = args->n, block_k = args->block_k;
  const int block_m = args->block_m, block_n = args->block_n;
  const int resident = args->resident;
  const K1Epilogue ep{(const double*)sigma_a, (const double*)sigma_b,
                      args->deferred, args->out_kind};
  const bool finished = ep.kind == K1_OUT_F32 || ep.kind == K1_OUT_F64;
  if (finished ? !sigma_a || !sigma_b : ep.kind != K1_OUT_PAIR || !lo)
    return cudaErrorInvalidValue;
  PairSchedule sched;
  cudaError_t err = check_dims(m, k, n, block_k);
  if (err == cudaSuccess)
    err = make_schedule(args->ii, args->jj, args->wexp, args->num_pairs,
                        &sched);
  if (err != cudaSuccess) return err;
  if ((block_m != 64 && block_m != 128) || (m + block_m - 1) / block_m > 65535)
    return cudaErrorInvalidValue;
  int layers = 0;
  for (int p = 0; p < sched.num_pairs; ++p) {
    const int top = sched.ii[p] > sched.jj[p] ? sched.ii[p] : sched.jj[p];
    if (top + 1 > layers) layers = top + 1;
  }
  size_t smem;
  if (resident) {
    if (k > block_k) return cudaErrorInvalidValue;
    const size_t kp = (size_t)(k + K1_KC - 1) / K1_KC * K1_KC;
    smem = (size_t)layers * (block_m + block_n) * kp + K1_ALIGN_SLACK;
  } else {
    smem = (size_t)k1_stages(block_m, block_n) * (block_m + block_n) * K1_KC +
           K1_ALIGN_SLACK;
  }
  if (smem > K1_SMEM_MAX) return cudaErrorInvalidValue;
  const int use_tma = k % 16 == 0;
  CUtensorMap map_a = {}, map_b = {};
  if (use_tma) {
    err = k1_map(&map_a, a_sl, layers, m, k, block_m);
    if (err == cudaSuccess) err = k1_map(&map_b, b_sl_t, layers, n, k, block_n);
    if (err != cudaSuccess) return err;
  }
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const dim3 grid((n + block_n - 1) / block_n, (m + block_m - 1) / block_m);
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t *a = (const int8_t*)a_sl, *b = (const int8_t*)b_sl_t;
#define REPRO_K1(BM, BN, RES)                                                \
  if (block_m == BM && block_n == BN && !resident == !RES)                   \
    return launch_k1<BM / 64, BN, RES>(grid, smem, st, map_a, map_b, a, b,   \
                                       out, (float*)lo, m, k, n, block_k,    \
                                       layers, use_tma, device, sched, ep);
  REPRO_K1(64, 32, true)
  REPRO_K1(64, 64, true)
  REPRO_K1(64, 32, false)
  REPRO_K1(64, 64, false)
  REPRO_K1(128, 64, false)
#undef REPRO_K1
  return cudaErrorInvalidValue;
}

// K2 launcher: a_hi, a_lo (m, k) f32, b_hi, b_lo (k, n) f32 -> hi, lo;
// `group` pairs share each slicing pass (tile_model.fused_plan).
cudaError_t split_gemm_fused_launch(const void* a_hi, const void* a_lo,
                                    const void* b_hi, const void* b_lo,
                                    void* hi, void* lo, int m, int k, int n,
                                    int block_k, int slice_bits, int group,
                                    const int* ii, const int* jj,
                                    const int* wexp, int num_pairs,
                                    int device, void* stream) {
  PairSchedule sched;
  cudaError_t err = check_dims(m, k, n, block_k);
  if (err == cudaSuccess) err = make_schedule(ii, jj, wexp, num_pairs, &sched);
  if (err != cudaSuccess) return err;
  if (slice_bits < 1 || slice_bits > 7) return cudaErrorInvalidValue;
  if ((m + F_M - 1) / F_M > 65535) return cudaErrorInvalidValue;
  const int nkt = (k + block_k - 1) / block_k;
  if (group < 1 || group > num_pairs) return cudaErrorInvalidValue;
  const long hold = 1 + (long)(group - 1) * nkt;
  if (hold > F_HOLD_MAX) return cudaErrorInvalidValue;
  int slices = 0;
  for (int p = 0; p < num_pairs; ++p)
  {
    const int top = sched.ii[p] > sched.jj[p] ? sched.ii[p] : sched.jj[p];
    if (top + 1 > slices) slices = top + 1;
  }
  const size_t smem = 2 * F_STAGE_FLOATS * sizeof(float) +
                      (size_t)slices * F_SLICE_BYTES;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const dim3 grid((n + F_N - 1) / F_N, (m + F_M - 1) / F_M);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *ah = (const float*)a_hi, *al = (const float*)a_lo;
  const float *bh = (const float*)b_hi, *bl = (const float*)b_lo;
#define REPRO_FUSED(CAP)                                                   \
  if (hold <= CAP)                                                         \
    return launch_fused<CAP>(grid, smem, st, ah, al, bh, bl, (float*)hi,   \
                             (float*)lo, m, k, n, block_k, slice_bits,     \
                             group, sched);
  REPRO_FUSED(1)
  REPRO_FUSED(2)
  REPRO_FUSED(4)
  REPRO_FUSED(8)
  REPRO_FUSED(12)
  REPRO_FUSED(16)
  REPRO_FUSED(21)
#undef REPRO_FUSED
  return cudaErrorInvalidValue;
}

// K3 launcher: a_pairs (P, m, k) int8, b_pairs (P, n, k) int8 (k-major),
// weights (P,) f32 -> hi, lo (m, n) f32, all contiguous on `device`.
cudaError_t split_gemm_v1_launch(const void* a_pairs, const void* b_pairs,
                                 const void* weights, void* hi, void* lo,
                                 int m, int k, int n, int block_k,
                                 int num_pairs, int device, void* stream) {
  cudaError_t err = check_dims(m, k, n, block_k);
  if (err != cudaSuccess) return err;
  if (num_pairs < 1) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const size_t smem = V_STAGES * V_STAGE_BYTES;
  err = cudaFuncSetAttribute(split_gemm_v1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + CTA_N - 1) / CTA_N, (m + CTA_M - 1) / CTA_M);
  split_gemm_v1_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)a_pairs, (const int8_t*)b_pairs, (const float*)weights,
      (float*)hi, (float*)lo, m, k, n, block_k, num_pairs);
  return cudaGetLastError();
}

// K3's gather: a_sl (s, m, k), b_sl (s, k, n) int8 -> a_pairs (P, m, k)
// and k-major b_pairs (P, n, k) int8, all contiguous on `device`.
cudaError_t gather_pairs_launch(const void* a_sl, const void* b_sl,
                                void* a_pairs, void* b_pairs, int m, int k,
                                int n, const int* ii, const int* jj,
                                const int* wexp, int num_pairs, int device,
                                void* stream) {
  PairSchedule sched;
  if (m < 1 || k < 1 || n < 1) return cudaErrorInvalidValue;
  cudaError_t err = make_schedule(ii, jj, wexp, num_pairs, &sched);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const int b_tiles_n = (n + GT - 1) / GT;
  const long b_tiles = (long)b_tiles_n * ((k + GT - 1) / GT);
  const long a_blocks = ((long)m * k + G_A_BYTES - 1) / G_A_BYTES;
  if (b_tiles + a_blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b_tiles + a_blocks), num_pairs);
  gather_pairs_kernel<<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a_sl, (const int8_t*)b_sl, (int8_t*)a_pairs,
      (int8_t*)b_pairs, m, k, n, b_tiles_n, (int)b_tiles, sched);
  return cudaGetLastError();
}

const char* split_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
