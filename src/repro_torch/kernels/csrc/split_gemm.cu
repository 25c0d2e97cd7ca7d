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

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- Staging one k-chunk of A (CTA_M x KC) into As[m][k] ------------

// Pre-sliced int8 A. vec: k % 16 == 0, so 16-byte rows never straddle k.
__device__ __forceinline__ void stage_a_int8(int8_t (*As)[LDS],
                                             const int8_t* __restrict__ A,
                                             int m0, int kc, int m, int k,
                                             bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (CTA_M * KC / 16) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / (KC / 16), col = (v % (KC / 16)) * 16;
      const int gm = m0 + row, gk = kc + col;
      int4 val = make_int4(0, 0, 0, 0);
      if (gm < m && gk < k)
        val = *reinterpret_cast<const int4*>(A + (size_t)gm * k + gk);
      *reinterpret_cast<int4*>(&As[row][col]) = val;
    }
  } else {
    for (int i = 0; i < (CTA_M * KC) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / KC, col = v % KC;
      const int gm = m0 + row, gk = kc + col;
      As[row][col] = (gm < m && gk < k) ? A[(size_t)gm * k + gk] : 0;
    }
  }
}

// ---- Staging one k-chunk of B (KC x CTA_N) transposed into Bs[n][k] --

// vec: n % 16 == 0 (16-byte loads along n).
__device__ __forceinline__ void stage_b_int8(int8_t (*Bs)[LDS],
                                             const int8_t* __restrict__ B,
                                             int n0, int kc, int k, int n,
                                             bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (KC * CTA_N / 16) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / (CTA_N / 16), col = (v % (CTA_N / 16)) * 16;
      const int gk = kc + kr, gn = n0 + col;
      int4 val = make_int4(0, 0, 0, 0);
      if (gk < k && gn < n)
        val = *reinterpret_cast<const int4*>(B + (size_t)gk * n + gn);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[col + j][kr] = bytes[j];
    }
  } else {
    for (int i = 0; i < (KC * CTA_N) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / CTA_N, col = v % CTA_N;
      const int gk = kc + kr, gn = n0 + col;
      Bs[col][kr] = (gk < k && gn < n) ? B[(size_t)gk * n + gn] : 0;
    }
  }
}

// ---- The tensor-core product of one staged chunk ---------------------

// One warp: its 32x32 sub-tile, KC deep, as 2x4 mma.sync m16n8k32
// (A row-major from As[m][k], B "col" = k-contiguous from Bs[n][k]).
__device__ __forceinline__ void mma_chunk(int8_t (*As)[LDS],
                                          int8_t (*Bs)[LDS],
                                          int wm, int wn, int g, int t,
                                          int (&acc)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 32) {
    uint32_t a[2][4];
    uint32_t b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t * 4]);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t * 4]);
      a[mi][2] =
          *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + t * 4]);
      a[mi][3] =
          *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + g;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + t * 4]);
      b[ni][1] =
          *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[mi][ni][0]), "+r"(acc[mi][ni][1]),
              "+r"(acc[mi][ni][2]), "+r"(acc[mi][ni][3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
              "r"(b[ni][0]), "r"(b[ni][1]));
      }
    }
  }
}

// Shared body of all kernels.  Stage(As, Bs, p, kc) fills one chunk
// of pair p; Weight(p) is pair p's exact power-of-two weight.
template <typename Stage, typename Weight>
__device__ __forceinline__ void split_gemm_body(int num_pairs,
                                                float* __restrict__ hi_out,
                                                float* __restrict__ lo_out,
                                                int m, int k, int n,
                                                int block_k, Stage stage,
                                                Weight weight) {
  __shared__ __align__(16) int8_t As[CTA_M][LDS];
  __shared__ __align__(16) int8_t Bs[CTA_N][LDS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * CTA_M, n0 = blockIdx.x * CTA_N;

  float hi[2][4][4], lo[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) hi[mi][ni][c] = lo[mi][ni][c] = 0.0f;

  for (int p = 0; p < num_pairs; ++p) {
    const float w = weight(p);
    for (int k0 = 0; k0 < k; k0 += block_k) {
      int acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
      const int k1 = min(k, k0 + block_k);
      for (int kc = k0; kc < k1; kc += KC) {
        __syncthreads();  // the previous chunk has been consumed
        stage(As, Bs, p, kc);
        __syncthreads();
        mma_chunk(As, Bs, wm, wn, g, t, acc);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            fold(hi[mi][ni][c], lo[mi][ni][c], acc[mi][ni][c], w);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + mi * 16 + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + 2 * t + (c & 1);
        if (row < m && col < n) {
          hi_out[(size_t)row * n + col] = hi[mi][ni][c];
          lo_out[(size_t)row * n + col] = lo[mi][ni][c];
        }
      }
}

// K1 — replaces src/repro/kernels/ops.py::split_gemm_pallas (body
// _split_gemm_kernel_v2, helpers _accumulate, _pow2_f32).
//
// Bound on an H100 SXM: int8 ops 2*m*n*k*P (P = s(s+1)/2) at 1,979 TOPS
// dense, against bytes s*(m*k + k*n) + 8*m*n at 3.35 TB/s; at the MuST
// shape (m, k, n) = (256, 256, 4096), s = 6 the ops bound is the larger.
// What this simple design leaves on the table: legacy mma.sync instead
// of wgmma, synchronous global->shared staging with no cp.async/TMA
// pipeline, a byte-wise transpose of B into shared memory, and each
// CTA re-reading the slice layers once per pair (P times instead of s).
__global__ void __launch_bounds__(THREADS)
split_gemm_kernel(const int8_t* __restrict__ a_sl,
                  const int8_t* __restrict__ b_sl,
                  float* __restrict__ hi_out, float* __restrict__ lo_out,
                  int m, int k, int n, int block_k,
                  const __grid_constant__ PairSchedule sched) {
  const size_t a_layer = (size_t)m * k, b_layer = (size_t)k * n;
  const bool vec_a = (k % 16) == 0, vec_b = (n % 16) == 0;
  const int m0 = blockIdx.y * CTA_M, n0 = blockIdx.x * CTA_N;
  split_gemm_body(sched.num_pairs, hi_out, lo_out, m, k, n, block_k,
                  [&](int8_t (*As)[LDS], int8_t (*Bs)[LDS], int p,
                      int kc) {
                    stage_a_int8(As, a_sl + sched.ii[p] * a_layer, m0, kc,
                                 m, k, vec_a);
                    stage_b_int8(Bs, b_sl + sched.jj[p] * b_layer, n0, kc,
                                 k, n, vec_b);
                  },
                  [&](int p) { return pow2f(sched.wexp[p]); });
}

// ---- PTX building blocks of K2 and K3 --------------------------------

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

}  // namespace

extern "C" {

// K1 launcher: a_sl (s, m, k) int8, b_sl (s, k, n) int8 -> hi, lo (m, n)
// f32, all contiguous on `device`; runs on `stream`.
cudaError_t split_gemm_launch(const void* a_sl, const void* b_sl, void* hi,
                              void* lo, int m, int k, int n, int block_k,
                              const int* ii, const int* jj, const int* wexp,
                              int num_pairs, int device, void* stream) {
  PairSchedule sched;
  cudaError_t err = check_dims(m, k, n, block_k);
  if (err == cudaSuccess) err = make_schedule(ii, jj, wexp, num_pairs, &sched);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();  // clear an unrelated earlier launch error
  const dim3 grid((n + CTA_N - 1) / CTA_N, (m + CTA_M - 1) / CTA_M);
  split_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a_sl, (const int8_t*)b_sl, (float*)hi, (float*)lo, m, k,
      n, block_k, sched);
  return cudaGetLastError();
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
