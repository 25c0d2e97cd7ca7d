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
// the int32 partial is exact (|part| <= 512 * 2**10 < 2**24) and may be
// summed in any order.  All float arithmetic in the fold and in the
// slicing recurrence uses the explicit round-to-nearest intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn), so no FMA contraction or
// reassociation can change a bit; the library is also built with
// -fmad=false and never with --use_fast_math.
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

// Slice `index` of the f32 pair (h, l): index + 1 steps of the
// reference's slice_step recurrence, q = rint(h*radix + l*radix)
// (round half to even, as jnp.round), residue renormalized by TwoSum.
__device__ __forceinline__ int quantize(float h, float l, int index,
                                        float radix) {
  float q = 0.0f;
  for (int t = 0; t <= index; ++t) {
    const float yh = __fmul_rn(h, radix);
    const float yl = __fmul_rn(l, radix);
    q = rintf(__fadd_rn(yh, yl));
    const float r = __fsub_rn(yh, q);
    const float s = __fadd_rn(r, yl);
    const float bp = __fsub_rn(s, r);
    l = __fadd_rn(__fsub_rn(r, __fsub_rn(s, bp)), __fsub_rn(yl, bp));
    h = s;
  }
  return __float2int_rn(q);
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

// Fused: A arrives as f32 (hi, lo) halves and is quantized on the way
// into shared memory.  vec: k % 4 == 0 (float4 loads along k).
__device__ __forceinline__ void stage_a_fused(int8_t (*As)[LDS],
                                              const float* __restrict__ Ah,
                                              const float* __restrict__ Al,
                                              int m0, int kc, int m, int k,
                                              int index, float radix,
                                              bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int i = 0; i < (CTA_M * KC / 4) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / (KC / 4), col = (v % (KC / 4)) * 4;
      const int gm = m0 + row, gk = kc + col;
      uint32_t packed = 0;
      if (gm < m && gk < k) {
        const size_t off = (size_t)gm * k + gk;
        const float4 h = *reinterpret_cast<const float4*>(Ah + off);
        const float4 l = *reinterpret_cast<const float4*>(Al + off);
        packed = pack4(quantize(h.x, l.x, index, radix),
                       quantize(h.y, l.y, index, radix),
                       quantize(h.z, l.z, index, radix),
                       quantize(h.w, l.w, index, radix));
      }
      *reinterpret_cast<uint32_t*>(&As[row][col]) = packed;
    }
  } else {
    for (int i = 0; i < (CTA_M * KC) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int row = v / KC, col = v % KC;
      const int gm = m0 + row, gk = kc + col;
      int q = 0;
      if (gm < m && gk < k) {
        const size_t off = (size_t)gm * k + gk;
        q = quantize(Ah[off], Al[off], index, radix);
      }
      As[row][col] = (int8_t)q;
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

// Fused B. vec: n % 4 == 0 (float4 loads along n).
__device__ __forceinline__ void stage_b_fused(int8_t (*Bs)[LDS],
                                              const float* __restrict__ Bh,
                                              const float* __restrict__ Bl,
                                              int n0, int kc, int k, int n,
                                              int index, float radix,
                                              bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int i = 0; i < (KC * CTA_N / 4) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / (CTA_N / 4), col = (v % (CTA_N / 4)) * 4;
      const int gk = kc + kr, gn = n0 + col;
      int q0 = 0, q1 = 0, q2 = 0, q3 = 0;
      if (gk < k && gn < n) {
        const size_t off = (size_t)gk * n + gn;
        const float4 h = *reinterpret_cast<const float4*>(Bh + off);
        const float4 l = *reinterpret_cast<const float4*>(Bl + off);
        q0 = quantize(h.x, l.x, index, radix);
        q1 = quantize(h.y, l.y, index, radix);
        q2 = quantize(h.z, l.z, index, radix);
        q3 = quantize(h.w, l.w, index, radix);
      }
      Bs[col + 0][kr] = (int8_t)q0;
      Bs[col + 1][kr] = (int8_t)q1;
      Bs[col + 2][kr] = (int8_t)q2;
      Bs[col + 3][kr] = (int8_t)q3;
    }
  } else {
    for (int i = 0; i < (KC * CTA_N) / THREADS; ++i) {
      const int v = tid + i * THREADS;
      const int kr = v / CTA_N, col = v % CTA_N;
      const int gk = kc + kr, gn = n0 + col;
      int q = 0;
      if (gk < k && gn < n) {
        const size_t off = (size_t)gk * n + gn;
        q = quantize(Bh[off], Bl[off], index, radix);
      }
      Bs[col][kr] = (int8_t)q;
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

// K2 — replaces src/repro/kernels/ops.py::split_gemm_pallas_fused (body
// _split_gemm_kernel_fused, in-kernel slicing.quantize_tile and
// slice_step).
//
// Bound on an H100 SXM: the same int8 ops as K1 against bytes
// 8*(m*k + k*n) + 8*m*n (the f32 hi/lo halves in, hi/lo out).  What this
// simple design leaves on the table: on top of K1's, every (pair,
// k-chunk) step re-reads the f32 halves and re-runs ii[p]+1 (jj[p]+1)
// slicing steps per element; hoisting the quantization out of the pair
// loop is only valid with a single k-tile and is later work.
__global__ void __launch_bounds__(THREADS)
split_gemm_fused_kernel(const float* __restrict__ a_hi,
                        const float* __restrict__ a_lo,
                        const float* __restrict__ b_hi,
                        const float* __restrict__ b_lo,
                        float* __restrict__ hi_out,
                        float* __restrict__ lo_out, int m, int k, int n,
                        int block_k, int slice_bits,
                        const __grid_constant__ PairSchedule sched) {
  const float radix = (float)(1 << slice_bits);
  const bool vec_a = (k % 4) == 0, vec_b = (n % 4) == 0;
  const int m0 = blockIdx.y * CTA_M, n0 = blockIdx.x * CTA_N;
  split_gemm_body(sched.num_pairs, hi_out, lo_out, m, k, n, block_k,
                  [&](int8_t (*As)[LDS], int8_t (*Bs)[LDS], int p,
                      int kc) {
                    stage_a_fused(As, a_hi, a_lo, m0, kc, m, k,
                                  sched.ii[p], radix, vec_a);
                    stage_b_fused(Bs, b_hi, b_lo, n0, kc, k, n,
                                  sched.jj[p], radix, vec_b);
                  },
                  [&](int p) { return pow2f(sched.wexp[p]); });
}

// K3 — replaces src/repro/kernels/ops.py::split_gemm_pallas_v1 (body
// _split_gemm_kernel_v1): K1's fold over pair copies the host gathered
// beforehand, a_pairs[p] = A_slice[ii[p]] and b_pairs[p] =
// B_slice[jj[p]], with pair p's weight read from the device array
// w[p] instead of being assembled from exponent bits.
//
// Bound on an H100 SXM: K1's int8 ops against bytes P*(m*k + k*n) +
// 4*P + 8*m*n (every pair copy read once): the bytes are the larger at
// the MuST shape.  Kept, like the reference's v1, for the A/B check
// against K1 and the traffic row; it shares K1's CTA body, so its
// design leaves the same on the table, plus the P pair copies.
__global__ void __launch_bounds__(THREADS)
split_gemm_v1_kernel(const int8_t* __restrict__ a_pairs,
                     const int8_t* __restrict__ b_pairs,
                     const float* __restrict__ weights,
                     float* __restrict__ hi_out, float* __restrict__ lo_out,
                     int m, int k, int n, int block_k, int num_pairs) {
  const size_t a_layer = (size_t)m * k, b_layer = (size_t)k * n;
  const bool vec_a = (k % 16) == 0, vec_b = (n % 16) == 0;
  const int m0 = blockIdx.y * CTA_M, n0 = blockIdx.x * CTA_N;
  split_gemm_body(num_pairs, hi_out, lo_out, m, k, n, block_k,
                  [&](int8_t (*As)[LDS], int8_t (*Bs)[LDS], int p,
                      int kc) {
                    stage_a_int8(As, a_pairs + p * a_layer, m0, kc, m, k,
                                 vec_a);
                    stage_b_int8(Bs, b_pairs + p * b_layer, n0, kc, k, n,
                                 vec_b);
                  },
                  [&](int p) { return __ldg(weights + p); });
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

// K2 launcher: a_hi, a_lo (m, k) f32, b_hi, b_lo (k, n) f32 -> hi, lo.
cudaError_t split_gemm_fused_launch(const void* a_hi, const void* a_lo,
                                    const void* b_hi, const void* b_lo,
                                    void* hi, void* lo, int m, int k, int n,
                                    int block_k, int slice_bits,
                                    const int* ii, const int* jj,
                                    const int* wexp, int num_pairs,
                                    int device, void* stream) {
  PairSchedule sched;
  cudaError_t err = check_dims(m, k, n, block_k);
  if (err == cudaSuccess) err = make_schedule(ii, jj, wexp, num_pairs, &sched);
  if (err != cudaSuccess) return err;
  if (slice_bits < 1 || slice_bits > 7) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const dim3 grid((n + CTA_N - 1) / CTA_N, (m + CTA_M - 1) / CTA_M);
  split_gemm_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a_hi, (const float*)a_lo, (const float*)b_hi,
      (const float*)b_lo, (float*)hi, (float*)lo, m, k, n, block_k,
      slice_bits, sched);
  return cudaGetLastError();
}

// K3 launcher: a_pairs (P, m, k) int8, b_pairs (P, k, n) int8, weights
// (P,) f32 -> hi, lo (m, n) f32, all contiguous on `device`.
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
  const dim3 grid((n + CTA_N - 1) / CTA_N, (m + CTA_M - 1) / CTA_M);
  split_gemm_v1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a_pairs, (const int8_t*)b_pairs, (const float*)weights,
      (float*)hi, (float*)lo, m, k, n, block_k, num_pairs);
  return cudaGetLastError();
}

const char* split_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
