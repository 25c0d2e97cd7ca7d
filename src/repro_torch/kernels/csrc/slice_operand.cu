// Ozaki slicing of one operand for Hopper (sm_90a): the power-of-two
// scale sigma and all s int8 slices of x in one launch.
//
// Replaces no TPU kernel: the reference slices in XLA
// (src/repro/core/ozaki.py slice_matrix), which the port first ran as
// some 40 eager float64 torch launches per operand.  This kernel is
// bitwise equal to repro_torch.core.ozaki.slice_matrix(x, s, axis=1):
//
//   absmax = max |x[row, :]|                (NaN wins, as torch.amax)
//   e      = absmax > 0 ? ceil(log(absmax) * INV_LN2) + 1 : 0
//   sigma  = ldexp(1, (int)e),   r = x / sigma
//   s times: q = rint(r * 2**w) (half to even); slice = q; r = r*2**w - q
//
// all in float64 registers.  r * 2**w and r*2**w - q are exact, and the
// rounding to an integer uses ROUND_MAGIC on the FP64 pipe, so no
// conversion unit is in the loop.  x / sigma is a multiply by the exact
// reciprocal 2**-e wherever that is finite (the same correctly rounded
// value as the division), else a true division.
//
// Bound: bytes.  Each element is read once (4 or 8 bytes) and written s
// times as int8; about 25 FP64 operations an element stay under that
// at s = 6.  One CTA owns TM rows (m indices) and every k of them, so
// sigma needs no second pass and no second launch: the rows' panel is
// copied into shared memory with cp.async, coalesced along whichever
// axis of x has the smaller stride (k for A as the caller holds it, m
// for B^T and x^T: the "transpose" happens on the way out of shared
// memory), reduced to the row maxima (registers, warp shuffles, shared
// memory), and sliced from shared memory into 16-byte stores along k
// in each of the s planes.  A panel too large for shared memory
// streams its k in chunks twice, the second read mostly from L2.
//
// The plan (which axis is fast, the vector width, TM, the chunk width
// TK) comes from repro_torch/kernels/slicing.py::slice_plan; the
// launcher checks it and refuses what the kernel does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S_THREADS = 256;
constexpr int S_UNIT = 16;               // k per thread per plane store
constexpr int S_SMEM_MAX = 200 * 1024;   // slicing.SLICE_SMEM_MAX
// 1 / math.log(2.0) in Python: the reference's log2 is log(x) * this.
constexpr double INV_LN2 = 0x1.71547652b82fep+0;
// 1.5 * 2**52: for |y| < 2**51, y + ROUND_MAGIC rounds y to an integer
// (half to even, as torch.round), held in the low mantissa bits.
constexpr double ROUND_MAGIC = 0x1.8p+52;

}  // namespace

// The wrapper's plan, per (shape, strides, dtype, s); its layout must
// match _build.SliceArgs.
struct SliceArgs {
  long long m, k, stride_m, stride_k;  // element strides of x
  int num_splits, slice_bits;
  int fast_k;  // 1: the panel's rows run along k, 0: along m
  int vec;     // elements per copy along the fast axis (16 bytes or 1)
  int tm, tk;  // rows per CTA, k per chunk (a multiple of S_UNIT)
  int chunks;  // ceil(k / tk); 1 when the whole panel is resident
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Asynchronous copy of `bytes` (4, 8 or 16) global -> shared; zero-fills
// when !valid (src-size 0: nothing is read).
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// |v| as an unsigned integer that orders like |v|, NaN above +inf: the
// sign bit cleared.  The max of these is torch.amax's of |x|.
__device__ __forceinline__ unsigned long long abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}
__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return (unsigned long long)__double_as_longlong(v) &
         0x7fffffffffffffffull;
}
__device__ __forceinline__ double from_bits(unsigned long long b, float) {
  return (double)__uint_as_float((uint32_t)b);
}
__device__ __forceinline__ double from_bits(unsigned long long b, double) {
  return __longlong_as_double((long long)b);
}

// 16 consecutive elements of a panel row (16-byte aligned) as doubles.
__device__ __forceinline__ void load_run(const float* p, double (&v)[S_UNIT]) {
#pragma unroll
  for (int j = 0; j < S_UNIT / 4; ++j) {
    const float4 f = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z,
    v[4 * j + 3] = f.w;
  }
}
__device__ __forceinline__ void load_run(const double* p,
                                         double (&v)[S_UNIT]) {
#pragma unroll
  for (int j = 0; j < S_UNIT / 2; ++j) {
    const double2 d = reinterpret_cast<const double2*>(p)[j];
    v[2 * j] = d.x, v[2 * j + 1] = d.y;
  }
}

// Copy the chunk of TM rows x TK k starting at (m0, k0) into `tile`,
// laid out [slow][fast] with no padding; what lies outside x is zero.
template <typename T>
__device__ __forceinline__ void load_chunk(T* tile, const T* x,
                                           const SliceArgs& a, long long m0,
                                           long long k0) {
  const int fast = a.fast_k ? a.tk : a.tm;
  const int slow = a.fast_k ? a.tm : a.tk;
  const int per_line = fast / a.vec;
  const int copies = slow * per_line;
  const int bytes = a.vec * (int)sizeof(T);
  for (int q = threadIdx.x; q < copies; q += S_THREADS) {
    const int line = q / per_line;
    const int f = (q - line * per_line) * a.vec;
    const long long gm = m0 + (a.fast_k ? line : f);
    const long long gk = k0 + (a.fast_k ? f : line);
    const bool valid = gm < a.m && gk < a.k;
    const T* src = valid ? x + gm * a.stride_m + gk * a.stride_k : x;
    copy_async(tile + (size_t)line * fast + f, src, bytes, valid);
  }
  copy_wait_all();
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
slice_operand_kernel(const T* __restrict__ x, int8_t* __restrict__ slices,
                     double* __restrict__ sigma_out, const SliceArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long red[S_THREADS];
  __shared__ double row_sigma[S_THREADS], row_inv[S_THREADS];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * a.tm;
  const int tpr = S_THREADS / a.tm;  // threads per row in the max pass

  // Pass 1: each thread keeps the max of one row's k positions c0,
  // c0 + tpr, ...; a row's threads are consecutive (fast_k) or tm apart.
  const int r1 = a.fast_k ? tid / tpr : tid % a.tm;
  const int c1 = a.fast_k ? tid % tpr : tid / a.tm;
  unsigned long long mx = 0;
  for (int j = 0; j < a.chunks; ++j) {
    if (j > 0) __syncthreads();
    load_chunk(tile, x, a, m0, (long long)j * a.tk);
    __syncthreads();
    for (int c = c1; c < a.tk; c += tpr) {
      const unsigned long long b =
          abs_bits(a.fast_k ? tile[r1 * a.tk + c] : tile[c * a.tm + r1]);
      mx = b > mx ? b : mx;
    }
  }
  // Lanes of one row differ in bits [lo, hi) of the lane id.
  const int lo = a.fast_k ? 1 : a.tm;
  const int hi = a.fast_k ? (tpr < 32 ? tpr : 32) : 32;
  for (int o = lo; o < hi; o <<= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, mx, o);
    mx = other > mx ? other : mx;
  }
  red[tid] = mx;
  __syncthreads();
  if (tid < a.tm) {
    // One entry per warp of the row.
    const int step = a.fast_k ? (tpr < 32 ? tpr : 32)
                              : (a.tm < 32 ? 32 / a.tm : 1);
    unsigned long long best = 0;
    for (int i = 0; i < tpr; i += step) {
      const unsigned long long b =
          red[a.fast_k ? tid * tpr + i : i * a.tm + tid];
      best = b > best ? b : best;
    }
    const double absmax = from_bits(best, T());
    const double e = absmax > 0.0 ? ceil(log(absmax) * INV_LN2) + 1.0 : 0.0;
    const int ei = (int)e;
    const double sigma = ldexp(1.0, ei);
    row_sigma[tid] = sigma;
    row_inv[tid] = (ei >= -1022 && ei <= 1023) ? ldexp(1.0, -ei) : 0.0;
    if (m0 + tid < a.m) sigma_out[m0 + tid] = sigma;
  }
  __syncthreads();

  // Pass 2: a unit is S_UNIT consecutive k of one row; consecutive
  // threads take consecutive units along k (fast_k) or rows (fast m),
  // so their shared-memory reads do not collide.
  const double radix = ldexp(1.0, a.slice_bits);
  const long long plane = a.m * a.k;
  const int per_row = a.tk / S_UNIT;
  const int units = a.tm * per_row;
  for (int j = 0; j < a.chunks; ++j) {
    const long long k0 = (long long)j * a.tk;
    if (a.chunks > 1) {
      __syncthreads();
      load_chunk(tile, x, a, m0, k0);
      __syncthreads();
    }
    for (int u = tid; u < units; u += S_THREADS) {
      const int r = a.fast_k ? u / per_row : u % a.tm;
      const int cg = a.fast_k ? u % per_row : u / a.tm;
      const long long gm = m0 + r, gk = k0 + (long long)cg * S_UNIT;
      if (gm >= a.m || gk >= a.k) continue;
      double v[S_UNIT];
      if (a.fast_k) {
        load_run(tile + r * a.tk + cg * S_UNIT, v);
      } else {
#pragma unroll
        for (int e = 0; e < S_UNIT; ++e)
          v[e] = (double)tile[(cg * S_UNIT + e) * a.tm + r];
      }
      const double inv = row_inv[r];
      if (inv != 0.0) {
#pragma unroll
        for (int e = 0; e < S_UNIT; ++e) v[e] = __dmul_rn(v[e], inv);
      } else {
        const double sig = row_sigma[r];
#pragma unroll
        for (int e = 0; e < S_UNIT; ++e) v[e] = __ddiv_rn(v[e], sig);
      }
      const long long left = a.k - gk;
      const int n = left < S_UNIT ? (int)left : S_UNIT;
      int8_t* out = slices + gm * a.k + gk;
      for (int t = 0; t < a.num_splits; ++t, out += plane) {
        uint32_t w[S_UNIT / 4] = {};
#pragma unroll
        for (int e = 0; e < S_UNIT; ++e) {
          const double y = __dmul_rn(v[e], radix);
          const double big = __dadd_rn(y, ROUND_MAGIC);
          const double q = __dsub_rn(big, ROUND_MAGIC);
          v[e] = __dsub_rn(y, q);
          w[e / 4] |= ((uint32_t)__double2loint(big) & 0xffu) << (8 * (e % 4));
        }
        if (n == S_UNIT && (a.k & 15) == 0) {
          *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
        } else if (n == S_UNIT && (a.k & 3) == 0) {
          uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
          o32[0] = w[0], o32[1] = w[1], o32[2] = w[2], o32[3] = w[3];
        } else {
#pragma unroll
          for (int e = 0; e < S_UNIT; ++e)
            if (e < n) out[e] = (int8_t)(w[e / 4] >> (8 * (e % 4)));
        }
      }
    }
  }
}

// The dynamic shared memory limit of each instance is raised per device
// to the largest size asked for so far, whatever that size: without it
// a kernel may take only 48 KB less its static shared memory (red,
// row_sigma and row_inv, 6 KB) as dynamic memory.
template <typename T>
cudaError_t launch_slice(const void* x, void* slices, void* sigma,
                         const SliceArgs& a, size_t smem, int device,
                         cudaStream_t stream) {
  static size_t raised[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        slice_operand_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    raised[device] = smem;
  }
  const unsigned grid = (unsigned)((a.m + a.tm - 1) / a.tm);
  slice_operand_kernel<T><<<grid, S_THREADS, smem, stream>>>(
      (const T*)x, (int8_t*)slices, (double*)sigma, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) float (dtype 0) or double (dtype 1) with the plan's strides
// -> slices (s, m, k) int8 and sigma (m,) double, contiguous on
// `device`; runs on `stream`.  A plan the kernel does not take is
// refused with cudaErrorInvalidValue.
cudaError_t slice_operand_launch(const void* x, int dtype, void* slices,
                                 void* sigma, const SliceArgs* args,
                                 int device, void* stream) {
  const SliceArgs a = *args;
  const int elem = dtype == 0 ? 4 : dtype == 1 ? 8 : 0;
  if (elem == 0 || a.m < 1 || a.k < 1 || a.stride_m < 0 || a.stride_k < 0 ||
      a.num_splits < 1 || a.slice_bits < 1 || a.slice_bits > 7)
    return cudaErrorInvalidValue;
  if (a.tm < 1 || a.tm > S_THREADS || (a.tm & (a.tm - 1)) != 0 ||
      a.tk < S_UNIT || a.tk % S_UNIT != 0 ||
      a.chunks != (a.k + a.tk - 1) / a.tk)
    return cudaErrorInvalidValue;
  if ((a.vec != 1 && a.vec * elem != 16) ||
      (a.fast_k ? a.tk : a.tm) % a.vec != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)a.tm * a.tk * elem;
  if (smem > (size_t)S_SMEM_MAX || (a.m + a.tm - 1) / a.tm > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0
             ? launch_slice<float>(x, slices, sigma, a, smem, device, st)
             : launch_slice<double>(x, slices, sigma, a, smem, device, st);
}

}  // extern "C"
