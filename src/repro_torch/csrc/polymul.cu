// Batched circular polynomial product mod z^k, written for Hopper (sm_90a).
//
//   out[r, i] = Σ_j a[r mod pa, j] · b[r mod pb, (i − j) mod k]
//
// for rows r < B and 0 <= i < k: the ⊗ of the paper's coefficient-domain
// sketch semiring (PolyCoeff).  Inputs a, b: row-major (pa, k) and (pb, k),
// f32 or bf16; a row period below B reads a factor broadcast over leading
// dims in place (pa = B when it is not broadcast).  Products are summed in
// f32 and written in the input dtype.  2 <= k <= 1024, any k.
//
// Replaces the TPU kernel src/repro/kernels/polymul/polymul.py (poly_mul),
// which builds each row's k x k circulant of a and multiplies it into b on
// the MXU.  Hopper has no such matrix unit for f32, and a circulant built
// in shared memory would cost k*k floats per row, so this kernel sums the
// k products of each output directly from the two rows staged in shared
// memory.
//
// Bound: bytes.  The work must read 2*B*k*sizeof(in) and write
// B*k*sizeof(out) bytes over 3.35 TB/s; the FFT form of the same function
// needs about 3*2.5*k*log2(k) + 6*(k/2+1) flops per row, less time at the
// f32 rate (at k = 256: 3.9 ms of bytes against 1.0 ms of flops for
// B = 2^22 rows).  This kernel does the direct form instead, 2*B*k*k
// flops, 8x (k = 256) to 26x (k = 1024) the FFT form's, so it is limited
// by the f32 FMA rate and by shared-memory loads (8.2 ms at 67 TFLOP/s for
// B = 2^22, k = 256), not by bytes.  A tensor-core or shared-memory-FFT
// design is later work.
//
// Design:
// - one block per tile of rows; each row's a (zero-padded to R*T) and b
//   are staged in shared memory as f32, T = ceil(k/R) threads per row;
// - thread t of a row owns the R outputs i = t + s*T (s < R) and walks
//   j = jl + q*T for jl < T, q < R.  The b index (i − j) mod k then
//   depends only on s − q, so each jl step loads R values of a
//   (broadcast in the warp) and R (R*T == k) or 2R−1 values of b into
//   registers and does R*R FMAs from them;
// - no atomics, and every output sums its k products in the same fixed
//   order, so the result is bit-identical from run to run;
// - rows of a tile sharing a warp (T < 32) are offset by T floats in
//   shared memory so their loads fall in distinct banks;
// - all global address arithmetic is 64-bit (B*k reaches 2^30 on the
//   sketch fit's path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;            // outputs per thread
constexpr int kThreads = 256;    // threads per block, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
poly_mul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                int64_t B, int k, int tk, int rows, int stride, int64_t pa, int64_t pb) {
  extern __shared__ float smem[];
  float* As = smem;                      // rows x stride: a[0..R*tk), zero past k
  float* Bs = smem + rows * stride;      // rows x stride: b[0..k)
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int nthr = rows * tk;
  const int rt = kR * tk;

  for (int lr = 0; lr < rows; ++lr) {
    const int64_t r = row0 + lr;
    const bool live = r < B;
    const T* ar = a + (live ? (r < pa ? r : r % pa) : 0) * (int64_t)k;
    const T* br = b + (live ? (r < pb ? r : r % pb) : 0) * (int64_t)k;
    for (int c = threadIdx.x; c < rt; c += nthr) {
      const bool in = live && c < k;
      As[lr * stride + c] = in ? to_f32(ar[c]) : 0.f;
      if (c < k) Bs[lr * stride + c] = in ? to_f32(br[c]) : 0.f;
    }
  }
  __syncthreads();

  const int lr = threadIdx.x / tk;
  const int t = threadIdx.x - lr * tk;
  const int64_t r = row0 + lr;
  if (r >= B) return;
  const float* Ar = As + lr * stride;
  const float* Br = Bs + lr * stride;

  // window slot w holds b[(t + m*tk − jl) mod k], m = w (exact) or w − (R−1)
  constexpr int kNB = kExact ? kR : 2 * kR - 1;
  int p[kNB];
#pragma unroll
  for (int w = 0; w < kNB; ++w) {
    const int m = kExact ? w : w - (kR - 1);
    int x = (t + m * tk) % k;
    p[w] = x < 0 ? x + k : x;
  }
  float acc[kR];
#pragma unroll
  for (int s = 0; s < kR; ++s) acc[s] = 0.f;

  for (int jl = 0; jl < tk; ++jl) {
    float av[kR], bv[kNB];
#pragma unroll
    for (int q = 0; q < kR; ++q) av[q] = Ar[jl + q * tk];
#pragma unroll
    for (int w = 0; w < kNB; ++w) bv[w] = Br[p[w]];
#pragma unroll
    for (int s = 0; s < kR; ++s) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int w = kExact ? (s - q + kR) % kR : s - q + kR - 1;
        acc[s] = fmaf(av[q], bv[w], acc[s]);
      }
    }
#pragma unroll
    for (int w = 0; w < kNB; ++w) p[w] = (p[w] == 0 ? k : p[w]) - 1;
  }

  T* o = out + r * (int64_t)k;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int i = t + s * tk;
    if (i < k) store(o + i, acc[s]);
  }
}

template <typename T>
cudaError_t launch(const T* a, const T* b, T* out, int64_t B, int64_t k, int64_t pa,
                   int64_t pb, cudaStream_t stream) {
  if (k < 2 || k > 1024 || pa < 1 || pb < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int tk = (int)((k + kR - 1) / kR);           // threads per row, <= 128
  const int rows = kThreads / tk;                     // rows per block, >= 2
  const int stride = kR * tk + (tk < 32 ? tk : 0);
  const int64_t blocks = (B + rows - 1) / rows;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)rows * stride * sizeof(float);   // <= 18.5 KB
  const dim3 grid((unsigned)blocks), block(rows * tk);
  if (kR * tk == k) {
    poly_mul_kernel<T, true><<<grid, block, smem, stream>>>(a, b, out, B, (int)k, tk, rows,
                                                            stride, pa, pb);
  } else {
    poly_mul_kernel<T, false><<<grid, block, smem, stream>>>(a, b, out, B, (int)k, tk, rows,
                                                             stride, pa, pb);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int poly_mul_f32(const void* a, const void* b, void* out, long long B, long long k,
                            long long pa, long long pb, void* stream) {
  return (int)launch<float>((const float*)a, (const float*)b, (float*)out, B, k, pa, pb,
                            (cudaStream_t)stream);
}

extern "C" int poly_mul_bf16(const void* a, const void* b, void* out, long long B, long long k,
                             long long pa, long long pb, void* stream) {
  return (int)launch<__nv_bfloat16>((const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
                                    (__nv_bfloat16*)out, B, k, pa, pb, (cudaStream_t)stream);
}

extern "C" const char* poly_mul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
