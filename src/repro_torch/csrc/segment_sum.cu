// Segment-⊕ over a static CSR, written for Hopper (sm_90a).
//
//   out[k, key, c] = Σ_{r ∈ segment(key)} vals[k, order[r], c]
//
// where order is the stable argsort of a join-tree edge's child key ids
// and offsets[key] .. offsets[key+1] is the key's run in it.  Inputs:
// vals (K, n, C) f32 or bf16, row-major; order (n,) int32; offsets
// (n_keys+1,) int32.  Output: (K, n_keys, C) f32.
//
// Replaces the TPU kernel src/repro/kernels/segment_sum/segment_sum.py
// (segment_sum_2d), which builds a one-hot (rows x keys) tile and
// multiplies it into the values on the MXU because scatter is slow on a
// TPU.  On Hopper that matmul would cost n * n_keys MACs for n adds, so
// this kernel reduces each key's run of the CSR directly instead.
//
// Bound: bytes.  The work reads every input once and writes the output
// once: K*n*C*sizeof(in) + 4n + 4(n_keys+1) + 4*K*n_keys*C bytes over
// 3.35 TB/s, against K*n*C adds, far below the f32 peak.
//
// Design:
// - one warp per (k, key), so no two warps write the same output and
//   no atomics are needed;
// - C > 8: lanes stride the channels; each lane adds its channel over
//   the run in CSR order (4 rows unrolled to keep loads in flight);
// - C <= 8: lanes stride the rows, each lane keeps C partial sums, and a
//   fixed xor-shuffle tree combines the lanes;
// - the summation order depends only on the CSR, so the f32 result is
//   bit-identical from run to run;
// - empty runs write zeros; all address arithmetic is 64-bit, because
//   K*n*C passes 2^31 at sketch widths.
// Known costs (left for later work): at C = 3 the gather through order
// reads 12-byte rows and wastes most of each 32-byte sector, and a
// heavily skewed key makes one long run that one warp walks alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNarrowC = 8;  // row-striding path up to this many channels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_wide(const T* __restrict__ vals, const int* __restrict__ order,
                 const int* __restrict__ offsets, float* __restrict__ out,
                 int64_t n_keys, int64_t n, int64_t C, int64_t n_warps) {
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int64_t k = w / n_keys;
  const int64_t key = w - k * n_keys;
  const int beg = offsets[key];
  const int end = offsets[key + 1];
  const T* __restrict__ v = vals + k * n * C;
  float* __restrict__ o = out + w * C;  // w == k * n_keys + key
  for (int64_t c = lane; c < C; c += 32) {
    float acc = 0.f;
    int r = beg;
    for (; r + 4 <= end; r += 4) {
      const int64_t i0 = order[r], i1 = order[r + 1];
      const int64_t i2 = order[r + 2], i3 = order[r + 3];
      const float x0 = to_f32(v[i0 * C + c]);
      const float x1 = to_f32(v[i1 * C + c]);
      const float x2 = to_f32(v[i2 * C + c]);
      const float x3 = to_f32(v[i3 * C + c]);
      acc += x0;
      acc += x1;
      acc += x2;
      acc += x3;
    }
    for (; r < end; ++r) acc += to_f32(v[(int64_t)order[r] * C + c]);
    o[c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_narrow(const T* __restrict__ vals, const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int64_t n_keys, int64_t n, int C, int64_t n_warps) {
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;  // uniform across the warp: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const int64_t k = w / n_keys;
  const int64_t key = w - k * n_keys;
  const int beg = offsets[key];
  const int end = offsets[key + 1];
  const T* __restrict__ v = vals + k * n * C;
  float* __restrict__ o = out + w * C;
  float acc[kNarrowC];
#pragma unroll
  for (int c = 0; c < kNarrowC; ++c) acc[c] = 0.f;
  for (int r = beg + lane; r < end; r += 32) {
    const T* __restrict__ row = v + (int64_t)order[r] * C;
#pragma unroll
    for (int c = 0; c < kNarrowC; ++c)
      if (c < C) acc[c] += to_f32(row[c]);
  }
#pragma unroll
  for (int c = 0; c < kNarrowC; ++c) {
    float s = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && c < C) o[c] = s;
  }
}

template <typename T>
cudaError_t launch(const T* vals, const int* order, const int* offsets, float* out,
                   int64_t K, int64_t n, int64_t n_keys, int64_t C, cudaStream_t stream) {
  const int64_t n_warps = K * n_keys;
  if (n_warps == 0 || C == 0) return cudaSuccess;
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  if (C <= kNarrowC) {
    segment_sum_narrow<T><<<grid, block, 0, stream>>>(vals, order, offsets, out, n_keys, n,
                                                      (int)C, n_warps);
  } else {
    segment_sum_wide<T><<<grid, block, 0, stream>>>(vals, order, offsets, out, n_keys, n, C,
                                                    n_warps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_f32(const void* vals, const void* order, const void* offsets,
                               void* out, long long K, long long n, long long n_keys,
                               long long C, void* stream) {
  return (int)launch<float>((const float*)vals, (const int*)order, (const int*)offsets,
                            (float*)out, K, n, n_keys, C, (cudaStream_t)stream);
}

extern "C" int segment_sum_bf16(const void* vals, const void* order, const void* offsets,
                                void* out, long long K, long long n, long long n_keys,
                                long long C, void* stream) {
  return (int)launch<__nv_bfloat16>((const __nv_bfloat16*)vals, (const int*)order,
                                    (const int*)offsets, (float*)out, K, n, n_keys, C,
                                    (cudaStream_t)stream);
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
