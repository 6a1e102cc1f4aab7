// Count sketch (signed scatter-add into k buckets) and its unsketch, written for Hopper (sm_90a).
//
//   sketch[j] = Σ_t [h(t) = j] · s(t) · x[t],      t = 0 .. n − 1,
//
// into a float32 sketch of k buckets that the caller has zeroed.  Two forms:
// - count_sketch_scatter takes the buckets h(t) (int32) and the signs s(t)
//   (float32) as arrays, as the TPU kernel does;
// - count_sketch_hashed computes them from t in 32-bit words, the
//   Dietzfelbinger multiply-add-shift of core/sketch.py's Hash2:
//   h(t) = (a·t + b mod 2³²) >> shift, s(t) = 1 − 2·((a2·t + b2 mod 2³²) >> 31),
//   so no index array is ever stored (an int64 one would take 8n bytes).
// count_sketch_unsketch is the gradient compressor's second pass
// (optim/grad_compress.py): est[t] = s(t) · sketch[h(t)] · scale and, when a
// state pointer is given, state[t] = x[t] − est[t] (error feedback).  Each
// element is read and written by one thread only, so est may be x's buffer
// and state may be x's buffer.
//
// Replaces the TPU kernel src/repro/kernels/count_sketch/count_sketch.py
// (count_sketch), which turns each 512-element tile into a one-hot (512 × k)
// matrix and a matmul on the MXU, because the TPU serializes scatters; its
// VMEM one-hot caps k near 1,024, and the gradient compressor's sketches
// have k up to 2²⁵.  Here every element is one atomic add into device memory
// (RED.ADD.F32, the return value unused): the k buckets are far larger than
// shared memory, so there are no per-block partial sketches.  The sum order
// of a bucket is therefore not fixed: two runs may differ in the last bits.
//
// Bound: bytes.  The hashed form reads x (4n bytes) and writes the sketch
// (4k bytes): 0.343 ms at n = 253,755,392, k = 2²⁵ at 3.35 TB/s.  Each
// random atomic moves a 32-byte sector of a sketch larger than L2, so this
// simple form runs about 30× above its bound (10.4 ms on an H100 80GB HBM3
// at 700 W, chip_smoke.py phase 1); a sector-coalesced form (bins of the
// hash's top bits in shared memory) or a deterministic two-pass form is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;      // grid-stride loops: 32 blocks an SM

struct Hash {
  uint32_t a, b, a2, b2;
  int shift;
  __device__ __forceinline__ uint32_t bucket(uint32_t t) const { return (a * t + b) >> shift; }
  __device__ __forceinline__ float sign(uint32_t t) const {
    return ((a2 * t + b2) >> 31) ? -1.f : 1.f;
  }
};

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* x, const int* buckets, const float* signs, float* out, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n; t += stride)
    atomicAdd(out + buckets[t], x[t] * signs[t]);
}

// One element a thread a step, both kernels: at (253,755,392, 2²⁵) the
// sketch ran in 10.2 ms and the unsketch in 5.9 ms, against 15.3 and 7.6 ms
// for four elements a thread through 16-byte accesses (the random atomics
// and gathers, not the streaming accesses, are the limit).
__global__ void __launch_bounds__(kThreads)
hashed_kernel(const float* x, float* out, long long n, const Hash h) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n; t += stride)
    atomicAdd(out + h.bucket((uint32_t)t), x[t] * h.sign((uint32_t)t));
}

// s(t)·sk[h(t)] rounded, then times scale rounded: the reference's two
// products.  __fmul_rn keeps the compiler from fusing the second product into
// the subtraction x − est (an FMA would skip est's rounding).
__device__ __forceinline__ float estimate(const float* sk, const Hash& h, uint32_t t, float scale) {
  return __fmul_rn(h.sign(t) * __ldg(sk + h.bucket(t)), scale);
}

__global__ void __launch_bounds__(kThreads)
unsketch_kernel(const float* x, const float* sk, float* est, float* state, long long n,
                const Hash h, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n; t += stride) {
    const float e = estimate(sk, h, (uint32_t)t, scale);
    if (state) state[t] = x[t] - e;             // x[t] read before est[t] (it may be x) is written
    est[t] = e;
  }
}

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch.  The caller checks that
// n < 2³¹, that out has k = 2^(32 − shift) zeroed floats and that every
// bucket lies in [0, k).

int count_sketch_scatter(const float* x, const int* buckets, const float* signs, float* out,
                         long long n, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, buckets, signs, out, n);
  return (int)cudaGetLastError();
}

int count_sketch_hashed(const float* x, float* out, long long n, unsigned a, unsigned b,
                        unsigned a2, unsigned b2, int shift, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || shift < 1 || shift > 31) return (int)cudaErrorInvalidValue;
  const Hash h{a, b, a2, b2, shift};
  hashed_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, h);
  return (int)cudaGetLastError();
}

int count_sketch_unsketch(const float* x, const float* sk, float* est, float* state, long long n,
                          unsigned a, unsigned b, unsigned a2, unsigned b2, int shift, float scale,
                          void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || shift < 1 || shift > 31) return (int)cudaErrorInvalidValue;
  const Hash h{a, b, a2, b2, shift};
  unsketch_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, sk, est, state, n, h,
                                                                     scale);
  return (int)cudaGetLastError();
}

const char* count_sketch_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
