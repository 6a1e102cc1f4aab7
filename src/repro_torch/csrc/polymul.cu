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
// the MXU.
//
// Bound: bytes.  The work must read 2*B*k*sizeof(in) and write
// B*k*sizeof(out) bytes over 3.35 TB/s; the FFT form of the same function
// needs about 3*2.5*k*log2(k) + 6*(k/2+1) flops per row, less time at the
// f32 rate (at k = 256: 3.9 ms of bytes against 1.0 ms of flops for
// B = 2^22 rows).  Both paths below sum the direct form's 2*B*k*k flops
// instead, the same products the TPU kernel's circulant sums, because an
// FFT leaves noise of order eps*|a|*|b| on outputs whose |a| ⊛ |b| is 0
// (monomial ⊗ monomial on the sketch path) and so cannot hold a
// per-element limit of 2e-5*(|a| ⊛ |b|).
//
// Tensor-core path (k = 16*MT*p with p <= 8: every multiple of 16 up to
// 128 at MT = 1, and 256, 512, 1024 at MT = 2, 4, 8 with p = 8): the
// circulant as a small matrix product a row, the block-Toeplitz form of
// the TPU kernel's circulant.  With k = m*p, m = 16*MT:
//   out[u*m + t] = Σ_{d<p, s<m} L[t, (d,s)] · R[(d,s), u],
//   L[t, (d,s)] = b[(d*m + t − s) mod k],  R[(d,s), u] = a[((u − d) mod p)*m + s],
// an (m x k)·(k x p) product, 2k^2 flops.  One warp owns a row: it stages
// the row's a (as p rows of m, padded to m + 4 floats so the R fragments'
// loads fall in 32 distinct banks) and b (with a wrapped margin, so no
// index needs a mod) in its shared memory as f32 (for f32 inputs split
// once there into TF32 hi and lo copies), and runs mma.sync m16n8k8 TF32
// over the k/8 K-steps, MT m-tiles by one n-tile of 8 columns (columns
// past p masked).  The K-steps are taken in the order of
// β = d*m − s0 = 0, 8, 16, ..: step β's L fragment of m-tile i is b at
// β + 16i + (row − column), so the fragments of all m-tiles at one step
// form a window of 2*MT eight-wide slices of b that slides by one slice a
// step: each step loads 2 new values of L a lane (hi and lo), kept in a
// register ring unrolled over 2*MT steps, and 2 of R.  A warp's next
// row is copied into a raw area of its shared memory by cp.async (16-byte
// copies: the wrapper hands over 16-byte-aligned rows) while it
// multiplies the current one.  Bound in practice:
// the MMA issue rate and the fragments' shared-memory loads, not bytes
// (f32 at k = 256 takes 192 MMAs a row, bf16 64).
//
// Precision.  f32 takes three TF32 products (3xTF32): each operand
// x = x_hi + x_lo, x_hi rounded to TF32 (11 significant bits) and x_lo
// read by the MMA truncated to TF32, and a·b ≈ a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, accumulated in f32 by the tensor core.  A zero operand
// splits into two zeros, so a zero product stays exactly zero; each
// product's error is at most about 5·2^-22·|a||b| (the dropped a_lo·b_lo,
// 2^-22, and the truncation of the two lo parts, 2^-21 each), so with the
// f32 sum of k products every output stays within 2e-5·(|a| ⊛ |b|), as
// the direct form does: monomial ⊗ monomial keeps its exact zeros, and
// integer-valued inputs whose partial sums are exact in f32 (|x| < 2^11
// split with x_lo = 0) stay exact.  Summing 1,024 products in f32 costs
// what it costs in the direct form.  bf16 values are exact in TF32 (8
// significant bits), so bf16 takes the one product a_hi·b_hi, exact,
// accumulated in f32 like the direct form, and rounds once on output.
// Measured on the card (chip_smoke.py phase 1): the largest |err| is
// 0.03–0.12 of the limit in f32, and bf16 sits at its output rounding.
//
// Direct path (every other k: 250 or 1000, and multiples of 16 such as
// 144 or 768 whose p would pass 8): the k products of each output summed
// from the two rows staged in shared memory on the FMA pipe:
// - one block per tile of rows; each row's a (zero-padded to R*T) and b
//   are staged in shared memory as f32, T = ceil(k/R) threads per row;
// - thread t of a row owns the R outputs i = t + s*T (s < R) and walks
//   j = jl + q*T for jl < T, q < R.  The b index (i − j) mod k then
//   depends only on s − q, so each jl step loads R values of a
//   (broadcast in the warp) and R (R*T == k) or 2R−1 values of b into
//   registers and does R*R FMAs from them;
// - rows of a tile sharing a warp (T < 32) are offset by T floats in
//   shared memory so their loads fall in distinct banks.
//
// Both paths: no atomics, and every output sums its k products in the
// same fixed order, so the result is bit-identical from run to run; all
// global address arithmetic is 64-bit (B*k reaches 2^30 on the sketch
// fit's path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kR = 8;            // direct path: outputs per thread
constexpr int kThreads = 256;    // direct path: threads per block, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------ tensor-core path --
constexpr int kTcWarps = 4;      // warps per block, one row each at a time
constexpr int kMaxDevices = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// x as TF32 parts: hi = x rounded to TF32 (10 explicit mantissa bits,
// ties away from zero) by two integer operations, and lo = x − hi, which
// the MMA reads with its low 13 bits dropped.  (cvt.rna.tf32.f32 issues
// at a fraction of the ALU rate and held the kernel back.)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = x - hi;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The TF32 parts of a staged value: hi at p and (kSplit) lo at p + lo_off.
template <bool kSplit>
__device__ __forceinline__ void parts(const float* p, int lo_off, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(p[0]);
  lo = kSplit ? __float_as_uint(p[lo_off]) : 0u;
}

// One eight-wide slice of the L window: b at y + g − c (rows of the
// fragment) and at y + g − c − 4 (its columns + 4).
struct Slice {
  uint32_t xh, xl, zh, zl;
};

template <bool kSplit>
__device__ __forceinline__ Slice load_slice(const float* q, int lo_off) {
  Slice s;
  parts<kSplit>(q, lo_off, s.xh, s.xl);
  parts<kSplit>(q - 4, lo_off, s.zh, s.zl);
  return s;
}

// Floats of one warp's staged operands: a (p rows of M + 4) and b
// (k + M + 8), twice for f32 (hi and lo parts).  Each warp also has a raw
// area of 2k values of T for the row in flight.
template <typename T, int MT>
__host__ __device__ __forceinline__ int warp_floats(int k) {
  return (k / (16 * MT) * (16 * MT + 4) + k + 16 * MT + 8) * (sizeof(T) == 4 ? 2 : 1);
}

template <typename T, int MT>
size_t block_smem(int k) {
  return kTcWarps * (warp_floats<T, MT>(k) * sizeof(float) + 2 * (size_t)k * sizeof(T));
}

template <typename T, int MT>
__global__ void __launch_bounds__(kTcWarps * 32)
poly_mul_tc(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
            int64_t B, int k, int64_t pa, int64_t pb) {
  constexpr int M = 16 * MT;               // rows t of the product
  constexpr int SA = M + 4;                // padded row of the staged a
  constexpr bool kSplit = sizeof(T) == 4;  // f32: 3xTF32; bf16: exact in TF32
  extern __shared__ float smem[];
  const int p = k / M;
  const int wf = warp_floats<T, MT>(k);
  const int lo_off = kSplit ? wf / 2 : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float* As = smem + warp * wf;            // As[q*SA + s] = a[q*M + s] (hi; lo at + lo_off)
  float* Bs = As + p * SA;                 // Bs[8 + x] = b[x mod k], −8 <= x < k + M
  const float* bq = Bs + 8 + g - c;
  const int qcol = g % p;                  // this lane's column u = g, mod p
  const int steps = k / 8;                 // a multiple of 2*MT: k/8 = 2*MT*p

  auto put1 = [&](float* dst, float v) {
    if (kSplit) {
      split(v, dst[0], dst[lo_off]);
    } else {
      dst[0] = v;
    }
  };
  // the next row's a and b land in a raw area by cp.async while the warp
  // multiplies this one; then the warp splits them into As and Bs
  T* raw = reinterpret_cast<T*>(smem + kTcWarps * wf) + warp * 2 * k;
  const int chunks = k * (int)sizeof(T) / 16;   // 16-byte copies an operand
  auto fetch = [&](int64_t r) {
    if (r < B) {
      const char* ar = reinterpret_cast<const char*>(a + (r < pa ? r : r % pa) * (int64_t)k);
      const char* br = reinterpret_cast<const char*>(b + (r < pb ? r : r % pb) * (int64_t)k);
      char* ra = reinterpret_cast<char*>(raw);
      for (int i = lane; i < chunks; i += 32) {
        cp_async16(ra + 16 * i, ar + 16 * i);
        cp_async16(ra + 16 * (chunks + i), br + 16 * i);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int64_t rstep = (int64_t)gridDim.x * kTcWarps;
  int64_t r = (int64_t)blockIdx.x * kTcWarps + warp;
  fetch(r);
  for (; r < B; r += rstep) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();                          // row r has landed; the last row's reads are done
    for (int x = lane; x < k; x += 32) {
      const float av = to_f32(raw[x]), bv = to_f32(raw[k + x]);
      put1(As + (x / M) * SA + x % M, av);
      put1(Bs + 8 + x, bv);
      if (x < M) put1(Bs + 8 + k + x, bv);
      if (x >= k - 8) put1(Bs + x - (k - 8), bv);
    }
    __syncwarp();                          // raw is free again
    fetch(r + rstep);

    float acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    // window slice j of step n sits in ring[(n + j) mod 2MT]: b at β + 8j
    Slice ring[2 * MT];
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) ring[j] = load_slice<kSplit>(bq + 8 * j, lo_off);
    int d = 0, s0 = 0;                     // step β = d*M − s0 (mod k)
    for (int n0 = 0; n0 < steps; n0 += 2 * MT) {
#pragma unroll
      for (int u = 0; u < 2 * MT; ++u) {
        const Slice next = load_slice<kSplit>(bq + 8 * (n0 + u) + 16 * MT, lo_off);
        uint32_t bh[2], bl[2];
        int q = qcol - d;
        q += q < 0 ? p : 0;
        const float* ap = As + q * SA + s0 + c;
        parts<kSplit>(ap, lo_off, bh[0], bl[0]);
        parts<kSplit>(ap + 4, lo_off, bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const Slice& w0 = ring[(u + 2 * i) % (2 * MT)];
          const Slice& w1 = ring[(u + 2 * i + 1) % (2 * MT)];
          if (kSplit) {                    // the two small products first
            mma_tf32(acc[i], w0.xl, w1.xl, w0.zl, w1.zl, bh[0], bh[1]);
            mma_tf32(acc[i], w0.xh, w1.xh, w0.zh, w1.zh, bl[0], bl[1]);
          }
          mma_tf32(acc[i], w0.xh, w1.xh, w0.zh, w1.zh, bh[0], bh[1]);
        }
        ring[u] = next;                    // slice 0 of this step is done
        if (s0 == 0) {
          d = d + 1 == p ? 0 : d + 1;
          s0 = M - 8;
        } else {
          s0 -= 8;
        }
      }
    }

    T* o = out + r * (int64_t)k;
    const int u0 = 2 * c;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int t = 16 * i + g;
      if (u0 < p) {
        store(o + u0 * M + t, acc[i][0]);
        store(o + u0 * M + t + 8, acc[i][2]);
      }
      if (u0 + 1 < p) {
        store(o + (u0 + 1) * M + t, acc[i][1]);
        store(o + (u0 + 1) * M + t + 8, acc[i][3]);
      }
    }
  }
}

template <typename T, int MT>
cudaError_t launch_tc(const T* a, const T* b, T* out, int64_t B, int k, int64_t pa, int64_t pb,
                      cudaStream_t stream) {
  static int resident[kMaxDevices][1025];  // blocks an SM, by device and k
  static int sms[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t smem = block_smem<T, MT>(k);    // <= 106 KB
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(poly_mul_tc<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 128 * 1024);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (resident[dev][k] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev][k],
                                                        poly_mul_tc<T, MT>,
                                                        kTcWarps * 32, smem);
    if (err != cudaSuccess) return err;
    if (resident[dev][k] == 0) return cudaErrorInvalidConfiguration;
  }
  // every block resident at once, each walking rows r, r + grid*warps, ...
  const int64_t blocks = std::min<int64_t>((B + kTcWarps - 1) / kTcWarps,
                                           (int64_t)sms[dev] * resident[dev][k]);
  poly_mul_tc<T, MT><<<(unsigned)blocks, kTcWarps * 32, smem, stream>>>(
      a, b, out, B, k, pa, pb);
  return cudaGetLastError();
}

// ----------------------------------------------------------- direct path --
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
  // the tensor cores where k = 16*MT*p with p <= 8
  if (k % 16 == 0 && k <= 128) return launch_tc<T, 1>(a, b, out, B, (int)k, pa, pb, stream);
  if (k == 256) return launch_tc<T, 2>(a, b, out, B, (int)k, pa, pb, stream);
  if (k == 512) return launch_tc<T, 4>(a, b, out, B, (int)k, pa, pb, stream);
  if (k == 1024) return launch_tc<T, 8>(a, b, out, B, (int)k, pa, pb, stream);
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
