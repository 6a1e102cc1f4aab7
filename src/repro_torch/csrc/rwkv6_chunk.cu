// Chunked RWKV-6 WKV, written for Hopper (sm_90a).
//
// Inputs r, k, v, w (the log-decay, <= 0), row-major (B, S, H, hs) float32,
// and the bonus u, (H, hs) float32.  Output (B, S, H, hs) float32:
//
//   out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),   S_t = diag(e^{w_t}) S_{t-1} + k_tᵀ v_t
//
// with S_{-1} = 0 for every (b, h), in the chunked form of c tokens:
//   cum = cumsum(w) over the chunk, cum_excl = cum − w;
//   A[i][j] = Σ_d r_id k_jd e^{clip(cum_excl_id − cum_jd, −60, 0)} for j < i,
//   A[i][i] = Σ_d r_id u_d k_id, zero above the diagonal;
//   out = A·v + (r ⊙ e^{cum_excl})·S;
//   S ← e^{cum_last} ⊙ S + (k ⊙ e^{cum_last − cum})ᵀ·v.
// Every pairwise exponent is <= 0, so no exponential overflows, whatever
// the decays.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py
// (rwkv6_chunk), whose grid walks (B·H, S/c) in order on one core and
// carries the state in VMEM scratch from one grid step to the next.  On
// Hopper blocks run in parallel and in no order, so one block owns one
// (b, h) and walks its chunks in a loop, the state in its registers.
//
// Bound: bytes.  The function must read r, k, v, w (4·B·S·H·hs floats) and
// u, and write B·S·H·hs floats: 335.5 MB, 0.100 ms at 3.35 TB/s, for the
// prefill's (8, 1024, 32, 64).  Its operations (the pairwise decays, the
// three products and the elementwise work, counted by wkv_flops in
// chip_smoke.py: 5.5 GFLOP there) take 0.082 ms at the 67 TFLOP/s float32
// rate.  Inside a block the products run from shared memory, so its
// bandwidth (128 bytes a clock an SM) is what this design spends with care.
//
// Design (256 threads a block, one block a (b, h), hs = 16, 32 or 64,
// c = 8 or 16); each chunk is three steps between barriers:
// 1. stage: 4·hs threads each own one column of r, k, w or v and hold its
//    c values in registers, fetched during the previous chunk's steps 2
//    and 3 (the first chunk's before the loop), so the loads' latency
//    hides behind compute.  The w threads take the cumsum in registers, in
//    the reference's order.  r, k and the cums go to shared memory as
//    {r, cum_excl} and {k, cum} pairs; the state goes from registers to
//    shared memory.  Reads are in place from the (B, S, H, hs) layout: a
//    warp reads 32 neighbouring floats of one token's row.
// 2. decays: A's c(c−1)/2 strictly lower entries take two threads each
//    (even and odd keys), summed by one shuffle in a fixed order; c
//    threads take the diagonal.  Then r ⊙ e^{cum_excl} (stored transposed)
//    and k ⊙ e^{cum_last − cum}.
// 3. products: the output is c × hs entries in 4 × 4 register tiles, each
//    tile's sum over j < c and the hs state rows split over 4 neighbouring
//    lanes and joined by two shuffles; the state update is hs × hs entries
//    in 4 × 4 tiles that stay in the registers of their thread for the
//    whole sequence.  Each tile step reads two float4 from shared memory
//    for 16 FMAs; row strides are padded so that the lanes of a quarter
//    warp fall in distinct banks.
// Every sum runs in a fixed order with no atomics: the same result on
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int HS, int C>
struct Layout {                              // shared memory, in floats
  static constexpr int PP = HS + 2;          // rc, kc row stride (float2)
  static constexpr int P1 = C + 4;           // rwT, AT row stride
  static constexpr int P2 = HS + 8;          // vs, st row stride
  static constexpr int NP = C * (C - 1) / 2; // strictly lower entries of A
  static constexpr int kRc = 0, kKc = kRc + 2 * C * PP, kRwT = kKc + 2 * C * PP;
  static constexpr int kKw = kRwT + HS * P1, kAT = kKw + C * HS, kVs = kAT + C * P1;
  static constexpr int kSt = kVs + C * P2, kDec = kSt + HS * P2, kUs = kDec + HS;
  static constexpr int kFloats = kUs + HS;
  static_assert(2 * NP + C <= kThreads && 4 * HS <= kThreads, "too few threads");
  static_assert((HS / 4) * (HS / 4) <= kThreads && C * HS / 4 <= kThreads, "too few threads");
  static_assert(C * HS / 4 % 32 == 0, "the output tiles must fill whole warps");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
}

template <int HS, int C>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ out,
                   int64_t S, int64_t H) {
  using L = Layout<HS, C>;
  constexpr int PP = L::PP, P1 = L::P1, P2 = L::P2, NP = L::NP, T4 = HS / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float2* rc = reinterpret_cast<float2*>(sm + L::kRc);   // [C][PP] {r, cum_excl}
  float2* kc = reinterpret_cast<float2*>(sm + L::kKc);   // [C][PP] {k, cum}
  float* rwT = sm + L::kRwT;                             // [HS][P1] r ⊙ e^{cum_excl}, transposed
  float* kw = sm + L::kKw;                               // [C][HS]  k ⊙ e^{cum_last − cum}
  float* AT = sm + L::kAT;                               // [C][P1]  A transposed
  float* vs = sm + L::kVs;                               // [C][P2]
  float* st = sm + L::kSt;                               // [HS][P2] state at the chunk's start
  float* dec = sm + L::kDec;                             // [HS] e^{cum_last}
  float* us = sm + L::kUs;                               // [HS]

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t row = H * HS;                            // floats from one token to the next
  const int64_t head = b * S * row + h * HS;
  const int64_t n_chunks = S / C;

  // step 1's role: column ld of r, k, w or v
  const bool loader = tid < 4 * HS;
  const int which = tid / HS, ld = tid % HS;
  const float* src = (which == 0 ? r : which == 1 ? k : which == 2 ? w : v) + head + ld;
  float buf[C];
  // step 2's roles: an entry of A below the diagonal (two threads), or on it
  const bool pair = tid < 2 * NP, diag = !pair && tid < 2 * NP + C;
  const int half = tid & 1, di = tid - 2 * NP;
  int pi = 1, pj = tid >> 1;                             // entry tid >> 1 below the diagonal
  while (pj >= pi) { pj -= pi; ++pi; }
  // step 3's roles: an output tile and a quarter of its sum; a state tile
  const bool outs = tid < C * HS / 4;
  const int ks = tid & 3, ti = (tid >> 2) / T4, tj = (tid >> 2) % T4;
  const bool owner = tid < T4 * T4;
  const int tq = tid / T4, tc = tid % T4;
  float s[4][4] = {};

  for (int e = tid; e < C * P1; e += kThreads) AT[e] = 0.f;   // zero above the diagonal
  for (int e = tid; e < HS; e += kThreads) us[e] = u[h * HS + e];
  if (loader) {
#pragma unroll
    for (int t = 0; t < C; ++t) buf[t] = src[t * row];
  }

  for (int64_t c = 0; c < n_chunks; ++c) {
    // 1. stage the chunk and the state
    if (loader) {
      if (which == 0) {
#pragma unroll
        for (int t = 0; t < C; ++t) rc[t * PP + ld].x = buf[t];
      } else if (which == 1) {
#pragma unroll
        for (int t = 0; t < C; ++t) kc[t * PP + ld].x = buf[t];
      } else if (which == 2) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          acc += buf[t];
          kc[t * PP + ld].y = acc;
          rc[t * PP + ld].y = acc - buf[t];
        }
        dec[ld] = __expf(acc);
      } else {
#pragma unroll
        for (int t = 0; t < C; ++t) vs[t * P2 + ld] = buf[t];
      }
    }
    if (owner) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(st + (4 * tq + i) * P2 + 4 * tc) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    if (loader && c + 1 < n_chunks) {                    // the next chunk, into registers
      const float* p = src + (c + 1) * C * row;
#pragma unroll
      for (int t = 0; t < C; ++t) buf[t] = p[t * row];
    }

    // 2. the decays: A, r ⊙ e^{cum_excl}, k ⊙ e^{cum_last − cum}
    float a = 0.f;
    if (pair) {
#pragma unroll 8
      for (int m = 0; m < HS / 2; ++m) {
        const int d = 2 * m + half;
        const float2 x = rc[pi * PP + d], y = kc[pj * PP + d];
        a += x.x * y.x * __expf(fminf(fmaxf(x.y - y.y, -60.f), 0.f));
      }
    } else if (diag) {
#pragma unroll 8
      for (int d = 0; d < HS; ++d) a += rc[di * PP + d].x * us[d] * kc[di * PP + d].x;
    }
    const float other = __shfl_xor_sync(0xffffffffu, a, 1);
    if (pair && half == 0) AT[pj * P1 + pi] = a + other;
    if (diag) AT[di * P1 + di] = a;
    for (int e = tid; e < C * HS; e += kThreads) {
      const int i = e % C, q = e / C;
      const float2 x = rc[i * PP + q];
      rwT[q * P1 + i] = x.x * __expf(x.y);
    }
    for (int e = tid; e < C * HS; e += kThreads) {
      const int j = e / HS, q = e % HS;
      const float2 y = kc[j * PP + q];
      kw[j * HS + q] = y.x * __expf(kc[(C - 1) * PP + q].y - y.y);
    }
    __syncthreads();

    // 3. the products: the output tiles, then the state tiles
    if (outs) {
      float acc[4][4] = {};
#pragma unroll
      for (int m = 0; m < C / 4; ++m) {
        const int j = ks + 4 * m;
        outer(acc, ld4(AT + j * P1 + 4 * ti), ld4(vs + j * P2 + 4 * tj));
      }
#pragma unroll 4
      for (int m = 0; m < HS / 4; ++m) {
        const int q = ks + 4 * m;
        outer(acc, ld4(rwT + q * P1 + 4 * ti), ld4(st + q * P2 + 4 * tj));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 2);
        }
      float4 o = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
#pragma unroll
      for (int i = 1; i < 4; ++i)
        if (ks == i) o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + head + (c * C + 4 * ti + ks) * row + 4 * tj) = o;
    }
    if (owner) {
      float add[4][4] = {};
#pragma unroll
      for (int j = 0; j < C; ++j) outer(add, ld4(kw + j * HS + 4 * tq), ld4(vs + j * P2 + 4 * tc));
      const float4 dq = ld4(dec + 4 * tq);
      const float dv[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dv[i] * s[i][j] + add[i][j];
    }
    __syncthreads();
  }
}

template <int HS, int C>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<HS, C>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_chunk_kernel<HS, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunk_kernel<HS, C><<<(unsigned)(B * H), kThreads, bytes, stream>>>(r, k, v, w, u, out,
                                                                            S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  The caller checks shapes:
// hs in {16, 32, 64}, chunk in {8, 16}, S % chunk == 0, B·H < 2^31.
int rwkv6_chunk_f32(const float* r, const float* k, const float* v, const float* w,
                    const float* u, float* out, long long B, long long S, long long H,
                    int hs, int chunk, void* stream) {
  if (chunk <= 0 || B * H <= 0 || B * H > 0x7fffffffLL || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RWKV6_CASE(HS_, C_) \
  if (hs == HS_ && chunk == C_) return launch<HS_, C_>(r, k, v, w, u, out, B, S, H, s);
  RWKV6_CASE(16, 8) RWKV6_CASE(16, 16) RWKV6_CASE(32, 8) RWKV6_CASE(32, 16)
  RWKV6_CASE(64, 8) RWKV6_CASE(64, 16)
#undef RWKV6_CASE
  return (int)cudaErrorInvalidValue;
}

const char* rwkv6_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
