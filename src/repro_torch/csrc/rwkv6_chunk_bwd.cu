// Backward of the chunked RWKV-6 WKV (csrc/rwkv6_chunk.cu), written for
// Hopper (sm_90a).
//
// Inputs: the forward's r, k, v, w (the log-decay, <= 0), row-major
// (B, S, H, hs) float32, the bonus u (H, hs) and the output's gradient do
// (B, S, H, hs), with the state zero at each sequence's start.  Outputs dr,
// dk, dv, dw (B, S, H, hs) and du_part (B, H, hs), the bonus's gradient of
// each (b, h), which the wrapper sums over b in a fixed order.
//
// The TPU reference has no backward kernel: src/repro/models/rwkv6.py
// (rwkv_chunked) is differentiated by jax.grad through its jnp scan.  The
// port needs one because its forward is a kernel that autograd cannot see
// through; this one evaluates the gradient of that forward's chunked
// formulas.  Per chunk of c tokens, with cum = cumsum(w), cum_excl the
// cumsum up to the token before, Q_ij = do_i · v_j, E_ijd =
// e^{clip(cum_excl_id − cum_jd, −60, 0)} for j < i (the forward's
// intra-chunk decays, clipped as the reference clips them), S0 the state
// at the chunk's start and G = dL/d(state after the chunk):
//   dr_i = Σ_{j<i} Q_ij k_j ⊙ E_ij + e^{cum_excl_i} ⊙ (S0·do_i) + u ⊙ k_i Q_ii
//   dk_j = Σ_{i>j} Q_ij r_i ⊙ E_ij + e^{cum_last − cum_j} ⊙ (G·v_j) + u ⊙ r_j Q_jj
//   dv_j = Σ_{i≥j} A_ij do_i + (k_j ⊙ e^{cum_last − cum_j})·G   (A the forward's,
//          u·(r_i ⊙ k_i) on its diagonal)
//   du  += Σ_i r_i ⊙ k_i Q_ii
//   G   ← e^{cum_last} ⊙ G + (r ⊙ e^{cum_excl})ᵀ·do         (for the chunk before)
// and the decays' gradient needs no pairwise exponentials of its own: with
// a_t = r_t ⊙ dr'_t and b_t = k_t ⊙ dk'_t (dr', dk' without their u terms),
//   dw_t = Σ_{i>t} a_i − Σ_{p≥t} b_p = D_t − b_t,  D_t = Σ_{i>t} (a_i − b_i),
// since each pair j < i whose decay passes through t adds to the first sum
// and not to the second.  D is carried in reverse over the whole sequence;
// it stays the size of the pairs that straddle t, not of the sums.
//
// Design: one block of 256 threads a (b, h).  It first walks the chunks
// forward and writes each chunk's starting state into a scratch of
// B·H·(S/c)·hs² floats (67 MB at (1, 2048, 32, 64), c 16), each thread the
// same entries it reads back later, so the block needs no fence; then it
// walks them in reverse with G in shared memory, six barriers a chunk:
// load the chunk (and its S0) → cumsums → exponentials (the pairwise
// E_ijd in full: c(c−1)/2·hs of them a chunk, each an accurate expf) → Q and
// A (eight lanes a dot product, joined by shuffles) → dr, dk, dv, a, b (a
// thread an element, row strides padded so a warp's lanes fall in
// distinct banks) → G's update and the serial D walk (a thread a column).
// Every sum runs in a fixed order with no atomics: the same bits on every
// run.
//
// Bound: the function reads r, k, v, w, do (5·B·S·H·hs floats) and u and
// writes dr, dk, dv, dw (4·B·S·H·hs) and du: 4·(9·B·S·H·hs + 2·H·hs) bytes,
// 151 MB and 0.045 ms at 3.35 TB/s for (1, 2048, 32, 64); its operations,
// twice the forward's (wkv_flops in chip_smoke.py), 2.8 GFLOP and 0.042 ms
// at 67 TFLOP/s.  What holds this simple design back is the serial walk of
// a block over S/c chunks with only B·H blocks (32 of the 132 SMs at the
// training shape), the scratch's round trip, and operands read from
// shared memory for every FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                    // lanes of a Q or A dot product

template <int HS, int C>
struct Layout {                              // shared memory, in floats
  static constexpr int PR = HS + 4;          // a chunk's rows: [C][PR]
  static constexpr int PS = HS + 1;          // S0 and G: [HS][PS], conflict-free by row
  static constexpr int PQ = C + 1;           // Q and A: [C][PQ]
  static constexpr int kRows = C * PR;
  static constexpr int kR = 0, kK = kR + kRows, kV = kK + kRows, kDo = kV + kRows;
  static constexpr int kCum = kDo + kRows, kRw = kCum + kRows, kKw = kRw + kRows;
  static constexpr int kA = kKw + kRows, kB = kA + kRows;
  static constexpr int kE = kB + kRows;      // [C][C][HS], entries j < i
  static constexpr int kQ = kE + C * C * HS, kAm = kQ + C * PQ;
  static constexpr int kS0 = kAm + C * PQ, kG = kS0 + HS * PS;
  static constexpr int kU = kG + HS * PS, kDec = kU + HS, kFloats = kDec + HS;
  static_assert(HS <= kThreads && kThreads % kGroup == 0, "a column a thread");
};

template <int HS, int C>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunk_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, const float* __restrict__ dout,
                       float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dw, float* __restrict__ du_part,
                       float* __restrict__ states, int64_t S, int64_t H) {
  using L = Layout<HS, C>;
  constexpr int PR = L::PR, PS = L::PS, PQ = L::PQ;
  constexpr int NS = (HS * HS + kThreads - 1) / kThreads;   // state entries a thread
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *R = sm + L::kR, *K = sm + L::kK, *V = sm + L::kV, *Do = sm + L::kDo;
  float *Cum = sm + L::kCum, *Rw = sm + L::kRw, *Kw = sm + L::kKw;
  float *Ab = sm + L::kA, *Bb = sm + L::kB, *E = sm + L::kE, *Q = sm + L::kQ;
  float *Am = sm + L::kAm, *S0 = sm + L::kS0, *G = sm + L::kG, *us = sm + L::kU;
  float* dec = sm + L::kDec;

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t row = H * HS;                            // floats from one token to the next
  const int64_t head = b * S * row + h * HS;
  const int64_t n_chunks = S / C;
  float* st = states + bh * n_chunks * HS * HS;          // this (b, h)'s chunk states

  // chunk x's rows of the given inputs into shared memory (dst[t][d])
  auto load = [&](int64_t x, const float* src, float* dst) {
    for (int e = tid; e < C * HS; e += kThreads) {
      const int t = e / HS, d = e % HS;
      dst[t * PR + d] = src[head + (x * C + t) * row + d];
    }
  };
  auto cumsum = [&]() {                                  // Cum holds w; in place, in order
    if (tid < HS) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        acc += Cum[t * PR + tid];
        Cum[t * PR + tid] = acc;
      }
    }
  };
  auto decays = [&]() {                                  // Kw = k ⊙ e^{cum_last − cum}, dec
    for (int e = tid; e < C * HS; e += kThreads) {
      const int t = e / HS, d = e % HS;
      Kw[t * PR + d] = K[t * PR + d] * expf(Cum[(C - 1) * PR + d] - Cum[t * PR + d]);
    }
    if (tid < HS) dec[tid] = expf(Cum[(C - 1) * PR + tid]);
  };

  // ---- forward walk: the state at each chunk's start, into the scratch
  float s[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) s[m] = 0.f;
  for (int64_t c = 0; c < n_chunks; ++c) {
    load(c, k, K);
    load(c, v, V);
    load(c, w, Cum);
    __syncthreads();
    cumsum();
    __syncthreads();
    decays();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int idx = tid + m * kThreads;
      if (idx < HS * HS) {
        const int d = idx / HS, e = idx % HS;
        st[c * HS * HS + idx] = s[m];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) acc += Kw[j * PR + d] * V[j * PR + e];
        s[m] = dec[d] * s[m] + acc;
      }
    }
    __syncthreads();
  }

  // ---- reverse walk
  for (int e = tid; e < HS * PS; e += kThreads) G[e] = 0.f;
  for (int e = tid; e < HS; e += kThreads) us[e] = u[h * HS + e];
  float carry = 0.f, du_acc = 0.f;                       // column tid's D and du
  for (int64_t c = n_chunks - 1; c >= 0; --c) {
    load(c, r, R);
    load(c, k, K);
    load(c, v, V);
    load(c, dout, Do);
    load(c, w, Cum);
#pragma unroll
    for (int m = 0; m < NS; ++m) {                       // the entries this thread wrote
      const int idx = tid + m * kThreads;
      if (idx < HS * HS) S0[(idx / HS) * PS + idx % HS] = st[c * HS * HS + idx];
    }
    __syncthreads();
    cumsum();
    __syncthreads();
    decays();
    for (int e = tid; e < C * HS; e += kThreads) {       // Rw = r ⊙ e^{cum_excl}
      const int t = e / HS, d = e % HS;
      Rw[t * PR + d] = t ? R[t * PR + d] * expf(Cum[(t - 1) * PR + d]) : R[d];
    }
    for (int e = tid; e < C * C * HS; e += kThreads) {   // E_ijd, j < i
      const int i = e / (C * HS), j = (e / HS) % C, d = e % HS;
      if (j < i)
        E[e] = expf(fminf(fmaxf(Cum[(i - 1) * PR + d] - Cum[j * PR + d], -60.f), 0.f));
    }
    __syncthreads();
    // Q_ij = do_i · v_j and A_ij (j ≤ i), a group of kGroup lanes each
    {
      const int g = tid / kGroup, l = tid % kGroup;
      for (int q = g; q < 2 * C * C; q += kThreads / kGroup) {   // uniform over the group
        const int which = q / (C * C), i = (q / C) % C, j = q % C;
        float acc = 0.f;
        if (j <= i) {
          if (which == 0) {
#pragma unroll
            for (int m = 0; m < HS / kGroup; ++m) {
              const int e = l + kGroup * m;
              acc += Do[i * PR + e] * V[j * PR + e];
            }
          } else if (j < i) {
            const float* Ep = E + (i * C + j) * HS;
#pragma unroll
            for (int m = 0; m < HS / kGroup; ++m) {
              const int d = l + kGroup * m;
              acc += R[i * PR + d] * K[j * PR + d] * Ep[d];
            }
          } else {
#pragma unroll
            for (int m = 0; m < HS / kGroup; ++m) {
              const int d = l + kGroup * m;
              acc += R[i * PR + d] * us[d] * K[i * PR + d];
            }
          }
        }
#pragma unroll
        for (int o = 1; o < kGroup; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (l == 0 && j <= i) (which == 0 ? Q : Am)[i * PQ + j] = acc;
      }
    }
    __syncthreads();
    // dr, dk, dv, a, b: thread an element (t, d)
    for (int o = tid; o < C * HS; o += kThreads) {
      const int t = o / HS, d = o % HS;
      const int64_t at = head + (c * C + t) * row + d;
      const float qtt = Q[t * PQ + t];
      float x = 0.f, y = 0.f;
#pragma unroll 8
      for (int e = 0; e < HS; ++e) x += S0[d * PS + e] * Do[t * PR + e];
      for (int j = 0; j < t; ++j) y += Q[t * PQ + j] * K[j * PR + d] * E[(t * C + j) * HS + d];
      const float drp = y + (t ? expf(Cum[(t - 1) * PR + d]) : 1.f) * x;
      dr[at] = drp + us[d] * K[t * PR + d] * qtt;
      Ab[t * PR + d] = R[t * PR + d] * drp;
      x = 0.f;
      y = 0.f;
#pragma unroll 8
      for (int e = 0; e < HS; ++e) x += G[d * PS + e] * V[t * PR + e];
      for (int i = t + 1; i < C; ++i) y += Q[i * PQ + t] * R[i * PR + d] * E[(i * C + t) * HS + d];
      const float dkp = y + expf(Cum[(C - 1) * PR + d] - Cum[t * PR + d]) * x;
      dk[at] = dkp + us[d] * R[t * PR + d] * qtt;
      Bb[t * PR + d] = K[t * PR + d] * dkp;
      x = 0.f;
      y = 0.f;
#pragma unroll 8
      for (int e = 0; e < HS; ++e) x += Kw[t * PR + e] * G[e * PS + d];
      for (int i = t; i < C; ++i) y += Am[i * PQ + t] * Do[i * PR + d];
      dv[at] = y + x;
    }
    if (tid < HS) {
#pragma unroll
      for (int t = 0; t < C; ++t) du_acc += R[t * PR + tid] * K[t * PR + tid] * Q[t * PQ + t];
    }
    __syncthreads();
    // G for the chunk before; the decays' gradient of this chunk's tokens
    for (int idx = tid; idx < HS * HS; idx += kThreads) {
      const int d = idx / HS, e = idx % HS;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) acc += Rw[i * PR + d] * Do[i * PR + e];
      G[d * PS + e] = dec[d] * G[d * PS + e] + acc;
    }
    if (tid < HS) {
      for (int t = C - 1; t >= 0; --t) {
        const float bt = Bb[t * PR + tid];
        dw[head + (c * C + t) * row + tid] = carry - bt;
        carry += Ab[t * PR + tid] - bt;
      }
    }
    __syncthreads();
  }
  if (tid < HS) du_part[bh * HS + tid] = du_acc;
}

template <int HS, int C>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, float* dr, float* dk, float* dv, float* dw, float* du_part,
           float* states, int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<HS, C>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_chunk_bwd_kernel<HS, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunk_bwd_kernel<HS, C><<<(unsigned)(B * H), kThreads, bytes, stream>>>(
      r, k, v, w, u, dout, dr, dk, dv, dw, du_part, states, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  The caller checks shapes:
// hs in {16, 32, 64}, chunk in {8, 16}, S % chunk == 0, S > 0,
// 0 < B·H < 2^31; states holds B·H·(S/chunk)·hs·hs floats, du_part B·H·hs.
int rwkv6_chunk_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* dout, float* dr, float* dk, float* dv,
                        float* dw, float* du_part, float* states, long long B, long long S,
                        long long H, int hs, int chunk, void* stream) {
  if (chunk <= 0 || S <= 0 || B * H <= 0 || S % chunk != 0 || B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RWKV6_BWD_CASE(HS_, C_)  \
  if (hs == HS_ && chunk == C_)  \
    return launch<HS_, C_>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, states, B, S, H, s);
  RWKV6_BWD_CASE(16, 8) RWKV6_BWD_CASE(16, 16) RWKV6_BWD_CASE(32, 8) RWKV6_BWD_CASE(32, 16)
  RWKV6_BWD_CASE(64, 8) RWKV6_BWD_CASE(64, 16)
#undef RWKV6_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* rwkv6_chunk_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
