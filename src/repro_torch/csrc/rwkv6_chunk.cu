// Chunked RWKV-6 WKV, written for Hopper (sm_90a).
//
// Inputs r, k, v, w (the log-decay, <= 0), row-major (B, S, H, hs) float32,
// and the bonus u, (H, hs) float32.  Output (B, S, H, hs) float32:
//
//   out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),   S_t = diag(e^{w_t}) S_{t-1} + k_tᵀ v_t
//
// with S_{-1} = 0 for every (b, h), in the chunked form of c tokens:
//   cum = cumsum(w) over the chunk, cum_excl = cum − w (the kernel takes the
//   cumsum up to the token before: the same sum, rounded once less);
//   A[i][j] = Σ_d r_id k_jd e^{cum_excl_id − cum_jd} for j < i,
//   A[i][i] = Σ_d r_id u_d k_id, zero above the diagonal;
//   out = A·v + (r ⊙ e^{cum_excl})·S;
//   S ← e^{cum_last} ⊙ S + (k ⊙ e^{cum_last − cum})ᵀ·v.
// Optionally the state after the last token, (B, H, hs, hs) float32 with
// S[b, h, key, value], is written too: the prefill's cache.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py
// (rwkv6_chunk), whose grid walks (B·H, S/c) in order on one core and
// carries the state in VMEM scratch from one grid step to the next.  On
// Hopper blocks run in parallel and in no order, so a block walks the
// chunks of one (b, h) in a loop, the state in its registers.
//
// Bound: bytes.  The function must read r, k, v, w (4·B·S·H·hs floats) and
// u, and write B·S·H·hs floats: 335.5 MB, 0.100 ms at 3.35 TB/s, for the
// prefill's (8, 1024, 32, 64).  Its operations (the pairwise decays, the
// three products and the elementwise work, counted by wkv_flops in
// chip_smoke.py: 5.5 GFLOP there) take 0.082 ms at the 67 TFLOP/s float32
// rate.  What holds it back is the serial walk over the S/c chunks: the
// first design (one block a (b, h), three barriers a chunk, the decays
// pairwise) took 0.38 ms there and 0.98 ms at (1, 4096, 32, 64), whose 32
// blocks left 100 of the 132 SMs idle (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (256 threads a block, hs = 16, 32 or 64, c = 8 or 16):
// - Factored decays.  The c(c−1)/2·hs pairwise exponentials of A are the
//   product of two that the chunk needs anyway, (r ⊙ e^{cum_excl}) ·
//   (k ⊙ e^{−cum})ᵀ: 2·c·hs exponentials and an FMA a term.  Each factor is
//   finite while the chunk's decay is at least −60 in every column
//   (e^{−cum} ≤ e^{60}); a chunk that decays more takes the pairwise form,
//   every exponent clipped to [−60, 0] as the reference does.  The state
//   update is then S ← e^{cum_last} ⊙ (S + (k ⊙ e^{−cum})ᵀ·v).  The factors
//   take expf, within 2 ulp at any argument: __expf's error grows with the
//   argument (2 + 1.17·|x| ulp), and the largest terms of A and of the
//   state are products e^{x}·e^{−x} = 1 with |x| up to 60.
// - A three-stage pipeline with one barrier a chunk.  Between two barriers
//   a block computes chunk c's output and state, A of chunk c + 1 (from the
//   factors made one chunk earlier), the exponentials of chunk c + 2 (and
//   its pairwise A where its decay is big), stages chunk c + 3's r, k and
//   cumsums (in the reference's order) and chunk c + 1's v into shared
//   memory, and loads chunk c + 4's columns into registers.  So the
//   exponentials (MUFU), the products (FMA) and the loads overlap.
// - The products run in 4 × 4 register tiles from shared memory, two
//   float4 loads for 16 FMAs, row strides padded so that the lanes of a
//   quarter warp fall in distinct banks; where there are fewer tiles than
//   threads, a tile's sum is split over a group of lanes and joined by a
//   reduce-scatter of shuffles, each lane keeping a part of the tile.
// - Sequence segments.  A batch of fewer than two (b, h) an SM leaves SMs
//   idle, so the wrapper cuts each sequence into segments: a first launch
//   walks every segment but the last for its state alone (from zero; no r,
//   no A, no output) and the product of its decays; the second walks every
//   segment, starting from the state that the earlier segments' states and
//   decays give it.  This re-reads k, w and v of all but the last segment
//   and moves (segments − 1)·(hs² + hs) floats a (b, h) through memory.
// Every sum runs in a fixed order with no atomics: the same result on
// every run.  It takes 0.314 ms at (8, 1024, 32, 64) in one walk, 3.1× its
// byte bound, and 0.232 ms at (1, 4096, 32, 64) in 8 segments (0.808 in one
// walk) (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBigDecay = -60.f;           // a chunk whose cum_last < this takes the pairwise A

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int HS, int C>
struct Layout {                              // shared memory, in floats
  static constexpr int PR = HS + 4;          // raw r, k, cum row stride
  static constexpr int P1 = C + 4;           // rwT, AT row stride
  static constexpr int PK = HS + 4;          // kinv (kw) row stride
  static constexpr int P2 = HS == 64 ? 72 : HS + 4;   // vs, st row stride
  static constexpr int NP = C * (C - 1) / 2; // strictly lower entries of A
  static constexpr int kRaw = 3 * C * PR;             // one {r, k, cum} buffer
  static constexpr int kExp = HS * P1 + C * PK + HS;  // one {rwT, kinv, dec} buffer
  static constexpr int kRaw0 = 0, kExp0 = 2 * kRaw, kAT0 = kExp0 + 3 * kExp;
  static constexpr int kVs0 = kAT0 + 3 * C * P1, kSt0 = kVs0 + 2 * C * P2;
  static constexpr int kUs = kSt0 + 2 * HS * P2, kFloats = kUs + HS;
  // products: out tiles (C/4 × HS/4), KS lanes each; state tiles (HS/4 × HS/4), SK lanes each
  static constexpr int TO = (C / 4) * (HS / 4), KS = cmin(16, kThreads / TO);
  static constexpr int TS = (HS / 4) * (HS / 4), SK = cmin(C, kThreads / TS);
  static constexpr int DT = 8;               // threads of a diagonal entry of A
  static_assert(2 * NP <= kThreads && C * DT <= kThreads && 4 * HS <= kThreads,
                "too few threads");
  static_assert(TO * KS % 32 == 0 && TS * SK % 32 == 0, "the product roles must fill warps");
  static_assert(KS >= 1 && KS <= 16 && SK <= 16 && (KS & (KS - 1)) == 0 && (SK & (SK - 1)) == 0,
                "lane groups");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[4i + j] += a_i · b_j
__device__ __forceinline__ void outer(float (&acc)[16], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
}

// Sum a 4 × 4 tile (v[4i + j]) over the L neighbouring lanes of a group and
// scatter it: lane l of the group ends with entries (l % L)·(16/L) ..
// + 16/L − 1 of the sum in v[0 .. 16/L), each a fixed sum order.  Each
// level halves the entries a lane holds (N of them before it), so every
// index is a constant and the tile stays in registers.
template <int L, int N = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int lane) {
  if constexpr (L > 1) {
    constexpr int n = N / 2, m = L / 2;
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    reduce_scatter<m, n>(v, lane);
  }
}

// Store the P = 16/L entries a lane holds after reduce_scatter<L>: entry
// idx = off + e of the tile goes to dst[(idx / 4)·stride + idx % 4].
template <int L>
__device__ __forceinline__ void store_part(float* dst, int64_t stride, const float (&v)[16],
                                           int lane) {
  constexpr int P = 16 / L, W = P < 4 ? P : 4;
  const int off = (lane % L) * P;
#pragma unroll
  for (int e = 0; e < P; e += W) {
    float* p = dst + ((off + e) / 4) * stride + (off + e) % 4;
    if (W == 4) *reinterpret_cast<float4*>(p) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    else if (W == 2) *reinterpret_cast<float2*>(p) = make_float2(v[e], v[e + 1]);
    else *p = v[e];
  }
}

template <int HS, int C>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ out,
                   float* __restrict__ state, float* __restrict__ U, float* __restrict__ D,
                   int64_t S, int64_t H, int64_t seg, int nseg, int pm1, int state_only) {
  using L = Layout<HS, C>;
  constexpr int PR = L::PR, P1 = L::P1, PK = L::PK, P2 = L::P2, NP = L::NP;
  constexpr int KS = L::KS, SK = L::SK, VT = HS / 4, DT = L::DT, PS = 16 / SK;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* us = sm + L::kUs;                               // [HS]

  const int tid = threadIdx.x;
  const bool full = !state_only;
  const int64_t sp = blockIdx.x % nseg, bh = blockIdx.x / nseg, b = bh / H, h = bh % H;
  const int64_t row = H * HS;                            // floats from one token to the next
  const int64_t head = b * S * row + h * HS;
  const int64_t n_chunks = S / C;
  const int64_t c0 = sp * seg, c1 = c0 + seg < n_chunks ? c0 + seg : n_chunks;   // the segment

  // Buffers, by chunk x: raw(x) {r, k, cum} [C][PR] ×2, staged three chunks
  // ahead; exp(x) {rwT [HS][P1] r ⊙ e^{cum_excl} transposed, kinv [C][PK]
  // k ⊙ e^{−cum} (k ⊙ e^{cum_last − cum} where the chunk's decay is big),
  // dec [HS] e^{cum_last}} ×3, two chunks ahead; AT(x) [C][P1] (A
  // transposed) ×3; vs(x) [C][P2] ×2, one ahead; st [HS][P2] ×2.
  auto raw = [&](int64_t x) { return sm + L::kRaw0 + (x & 1) * L::kRaw; };
  auto rwT = [&](int64_t x) { return sm + L::kExp0 + (int)(x % 3) * L::kExp; };
  auto kinv = [&](int64_t x) { return rwT(x) + HS * P1; };
  auto dec = [&](int64_t x) { return kinv(x) + C * PK; };
  auto AT = [&](int64_t x) { return sm + L::kAT0 + (int)(x % 3) * C * P1; };
  auto vs = [&](int64_t x) { return sm + L::kVs0 + (x & 1) * C * P2; };
  auto st = [&](int64_t x) { return sm + L::kSt0 + (x & 1) * HS * P2; };

  // loading: thread ld of r, k, w or v (which 0..3); the state-only pass reads no r
  const int which = tid / HS, ld = tid % HS;
  const bool rkw = which < 3 && (full || which > 0), vload = which == 3;
  const float* src = (which == 0 ? r : which == 1 ? k : which == 2 ? w : v) + head + ld;
  float buf[C];
  // A: an entry below the diagonal (two threads), an entry on it (DT threads)
  const bool pair = tid < 2 * NP, diag = tid < C * DT;
  const int half = tid & 1, di = tid / DT, dp = tid % DT;
  int pi = 1, pj = tid >> 1;                             // entry tid >> 1 below the diagonal
  while (pj >= pi) { pj -= pi; ++pi; }
  // products: an out tile (ti, tj) and lane ks of KS; a state tile (tq, tc) and lane sk of SK
  const bool outs = full && tid < L::TO * KS;
  const int ks = tid % KS, ti = (tid / KS) / VT, tj = (tid / KS) % VT;
  const bool sts = tid < L::TS * SK;
  const int sk = tid % SK, tq = (tid / SK) / VT, tc = (tid / SK) % VT;
  float s[PS];                                           // entries (sk·PS ..) of the state tile
#pragma unroll
  for (int e = 0; e < PS; ++e) s[e] = 0.f;
  // where the state tile's entry e lies: key row 4tq + (sk·PS + e)/4, value column 4tc + ..
  auto key = [&](int e) { return 4 * tq + (sk * PS + e) / 4; };
  auto col = [&](int e) { return 4 * tc + (sk * PS + e) % 4; };

  auto load = [&](int64_t x) {                           // chunk x's column, into registers
    const float* p = src + x * C * row;
#pragma unroll
    for (int t = 0; t < C; ++t) buf[t] = p[t * row];
  };
  auto stage = [&](int64_t x) {                          // ... into raw(x) (r, k, w threads):
    float* dst = raw(x) + which * C * PR + ld;           // the cumsum in the reference's order
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      acc += buf[t];
      dst[t * PR] = which == 2 ? acc : buf[t];
    }
    return acc;                                          // w threads: cum_last of the column
  };
  auto stage_v = [&](int64_t x) {
#pragma unroll
    for (int t = 0; t < C; ++t) vs(x)[t * P2 + ld] = buf[t];
  };
  // exp(x) and A(x)'s diagonal from raw(x); where the decay is big, A(x)'s
  // strictly lower part too, pairwise (every exponent clipped to [−60, 0]);
  // the state-only pass takes kinv and dec alone
  auto exps = [&](int64_t x, bool big) {
    const float* rr = raw(x);
    const float* kk = rr + C * PR;
    const float* cm = kk + C * PR;                       // cum; cum_excl of token i is cum[i − 1]
    float* rw = rwT(x);
    float* ki = kinv(x);
    constexpr int per = (C * HS + kThreads - 1) / kThreads;   // elements a thread, unrolled
    if (full) {
#pragma unroll
      for (int m = 0; m < per; ++m) {
        const int e = tid + m * kThreads;
        if (e < C * HS) {
          const int i = e % C, q = e / C;
          rw[q * P1 + i] = i ? rr[i * PR + q] * expf(cm[(i - 1) * PR + q]) : rr[q];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < per; ++m) {
      const int e = tid + m * kThreads;
      if (e < C * HS) {
        const int j = e / HS, q = e % HS;
        const float c = cm[j * PR + q];
        ki[j * PK + q] = kk[j * PR + q] * expf(big ? cm[(C - 1) * PR + q] - c : -c);
      }
    }
    for (int q = tid; q < HS; q += kThreads) dec(x)[q] = expf(cm[(C - 1) * PR + q]);
    if (!full) return;
    float a = 0.f;
    if (diag) {
#pragma unroll
      for (int m = 0; m < HS / DT; ++m) {
        const int d = dp + DT * m;
        a += rr[di * PR + d] * us[d] * kk[di * PR + d];
      }
    }
#pragma unroll
    for (int m = 1; m < DT; m <<= 1) a += __shfl_xor_sync(0xffffffffu, a, m);
    if (diag && dp == 0) AT(x)[di * P1 + di] = a;
    if (big) {
      float p = 0.f;
      if (pair) {
#pragma unroll 8
        for (int m = 0; m < HS / 2; ++m) {
          const int d = 2 * m + half;
          p += rr[pi * PR + d] * kk[pj * PR + d]
               * __expf(fminf(fmaxf(cm[(pi - 1) * PR + d] - cm[pj * PR + d], -60.f), 0.f));
        }
      }
      const float other = __shfl_xor_sync(0xffffffffu, p, 1);
      if (pair && half == 0) AT(x)[pj * P1 + pi] = p + other;
    }
  };
  // A(x)'s strictly lower part from exp(x), where the decay is not big:
  // A[i][j] = Σ_d (r_id e^{cum_excl_id}) (k_jd e^{−cum_jd}), each factor finite
  auto factored = [&](int64_t x) {
    const float* rw = rwT(x);
    const float* ki = kinv(x);
    float p = 0.f;
    if (pair) {
#pragma unroll
      for (int m = 0; m < HS / 2; ++m) {
        const int d = 2 * m + half;
        p += rw[d * P1 + pi] * ki[pj * PK + d];
      }
    }
    const float other = __shfl_xor_sync(0xffffffffu, p, 1);
    if (pair && half == 0) AT(x)[pj * P1 + pi] = p + other;
  };
  // any column's cum_last below kBigDecay, over the w threads, with a barrier
  auto big_decay = [&](bool mine) { return __syncthreads_or(mine) != 0; };

  // The state at the segment's start: S ← D_p ⊙ S + U_p over the segments
  // before it (the state-only pass gave each its decay and its state from zero).
  for (int64_t p = 0; full && p < sp; ++p) {
    const int64_t at = bh * pm1 + p;
#pragma unroll
    for (int e = 0; e < PS; ++e)
      if (sts) s[e] = D[at * HS + key(e)] * s[e] + U[(at * HS + key(e)) * HS + col(e)];
  }
  if (sts) {
    float part[16];
#pragma unroll
    for (int e = 0; e < PS; ++e) part[e] = s[e];
    store_part<SK>(st(c0) + 4 * tq * P2 + 4 * tc, P2, part, sk);
  }
  for (int e = tid; e < 3 * C * P1; e += kThreads) sm[L::kAT0 + e] = 0.f;   // A's upper part
  for (int e = tid; e < HS; e += kThreads) us[e] = u[h * HS + e];
  float cl = 0.f, total = 0.f;                           // w threads: Σ cum_last of the segment
  bool big0 = false, big1 = false, big2 = false;
  if (rkw) {
    load(c0);
    cl = stage(c0);
    total += cl;
  }
  big0 = big_decay(which == 2 && cl < kBigDecay);
  if (c0 + 1 < c1) {
    if (rkw) {
      load(c0 + 1);
      cl = stage(c0 + 1);
      total += cl;
    }
    big1 = big_decay(which == 2 && cl < kBigDecay);
  }
  if (vload) {
    load(c0);
    stage_v(c0);
    if (c0 + 1 < c1) load(c0 + 1);
  }
  exps(c0, big0);
  if (c0 + 1 < c1) exps(c0 + 1, big1);
  __syncthreads();
  if (full && !big0) factored(c0);
  if (rkw && c0 + 2 < c1) {
    load(c0 + 2);
    cl = stage(c0 + 2);
    total += cl;
    if (c0 + 3 < c1) load(c0 + 3);
  }
  if (c0 + 2 < c1) big2 = big_decay(which == 2 && cl < kBigDecay);
  else __syncthreads();

  for (int64_t c = c0; c < c1; ++c) {
    const float* ATc = AT(c);
    const float* rwc = rwT(c);
    const float* kic = kinv(c);
    const float* dcc = dec(c);
    const float* vsc = vs(c);
    const float* stc = st(c);
    // chunk c's output tiles: A·v over j ≤ 4ti + 3, then (r ⊙ e^{cum_excl})·S over the rows
    if (outs) {
      float acc[16] = {};
#pragma unroll
      for (int m = 0; m < (C + KS - 1) / KS; ++m) {
        const int j = ks + KS * m;
        if (j < 4 * ti + 4) outer(acc, ld4(ATc + j * P1 + 4 * ti), ld4(vsc + j * P2 + 4 * tj));
      }
#pragma unroll
      for (int m = 0; m < HS / KS; ++m) {
        const int q = ks + KS * m;
        outer(acc, ld4(rwc + q * P1 + 4 * ti), ld4(stc + q * P2 + 4 * tj));
      }
      reduce_scatter<KS>(acc, ks);
      store_part<KS>(out + head + (c * C + 4 * ti) * row + 4 * tj, row, acc, ks);
    }
    // the state tiles: S ← e^{cum_last} ⊙ S + kwᵀ·v (kw = e^{cum_last} ⊙ kinv where the
    // decay is not big), into the next chunk's state buffer
    if (sts) {
      float add[16] = {};
#pragma unroll
      for (int m = 0; m < C / SK; ++m) {
        const int j = sk + SK * m;
        outer(add, ld4(kic + j * PK + 4 * tq), ld4(vsc + j * P2 + 4 * tc));
      }
      reduce_scatter<SK>(add, sk);
#pragma unroll
      for (int e = 0; e < PS; ++e) {
        const float d = dcc[key(e)];
        s[e] = big0 ? d * s[e] + add[e] : d * (s[e] + add[e]);
      }
      if (full && c + 1 < c1) {
        float part[16];
#pragma unroll
        for (int e = 0; e < PS; ++e) part[e] = s[e];
        store_part<SK>(st(c + 1) + 4 * tq * P2 + 4 * tc, P2, part, sk);
      }
    }
    if (full && c + 1 < c1 && !big1) factored(c + 1);
    if (c + 2 < c1) exps(c + 2, big2);
    cl = 0.f;
    if (rkw && c + 3 < c1) {
      cl = stage(c + 3);
      total += cl;
      if (c + 4 < c1) load(c + 4);
    }
    if (vload && c + 1 < c1) {
      stage_v(c + 1);
      if (c + 2 < c1) load(c + 2);
    }
    const bool big3 = big_decay(which == 2 && c + 3 < c1 && cl < kBigDecay);
    big0 = big1;
    big1 = big2;
    big2 = big3;
  }

  if (!full) {                                           // the segment's state and decay
    const int64_t at = bh * pm1 + sp;
    if (sts) {
      float part[16];
#pragma unroll
      for (int e = 0; e < PS; ++e) part[e] = s[e];
      store_part<SK>(U + at * HS * HS + 4 * tq * HS + 4 * tc, HS, part, sk);
    }
    if (which == 2) D[at * HS + ld] = __expf(total);
  } else if (state && sp == nseg - 1 && sts) {           // the state after the last token
    float part[16];
#pragma unroll
    for (int e = 0; e < PS; ++e) part[e] = s[e];
    store_part<SK>(state + bh * HS * HS + 4 * tq * HS + 4 * tc, HS, part, sk);
  }
}

template <int HS, int C>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, float* state, float* U, float* D, int64_t B, int64_t S, int64_t H,
           int segments, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<HS, C>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_chunk_kernel<HS, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_chunks = S / C, seg = (n_chunks + segments - 1) / segments;
  const int pm1 = segments - 1;
  if (pm1) {                                    // the state-only pass over all but the last
    rwkv6_chunk_kernel<HS, C><<<(unsigned)(B * H * pm1), kThreads, bytes, stream>>>(
        r, k, v, w, u, out, state, U, D, S, H, seg, pm1, pm1, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rwkv6_chunk_kernel<HS, C><<<(unsigned)(B * H * segments), kThreads, bytes, stream>>>(
      r, k, v, w, u, out, state, U, D, S, H, seg, segments, pm1, 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of a launch.  The caller checks shapes:
// hs in {16, 32, 64}, chunk in {8, 16}, S % chunk == 0, S > 0,
// 1 <= segments with every segment of ⌈S/chunk/segments⌉ chunks non-empty,
// B·H·segments < 2^31; state is null or holds B·H·hs·hs floats; with
// segments > 1, U holds B·H·(segments − 1)·hs·hs floats and D
// B·H·(segments − 1)·hs.
int rwkv6_chunk_f32(const float* r, const float* k, const float* v, const float* w,
                    const float* u, float* out, float* state, float* U, float* D, long long B,
                    long long S, long long H, int hs, int chunk, int segments, void* stream) {
  if (chunk <= 0 || S <= 0 || B * H <= 0 || S % chunk != 0 || segments < 1
      || B * H * segments > 0x7fffffffLL || (segments > 1 && (!U || !D)))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = S / chunk, seg = (n_chunks + segments - 1) / segments;
  if ((segments - 1) * seg >= n_chunks) return (int)cudaErrorInvalidValue;   // an empty segment
  cudaStream_t s = (cudaStream_t)stream;
#define RWKV6_CASE(HS_, C_)   \
  if (hs == HS_ && chunk == C_) \
    return launch<HS_, C_>(r, k, v, w, u, out, state, U, D, B, S, H, segments, s);
  RWKV6_CASE(16, 8) RWKV6_CASE(16, 16) RWKV6_CASE(32, 8) RWKV6_CASE(32, 16)
  RWKV6_CASE(64, 8) RWKV6_CASE(64, 16)
#undef RWKV6_CASE
  return (int)cudaErrorInvalidValue;
}

const char* rwkv6_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
