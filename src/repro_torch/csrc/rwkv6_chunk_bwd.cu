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
// Bound: bytes.  The function reads r, k, v, w, do (5·B·S·H·hs floats) and u
// and writes dr, dk, dv, dw (4·B·S·H·hs) and du: 4·(9·B·S·H·hs + 2·H·hs)
// bytes, 151 MB and 0.045 ms at 3.35 TB/s for (1, 2048, 32, 64); its
// operations, twice the forward's (wkv_flops in chip_smoke.py), 2.8 GFLOP
// and 0.041 ms at 67 TFLOP/s.  The first design (one block of 256 threads
// a (b, h), every pairwise decay an expf kept in a 64 KB shared array, a
// thread an output element with both operands of every FMA read from
// shared memory) took 3.74 ms there, 83× the bound: its B·H = 32 blocks
// left 100 of the 132 SMs idle, and the array held it to one block an SM
// (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 1).
//
// Design (256 threads a CTA; hs = 16, 32 or 64, c = 8 or 16):
// - A cluster of NS CTAs a (b, h) (NS = 4, or 2 at hs = 16: split_for),
//   CTA g owning value columns [g·hs/NS, (g+1)·hs/NS) of the state S0 and of
//   G, which evolve column by column: the state rebuild, G's update and dv
//   need no other column.  The two sums over value columns, S0·do_i (dr's
//   state term) and G·v_j (dk's), each CTA computes for its columns into its
//   shared memory; CTA g then reads the NS partials of its key columns
//   [g·hs/NS, ..) through distributed shared memory, summed in rank order,
//   and finishes dr, dk, dw and du for those columns.  So B·H·NS CTAs walk
//   in parallel (128 at the training shape, against 32).  The partials are
//   double-buffered and the cluster's barrier is split around a stage: a
//   CTA arrives once its partials are written and waits only before it
//   reads the others'.
// - Factored decays, as the forward has them: E_ijd = e^{cum_excl_id} ·
//   e^{−cum_jd}, so with Rw = r ⊙ e^{cum_excl} and Ki = k ⊙ e^{−cum}
//     A_ij = Rw_i · Ki_j (j < i),  dr_intra = e^{cum_excl} ⊙ (Q_lower·Ki),
//     dk_intra = e^{−cum} ⊙ (Q_lowerᵀ·Rw),
//   small products with 3·c·hs exponentials a chunk in place of c(c−1)/2·hs
//   pairwise ones, and no [c][c][hs] array.  Each factor is finite while
//   every column of the chunk decays by at least −60 (then the clip is
//   inactive); a chunk that decays more takes the pairwise form, every
//   exponent clipped to [−60, 0], as the forward switches.  The factors take
//   expf, not __expf: the largest terms are products e^{x}·e^{−x} with |x|
//   up to 60 (the forward's header).
// - Every product runs in 4 × 4 register tiles from padded shared rows, a
//   4-deep slice of the sum at a time: eight float4 loads for 64 FMAs, in
//   either layout of each operand, so no operand is transposed; a tile's sum
//   is split over a group of lanes and joined by a reduce-scatter of
//   shuffles.  Four barriers a chunk in reverse, three in the rebuild; the
//   next chunk's rows load into registers while the current one is worked
//   on.
// - The rebuild walks the chunks forward once and writes each chunk's
//   starting state (this CTA's columns) into a scratch of B·H·(S/c)·hs²
//   floats; each thread reads back in reverse exactly the entries it wrote.
// Every sum runs in a fixed order with no atomics: the same bits on every
// run.  It takes 1.34 ms at (1, 2048, 32, 64), 29.7× its bound, with 76 KB
// of shared memory a CTA and two CTAs an SM (NVIDIA H100 80GB HBM3,
// 700.00 W, chip_smoke.py phase 1).  Two CTAs an SM is what lets the 32
// clusters of the training shape start at once: at one CTA an SM the card
// cannot place all of them, and the launch takes two waves.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kBigDecay = -60.f;           // a chunk whose cum_last < this takes the pairwise form

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int pow2ceil(int x) { return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2); }

template <int HS, int C, int NS>
struct Layout {                              // shared memory, in floats
  static constexpr int NC = HS / NS;         // a CTA's value columns, and its key columns
  static constexpr int PR = HS + 4;          // a chunk's rows: [C][PR]
  static constexpr int PQ = C + 4;           // Q (lower, diagonal zeroed) and A: [C][PQ]
  static constexpr int PN = NC + 4;          // S0, G: [HS][PN]; X, Y, a, b: [C][PN]
  static constexpr int kRows = C * PR;
  static constexpr int kR = 0, kK = kR + kRows, kCum = kK + kRows, kV = kCum + kRows;
  static constexpr int kDo = kV + kRows, kRw = kDo + kRows, kKi = kRw + kRows;
  static constexpr int kKw = kKi + kRows;
  static constexpr int kPart = kKw + kRows;  // {S0·do, G·v} partials, two buffers
  static constexpr int kQ = kPart + 4 * kRows, kA = kQ + C * PQ;
  static constexpr int kS0 = kA + C * PQ, kG = kS0 + HS * PN;     // G: two buffers
  static constexpr int kX = kG + 2 * HS * PN, kY = kX + C * PN, kAb = kY + C * PN;
  static constexpr int kBb = kAb + C * PN, kQd = kBb + C * PN, kDec = kQd + C;
  static constexpr int kU = kDec + HS, kFloats = kU + HS;
  static constexpr int NF = (C * HS + kThreads - 1) / kThreads;   // float4 of r, k, v, do a thread
  static_assert(HS % NS == 0 && NC % 4 == 0 && C % 4 == 0, "4 × 4 tiles");
  static_assert(C * NC <= kThreads && C * 8 <= kThreads && C * (C - 1) <= kThreads
                && HS <= kThreads, "too few threads");
};

// The tiles of an (4·TA) × (4·TB) product summed over KB slices of 4:
// L lanes a tile, each keeping NE entries of the sum after reduce_scatter.
template <int TA, int TB, int KB>
struct Tiles {
  static constexpr int L = cmin(16, cmin(kThreads / (TA * TB), pow2ceil(KB)));
  static constexpr int USED = TA * TB * L;                 // threads with a tile
  static constexpr int WARPS = (USED + 31) / 32 * 32;     // ... and the rest of their warps
  static constexpr int NE = 16 / L;
  static constexpr int STEPS = (KB + L - 1) / L;
  static_assert(USED <= kThreads && (L & (L - 1)) == 0, "lane groups");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[4a + b] += Σ_{q<4} x(a0 + a, m0 + q) · y(m0 + q, b0 + b), where
// x(a, m) = XK ? X[a·px + m] : X[m·px + a] and y(m, b) = YK ? Y[b·py + m]
// : Y[m·py + b]: eight float4 loads, 64 FMAs, in q's order.
template <bool XK, bool YK>
__device__ __forceinline__ void mac4(float (&acc)[16], const float* X, int px, const float* Y,
                                     int py, int a0, int b0, int m0) {
  float x[4][4], y[4][4];                    // x[a][q], y[q][b]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = XK ? ld4(X + (a0 + i) * px + m0) : ld4(X + (m0 + i) * px + a0);
    const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (XK) x[i][j] = tv[j];
      else x[j][i] = tv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = YK ? ld4(Y + (b0 + i) * py + m0) : ld4(Y + (m0 + i) * py + b0);
    const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (YK) y[j][i] = tv[j];
      else y[i][j] = tv[j];
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[4 * a + b] += x[a][q] * y[q][b];
}

// Sum a 4 × 4 tile (v[4i + j]) over the L neighbouring lanes of a group and
// scatter it: lane l of the group ends with entries (l % L)·(16/L) ..
// + 16/L − 1 of the sum in v[0 .. 16/L), each a fixed sum order.
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

// Store (load) the 16/L entries a lane holds after reduce_scatter<L>: entry
// idx = off + e of the tile is at p[(idx / 4)·stride + idx % 4].
template <int L>
__device__ __forceinline__ void store_part(float* p, int64_t stride, const float (&v)[16],
                                           int lane) {
  constexpr int P = 16 / L, W = P < 4 ? P : 4;
  const int off = (lane % L) * P;
#pragma unroll
  for (int e = 0; e < P; e += W) {
    float* q = p + ((off + e) / 4) * stride + (off + e) % 4;
    if (W == 4) *reinterpret_cast<float4*>(q) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    else if (W == 2) *reinterpret_cast<float2*>(q) = make_float2(v[e], v[e + 1]);
    else *q = v[e];
  }
}

template <int L>
__device__ __forceinline__ void load_part(const float* p, int64_t stride, float (&v)[16],
                                          int lane) {
  constexpr int P = 16 / L;
  const int off = (lane % L) * P;
#pragma unroll
  for (int e = 0; e < P; ++e) v[e] = p[((off + e) / 4) * stride + (off + e) % 4];
}

// The cluster's barrier in two halves: a thread arrives once its partials
// are written (release) and waits before it reads another CTA's (acquire),
// with a stage of work between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int HS, int C, int NS>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_chunk_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, const float* __restrict__ dout,
                       float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dw, float* __restrict__ du_part,
                       float* __restrict__ states, int64_t S, int64_t H) {
  using L = Layout<HS, C, NS>;
  constexpr int NC = L::NC, PR = L::PR, PQ = L::PQ, PN = L::PN, kRows = L::kRows;
  constexpr int CT = C / 4, HT = HS / 4, NT = NC / 4, N4 = C * HS / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *R = sm + L::kR, *K = sm + L::kK, *Cum = sm + L::kCum, *V = sm + L::kV;
  float *Do = sm + L::kDo, *Rw = sm + L::kRw, *Ki = sm + L::kKi, *Kw = sm + L::kKw;
  float *Q = sm + L::kQ, *A = sm + L::kA, *S0 = sm + L::kS0, *Xs = sm + L::kX;
  float *Ys = sm + L::kY, *Ab = sm + L::kAb, *Bb = sm + L::kBb, *qd = sm + L::kQd;
  float *dec = sm + L::kDec, *us = sm + L::kU;

  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x / NS, b = bh / H, h = bh % H;
  const int64_t row = H * HS;                            // floats from one token to the next
  const int64_t head = b * S * row + h * HS;
  const int64_t n_chunks = S / C;
  const int gc = g * NC;                                 // this CTA's first column
  float* st = states + (bh * NS + g) * n_chunks * (HS * NC);   // its chunk states, [HS][NC] each

  // ---- a chunk's rows: r, k, v, do as float4 (thread tid the float4s tid +
  // kThreads·m of the arrays first .. first + na − 1), w as a column a thread
  float4 pf[L::NF];
  float pw[C];
  auto fetch = [&](int64_t x, int first, int na) {
#pragma unroll
    for (int m = 0; m < L::NF; ++m) {
      const int f = tid + kThreads * m;
      if (f < na * N4) {
        const int a = first + f / N4, t = (f % N4) / HT, q = f % HT;
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : dout;
        pf[m] = ld4(src + head + (x * C + t) * row + 4 * q);
      }
    }
    if (tid < HS) {
#pragma unroll
      for (int t = 0; t < C; ++t) pw[t] = w[head + (x * C + t) * row + tid];
    }
  };
  // ... into shared memory; the w threads take the cumsum in the reference's
  // order and return cum_last
  auto stage = [&](int first, int na) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < L::NF; ++m) {
      const int f = tid + kThreads * m;
      if (f < na * N4) {
        const int a = first + f / N4, t = (f % N4) / HT, q = f % HT;
        float* dst = a == 0 ? R : a == 1 ? K : a == 2 ? V : Do;
        *reinterpret_cast<float4*>(dst + t * PR + 4 * q) = pf[m];
      }
    }
    if (tid < HS) {
#pragma unroll
      for (int t = 0; t < C; ++t) {
        acc += pw[t];
        Cum[t * PR + tid] = acc;
      }
    }
    return acc;
  };

  // ---- the state tiles: key rows × this CTA's value columns, summed over
  // the chunk's tokens (the rebuild); thread tid keeps the entries of lane
  // sl of tile (sq, sc), in the rebuild and again, read back, in reverse
  using TS = Tiles<HT, NT, CT>;
  const bool s_on = tid < TS::USED;
  const int sl = tid % TS::L, sq = (tid / TS::L) / NT, sc = (tid / TS::L) % NT;
  const int s_off = 4 * sq * NC + 4 * sc;                // the tile's corner in a [HS][NC] state
  auto s_key = [&](int e) { return 4 * sq + (sl * TS::NE + e) / 4; };
  auto s_col = [&](int e) { return 4 * sc + (sl * TS::NE + e) % 4; };
  float s[16];

  // ---- forward walk: the state at each chunk's start, into the scratch
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = 0.f;
  fetch(0, 1, 2);
  for (int64_t c = 0; c < n_chunks; ++c) {
    stage(1, 2);
    if (c + 1 < n_chunks) fetch(c + 1, 1, 2);
    if (s_on) store_part<TS::L>(st + c * HS * NC + s_off, NC, s, sl);
    __syncthreads();
    for (int e = tid; e < C * HS; e += kThreads) {       // Kw = k ⊙ e^{cum_last − cum}
      const int t = e / HS, d = e % HS;
      Kw[t * PR + d] = K[t * PR + d] * expf(Cum[(C - 1) * PR + d] - Cum[t * PR + d]);
    }
    if (tid < HS) dec[tid] = expf(Cum[(C - 1) * PR + tid]);
    __syncthreads();
    if (tid < TS::WARPS) {                               // S ← e^{cum_last} ⊙ S + Kwᵀ·v
      float acc[16] = {};
      if (s_on) {
#pragma unroll
        for (int q = 0; q < TS::STEPS; ++q) {
          const int mb = sl + TS::L * q;
          if (mb < CT) mac4<false, false>(acc, Kw, PR, V + gc, PR, 4 * sq, 4 * sc, 4 * mb);
        }
      }
      reduce_scatter<TS::L>(acc, sl);
      if (s_on) {
#pragma unroll
        for (int e = 0; e < TS::NE; ++e) s[e] = dec[s_key(e)] * s[e] + acc[e];
      }
    }
    __syncthreads();
  }

  // ---- reverse walk
  for (int e = tid; e < 2 * HS * PN; e += kThreads) sm[L::kG + e] = 0.f;
  for (int e = tid; e < 2 * C * PQ; e += kThreads) Q[e] = 0.f;   // Q and A: their upper parts
  for (int e = tid; e < HS; e += kThreads) us[e] = u[h * HS + e];
  float carry = 0.f, du_acc = 0.f;                       // key column gc + tid's D and du
  // the decays' gradient of chunk x's tokens, from its a and b: a thread a key column
  auto dwalk = [&](int64_t x) {
    if (tid < NC) {
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        const float bt = Bb[t * PN + tid];
        dw[head + (x * C + t) * row + gc + tid] = carry - bt;
        carry += Ab[t * PN + tid] - bt;
      }
    }
  };
  fetch(n_chunks - 1, 0, 4);
  if (s_on) load_part<TS::L>(st + (n_chunks - 1) * HS * NC + s_off, NC, s, sl);
  int cb = 0;                                            // G's buffer for this chunk
  for (int64_t c = n_chunks - 1; c >= 0; --c) {
    const float cl = stage(0, 4);
    if (s_on) {
#pragma unroll
      for (int e = 0; e < TS::NE; ++e) S0[s_key(e) * PN + s_col(e)] = s[e];
    }
    if (c + 1 < n_chunks) dwalk(c + 1);
    if (c > 0) {
      fetch(c - 1, 0, 4);
      if (s_on) load_part<TS::L>(st + (c - 1) * HS * NC + s_off, NC, s, sl);
    }
    const bool big = __syncthreads_or(tid < HS && cl < kBigDecay) != 0;
    float* Pr = sm + L::kPart + (int)(c & 1) * 2 * kRows;     // S0·do partial; G·v at + kRows
    float* Pk = Pr + kRows;
    const float* Gc = sm + L::kG + cb * HS * PN;         // G after this chunk
    float* Gn = sm + L::kG + (cb ^ 1) * HS * PN;         // ... and after the chunk before

    // (1) the factors; A's diagonal; Q; this CTA's partials of S0·do and G·v
    for (int e = tid; e < C * HS; e += kThreads) {
      const int t = e / HS, d = e % HS;
      const float cm = Cum[t * PR + d], kt = K[t * PR + d];
      Rw[t * PR + d] = t ? R[t * PR + d] * expf(Cum[(t - 1) * PR + d]) : R[d];
      Kw[t * PR + d] = kt * expf(Cum[(C - 1) * PR + d] - cm);
      if (!big) Ki[t * PR + d] = kt * expf(-cm);
    }
    if (tid < HS) dec[tid] = expf(Cum[(C - 1) * PR + tid]);
    {                                                    // A_ii = Σ_d r_id u_d k_id, 8 lanes a row
      const int i = tid / 8, p = tid % 8;
      float a = 0.f;
      if (i < C) {
#pragma unroll
        for (int m = 0; m < HS / 8; ++m) {
          const int d = p + 8 * m;
          a += R[i * PR + d] * us[d] * K[i * PR + d];
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (i < C && p == 0) A[i * PQ + i] = a;
    }
    {                                                    // Q_ij = do_i · v_j, i ≥ j
      using T = Tiles<CT, CT, HT>;
      if (tid < T::WARPS) {
        const int l = tid % T::L, ta = (tid / T::L) / CT, tb = (tid / T::L) % CT;
        const bool live = tid < T::USED && ta >= tb;
        float acc[16] = {};
        if (live) {
#pragma unroll
          for (int q = 0; q < T::STEPS; ++q) {
            const int mb = l + T::L * q;
            if (mb < HT) mac4<true, true>(acc, Do, PR, V, PR, 4 * ta, 4 * tb, 4 * mb);
          }
        }
        reduce_scatter<T::L>(acc, l);
        if (live) {
#pragma unroll
          for (int e = 0; e < T::NE; ++e) {
            const int idx = l * T::NE + e, i = 4 * ta + idx / 4, j = 4 * tb + idx % 4;
            Q[i * PQ + j] = j < i ? acc[e] : 0.f;        // Q_lower: the diagonal apart
            if (i == j) qd[i] = acc[e];
          }
        }
      }
    }
    {                                                    // the partials over this CTA's columns
      using T = Tiles<CT, HT, NT>;
      if (tid < T::WARPS) {
        const bool on = tid < T::USED;
        const int l = tid % T::L, ta = (tid / T::L) / HT, tb = (tid / T::L) % HT;
        float acc[16] = {};
        if (on) {
#pragma unroll
          for (int q = 0; q < T::STEPS; ++q) {
            const int mb = l + T::L * q;
            if (mb < NT) mac4<true, true>(acc, Do + gc, PR, S0, PN, 4 * ta, 4 * tb, 4 * mb);
          }
        }
        reduce_scatter<T::L>(acc, l);
        if (on) store_part<T::L>(Pr + 4 * ta * PR + 4 * tb, PR, acc, l);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.f;
        if (on) {
#pragma unroll
          for (int q = 0; q < T::STEPS; ++q) {
            const int mb = l + T::L * q;
            if (mb < NT) mac4<true, true>(acc, V + gc, PR, Gc, PN, 4 * ta, 4 * tb, 4 * mb);
          }
        }
        reduce_scatter<T::L>(acc, l);
        if (on) store_part<T::L>(Pk + 4 * ta * PR + 4 * tb, PR, acc, l);
      }
    }
    cluster_arrive();                                    // this CTA's partials are written
    __syncthreads();

    // (2) A's strict lower part and the intra-chunk terms X (of dr) and Y
    // (of dk) over this CTA's key columns; G for the chunk before
    if (!big) {
      {                                                  // A_ij = Rw_i · Ki_j, j < i
        using T = Tiles<CT, CT, HT>;
        if (tid < T::WARPS) {
          const int l = tid % T::L, ta = (tid / T::L) / CT, tb = (tid / T::L) % CT;
          const bool live = tid < T::USED && ta >= tb;
          float acc[16] = {};
          if (live) {
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q) {
              const int mb = l + T::L * q;
              if (mb < HT) mac4<true, true>(acc, Rw, PR, Ki, PR, 4 * ta, 4 * tb, 4 * mb);
            }
          }
          reduce_scatter<T::L>(acc, l);
          if (live) {
#pragma unroll
            for (int e = 0; e < T::NE; ++e) {
              const int idx = l * T::NE + e, i = 4 * ta + idx / 4, j = 4 * tb + idx % 4;
              if (j != i) A[i * PQ + j] = j < i ? acc[e] : 0.f;
            }
          }
        }
      }
      {                                                  // X = Q_lower·Ki, Y = Q_lowerᵀ·Rw
        using T = Tiles<CT, NT, CT>;
        if (tid < T::WARPS) {
          const bool on = tid < T::USED;
          const int l = tid % T::L, ta = (tid / T::L) / NT, tb = (tid / T::L) % NT;
          float acc[16] = {};
          if (on) {
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q) {
              const int mb = l + T::L * q;
              if (mb < CT && mb <= ta)
                mac4<true, false>(acc, Q, PQ, Ki + gc, PR, 4 * ta, 4 * tb, 4 * mb);
            }
          }
          reduce_scatter<T::L>(acc, l);
          if (on) store_part<T::L>(Xs + 4 * ta * PN + 4 * tb, PN, acc, l);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = 0.f;
          if (on) {
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q) {
              const int mb = l + T::L * q;
              if (mb < CT && mb >= ta)
                mac4<false, false>(acc, Q, PQ, Rw + gc, PR, 4 * ta, 4 * tb, 4 * mb);
            }
          }
          reduce_scatter<T::L>(acc, l);
          if (on) store_part<T::L>(Ys + 4 * ta * PN + 4 * tb, PN, acc, l);
        }
      }
    } else {                                             // pairwise, clipped to [−60, 0]
      {
        constexpr int NP = C * (C - 1) / 2;
        const int half = tid & 1;
        int pi = 1, pj = tid >> 1;                       // pair tid >> 1 below the diagonal
        while (pj >= pi) { pj -= pi; ++pi; }
        float p = 0.f;
        if (tid < 2 * NP) {
          for (int m = 0; m < HS / 2; ++m) {
            const int d = 2 * m + half;
            p += R[pi * PR + d] * K[pj * PR + d]
                 * expf(fminf(fmaxf(Cum[(pi - 1) * PR + d] - Cum[pj * PR + d], -60.f), 0.f));
          }
        }
        const float other = __shfl_xor_sync(0xffffffffu, p, 1);
        if (tid < 2 * NP && half == 0) A[pi * PQ + pj] = p + other;
      }
      if (tid < C * NC) {
        const int t = tid / NC, dd = tid % NC, d = gc + dd;
        float x = 0.f, y = 0.f;
        for (int j = 0; j < t; ++j)
          x += Q[t * PQ + j] * K[j * PR + d]
               * expf(fminf(fmaxf(Cum[(t - 1) * PR + d] - Cum[j * PR + d], -60.f), 0.f));
        for (int i = t + 1; i < C; ++i)
          y += Q[i * PQ + t] * R[i * PR + d]
               * expf(fminf(fmaxf(Cum[(i - 1) * PR + d] - Cum[t * PR + d], -60.f), 0.f));
        Xs[t * PN + dd] = x;
        Ys[t * PN + dd] = y;
      }
    }
    {                                                    // G ← e^{cum_last} ⊙ G + Rwᵀ·do
      using T = Tiles<HT, NT, CT>;
      if (tid < T::WARPS) {
        const bool on = tid < T::USED;
        const int l = tid % T::L, ta = (tid / T::L) / NT, tb = (tid / T::L) % NT;
        float acc[16] = {};
        if (on) {
#pragma unroll
          for (int q = 0; q < T::STEPS; ++q) {
            const int mb = l + T::L * q;
            if (mb < CT) mac4<false, false>(acc, Rw, PR, Do + gc, PR, 4 * ta, 4 * tb, 4 * mb);
          }
        }
        reduce_scatter<T::L>(acc, l);
        if (on) {
#pragma unroll
          for (int e = 0; e < T::NE; ++e) {
            const int idx = l * T::NE + e, d = 4 * ta + idx / 4, col = 4 * tb + idx % 4;
            Gn[d * PN + col] = dec[d] * Gc[d * PN + col] + acc[e];
          }
        }
      }
    }
    __syncthreads();

    // (3) dr, dk, a, b of this CTA's key columns from the NS partials in rank
    // order; du; dv of its value columns
    cluster_wait();                                      // every CTA's partials are written
    if (tid < C * NC) {
      const int t = tid / NC, dd = tid % NC, d = gc + dd;
      float pr = 0.f, pk = 0.f;
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float* part = cluster.map_shared_rank(Pr, q);
        pr += part[t * PR + d];
        pk += part[kRows + t * PR + d];
      }
      const float cm = Cum[t * PR + d];
      const float ecx = t ? expf(Cum[(t - 1) * PR + d]) : 1.f;   // e^{cum_excl}
      const float elc = expf(Cum[(C - 1) * PR + d] - cm);        // e^{cum_last − cum}
      const float x = Xs[t * PN + dd], y = Ys[t * PN + dd];
      const float drp = big ? x + ecx * pr : ecx * (x + pr);
      const float dkp = big ? y + elc * pk : expf(-cm) * y + elc * pk;
      const float rt = R[t * PR + d], kt = K[t * PR + d], qt = qd[t];
      const int64_t at = head + (c * C + t) * row + d;
      dr[at] = drp + us[d] * kt * qt;
      dk[at] = dkp + us[d] * rt * qt;
      Ab[t * PN + dd] = rt * drp;
      Bb[t * PN + dd] = kt * dkp;
    }
    if (tid < NC) {
#pragma unroll
      for (int t = 0; t < C; ++t) du_acc += R[t * PR + gc + tid] * K[t * PR + gc + tid] * qd[t];
    }
    {                                                    // dv = Aᵀ·do + Kw·G, this CTA's columns
      using T = Tiles<CT, NT, CT + HT>;
      if (tid < T::WARPS) {
        const bool on = tid < T::USED;
        const int l = tid % T::L, ta = (tid / T::L) / NT, tb = (tid / T::L) % NT;
        float acc[16] = {};
        if (on) {
#pragma unroll
          for (int q = 0; q < T::STEPS; ++q) {
            const int vb = l + T::L * q;
            if (vb < CT) {
              if (vb >= ta) mac4<false, false>(acc, A, PQ, Do + gc, PR, 4 * ta, 4 * tb, 4 * vb);
            } else if (vb < CT + HT) {
              mac4<true, false>(acc, Kw, PR, Gc, PN, 4 * ta, 4 * tb, 4 * (vb - CT));
            }
          }
        }
        reduce_scatter<T::L>(acc, l);
        if (on) store_part<T::L>(dv + head + (c * C + 4 * ta) * row + gc + 4 * tb, row, acc, l);
      }
    }
    __syncthreads();
    cb ^= 1;
  }
  dwalk(0);
  if (tid < NC) du_part[bh * HS + gc + tid] = du_acc;
  cluster.sync();                                        // no CTA leaves while its partials are read
}

template <int HS, int C, int NS>
cudaError_t prepare(size_t* bytes) {
  *bytes = sizeof(float) * Layout<HS, C, NS>::kFloats;
  return cudaFuncSetAttribute(rwkv6_chunk_bwd_kernel<HS, C, NS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

template <int HS, int C, int NS>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, float* dr, float* dk, float* dv, float* dw, float* du_part,
           float* states, int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err = prepare<HS, C, NS>(&bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * NS));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rwkv6_chunk_bwd_kernel<HS, C, NS>, r, k, v, w, u, dout, dr, dk,
                           dv, dw, du_part, states, S, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HS, int C, int NS>
int info(int* smem_bytes, int* ctas_per_sm) {
  size_t bytes;
  cudaError_t err = prepare<HS, C, NS>(&bytes);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, rwkv6_chunk_bwd_kernel<HS, C, NS>, kThreads, bytes);
}

}  // namespace

// CTAs a (b, h): 4, or 2 at hs = 16, so that a CTA's hs / split value
// columns fill two 4 × 4 tiles.
constexpr int split_for(int hs) { return hs == 16 ? 2 : 4; }

// The (hs, chunk) cases compiled.
#define RWKV6_BWD_CASES(X) X(16, 8) X(16, 16) X(32, 8) X(32, 16) X(64, 8) X(64, 16)

extern "C" {

// Returns 0 or the cudaError_t of the launch.  The caller checks shapes:
// hs in {16, 32, 64}, chunk in {8, 16}, S % chunk == 0, S > 0,
// 0 < B·H·split < 2^31; r, k, v, dout, dv 16-byte aligned; states holds
// B·H·(S/chunk)·hs·hs floats, du_part B·H·hs.
int rwkv6_chunk_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* dout, float* dr, float* dk, float* dv,
                        float* dw, float* du_part, float* states, long long B, long long S,
                        long long H, int hs, int chunk, void* stream) {
  if (chunk <= 0 || S <= 0 || B * H <= 0 || S % chunk != 0
      || B * H * split_for(hs) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RWKV6_BWD_LAUNCH(HS_, C_)                       \
  if (hs == HS_ && chunk == C_)                         \
    return launch<HS_, C_, split_for(HS_)>(r, k, v, w, u, dout, dr, dk, dv, dw, du_part, \
                                           states, B, S, H, s);
  RWKV6_BWD_CASES(RWKV6_BWD_LAUNCH)
#undef RWKV6_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The split, the shared memory a CTA takes and the CTAs an SM holds, for a
// case.
int rwkv6_chunk_bwd_info(int hs, int chunk, int* split, int* smem_bytes, int* ctas_per_sm) {
#define RWKV6_BWD_INFO(HS_, C_)                         \
  if (hs == HS_ && chunk == C_) {                       \
    *split = split_for(HS_);                            \
    return info<HS_, C_, split_for(HS_)>(smem_bytes, ctas_per_sm); \
  }
  RWKV6_BWD_CASES(RWKV6_BWD_INFO)
#undef RWKV6_BWD_INFO
  return (int)cudaErrorInvalidValue;
}

const char* rwkv6_chunk_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
