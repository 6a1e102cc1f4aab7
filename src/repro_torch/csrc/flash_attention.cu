// Causal or non-causal GQA attention forward (flash form), written for Hopper (sm_90a).
//
// Inputs q (B, S, N, dh), k and v (B, Sk, Kh, dh), read in place through
// their element strides (the last dimension contiguous), all bf16 or all
// float32; N % Kh == 0 and query head n reads K/V head n / (N / Kh), the
// grouping of the reference's _block_attn_fwd.  Sk = S on a causal call; a
// non-causal call may take any Sk ≥ 1 (cross-attention: the encoder's
// output as keys).  Output (B, S, N·dh) in the input type (strides given
// too):
//
//   out[b, i, n] = Σ_j p_ij v[b, j, n / G] / max(Σ_j p_ij, 1e-30),
//   p_ij = exp(s_ij − m_i),  s_ij = (q_i · k_j) / sqrt(dh),
//
// over j ≤ i when causal, every j < Sk otherwise, by online softmax over
// K/V tiles: a running max m, a running sum l and a float32 accumulator,
// rescaled by exp(m_old − m_new) as each tile arrives.  A causal call may
// take a sliding window w ≥ 1 (0: none): then only i − w < j ≤ i, the mask
// of the reference's models/layers._attn_mask, for Hymba's windowed layers.
// Masked scores are −1e30 (not −inf), as in the reference.  In bf16 the
// probabilities are rounded to bf16 before P·V and l sums them unrounded,
// as _block_attn_fwd does.  Optionally (a non-null lse pointer) each row's
// log-sum-exp m + log(max(l, 1e-30)) in natural log, float32 (B, N, S), the
// residual that the training backward (ref.block_attn_bwd) recomputes the
// probabilities from; rows past S are not written.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention), whose grid (B·H, q blocks, kv blocks) runs in order on
// one core, keeps m, l and the accumulator in VMEM scratch across the kv
// axis, masks the causal upper triangle instead of skipping it, and needs
// K/V repeated G times by its GQA wrapper.  Here one block owns one query
// tile of one (b, n) and loops over the K/V tiles itself, its state in
// registers; under causality the loop stops at the diagonal tile (the tiles
// wholly above it are never read); the K/V head is indexed, never repeated.
//
// Bound: operations.  At the TinyLlama prefill (8, 2048, 32, 4, 64) the
// products are 4·B·N·dh·S(S+1)/2 = 137.4 GFLOP, 0.139 ms at 989 TFLOP/s
// bf16, against 151 MB of q, k, v and output (0.045 ms at 3.35 TB/s).  With
// a window the pairs are Σ_i min(i + 1, w): at Hymba's (8, 2176, 25, 5, 64),
// w 1,024, 1.70 · 10⁶ a (b, head) against 2.37 · 10⁶ causal; at (1, 16384),
// 16.3 · 10⁶ against 134.2 · 10⁶.
//
// Design, bf16 (384 threads = 3 warpgroups a block, 128-row query tiles,
// 128-row K/V tiles), after FlashAttention-3's warp specialisation:
// - Persistent: one block an SM walks the (query tile, b, n) work tiles,
//   longest causal rows first, so one tile's last products and stores run
//   while the next tile's Q and K/V are already loading.
// - Warpgroup 0 is the producer: setmaxnreg lowers its registers to 24 and one
//   thread issues every load as a TMA copy through a 4-D tensor map (dh,
//   heads, S, B) of the operand's own strides, so the copies cost the
//   consumers no instructions.  Q's 128 × dh tile is loaded once a work tile
//   (a "full" and an "empty" mbarrier); K and V tiles go through a ring of 3
//   stages, each with a "full" mbarrier for K, one for V (the TMA completes
//   their byte counts) and an "empty" one that all 256 consumer threads
//   arrive on when the tile's products are done.  TMA writes zeros for rows
//   past S (past Sk in K and V), so a ragged or short length needs no load
//   code; a zero key still scores 0, so the keys of the last tile past Sk
//   are masked before the row max (the "edge" mask).  Every row of a
//   non-causal call sees key 0 in its first tile, so its running max is a
//   score, never the mask value, even where Sk < 128 and that tile is the
//   last.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg raises theirs to 240),
//   64 query rows each.  S = Q·Kᵀ is one wgmma m64n128k16 per 16 columns of
//   dh, both operands read from shared memory by descriptors; the softmax
//   runs on the 64 accumulators a thread holds (a row's max and sum over its
//   4 lanes, two shuffles), in base 2 with 1/√dh·log₂e folded into one FFMA
//   before each ex2; the probabilities, rounded to bf16 in registers, are
//   the A operand of O += P·V (wgmma m64n{dh}k16, A from registers, V from
//   shared memory with the B-transpose bit, since a V tile is
//   dh-contiguous).  Within a consumer, tile j's Q·Kᵀ and softmax run while
//   tile j − 1's P·V is on the tensor cores; the two consumers run
//   unsynchronised, so one's softmax also runs under the other's products.
// - Tiles are swizzled by the TMA (128-byte swizzle at dh ≥ 64, 64 at 32, 32
//   at 16) in the pattern the wgmma descriptors name; at dh 128 a tile is two
//   64-column boxes.  Shared memory: (1 + 2 · 3) tiles of 128 × dh, 225 KB
//   at dh 128.
// - Causal masking touches only the diagonal tile (and a ragged last tile);
//   the loop stops at the diagonal.
// - Window (both kernels): query tile qt, rows [T·qt, T·qt + T), reads only
//   the K/V tiles from ⌊max(0, T·qt − w + 1) / T⌋ to its diagonal; the
//   tiles wholly below the band are never loaded or multiplied.  A tile
//   whose first key lies below T·qt + T − w is masked at its low edge too
//   (key < row − w + 1).  The band's first tile may hold no key of a row
//   (w 1,024, T 128: row T·qt + 127 there), and only that tile: that row's
//   max is then the mask value itself, and the bf16 kernel's one-FFMA
//   exponent x·c − m·c of two equal −1e30 scores need not be 0, so on the
//   first tile a row whose max is the mask value takes 0 for its
//   exponent's offset (FlashAttention-3's Check_inf) and its masked scores
//   give p = 0.  The float32 kernel subtracts before scaling, exactly, as
//   the reference does: p = 1 on such a tile, wiped by the next tile's
//   correction of 0.  The band's masks sit in a block of their own, so the
//   causal kernel's loop is the one it had without a window.
// Design, float32 (128 threads = 4 warps, 64 query rows, 64-row K/V tiles):
//   plain FMA, no TF32.  A thread owns 4 rows × 8 columns of the 64 × 64
//   score tile and 4 rows × dh/8 columns of the output; the 8 lanes of a row
//   reduce by shuffles; P goes through shared memory for P·V (warp local: a
//   row's lanes are in one warp).  Shared-memory rows are padded (+16 bytes)
//   so the float4 loads of a quarter warp fall in distinct banks; K/V tiles
//   arrive by cp.async.
//   The grid is (N, B, q tiles) with the q tile in reverse order, so the
//   longest causal rows start first.
// In both, the G heads of one K/V head are neighbours in the order of work
// and share its tiles through L2.
// Every sum runs in a fixed order with no atomics: the same result on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;

// bf16 kernel
constexpr int kTile = 128;          // query rows a block; key rows a K/V tile (equal: the causal tile count is qt + 1)
constexpr int kStages = 3;          // K/V ring depth (225 KB of shared memory at dh 128)
constexpr int kWG = 128;            // threads a warpgroup
constexpr int kBf16Threads = 3 * kWG;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // 128 · 24 + 256 · 240 ≤ 65,536
constexpr int kMaxDevices = 64;     // per-device launch settings cached on the host

// float32 kernel
constexpr int kF32Threads = 128;    // 4 warps
constexpr int kF32Tile = 64;        // query rows a block and key rows a tile

struct Strides {                    // element strides of a (B, S, heads, dh) operand
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                       // (B, N, S) or null
  Strides sq, sk, sv, so;
  int S;                            // query rows
  int Sk;                           // key rows (S when causal)
  int G;                            // query heads a K/V head
  float scale;                      // 1 / sqrt(dh)
  int window;                       // causal band width, 0 for none
};

struct Bf16Args {
  CUtensorMap tq, tk, tv;           // (dh, heads, S, B) maps of q, (dh, heads, Sk, B) of k and v
  void* o;
  float* lse;
  Strides so;
  int B, S, Sk, N, G;
  int window;                       // causal band width, 0 for none
  float scale_log2;                 // log2(e) / sqrt(dh)
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ex2(float x) {     // 2^x; 0 for x below −126 (flushed)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory of the bf16 kernel at one dh, in bytes from a 1024-aligned base.
template <int DH>
struct Bf16Layout {
  static constexpr int kInner = DH < 64 ? DH : 64;         // columns a box and a swizzle row
  static constexpr int kRowBytes = 2 * kInner;             // 32, 64 or 128: the swizzle
  static constexpr int kParts = DH / kInner;               // boxes a tile: 1, or 2 at dh 128
  static constexpr int kPartBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kParts * kPartBytes;   // 128 rows × dh
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                    // + stage · kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;   // q_full, q_empty, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;   // + alignment slack
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ Bf16Args a) {
  using L = Bf16Layout<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * kStages, empty = v_full + 8 * kStages;
  const int S = a.S, Sk = a.Sk, N = a.N;
  const int n_qt = (S + kTile - 1) / kTile, n_kt = (Sk + kTile - 1) / kTile;
  // Work tile w (this block takes w = blockIdx.x, + gridDim.x, ...): query
  // tile n_qt − 1 − w / (B·N), so the longest causal rows go first, of
  // (b, n) = divmod(w % (B·N), N).
  const long long n_work = (long long)a.B * N * n_qt;
  auto tile_of = [&](long long w, int& b, int& n, int& qt) {
    const long long bn = w % ((long long)a.B * N);
    qt = n_qt - 1 - (int)(w / ((long long)a.B * N));
    b = (int)(bn / N);
    n = (int)(bn % N);
  };
  // the K/V tiles a query tile reads: first_tile(qt) .. last_tile(qt)
  const int window = CAUSAL ? a.window : 0;
  auto first_tile = [&](int qt) { return window ? max(0, qt * kTile - window + 1) / kTile : 0; };
  auto last_tile = [&](int qt) { return CAUSAL ? qt : n_kt - 1; };

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 2 * kWG);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + 8 * s, 1);
      sm90::mbar_init(v_full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 2 * kWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_index();
  if (wg == 0) {
    // ---- producer: one thread keeps Q and the K/V ring full, tile after tile
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensor_map(&a.tq);
      sm90::prefetch_tensor_map(&a.tk);
      sm90::prefetch_tensor_map(&a.tv);
      int it = 0;                                    // K/V tiles loaded so far
      int round = 0;                                 // work tiles begun so far
      for (long long w = blockIdx.x; w < n_work; w += gridDim.x, ++round) {
        int b, n, qt;
        tile_of(w, b, n, qt);
        const int kh = n / a.G;
        if (round > 0) sm90::mbar_wait(q_empty, (round - 1) & 1);   // the last tile's Q is free
        sm90::mbar_arrive_expect_tx(q_full, L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kParts; ++p)
          sm90::tma_load_4d(base + L::kQ + p * L::kPartBytes, &a.tq, q_full, p * L::kInner, n,
                            qt * kTile, b);
        for (int j = first_tile(qt); j <= last_tile(qt); ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) sm90::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(k_full + 8 * s, L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kParts; ++p)
            sm90::tma_load_4d(base + L::kK + s * L::kTileBytes + p * L::kPartBytes, &a.tk,
                              k_full + 8 * s, p * L::kInner, kh, j * kTile, b);
          sm90::mbar_arrive_expect_tx(v_full + 8 * s, L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kParts; ++p)
            sm90::tma_load_4d(base + L::kV + s * L::kTileBytes + p * L::kPartBytes, &a.tv,
                              v_full + 8 * s, p * L::kInner, kh, j * kTile, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows 64c .. 64c + 63 of each tile
    sm90::regs_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // descriptors advance by (byte offset) / 16 in their address field
    const uint64_t dq = sm90::make_desc(base + L::kQ + 64 * c * L::kRowBytes, L::kRowBytes);

    // x[4i + e]: the score of row row0 + 8(e / 2), key kv0 + 8i + 2t + e % 2;
    // o[4i + e]: row row0 + 8(e / 2), column 8i + 2t + e % 2
    float x[64], o[DH / 2];
    uint32_t pa[8][4];                               // P in bf16: the A fragments of P·V's 8 k-steps
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // m: the raw scores' running max
    float corr[2], sum[2];
    int it = 0;                                      // K/V tiles consumed so far

    auto scores = [&](int i) {                       // issue x = Q·Kᵀ of ring slot i (not waited for)
      const uint64_t dk =
          sm90::make_desc(base + L::kK + (i % kStages) * L::kTileBytes, L::kRowBytes);
      sm90::mbar_wait(k_full + 8 * (i % kStages), (i / kStages) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int off = (kk * 16 / L::kInner) * L::kPartBytes + 2 * (kk * 16 % L::kInner);
        sm90::wgmma_ss_m64n128k16(x, dq + (off >> 4), dk + (off >> 4), kk);
      }
      sm90::wgmma_commit();
    };
    auto accumulate = [&](int i) {                   // issue o += P·V of ring slot i (not waited for)
      const uint64_t dv0 =
          sm90::make_desc(base + L::kV + (i % kStages) * L::kTileBytes, L::kRowBytes);
      sm90::mbar_wait(v_full + 8 * (i % kStages), (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int p = 0; p < L::kParts; ++p) {
          const uint64_t dv = dv0 + ((p * L::kPartBytes + kk * 16 * L::kRowBytes) >> 4);
          if constexpr (DH >= 64)
            sm90::wgmma_rs_m64n64k16_tb(o + 32 * p, pa[kk], dv);
          else if constexpr (DH == 32)
            sm90::wgmma_rs_m64n32k16_tb(o, pa[kk], dv);
          else
            sm90::wgmma_rs_m64n16k16_tb(o, pa[kk], dv);
        }
      }
      sm90::wgmma_commit();
    };
    // Online softmax of K/V tile j's scores, in place: x becomes
    // p = 2^(x·c − m·c) with c = log2(e)/√dh folded into one FFMA; corr is
    // exp(m_old − m_new).  edge: mask keys past the row (or past Sk); low:
    // mask keys below the row's band; first: the tile opens the row's
    // state, and only a band's first tile can hold none of a row's keys.
    auto softmax = [&](int j, int row0, bool edge, bool low, bool first) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sm90::fence_operand(x[i]);
      const int kv0 = j * kTile;
      if (edge) {
        // key kv0 + 2t + (8(i / 4) + i % 2) is valid up to min(Sk − 1, row)
        // (Sk − 1 when not causal): one compare of the constant against a
        // per-row bound
        int lim[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = (CAUSAL ? min(Sk - 1, row0 + 8 * r) : Sk - 1) - kv0 - 2 * t;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i / 4) + (i & 1) > lim[(i >> 1) & 1]) x[i] = kMasked;
      }
      if (low) {
        // ... and from row − w + 1 (a row past S takes row S − 1's band)
        int lo[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) lo[r] = min(S - 1, row0 + 8 * r) - window + 1 - kv0 - 2 * t;
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i / 4) + (i & 1) < lo[(i >> 1) & 1]) x[i] = kMasked;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * a.scale_log2);   // 0 on the first tile (m = −inf)
        m[r] = mx[r];
        // a row with no key in the band's first tile: p = 0, not 2^(residue)
        ms[r] = first && mx[r] == kMasked ? 0.f : mx[r] * a.scale_log2;
        sum[r] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        x[i] = ex2(fmaf(x[i], a.scale_log2, -ms[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += x[i];
      }
    };
    // Folds a finished tile into the state: l and o rescaled, P rounded to bf16.
    auto fold = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];   // this lane's share of l
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
        pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
        pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
        pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
      }
    };

    // Tile j's scores and softmax run while tile j − 1's P·V is on the tensor
    // cores; the two consumers run unsynchronised, so one's softmax also runs
    // under the other's products.
    int round = 0;
    for (long long w = blockIdx.x; w < n_work; w += gridDim.x, ++round) {
      int b, n, qt;
      tile_of(w, b, n, qt);
      const int j0 = first_tile(qt), n_tiles = last_tile(qt) - j0 + 1;
      const int row0 = qt * kTile + 64 * c + 16 * warp + g;   // this thread's rows: row0, row0 + 8
      // masked: the diagonal and a ragged last K/V tile; the band's low edge
      auto edge = [&](int j) { return (CAUSAL && j == qt) || (j + 1) * kTile > Sk; };
      auto low = [&](int j) { return window && j * kTile < qt * kTile + kTile - window; };
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      sm90::mbar_wait(q_full, round & 1);
      scores(it);
      sm90::wgmma_wait<0>();
      softmax(j0, row0, edge(j0), low(j0), true);
      fold();
      for (int j = 1; j < n_tiles; ++j) {
        scores(it + j);
        accumulate(it + j - 1);
        sm90::wgmma_wait<1>();                       // the scores have landed
        softmax(j0 + j, row0, edge(j0 + j), low(j0 + j), false);
        sm90::wgmma_wait<0>();                       // P·V of tile j − 1 is done
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) sm90::fence_operand(o[i]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) sm90::fence_operand(pa[kk][r]);
        sm90::mbar_arrive(empty + 8 * ((it + j - 1) % kStages));   // its K and V are free
        fold();
      }
      sm90::mbar_arrive(q_empty);                    // every product with Q is done
      sm90::wgmma_fence();
      accumulate(it + n_tiles - 1);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) sm90::fence_operand(o[i]);
      sm90::mbar_arrive(empty + 8 * ((it + n_tiles - 1) % kStages));
      it += n_tiles;

      bf16* O = static_cast<bf16*>(a.o) + b * a.so.b + n * a.so.h;
      float* LSE = a.lse ? a.lse + ((long long)b * N + n) * S : nullptr;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float den = fmaxf(lr, 1e-30f);
        const int row = row0 + 8 * r;
        if (row < S) {
          if (LSE && t == 0) LSE[row] = m[r] * a.scale_log2 * kLn2 + logf(den);
          bf16* orow = O + row * a.so.s + 2 * t;
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt)
            *reinterpret_cast<uint32_t*>(orow + dt * 8) =
                pack_bf16(o[4 * dt + 2 * r] / den, o[4 * dt + 2 * r + 1] / den);
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;     // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + ROWS − 1 of one (b, head) of a (B, S, heads, DH) operand
// into shared memory with a row stride of LD elements; rows ≥ S read as 0.
template <typename T, int DH, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* sm, const T* base, long long row_stride, int r0,
                                          int S) {
  constexpr int kChunk = 16 / sizeof(T);        // elements in 16 bytes
  constexpr int kPerRow = DH / kChunk;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kF32Threads) {
    const int r = c / kPerRow, e = (c % kPerRow) * kChunk;
    const bool ok = r0 + r < S;
    cp_async16(sm + r * LD + e, ok ? base + (long long)(r0 + r) * row_stride + e : base, ok);
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const Args a) {
  constexpr int LD = DH + 4;                    // row stride in floats
  constexpr int LP = kF32Tile + 4;
  constexpr int NC = DH / 8;                    // output columns a thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kF32Tile][LD]
  float* sK = sQ + kF32Tile * LD;               // [kF32Tile][LD]
  float* sV = sK + kF32Tile * LD;               // [kF32Tile][LD]
  float* sP = sV + kF32Tile * LD;               // [kF32Tile][LP]

  const int n = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kF32Tile;
  const int S = a.S, Sk = a.Sk, kh = n / a.G;
  const float* Q = static_cast<const float*>(a.q) + b * a.sq.b + n * a.sq.h;
  const float* K = static_cast<const float*>(a.k) + b * a.sk.b + kh * a.sk.h;
  const float* V = static_cast<const float*>(a.v) + b * a.sv.b + kh * a.sv.h;
  const int window = CAUSAL ? a.window : 0;
  const int j0 = window ? max(0, q0 - window + 1) / kF32Tile : 0;   // the band's first tile
  const int j1 = CAUSAL ? qt : (Sk + kF32Tile - 1) / kF32Tile - 1;

  // rows 4ty .. 4ty + 3; score columns tx + 8c (c < 8); output columns tx + 8c (c < NC)
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  load_tile<float, DH, kF32Tile, LD>(sQ, Q, a.sq.s, q0, S);
  cp_commit();
  float o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int j = j0; j <= j1; ++j) {
    const int kv0 = j * kF32Tile;
    load_tile<float, DH, kF32Tile, LD>(sK, K, a.sk.s, kv0, Sk);
    load_tile<float, DH, kF32Tile, LD>(sV, V, a.sv.s, kv0, Sk);
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * LD + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 8 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float acc = s[i][c];
          acc = fmaf(qv[i].x, kv[c].x, acc);
          acc = fmaf(qv[i].y, kv[c].y, acc);
          acc = fmaf(qv[i].z, kv[c].z, acc);
          acc = fmaf(qv[i].w, kv[c].w, acc);
          s[i][c] = acc;
        }
    }
    const bool edge = (CAUSAL && j == qt) || kv0 + kF32Tile > Sk ||
                      (window && kv0 < q0 + kF32Tile - window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      const int low = window ? min(row, S - 1) - window + 1 : 0;   // a row past S keeps a key
      float mx = m[i], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float x = s[i][c] * a.scale;
        if (edge) {
          const int key = kv0 + tx + 8 * c;
          if (key >= Sk || (CAUSAL && key > row) || key < low) x = kMasked;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = exp2f((m[i] - mx) * kLog2e);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = exp2f((s[i][c] - mx) * kLog2e);
        sum += p;
        sP[(4 * ty + i) * LP + tx + 8 * c] = p;
      }
      l[i] = l[i] * corr + sum;                 // this lane's share of l
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= corr;
    }
    __syncwarp();                               // a row's 8 lanes are in one warp

    // O += P·V
#pragma unroll 2
    for (int c = 0; c < kF32Tile; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sV + (c + cc) * LD + tx;
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          const float vv = vrow[8 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            o[i][jj] = fmaf(p, vv, o[i][jj]);
          }
        }
      }
    }
    __syncthreads();                            // K, V and P are free for the next tile
  }

  float* O = static_cast<float*>(a.o) + b * a.so.b + n * a.so.h;
  float* LSE = a.lse ? a.lse + ((long long)b * gridDim.x + n) * S : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float den = fmaxf(li, 1e-30f);
    const int row = q0 + 4 * ty + i;
    if (row < S) {
      if (LSE && tx == 0) LSE[row] = m[i] + logf(den);
      float* orow = O + row * a.so.s + tx;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[8 * c] = o[i][c] / den;
    }
  }
}

// A tensor map of one (B, S, heads, DH) bf16 operand, its dims (dh, heads,
// S, B) innermost first, boxes of one TMA part.  A dimension of extent 1
// takes the packed stride (its stride is never used, and TMA wants every
// stride a positive multiple of 16 bytes).
template <int DH>
int bf16_map(CUtensorMap* map, const void* base, const Strides& st, long long B, long long S,
             long long heads) {
  using L = Bf16Layout<DH>;
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t given[3] = {2ull * st.h, 2ull * st.s, 2ull * st.b};
  uint64_t strides[3], packed = 2ull * DH;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? given[i] : packed;
    packed = strides[i] * dims[i + 1];
  }
  const uint32_t box[4] = {(uint32_t)L::kInner, 1, (uint32_t)kTile, 1};
  return sm90::make_tensor_map_bf16(map, base, dims, strides, box,
                                    static_cast<sm90::Swizzle>(L::kRowBytes));
}

template <int DH, bool CAUSAL>
int launch_bf16(const Args& a, long long B, long long S, long long N, long long Kh,
                cudaStream_t st) {
  using L = Bf16Layout<DH>;
  Bf16Args h;
  int err = bf16_map<DH>(&h.tq, a.q, a.sq, B, S, N);
  if (!err) err = bf16_map<DH>(&h.tk, a.k, a.sk, B, a.Sk, Kh);
  if (!err) err = bf16_map<DH>(&h.tv, a.v, a.sv, B, a.Sk, Kh);
  if (err) return err;
  h.o = a.o;
  h.lse = a.lse;
  h.so = a.so;
  h.B = (int)B;
  h.S = a.S;
  h.Sk = a.Sk;
  h.N = (int)N;
  h.G = a.G;
  h.window = a.window;
  h.scale_log2 = a.scale * kLog2e;
  // per device, once: the shared-memory opt-in and the SM count (a launch's
  // host time is on the path of short calls)
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev];
  if (sms == 0) {
    if ((e = cudaFuncSetAttribute(flash_attention_bf16_kernel<DH, CAUSAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    sms_of[dev] = sms;
  }
  const long long work = B * N * ((S + kTile - 1) / kTile);   // one block an SM walks the tiles
  flash_attention_bf16_kernel<DH, CAUSAL>
      <<<(unsigned)(work < sms ? work : sms), kBf16Threads, L::kBytes, st>>>(h);
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL>
int launch_f32(const Args& a, long long B, long long S, long long N, cudaStream_t st) {
  constexpr size_t bytes =
      sizeof(float) * ((kF32Tile + 2 * kF32Tile) * (DH + 4) + kF32Tile * (kF32Tile + 4));
  static bool opted_in[kMaxDevices];                // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_attention_f32_kernel<DH, CAUSAL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const unsigned n_qt = (unsigned)((S + kF32Tile - 1) / kF32Tile);
  flash_attention_f32_kernel<DH, CAUSAL>
      <<<dim3((unsigned)N, (unsigned)B, n_qt), kF32Threads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const Args& a, bool is_bf16, bool causal, long long B, long long S, long long N,
             long long Kh, cudaStream_t st) {
  if (is_bf16)
    return causal ? launch_bf16<DH, true>(a, B, S, N, Kh, st)
                  : launch_bf16<DH, false>(a, B, S, N, Kh, st);
  return causal ? launch_f32<DH, true>(a, B, S, N, st) : launch_f32<DH, false>(a, B, S, N, st);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  q is (B, S, N, dh), k and v
// (B, Sk, Kh, dh), out (B, S, N·dh).  strides: 12 element strides,
// (batch, sequence, head) of q, k, v and out in that order, each of a
// dimension longer than 1 a positive multiple of 16 bytes; every base pointer
// is 16-byte aligned; the last dimension is contiguous.  lse: null, or a contiguous
// float32 (B, N, S) for each row's log-sum-exp.  The caller checks shapes: dh
// in {16, 32, 64, 128}, N % Kh == 0, B, ceil(S / tile) and ceil(Sk / tile) at
// most 65,535, the tile 128 rows in bf16 and 64 in float32.  Sk = S on a causal
// call.  window: 0, or the causal band width w ≥ 1 (a window on a non-causal
// call is refused).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                        int is_bf16, long long B, long long S, long long Sk, long long N,
                        long long Kh, int dh, int causal, int window, const long long* strides,
                        void* stream) {
  const long long tile = is_bf16 ? kTile : kF32Tile;
  if (B <= 0 || S <= 0 || Sk <= 0 || N <= 0 || Kh <= 0 || N % Kh != 0 || B > 65535 ||
      N > 0x7fffffffLL || (S + tile - 1) / tile > 65535 || (Sk + tile - 1) / tile > 65535 ||
      (causal && Sk != S) || window < 0 || (window && !causal))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = lse;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  a.S = (int)S;
  a.Sk = (int)Sk;
  a.G = (int)(N / Kh);
  a.scale = (float)(1.0 / sqrt((double)dh));
  a.window = window;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return dispatch<16>(a, is_bf16, causal, B, S, N, Kh, st);
    case 32: return dispatch<32>(a, is_bf16, causal, B, S, N, Kh, st);
    case 64: return dispatch<64>(a, is_bf16, causal, B, S, N, Kh, st);
    case 128: return dispatch<128>(a, is_bf16, causal, B, S, N, Kh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bf16 kernel at head width dh, in bytes (0 for
// a width it does not take).
int flash_attention_bf16_smem_bytes(int dh) {
  switch (dh) {
    case 16: return Bf16Layout<16>::kBytes;
    case 32: return Bf16Layout<32>::kBytes;
    case 64: return Bf16Layout<64>::kBytes;
    case 128: return Bf16Layout<128>::kBytes;
    default: return 0;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
