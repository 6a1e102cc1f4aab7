// Causal or non-causal GQA attention forward (flash form), written for Hopper (sm_90a).
//
// Inputs q (B, S, N, dh), k and v (B, S, Kh, dh), read in place through
// their element strides (the last dimension contiguous), all bf16 or all
// float32; N % Kh == 0 and query head n reads K/V head n / (N / Kh), the
// grouping of the reference's _block_attn_fwd.  Output (B, S, N·dh) in the
// input type (strides given too):
//
//   out[b, i, n] = Σ_j p_ij v[b, j, n / G] / max(Σ_j p_ij, 1e-30),
//   p_ij = exp(s_ij − m_i),  s_ij = (q_i · k_j) / sqrt(dh),
//
// over j ≤ i when causal, every j < S otherwise, by online softmax over
// 64-row K/V tiles: a running max m, a running sum l and a float32
// accumulator, rescaled by exp(m_old − m_new) as each tile arrives.
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
// K/V repeated G times by its GQA wrapper.  Here one block owns 64 query rows
// of one (b, n) and loops over the K/V tiles itself, its state in registers;
// under causality the loop stops at the diagonal tile (the tiles wholly above
// it are never read); the K/V head is indexed, never repeated.
//
// Bound: operations.  At the TinyLlama prefill (8, 2048, 32, 4, 64) the
// products are 4·B·N·dh·S(S+1)/2 = 137.4 GFLOP, 0.139 ms at 989 TFLOP/s
// bf16, against 151 MB of q, k, v and output (0.045 ms at 3.35 TB/s).
//
// Design (128 threads = 4 warps a block, 64 query rows, 64-row K/V tiles):
// - bf16: each warp owns 16 query rows.  S = Q·Kᵀ and O += P·V run on the
//   tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).  The
//   Q fragments stay in registers for the whole loop; S's accumulator
//   fragments become P·V's A operand in registers (no trip through shared
//   memory); V's B fragments come from ldmatrix.trans.  K/V tiles are
//   double-buffered in shared memory by cp.async, the next tile in flight
//   while the current one is used; rows past S are zero-filled.  A row's max
//   and sum are shared by the 4 lanes that hold it (two shuffles).
// - float32: plain FMA, no TF32.  A thread owns 4 rows × 8 columns of the
//   64 × 64 score tile and 4 rows × dh/8 columns of the output; the 8 lanes
//   of a row reduce by shuffles; P goes through shared memory for P·V (warp
//   local: a row's lanes are in one warp).
// - Shared-memory rows are padded (+16 bytes) so the fragment and float4
//   loads of a quarter warp fall in distinct banks.
// - The grid is (N, B, q tiles) with the q tile in reverse order, so the
//   longest causal rows start first; the G heads of one K/V head are
//   neighbours in the grid and share its tiles through L2.
// Every sum runs in a fixed order with no atomics: the same result on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kBM = 64;             // query rows a block
constexpr int kBN = 64;             // key/value rows a tile (== kBM: the causal tile count is qt + 1)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

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
  int S;                            // sequence length (queries and keys)
  int G;                            // query heads a K/V head
  float scale;                      // 1 / sqrt(dh)
};

using bf16 = __nv_bfloat16;

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
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, e = (c % kPerRow) * kChunk;
    const bool ok = r0 + r < S;
    cp_async16(sm + r * LD + e, ok ? base + (long long)(r0 + r) * row_stride + e : base, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a · b for one 16 × 8 × 16 tile: a row-major (4 regs), b column-major (2 regs).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 × 8 bf16 matrices, transposed: lane L gives the address of row L % 8
// of matrix L / 8 and receives, of each, the elements (2(L % 4), L / 4) and
// (2(L % 4) + 1, L / 4): an mma B fragment of a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const Args a) {
  constexpr int LD = DH + 8;                    // row stride in elements
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);    // [kBM][LD]
  bf16* sK = sQ + kBM * LD;                     // [2][kBN][LD]
  bf16* sV = sK + 2 * kBN * LD;                 // [2][kBN][LD]

  const int n = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kBM;
  const int S = a.S, kh = n / a.G;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.sq.b + n * a.sq.h;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.sk.b + kh * a.sk.h;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.sv.b + kh * a.sv.h;
  const int n_tiles = CAUSAL ? qt + 1 : (S + kBN - 1) / kBN;

  load_tile<bf16, DH, kBM, LD>(sQ, Q, a.sq.s, q0, S);
  load_tile<bf16, DH, kBN, LD>(sK, K, a.sk.s, 0, S);
  load_tile<bf16, DH, kBN, LD>(sV, V, a.sv.s, 0, S);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;          // this thread's rows: row0 and row0 + 8
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {                      // the next tile, into the other buffer
      load_tile<bf16, DH, kBN, LD>(sK + (buf ^ 1) * kBN * LD, K, a.sk.s, (j + 1) * kBN, S);
      load_tile<bf16, DH, kBN, LD>(sV + (buf ^ 1) * kBN * LD, V, a.sv.s, (j + 1) * kBN, S);
    }
    cp_commit();                                // (an empty group on the last tile)
    cp_wait<1>();                               // tile j (and Q) have landed
    __syncthreads();
    if (j == 0) {
      const bf16* qs = sQ + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        qf[kk][0] = ld32(qs + kk * 16);
        qf[kk][1] = ld32(qs + 8 * LD + kk * 16);
        qf[kk][2] = ld32(qs + kk * 16 + 8);
        qf[kk][3] = ld32(qs + 8 * LD + kk * 16 + 8);
      }
    }
    const bf16* ks = sK + buf * kBN * LD;
    const bf16* vs = sV + buf * kBN * LD;

    // S = Q·Kᵀ: 8 tiles of 16 × 8; element e of tile nt is row row0 + 8(e / 2),
    // key j·kBN + 8nt + 2t + e % 2
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }
    const int kv0 = j * kBN;
    const bool edge = (CAUSAL && j == qt) || kv0 + kBN > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (edge) {
          const int key = kv0 + nt * 8 + 2 * t + (e & 1), row = row0 + (e >> 1) * 8;
          if (key >= S || (CAUSAL && key > row)) x = kMasked;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * kLog2e);  // 0 on the first tile (m = −inf)
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f((s[nt][e] - m[e >> 1]) * kLog2e);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];   // this lane's share of l
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P·V: P's fragments are S's accumulators, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DH / 8; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LD + (dt + (lane >> 4)) * 8);
        mma_bf16(o[dt], pa, vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                            // the buffer is free for tile j + 2
  }

  bf16* O = static_cast<bf16*>(a.o) + b * a.so.b + n * a.so.h;
  float* LSE = a.lse ? a.lse + ((long long)b * gridDim.x + n) * S : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int row = row0 + 8 * i;
    if (row < S) {
      if (LSE && t == 0) LSE[row] = m[i] + logf(den);
      bf16* orow = O + row * a.so.s + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16(o[dt][2 * i] / den, o[dt][2 * i + 1] / den);
    }
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const Args a) {
  constexpr int LD = DH + 4;                    // row stride in floats
  constexpr int LP = kBN + 4;
  constexpr int NC = DH / 8;                    // output columns a thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBM][LD]
  float* sK = sQ + kBM * LD;                    // [kBN][LD]
  float* sV = sK + kBN * LD;                    // [kBN][LD]
  float* sP = sV + kBN * LD;                    // [kBM][LP]

  const int n = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kBM;
  const int S = a.S, kh = n / a.G;
  const float* Q = static_cast<const float*>(a.q) + b * a.sq.b + n * a.sq.h;
  const float* K = static_cast<const float*>(a.k) + b * a.sk.b + kh * a.sk.h;
  const float* V = static_cast<const float*>(a.v) + b * a.sv.b + kh * a.sv.h;
  const int n_tiles = CAUSAL ? qt + 1 : (S + kBN - 1) / kBN;

  // rows 4ty .. 4ty + 3; score columns tx + 8c (c < 8); output columns tx + 8c (c < NC)
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  load_tile<float, DH, kBM, LD>(sQ, Q, a.sq.s, q0, S);
  cp_commit();
  float o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBN;
    load_tile<float, DH, kBN, LD>(sK, K, a.sk.s, kv0, S);
    load_tile<float, DH, kBN, LD>(sV, V, a.sv.s, kv0, S);
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
    const bool edge = (CAUSAL && j == qt) || kv0 + kBN > S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = m[i], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float x = s[i][c] * a.scale;
        if (edge) {
          const int key = kv0 + tx + 8 * c;
          if (key >= S || (CAUSAL && key > row)) x = kMasked;
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
    for (int c = 0; c < kBN; c += 4) {
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

template <int DH, bool CAUSAL>
int launch_bf16(const Args& a, unsigned N, unsigned B, unsigned n_qt, cudaStream_t st) {
  constexpr size_t bytes = sizeof(bf16) * (kBM + 4 * kBN) * (DH + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<DH, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bf16_kernel<DH, CAUSAL><<<dim3(N, B, n_qt), kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL>
int launch_f32(const Args& a, unsigned N, unsigned B, unsigned n_qt, cudaStream_t st) {
  constexpr size_t bytes = sizeof(float) * ((kBM + 2 * kBN) * (DH + 4) + kBM * (kBN + 4));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<DH, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_attention_f32_kernel<DH, CAUSAL><<<dim3(N, B, n_qt), kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const Args& a, bool is_bf16, bool causal, unsigned N, unsigned B, unsigned n_qt,
             cudaStream_t st) {
  if (is_bf16)
    return causal ? launch_bf16<DH, true>(a, N, B, n_qt, st) : launch_bf16<DH, false>(a, N, B, n_qt, st);
  return causal ? launch_f32<DH, true>(a, N, B, n_qt, st) : launch_f32<DH, false>(a, N, B, n_qt, st);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  strides: 12 element strides,
// (batch, sequence, head) of q, k, v and out in that order, each a multiple of
// 16 bytes, as is every base pointer; the last dimension is contiguous.  lse:
// null, or a contiguous float32 (B, N, S) for each row's log-sum-exp.  The
// caller checks shapes: dh in {16, 32, 64, 128}, N % Kh == 0, B and
// ceil(S / 64) at most 65,535.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                        int is_bf16, long long B, long long S, long long N, long long Kh, int dh,
                        int causal, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || Kh <= 0 || N % Kh != 0 || B > 65535 || N > 0x7fffffffLL ||
      (S + kBM - 1) / kBM > 65535)
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
  a.G = (int)(N / Kh);
  a.scale = (float)(1.0 / sqrt((double)dh));
  const unsigned n_qt = (unsigned)((S + kBM - 1) / kBM);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return dispatch<16>(a, is_bf16, causal, (unsigned)N, (unsigned)B, n_qt, st);
    case 32: return dispatch<32>(a, is_bf16, causal, (unsigned)N, (unsigned)B, n_qt, st);
    case 64: return dispatch<64>(a, is_bf16, causal, (unsigned)N, (unsigned)B, n_qt, st);
    case 128: return dispatch<128>(a, is_bf16, causal, (unsigned)N, (unsigned)B, n_qt, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
