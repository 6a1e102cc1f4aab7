// Segment-⊕ over a static CSR and its work plan, written for Hopper (sm_90a).
//
//   out[k, key, c] = Σ_{r ∈ segment(key)} vals[k, order[r], c]
//
// where order is the stable argsort of a join-tree edge's child key ids
// and offsets[key] .. offsets[key+1] is the key's run in it.  Inputs:
// vals (K, n, C) f32 or bf16, row-major; order (entries,) int32; and the
// CSR's work plan (built once per edge on the host, kernels/segment_sum/
// ops.py): item_offsets (n_items+1,), item i covering the entries
// item_offsets[i] .. item_offsets[i+1], all of one key item_key[i] and at
// most L of them (L = ops.ITEM_ROWS); item_slot[i], the partial slot of
// an item of a split key (a key of more than L entries) or −1; and per
// split key j its key split_key[j] and its slots split_offsets[j] ..
// split_offsets[j+1], in item order.  Output: (K, n_keys, C) f32.
//
// Replaces the TPU kernel src/repro/kernels/segment_sum/segment_sum.py
// (segment_sum_2d), which builds a one-hot (rows x keys) tile and
// multiplies it into the values on the MXU because scatter is slow on a
// TPU.  On Hopper that matmul would cost n * n_keys MACs for n adds, so
// this kernel reduces each item's run of the CSR directly instead.
//
// Bound: bytes.  The work reads every input once and writes the output
// once: K*n*C*sizeof(in) + 4*entries + 4(n_keys+1) + 4*K*n_keys*C bytes
// over 3.35 TB/s, against K*n*C adds, far below the f32 peak.
//
// Design:
// - one warp per (k, item), so no two warps write the same output and
//   no float atomics are needed.  A key of at most L entries is one item
//   (an empty key too) and writes its output directly; a longer key is
//   cut into ceil(len / L) items, each of which writes a partial to a
//   scratch (K, n_slots, C) that the wrapper allocates, and a second
//   launch sums each split key's partials in item order.  So the longest
//   serial walk is L entries whatever the key skew (before the plan, a
//   Zipf(1.3) key of 1,067,482 rows was one warp's walk);
// - C > 8: lanes stride the channels, NS of them a lane (NS = 1, 2 or 4,
//   up to 128 channels a pass), and each lane adds its channels over the
//   item's rows in CSR order, 4 rows unrolled to keep loads in flight;
// - C <= 8: lanes stride the rows, each lane keeps C partial sums, and a
//   fixed xor-shuffle tree combines the lanes.  On items of more than
//   3,072 entries (a split key's, a histogram bin's) a lane loads 4 rows
//   at once; on the ~1,000–2,000-entry items of uniform keys that was
//   slower, and they walk one row at a time.  Either way a lane adds its
//   rows in the same order, so the two loops give the same bits;
// - the summation order depends only on the CSR and the plan, so the f32
//   result is bit-identical from run to run, whatever the schedule;
// - empty keys write zeros; all address arithmetic is 64-bit, because
//   K*n*C passes 2^31 at sketch widths.
// Known costs that remain: at C = 3 the gather through order reads
// 12-byte rows and wastes most of each 32-byte sector; a skewed CSR pays
// a second launch (about the launch's own time) and K*n_slots*C floats of
// scratch traffic, n_slots <= entries / L + the number of split keys.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNarrowC = 8;      // row-striding path up to this many channels
constexpr int kUnroll = 4;       // rows in flight per lane (narrow path: on long items)
constexpr int kLongItem = 3072;  // narrow path: items longer than this unroll their rows
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The plan's view of warp w: its k, its item's CSR run [beg, end) and the
// row of (K, n_keys, C) output or (K, n_slots, C) scratch it writes.
struct Item {
  int64_t k;
  int beg, end;
  float* dst;
};

__device__ __forceinline__ Item item_of(int64_t w, const int* __restrict__ item_offsets,
                                        const int* __restrict__ item_key,
                                        const int* __restrict__ item_slot,
                                        float* __restrict__ out, float* __restrict__ part,
                                        int64_t n_items, int64_t n_keys, int64_t n_slots,
                                        int64_t C) {
  Item it;
  it.k = w / n_items;
  const int64_t i = w - it.k * n_items;
  it.beg = item_offsets[i];
  it.end = item_offsets[i + 1];
  const int slot = item_slot[i];
  it.dst = slot < 0 ? out + (it.k * n_keys + item_key[i]) * C
                    : part + (it.k * n_slots + slot) * C;
  return it;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_wide(const T* __restrict__ vals, const int* __restrict__ order,
                 const int* __restrict__ item_offsets, const int* __restrict__ item_key,
                 const int* __restrict__ item_slot, float* __restrict__ out,
                 float* __restrict__ part, int64_t n_items, int64_t n_keys, int64_t n_slots,
                 int64_t n, int64_t C, int64_t n_warps) {
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const Item it = item_of(w, item_offsets, item_key, item_slot, out, part, n_items, n_keys,
                          n_slots, C);
  const T* __restrict__ v = vals + it.k * n * C;
  for (int64_t c0 = 0; c0 < C; c0 += 32 * NS) {
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
    int r = it.beg;
    for (; r + kUnroll <= it.end; r += kUnroll) {
      int64_t rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) rows[u] = (int64_t)order[r + u] * C;
      float x[kUnroll][NS];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int64_t c = c0 + lane + 32 * s;
          x[u][s] = c < C ? to_f32(v[rows[u] + c]) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] += x[u][s];
    }
    for (; r < it.end; ++r) {
      const int64_t row = (int64_t)order[r] * C;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int64_t c = c0 + lane + 32 * s;
        if (c < C) acc[s] += to_f32(v[row + c]);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int64_t c = c0 + lane + 32 * s;
      if (c < C) it.dst[c] = acc[s];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_narrow(const T* __restrict__ vals, const int* __restrict__ order,
                   const int* __restrict__ item_offsets, const int* __restrict__ item_key,
                   const int* __restrict__ item_slot, float* __restrict__ out,
                   float* __restrict__ part, int64_t n_items, int64_t n_keys, int64_t n_slots,
                   int64_t n, int C, int64_t n_warps) {
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_warps) return;  // uniform across the warp: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const Item it = item_of(w, item_offsets, item_key, item_slot, out, part, n_items, n_keys,
                          n_slots, C);
  const T* __restrict__ v = vals + it.k * n * C;
  float acc[kNarrowC];
#pragma unroll
  for (int c = 0; c < kNarrowC; ++c) acc[c] = 0.f;
  int r = it.beg + lane;
  if (it.end - it.beg > kLongItem) {
    for (; r + 32 * (kUnroll - 1) < it.end; r += 32 * kUnroll) {
      const T* rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) rows[u] = v + (int64_t)order[r + 32 * u] * C;
      float x[kUnroll][kNarrowC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < kNarrowC; ++c) x[u][c] = c < C ? to_f32(rows[u][c]) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < kNarrowC; ++c) acc[c] += x[u][c];
    }
  }
  for (; r < it.end; r += 32) {
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
    if (lane == 0 && c < C) it.dst[c] = s;
  }
}

// One thread per (k, split key, channel): the key's partials in item order.
__global__ void __launch_bounds__(kCombineThreads)
segment_sum_combine(const float* __restrict__ part, const int* __restrict__ split_key,
                    const int* __restrict__ split_offsets, float* __restrict__ out,
                    int64_t n_split, int64_t n_keys, int64_t n_slots, int64_t C,
                    int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t c = t % C;
  const int64_t j = (t / C) % n_split;
  const int64_t k = t / (C * n_split);
  const float* __restrict__ p = part + k * n_slots * C + c;
  float acc = 0.f;
  for (int s = split_offsets[j]; s < split_offsets[j + 1]; ++s) acc += p[(int64_t)s * C];
  out[(k * n_keys + split_key[j]) * C + c] = acc;
}

struct Plan {
  const int* item_offsets;
  const int* item_key;
  const int* item_slot;
  const int* split_key;
  const int* split_offsets;
  int64_t n_items, n_split, n_slots;
};

template <typename T>
cudaError_t launch(const T* vals, const int* order, const Plan& pl, float* part, float* out,
                   int64_t K, int64_t n, int64_t n_keys, int64_t C, cudaStream_t stream) {
  const int64_t n_warps = K * pl.n_items;
  if (n_warps == 0 || C == 0) return cudaSuccess;
  const int64_t blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
#define SEGSUM_ARGS vals, order, pl.item_offsets, pl.item_key, pl.item_slot, out, part, \
                    pl.n_items, n_keys, pl.n_slots, n
  if (C <= kNarrowC) {
    segment_sum_narrow<T><<<grid, block, 0, stream>>>(SEGSUM_ARGS, (int)C, n_warps);
  } else if (C <= 32) {
    segment_sum_wide<T, 1><<<grid, block, 0, stream>>>(SEGSUM_ARGS, C, n_warps);
  } else if (C <= 64) {
    segment_sum_wide<T, 2><<<grid, block, 0, stream>>>(SEGSUM_ARGS, C, n_warps);
  } else {
    segment_sum_wide<T, 4><<<grid, block, 0, stream>>>(SEGSUM_ARGS, C, n_warps);
  }
#undef SEGSUM_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 0) return err;
  const int64_t total = K * pl.n_split * C;
  const int64_t cblocks = (total + kCombineThreads - 1) / kCombineThreads;
  if (cblocks > INT32_MAX) return cudaErrorInvalidValue;
  segment_sum_combine<<<(unsigned)cblocks, kCombineThreads, 0, stream>>>(
      part, pl.split_key, pl.split_offsets, out, pl.n_split, n_keys, pl.n_slots, C, total);
  return cudaGetLastError();
}

}  // namespace

// plan: the five int32 arrays item_offsets, item_key, item_slot,
// split_key, split_offsets (pointers), then n_items, n_split, n_slots.
extern "C" int segment_sum_f32(const void* vals, const void* order, const void* const* plan,
                               long long n_items, long long n_split, long long n_slots,
                               void* part, void* out, long long K, long long n,
                               long long n_keys, long long C, void* stream) {
  const Plan pl{(const int*)plan[0], (const int*)plan[1], (const int*)plan[2],
                (const int*)plan[3], (const int*)plan[4], n_items, n_split, n_slots};
  return (int)launch<float>((const float*)vals, (const int*)order, pl, (float*)part,
                            (float*)out, K, n, n_keys, C, (cudaStream_t)stream);
}

extern "C" int segment_sum_bf16(const void* vals, const void* order, const void* const* plan,
                                long long n_items, long long n_split, long long n_slots,
                                void* part, void* out, long long K, long long n,
                                long long n_keys, long long C, void* stream) {
  const Plan pl{(const int*)plan[0], (const int*)plan[1], (const int*)plan[2],
                (const int*)plan[3], (const int*)plan[4], n_items, n_split, n_slots};
  return (int)launch<__nv_bfloat16>((const __nv_bfloat16*)vals, (const int*)order, pl,
                                    (float*)part, (float*)out, K, n, n_keys, C,
                                    (cudaStream_t)stream);
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
