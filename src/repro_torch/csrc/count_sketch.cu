// Count sketch (signed scatter-add into k buckets) and its unsketch, written for Hopper (sm_90a).
//
//   sketch[j] = Σ_t [h(t) = j] · s(t) · x[t],      t = 0 .. n − 1,
//
// into a float32 sketch of k buckets.  Two forms of the same sum:
// - the arrays form takes the buckets h(t) (int32) and the signs s(t)
//   (float32) as arrays, as the TPU kernel does;
// - the hashed form computes them from t in 32-bit words, the
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
// have k up to 2²⁵.
//
// Bound: bytes.  The sketch reads x (4n bytes) and writes the sketch (4k
// bytes): 0.343 ms at n = 253,755,392, k = 2²⁵ at 3.35 TB/s; the unsketch
// reads x and the sketch and writes est and state (12n + 4k bytes).  What
// costs is not the bytes but where the random adds land: the first design,
// one RED an element into a sketch larger than the 50 MB L2, paid a 32-byte
// sector of device memory for each and ran 30× above the bound at 2²⁵
// (10.2 ms, NVIDIA H100 80GB HBM3 at 700 W).  So the route goes by the
// sketch's size (the wrapper's ops.plan):
// - shared memory (k ≤ 2¹⁴): each block sums a tile of x into a sketch in
//   its shared memory with shared atomics and writes it whole with plain
//   stores, either as the result (one block: no memset, no second launch)
//   or as one partial of several that a second kernel sums in block order.
// - bins (hashed form, 2²³ ≤ k ≤ 2²⁵): the buckets are cut into bins of
//   2¹⁵ (128 KiB).  A count of the elements a bin (hashes only), a scan, then
//   a scatter: each block ranks a tile's elements within their bins with
//   shared atomics, reserves each bin's run of a pairs array (one global
//   atomic a bin), sorts the tile's (bucket, value) pairs by bin in shared
//   memory and writes every run contiguously; last, one block a bin sums
//   its pairs into a shared-memory sketch and stores it whole.  This moves
//   20n + 4k bytes (x, the pairs written and read, the sketch) with no
//   global RED: 1.5 ms of bytes at 2²⁵; it took 3.05 ms there, 1.02 at 2²⁴
//   and 0.71 at 2²³, against 4.40, 1.30 and 0.81 for slabs, and 0.18 at
//   2²¹, against 0.15 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 1).
// - slabs (any other k): the buckets are cut into slabs of at most 2²³
//   (32 MiB) that L2 holds, and the grid's blocks are work items (slab, tile
//   of x) in slab-major order: blocks start in index order, so the running
//   blocks add into one or two slabs at a time, and their REDs hit L2
//   (sent with an evict-last policy, x read with evict-first loads); x is
//   read once a slab.  L2 took 58–78 G REDs a second here (2²⁵ in four
//   slabs, 2²¹ in one), which bounds this route at the large sketches.
// The adds are atomics, so a bucket's sum order is not fixed: two runs may
// differ in the last bits, and each bucket j is held to 2⁻²³ · m_j · W_j of
// the float64 sum (m_j terms, W_j = Σ|x_t| over them).  The unsketch is a
// gather from the sketch; it does the reference's two float32 products in
// order and equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // slab route and unsketch: threads a block
constexpr int kPerThread = 16;                // ... elements a thread: a work item is 4,096
constexpr long long kItem = (long long)kThreads * kPerThread;
constexpr long long kMaxBlocks = 132 * 32;      // unsketch: a grid-stride loop, 32 blocks an SM
constexpr int kSmemThreads = 1024;            // shared-memory route: threads a block
constexpr int kSmemMaxK = 1 << 14;            // ... buckets it holds (64 KiB)
constexpr int kBinBits = 15;                  // bins route: buckets of a bin (128 KiB of shared)
constexpr int kBinsMax = 1024;                // ... most bins (k ≤ 2²⁵)
constexpr int kBinThreads = 1024;             // ... threads a block
constexpr int kBinPerThread = 16;             // ... scatter: elements a thread
constexpr long long kBinTile = (long long)kBinThreads * kBinPerThread;
constexpr long long kCountTile = 1LL << 18;   // ... count: elements a block

struct Hash {
  uint32_t a, b, a2, b2;
  int shift;
  __device__ __forceinline__ uint32_t bucket(uint32_t t) const { return (a * t + b) >> shift; }
  __device__ __forceinline__ float sign(uint32_t t) const {
    return ((a2 * t + b2) >> 31) ? -1.f : 1.f;
  }
};

// The two element sources: bucket(t) first, value(t) only where it is needed.
struct Hashed {
  const float* x;
  Hash h;
  __device__ __forceinline__ uint32_t bucket(uint32_t t) const { return h.bucket(t); }
  __device__ __forceinline__ float value(uint32_t t) const { return __ldcs(x + t) * h.sign(t); }
};

struct Arrays {
  const float* x;
  const int* buckets;
  const float* signs;
  __device__ __forceinline__ uint32_t bucket(uint32_t t) const {
    return (uint32_t)__ldcs(buckets + t);
  }
  __device__ __forceinline__ float value(uint32_t t) const {
    return __ldcs(x + t) * __ldcs(signs + t);
  }
};

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void red_add(float* p, float v, uint64_t policy) {
  asm volatile("red.relaxed.gpu.global.add.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(p), "f"(v), "l"(policy) : "memory");
}

// Block b sums x[b·tile, min(n, (b+1)·tile)) into a shared sketch and
// stores it at out + b·k.  Four elements a thread are loaded before their
// four adds, so the loads overlap.
template <class Src>
__global__ void __launch_bounds__(kSmemThreads)
count_sketch_smem_kernel(const Src src, float* out, long long n, int k, long long tile) {
  extern __shared__ float sk[];
  for (int j = threadIdx.x; j < k; j += kSmemThreads) sk[j] = 0.f;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * tile;
  const long long t1 = t0 + tile < n ? t0 + tile : n;
  for (long long base = t0 + threadIdx.x; base < t1; base += 4LL * kSmemThreads) {
    uint32_t j[4];
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long t = base + (long long)i * kSmemThreads;
      j[i] = t < t1 ? src.bucket((uint32_t)t) : 0u;
      v[i] = t < t1 ? src.value((uint32_t)t) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (base + (long long)i * kSmemThreads < t1) atomicAdd(sk + j[i], v[i]);
  }
  __syncthreads();
  float* dst = out + (long long)blockIdx.x * k;
  for (int j = threadIdx.x; j < k; j += kSmemThreads) dst[j] = sk[j];
}

// out[j] = Σ_p partials[p·k + j], p = 0 .. parts − 1 in order.
__global__ void __launch_bounds__(kThreads)
count_sketch_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int parts,
                           int k) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= k) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += partials[(long long)p * k + j];
  out[j] = acc;
}

// Work item blockIdx.x = slab · items + tile: the tile's elements whose
// bucket lies in the slab (bucket >> slab_shift == slab) are added.
template <class Src>
__global__ void __launch_bounds__(kThreads)
count_sketch_slab_kernel(const Src src, float* out, long long n, int slab_shift, long long items) {
  const uint32_t slab = (uint32_t)(blockIdx.x / items);
  const long long t0 = (blockIdx.x % items) * kItem + threadIdx.x;
  const uint64_t policy = evict_last_policy();
#pragma unroll 4
  for (int i = 0; i < kPerThread; ++i) {
    const long long t = t0 + (long long)i * kThreads;
    if (t < n) {
      const uint32_t j = src.bucket((uint32_t)t);
      if ((j >> slab_shift) == slab) red_add(out + j, src.value((uint32_t)t), policy);
    }
  }
}

// s(t)·sk[h(t)] rounded, then times scale rounded: the reference's two
// products.  __fmul_rn keeps the compiler from fusing the second product into
// the subtraction x − est (an FMA would skip est's rounding).
__device__ __forceinline__ float estimate(const float* sk, const Hash& h, uint32_t j, uint32_t t,
                                          float scale) {
  return __fmul_rn(h.sign(t) * __ldg(sk + j), scale);
}

// One element a thread a step over a grid-stride loop: at (253,755,392,
// 2²⁵) this ran in 5.9 ms, against 7.6 ms for four elements a thread
// through 16-byte accesses; the slab route's work items, with or without
// slab-major passes (which store est and state in partial sectors), were
// slower still.  The random gathers are the limit.
__global__ void __launch_bounds__(kThreads)
unsketch_kernel(const float* x, const float* sk, float* est, float* state, long long n,
                const Hash h, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n; t += stride) {
    const uint32_t u = (uint32_t)t;
    const float e = estimate(sk, h, h.bucket(u), u, scale);
    if (state) state[t] = x[t] - e;             // x[t] read before est[t] (it may be x) is written
    est[t] = e;
  }
}

// The bins route (hashed form): the buckets are cut into bins of 2^kBinBits,
// the elements are partitioned by bin into (bucket, value) pairs, and one
// block a bin sums its pairs into a shared-memory sketch.
// 1. cnt[bin] = the elements of the bin (hashes only, no x).
__global__ void __launch_bounds__(kBinThreads)
count_sketch_bin_count_kernel(const Hash h, long long n, int nbins, unsigned* cnt) {
  __shared__ unsigned hist[kBinsMax];
  for (int i = threadIdx.x; i < nbins; i += kBinThreads) hist[i] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * kCountTile;
  const long long t1 = t0 + kCountTile < n ? t0 + kCountTile : n;
  for (long long t = t0 + threadIdx.x; t < t1; t += kBinThreads)
    atomicAdd(hist + (h.bucket((uint32_t)t) >> kBinBits), 1u);
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kBinThreads)
    if (hist[i]) atomicAdd(cnt + i, hist[i]);
}

// The exclusive prefix of v over the block's 1,024 threads (thread order),
// and the sum in *total.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warp_sums, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned excl = x - v + (warp ? warp_sums[warp - 1] : 0u);
  *total = warp_sums[31];
  return excl;
}

// 2. start[bin] = Σ cnt of the bins before it (start[nbins] = n); cursor = start.
__global__ void __launch_bounds__(kBinThreads)
count_sketch_bin_scan_kernel(const unsigned* cnt, unsigned* start, unsigned* cursor, int nbins) {
  __shared__ unsigned warp_sums[32];
  const int i = threadIdx.x;
  unsigned total;
  const unsigned e = block_scan(i < nbins ? cnt[i] : 0u, warp_sums, &total);
  if (i < nbins) start[i] = cursor[i] = e;
  if (i == 0) start[nbins] = total;
}

// 3. A block takes a tile of x, ranks its elements within their bins
// (shared atomics), reserves each bin's run of the output (one global atomic
// a bin), sorts the tile's pairs by bin in shared memory and writes each
// bin's run contiguously.
__global__ void __launch_bounds__(kBinThreads)
count_sketch_bin_scatter_kernel(const float* x, const Hash h, long long n, int nbins,
                                unsigned* cursor, uint2* pairs) {
  extern __shared__ uint2 staged[];                      // [kBinTile], sorted by bin
  __shared__ unsigned hist[kBinsMax], offs[kBinsMax], base[kBinsMax], warp_sums[32];
  const int tid = threadIdx.x;
  for (int i = tid; i < nbins; i += kBinThreads) hist[i] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * kBinTile + tid;
  uint32_t j[kBinPerThread];
  float val[kBinPerThread];
  unsigned rank[kBinPerThread];
#pragma unroll
  for (int e = 0; e < kBinPerThread; ++e) {
    const long long t = t0 + (long long)e * kBinThreads;
    j[e] = h.bucket((uint32_t)t);
    val[e] = t < n ? __ldcs(x + t) * h.sign((uint32_t)t) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kBinPerThread; ++e)
    if (t0 + (long long)e * kBinThreads < n) rank[e] = atomicAdd(hist + (j[e] >> kBinBits), 1u);
  __syncthreads();
  unsigned total;
  const unsigned c = tid < nbins ? hist[tid] : 0u;
  const unsigned o = block_scan(c, warp_sums, &total);
  if (tid < nbins) {
    offs[tid] = o;
    if (c) base[tid] = atomicAdd(cursor + tid, c);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kBinPerThread; ++e)
    if (t0 + (long long)e * kBinThreads < n)
      staged[offs[j[e] >> kBinBits] + rank[e]] = make_uint2(j[e], __float_as_uint(val[e]));
  __syncthreads();
  for (unsigned p = tid; p < total; p += kBinThreads) {
    const uint2 q = staged[p];
    const unsigned bin = q.x >> kBinBits;
    pairs[base[bin] + (p - offs[bin])] = q;
  }
}

// 4. Block b sums bin b's pairs into a shared sketch and stores it whole.
__global__ void __launch_bounds__(kBinThreads)
count_sketch_bin_sum_kernel(const uint2* pairs, const unsigned* start, float* out) {
  constexpr int kB = 1 << kBinBits;
  extern __shared__ float bin_sk[];                      // [kB]
  for (int i = threadIdx.x; i < kB; i += kBinThreads) bin_sk[i] = 0.f;
  __syncthreads();
  const unsigned p1 = start[blockIdx.x + 1];
  for (unsigned p = start[blockIdx.x] + threadIdx.x; p < p1; p += 4 * kBinThreads) {
    uint2 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = p + i * kBinThreads < p1 ? __ldcs(pairs + p + i * kBinThreads) : make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p + i * kBinThreads < p1)
        atomicAdd(bin_sk + (q[i].x & (kB - 1)), __uint_as_float(q[i].y));
  }
  __syncthreads();
  float* dst = out + (long long)blockIdx.x * kB;
  for (int i = threadIdx.x; i < kB; i += kBinThreads) dst[i] = bin_sk[i];
}

// The items of the slab route: (k >> slab_shift) slabs of ⌈n / kItem⌉ tiles.
int slab_grid(long long n, int shift, int slab_shift, long long* items, unsigned* blocks) {
  const int k_bits = 32 - shift;
  if (slab_shift < 1 || slab_shift > k_bits) return (int)cudaErrorInvalidValue;
  *items = (n + kItem - 1) / kItem;
  const long long total = *items << (k_bits - slab_shift);
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)total;
  return 0;
}

template <class Src>
int sketch(const Src& src, float* out, float* partials, long long n, int shift, long long tile,
           int parts, int slab_shift, cudaStream_t stream) {
  if (n <= 0 || n > 0x7fffffffLL || shift < 1 || shift > 31) return (int)cudaErrorInvalidValue;
  const int k_bits = 32 - shift;
  if (tile > 0) {                                      // shared-memory route
    const int k = 1 << k_bits;
    if (k > kSmemMaxK || parts < 1 || (long long)parts * tile < n
        || (parts > 1 && partials == nullptr))
      return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(float) * k;
    cudaError_t err = cudaFuncSetAttribute(count_sketch_smem_kernel<Src>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    count_sketch_smem_kernel<Src><<<parts, kSmemThreads, bytes, stream>>>(
        src, parts > 1 ? partials : out, n, k, tile);
    if (parts > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      count_sketch_reduce_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          partials, out, parts, k);
    }
    return (int)cudaGetLastError();
  }
  long long items;
  unsigned blocks;
  const int rc = slab_grid(n, shift, slab_shift, &items, &blocks);
  if (rc) return rc;
  count_sketch_slab_kernel<Src><<<blocks, kThreads, 0, stream>>>(src, out, n, slab_shift, items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of a launch.  The caller checks that
// n < 2³¹, that out has k = 2^(32 − shift) floats and, for the arrays form,
// that every bucket lies in [0, k).  Route: tile > 0 takes shared memory
// (k ≤ 2¹⁴; parts blocks of tile elements, parts · tile ≥ n; with parts > 1
// the partials scratch holds parts · k floats), out written whole; tile = 0
// takes the slabs of 2^slab_shift buckets into a zeroed out.

int count_sketch_scatter(const float* x, const int* buckets, const float* signs, float* out,
                         float* partials, long long n, int shift, long long tile, int parts,
                         int slab_shift, void* stream) {
  return sketch(Arrays{x, buckets, signs}, out, partials, n, shift, tile, parts, slab_shift,
                (cudaStream_t)stream);
}

int count_sketch_hashed(const float* x, float* out, float* partials, long long n, unsigned a,
                        unsigned b, unsigned a2, unsigned b2, int shift, long long tile,
                        int parts, int slab_shift, void* stream) {
  return sketch(Hashed{x, Hash{a, b, a2, b2, shift}}, out, partials, n, shift, tile, parts,
                slab_shift, (cudaStream_t)stream);
}

// The bins route of the hashed form: 2^15 < k ≤ 2²⁵ (shift 7 .. 16), scratch
// of 2n + 3·(k >> 15) + 1 32-bit words (the pairs, then the bins' counts,
// starts and cursors); out is written whole.
int count_sketch_hashed_bins(const float* x, float* out, unsigned* scratch, long long n,
                             unsigned a, unsigned b, unsigned a2, unsigned b2, int shift,
                             void* stream) {
  const int k_bits = 32 - shift;
  if (n <= 0 || n > 0x7fffffffLL || k_bits <= kBinBits || (1 << (k_bits - kBinBits)) > kBinsMax)
    return (int)cudaErrorInvalidValue;
  const int nbins = 1 << (k_bits - kBinBits);
  const Hash h{a, b, a2, b2, shift};
  cudaStream_t st = (cudaStream_t)stream;
  uint2* pairs = reinterpret_cast<uint2*>(scratch);
  unsigned* cnt = scratch + 2 * n;
  unsigned* start = cnt + nbins;
  unsigned* cursor = start + nbins + 1;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(unsigned) * nbins, st);
  if (err != cudaSuccess) return (int)err;
  count_sketch_bin_count_kernel<<<(unsigned)((n + kCountTile - 1) / kCountTile), kBinThreads, 0,
                                  st>>>(h, n, nbins, cnt);
  count_sketch_bin_scan_kernel<<<1, kBinThreads, 0, st>>>(cnt, start, cursor, nbins);
  const int stage_bytes = (int)(sizeof(uint2) * kBinTile);
  const int sum_bytes = (int)sizeof(float) << kBinBits;
  err = cudaFuncSetAttribute(count_sketch_bin_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(count_sketch_bin_sum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, sum_bytes);
  if (err != cudaSuccess) return (int)err;
  count_sketch_bin_scatter_kernel<<<(unsigned)((n + kBinTile - 1) / kBinTile), kBinThreads,
                                    stage_bytes, st>>>(x, h, n, nbins, cursor, pairs);
  count_sketch_bin_sum_kernel<<<nbins, kBinThreads, sum_bytes, st>>>(pairs, start, out);
  return (int)cudaGetLastError();
}

int count_sketch_unsketch(const float* x, const float* sk, float* est, float* state, long long n,
                          unsigned a, unsigned b, unsigned a2, unsigned b2, int shift, float scale,
                          void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || shift < 1 || shift > 31) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Hash h{a, b, a2, b2, shift};
  unsketch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(x, sk, est, state, n,
                                                                          h, scale);
  return (int)cudaGetLastError();
}

const char* count_sketch_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
