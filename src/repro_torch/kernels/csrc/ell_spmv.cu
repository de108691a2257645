// Sliced-ELL neighbour aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmv.py:48
// (_spmv_kernel), the body of ell_spmv / ell_spmv_bucketed /
// ell_spmv_batched / ell_fold.  For every row v of every bucket of a
// table (a bucket is one [Nv, W] block of the sliced ELL) it computes
//
//     y[v, f] = sum_{j = 0..W-1} (w[v, j] * m[v]) * x[clamp(nbrs[v, j]), f]
//
// with m the optional row mask (a masked row is computed as weight * 0,
// not skipped, so a non-finite x still gives NaN), slots added in the
// order j = 0, 1, ..., W-1, each product rounded in the input type
// before it is widened, a float32 accumulator, and the result rounded
// to x's type.  For float32 the products and adds are __fmul_rn /
// __fadd_rn, never an FMA: the port's dense fallback and its kernel path
// reduce through this kernel, and its CPU path (an eager slot loop)
// does the same IEEE operations in the same order, which is what makes
// all three bitwise equal.
//
// What bounds it on an H100.  At F = 1 (PageRank) each slot moves an
// index and a weight (8 bytes) and gathers one value of x for two flops,
// so the function is bound by bytes: a PageRank sweep of the
// 2,097,152-vertex graph streams 12.5M slots (100 MB) and gathers 9.07M
// real ones from an 8 MB x that the 50 MB L2 holds.  Before this design
// one thread computed one output element, walking its row's W slots in
// series: index load, then the gather that depends on it, then the add.
// For the wide buckets (W = 128, 256: ~10k rows, 39 blocks) nothing
// else was in flight, so a row cost about W gather latencies and those
// buckets were bound by latency, not bytes; the slot loads of a warp
// touched 32 cache lines each step; and a sweep took one launch a
// bucket.  Now the random 4-byte gathers set the pace: each costs the
// L2 a 32-byte sector, and the sweep runs within ~10 % of PyTorch's own
// index_select of the same values (PERF.md, tools/ell_spmv_sweep.py).
//
// The mapping.  One launch covers every bucket of a table (at most
// ELL_MAX_BUCKETS, passed by value in the parameter space); blocks are
// dealt to (bucket, row tile) from a prefix of block counts that the
// host plans from the bucket shapes, widest bucket first so the blocks
// with the longest serial sums start first.  At F = 1 (ell_spmv_rows) a
// block takes a tile of R rows and gathers all of it in parallel: the W
// slots of a row are padded to a group of G = next_pow2(W) virtual
// slots (G capped at ELL_TILE, beyond which a row is taken in chunks of
// G), R = ELL_TILE / G rows make ELL_TILE virtual slots, and every
// thread takes ELL_TILE / ELL_THREADS of them in quads of consecutive
// slots.  Where a tile's slots are contiguous in memory (W = G, or a
// chunk of one row) a quad is one coalesced 16-byte load of indices and
// one of weights, with the streaming hint so x keeps the caches; other
// quads load slot by slot.  The gathers of a thread's quads do not
// depend on each other, so its whole share is in flight at once.  Each
// rounded product goes to shared memory (prod_stride: quads stored and
// rows read back 16 bytes at a time, without bank conflicts); then one
// thread a row adds its row's products in slot order.  A wide row thus
// costs W gathers in flight and W shared-memory adds, not W dependent
// round trips.  The adds stay serial on purpose: a tree, a shuffle
// reduction or atomics would change the order of the float32 adds and
// so the bits.  One mapping serves every width, so there is no
// narrow/wide threshold; ELL_TILE, ELL_THREADS and ELL_MIN_BLOCKS were
// chosen with tools/ell_spmv_sweep.py (every geometry that keeps 4 or
// more blocks an SM resident lands within ~1 % on the PageRank sweep).
// At F > 1 (ell_spmv_features) one thread computes one output element
// (row, feature), feature fastest: a warp's gathers of one neighbour row
// are coalesced and the index and weight loads are broadcasts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#ifndef ELL_TILE
#define ELL_TILE 2048          // virtual slots a block gathers in one pass
#endif
#ifndef ELL_THREADS
#define ELL_THREADS 256
#endif
#ifndef ELL_MIN_BLOCKS
#define ELL_MIN_BLOCKS 6       // resident blocks an SM the F = 1 body keeps
#endif
#define ELL_MAX_BUCKETS 16

static_assert((ELL_TILE & (ELL_TILE - 1)) == 0, "ELL_TILE: a power of two");
static_assert(ELL_TILE % (4 * ELL_THREADS) == 0,
              "ELL_TILE: whole quads for every thread");

// One bucket of a launch.  The layout is mirrored by ctypes in
// kernels/ell_spmv.py (_Bucket); outside the anonymous namespace, so
// that ell_spmv_launch, which takes a Table, keeps external linkage.
struct Bucket {
  const int32_t* nbrs;      // [n_rows, width]
  const void* w;            // [n_rows, width], T
  const void* mask;         // [n_rows]: bytes 0/1 (mask_kind 1), T (2), null (0)
  const void* x;            // [n_src, n_feat], T
  int64_t n_src;
  int64_t n_rows;
  int64_t out_row;          // the bucket's first row in y
  int64_t block_start;      // the bucket's first block in the grid
  int32_t width;
  int32_t lg_group;         // log2 G (F = 1)
  int32_t mask_kind;
  int32_t pad;
};

struct Table {
  Bucket b[ELL_MAX_BUCKETS];
  int32_t n;
};

namespace {

// Product rounded in the storage type T, then widened to float.
struct F32 {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float widen(T a) { return a; }
  static __device__ __forceinline__ T narrow(float a) { return a; }
  static __device__ __forceinline__ void load4(const T* p, T* o) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

struct BF16 {
  using T = __nv_bfloat16;
  // the float product of two bf16 values is exact, so this is one
  // rounding: the correctly rounded bf16 product
  static __device__ __forceinline__ T mul(T a, T b) {
    return __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ float widen(T a) {
    return __bfloat162float(a);
  }
  static __device__ __forceinline__ T narrow(float a) {
    return __float2bfloat16_rn(a);
  }
  static __device__ __forceinline__ void load4(const T* p, T* o) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(o, &v, sizeof(v));
  }
};

// Row stride of the products in shared memory.  G >= 4: a quad of
// slots lies in one row and is stored, and a row is read back, 16 bytes
// at a time; a stride of G + 4 (G >= 8) or 4 (G = 4) floats keeps S / 4
// odd, so the 8 lanes of a quarter warp reading 8 rows hit 8 different
// bank groups.  G <= 2: scalar, odd stride.
__device__ __forceinline__ int prod_stride(int G) {
  return G >= 8 ? G + 4 : (G == 4 ? 4 : (G | 1));
}

// The bucket of this block: the last whose first block is at or
// before blockIdx.x (entries in block order).
__device__ __forceinline__ int block_bucket(const Table& tab) {
  int b = 0;
  while (b + 1 < tab.n && blockIdx.x >= tab.b[b + 1].block_start) ++b;
  return b;
}

// F = 1: a tile of ELL_TILE >> lg_group rows, gathered in parallel,
// summed one thread a row in slot order.
template <typename A>
__global__ void __launch_bounds__(ELL_THREADS, ELL_MIN_BLOCKS)
ell_spmv_rows(const __grid_constant__ Table tab,
              typename A::T* __restrict__ y) {
  using T = typename A::T;
  constexpr int kQuads = ELL_TILE / (4 * ELL_THREADS);
  // R * prod_stride(G) <= 1.5 ELL_TILE (G = 2 and G = 8)
  __shared__ __align__(16) float prod[ELL_TILE + ELL_TILE / 2];
  const Bucket& bk = tab.b[block_bucket(tab)];
  const int lg = bk.lg_group;
  const int G = 1 << lg;
  const int R = ELL_TILE >> lg;
  const int S = prod_stride(G);
  const int W = bk.width;
  const int64_t row0 = (blockIdx.x - bk.block_start) * static_cast<int64_t>(R);
  const int rows = static_cast<int>(min(static_cast<int64_t>(R),
                                        bk.n_rows - row0));
  // clamp bound; nbrs are int32, so n_src beyond 2^31 never binds
  const int hi = static_cast<int>(min(bk.n_src - 1, static_cast<int64_t>(0x7fffffff)));
  const T* __restrict__ x = static_cast<const T*>(bk.x);
  const int mask_kind = bk.mask_kind;
  const uint8_t* __restrict__ mbytes = static_cast<const uint8_t*>(bk.mask) + row0;
  const T* __restrict__ mvals = static_cast<const T*>(bk.mask) + row0;
  // a tile's slots are contiguous when its rows have no padding to G
  // (W = G) or it is one row's chunk (W > G, R = 1)
  const bool contiguous = W >= G;
  float carry = 0.0f;                    // a chunked row's sum so far
  for (int c0 = 0;; c0 += G) {
    const int cc = min(G, W - c0);       // real slots of this pass
    // this pass's slots, at offsets r * W + j below 2^31 (R * W <= ELL_TILE)
    const int32_t* __restrict__ nb = bk.nbrs + (row0 * W + c0);
    const T* __restrict__ wt = static_cast<const T*>(bk.w) + (row0 * W + c0);
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int k0 = 4 * (threadIdx.x + i * ELL_THREADS);
      int r[4], j[4];
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = (k0 + e) >> lg;
        j[e] = (k0 + e) & (G - 1);
        ok[e] = j[e] < cc && r[e] < rows;
      }
      const int o0 = r[0] * W + j[0];
      int32_t s[4];
      T wv[4];
      // in a contiguous tile the valid slots are a prefix, so ok[3]
      // means the whole quad, at o0 .. o0 + 3
      if (contiguous && ok[3] &&
          ((reinterpret_cast<uintptr_t>(nb + o0) & 15) |
           (reinterpret_cast<uintptr_t>(wt + o0) & (4 * sizeof(T) - 1)))
              == 0) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(nb + o0));
        s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
        A::load4(wt + o0, wv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok[e]) {
            s[e] = __ldcs(nb + r[e] * W + j[e]);
            wv[e] = __ldcs(wt + r[e] * W + j[e]);
          }
        }
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = 0.0f;
        if (!ok[e]) continue;
        // out-of-range indices read the nearest row, as XLA's gather clamps
        const int se = min(max(s[e], 0), hi);
        T we = wv[e];
        if (mask_kind == 1)
          we = A::mul(we, A::narrow(mbytes[r[e]] ? 1.0f : 0.0f));
        else if (mask_kind == 2)
          we = A::mul(we, mvals[r[e]]);
                p[e] = A::widen(A::mul(we, __ldg(x + se)));
      }
      if (G >= 4) {
        if (ok[0])
          *reinterpret_cast<float4*>(prod + r[0] * S + j[0]) =
              make_float4(p[0], p[1], p[2], p[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok[e]) prod[r[e] * S + j[e]] = p[e];
      }
    }
    __syncthreads();
    const bool last = c0 + G >= W;
    for (int rr = threadIdx.x; rr < rows; rr += ELL_THREADS) {
      const float* pr = prod + rr * S;
      float acc = carry;
      if (G >= 4) {
        for (int jj = 0; jj < cc; jj += 4) {
          const float4 q = *reinterpret_cast<const float4*>(pr + jj);
          acc = __fadd_rn(acc, q.x);
          if (jj + 1 < cc) acc = __fadd_rn(acc, q.y);
          if (jj + 2 < cc) acc = __fadd_rn(acc, q.z);
          if (jj + 3 < cc) acc = __fadd_rn(acc, q.w);
        }
      } else {
        for (int jj = 0; jj < cc; ++jj) acc = __fadd_rn(acc, pr[jj]);
      }
      if (last)
        y[bk.out_row + row0 + rr] = A::narrow(acc);
      else
        carry = acc;
    }
    if (last) break;
    __syncthreads();
  }
}

// F > 1: one thread an output element, feature fastest.  kOne: a table
// of one bucket (every F > 1 call but a bucketed one), read at fixed
// offsets of the parameter space, so its pointers stay warp-uniform
// operands instead of taking registers (8 blocks an SM, not 6).
template <typename A, bool kOne>
__global__ void __launch_bounds__(ELL_THREADS)
ell_spmv_features(const __grid_constant__ Table tab,
                  typename A::T* __restrict__ y, int32_t n_feat) {
  using T = typename A::T;
  const Bucket& bk = tab.b[kOne ? 0 : block_bucket(tab)];
  const int64_t t = (blockIdx.x - bk.block_start) * static_cast<int64_t>(
      ELL_THREADS) + threadIdx.x;
  if (t >= bk.n_rows * n_feat) return;
  const int64_t v = t / n_feat;
  const int f = static_cast<int>(t - v * n_feat);
  const int W = bk.width;
  const int hi = static_cast<int>(min(bk.n_src - 1, static_cast<int64_t>(0x7fffffff)));
  const int32_t* __restrict__ nb = bk.nbrs + v * W;
  const T* __restrict__ wr = static_cast<const T*>(bk.w) + v * W;
  const T* __restrict__ xf = static_cast<const T*>(bk.x) + f;
  const int mask_kind = bk.mask_kind;
  T m = T();
  if (mask_kind == 1)
    m = A::narrow(static_cast<const uint8_t*>(bk.mask)[v] ? 1.0f : 0.0f);
  else if (mask_kind == 2)
    m = static_cast<const T*>(bk.mask)[v];
  float acc = 0.0f;
  for (int jj = 0; jj < W; ++jj) {
    // read-only loads spelled out: pointers from the table are not
    // __restrict__ kernel parameters, so nvcc would not infer them
    const int s = min(max(__ldg(nb + jj), 0), hi);
    T wj = __ldg(wr + jj);
    if (mask_kind) wj = A::mul(wj, m);       // gate the weight first
    acc = __fadd_rn(acc, A::widen(A::mul(
        wj, __ldg(xf + static_cast<int64_t>(s) * n_feat))));
  }
  y[(bk.out_row + v) * n_feat + f] = A::narrow(acc);
}

template <typename A>
int launch(const Table& tab, unsigned int grid, void* y, int32_t n_feat,
           cudaStream_t s) {
  using T = typename A::T;
  if (n_feat == 1)
    ell_spmv_rows<A><<<grid, ELL_THREADS, 0, s>>>(tab, static_cast<T*>(y));
  else if (tab.n == 1)
    ell_spmv_features<A, true><<<grid, ELL_THREADS, 0, s>>>(
        tab, static_cast<T*>(y), n_feat);
  else
    ell_spmv_features<A, false><<<grid, ELL_THREADS, 0, s>>>(
        tab, static_cast<T*>(y), n_feat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch over every bucket of *table (n <= ELL_MAX_BUCKETS, in
// block order, n_blocks in all).  y is [sum of n_rows, n_feat].
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success).
int ell_spmv_launch(const Table* table, int64_t n_blocks, void* y,
                    int32_t n_feat, int32_t dtype, void* stream) {
  if (n_blocks <= 0 || n_feat <= 0) return 0;
  if (table->n <= 0 || table->n > ELL_MAX_BUCKETS || n_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(n_blocks);
  switch (dtype) {
    case 0: return launch<F32>(*table, grid, y, n_feat, s);
    case 1: return launch<BF16>(*table, grid, y, n_feat, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The constants the host's planner and its ctypes table must match.
void ell_spmv_geometry(int32_t* tile, int32_t* threads, int32_t* max_buckets,
                       int64_t* table_bytes) {
  *tile = ELL_TILE;
  *threads = ELL_THREADS;
  *max_buckets = ELL_MAX_BUCKETS;
  *table_bytes = sizeof(Table);
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
