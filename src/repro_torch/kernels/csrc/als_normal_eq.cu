// ALS normal-equation accumulation for Hopper (sm_90a).
//
// Replaces repro/kernels/als_normal_eq.py::_als_kernel, the Pallas TPU
// kernel behind als_normal_eq / als_normal_eq_bucketed /
// als_normal_eq_batched.  For every row v of a [Nv, W] block, with
// X_j = x[nbrs[v, j]] (a row of d float32 values) and m = mask[v, j],
//
//     A[v, i, k] = sum_{j = 0..W-1} (X_j[i] * m) * X_j[k]     [d, d]
//     b[v, i]    = sum_{j = 0..W-1} (X_j[i] * m) * r[v, j]     [d]
//
// in float32, slots added in the order j = 0, 1, ..., W-1, each product
// rounded before it is added: __fmul_rn/__fadd_rn, so nvcc cannot
// contract them into an FMA.  The port's plain version (an eager slot
// loop on the CPU) does the same IEEE operations in the same order, so
// the two are bitwise equal.
//
// Masked slots are skipped, and the plain version skips them the same
// way.  For finite x this is bitwise what the TPU kernel computes: a
// masked slot adds (x * 0) * x = +-0 to an accumulator that started at
// +0 and so can never be -0, which leaves it unchanged; and an unmasked
// slot's x * 1 is x exactly, so the kernel multiplies X_j[i] * X_j[k]
// directly.  (A non-finite x at a masked slot would make the TPU
// kernel's sum NaN; here it is never read.)  Out-of-range neighbour ids
// read the nearest row, as XLA's gather clamps.
//
// What bounds it on an H100.  A real slot reads a d-wide row of x (4d
// bytes, gathered), a mask byte, a rating and (outside the fold) an
// index; A is symmetric, so the function needs d(d+1)/2 + d products
// and as many adds a slot: at d = 20, 230 of each for 89 bytes, under
// the card's float32 flop-to-byte ratio, so bytes bound it; at d = 64,
// 2,144 for 265 bytes, so the float32 pipes do.  Unfused, a product
// and its add are two instructions, so this contract reaches at most
// half of the published 67 TFLOP/s.
//
// The design:
//
// * the outputs are the upper triangle of the d x (d + 1) matrix
//   [A | b] (i <= k; column d is b).  x_i * x_k and x_k * x_i are the
//   same IEEE product added in the same order, so A[k, i] == A[i, k]
//   bitwise and the lower triangle is a mirror of the upper one;
// * register tiles: a thread owns a 4 x 4 tile of that triangle (tiles
//   in row-major order; a tile on the diagonal also computes the few
//   entries below it and does not store them) and keeps its 16 float32
//   accumulators in registers across the whole row.  Per slot it reads
//   its tile's 4 row values and 4 column values from shared memory as
//   two 16-byte loads, for 16 products: 20 tiles at d = 20 (one warp a
//   row, ALS_ROWS_PER_BLOCK rows a block), 152 at d = 64 (five warps a
//   row, one row a block);
// * the real slots of a row are compacted without block barriers: the
//   row's warps scan its mask in windows of ALS_WIN slots (each lane
//   reads ALS_WIN / 32 mask bytes as one aligned word, ALS_CHUNK
//   windows loaded at once, the next chunk one ahead), and a ballot per
//   byte gives every real slot its place in slot order.  Each lane
//   copies its real slots' rows of x and their ratings straight into
//   shared memory with cp.async (16 bytes at a time where d % 4 == 0
//   and x is aligned), a staged row being d values, the rating in
//   column d, and a stride of a multiple of 4 floats;
// * two staging buffers a row: the copies of the next non-empty window
//   fly while the current one is computed, and one barrier a window
//   (__syncwarp where a warp owns the row, __syncthreads where five
//   warps do) separates the two;
// * a row with no real slot writes its zeros after the mask scan and
//   does nothing else;
// * the fold needs no index: a bucket without nbrs reads slot j of row
//   v at row v * W + j of x, the gathered scope viewed as [Nv * W, d];
// * one launch takes a table of up to ALS_MAX_BUCKETS buckets (passed
//   by value), each with its own rows, width, x and output offset;
//   blocks are dealt to (bucket, rows) from a host prefix, widest
//   bucket first;
// * the finished tile is mirrored into shared memory and the row's
//   threads write A and b out coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ALS_WIN
#define ALS_WIN 32                  // mask slots a window scans: 32, 64, 128
#endif
#ifndef ALS_CHUNK
#define ALS_CHUNK 4                 // windows of mask loaded at once
#endif
#ifndef ALS_UNROLL
#define ALS_UNROLL 4                // staged slots a compute step unrolls
#endif
#ifndef ALS_ROWS_PER_BLOCK
#define ALS_ROWS_PER_BLOCK 4        // rows a block takes where a warp owns one
#endif
#define ALS_MAX_BUCKETS 16

// file scope, not in the anonymous namespace: the extern "C" entry takes
// a pointer to it and must keep external linkage
struct AlsBucket {
  const int32_t* nbrs;     // [n_rows, width]; null: the identity gather
  const uint8_t* mask;     // [n_rows, width] bool
  const float* ratings;    // [n_rows, width]
  const float* x;          // [n_src, d]
  int64_t n_src;
  int64_t n_rows;
  int64_t out_row;         // the bucket's first row of A and b
  int64_t block_start;     // its first block
  int32_t width;
  int32_t pad;
};

struct AlsTable {
  AlsBucket b[ALS_MAX_BUCKETS];
  int32_t n;
};

namespace {

constexpr int kWin = ALS_WIN;
constexpr int kBytes = kWin / 32;   // mask bytes a lane reads a window
constexpr int kChunk = ALS_CHUNK;
constexpr int kUnroll = ALS_UNROLL;
constexpr int kRowsPerBlock = ALS_ROWS_PER_BLOCK;
constexpr int kMaxD = 64;
constexpr int kMaxWarps = 5;        // warps a row takes at d = 64
static_assert(kBytes == 1 || kBytes == 2 || kBytes == 4,
              "ALS_WIN is 32, 64 or 128");
static_assert(kChunk >= 1 && kChunk <= 8, "ALS_CHUNK is 1..8");

template <int N> struct MaskWord;
template <> struct MaskWord<1> { using T = unsigned char; };
template <> struct MaskWord<2> { using T = unsigned short; };
template <> struct MaskWord<4> { using T = unsigned int; };

// a staged row: d values, the rating, padding to a multiple of 4 floats
__host__ __device__ constexpr int stride_of(int d) { return (d + 4) & ~3; }

// 4 x 4 tiles of the upper triangle of [A | b]
__host__ __device__ constexpr int tiles_of(int d) {
  return ((d + 3) / 4) * (stride_of(d) / 4)
         - ((d + 3) / 4) * ((d + 3) / 4 - 1) / 2;
}

__host__ __device__ constexpr int warps_of(int d) {
  return (tiles_of(d) + 31) / 32;
}

__host__ __device__ constexpr int rows_of(int warps) {
  return warps == 1 ? kRowsPerBlock : 1;
}

static_assert(warps_of(kMaxD) == kMaxWarps, "the launch's switch");

__host__ __device__ constexpr size_t smem_of(int d) {
  return static_cast<size_t>(rows_of(warps_of(d))) * 2 * kWin * stride_of(d)
         * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::
                   "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 1) __syncwarp();
  else __syncthreads();            // one row a block
}

template <int G>
__global__ void __launch_bounds__(32 * G * rows_of(G))
als_normal_eq_kernel(const __grid_constant__ AlsTable table,
                     float* __restrict__ a_out, float* __restrict__ b_out,
                     int32_t d) {
  using Word = typename MaskWord<kBytes>::T;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / G;              // the block's row
  const int wig = warp - group * G;        // warp in the row's group
  const int tid = wig * 32 + lane;         // thread in the row's group

  int e = 0;
  while (e + 1 < table.n && table.b[e + 1].block_start <= blockIdx.x) ++e;
  const int64_t v = (static_cast<int64_t>(blockIdx.x) - table.b[e].block_start)
                    * rows_of(G) + group;
  if (v >= table.b[e].n_rows) return;      // uniform over a row's warps
  const int32_t* nbrs = table.b[e].nbrs;
  const float* ratings = table.b[e].ratings;
  const float* x = table.b[e].x;
  const int64_t n_src = table.b[e].n_src;
  const int width = table.b[e].width;
  const int64_t out = table.b[e].out_row + v;
  const int64_t row_off = v * width;

  const int stride = stride_of(d);
  const int ct = stride >> 2;
  const int n_tiles = tiles_of(d);
  float* buf = smem + static_cast<size_t>(group) * 2 * kWin * stride;
  float* a_dst = a_out + out * d * d;
  float* b_dst = b_out + out * d;

  // this thread's tile: rows 4ti.., columns 4tk.. of [A | b]; threads past
  // the last tile compute the last one again and store nothing
  const bool owner = tid < n_tiles;
  int ti = 0, tk = owner ? tid : n_tiles - 1;
  while (tk >= ct - ti) {
    tk -= ct - ti;
    ++ti;
  }
  tk += ti;

  // the mask as aligned words: lane l of window c holds slots
  // c * kWin + l * kBytes - off0 + (0 .. kBytes - 1)
  const uint8_t* mrow = table.b[e].mask + row_off;
  const int off0 =
      static_cast<int>(reinterpret_cast<uintptr_t>(mrow) & (kBytes - 1));
  const Word* words = reinterpret_cast<const Word*>(mrow - off0);
  const int n_win = (width + off0 + kWin - 1) / kWin;
  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  auto load_chunk = [&](int k, uint32_t (&w)[kChunk]) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int c = k * kChunk + i;
      w[i] = c < n_win && c * kWin + lane * kBytes - off0 < width
                 ? static_cast<uint32_t>(__ldg(words + c * 32 + lane))
                 : 0u;
    }
  };
  uint32_t wq[kChunk], wn[kChunk];
  load_chunk(0, wq);
  load_chunk(1, wn);

  // one real slot: its row of x and its rating into a staged row
  auto copy_slot = [&](int j, float* dst) {
    const int64_t s = row_off + j;
    int64_t src = s;                       // the identity gather
    if (nbrs != nullptr) {
      src = __ldg(nbrs + s);
      src = src < 0 ? 0 : (src >= n_src ? n_src - 1 : src);
    }
    const float* xr = x + src * d;
    if (vec) {
      for (int f = 0; f < d; f += 4) cp_async16(dst + f, xr + f);
    } else {
      for (int f = 0; f < d; ++f) cp_async4(dst + f, xr + f);
    }
    cp_async4(dst + d, ratings + s);
  };

  // the next window with a real slot: compact its real slots in slot
  // order (lane by lane, byte by byte within a lane), copy this thread's
  // share of them into dst and return their number; 0 at the row's end
  int c = 0;
  auto next = [&](float* dst) -> int {
    while (c < n_win) {
      if (c > 0 && c % kChunk == 0) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) wq[i] = wn[i];
        load_chunk(c / kChunk + 1, wn);
      }
      uint32_t word = wq[0];
#pragma unroll
      for (int i = 1; i < kChunk; ++i)
        if (c % kChunk == i) word = wq[i];
      const int j0 = c * kWin + lane * kBytes - off0;
      ++c;
      uint32_t bits = 0;
#pragma unroll
      for (int t = 0; t < kBytes; ++t) {
        const int j = j0 + t;
        if (((word >> (8 * t)) & 0xffu) != 0 && j >= 0 && j < width)
          bits |= 1u << t;
      }
      const unsigned below = (1u << lane) - 1u;
      int q = 0, n = 0;
#pragma unroll
      for (int t = 0; t < kBytes; ++t) {
        const unsigned ballot = __ballot_sync(0xffffffffu, (bits >> t) & 1u);
        q += __popc(ballot & below);
        n += __popc(ballot);
      }
      if (n == 0) continue;
#pragma unroll
      for (int t = 0; t < kBytes; ++t) {
        if ((bits >> t) & 1u) {
          if (G == 1 || q % G == wig) copy_slot(j0 + t, dst + q * stride);
          ++q;
        }
      }
      return n;
    }
    return 0;
  };

  int n = next(buf);
  cp_async_commit();
  if (n == 0) {                            // no real slot: zeros
    for (int p = tid; p < d * d; p += 32 * G) a_dst[p] = 0.0f;
    for (int p = tid; p < d; p += 32 * G) b_dst[p] = 0.0f;
    return;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  int cur = 0;
  while (n > 0) {
    cp_async_wait_all();
    group_sync<G>();                       // the window landed; the other
                                           // buffer is free again
    const int n_next = next(buf + (cur ^ 1) * kWin * stride);
    cp_async_commit();
    const float* s = buf + cur * kWin * stride;
#pragma unroll kUnroll
    for (int q = 0; q < n; ++q) {
      const float4 r = *reinterpret_cast<const float4*>(s + q * stride + 4 * ti);
      const float4 k = *reinterpret_cast<const float4*>(s + q * stride + 4 * tk);
      const float rv[4] = {r.x, r.y, r.z, r.w};
      const float kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(rv[a], kv[b]));
    }
    cur ^= 1;
    n = n_next;
  }

  // mirror the tile into shared memory ([d][d] A, then b), then write out
  group_sync<G>();
  float* o = buf;
  if (owner) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * tk + b;
        if (i >= d || k < i) continue;     // below the diagonal: mirrored
        if (k < d) {
          o[i * d + k] = acc[a][b];
          o[k * d + i] = acc[a][b];
        } else if (k == d) {
          o[d * d + i] = acc[a][b];
        }
      }
    }
  }
  group_sync<G>();
  for (int p = tid; p < d * d; p += 32 * G) a_dst[p] = o[p];
  for (int p = tid; p < d; p += 32 * G) b_dst[p] = o[d * d + p];
}

template <int G>
int launch(const AlsTable* t, int64_t n_blocks, int32_t d, void* a, void* b,
           cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    size_t most = 0;
    for (int dd = 1; dd <= kMaxD; ++dd)
      if (warps_of(dd) == G && smem_of(dd) > most) most = smem_of(dd);
    const cudaError_t err = cudaFuncSetAttribute(
        als_normal_eq_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  als_normal_eq_kernel<G><<<static_cast<unsigned int>(n_blocks),
                            32 * G * rows_of(G), smem_of(d), stream>>>(
      *t, static_cast<float*>(a), static_cast<float*>(b), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The geometry the wrapper plans with: warps a row, rows a block, the
// mask window, the table's bucket limit and size.  Returns
// cudaErrorInvalidValue (and no row geometry) outside 1 <= d <= 64.
int als_normal_eq_geometry(int32_t d, int32_t* warps_per_row,
                           int32_t* rows_per_block, int32_t* window,
                           int32_t* max_buckets, int64_t* table_bytes) {
  *window = kWin;
  *max_buckets = ALS_MAX_BUCKETS;
  *table_bytes = static_cast<int64_t>(sizeof(AlsTable));
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  *warps_per_row = warps_of(d);
  *rows_per_block = rows_of(warps_of(d));
  return 0;
}

// One launch over every bucket of *table (1 <= n <= ALS_MAX_BUCKETS, in
// launch order, block_start ascending), float32 only, mask bool (one
// byte a slot), 1 <= d <= 64; A [rows, d, d] and b [rows, d] are written
// at each bucket's out_row.  Returns the cudaError_t of the launch.
int als_normal_eq_launch(const AlsTable* table, int64_t n_blocks, int32_t d,
                         void* a, void* b, void* stream) {
  if (d < 1 || d > kMaxD || table->n <= 0 || table->n > ALS_MAX_BUCKETS ||
      n_blocks <= 0 || n_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warps_of(d)) {
    case 1: return launch<1>(table, n_blocks, d, a, b, s);
    case 2: return launch<2>(table, n_blocks, d, a, b, s);
    case 3: return launch<3>(table, n_blocks, d, a, b, s);
    case 4: return launch<4>(table, n_blocks, d, a, b, s);
    case 5: return launch<5>(table, n_blocks, d, a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* als_normal_eq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
