// ALS normal-equation accumulation for Hopper (sm_90a).
//
// Replaces repro/kernels/als_normal_eq.py::_als_kernel, the Pallas TPU
// kernel behind als_normal_eq / als_normal_eq_bucketed /
// als_normal_eq_batched.  For every row v of one [Nv, W] block, with
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
// kernel's sum NaN; here it is never read.)
//
// What bounds it on an H100: bytes at small d, operations at large d.
// A masked slot reads only its mask byte.  A real slot reads a d-wide
// row of x (4d bytes, gathered), an index, a mask byte and a rating,
// for 2d(d+1) flops: at d = 20 that is 89 bytes for 840 flops, under
// the card's float32 flop-to-byte ratio (67 TFLOP/s over 3.35 TB/s =
// 20), so bytes bound it; at d = 64, 265 bytes for 8,320 flops, so the
// float32 pipes do.  The design reads each gathered
// row once and only for real slots, and keeps the products on chip:
//
// * one block per row v.  The block walks its row in tiles of 32 slots.
//   Warp 0 reads a tile's mask, indices and ratings, and compacts the
//   real slots with a ballot, in slot order;
// * the block copies the real slots' rows of x into shared memory, a
//   [32, d + 1] tile whose last column holds the slot's rating, so A
//   and b are one d x (d + 1) matrix [A | b] of outputs;
// * each thread owns a fixed set of those d(d + 1) outputs, strided by
//   the block size, and keeps their float32 accumulators in registers
//   across the whole row: NPT outputs a thread (a template argument, so
//   the accumulators are registers), at most 512 threads a block.  A
//   warp's outputs are consecutive, so its reads of the tile are
//   broadcasts (row i) and conflict-free (column k).
//
// Shared memory is at most 32 x 65 x 4 = 8,320 bytes (d = 64), below the
// 48 KB a block may take without opting in.  The TPU kernel's 128-row
// VMEM tiling, which holds the whole factor block resident, has no
// counterpart: x is read through the cache, row by row, as gathered.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;           // slots staged per pass: one ballot
constexpr int kMaxThreads = 512;
constexpr int kMaxD = 64;

template <int NPT>
__global__ void __launch_bounds__(kMaxThreads)
als_normal_eq_kernel(const int32_t* __restrict__ nbrs,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ ratings,
                     const float* __restrict__ x,
                     float* __restrict__ a_out, float* __restrict__ b_out,
                     int32_t width, int64_t n_src, int32_t d) {
  extern __shared__ float tile[];          // [kTile][d + 1]
  __shared__ int64_t src_row[kTile];
  __shared__ int n_real;

  const int64_t v = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int dp = d + 1;
  const int n_out = d * dp;

  // output o = i * (d + 1) + k: A[v, i, k] for k < d, b[v, i] for k = d
  int row_of[NPT], col_of[NPT];
  float acc[NPT];
#pragma unroll
  for (int p = 0; p < NPT; ++p) {
    const int o = tid + p * nthreads;
    row_of[p] = o < n_out ? o / dp : 0;
    col_of[p] = o < n_out ? o - row_of[p] * dp : 0;
    acc[p] = 0.0f;
  }

  const int32_t* nb = nbrs + v * width;
  const uint8_t* mk = mask + v * width;
  const float* rt = ratings + v * width;
  for (int32_t j0 = 0; j0 < width; j0 += kTile) {
    if (tid < kTile) {
      const int32_t j = j0 + tid;
      const bool real = j < width && mk[j] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, real);
      if (real) {
        const int q = __popc(ballot & ((1u << tid) - 1u));
        int64_t s = nb[j];
        // out-of-range indices read the nearest row, as XLA's gather clamps
        s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
        src_row[q] = s;
        tile[q * dp + d] = rt[j];          // the tile's last column
      }
      if (tid == 0) n_real = __popc(ballot);
    }
    __syncthreads();
    const int n = n_real;
    for (int e = tid; e < n * d; e += nthreads) {
      const int q = e / d;
      const int c = e - q * d;
      tile[q * dp + c] = x[src_row[q] * d + c];
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float* t = tile + q * dp;
#pragma unroll
      for (int p = 0; p < NPT; ++p)
        acc[p] = __fadd_rn(acc[p], __fmul_rn(t[row_of[p]], t[col_of[p]]));
    }
    __syncthreads();                       // the tile is refilled next pass
  }

  float* a = a_out + v * d * d;
  float* b = b_out + v * d;
#pragma unroll
  for (int p = 0; p < NPT; ++p) {
    const int o = tid + p * nthreads;
    if (o >= n_out) continue;
    if (col_of[p] < d) a[row_of[p] * d + col_of[p]] = acc[p];
    else b[row_of[p]] = acc[p];
  }
}

template <int NPT>
int launch(const void* nbrs, const void* mask, const void* ratings,
           const void* x, void* a, void* b, int64_t n_rows, int32_t width,
           int64_t n_src, int32_t d, int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (d + 1) * sizeof(float);
  als_normal_eq_kernel<NPT><<<static_cast<unsigned int>(n_rows), threads,
                              smem, stream>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(ratings), static_cast<const float*>(x),
      static_cast<float*>(a), static_cast<float*>(b), width, n_src, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 only; mask is bool (one byte a slot).  Takes 1 <= d <= 64.
// Returns the cudaError_t of the launch (0 on success).
int als_normal_eq_launch(const void* nbrs, const void* mask,
                         const void* ratings, const void* x, void* a,
                         void* b, int64_t n_rows, int32_t width,
                         int64_t n_src, int32_t d, void* stream) {
  if (n_rows <= 0) return 0;
  if (d < 1 || d > kMaxD || width < 0 || n_rows > 0x7fffffffLL ||
      (n_src <= 0 && width > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the fewest outputs a thread (of 1, 2, 4, 8, 16) that fit the block
  const int n_out = d * (d + 1);
  int npt = 1;
  while ((n_out + npt - 1) / npt > kMaxThreads) npt *= 2;
  const int per = (n_out + npt - 1) / npt;
  const int threads = ((per + 31) / 32) * 32;   // >= one warp: the ballot
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case 1: return launch<1>(nbrs, mask, ratings, x, a, b, n_rows, width, n_src, d, threads, s);
    case 2: return launch<2>(nbrs, mask, ratings, x, a, b, n_rows, width, n_src, d, threads, s);
    case 4: return launch<4>(nbrs, mask, ratings, x, a, b, n_rows, width, n_src, d, threads, s);
    case 8: return launch<8>(nbrs, mask, ratings, x, a, b, n_rows, width, n_src, d, threads, s);
    case 16: return launch<16>(nbrs, mask, ratings, x, a, b, n_rows, width, n_src, d, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* als_normal_eq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
