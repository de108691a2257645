// Segmented sum over contiguous segments for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ell_spmv.py:185 (segment_combine), an XLA
// scatter-add rather than a Pallas kernel: stage 2 of hub splitting
// (virtual-row partials summed onto their owner rows), the chunk
// combine of a window wider than w_cap, and the reduce of the MapReduce
// baseline.  Every caller can lay its segments out contiguously, so the
// function here is
//
//     y[r, f] = sum_{i = offsets[r] .. offsets[r+1]-1} x[i, f]
//
// added in row order i = offsets[r], offsets[r] + 1, ..., from +0.0, in
// float32 with __fadd_rn (never contracted), and rounded once to the
// output type.  An empty segment gives +0.0, and -0.0 inputs come out as
// +0.0 + (-0.0) = +0.0, as XLA's scatter-add into zeros gives them.
// Rows of x past offsets[n_rows] belong to no segment (the dropped
// sentinel rows).  The port's CPU path, segment_sum_csr_plain, does the
// same IEEE adds in the same order, so the two are bitwise equal.  A
// fixed order is the point: PyTorch's index_add_ adds with atomics on
// CUDA, in an order that changes from run to run.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// takes one add; each output element is written once.  The mapping is
// the simple one: one thread a (segment, feature element), threads
// numbered feature-fastest, so a warp reads consecutive addresses of
// one row where F >= 32 (the MapReduce reduce's F = 400 and 20), and
// neighbouring rows of neighbouring segments where F = 1.  A thread
// walks its segment's rows serially; the loads of SEG_UNROLL rows are
// issued before their adds, so that many are in flight a thread.  A
// long segment therefore costs its length in dependent adds, and a grid
// with a few long segments waits for them: a warp a long segment with a
// fixed-order tree would cut that, and is left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SEG_THREADS
#define SEG_THREADS 256
#endif
#ifndef SEG_UNROLL
#define SEG_UNROLL 8
#endif

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename OffT>
__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const T* __restrict__ x, const OffT* __restrict__ offsets,
                   T* __restrict__ y, int64_t n_rows, int64_t n_feat,
                   int64_t n_src) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * SEG_THREADS +
                    threadIdx.x;
  if (t >= n_rows * n_feat) return;
  const int64_t r = t / n_feat;
  const int64_t f = t - r * n_feat;
  int64_t i = static_cast<int64_t>(offsets[r]);
  int64_t end = static_cast<int64_t>(offsets[r + 1]);
  if (i < 0) i = 0;
  if (end > n_src) end = n_src;
  const T* p = x + f;
  float acc = 0.0f;
  for (; i + SEG_UNROLL <= end; i += SEG_UNROLL) {
    float v[SEG_UNROLL];
#pragma unroll
    for (int k = 0; k < SEG_UNROLL; ++k) v[k] = widen(p[(i + k) * n_feat]);
#pragma unroll
    for (int k = 0; k < SEG_UNROLL; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; i < end; ++i) acc = __fadd_rn(acc, widen(p[i * n_feat]));
  store(y + t, acc);
}

template <typename T, typename OffT>
void launch(const void* x, const void* offsets, void* y, int64_t n_rows,
            int64_t n_feat, int64_t n_src, unsigned int grid,
            cudaStream_t s) {
  segment_sum_kernel<T, OffT><<<grid, SEG_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const OffT*>(offsets),
      static_cast<T*>(y), n_rows, n_feat, n_src);
}

}  // namespace

extern "C" {

// y [n_rows, n_feat] = segment sums of x [n_src, n_feat] over the
// n_rows segments that offsets [n_rows + 1] delimits.  dtype: 0 =
// float32, 1 = bfloat16 (x and y alike; the sum is float32 either way).
// offsets_64: offsets are int64 (1) or int32 (0).  Returns the
// cudaError_t of the launch (0 on success).
int segment_sum_launch(const void* x, const void* offsets,
                       int32_t offsets_64, void* y, int64_t n_rows,
                       int64_t n_feat, int64_t n_src, int32_t dtype,
                       void* stream) {
  const int64_t n = n_rows * n_feat;
  if (n <= 0) return 0;
  const int64_t blocks = (n + SEG_THREADS - 1) / SEG_THREADS;
  if (blocks > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (dtype == 0 && offsets_64)
    launch<float, int64_t>(x, offsets, y, n_rows, n_feat, n_src, grid, s);
  else if (dtype == 0)
    launch<float, int32_t>(x, offsets, y, n_rows, n_feat, n_src, grid, s);
  else if (offsets_64)
    launch<__nv_bfloat16, int64_t>(x, offsets, y, n_rows, n_feat, n_src,
                                   grid, s);
  else
    launch<__nv_bfloat16, int32_t>(x, offsets, y, n_rows, n_feat, n_src,
                                   grid, s);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
