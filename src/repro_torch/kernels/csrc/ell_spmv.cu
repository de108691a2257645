// Sliced-ELL neighbour aggregation for Hopper (sm_90a).
//
// Replaces repro/kernels/ell_spmv.py::_spmv_kernel, the Pallas TPU
// kernel behind ell_spmv / ell_spmv_bucketed / ell_spmv_batched /
// ell_fold.  It computes, for every row v of one [Nv, W] block,
//
//     y[v, f] = sum_{j = 0..W-1} (w[v, j] * m[v]) * x[nbrs[v, j], f]
//
// with m the optional row mask (1 = active, 0 = masked; a masked row
// is computed as weight * 0, not skipped), slots added in the order
// j = 0, 1, ..., W-1, each product rounded in the input type before it
// is widened, a float32 accumulator, and the result rounded to x's
// type.  For float32 the product and the add are __fmul_rn/__fadd_rn,
// so nvcc cannot contract them into an FMA: the port's dense fallback
// and its kernel path reduce through this one launch, and its CPU
// path (an eager slot loop) does the same IEEE operations in the same
// order, which is what makes all three bitwise equal.
//
// What bounds it on an H100: bytes.  Each slot costs one index, one
// weight and one gathered row of x for two flops; at F = 1 (PageRank)
// that is 12 bytes per 2 flops, three orders of magnitude below the
// card's flop-to-byte ratio.  The gathered rows of x are random reads,
// so the design keeps them cheap rather than few: x is a read-only
// argument (__restrict__ const, served through the non-coherent cache)
// and, for the graphs this port runs, small enough to stay in the
// 50 MB L2 (2M vertices x 4 bytes at F = 1).  One thread computes one
// output element (row, feature) with the feature index fastest, so at
// wide F a warp's gathers of one neighbour row are coalesced and the
// index and weight loads are broadcasts; at F = 1 a thread walks its
// own row's slots, which for the narrow buckets that hold most rows
// (W = 2..8) are still contiguous across a warp.  The TPU kernel's
// 128 x 128 VMEM tiling has no counterpart here.  The slot width W is
// a runtime argument: bucket widths are powers of two except the last
// bucket's, and ell_fold's width is the scope width.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Product rounded in the storage type T, then widened to float.
struct F32 {
  using T = float;
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float widen(T a) { return a; }
  static __device__ __forceinline__ T narrow(float a) { return a; }
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
};

template <typename A>
__global__ void ell_spmv_kernel(const int32_t* __restrict__ nbrs,
                                const typename A::T* __restrict__ w,
                                const typename A::T* __restrict__ row_mask,
                                const typename A::T* __restrict__ x,
                                typename A::T* __restrict__ y,
                                int64_t n_rows, int32_t width,
                                int64_t n_src, int32_t n_feat) {
  using T = typename A::T;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n_rows * n_feat) return;
  const int64_t v = t / n_feat;
  const int64_t f = t - v * n_feat;
  const int32_t* nb = nbrs + v * width;
  const T* wr = w + v * width;
  const bool masked = row_mask != nullptr;
  const T m = masked ? row_mask[v] : T();
  float acc = 0.0f;
  for (int32_t j = 0; j < width; ++j) {
    int64_t s = nb[j];
    // out-of-range indices read the nearest row, as XLA's gather clamps
    s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
    T wj = wr[j];
    if (masked) wj = A::mul(wj, m);          // gate the weight first
    acc = __fadd_rn(acc, A::widen(A::mul(wj, x[s * n_feat + f])));
  }
  y[t] = A::narrow(acc);
}

template <typename A>
int launch(const void* nbrs, const void* w, const void* row_mask,
           const void* x, void* y, int64_t n_rows, int32_t width,
           int64_t n_src, int32_t n_feat, cudaStream_t stream) {
  using T = typename A::T;
  constexpr int kThreads = 256;
  const int64_t n_out = n_rows * n_feat;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  ell_spmv_kernel<A><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const T*>(w),
      static_cast<const T*>(row_mask), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, width, n_src, n_feat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  row_mask may be null (all rows on).
// Returns the cudaError_t of the launch (0 on success).
int ell_spmv_launch(const void* nbrs, const void* w, const void* row_mask,
                    const void* x, void* y, int64_t n_rows, int32_t width,
                    int64_t n_src, int32_t n_feat, int32_t dtype,
                    void* stream) {
  if (n_rows <= 0 || n_feat <= 0) return 0;
  if (n_src <= 0 && width > 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<F32>(nbrs, w, row_mask, x, y, n_rows, width, n_src, n_feat, s);
    case 1: return launch<BF16>(nbrs, w, row_mask, x, y, n_rows, width, n_src, n_feat, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
