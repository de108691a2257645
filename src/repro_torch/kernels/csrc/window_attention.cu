// Sliding-window decode attention for Hopper (sm_90a): one new query
// token per request against a ring-buffer KV cache.
//
// Replaces repro/kernels/window_attention.py::_decode_kernel, the Pallas
// TPU kernel behind decode_window_attention.  For request b, query head
// h and KV head g = h / n_rep (grouped-query attention: n_rep query
// heads share one KV head),
//
//     s[t]    = (q[b, h, :] . k[b, t, g, :]) * scale      t < kv_len[b]
//     o[b, h] = sum_t softmax(s)[t] * v[b, t, g, :]
//
// with scale = 1 / sqrt(dh), in float32: K and V (float32 or bfloat16)
// are upcast exactly, the softmax is an online one (a running max m, a
// denominator l and an accumulator acc), and expf is the IEEE one (no
// fast-math).  The contract is 1 <= kv_len[b] <= W; rows t >= kv_len[b]
// are never read.
//
// What bounds it on an H100: bytes.  Each valid K and V row (2 * dh
// values) is read once per KV head and used by the group's n_rep query
// heads for 4 * n_rep * dh flops: at dh = 128, n_rep = 4 and a bf16
// cache that is 2,048 flops for 512 bytes, 4 flops a byte against the
// card's float32 ratio of 20 (67 TFLOP/s over 3.35 TB/s).  So the
// design reads every row once, and only once per KV head, and keeps the
// per-row work small and spread over the lanes:
//
// * pass 1, one block of 4 warps per (split of W, KV head, request), or
//   per chunk of at most R of the group's query heads where a group is
//   larger than R (R = 8, or 4 at dh > 128).  The query rows sit in
//   shared memory.  Each warp takes the split's rows in tiles of 32, one
//   row a lane: a lane reads its K row (16-byte loads where the layout
//   allows) and computes that row's R scores alone, so a score costs no
//   shuffles.  The tile's softmax update is then two warp reductions a
//   head (max and sum) and one exp a lane and head.  For p . V a lane
//   owns the elements lane + 32 i of the accumulator (EPL = ceil(dh / 32)
//   of them); the warp reads the tile's V rows 8 at a time, coalesced,
//   and broadcasts each row's p from the lane that scored it.  The block
//   merges its warps' (m, l, acc) through shared memory and writes one
//   partial a query head and split;
// * pass 2, one block per (request, query head), merges the splits:
//   o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s.
//   A split that lies wholly at or past kv_len has m = -inf, l = 0 and
//   acc = 0, and is weighted 0 (never e^(-inf - -inf)).
//
// The split count is the wrapper's: enough splits that the blocks fill
// the card several times over, each split a multiple of 128 rows (one
// tile of every warp).  The TPU kernel's sequential grid over 512-row
// tiles, which carried (m, l, acc) from one grid step to the next, has
// no counterpart: blocks run in parallel, so the carry becomes the
// per-split partials and pass 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;             // rows a warp scores at once: one a lane
constexpr int kVRows = 8;             // V rows a warp has in flight
constexpr int kMaxDh = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row, upcast: 4 floats, or 8 bfloat16 (exactly: a
// bfloat16 is the high half of its float)
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Pass 1.  q [B, H, dh] float32 contiguous; k, v strided [B, W, Hkv, dh]
// (unit stride in dh); partials [B, H, n_splits] and [B, H, n_splits, dh].
// k_vec: K rows may be read in 16-byte pieces (dh * sizeof(T) and the
// K strides multiples of 16 bytes, k 16-byte aligned).  EPL: the
// accumulator elements a lane holds per head, ceil(dh / 32).
template <typename T, int EPL, int R>
__global__ void __launch_bounds__(kThreads)
window_attention_split(const float* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ kv_len,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int32_t H,
                       int32_t n_rep, int32_t dh, int32_t chunk,
                       int32_t n_splits, int64_t ksb, int64_t ksw,
                       int64_t ksh, int64_t vsb, int64_t vsw, int64_t vsh,
                       int32_t k_vec, float scale) {
  extern __shared__ __align__(16) float smem[];  // q_s [R][dh], then
                                                 // sm_acc [kWarps][R][dh]
  float* q_s = smem;
  float* sm_acc = smem + R * dh;
  __shared__ float sm_m[kWarps][R], sm_l[kWarps][R];

  const int split = blockIdx.x;
  const int n_chunks = (n_rep + R - 1) / R;
  const int g = blockIdx.y / n_chunks;
  const int r0 = (blockIdx.y % n_chunks) * R;
  const int nr = min(R, n_rep - r0);         // query heads of this block
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = split * chunk;
  const int end = min(start + chunk, kv_len[b]);   // rows [start, end)
  const int h0 = g * n_rep + r0;

  for (int i = threadIdx.x; i < R * dh; i += kThreads) {
    const int r = i / dh;
    q_s[i] = r < nr ? q[(b * H + h0 + r) * dh + (i - r * dh)] : 0.f;
  }
  __syncthreads();

  float acc[R][EPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  }
  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;

  for (int t0 = start + warp * kTile; t0 < end; t0 += kWarps * kTile) {
    // this lane's row: its R scores
    const int t = t0 + lane;
    const bool valid = t < end;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (valid) {
      const T* kr = kb + static_cast<int64_t>(t) * ksw;
      if (k_vec) {
        // 16 bytes at a time, 8 pieces in flight; q_s rows are 16-byte
        // aligned (dh is a multiple of 4 here)
        constexpr int P = 16 / sizeof(T);
#pragma unroll 8
        for (int d0 = 0; d0 < dh; d0 += P) {
          float kf[P];
          load16(kr + d0, kf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int u = 0; u < P; u += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(q_s + r * dh + d0 + u);
              s[r] += qv.x * kf[u] + qv.y * kf[u + 1] + qv.z * kf[u + 2] +
                      qv.w * kf[u + 3];
            }
          }
        }
      } else {
#pragma unroll 8
        for (int d = 0; d < dh; ++d) {
          const float kf = to_f32(kr[d]);
#pragma unroll
          for (int r = 0; r < R; ++r) s[r] += q_s[r * dh + d] * kf;
        }
      }
    }
    // the tile's online-softmax update; row t0 < end is valid, so the
    // new max is finite and alpha = 0 on the first tile (m = -inf)
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
      const float sr = valid ? s[r] * scale : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - mn);
      p[r] = expf(sr - mn);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[r][i] *= alpha;
      m[r] = mn;
    }
    // p . V over the tile's valid rows, kVRows rows in flight
    const int rows = min(kTile, end - t0);
    for (int j0 = 0; j0 < rows; j0 += kVRows) {
      float vf[kVRows][EPL];
#pragma unroll
      for (int jj = 0; jj < kVRows; ++jj) {
        const bool ok = j0 + jj < rows;
        const T* vr = vb + static_cast<int64_t>(t0 + j0 + jj) * vsw;
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          const int e = lane + 32 * i;
          vf[jj][i] = (ok && e < dh) ? to_f32(vr[e]) : 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kVRows; ++jj) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= nr) break;
          const float pr = __shfl_sync(kFull, p[r], j0 + jj);
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[r][i] += pr * vf[jj][i];
        }
      }
    }
  }

  // merge the block's warps: a warp that saw no row has m = -inf
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      if (e < dh) sm_acc[(warp * R + r) * dh + e] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * dh; idx += kThreads) {
    const int r = idx / dh, e = idx - r * dh;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][r];
      if (mw != -INFINITY) a += expf(mw - mx) * sm_acc[(w * R + r) * dh + e];
    }
    part_acc[((b * H + h0 + r) * n_splits + split) * dh + e] = a;
  }
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float mx = -INFINITY, sl = 0.f;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][r];
      if (mw != -INFINITY) sl += expf(mw - mx) * sm_l[w][r];
    }
    part_m[(b * H + h0 + r) * n_splits + split] = mx;
    part_l[(b * H + h0 + r) * n_splits + split] = sl;
  }
}

// Pass 2: one block per (request, query head), one thread per element.
__global__ void window_attention_combine(const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         const float* __restrict__ part_acc,
                                         float* __restrict__ out, int32_t dh,
                                         int32_t n_splits) {
  const int64_t bh = blockIdx.x;
  const int e = threadIdx.x;
  const float* pm = part_m + bh * n_splits;
  const float* pl = part_l + bh * n_splits;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, pm[s]);
  float l = 0.f, o = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    if (pm[s] == -INFINITY) continue;        // a split past kv_len
    const float w = expf(pm[s] - mx);
    l += w * pl[s];
    if (e < dh) o += w * part_acc[(bh * n_splits + s) * dh + e];
  }
  if (e < dh) out[bh * dh + e] = o / fmaxf(l, 1e-30f);
}

// The launch parameters shared by every instantiation.
struct Args {
  const void *q, *k, *v, *kv_len;
  void *part_m, *part_l, *part_acc;
  int32_t B, H, Hkv, dh, chunk, n_splits, k_vec;
  int64_t ks[3], vs[3];
  cudaStream_t stream;
};

template <typename T, int EPL, int R>
int launch_split(const Args& a) {
  const int n_rep = a.H / a.Hkv;
  const int n_chunks = (n_rep + R - 1) / R;
  if (static_cast<int64_t>(a.Hkv) * n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.n_splits),
                  static_cast<unsigned>(a.Hkv * n_chunks),
                  static_cast<unsigned>(a.B));
  const size_t smem = sizeof(float) * (1 + kWarps) * R * a.dh;
  window_attention_split<T, EPL, R><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.kv_len),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), a.H, n_rep, a.dh, a.chunk, a.n_splits,
      a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.k_vec,
      1.0f / sqrtf(static_cast<float>(a.dh)));
  return static_cast<int>(cudaGetLastError());
}

// R: the query heads a block holds, the least power of two >= n_rep,
// at most 8 (4 at EPL = 8, to bound the registers)
template <typename T, int EPL>
int dispatch_r(const Args& a) {
  constexpr int kRmax = EPL >= 8 ? 4 : 8;
  const int n_rep = a.H / a.Hkv;
  int r = 1;
  while (r < n_rep && r < kRmax) r *= 2;
  switch (r) {
    case 1: return launch_split<T, EPL, 1>(a);
    case 2: return launch_split<T, EPL, 2>(a);
    case 4: return launch_split<T, EPL, 4>(a);
    default: return launch_split<T, EPL, kRmax>(a);
  }
}

template <typename T>
int dispatch_epl(const Args& a) {
  const int epl = (a.dh + 31) / 32;
  if (epl <= 1) return dispatch_r<T, 1>(a);
  if (epl <= 2) return dispatch_r<T, 2>(a);
  if (epl <= 4) return dispatch_r<T, 4>(a);
  return dispatch_r<T, 8>(a);
}

}  // namespace

extern "C" {

// q: float32 [B, H, dh] contiguous.  k, v: [B, W, Hkv, dh] with element
// strides (ks, vs) = (batch, row, head) and unit stride in dh; kv_dtype
// 0 = float32, 1 = bfloat16.  k_vec != 0 lets K rows be read in 16-byte
// pieces: the caller checks that dh * sizeof(T), every K stride (times
// sizeof(T)) and k's address are multiples of 16.  kv_len: int32 [B],
// 1 <= kv_len <= W (not checked here: the decode path never gives 0,
// and a host check would synchronize every layer).  Partials: float32
// [B, H, n_splits] (m, l) and [B, H, n_splits, dh] (acc); out: float32
// [B, H, dh].  Split s covers rows [s * chunk, (s + 1) * chunk).  Takes
// 1 <= dh <= 256 and H a multiple of Hkv.  Returns the cudaError_t of
// the launches (0 on success).
int window_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* part_m, void* part_l,
                            void* part_acc, void* out, int32_t B, int32_t H,
                            int32_t Hkv, int32_t W, int32_t dh,
                            int32_t chunk, int32_t n_splits, int64_t ksb,
                            int64_t ksw, int64_t ksh, int64_t vsb,
                            int64_t vsw, int64_t vsh, int32_t kv_dtype,
                            int32_t k_vec, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dh < 1 || dh > kMaxDh || Hkv < 1 || H % Hkv != 0 || W < 1 ||
      chunk < 1 || n_splits < 1 ||
      static_cast<int64_t>(chunk) * n_splits < W || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, kv_len, part_m, part_l, part_acc,
               B, H, Hkv, dh, chunk, n_splits, k_vec,
               {ksb, ksw, ksh}, {vsb, vsw, vsh},
               static_cast<cudaStream_t>(stream)};
  int err;
  if (kv_dtype == 0)
    err = dispatch_epl<float>(a);
  else if (kv_dtype == 1)
    err = dispatch_epl<__nv_bfloat16>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  const int threads = ((dh + 31) / 32) * 32;
  window_attention_combine<<<static_cast<unsigned>(
                                 static_cast<int64_t>(B) * H),
                             threads, 0, a.stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<float*>(out), dh,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
