// Sliding-window decode attention for Hopper (sm_90a): one new query
// token per request against a ring-buffer KV cache, in one launch.
//
// Replaces repro/kernels/window_attention.py::_decode_kernel, the Pallas
// TPU kernel behind decode_window_attention.  For request b, query head
// h and KV head g = h / n_rep (grouped-query attention: n_rep query
// heads share one KV head),
//
//     s[t]    = (q[b, h, :] . k[b, t, g, :]) * scale      t < kv_len[b]
//     o[b, h] = sum_t softmax(s)[t] * v[b, t, g, :]
//
// with scale = 1 / sqrt(dh).  q is float32, the softmax is an online one
// in float32 (a running max m, a denominator l, an accumulator acc), expf
// is the IEEE one (no fast-math), and the output is float32.  The
// contract is 1 <= kv_len[b] <= W; rows t >= kv_len[b] are never read.
//
// What bounds it on an H100: bytes.  Each valid K and V row (2 * dh
// values) is read once per KV head and serves the group's n_rep query
// heads with 4 * n_rep * dh flops: at dh = 128, n_rep = 4 and a bf16
// cache, 2,048 flops for 512 bytes, 4 flops a byte, against the 295 a
// byte at which the bf16 tensor cores (989 TFLOP/s over 3.35 TB/s) would
// be the limit.  Even with q and p split in two (below), the mma work is
// a few percent of the time the bytes take.  So the kernel has to keep
// enough bytes in flight, spend few instructions a row, and keep every
// SM streaming to the end.
//
// The first design (one lane per K row on the CUDA cores, then a second
// launch for the combine) reached 31 % of that bound in bf16 and was
// slower per row in bf16 than in float32.  What it lost:
//   1. K reads: a warp's 16-byte loads touched 32 rows 2 KB apart
//      (uncoalesced), and each row cost R * dh float32 FMAs plus the bf16
//      unpacking and shared-memory reads of q: instructions, not bytes,
//      set the pace;
//   2. V reads: one 2-byte element a lane and row, 64 bytes a warp
//      instruction, and R shuffles a row for p;
//   3. waves: 2,048-row splits gave decode_32k 512 blocks of which about
//      3 fit an SM (146 registers a thread), 1.3 waves with the second
//      one mostly empty;
//   4. a second launch for the combine, in a step the host already paces.
//
// The bf16 cache (the serving path) takes the tensor-core body,
// window_attention_mma:
//   * a block of 4 warps per (KV head, split of W, request) streams the
//     split's rows in tiles of 64 rows x dh through a ring of kStages
//     shared-memory stages fed by cp.async: each row is one contiguous
//     dh * 2-byte piece, copied 16 bytes a thread, coalesced, with a
//     256-byte L2 prefetch; rows past kv_len are zero-filled and masked.
//     The grid runs the KV heads fastest, so the blocks in flight read
//     the same cache rows, each row's Hkv heads contiguous;
//   * each warp takes 16 rows of a tile.  S = Q K^T and O += P V run on
//     mma.sync.m16n8k16 (bf16 in, float32 accumulate), operands from
//     shared memory through ldmatrix (.trans for V).  The M = 16 rows of
//     Q hold the group's (up to 8) query heads twice: row r is
//     bf16(q_r), row r + 8 is bf16(q_r - bf16(q_r)).  In the mma
//     fragment layout a lane holds rows r and r + 8 of the same columns,
//     so the two partial scores are added in float32 in the lane, and
//     the score's S fragment is the P fragment of the P V product: P
//     never leaves registers, and enters the second product as p_hi in
//     rows 0-7 and p_lo = bf16(p - p_hi) in rows 8-15 in the same way.
//     A group of one query head (MHA, the reference signature) wastes
//     rows; a group over 8 takes several blocks;
//   * precision: K and V in bf16 are exact mma operands; q = q_hi + q_lo
//     leaves |q| * 2^-16 out (p likewise), and products of two bf16 are
//     exact in float32, so a score carries about 2^-16 relative error
//     against 2^-8 for a single bf16 rounding of q.  An emulation of this
//     arithmetic in float32 (tests/test_torch_attention.py) stays within
//     2.1e-6 of the float32 plain version, where one rounding of q and p
//     to bf16 is 7e-4 to 2e-3 off, outside the 1e-5 the kernel is held
//     to;
//   * splits (window_attention.split_rows): the fewest that fill the
//     card's resident blocks (2 an SM at dh <= 128) in whole waves, so a
//     full ring streams with no block starting late.
// A float32 cache would need three bf16 terms a value to be exact enough,
// which triples the mma work for a dtype the serving path does not use,
// so the float32 cache keeps the CUDA-core body, window_attention_f32
// (each lane scores its own row, 16-byte K loads where the layout
// allows, V read coalesced 32 elements a warp; splits for 16 blocks an
// SM, which balance a ragged kv_len): at decode_32k it is 1.5x its bound
// and many times faster than the library's float32 attention (PERF.md).
//
// Both bodies end the same way (finish): the block merges its warps'
// (m, l, acc) in shared memory; a (request, KV head) covered by one
// split writes its output directly; otherwise each split writes a
// float32 partial (m, l, acc) and takes a ticket (an atomic on a small
// int32 buffer the wrapper keeps zeroed); the block that draws the last
// ticket merges the splits, o = sum_s e^(m_s - M) acc_s / sum_s
// e^(m_s - M) l_s, and zeroes the ticket again.  A split that starts at
// or past kv_len returns at once and draws no ticket, so every split
// merged has a finite m (never e^(-inf - -inf)).  The partial entry
// (window_attention_partial_launch) ends the same way but leaves the
// merged row unnormalised, o = sum_s e^(m_s - M) acc_s, beside its M and
// L = sum_s e^(m_s - M) l_s: the float32 partial of a row-sharded cache
// that the ranks then merge; a request with no valid row gives o = 0,
// m = -inf, l = 0.  The partials' bytes
// stay under 5 % of the K/V bytes.  The TPU kernel's sequential grid over
// 512-row tiles, which carried (m, l, acc) from one grid step to the
// next, becomes the ring inside a block plus the ticketed merge across
// blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDh = 256;
constexpr int kMaxSplits = 256;       // the merge keeps R weights a split
// the CUDA-core body (float32 cache)
constexpr int kTile = 32;             // rows a warp scores at once: one a lane
constexpr int kVRows = 8;             // V rows a warp has in flight
// the tensor-core body (bf16 cache)
constexpr int kMmaHeads = 8;          // query heads a block: Q rows 0-7
                                      // hi, 8-15 lo
constexpr int kRows = 64;             // rows a stage holds: 16 a warp
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of a float32 row
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
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

// Where a launch writes: partials acc [B, H, n_splits, dh], m and l
// [B, H, n_splits]; out [B, H, dh]; one ticket per (request, block row);
// for the partial entry the merged row's m and l [B, H] (row_m, row_l),
// and out unnormalised (both null otherwise).
struct Out {
  float *acc, *m, *l, *out;
  int32_t* ticket;
  float *row_m, *row_l;
};

// The block's (request, KV head, chunk of query heads) and split.
struct Group {
  int64_t bh0;       // b * H + the chunk's first query head
  int64_t tix;       // the ticket: b * gridDim.x + blockIdx.x
  int nr, split, n_valid, n_splits, dh;
};

// The end of both bodies.  The block's warps have left their state in
// shared memory (sm_m, sm_l [kWarps][R]; sm_acc [kWarps][R][stride], a
// warp that saw no row with m = -inf, l = 0, acc = 0) and synchronized.
// scratch: R * (n_valid + 1) floats, which may alias sm_acc.
template <int R>
__device__ void finish(const float (*sm_m)[R], const float (*sm_l)[R],
                       const float* sm_acc, int stride, float* scratch,
                       const Group& gr, const Out& o) {
  const int tid = threadIdx.x, dh = gr.dh, ns = gr.n_splits;
  const bool direct = gr.n_valid == 1;
  for (int i = tid; i < gr.nr * dh; i += kThreads) {
    const int r = i / dh, e = i - r * dh;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][r];
      if (mw == -INFINITY) continue;
      const float f = expf(mw - mx);
      a += f * sm_acc[(w * R + r) * stride + e];
      l += f * sm_l[w][r];
    }
    const int64_t bh = gr.bh0 + r;
    if (direct && o.row_m) {
      o.out[bh * dh + e] = a;
      if (e == 0) {
        o.row_m[bh] = mx;
        o.row_l[bh] = l;
      }
    } else if (direct) {
      o.out[bh * dh + e] = a / l;
    } else {
      o.acc[(bh * ns + gr.split) * dh + e] = a;
      if (e == 0) {
        o.m[bh * ns + gr.split] = mx;
        o.l[bh * ns + gr.split] = l;
      }
    }
  }
  if (direct) return;
  // the last split of the group to finish merges them all
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(o.ticket + gr.tix, 1) == gr.n_valid - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nv = gr.n_valid;
  float* wts = scratch;                 // [R][nv]: e^(m_s - M)
  float* lsum = scratch + R * nv;       // [R]
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < gr.nr; r += kWarps) {
    const float* pm = o.m + (gr.bh0 + r) * ns;
    const float* pl = o.l + (gr.bh0 + r) * ns;
    float mx = -INFINITY;
    for (int s = lane; s < nv; s += 32) mx = fmaxf(mx, __ldcg(pm + s));
    mx = warp_max(mx);
    float ls = 0.f;
    for (int s = lane; s < nv; s += 32) {
      const float f = expf(__ldcg(pm + s) - mx);
      wts[r * nv + s] = f;
      ls += f * __ldcg(pl + s);
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      lsum[r] = ls;
      if (o.row_m) {
        o.row_m[gr.bh0 + r] = mx;
        o.row_l[gr.bh0 + r] = ls;
      }
    }
  }
  __syncthreads();
  if ((dh & 3) == 0) {                  // 16 bytes of acc a load
    const int d4 = dh >> 2;
    for (int i = tid; i < gr.nr * d4; i += kThreads) {
      const int r = i / d4, c = i - r * d4;
      const int64_t bh = gr.bh0 + r;
      const float4* pa =
          reinterpret_cast<const float4*>(o.acc + bh * ns * dh) + c;
      const float* wr = wts + r * nv;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < nv; ++s) {
        const float4 x = __ldcg(pa + static_cast<int64_t>(s) * d4);
        const float f = wr[s];
        a.x += f * x.x;
        a.y += f * x.y;
        a.z += f * x.z;
        a.w += f * x.w;
      }
      const float l = o.row_m ? 1.f : lsum[r];
      reinterpret_cast<float4*>(o.out + bh * dh)[c] =
          make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
    }
  } else {
    for (int i = tid; i < gr.nr * dh; i += kThreads) {
      const int r = i / dh, e = i - r * dh;
      const int64_t bh = gr.bh0 + r;
      const float* pa = o.acc + bh * ns * dh + e;
      const float* wr = wts + r * nv;
      float a = 0.f;
#pragma unroll 8
      for (int s = 0; s < nv; ++s)
        a += wr[s] * __ldcg(pa + static_cast<int64_t>(s) * dh);
      o.out[bh * dh + e] = o.row_m ? a : a / lsum[r];
    }
  }
  if (tid == 0) o.ticket[gr.tix] = 0;
}

// The block's place in the grid, (KV head x chunk of query heads, split,
// request), and its rows [start, end).  Returns false for a block with
// no row.
__device__ __forceinline__ bool locate(const int32_t* kv_len, int H,
                                       int n_rep, int R, int W, int chunk,
                                       int n_splits, int dh, const Out& o,
                                       Group& gr, int& g, int& r0,
                                       int& start, int& end) {
  const int n_chunks = (n_rep + R - 1) / R;
  g = blockIdx.x / n_chunks;
  r0 = (blockIdx.x % n_chunks) * R;
  const int64_t b = blockIdx.z;
  const int kvl = min(kv_len[b], W);
  gr.nr = min(R, n_rep - r0);
  gr.bh0 = b * H + g * n_rep + r0;
  gr.tix = b * gridDim.x + blockIdx.x;
  gr.split = blockIdx.y;
  gr.n_splits = n_splits;
  gr.dh = dh;
  if (kvl <= 0) {                       // no row: zeros (m = -inf, l = 0)
    if (gr.split == 0) {
      for (int i = threadIdx.x; i < gr.nr * dh; i += kThreads)
        o.out[gr.bh0 * dh + i] = 0.f;
      if (o.row_m)
        for (int i = threadIdx.x; i < gr.nr; i += kThreads) {
          o.row_m[gr.bh0 + i] = -INFINITY;
          o.row_l[gr.bh0 + i] = 0.f;
        }
    }
    return false;
  }
  start = gr.split * chunk;
  if (start >= kvl) return false;
  end = min(start + chunk, kvl);
  gr.n_valid = (kvl + chunk - 1) / chunk;
  return true;
}

// ---------------------------------------------------------------------
// The CUDA-core body (float32 cache).  q [B, H, dh] float32 contiguous;
// k, v strided [B, W, Hkv, dh] (unit stride in dh).  k_vec: K rows may be
// read in 16-byte pieces.  EPL: the accumulator elements a lane holds per
// head, ceil(dh / 32).  A block holds R of the group's query heads.
template <int EPL, int R>
__global__ void __launch_bounds__(kThreads)
window_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int32_t* __restrict__ kv_len, Out o, int32_t H,
                     int32_t n_rep, int32_t W, int32_t dh, int32_t chunk,
                     int32_t n_splits, int64_t ksb, int64_t ksw, int64_t ksh,
                     int64_t vsb, int64_t vsw, int64_t vsh, int32_t k_vec,
                     float scale) {
  extern __shared__ __align__(16) float smem[];  // q_s [R][dh], then
                                                 // sm_acc [kWarps][R][dh]
  float* q_s = smem;
  float* sm_acc = smem + R * dh;
  __shared__ float sm_m[kWarps][R], sm_l[kWarps][R];

  Group gr;
  int g, r0, start, end;
  if (!locate(kv_len, H, n_rep, R, W, chunk, n_splits, dh, o, gr, g, r0,
              start, end))
    return;
  const int nr = gr.nr;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < R * dh; i += kThreads) {
    const int r = i / dh;
    q_s[i] = r < nr ? q[(gr.bh0 + r) * dh + (i - r * dh)] : 0.f;
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
  const float* kb = k + b * ksb + g * ksh;
  const float* vb = v + b * vsb + g * vsh;

  for (int t0 = start + warp * kTile; t0 < end; t0 += kWarps * kTile) {
    // this lane's row: its R scores
    const int t = t0 + lane;
    const bool valid = t < end;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (valid) {
      const float* kr = kb + static_cast<int64_t>(t) * ksw;
      if (k_vec) {
        // 16 bytes at a time, 8 pieces in flight; q_s rows are 16-byte
        // aligned (dh is a multiple of 4 here)
#pragma unroll 8
        for (int d0 = 0; d0 < dh; d0 += 4) {
          float kf[4];
          load16(kr + d0, kf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + r * dh + d0);
            s[r] += qv.x * kf[0] + qv.y * kf[1] + qv.z * kf[2] +
                    qv.w * kf[3];
          }
        }
      } else {
#pragma unroll 8
        for (int d = 0; d < dh; ++d) {
          const float kf = kr[d];
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
        const float* vr = vb + static_cast<int64_t>(t0 + j0 + jj) * vsw;
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          const int e = lane + 32 * i;
          vf[jj][i] = (ok && e < dh) ? vr[e] : 0.f;
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
  finish<R>(sm_m, sm_l, sm_acc, dh, smem, gr, o);
}

// ---------------------------------------------------------------------
// The tensor-core body (bf16 cache).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past `n` (0 or 16)
// are zero-filled and not read
// (the L2 fetches the 256-byte line around it)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8]: bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x = hi + lo, each a bf16 pair: (hi, lo) packed for an mma operand
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Shared rows are DHP + 8 bf16 long: 16 bytes of pad put the 8 rows an
// ldmatrix reads on 8 different 4-bank groups.
template <int DHP>
struct MmaShape {
  static constexpr int kStride = DHP + 8;
  static constexpr int kStages = DHP >= 256 ? 2 : 3;
  static constexpr size_t kRingBytes =
      sizeof(__nv_bfloat16) * (16 + 2 * kStages * kRows) * kStride;
};

// q [B, H, dh] float32 contiguous; k, v bf16 [B, W, Hkv, dh] strided
// with unit stride in dh; DHP: dh rounded up to a power of two >= 16
// (columns dh..DHP-1 are zero in shared memory).  vec: K and V rows may
// be copied in 16-byte pieces (dh a multiple of 8, strides and bases
// 16-byte aligned); otherwise element by element, synchronously.
template <int DHP>
__global__ void __launch_bounds__(kThreads)
window_attention_mma(const float* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int32_t* __restrict__ kv_len, Out o, int32_t H,
                     int32_t n_rep, int32_t W, int32_t dh, int32_t chunk,
                     int32_t n_splits, int64_t ksb, int64_t ksw, int64_t ksh,
                     int64_t vsb, int64_t vsw, int64_t vsh, int32_t vec,
                     float scale) {
  using S = MmaShape<DHP>;
  constexpr int kStride = S::kStride, kStages = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16]
  __nv_bfloat16* k_s = q_s + 16 * kStride;          // [kStages][kRows]
  __nv_bfloat16* v_s = k_s + kStages * kRows * kStride;
  __shared__ float sm_m[kWarps][kMmaHeads], sm_l[kWarps][kMmaHeads];

  Group gr;
  int g, r0, start, end;
  if (!locate(kv_len, H, n_rep, kMmaHeads, W, chunk, n_splits, dh, o, gr,
              g, r0, start, end))
    return;

  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  const __nv_bfloat16* kb = k + b * ksb + g * ksh;
  const __nv_bfloat16* vb = v + b * vsb + g * vsh;
  const int n_tiles = (end - start + kRows - 1) / kRows;
  // tile i of the split into stage s; rows at or past `end` become zeros
  auto load_tile = [&](int i, int s) {
    const int t0 = start + i * kRows;
    __nv_bfloat16* ks = k_s + s * kRows * kStride;
    __nv_bfloat16* vs = v_s + s * kRows * kStride;
    if (vec) {
      constexpr int kPieces = DHP / 8;     // 16-byte pieces a padded row
#pragma unroll 4
      for (int j = tid; j < kRows * kPieces; j += kThreads) {
        const int row = j / kPieces, c = (j % kPieces) * 8;
        if (c >= dh) continue;
        const int t = t0 + row;
        const int n = t < end ? 16 : 0;
        const int64_t ts = t < end ? t : start;     // read nothing past end
        cp_async16(ks + row * kStride + c, kb + ts * ksw + c, n);
        cp_async16(vs + row * kStride + c, vb + ts * vsw + c, n);
      }
    } else {
      for (int j = tid; j < kRows * DHP; j += kThreads) {
        const int row = j / DHP, c = j % DHP;
        if (c >= dh) continue;
        const int t = t0 + row;
        ks[row * kStride + c] = t < end ? kb[t * ksw + c] : zero;
        vs[row * kStride + c] = t < end ? vb[t * vsw + c] : zero;
      }
    }
  };

  // the first tiles in flight before anything else
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // Q: row r = bf16(q_r), row r + 8 = bf16(q_r - bf16(q_r)); zero past
  // the block's heads and past dh
  for (int i = tid; i < kMmaHeads * DHP; i += kThreads) {
    const int r = i / DHP, e = i % DHP;
    const float x = (r < gr.nr && e < dh) ? q[(gr.bh0 + r) * dh + e] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    q_s[r * kStride + e] = hi;
    q_s[(r + 8) * kStride + e] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
  // K and V columns dh..DHP-1 stay zero (0 * garbage could be NaN)
  if (dh < DHP)
    for (int i = tid; i < 2 * kStages * kRows * (DHP - dh); i += kThreads) {
      const int row = i / (DHP - dh);
      k_s[row * kStride + dh + (i - row * (DHP - dh))] = zero;
    }

  // this lane's head (a row of the mma) and column pair
  const int hr = lane >> 2, hc = (lane & 3) * 2;
  // ldmatrix row addresses: A (Q, row-major), B (K, non-transposed) and
  // B (V, transposed), 16 x 16 a call
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  float acc[DHP / 8][4];
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m = -INFINITY, l = 0.f;   // head hr: running max, this lane's sum

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // tile i landed; tile i - 1 used
    if (i + kStages - 1 < n_tiles)
      load_tile(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const int t0 = start + i * kRows + warp * 16;   // this warp's rows
    if (t0 >= end) continue;
    const int row0 = (i % kStages) * kRows + warp * 16;
    const __nv_bfloat16* ks = k_s + row0 * kStride;
    const __nv_bfloat16* vs = v_s + row0 * kStride;

    // S = Q K^T: two n-tiles of 8 rows; c[0..1] hi, c[2..3] lo
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, q_s + a_row * kStride + kk * 16 + a_col);
      ldsm_x4(bk, ks + k_row * kStride + kk * 16 + k_col);
      mma_bf16(sc[0], a, bk[0], bk[1]);
      mma_bf16(sc[1], a, bk[2], bk[3]);
    }
    // head hr's scores at rows t0 + 8 j + hc + e
    float s[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = (sc[j][e] + sc[j][e + 2]) * scale;
        s[j][e] = t0 + 8 * j + hc + e < end ? x : -INFINITY;
        mx = fmaxf(mx, s[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    // row t0 < end is valid, so mn is finite; alpha = 0 on the first tile
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    uint32_t pa[4];                       // P: rows 0-7 hi, 8-15 lo
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = expf(s[j][0] - mn), p1 = expf(s[j][1] - mn);
      ps += p0 + p1;
      split2(p0, p1, pa[2 * j], pa[2 * j + 1]);
    }
    l = l * alpha + ps;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      acc[n][0] *= alpha;
      acc[n][1] *= alpha;
      acc[n][2] *= alpha;
      acc[n][3] *= alpha;
    }
    // O += P V over the warp's 16 rows
#pragma unroll
    for (int d = 0; d < DHP / 16; ++d) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + a_row * kStride + d * 16 + a_col);
      mma_bf16(acc[2 * d], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * d + 1], pa, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring is free

  // the warp's state into shared memory, over the ring: acc [kWarps]
  // [kMmaHeads][DHP], head hr's value = hi row + lo row
  float* sm_acc = reinterpret_cast<float*>(k_s);
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if ((lane & 3) == 0) {
    sm_m[warp][hr] = m;
    sm_l[warp][hr] = l;
  }
  float* row = sm_acc + (warp * kMmaHeads + hr) * DHP + hc;
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n) {
    row[8 * n] = acc[n][0] + acc[n][2];
    row[8 * n + 1] = acc[n][1] + acc[n][3];
  }
  __syncthreads();
  finish<kMmaHeads>(sm_m, sm_l, sm_acc, DHP, sm_acc, gr, o);
}

// ---------------------------------------------------------------------
// Launch.

// The launch parameters shared by every instantiation.
struct Args {
  const void *q, *k, *v, *kv_len;
  Out o;
  int32_t B, H, Hkv, W, dh, chunk, n_splits, vec;
  int64_t ks[3], vs[3];
  cudaStream_t stream;
};

// Opt in to more than 48 KB of dynamic shared memory, once a kernel.
template <typename K>
int allow_smem(K kernel, size_t smem, size_t& done) {
  if (smem <= done) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (!err) done = smem;
  return err;
}

// KV heads (x chunks of query heads) fastest: the blocks in flight read
// the same rows of the cache, each row's Hkv heads contiguous
dim3 grid_of(const Args& a, int R) {
  const int n_chunks = (a.H / a.Hkv + R - 1) / R;
  return dim3(static_cast<unsigned>(a.Hkv * n_chunks),
              static_cast<unsigned>(a.n_splits),
              static_cast<unsigned>(a.B));
}

// q and the warps' accumulators, or the merge's scratch (R weights a
// split and R sums) over them
size_t f32_smem(const Args& a, int R) {
  const size_t body = sizeof(float) * (1 + kWarps) * R * a.dh;
  const size_t merge = sizeof(float) * R * (a.n_splits + 1);
  return body > merge ? body : merge;
}

template <int EPL, int R>
int launch_f32(const Args& a) {
  static size_t done = 48 << 10;
  const size_t smem = f32_smem(a, R);
  if (int err = allow_smem(window_attention_f32<EPL, R>, smem, done))
    return err;
  window_attention_f32<EPL, R><<<grid_of(a, R), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int32_t*>(a.kv_len),
      a.o, a.H, a.H / a.Hkv, a.W, a.dh, a.chunk, a.n_splits, a.ks[0],
      a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.vec,
      1.0f / sqrtf(static_cast<float>(a.dh)));
  return static_cast<int>(cudaGetLastError());
}

// R: the query heads a block holds, the least power of two >= n_rep,
// at most 8 (4 at EPL = 8, to bound the registers)
template <int EPL>
int dispatch_r(const Args& a) {
  constexpr int kRmax = EPL >= 8 ? 4 : 8;
  const int n_rep = a.H / a.Hkv;
  int r = 1;
  while (r < n_rep && r < kRmax) r *= 2;
  switch (r) {
    case 1: return launch_f32<EPL, 1>(a);
    case 2: return launch_f32<EPL, 2>(a);
    case 4: return launch_f32<EPL, 4>(a);
    default: return launch_f32<EPL, kRmax>(a);
  }
}

int dispatch_f32(const Args& a) {
  const int epl = (a.dh + 31) / 32;
  if (epl <= 1) return dispatch_r<1>(a);
  if (epl <= 2) return dispatch_r<2>(a);
  if (epl <= 4) return dispatch_r<4>(a);
  return dispatch_r<8>(a);
}

// the ring, which the warps' state and the merge's scratch reuse
template <int DHP>
constexpr size_t mma_smem() {
  using S = MmaShape<DHP>;
  static_assert(S::kRingBytes - sizeof(__nv_bfloat16) * 16 * S::kStride >=
                    sizeof(float) * kMmaHeads *
                        (kWarps * DHP > kMaxSplits + 1 ? kWarps * DHP
                                                       : kMaxSplits + 1),
                "the ring holds the warps' state and the merge's scratch");
  return S::kRingBytes;
}

template <int DHP>
int launch_mma(const Args& a) {
  static size_t done = 48 << 10;
  constexpr size_t smem = mma_smem<DHP>();
  if (int err = allow_smem(window_attention_mma<DHP>, smem, done)) return err;
  window_attention_mma<DHP><<<grid_of(a, kMmaHeads), kThreads, smem,
                              a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const int32_t*>(a.kv_len), a.o, a.H, a.H / a.Hkv, a.W,
      a.dh, a.chunk, a.n_splits, a.ks[0], a.ks[1], a.ks[2], a.vs[0],
      a.vs[1], a.vs[2], a.vec, 1.0f / sqrtf(static_cast<float>(a.dh)));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const Args& a) {
  if (a.dh <= 16) return launch_mma<16>(a);
  if (a.dh <= 32) return launch_mma<32>(a);
  if (a.dh <= 64) return launch_mma<64>(a);
  if (a.dh <= 128) return launch_mma<128>(a);
  return launch_mma<256>(a);
}

// The compiled attributes of the body a bf16 launch at this dh takes.
template <int DHP>
int info_mma(int32_t* info) {
  cudaFuncAttributes at;
  int err = static_cast<int>(
      cudaFuncGetAttributes(&at, window_attention_mma<DHP>));
  if (err) return err;
  constexpr size_t smem = mma_smem<DHP>();
  static size_t done = 48 << 10;
  if ((err = allow_smem(window_attention_mma<DHP>, smem, done))) return err;
  int blocks = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, window_attention_mma<DHP>, kThreads, smem));
  info[0] = at.numRegs;
  info[1] = static_cast<int32_t>(at.localSizeBytes);
  info[2] = static_cast<int32_t>(at.sharedSizeBytes);
  info[3] = static_cast<int32_t>(smem);
  info[4] = blocks;
  info[5] = MmaShape<DHP>::kStages;
  return err;
}

}  // namespace

extern "C" {

// q: float32 [B, H, dh] contiguous.  k, v: [B, W, Hkv, dh] with element
// strides (ks, vs) = (batch, row, head) and unit stride in dh; kv_dtype
// 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core body).
// vec != 0: rows may be read in 16-byte pieces (the caller checks dh *
// element size, the strides and the bases: for bf16 K and V, for float32
// K).  kv_len: int32 [B], 1 <= kv_len <= W (not checked: a host check
// would synchronize every layer; kv_len is clamped to W and a kv_len <=
// 0 gives zeros).  part: float32 scratch of B * H * n_splits * (dh + 2)
// (acc, then m, then l); ticket: int32 [>= B * H], zero, and zero again
// when the launch ends (one launch at a time may use it); out: float32
// [B, H, dh].  Split s covers rows [s * chunk, (s + 1) * chunk).  Takes
// 1 <= dh <= 256, H a multiple of Hkv and n_splits <= 256.  row_m,
// row_l: float32 [B, H], or both null.  Given, the launch is the
// partial entry: out is each row's unnormalised merged sum, row_m its
// running max and row_l its sum of weights, and kv_len may be 0 (o = 0,
// m = -inf, l = 0).  Returns the cudaError_t of the launch (0 on
// success).
int window_attention_partial_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* part, void* ticket, void* out, int32_t B, int32_t H, int32_t Hkv,
    int32_t W, int32_t dh, int32_t chunk, int32_t n_splits, int64_t ksb,
    int64_t ksw, int64_t ksh, int64_t vsb, int64_t vsw, int64_t vsh,
    int32_t kv_dtype, int32_t vec, void* row_m, void* row_l, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dh < 1 || dh > kMaxDh || Hkv < 1 || H % Hkv != 0 || W < 1 ||
      chunk < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      static_cast<int64_t>(chunk) * n_splits < W || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  const int64_t n_part = static_cast<int64_t>(B) * H * n_splits;
  const Out o{p, p + n_part * dh, p + n_part * (dh + 1),
              static_cast<float*>(out), static_cast<int32_t*>(ticket),
              static_cast<float*>(row_m), static_cast<float*>(row_l)};
  const Args a{q, k, v, kv_len, o, B, H, Hkv, W, dh, chunk, n_splits, vec,
               {ksb, ksw, ksh}, {vsb, vsw, vsh},
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 0) return dispatch_f32(a);
  if (kv_dtype == 1) return dispatch_mma(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The whole attention: window_attention_partial_launch without row_m
// and row_l, out normalised.
int window_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* part, void* ticket,
                            void* out, int32_t B, int32_t H, int32_t Hkv,
                            int32_t W, int32_t dh, int32_t chunk,
                            int32_t n_splits, int64_t ksb, int64_t ksw,
                            int64_t ksh, int64_t vsb, int64_t vsw,
                            int64_t vsh, int32_t kv_dtype, int32_t vec,
                            void* stream) {
  return window_attention_partial_launch(
      q, k, v, kv_len, part, ticket, out, B, H, Hkv, W, dh, chunk, n_splits,
      ksb, ksw, ksh, vsb, vsw, vsh, kv_dtype, vec, nullptr, nullptr, stream);
}

// For a bf16 launch at this dh: the tensor-core body's registers a
// thread, local (spill) bytes a thread, static and dynamic shared bytes
// a block, resident blocks an SM and ring stages, in info[0..5].
// Returns the cudaError_t.
int window_attention_info(int32_t dh, int32_t* info) {
  if (dh < 1 || dh > kMaxDh) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 16) return info_mma<16>(info);
  if (dh <= 32) return info_mma<32>(info);
  if (dh <= 64) return info_mma<64>(info);
  if (dh <= 128) return info_mma<128>(info);
  return info_mma<256>(info);
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
