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
// Offsets are clamped to [0, n_src]; rows of x past offsets[n_rows]
// belong to no segment (the dropped sentinel rows).  The port's CPU
// path, segment_sum_csr_plain, does the same IEEE adds in the same
// order, so the two are bitwise equal.  A fixed order is the point:
// PyTorch's index_add_ adds with atomics on CUDA, in an order that
// changes from run to run.  So there is no tree, no shuffle reduction
// and no atomic here: each (segment, feature) pair is one thread's
// serial chain of adds.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// takes one add; each offset is read once; each output element is
// written once.  The design keeps enough of those bytes in flight, and
// enough serial chains of adds running, to reach the memory's rate:
//
// * A block takes a tile of consecutive segments: at most SEG_THREADS *
//   SEG_PAIRS (segment, feature) pairs, ~SEG_TILE_BYTES of x on average
//   (the host plan sizes it from shapes; no offset is read on the host).
//   Segments are contiguous, so the tile's offsets and its rows of x are
//   two contiguous byte ranges.
// * One producer thread stages both into shared memory with TMA 1-D bulk
//   copies (cp.async.bulk, completing on an mbarrier), through a ring of
//   stages: the tile's offsets and up to stage_x bytes of its x.  The
//   plan makes a stage 5/4 of an average tile's x, so a tile is summed
//   from one stage, and fills the block's share of shared memory with as
//   many stages as fit (at least 2, at most SEG_MAX_STAGES).  The
//   producer reads the row spans of its next SEG_LOOKAHEAD tiles ahead.
// * The grid is persistent (SEG_BLOCKS_PER_SM blocks an SM, tile t to
//   block t % grid), so the next tiles' bytes are in flight while this
//   one is summed.
// * SEG_THREADS consumer threads add from shared memory: a thread owns
//   SEG_PAIRS (segment, feature) pairs of the tile, numbered feature-
//   fastest, and adds each pair's rows serially in row order, the loads
//   of the next SEG_UNROLL rows in flight while as many are added.  A tile in one stage
//   costs each pair its rows' loads and adds and nothing else; a span
//   longer than a stage is walked stage by stage, each pair's sum carried
//   in a register, so a segment of L rows costs L dependent adds from
//   shared memory, not L / 8 dependent DRAM round trips.  The output is
//   written coalesced, a warp's 32 neighbouring elements at a time.
// * Stage boundaries are 16-byte aligned in x, so a stage may start or
//   end inside a row.  Across stages a pair keeps its rows still to add
//   and its next row's element as (stages ahead, element in that stage):
//   a few 32-bit operations and a multiply-shift division a stage.  A
//   bulk copy needs 16-byte aligned addresses and sizes: each copy takes
//   the 16-byte aligned bytes around its range that lie inside the
//   array, and the few bytes at either end of the array that fall
//   outside that are copied element by element, so nothing is read
//   outside x or the offsets.
// * A feature count above SEG_THREADS * SEG_PAIRS is cut into slabs of
//   that many features, one segment a tile; each slab reads the whole
//   rows (no caller of the port has one).
// * Offsets that decrease (outside the wrapper's contract) still give
//   the function above: a segment that reaches outside its tile's span
//   is read from global memory instead.
// * Row indices are 32-bit where x has fewer than 2^31 - 1 rows, 64-bit
//   otherwise; element indices are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SEG_THREADS
#define SEG_THREADS 256          // consumer threads a block (+ one warp)
#endif
#ifndef SEG_PAIRS
#define SEG_PAIRS 8              // (segment, feature) pairs a consumer thread
#endif
#ifndef SEG_STAGE_BYTES
#define SEG_STAGE_BYTES 65536    // bytes of x a stage holds at most
#endif
#ifndef SEG_MAX_STAGES
#define SEG_MAX_STAGES 16        // stages in the ring at most
#endif
#ifndef SEG_BLOCKS_PER_SM
#define SEG_BLOCKS_PER_SM 2      // blocks an SM the kernel is compiled for
#endif
#ifndef SEG_TILE_BYTES
#define SEG_TILE_BYTES 49152     // bytes of x the host plan aims a tile at
#endif
#ifndef SEG_UNROLL
#define SEG_UNROLL 8             // loads issued ahead of their adds
#endif
#ifndef SEG_LOOKAHEAD
#define SEG_LOOKAHEAD 4          // items whose spans a producer reads ahead
#endif

static_assert(SEG_THREADS % 32 == 0 && SEG_THREADS >= 32,
              "SEG_THREADS is whole warps");
static_assert(SEG_MAX_STAGES >= 1 && SEG_MAX_STAGES <= 16,
              "the barriers fit in kBarrierBytes");

constexpr int kPairs = SEG_THREADS * SEG_PAIRS;   // pairs a tile at most
constexpr int kBarrierBytes = 256;                // full[], empty[]
constexpr int kMaxSmem = 232448;                  // 227 KB a block

// The launch as the host planned it (file scope: see the .py wrapper).
struct SegArgs {
  const void* x;
  const void* offsets;
  void* y;
  int64_t n_rows, n_feat, n_src;
  int64_t n_items;    // tiles * slabs
  int32_t tile_rows;  // segments a tile
  int32_t n_slabs;    // feature slabs a tile
  int32_t slab;       // features a slab
  int32_t off_area;   // bytes of a stage's offset image
  int32_t stage_x;    // bytes of x a stage holds (a multiple of 16)
  int32_t n_stages;   // stages in the ring
};

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// An element of x in shared memory at byte address a, as float32.
__device__ __forceinline__ float lds(uint32_t a, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float lds(uint32_t a, __nv_bfloat16) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "SEG_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra SEG_WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uintptr_t down16(uintptr_t a) {
  return a & ~uintptr_t(15);
}
__device__ __forceinline__ uintptr_t up16(uintptr_t a) {
  return (a + 15) & ~uintptr_t(15);
}

// A bulk copy the producer issues after its barrier expects the bytes.
struct Bulk {
  unsigned char* dst;
  uintptr_t src;
  uint32_t bytes;
};

// Stage bytes [g0, g1) of an array [lo, hi) into dst so that dst[k] holds
// the byte at down16(g0) + k.  The 16-byte aligned part inside the array
// goes to *bulk; the rest (under 16 bytes at either end of the array) is
// copied here, element by element.  Returns whether any was.
template <typename E>
__device__ __forceinline__ bool stage_range(unsigned char* dst, uintptr_t g0,
                                            uintptr_t g1, uintptr_t lo,
                                            uintptr_t hi, Bulk* bulk) {
  const uintptr_t base = down16(g0);
  uintptr_t b0 = up16(lo) > base ? up16(lo) : base;
  uintptr_t b1 = down16(hi) < up16(g1) ? down16(hi) : up16(g1);
  if (b1 <= b0) b0 = b1 = g1;          // no aligned part: all by elements
  bulk->dst = dst + (b0 - base);
  bulk->src = b0;
  bulk->bytes = static_cast<uint32_t>(b1 - b0);
  bool copied = false;
  for (uintptr_t a = g0; a < b0 && a < g1; a += sizeof(E), copied = true)
    *reinterpret_cast<E*>(dst + (a - base)) = *reinterpret_cast<const E*>(a);
  for (uintptr_t a = b1 > g0 ? b1 : g0; a < g1; a += sizeof(E), copied = true)
    *reinterpret_cast<E*>(dst + (a - base)) = *reinterpret_cast<const E*>(a);
  return copied;
}

template <typename Row>
__device__ __forceinline__ Row clamp_row(int64_t v, Row n_src) {
  return static_cast<Row>(v < 0 ? 0 : (v > n_src ? n_src : v));
}

// The x bytes of a tile's row span [lo, hi): the first stage's image
// starts at down16 of its first byte, the others stage_x apart.
struct Span {
  uintptr_t g0, g1, base;
  int64_t n_chunks;
};
__device__ __forceinline__ Span x_span(uintptr_t x, int64_t lo, int64_t hi,
                                       int64_t row_bytes, int32_t stage_x) {
  Span s;
  s.g0 = x + static_cast<uintptr_t>(lo * row_bytes);
  s.g1 = x + static_cast<uintptr_t>(hi * row_bytes);
  s.base = down16(s.g0);
  s.n_chunks = hi > lo ? static_cast<int64_t>((s.g1 - s.base + stage_x - 1) /
                                              static_cast<uint32_t>(stage_x))
                       : 0;
  return s;
}

// acc + p[0] + p[stride] + ... + p[(n - 1) * stride] from shared memory
// at byte address a, in that order, for n >= SEG_UNROLL; the loads of
// the next SEG_UNROLL rows are in flight while this batch is added.
// Out of line: every pair of a thread may call it, and a walk of many
// rows pays for the call.
template <typename T>
__device__ __noinline__ float add_rows(float acc, uint32_t a, int stride,
                                       int n) {
  const uint32_t step = static_cast<uint32_t>(stride) * sizeof(T);
  float v[SEG_UNROLL];
#pragma unroll
  for (int k = 0; k < SEG_UNROLL; ++k) v[k] = lds(a + k * step, T());
  int i = SEG_UNROLL;
  for (; i + SEG_UNROLL <= n; i += SEG_UNROLL) {
    float w[SEG_UNROLL];
#pragma unroll
    for (int k = 0; k < SEG_UNROLL; ++k) w[k] = lds(a + (i + k) * step, T());
#pragma unroll
    for (int k = 0; k < SEG_UNROLL; ++k) {
      acc = __fadd_rn(acc, v[k]);
      v[k] = w[k];
    }
  }
#pragma unroll
  for (int k = 0; k < SEG_UNROLL; ++k) acc = __fadd_rn(acc, v[k]);
  for (; i < n; ++i) acc = __fadd_rn(acc, lds(a + i * step, T()));
  return acc;
}

// Rows [i0, i1) of feature f read straight from global memory.
template <typename T>
__device__ __noinline__ float add_global(float acc, const T* x,
                                         int64_t n_feat, int64_t f,
                                         int64_t i0, int64_t i1) {
  for (int64_t i = i0; i < i1; ++i)
    acc = __fadd_rn(acc, widen(x[i * n_feat + f]));
  return acc;
}

// n / d for 0 <= n < 2^31 as a multiply and a shift (d fixed for the
// launch; the rounding-up multiplier of Granlund and Montgomery).
struct FastDiv {
  uint32_t d, mul, shr;
  __device__ explicit FastDiv(uint32_t div) : d(div), mul(0), shr(0) {
    if (div > 1) {
      const uint32_t p = 31 + (32 - __clz(div - 1));
      mul = static_cast<uint32_t>(((1ull << p) + div - 1) / div);
      shr = p - 32;
    }
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
};

// The row span [lo, hi) of item `item`'s tile, clamped to [0, n_src].
template <typename OffT, typename Row>
__device__ __forceinline__ void item_span(const SegArgs& a, const OffT* off,
                                          int64_t item, Row* lo, Row* hi) {
  const int64_t r0 = (item / a.n_slabs) * a.tile_rows;
  const int64_t r1 = r0 + a.tile_rows < a.n_rows ? r0 + a.tile_rows
                                                 : a.n_rows;
  *lo = clamp_row(static_cast<int64_t>(off[r0]), static_cast<Row>(a.n_src));
  *hi = clamp_row(static_cast<int64_t>(off[r1]), static_cast<Row>(a.n_src));
}

// The producer (one thread): stages the offsets and rows of x of the
// block's items, one stage at a time, as stages come free.  The
// spans of the next SEG_LOOKAHEAD items are read while this one's stages
// are issued, so a span's round trip to memory is paid once for them.
template <typename T, typename OffT, typename Row>
__device__ void produce(const SegArgs& a, unsigned char* stages,
                        uint64_t* full, uint64_t* empty, int64_t first,
                        int64_t step) {
  const OffT* off = static_cast<const OffT*>(a.offsets);
  const uintptr_t xlo = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t xhi = xlo + static_cast<uintptr_t>(a.n_src * a.n_feat *
                                                     sizeof(T));
  const uintptr_t olo = reinterpret_cast<uintptr_t>(off);
  const uintptr_t ohi = olo + static_cast<uintptr_t>((a.n_rows + 1) *
                                                     sizeof(OffT));
  const int64_t row_bytes = a.n_feat * static_cast<int64_t>(sizeof(T));
  const int stage_bytes = a.off_area + a.stage_x;
  int stage = 0;
  uint32_t phase = 0;
  // the spans of the next SEG_LOOKAHEAD items, read ahead of their turn
  Row lo_ahead[SEG_LOOKAHEAD], hi_ahead[SEG_LOOKAHEAD];
#pragma unroll
  for (int j = 0; j < SEG_LOOKAHEAD; ++j) {
    lo_ahead[j] = hi_ahead[j] = 0;
    if (first + j * step < a.n_items)
      item_span(a, off, first + j * step, &lo_ahead[j], &hi_ahead[j]);
  }
  for (int64_t item = first; item < a.n_items; item += step) {
    const Row lo = lo_ahead[0], hi = hi_ahead[0];
#pragma unroll
    for (int j = 0; j + 1 < SEG_LOOKAHEAD; ++j) {
      lo_ahead[j] = lo_ahead[j + 1];
      hi_ahead[j] = hi_ahead[j + 1];
    }
    const int64_t later = item + SEG_LOOKAHEAD * step;
    if (later < a.n_items)
      item_span(a, off, later, &lo_ahead[SEG_LOOKAHEAD - 1],
                &hi_ahead[SEG_LOOKAHEAD - 1]);
    const int64_t r0 = (item / a.n_slabs) * a.tile_rows;
    const int64_t t_act = a.n_rows - r0 < a.tile_rows ? a.n_rows - r0
                                                      : a.tile_rows;
    const Span sp = x_span(xlo, lo, hi, row_bytes, a.stage_x);
    const int64_t uses = sp.n_chunks > 0 ? sp.n_chunks : 1;
    for (int64_t c = 0; c < uses; ++c) {
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = stages + stage * stage_bytes;
      Bulk offs = {st, 0, 0}, rows = {st, 0, 0};
      bool copied = false;
      if (c == 0) {
        const uintptr_t g0 = olo + r0 * sizeof(OffT);
        copied |= stage_range<OffT>(st, g0, g0 + (t_act + 1) * sizeof(OffT),
                                    olo, ohi, &offs);
      }
      if (c < sp.n_chunks) {
        const uintptr_t img = sp.base + c * a.stage_x;
        const uintptr_t w0 = sp.g0 > img ? sp.g0 : img;
        const uintptr_t w1 = sp.g1 < img + a.stage_x ? sp.g1
                                                     : img + a.stage_x;
        copied |= stage_range<T>(st + a.off_area, w0, w1, xlo, xhi, &rows);
      }
      // the element copies above are generic-proxy writes that a later
      // bulk copy into this stage must not overtake
      if (copied) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t bytes = offs.bytes + rows.bytes;
      if (bytes) mbar_arrive_tx(&full[stage], bytes);
      else mbar_arrive(&full[stage]);
      if (offs.bytes) bulk_load(offs.dst, offs.src, offs.bytes, &full[stage]);
      if (rows.bytes) bulk_load(rows.dst, rows.src, rows.bytes, &full[stage]);
      if (++stage == a.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Pair (r, f)'s segment [s, e) of a tile whose span is [lo, hi): s is
// clamped at 0 and e at n_src, and one beyond either side stays empty.
// Whether it lies inside the span (else it is read from global memory).
template <typename OffT, typename Row>
__device__ __forceinline__ bool segment(const OffT* ob, int r, int64_t n_src,
                                        Row lo, Row hi, Row* s, Row* e) {
  const int64_t s64 = static_cast<int64_t>(ob[r]);
  const int64_t e64 = static_cast<int64_t>(ob[r + 1]);
  *s = static_cast<Row>(s64 < 0 ? 0 : (s64 > n_src ? n_src + 1 : s64));
  *e = static_cast<Row>(e64 > n_src ? n_src : (e64 < 0 ? -1 : e64));
  return *s >= lo && *e <= hi;
}

// acc plus n rows of a feature from shared memory at byte address p,
// rows step bytes apart, in order.
template <typename T>
__device__ __forceinline__ float add_staged(float acc, uint32_t p,
                                            uint32_t step, int stride,
                                            int n) {
  if (n >= SEG_UNROLL) return add_rows<T>(acc, p, stride, n);
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, lds(p + i * step, T()));
  return acc;
}

// The consumer threads: thread t of nt adds its pairs of each of the
// block's items.
template <typename T, typename OffT, typename Row>
__device__ void consume(const SegArgs& a, unsigned char* stages,
                        uint64_t* full, uint64_t* empty, int64_t first,
                        int64_t step, int t, int nt) {
  const int lane = t & 31;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int F = static_cast<int>(a.n_feat);
  const uint32_t row_step = static_cast<uint32_t>(F * sizeof(T));
  const Row n_src = static_cast<Row>(a.n_src);
  const int64_t row_bytes = a.n_feat * static_cast<int64_t>(sizeof(T));
  const uintptr_t xlo = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t olo = reinterpret_cast<uintptr_t>(a.offsets);
  const FastDiv div_f(static_cast<uint32_t>(F));
  const FastDiv div_slab(static_cast<uint32_t>(a.slab));
  const int stage_elems = a.stage_x / static_cast<int>(sizeof(T));
  const FastDiv div_stage(static_cast<uint32_t>(stage_elems));
  const int stage_bytes = a.off_area + a.stage_x;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t item = first; item < a.n_items; item += step) {
    const int64_t tile = a.n_slabs == 1 ? item : item / a.n_slabs;
    const int f0 = static_cast<int>(item - tile * a.n_slabs) * a.slab;
    const int64_t r0 = tile * a.tile_rows;
    const int t_act = static_cast<int>(
        a.n_rows - r0 < a.tile_rows ? a.n_rows - r0 : a.tile_rows);
    mbar_wait(&full[stage], phase);
    const unsigned char* st = stages + stage * stage_bytes;
    const OffT* ob = reinterpret_cast<const OffT*>(st) +
                     ((olo + r0 * sizeof(OffT)) & 15) / sizeof(OffT);
    const Row lo = clamp_row(static_cast<int64_t>(ob[0]), n_src);
    Row hi = clamp_row(static_cast<int64_t>(ob[t_act]), n_src);
    hi = hi > lo ? hi : lo;   // a span that decreases is empty, at lo
    const Span sp = x_span(xlo, lo, hi, row_bytes, a.stage_x);
    // elements of the first stage's image before the span's first
    const int head = static_cast<int>((sp.g0 - sp.base) / sizeof(T));
    if (sp.n_chunks <= 1) {
      // the whole tile in this one stage: each pair sums its rows and
      // stores them, with no state carried between stages
      const uint32_t xs = smem_u32(st + a.off_area);
#pragma unroll
      for (int k = 0; k < SEG_PAIRS; ++k) {
        const int q = t + k * nt;
        const int r = static_cast<int>(div_slab(q));
        const int f = f0 + (q - r * a.slab);
        if (r < t_act && f < F) {
          Row s, e;
          float v = 0.0f;
          if (!segment(ob, r, a.n_src, lo, hi, &s, &e))
            v = add_global(v, x, a.n_feat, f, s, e);
          else if (e > s)
            v = add_staged<T>(
                v, xs + static_cast<uint32_t>((s - lo) * F + f + head) *
                            static_cast<uint32_t>(sizeof(T)),
                row_step, F, static_cast<int>(e - s));
          store(y + (r0 + r) * a.n_feat + f, v);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == a.n_stages) {
        stage = 0;
        phase ^= 1;
      }
      continue;
    }
    // a span over several stages: each pair's sum, its rows still to
    // add, and its next row's element as (stages ahead, element in that
    // stage's image)
    float acc[SEG_PAIRS];
    Row rem[SEG_PAIRS];
    int ahead[SEG_PAIRS], at[SEG_PAIRS];
#pragma unroll
    for (int k = 0; k < SEG_PAIRS; ++k) {
      const int q = t + k * nt;
      const int r = static_cast<int>(div_slab(q));
      const int f = f0 + (q - r * a.slab);
      acc[k] = 0.0f;
      rem[k] = 0;
      ahead[k] = 0;
      at[k] = 0;
      if (r < t_act && f < F) {
        Row s, e;
        if (!segment(ob, r, a.n_src, lo, hi, &s, &e)) {
          acc[k] = add_global(acc[k], x, a.n_feat, f, s, e);
        } else if (e > s) {
          rem[k] = e - s;
          const int64_t el = static_cast<int64_t>(s - lo) * F + f + head;
          ahead[k] = static_cast<int>(el / stage_elems);
          at[k] = static_cast<int>(el - static_cast<int64_t>(ahead[k]) *
                                            stage_elems);
        }
      }
    }
    for (int64_t c = 0; c < sp.n_chunks; ++c) {
      if (c > 0) mbar_wait(&full[stage], phase);
      const uint32_t xs = smem_u32(stages + stage * stage_bytes + a.off_area);
#pragma unroll
      for (int k = 0; k < SEG_PAIRS; ++k) {
        if (rem[k] <= 0) continue;
        if (ahead[k] > 0) {
          --ahead[k];
          continue;
        }
        // the rows whose elements lie in this stage's image
        const uint32_t fit = div_f(stage_elems - at[k] + F - 1);
        const int n = rem[k] < static_cast<Row>(fit) ? static_cast<int>(rem[k])
                                                     : static_cast<int>(fit);
        acc[k] = add_staged<T>(
            acc[k], xs + at[k] * static_cast<uint32_t>(sizeof(T)), row_step,
            F, n);
        rem[k] -= n;
        // the next row's element, from the next stage's image (past
        // this one: n rows took all of it that the pair has)
        const int next = at[k] + n * F - stage_elems;
        ahead[k] = static_cast<int>(div_stage(static_cast<uint32_t>(next)));
        at[k] = next - ahead[k] * stage_elems;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == a.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int k = 0; k < SEG_PAIRS; ++k) {
      const int q = t + k * nt;
      const int r = static_cast<int>(div_slab(q));
      const int f = f0 + (q - r * a.slab);
      if (r < t_act && f < F) store(y + (r0 + r) * a.n_feat + f, acc[k]);
    }
  }
}

template <typename T, typename OffT, typename Row>
__global__ void __launch_bounds__(SEG_THREADS + 32, SEG_BLOCKS_PER_SM)
segment_sum_kernel(const __grid_constant__ SegArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + SEG_MAX_STAGES;
  unsigned char* stages = smem + kBarrierBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.n_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], SEG_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == SEG_THREADS)
    produce<T, OffT, Row>(a, stages, full, empty, blockIdx.x, gridDim.x);
  else if (threadIdx.x < SEG_THREADS)
    consume<T, OffT, Row>(a, stages, full, empty, blockIdx.x, gridDim.x,
                          threadIdx.x, SEG_THREADS);
}

template <typename T, typename OffT, typename Row>
int launch(const SegArgs& a, unsigned int grid, int smem, cudaStream_t s) {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(segment_sum_kernel<T, OffT, Row>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  segment_sum_kernel<T, OffT, Row><<<grid, SEG_THREADS + 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit rows where x has fewer than 2^31 - 1 of them (a segment's end
// may stand one past n_src, see consume)
template <typename T, typename OffT>
int launch_rows(const SegArgs& a, unsigned int grid, int smem,
                cudaStream_t s) {
  if (a.n_src < 0x7fffffff) return launch<T, OffT, int32_t>(a, grid, smem, s);
  return launch<T, OffT, int64_t>(a, grid, smem, s);
}

}  // namespace

extern "C" {

// The build's geometry, for the host plan: threads, pairs a thread,
// largest stage's bytes of x, stages at most, blocks an SM, tile bytes,
// barrier bytes.
void segment_sum_geometry(int32_t* out) {
  out[0] = SEG_THREADS;
  out[1] = SEG_PAIRS;
  out[2] = SEG_STAGE_BYTES;
  out[3] = SEG_MAX_STAGES;
  out[4] = SEG_BLOCKS_PER_SM;
  out[5] = SEG_TILE_BYTES;
  out[6] = kBarrierBytes;
}

// y [n_rows, n_feat] = segment sums of x [n_src, n_feat] over the
// n_rows segments that offsets [n_rows + 1] delimits, as the host plan
// says: tile_rows segments a tile, n_slabs feature slabs, n_stages
// stages of stage_x bytes of x, grid blocks.  dtype: 0 = float32, 1 = bfloat16 (x and y
// alike; the sum is float32 either way).  offsets_64: offsets are int64
// (1) or int32 (0).  Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for a plan this build cannot run.
int segment_sum_launch(const void* x, const void* offsets,
                       int32_t offsets_64, void* y, int64_t n_rows,
                       int64_t n_feat, int64_t n_src, int32_t dtype,
                       int64_t tile_rows, int64_t n_slabs, int64_t stage_x,
                       int64_t n_stages, int64_t grid, void* stream) {
  if (n_rows <= 0 || n_feat <= 0) return 0;
  const int64_t slab = n_slabs > 1 ? kPairs : n_feat;
  const int64_t off_bytes = offsets_64 ? 8 : 4;
  const int64_t off_area = ((tile_rows + 1) * off_bytes + 30 + 15) / 16 * 16;
  const int64_t smem = kBarrierBytes + n_stages * (off_area + stage_x);
  const int64_t n_items = (n_rows + tile_rows - 1) / tile_rows * n_slabs;
  if (n_feat > 0x3fffffff || n_src < 0 || tile_rows < 1 || n_slabs < 1 ||
      tile_rows * slab > kPairs || slab * n_slabs < n_feat ||
      (n_slabs > 1 && tile_rows != 1) || stage_x < 16 ||
      stage_x > SEG_STAGE_BYTES || stage_x % 16 || n_stages < 1 ||
      n_stages > SEG_MAX_STAGES || smem > kMaxSmem || grid < 1 ||
      grid > n_items || grid > 0x7fffffff || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a;
  a.x = x;
  a.offsets = offsets;
  a.y = y;
  a.n_rows = n_rows;
  a.n_feat = n_feat;
  a.n_src = n_src;
  a.n_items = n_items;
  a.tile_rows = static_cast<int32_t>(tile_rows);
  a.n_slabs = static_cast<int32_t>(n_slabs);
  a.slab = static_cast<int32_t>(slab);
  a.off_area = static_cast<int32_t>(off_area);
  a.stage_x = static_cast<int32_t>(stage_x);
  a.n_stages = static_cast<int32_t>(n_stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int g = static_cast<unsigned int>(grid);
  const int sm = static_cast<int>(smem);
  if (dtype == 0 && offsets_64)
    return launch_rows<float, int64_t>(a, g, sm, s);
  if (dtype == 0) return launch_rows<float, int32_t>(a, g, sm, s);
  if (offsets_64) return launch_rows<__nv_bfloat16, int64_t>(a, g, sm, s);
  return launch_rows<__nv_bfloat16, int32_t>(a, g, sm, s);
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
