// run_reduce: the count's per-run reductions over sorted rows, in one launch.
//
// Replaces the JAX package's packed segmented suffix scans, which XLA runs
// as one int32 associative scan each: seg_or_suffix8
// (tpu_debruijn/sorting.py:316, the per-kmer exts OR of count_kmers) and
// _seg_sum_or_suffix (tpu_debruijn/filter.py:1195, the (count << 8) | exts
// fold of the corpus merge), with the run boundaries, counts, head rows and
// label reductions around them (tpu_debruijn/filter.py count_kmers).  Two
// forms:
//
// * The rows form, tdb_run_reduce_rows: the whole tail of the count in one
//   pass over its sorted packed observation rows (filter.pack_obs_rows: W
//   key limbs, the exts word, the label word, zero padding; 16 or 32 bytes).
//   A row starts a run where its key (the W limbs, and with by_label the
//   label word) differs from the previous row's.  Each run becomes one row:
//   its key, (min(count, 65535) << 8) | (OR of the exts' low bytes) in the
//   exts word, and its label under an op (the first, min, max, an int32
//   wrapping sum, or 0), written compacted at index = run number, which may
//   be in place over the front of the input.
// * The ends form, tdb_run_reduce: the OR of the low 8 bits of one int32
//   column and the int64 sum of another over runs given by their ends
//   (exclusive, strictly increasing, ends[u - 1] == n), for callers that
//   hold columns and run ends already (the colored pairs' rollup).
//
// Bound on the H100: device memory.  The rows form reads every row once
// (1.78 GB at the quick start's 111.4M 16-byte rows) and writes one row a
// run; the ends form reads a 4-byte column of the rows in place, so a
// 32-byte sector serves two rows.
//
// Rows form design: a single pass with a decoupled look-back.  A block
// takes its tile id from an atomic counter (so every lower tile is already
// running: the look-back cannot deadlock) and stages its 32 kB tile in
// shared memory by cp.async, 16 bytes a copy, coalesced; each thread's
// consecutive rows are padded by 16 bytes, so the lanes of a warp reading
// their k-th rows hit distinct banks.  Each thread walks its 8 (or 4) rows in
// order: a row starts a run where its key differs from the previous row's,
// and the thread's aggregate is (runs started, partial (count, OR, label) of
// its last run).  A shuffle scan and a pass over the warps give each thread
// its exclusive prefix within the tile; the tile publishes its aggregate,
// looks back over lower tiles to the nearest published prefix and publishes
// its own.  Then each thread walks its rows again with the true carry and
// run number: the head of a run writes the run that ended on the row before
// it, and the last row writes the last run.  No atomics on outputs, so a run
// of any length costs nothing extra and counts saturate exactly.
// The look-back bounds the design: a tile waits there for the slowest lower
// tile still in flight, so every thread of the block watches one lower tile
// (256 a round trip), and each status is two 64-bit words that carry their
// own valid bits (one round trip, no fences).  (A persistent grid that
// loads each tile one ahead ran slower: fewer tiles in flight.)
// In place is safe: the run ending before row i has a number below i, and
// a tile writes only after every lower tile has published, which it does
// only after loading its rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 16;  // chunks of 32 rows a warp
constexpr unsigned kFull = 0xffffffffu;

// The number of ends <= row (the run holding row), by a 32-ary search: each
// level the 32 lanes probe 32 points of [lo, hi) and a ballot narrows it.
__device__ __forceinline__ int64_t run_of(const int64_t* __restrict__ ends, int64_t u,
                                          int64_t row, int lane) {
  int64_t lo = 0, hi = u;  // ends[< lo] <= row < ends[>= hi]
  while (hi > lo) {
    const int64_t span = hi - lo;
    const int64_t probe = lo + span * (lane + 1) / 33;
    const unsigned le = __ballot_sync(kFull, __ldg(ends + probe) <= row);
    const int c = __popc(le);  // probes rise with the lane, so a prefix holds
    const int64_t below = __shfl_sync(kFull, probe, c > 0 ? c - 1 : 0);
    const int64_t above = __shfl_sync(kFull, probe, c < 32 ? c : 31);
    lo = c > 0 ? below + 1 : lo;
    hi = c < 32 ? above : hi;
  }
  return lo;
}

// The ends form: a flat pass, balanced whatever the run lengths.  One warp
// takes kChunks consecutive chunks of 32 rows, one row a lane, with every
// chunk's loads issued before the first is reduced.  Lane 0's run comes
// from a 32-ary search of ends (a ballot a level); within a chunk a lane's
// run is the warp's first run plus the run ends at or before it (one
// reduce-OR of the ends the warp loads).  A segmented suffix reduce by
// __shfl_down_sync leaves each run's total at its first lane in the chunk,
// which makes one atomicOr / atomicAdd into the zeroed outputs; the total of
// the chunk's last run is carried to the warp's next chunk instead, so a run
// of 10^7 rows costs one atomic a warp, not one a chunk.
template <bool kOr, bool kSum>
__global__ void __launch_bounds__(kThreads)
run_reduce_kernel(const int32_t* __restrict__ or_col, int64_t or_stride,
                  const int32_t* __restrict__ sum_col, int64_t sum_stride,
                  const int64_t* __restrict__ ends, int64_t n, int64_t u,
                  int32_t* __restrict__ or_out, int64_t* __restrict__ sum_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t first = warp * (32 * kChunks);
  if (first >= n) return;  // whole warps leave together

  // every chunk's loads in flight before the first reduce
  int32_t ov[kChunks];
  int64_t sv[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t row = first + 32 * c + lane;
    const bool in = row < n;
    ov[c] = kOr && in ? __ldg(or_col + row * or_stride) & 0xFF : 0;
    sv[c] = kSum && in ? (int64_t)__ldg(sum_col + row * sum_stride) : 0;
  }

  int64_t r0 = run_of(ends, u, first, lane);  // the run of the chunk's first row
  int64_t carry_run = -1;
  int32_t carry_or = 0;
  int64_t carry_sum = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t base = first + 32 * c;
    if (base >= n) break;
    // runs r0 .. r0 + 31 cover the chunk; the ends inside it start runs
    const int64_t e = r0 + lane < u ? __ldg(ends + r0 + lane) : INT64_MAX;
    const unsigned starts = __reduce_or_sync(
        kFull, e > base && e < base + 32 ? 1u << (unsigned)(e - base) : 0u);
    const bool next_starts = __any_sync(kFull, e == base + 32);
    const int64_t run = r0 + __popc(starts & ((2u << lane) - 1u));
    const int64_t row = base + lane;
    int32_t o = ov[c];
    int64_t s = sv[c];
    // segmented suffix reduce: a lane ends with its run's total from it on
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o2 = __shfl_down_sync(kFull, o, off);
      const int64_t s2 = __shfl_down_sync(kFull, s, off);
      const int64_t run2 = __shfl_down_sync(kFull, run, off);
      if (lane + off < 32 && run2 == run) {
        o |= o2;
        s += s2;
      }
    }
    const int64_t run_up = __shfl_up_sync(kFull, run, 1);
    const bool head = (lane == 0 || run_up != run) && row < n && run < u;
    // the previous chunk's carry joins lane 0's run, or is flushed
    if (carry_run >= 0) {
      const int64_t run0 = __shfl_sync(kFull, run, 0);
      if (lane == 0) {
        if (run0 == carry_run) {
          o |= carry_or;
          s += carry_sum;
        } else {
          if (kOr) atomicOr(or_out + carry_run, carry_or);
          if (kSum) atomicAdd((unsigned long long*)(sum_out + carry_run),
                              (unsigned long long)carry_sum);
        }
      }
      carry_run = -1;
    }
    const int64_t run_last = __shfl_sync(kFull, run, 31);
    const bool last_chunk = c == kChunks - 1 || base + 32 >= n;
    const bool keep = head && run == run_last && !last_chunk;
    if (head && !keep) {
      if (kOr) atomicOr(or_out + run, o);
      if (kSum) atomicAdd((unsigned long long*)(sum_out + run), (unsigned long long)s);
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    if (kept) {
      const int src = __ffs(kept) - 1;
      carry_run = run_last;
      carry_or = __shfl_sync(kFull, o, src);
      carry_sum = __shfl_sync(kFull, s, src);
    }
    r0 = run_last + (next_starts ? 1 : 0);
  }
}

template <bool kOr, bool kSum>
int launch(const int32_t* or_col, int64_t or_stride, const int32_t* sum_col,
           int64_t sum_stride, const int64_t* ends, int64_t n, int64_t u,
           int32_t* or_out, int64_t* sum_out, cudaStream_t s) {
  const int64_t warps = (n + 32 * kChunks - 1) / (32 * kChunks);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  run_reduce_kernel<kOr, kSum><<<(unsigned)blocks, kThreads, 0, s>>>(
      or_col, or_stride, sum_col, sum_stride, ends, n, u, or_out, sum_out);
  return (int)cudaGetLastError();
}


// ---- the rows form ---------------------------------------------------------

enum LabelOp { kFirst = 0, kMin = 1, kMax = 2, kSum = 3, kNone = 4 };

constexpr int kRowThreads = 256;  // threads a block; a tile is 32 kB of rows
constexpr int kCountMax = 65535;

// A run's partial reduction: rows (0: empty), exts OR, label.
struct Part {
  int32_t cnt, ors, lab;
};

template <int OP>
__device__ __forceinline__ int32_t op_lab(int32_t a, int32_t b) {
  if (OP == kMin) return min(a, b);
  if (OP == kMax) return max(a, b);
  if (OP == kSum) return (int32_t)((uint32_t)a + (uint32_t)b);  // wraps, as the JAX scan does
  return a;  // the first, which the stable sort left at the head
}

template <int OP>
__device__ __forceinline__ Part join(const Part& a, const Part& b) {
  return Part{a.cnt + b.cnt, a.ors | b.ors,
              a.cnt == 0 ? b.lab : b.cnt == 0 ? a.lab : op_lab<OP>(a.lab, b.lab)};
}

// (runs started, partial of the last run): the scan's element over a range of
// rows; a range with no run start extends the run open before it
struct Agg {
  int32_t heads;
  Part t;
};

template <int OP>
__device__ __forceinline__ Agg fold(const Agg& a, const Agg& b) {
  return Agg{a.heads + b.heads, b.heads > 0 ? b.t : join<OP>(a.t, b.t)};
}

__device__ __forceinline__ Agg shfl_up(const Agg& x, int off) {
  return Agg{__shfl_up_sync(kFull, x.heads, off),
             Part{__shfl_up_sync(kFull, x.t.cnt, off), __shfl_up_sync(kFull, x.t.ors, off),
                  __shfl_up_sync(kFull, x.t.lab, off)}};
}

__device__ __forceinline__ Agg shfl_down(const Agg& x, int off) {
  return Agg{__shfl_down_sync(kFull, x.heads, off),
             Part{__shfl_down_sync(kFull, x.t.cnt, off), __shfl_down_sync(kFull, x.t.ors, off),
                  __shfl_down_sync(kFull, x.t.lab, off)}};
}

// A tile's status for the look-back, its aggregate or its inclusive prefix:
// two 64-bit words, each with its own valid bit (bit 0), so a reader that
// sees both bits set holds the whole value, with no fence and one round
// trip: (heads << 33 | cnt << 2 | 1) and (lab << 32 | ors << 2 | 1).  heads
// and cnt are below 2^31.  The words are zeroed before the launch.
__device__ __forceinline__ void publish(ulonglong2* slot, const Agg& a) {
  volatile unsigned long long* s = reinterpret_cast<volatile unsigned long long*>(slot);
  s[0] = (unsigned long long)(uint32_t)a.heads << 33 | (unsigned long long)(uint32_t)a.t.cnt << 2 | 1ull;
  s[1] = (unsigned long long)(uint32_t)a.t.lab << 32 | (unsigned long long)(a.t.ors & 0xFF) << 2 | 1ull;
}

// Whether the slot is published, and if so its value.
__device__ __forceinline__ bool read_status(const ulonglong2* slot, Agg& a) {
  const volatile unsigned long long* s = reinterpret_cast<const volatile unsigned long long*>(slot);
  const unsigned long long w0 = s[0], w1 = s[1];
  a = Agg{(int32_t)(w0 >> 33), Part{(int32_t)((w0 >> 2) & 0x7fffffffu), (int32_t)((w1 >> 2) & 0xFF),
                                    (int32_t)(w1 >> 32)}};
  return (w0 & w1 & 1ull) != 0;
}

// The exclusive prefix of `tile`, by the whole block (every thread calls
// it): thread i watches tile base - i, kRowThreads tiles a round trip,
// until the nearest tile whose prefix is published; the aggregates after it
// are folded in tile order, by shuffle trees and then across warps.  The
// prefixes published lag the tiles in flight by about their number, so a
// round must cover many tiles.
template <int OP>
__device__ __forceinline__ Agg look_back(const ulonglong2* aggs, const ulonglong2* incs, int tile,
                                         unsigned* masks, Agg* warp_fold) {
  constexpr int kWarps = kRowThreads / 32;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  Agg acc{0, Part{0, 0, 0}};
  for (int base = tile - 1;; base -= kRowThreads) {
    const int j = base - threadIdx.x;
    Agg x{0, Part{0, 0, 0}};
    int state, stop;
    for (;;) {  // until every tile before the nearest prefix has its aggregate
      state = 2;  // before tile 0: an empty prefix
      if (j >= 0) {  // both slots at once: one round trip
        Agg v;
        const bool has_inc = read_status(incs + j, v);
        const bool has_agg = read_status(aggs + j, x);
        state = has_inc ? 2 : has_agg ? 1 : 0;
        if (has_inc) x = v;
      }
      const unsigned inc = __ballot_sync(kFull, state == 2);
      const unsigned none = __ballot_sync(kFull, state == 0);
      if (lane == 0) {
        masks[wid] = inc;
        masks[kWarps + wid] = none;
      }
      __syncthreads();
      stop = kRowThreads;
      bool pending = false;
      for (int w = 0; w < kWarps && stop == kRowThreads; ++w) {
        const unsigned m = masks[w], z = masks[kWarps + w];
        if (m) stop = 32 * w + __ffs(m) - 1;
        pending |= (z & (m ? (m & -m) - 1u : kFull)) != 0;
      }
      __syncthreads();
      if (!pending) break;
      __nanosleep(64);
    }
    if ((int)threadIdx.x > stop) x = Agg{0, Part{0, 0, 0}};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // earlier tiles sit in higher lanes
      const Agg y = shfl_down(x, off);
      if (lane + off < 32) x = fold<OP>(y, x);
    }
    if (lane == 0) warp_fold[wid] = x;
    __syncthreads();
    Agg window{0, Part{0, 0, 0}};
    for (int w = kWarps - 1; w >= 0; --w) window = fold<OP>(window, warp_fold[w]);
    acc = fold<OP>(window, acc);
    __syncthreads();
    if (stop < kRowThreads) return acc;
  }
}

// A tile in shared memory: each thread's R consecutive rows, then 16 bytes
// of padding, so the lanes of a warp reading their k-th rows hit distinct
// banks (a 144-byte stride).
template <int RW>
struct TileLayout {
  static constexpr int R = 32 / RW;              // rows a thread: 8 or 4
  static constexpr int kRows = kRowThreads * R;  // rows a tile
  static constexpr int kStride = R * RW + 4;     // words a thread's rows take
  static constexpr int kWords = kRowThreads * kStride;
  __device__ static int slot(int k) { return (k / R) * kStride + (k % R) * RW; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

template <int RW>
__device__ __forceinline__ void smem_row(const int32_t* p, int32_t (&r)[RW]) {
#pragma unroll
  for (int j = 0; j < RW; j += 4) {
    const int4 v = *reinterpret_cast<const int4*>(p + j);
    r[j] = v.x;
    r[j + 1] = v.y;
    r[j + 2] = v.z;
    r[j + 3] = v.w;
  }
}

// Whether two rows' keys differ: the W limbs, and the label word where
// `lmask` is all ones (by_label).
template <int W, int RW>
__device__ __forceinline__ bool differs(const int32_t (&a)[RW], const int32_t (&b)[RW],
                                        int32_t lmask) {
  int32_t d = (a[W + 1] ^ b[W + 1]) & lmask;
#pragma unroll
  for (int j = 0; j < W; ++j) d |= a[j] ^ b[j];
  return d != 0;
}

// One run's output row: the limbs of `key`, the packed count and OR, the
// label (0 under kNone); the rest zero.
template <int W, int RW, int OP>
__device__ __forceinline__ void write_run(int32_t* out, int run, const int32_t (&key)[RW],
                                          const Part& x) {
  int32_t r[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) r[j] = j < W ? key[j] : 0;
  r[W] = (min(x.cnt, kCountMax) << 8) | (x.ors & 0xFF);
  r[W + 1] = OP == kNone ? 0 : x.lab;
  int32_t* p = out + (int64_t)run * RW;
#pragma unroll
  for (int j = 0; j < RW; j += 4)
    *reinterpret_cast<int4*>(p + j) = make_int4(r[j], r[j + 1], r[j + 2], r[j + 3]);
}

template <int W, int OP>
__global__ void __launch_bounds__(kRowThreads, 4)
run_reduce_rows_kernel(const int32_t* in, int32_t* out, int n, int32_t lmask, int* counter,
                       int* u_out, ulonglong2* aggs, ulonglong2* incs, int tiles) {
  constexpr int RW = W <= 2 ? 4 : 8;
  using L = TileLayout<RW>;
  constexpr int R = L::R;
  extern __shared__ __align__(16) int32_t rows[];  // the tile, then the row before it
  __shared__ int tile_s;
  __shared__ Agg warp_agg[kRowThreads / 32];
  __shared__ Agg warp_pre[kRowThreads / 32];
  __shared__ unsigned lb_masks[2 * (kRowThreads / 32)];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = atomicAdd(counter, 1);  // ids in start order
  __syncthreads();
  const int tile = tile_s;
  const int tile_first = tile * L::kRows;  // n < 2^31

  // the tile's rows into shared memory, 16 bytes a copy, coalesced; rows
  // past n are zero
  constexpr int kParts = RW / 4;
#pragma unroll
  for (int c = threadIdx.x; c < L::kRows * kParts; c += kRowThreads) {
    const int k = c / kParts, part = c % kParts;
    const int g = tile_first + k;
    cp_async16(rows + L::slot(k) + 4 * part, in + (int64_t)(g < n ? g : 0) * RW + 4 * part,
               g < n ? 16 : 0);
  }
  if (threadIdx.x < kParts && tile_first > 0)
    cp_async16(rows + L::kWords + 4 * threadIdx.x,
               in + (int64_t)(tile_first - 1) * RW + 4 * threadIdx.x, 16);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // pass 1: each thread's R rows in order: runs started and the last's partial
  const int k0 = threadIdx.x * R;
  const int32_t* prev_p = k0 == 0 ? rows + L::kWords : rows + L::slot(k0 - 1);
  int32_t prev[RW], cur[RW];
  smem_row<RW>(prev_p, prev);
  Agg a{0, Part{0, 0, 0}};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = tile_first + k0 + r;
    smem_row<RW>(rows + L::slot(k0 + r), cur);
    const bool in_range = g < n;
    const bool head = in_range && (g == 0 || differs<W, RW>(cur, prev, lmask));
    const Part x{in_range ? 1 : 0, cur[W] & 0xFF, cur[W + 1]};
    a.heads += head;
    a.t = head ? x : join<OP>(a.t, x);
#pragma unroll
    for (int j = 0; j < RW; ++j) prev[j] = cur[j];
  }

  // the threads' exclusive prefixes within the block, then the tile's by the
  // look-back
  Agg incl = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg y = shfl_up(incl, off);
    if (lane >= off) incl = fold<OP>(y, incl);
  }
  Agg excl = shfl_up(incl, 1);
  if (lane == 0) excl = Agg{0, Part{0, 0, 0}};
  if (lane == 31) warp_agg[wid] = incl;
  __syncthreads();
  Agg agg{0, Part{0, 0, 0}};
  for (int i = 0; i < kRowThreads / 32; ++i) agg = fold<OP>(agg, warp_agg[i]);
  Agg pre{0, Part{0, 0, 0}};
  if (tile > 0) {
    if (threadIdx.x == 0) publish(aggs + tile, agg);
    pre = look_back<OP>(aggs, incs, tile, lb_masks, warp_pre);
  }
  if (threadIdx.x == 0) {
    const Agg inc = fold<OP>(pre, agg);
    publish(incs + tile, inc);
    if (tile == tiles - 1) *u_out = inc.heads;
    for (int i = 0; i < kRowThreads / 32; ++i) {
      warp_pre[i] = pre;
      pre = fold<OP>(pre, warp_agg[i]);
    }
  }
  __syncthreads();

  // pass 2: the same rows with the true carry and run number; the head of a
  // run writes the run that ended on the row before it, the last row the last
  const Agg mine = fold<OP>(warp_pre[wid], excl);
  Part carry = mine.t;
  int run = mine.heads;  // runs started before the row
  smem_row<RW>(prev_p, prev);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = tile_first + k0 + r;
    if (g >= n) break;
    smem_row<RW>(rows + L::slot(k0 + r), cur);
    const bool head = g == 0 || differs<W, RW>(cur, prev, lmask);
    const Part x{1, cur[W] & 0xFF, cur[W + 1]};
    if (head && g > 0) write_run<W, RW, OP>(out, run - 1, prev, carry);
    run += head;
    carry = head ? x : join<OP>(carry, x);
    if (g == n - 1) write_run<W, RW, OP>(out, run - 1, cur, carry);
#pragma unroll
    for (int j = 0; j < RW; ++j) prev[j] = cur[j];
  }
}

template <int W, int OP>
int launch_rows(const int32_t* in, int32_t* out, int n, int32_t lmask, int* scratch,
                cudaStream_t s) {
  constexpr int kTileRows = TileLayout<W <= 2 ? 4 : 8>::kRows;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  // scratch: counter, runs, 2 spare words, then each tile's aggregate and
  // inclusive prefix, all zeroed (unpublished)
  ulonglong2* aggs = reinterpret_cast<ulonglong2*>(scratch + 4);
  ulonglong2* incs = aggs + tiles;
  const int smem = (TileLayout<W <= 2 ? 4 : 8>::kWords + 8) * (int)sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(run_reduce_rows_kernel<W, OP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (4 + 8 * (size_t)tiles) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  run_reduce_rows_kernel<W, OP><<<(unsigned)tiles, kRowThreads, smem, s>>>(
      in, out, n, lmask, scratch, scratch + 1, aggs, incs, tiles);
  return (int)cudaGetLastError();
}

template <int W>
int launch_rows_op(const int32_t* in, int32_t* out, int n, int32_t lmask, int op, int* scratch,
                   cudaStream_t s) {
  switch (op) {
    case kFirst: return launch_rows<W, kFirst>(in, out, n, lmask, scratch, s);
    case kMin: return launch_rows<W, kMin>(in, out, n, lmask, scratch, s);
    case kMax: return launch_rows<W, kMax>(in, out, n, lmask, scratch, s);
    case kSum: return launch_rows<W, kSum>(in, out, n, lmask, scratch, s);
    case kNone: return launch_rows<W, kNone>(in, out, n, lmask, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// or_col / sum_col: int32 columns of n rows, element i at col[i * stride]
// (either may be null, not both); ends: (u,) int64, strictly increasing,
// ends[u - 1] == n; or_out (u,) int32 and sum_out (u,) int64, zeroed by the
// caller, null where not wanted.
extern "C" int tdb_run_reduce(const void* or_col, int64_t or_stride, const void* sum_col,
                              int64_t sum_stride, const void* ends, int64_t n, int64_t u,
                              void* or_out, void* sum_out, void* stream) {
  if (n == 0 || u == 0) return 0;
  if (n < 0 || u < 0 || u > n || (or_col == nullptr && sum_col == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* oc = (const int32_t*)or_col;
  const int32_t* sc = (const int32_t*)sum_col;
  const int64_t* e = (const int64_t*)ends;
  int32_t* oo = (int32_t*)or_out;
  int64_t* so = (int64_t*)sum_out;
  if (oc && sc) return launch<true, true>(oc, or_stride, sc, sum_stride, e, n, u, oo, so, s);
  if (oc) return launch<true, false>(oc, or_stride, sc, sum_stride, e, n, u, oo, so, s);
  return launch<false, true>(oc, or_stride, sc, sum_stride, e, n, u, oo, so, s);
}

// Words of scratch the rows form needs for n rows of rw words.
extern "C" int64_t tdb_run_reduce_rows_scratch(int64_t n, int rw) {
  const int64_t tile = (int64_t)kRowThreads * (32 / rw);
  const int64_t tiles = (n + tile - 1) / tile;
  return 4 + 8 * tiles;
}

// in: (n, rw) int32 rows, rw = 4 (w <= 2) or 8 (w = 3, 4), 16-byte
// aligned, sorted so equal keys are adjacent; the key is the w limb words
// and, with by_label, the label word w + 1; the exts word is w.  out:
// capacity n rows (may be in); run r goes to out[r].  scratch:
// tdb_run_reduce_rows_scratch(n, rw) int32 words, 16-byte aligned; the
// number of runs is left in scratch[1].  op: LabelOp.
extern "C" int tdb_run_reduce_rows(const void* in, void* out, int64_t n, int w, int by_label,
                                   int op, void* scratch, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)in;
  int32_t* o = (int32_t*)out;
  int* sc = (int*)scratch;
  const int32_t lmask = by_label ? -1 : 0;
  switch (w) {
    case 1: return launch_rows_op<1>(i, o, (int)n, lmask, op, sc, s);
    case 2: return launch_rows_op<2>(i, o, (int)n, lmask, op, sc, s);
    case 3: return launch_rows_op<3>(i, o, (int)n, lmask, op, sc, s);
    case 4: return launch_rows_op<4>(i, o, (int)n, lmask, op, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
