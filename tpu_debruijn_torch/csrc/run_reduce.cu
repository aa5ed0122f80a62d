// run_reduce: the count's segmented reduce over sorted rows, in one launch.
//
// Replaces the JAX package's packed segmented suffix scans, which XLA runs
// as one int32 associative scan each: seg_or_suffix8
// (tpu_debruijn/sorting.py:316, the per-kmer exts OR of count_kmers) and
// _seg_sum_or_suffix (tpu_debruijn/filter.py:1195, the (count << 8) | exts
// fold of the corpus merge).  Their values are read at run starts, so only
// the per-run totals are needed: the OR of the low 8 bits of one int32
// column over each run, and optionally the int64 sum of a second int32
// column over each run.  Runs partition [0, n) and end (exclusive) at
// ends[0..u), strictly increasing, ends[u - 1] == n.
//
// Bound on the H100: device memory.  The columns are read in place from
// the sorted packed observation rows (a pointer and a row stride: no
// contiguous copy), so a 4-byte word of a 16-byte row costs a 32-byte
// sector for two rows: 1.78 GB at the quick start's 111.4M rows, against
// ~0.5 GB of useful bytes.
//
// Design: a flat pass, balanced whatever the run lengths.  One warp takes
// kChunks consecutive chunks of 32 rows, one row a lane, with every chunk's
// loads issued before the first is reduced.  Lane 0's run comes from a
// 32-ary search of ends (a ballot a level); within a chunk a lane's run is
// the warp's first run plus the run ends at or before it (one reduce-OR of
// the ends the warp loads).  A segmented suffix reduce by __shfl_down_sync
// leaves each run's total at its first lane in the chunk, which makes one
// atomicOr / atomicAdd into the zeroed outputs; the total of the chunk's
// last run is carried to the warp's next chunk instead, so a run of 10^7
// rows costs one atomic a warp, not one a chunk.

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
