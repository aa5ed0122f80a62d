// msp_scan: the MSP scanner's recurrence over every read, in one launch.
//
// Replaces the JAX package's jax.lax.scan in msp_scan_batch
// (tpu_debruijn/msp.py:133-148, plain XLA; rust-debruijn's Scanner::scan,
// msp.rs:159-277), which the port's plain version runs as a Python loop of
// Lk - 1 steps over (R,) columns.  For kmer index i = 1 .. Lk - 1 of a read
// with p-mer scores s[0 .. N):
//   end = i + w - 1 (w = k - p + 1, the p-mers of one kmer)
//   rescan = i > mpos;  better = s[end] < mval   (strict: the older wins a tie)
//   (mval, mpos) = rescan ? min of s[i, i + w) : better ? (s[end], end) : as was
//   flag[i] = rescan | better
// with flag[0] = 1 and (mval, mpos) = min of s[0, w) at i = 0.  A window's
// minimum takes the rightmost position among equal scores (msp.rs:127-141).
// Scores are int32 order keys (the int32 view of a p-mer rank with its sign
// bit flipped, or a permutation's score), compared signed.
//
// Bound on the H100: device memory, scores in and flags, mvals and mposs out
// (~1.8 kB a read at phase 9's 160-base rows); the rescans are a few dozen
// compares a read on average and w a step at worst (rising scores).
//
// Design: one thread a read, the recurrence in registers.  A block of 64
// reads first copies its 64 score rows into shared memory with coalesced
// loads (a row stride made odd, so the 32 lanes of a warp reading one column
// of 32 rows hit 32 banks), then each thread walks its row there, rescanning
// the window itself, so no windowed-minimum table is built.  Outputs are
// written as (Lk, R) columns, lanes on consecutive reads, so every store is
// coalesced; the wrapper returns their (R, Lk) transposed views, the layout
// the plain loop returns.  Rows too long for a 48 KB tile are walked in
// device memory instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReads = 64;  // reads (threads) a block
constexpr int kTileBytes = 48 * 1024;

__device__ __forceinline__ void window_min(const int32_t* row, int i, int w, int32_t& v,
                                           int32_t& p) {
  v = row[i];
  p = i;
  for (int j = i + 1; j < i + w; ++j) {
    const int32_t s = row[j];
    if (s <= v) {  // the rightmost minimum
      v = s;
      p = j;
    }
  }
}

__global__ void __launch_bounds__(kReads)
msp_scan_kernel(const int32_t* __restrict__ scores, int r_count, int n, int w, int lk,
                int stride, bool tiled, uint8_t* __restrict__ flags,
                int32_t* __restrict__ mvals, int32_t* __restrict__ mposs) {
  extern __shared__ int32_t tile[];
  const int first = blockIdx.x * kReads;
  const int rows = min(kReads, r_count - first);
  const int r = first + threadIdx.x;
  const int32_t* row;
  if (tiled) {
    const int32_t* src = scores + (int64_t)first * n;
    for (int idx = threadIdx.x; idx < rows * n; idx += kReads) {
      const int rr = idx / n;
      tile[rr * stride + (idx - rr * n)] = __ldg(src + idx);
    }
    __syncthreads();
    row = tile + threadIdx.x * stride;
  } else {
    row = scores + (int64_t)r * n;
  }
  if (r >= r_count) return;

  int32_t mval, mpos;
  window_min(row, 0, w, mval, mpos);
  flags[r] = 1;
  mvals[r] = mval;
  mposs[r] = mpos;
  for (int i = 1; i < lk; ++i) {
    const int end = i + w - 1;
    const int32_t end_val = row[end];
    const bool rescan = i > mpos;
    const bool better = end_val < mval;
    if (rescan) {
      window_min(row, i, w, mval, mpos);
    } else if (better) {
      mval = end_val;
      mpos = end;
    }
    const int64_t o = (int64_t)i * r_count + r;
    flags[o] = rescan || better;
    mvals[o] = mval;
    mposs[o] = mpos;
  }
}

}  // namespace

// scores: (r_count, n) int32, row-major; w = k - p + 1; lk = n - w + 1 >= 1;
// flags (uint8 0/1), mvals, mposs: (lk, r_count), row-major.  r_count * n
// and lk * r_count are below 2^31.
extern "C" int tdb_msp_scan(const void* scores, int64_t r_count, int64_t n, int w,
                            void* flags, void* mvals, void* mposs, void* stream) {
  if (r_count == 0) return 0;
  const int64_t lk = n - w + 1;
  if (w < 1 || lk < 1 || r_count < 0 || r_count * n >= (1LL << 31) ||
      lk * r_count >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int stride = (int)(n | 1);
  const int64_t tile_bytes = (int64_t)kReads * stride * 4;
  const bool tiled = tile_bytes <= kTileBytes;
  const unsigned blocks = (unsigned)((r_count + kReads - 1) / kReads);
  msp_scan_kernel<<<blocks, kReads, tiled ? (size_t)tile_bytes : 0, (cudaStream_t)stream>>>(
      (const int32_t*)scores, (int)r_count, (int)n, w, (int)lk, stride, tiled,
      (uint8_t*)flags, (int32_t*)mvals, (int32_t*)mposs);
  return (int)cudaGetLastError();
}
