// msp_scan: the MSP scanner over every read, in one launch.
//
// Replaces the JAX package's jax.lax.scan in msp_scan_batch
// (tpu_debruijn/msp.py:133-148, plain XLA; rust-debruijn's Scanner::scan,
// msp.rs:159-277) and, in the reads form, the p-mer rank extraction and
// scoring before it (msp.py:114-126).  For kmer index i = 1 .. Lk - 1 of a
// read with p-mer scores s[0 .. N):
//   end = i + w - 1 (w = k - p + 1, the p-mers of one kmer)
//   rescan = i > mpos;  better = s[end] < mval   (strict: the older wins a tie)
//   (mval, mpos) = rescan ? min of s[i, i + w) : better ? (s[end], end) : as was
//   flag[i] = rescan | better
// with flag[0] = 1 and (mval, mpos) = min of s[0, w) at i = 0.  A window's
// minimum takes the rightmost position among equal scores (msp.rs:127-141).
// Scores are int32 order keys (the int32 view of a p-mer rank with its sign
// bit flipped, or a permutation's score), compared signed.  Two forms:
//
// * The reads form, tdb_msp_scan_reads: from the padded read bases (R, L)
//   uint8 to flags, the minimizer's forward rank and its position, (Lk, R)
//   each.  Every position is computed, padding included.
// * The scores form, tdb_msp_scan: the recurrence alone over (R, N) int32
//   scores, writing flags, scores and positions.
//
// Bound on the H100: device memory.  The reads form reads L bytes a read
// and writes 9 bytes a kmer position (~1.3 kB a read at phase 9's 160-base
// rows: 155 MB a source block).  Each read is a serial chain of L steps, so
// in practice its time is the chain's latency times the reads an SM holds.
//
// Reads form design: one thread a read, no step that diverges for long.
// The thread streams its row's bases (16-byte loads issued 16 steps ahead
// where rows allow), rolls the forward and reverse-complement ranks as
// 2p-bit values, scores each p-mer (the order key, or the permutation table
// through the read-only cache) and keeps the last w (score, forward rank)
// pairs in a ring in shared memory, laid out [slot][thread] so the lanes of
// a warp, which step in lockstep, touch one slot at a time.  A rescan needs
// the minimum of the window [i, i + w): cut the p-mers into blocks of w,
// keep the running minimum of the current block in registers, and when a
// block is whole compute its suffix minima once (w steps, every lane at
// once); the window is then the suffix of the last block beside the prefix
// of this one, so a rescan costs two shared loads instead of w compares in
// a loop that diverges.  The suffix minima are kept as offsets (a byte
// each): their scores and ranks are still in the ring.  A read needs 9
// bytes of shared memory a unit of w (216 B at w = 24), so an SM holds
// 1,024 reads.  Outputs are written as (Lk, R) columns, lanes on
// consecutive reads, so every store is coalesced; the wrapper returns
// their (R, Lk) transposed views.
//
// Scores form design: one thread a read over scores staged in shared
// memory (64 rows, an odd row stride against bank conflicts), or walked in
// device memory when a tile would exceed 48 KB.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kReads = 64;  // reads (threads) a block, in both forms
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


template <bool kVec, bool kPerm>
__global__ void __launch_bounds__(kReads)
msp_scan_reads_kernel(const uint8_t* __restrict__ bases, int r_count, int l, int p, int w,
                      const int32_t* __restrict__ perm, bool rc, uint8_t* __restrict__ flags,
                      int32_t* __restrict__ min_rank, int32_t* __restrict__ min_pos) {
  // per thread, laid out [slot][thread]: the ring of the last w p-mers'
  // (score, forward rank), slot = p-mer index % w, then for each offset t of
  // the last whole block of w p-mers the offset of the least score in
  // [t, w) (its score and rank stay in the ring until the next block
  // overwrites them, after the last query of them)
  extern __shared__ int2 smem[];
  const int r = blockIdx.x * kReads + threadIdx.x;
  if (r >= r_count) return;
  int2* ring = smem + threadIdx.x;
  uint8_t* suf = reinterpret_cast<uint8_t*>(smem + w * kReads) + threadIdx.x;
  const uint8_t* row = bases + (int64_t)r * l;
  const uint32_t mask = p >= 16 ? 0xffffffffu : (1u << (2 * p)) - 1u;
  const int top = 2 * (p - 1);  // where a base enters the reverse complement
  uint32_t fwd = 0, rev = 0, word = 0, mrank = 0, prank = 0;
  int32_t mval = 0, mpos = 0, pval = 0, ppos = 0;
  int o = w - 1;  // p-mer q's offset in its block, q % w
  int2* slot = ring + (w - 1) * kReads;  // ring slot o
  uint8_t* f_out = flags + r;  // the outputs of kmer i, advanced a row a step
  int32_t* r_out = min_rank + r;
  int32_t* p_out = min_pos + r;
  // with kVec the bases come 16 a load, each load issued 16 steps before use
  const uint4* row16 = reinterpret_cast<const uint4*>(row);
  uint4 cur = kVec ? __ldg(row16) : make_uint4(0, 0, 0, 0), nxt = cur;
  for (int j = 0; j < l; ++j) {
    uint32_t b;
    if (kVec) {
      if ((j & 15) == 0) {
        if (j > 0) cur = nxt;
        if (j + 16 < l) nxt = __ldg(row16 + (j >> 4) + 1);
      }
      if ((j & 3) == 0) {
        word = cur.x;
        cur.x = cur.y;
        cur.y = cur.z;
        cur.z = cur.w;
      }
      b = (word >> (8 * (j & 3))) & 3u;
    } else {
      b = __ldg(row + j) & 3u;
    }
    fwd = ((fwd << 2) | b) & mask;
    rev = (rev >> 2) | ((3u - b) << top);
    if (j < p - 1) continue;
    const int q = j - p + 1;  // the p-mer ending at base j
    int32_t s = kPerm ? __ldg(perm + fwd) : (int32_t)(fwd ^ 0x80000000u);
    if (rc) s = min(s, kPerm ? __ldg(perm + rev) : (int32_t)(rev ^ 0x80000000u));
    if (o + 1 == w) {
      o = 0;
      slot = ring;
    } else {
      o += 1;
      slot += kReads;
    }
    *slot = make_int2(s, (int32_t)fwd);
    if (o == 0 || s <= pval) {  // the block's running minimum, the rightmost
      pval = s;
      ppos = q;
      prank = fwd;
    }
    if (o == w - 1) {
      // the block is whole: its suffix minima, right to left (the right one
      // keeps a tie); every lane is at the same offset, so none diverges
      int32_t bv = s;
      int bo = o;
      suf[o * kReads] = (uint8_t)bo;
      for (int t = w - 2; t >= 0; --t) {
        const int32_t e = ring[t * kReads].x;
        if (e < bv) {
          bv = e;
          bo = t;
        }
        suf[t * kReads] = (uint8_t)bo;
      }
    }
    if (q < w - 1) continue;
    const int i = q - w + 1;  // the kmer whose window [i, q] ends at p-mer q
    bool flag = true;
    if (i == 0 || i > mpos) {
      // rescan: the window is this block (o = w - 1), or the suffix of the
      // last block from i (offset o + 1) beside this block's running minimum
      const int so = o == w - 1 ? 0 : suf[(o + 1) * kReads];
      const int2 e = o == w - 1 ? make_int2(INT_MAX, 0) : ring[so * kReads];
      if (pval <= e.x) {
        mval = pval;
        mpos = ppos;
        mrank = prank;
      } else {
        mval = e.x;
        mpos = q - o - w + so;  // the last block starts at q - o - w
        mrank = (uint32_t)e.y;
      }
    } else if (s < mval) {
      mval = s;
      mpos = q;
      mrank = fwd;
    } else {
      flag = false;
    }
    *f_out = flag;
    *r_out = (int32_t)mrank;
    *p_out = mpos;
    f_out += r_count;
    r_out += r_count;
    p_out += r_count;
  }
}

template <bool kVec, bool kPerm>
int launch_reads(const uint8_t* bases, int r_count, int l, int p, int w, const int32_t* perm,
                 bool rc, uint8_t* flags, int32_t* min_rank, int32_t* min_pos, cudaStream_t s) {
  const size_t smem = (size_t)w * kReads * (sizeof(int2) + 1);  // 36 kB at most (w = 64)
  const unsigned blocks = (unsigned)((r_count + kReads - 1) / kReads);
  msp_scan_reads_kernel<kVec, kPerm><<<blocks, kReads, smem, s>>>(
      bases, r_count, l, p, w, perm, rc, flags, min_rank, min_pos);
  return (int)cudaGetLastError();
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

// bases: (r_count, l) uint8 2-bit codes, row-major; 1 <= p <= 16,
// w = k - p + 1 in [1, 64], lk = l - k + 1 >= 1; perm: (4^p,) int32 scores
// or null for the order key; flags (uint8 0/1), min_rank (the int32 view of
// the minimizer's forward rank), min_pos: (lk, r_count), row-major.
// r_count * l and lk * r_count are below 2^31.
extern "C" int tdb_msp_scan_reads(const void* bases, int64_t r_count, int64_t l, int p, int w,
                                  const void* perm, int rc, void* flags, void* min_rank,
                                  void* min_pos, void* stream) {
  if (r_count == 0) return 0;
  const int64_t lk = l - (p + w - 1) + 1;
  if (p < 1 || p > 16 || w < 1 || w > 64 || lk < 1 || r_count < 0 ||
      r_count * l >= (1LL << 31) || lk * r_count >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const uint8_t* b = (const uint8_t*)bases;
  const int32_t* pm = (const int32_t*)perm;
  uint8_t* f = (uint8_t*)flags;
  int32_t* mr = (int32_t*)min_rank;
  int32_t* mp = (int32_t*)min_pos;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = l % 16 == 0 && (uintptr_t)bases % 16 == 0;
  const int rr = (int)r_count, ll = (int)l;
  if (vec && pm) return launch_reads<true, true>(b, rr, ll, p, w, pm, rc, f, mr, mp, s);
  if (vec) return launch_reads<true, false>(b, rr, ll, p, w, pm, rc, f, mr, mp, s);
  if (pm) return launch_reads<false, true>(b, rr, ll, p, w, pm, rc, f, mr, mp, s);
  return launch_reads<false, false>(b, rr, ll, p, w, pm, rc, f, mr, mp, s);
}
