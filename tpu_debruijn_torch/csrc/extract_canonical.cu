// Fused kmer extraction kernel: window pack, reverse complement, canonical
// min, Exts byte and validity, from the raw base matrix in one pass.
//
// Replaces the Pallas kernel tpu_debruijn/kernels/extract_canonical.py::_kernel
// (called through _call / extract_canonical_fused).
//
// Layout: bases (R, L) uint8 2-bit codes, row-major; lengths (R,) int32;
// seq_exts (R,) int32.  Outputs: limbs (R, Lk, W) int64 (each a 32-bit value,
// most-significant limb first, value right-aligned), exts (R, Lk) int32 and
// valid (R, Lk) bool, valid = pos <= len - K, Lk = L - K + 1.  Slots past
// len - K are invalid but still written.
//
// Bound on the H100: device memory on the write side.  Each input byte read
// once and each output byte written once is L + 8 bytes per read in and
// Lk * (8W + 5) bytes out, ~20x the input at K = 31: 2.69 GB and 0.803 ms at
// 3.35 TB/s for 928,331 reads of 160 bases.
//
// Design.  The first version spent its time on instructions: 2K single-byte
// loads per slot and a 64-bit division per slot.  Here a block takes a tile
// of pieces (a piece is a row, or SEG_MAX slots of a longer row; pieces of
// one tile are consecutive, so the tile's outputs are three contiguous runs):
// 1. Each piece's 16-base chunks are loaded with one 16-byte load each (when
//    L is a multiple of 16) and packed into 32-bit words, first base in the
//    top bits, in shared memory; the same word, 2-bit reversed and
//    complemented, is the rc strand's word of the row padded to 16 NW bases.
// 2. One thread per slot builds each of its W forward and W rc limbs from
//    two words with one funnel shift: O(W) work whatever K is.  The Exts
//    nibbles come from the packed words.  The thread stores its slot's limbs
//    (16-byte stores for even W), exts and valid byte itself; neighbouring
//    threads write neighbouring slots, so every store instruction of a warp
//    covers one contiguous run.
// Measured on the H100 at the shape above (PERF.md): 1.17 ms, 69% of the
// bound.  Two neighbouring slots per thread (shared words, but each store
// instruction of a warp then strided) took 2.29 ms; staging the tile's
// outputs in shared memory for 16-byte copies took 1.31-1.53 ms.
// The plain transcription is extract_canonical_tiled_plain
// (kernels/extract_canonical.py), which uses the same piece layout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PIECES = 64;  // pieces per tile at most

struct Piece {
  int64_t row;
  int64_t out0;  // row * Lk: the row's first slot in the outputs
  int s0, s1;  // slots [s0, s1) of the row
  int ca, cb;  // chunks ca..cb of the row are packed
  int len, se;
};

__device__ __forceinline__ int32_t exts_rc(int32_t e) {
  e = ((e & 0x0F) << 4) | ((e >> 4) & 0x0F);
  e = ((e & 0x55) << 1) | ((e >> 1) & 0x55);
  return ((e & 0x33) << 2) | ((e >> 2) & 0x33);
}

// four bytes (little-endian, first base lowest) -> 8 bits, first base on top
__device__ __forceinline__ uint32_t pack4(uint32_t b) {
  return ((b & 3u) << 6) | (((b >> 8) & 3u) << 4) | (((b >> 16) & 3u) << 2) |
         ((b >> 24) & 3u);
}

// the reversed, complemented word: 16 bases read backwards, each 3 - base
__device__ __forceinline__ uint32_t rc_word(uint32_t f) {
  uint32_t r = __brev(f);
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return ~r;
}

// 16 bases starting `bit / 2` bases into word i, first base on top
__device__ __forceinline__ uint32_t window(const uint32_t* w, int i, int bit) {
  return __funnelshift_l(w[i + 1], w[i], bit);
}

template <int W, bool STRANDED>
__global__ void __launch_bounds__(THREADS) extract_canonical_kernel(
    const uint8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ seq_exts, int64_t r, int l, int k, int seg,
    int nseg, int wst, int tp, bool vec, int64_t* __restrict__ out_kmers,
    int32_t* __restrict__ out_exts, bool* __restrict__ out_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  Piece* pieces = reinterpret_cast<Piece*>(smem);
  uint32_t* fw = reinterpret_cast<uint32_t*>(pieces + tp);  // [tp][wst]
  uint32_t* rw = fw + tp * wst;                              // [tp][wst]
  const int lk = l - k + 1;
  const int nw = (l + 15) >> 4;
  const int nb_low = k - 16 * (W - 1);  // bases in the (partial) top limb
  const int64_t npieces = r * nseg;
  const int64_t ntiles = (npieces + tp - 1) / tp;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t p0 = tile * tp;
    const int np = (int)min((int64_t)tp, npieces - p0);
    if (threadIdx.x < np) {
      const int64_t p = p0 + threadIdx.x;
      Piece q;
      q.row = nseg == 1 ? p : p / nseg;
      q.out0 = q.row * lk;
      q.s0 = (int)(p - q.row * nseg) * seg;
      q.s1 = min(q.s0 + seg, lk);
      q.ca = max(0, (q.s0 - 1) >> 4);
      q.cb = min(nw - 1, (q.s1 - 1 + k) >> 4);
      q.len = lengths[q.row];
      q.se = seq_exts[q.row];
      pieces[threadIdx.x] = q;
    }
    __syncthreads();

    // 1. pack: word cl of piece pi is chunk ca + cl; the rc word of chunk c
    //    goes to cb - c; every word past the piece's last is 0
    for (int it = threadIdx.x; it < np * wst; it += THREADS) {
      const int pi = it / wst;
      const int cl = it - pi * wst;
      const Piece& q = pieces[pi];
      const int c = q.ca + cl;
      if (c <= q.cb) {
        const uint8_t* src = bases + q.row * (int64_t)l + 16 * c;
        uint32_t f = 0;
        if (vec) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          f = (pack4(v.x) << 24) | (pack4(v.y) << 16) | (pack4(v.z) << 8) |
              pack4(v.w);
        } else {
          for (int t = 0; t < 16; ++t)
            f = (f << 2) | (16 * c + t < l ? (uint32_t)(src[t] & 3) : 0u);
        }
        fw[pi * wst + cl] = f;
        rw[pi * wst + (q.cb - c)] = rc_word(f);
      } else {
        fw[pi * wst + cl] = 0;
        rw[pi * wst + cl] = 0;
      }
    }
    __syncthreads();

    // 2. one thread per slot; slot sl of piece pi
    int pi = threadIdx.x / seg, sl = threadIdx.x - pi * seg;
    for (; pi < np; sl += THREADS) {
      if (seg >= 64) {
        while (sl >= seg) sl -= seg, ++pi;
      } else {
        const int d = sl / seg;
        pi += d;
        sl -= d * seg;
      }
      if (pi >= np) break;
      const Piece& q = pieces[pi];
      const int s = q.s0 + sl;
      if (s >= q.s1) continue;
      const uint32_t* F = fw + pi * wst;
      const uint32_t* RC = rw + pi * wst;
      uint32_t fwd[W], rcl[W] = {};
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int c0 = j == 0 ? 0 : nb_low + 16 * (j - 1);
        const int drop = 32 - 2 * (j == 0 ? nb_low : 16);
        const int pos = s + c0;
        fwd[j] = window(F, (pos >> 4) - q.ca, 2 * (pos & 15)) >> drop;
        if (!STRANDED) {
          const int qq = 16 * nw - k - s + c0;
          rcl[j] = window(RC, (qq >> 4) - (nw - 1 - q.cb), 2 * (qq & 15)) >> drop;
        }
      }
      bool flip = false;
      if (!STRANDED) {
        bool lt = false, eq = true;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          lt = lt || (eq && fwd[j] < rcl[j]);
          eq = eq && fwd[j] == rcl[j];
        }
        flip = !lt;  // lib.rs:224-231
      }

      // extension nibbles (KmerExtsIter, lib.rs:809-842); the right
      // neighbour lies past the row for the last slot, which reads 0 there
      auto base = [&](int p) {
        return (int)((F[(p >> 4) - q.ca] >> (30 - 2 * (p & 15))) & 3u);
      };
      const int left_nib = s == 0 ? (q.se & 0x0F) : (1 << base(s - 1));
      const int rb = s + k < l ? base(s + k) : 0;
      const int right_nib = s == q.len - k ? ((q.se >> 4) & 0x0F) : (1 << rb);
      int32_t e = (left_nib & 0x0F) | ((right_nib & 0x0F) << 4);
      if (flip) e = exts_rc(e);

      const int64_t idx = q.out0 + s;
      int64_t v[W];
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = (int64_t)(flip ? rcl[j] : fwd[j]);
      if constexpr (W % 2 == 0) {
        longlong2* dst = reinterpret_cast<longlong2*>(out_kmers + idx * W);
#pragma unroll
        for (int j = 0; j < W / 2; ++j) dst[j] = make_longlong2(v[2 * j], v[2 * j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) out_kmers[idx * W + j] = v[j];
      }
      out_exts[idx] = e;
      out_valid[idx] = s <= q.len - k;
    }
    __syncthreads();
  }
}

template <int W>
int launch(bool stranded, int64_t ntiles, size_t smem, cudaStream_t st,
           const uint8_t* b, const int32_t* len, const int32_t* se, int64_t r,
           int l, int k, int seg, int nseg, int wst, int tp, bool vec,
           int64_t* ok, int32_t* oe, bool* ov) {
  auto kernel = stranded ? extract_canonical_kernel<W, true>
                         : extract_canonical_kernel<W, false>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned blocks = (unsigned)(ntiles < resident ? ntiles : resident);
  kernel<<<blocks, THREADS, smem, st>>>(b, len, se, r, l, k, seg, nseg, wst, tp,
                                        vec, ok, oe, ov);
  return (int)cudaGetLastError();
}

}  // namespace

// seg_max: slots per piece at most; tile_slots: slots per tile, about
// (SEG_MAX and TILE_SLOTS of kernels/extract_canonical.py).
extern "C" int tdb_extract_canonical(const void* bases, const void* lengths,
                                     const void* seq_exts, int64_t r, int l,
                                     int k, int stranded, int seg_max,
                                     int tile_slots, void* out_kmers,
                                     void* out_exts, void* out_valid,
                                     void* stream) {
  const int w = (k + 15) / 16;
  if (k < 1 || k > 64 || l < k || seg_max < 1 || tile_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const int lk = l - k + 1;
  const int seg = lk < seg_max ? lk : seg_max;
  const int nseg = (lk + seg - 1) / seg;
  const int wst = ((seg + k) >> 4) + 3;
  int tp = tile_slots / seg;
  tp = tp < 1 ? 1 : (tp > MAX_PIECES ? MAX_PIECES : tp);
  const size_t smem = tp * sizeof(Piece) + 2 * (size_t)tp * wst * sizeof(uint32_t);
  const int64_t ntiles = (r * nseg + tp - 1) / tp;
  const bool vec = l % 16 == 0 && ((uintptr_t)bases & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* b = (const uint8_t*)bases;
  const int32_t* len = (const int32_t*)lengths;
  const int32_t* se = (const int32_t*)seq_exts;
  int64_t* ok = (int64_t*)out_kmers;
  int32_t* oe = (int32_t*)out_exts;
  bool* ov = (bool*)out_valid;
  const bool sd = stranded != 0;
  switch (w) {
    case 1: return launch<1>(sd, ntiles, smem, st, b, len, se, r, l, k, seg, nseg, wst, tp, vec, ok, oe, ov);
    case 2: return launch<2>(sd, ntiles, smem, st, b, len, se, r, l, k, seg, nseg, wst, tp, vec, ok, oe, ov);
    case 3: return launch<3>(sd, ntiles, smem, st, b, len, se, r, l, k, seg, nseg, wst, tp, vec, ok, oe, ov);
    case 4: return launch<4>(sd, ntiles, smem, st, b, len, se, r, l, k, seg, nseg, wst, tp, vec, ok, oe, ov);
    default: return (int)cudaErrorInvalidValue;
  }
}
