// Gathers: row gather by an index vector, and take_along_axis on a 2-D table.
//
// Replace the Pallas gather probes scripts/probe_pallas_gather.py::k1, k2, k3,
// scripts/probe_pallas_gather2.py::k_v1 .. k_v4 and
// scripts/probe_pallas_gather3.py::k1, k2, which asked whether a kernel could
// gather per lane from a table held in on-chip memory.  On the H100 any
// thread loads from any address, so each gather is one pass.
//
// gather_rows carries the count stage's gathers (the valid-slot compaction
// and the sort permutation over ~10^8 rows of 16 or 32 bytes) and the row
// gathers of edge resolution.  Bound on the H100: device memory, but not
// bytes-once: a random row of up to 32 bytes costs at least a whole 32-byte
// sector, so the floor of a random gather is one sector read per row plus
// the index and output streams.  One thread per row of up to 8 words (32
// bytes), the row moved as one or two 16-byte vectors (or 8- and 4-byte
// ones where its width needs them, the count chosen at compile time), and
// one warp per wider row, its lanes over consecutive vectors of the row so
// the row is read in full sectors.  On the card a random gather of 16-byte
// rows runs at ~25-28 G rows/s whatever the table's size above the L2, and
// none of these moved it (PERF.md): several rows in flight per thread,
// non-allocating and streaming cache hints, a grid-stride launch (which
// cost 1.5-6%).  A gather by a sorted index streams at 85-92% of the
// bytes-once bound.
//
// take_along_axis: one thread per element, 32-bit index math (the table
// has fewer than 2^31 elements; the entry point refuses more).  At the
// probes' (2048, 128) it is bound by the host's launch path, not by the card.
//
// Indices are int32 or int64.  An index outside [0, rows) is clamped into it,
// as the plain versions do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename I>
__device__ __forceinline__ int64_t clamp_idx(I j, int64_t n) {
  int64_t v = (int64_t)j;
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// One thread per row of NV vectors.
template <typename V, int NV, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_thread(const V* __restrict__ table, const I* __restrict__ idx,
                   int64_t m, int64_t n, V* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const V* src = table + clamp_idx(idx[i], m) * NV;
  V* dst = out + i * NV;
#pragma unroll
  for (int v = 0; v < NV; ++v) dst[v] = __ldg(src + v);
}

// One warp per row; lane l copies vectors l, l + 32, ... of the row.
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_warp(const V* __restrict__ table, const I* __restrict__ idx,
                 int64_t m, int64_t n, int nv, V* __restrict__ out) {
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t r = clamp_idx(idx[i], m);
  const V* src = table + r * nv;
  V* dst = out + i * nv;
  for (int v = lane; v < nv; v += 32) dst[v] = __ldg(src + v);
}

template <typename V, int NV, typename I>
int launch_thread(const void* table, const void* idx, int64_t m, int64_t n,
                  void* out, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  gather_rows_thread<V, NV, I><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const V*)table, (const I*)idx, m, n, (V*)out);
  return (int)cudaGetLastError();
}

template <typename V, typename I>
int launch_warp(const void* table, const void* idx, int64_t m, int64_t n,
                int nv, void* out, cudaStream_t s) {
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  gather_rows_warp<V, I><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const V*)table, (const I*)idx, m, n, nv, (V*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int gather_rows_idx(const void* table, const void* idx, int64_t m, int64_t n,
                    int words, void* out, cudaStream_t s) {
  switch (words) {  // the widest vector that divides the row
    case 1: return launch_thread<int, 1, I>(table, idx, m, n, out, s);
    case 2: return launch_thread<int2, 1, I>(table, idx, m, n, out, s);
    case 3: return launch_thread<int, 3, I>(table, idx, m, n, out, s);
    case 4: return launch_thread<int4, 1, I>(table, idx, m, n, out, s);
    case 5: return launch_thread<int, 5, I>(table, idx, m, n, out, s);
    case 6: return launch_thread<int2, 3, I>(table, idx, m, n, out, s);
    case 7: return launch_thread<int, 7, I>(table, idx, m, n, out, s);
    case 8: return launch_thread<int4, 2, I>(table, idx, m, n, out, s);
    default: break;
  }
  if (words % 4 == 0) return launch_warp<int4, I>(table, idx, m, n, words / 4, out, s);
  if (words % 2 == 0) return launch_warp<int2, I>(table, idx, m, n, words / 2, out, s);
  return launch_warp<int, I>(table, idx, m, n, words, out, s);
}

// One element per thread.
template <typename I>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const int32_t* __restrict__ tab, const I* __restrict__ idx,
                       uint32_t r, uint32_t l, int axis, int32_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= r * l) return;
  const uint32_t row = i / l, col = i - row * l;
  const uint32_t src = axis == 0 ? (uint32_t)clamp_idx(idx[i], r) * l + col
                                 : row * l + (uint32_t)clamp_idx(idx[i], l);
  out[i] = __ldg(tab + src);
}

}  // namespace

// table: (m, words) 4-byte words, 16-byte aligned; idx: (n,) int32 or int64;
// out: (n, words).
extern "C" int tdb_gather_rows(const void* table, const void* idx, int64_t m,
                               int64_t n, int words, int idx_is_64, void* out,
                               void* stream) {
  if (n == 0) return 0;
  if (m <= 0 || words <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx_is_64 ? gather_rows_idx<int64_t>(table, idx, m, n, words, out, s)
                   : gather_rows_idx<int32_t>(table, idx, m, n, words, out, s);
}

// tab, idx, out: (r, l) row-major, r * l < 2^31;
// out[i, j] = tab[idx[i, j], j] (axis 0) or tab[i, idx[i, j]] (axis 1).
extern "C" int tdb_take_along_axis(const void* tab, const void* idx, int64_t r,
                                   int64_t l, int axis, int idx_is_64,
                                   void* out, void* stream) {
  const int64_t n = r * l;
  if (n == 0) return 0;
  if ((axis != 0 && axis != 1) || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (idx_is_64)
    take_along_axis_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, (const int64_t*)idx, (uint32_t)r, (uint32_t)l, axis, (int32_t*)out);
  else
    take_along_axis_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)tab, (const int32_t*)idx, (uint32_t)r, (uint32_t)l, axis, (int32_t*)out);
  return (int)cudaGetLastError();
}
