// Gathers: row gather by an index vector, and take_along_axis on a 2-D table.
//
// Replace the Pallas gather probes scripts/probe_pallas_gather.py::k1, k2, k3,
// scripts/probe_pallas_gather2.py::k_v1 .. k_v4 and
// scripts/probe_pallas_gather3.py::k1, k2, which asked whether a kernel could
// gather per lane from a table held in on-chip memory.  On the H100 any
// thread loads from any address, so each gather is one pass.
//
// Bound on the H100: device memory latency and transactions, not bytes.  A
// random row gather touches one 32-byte sector per row of up to 32 bytes, so
// the design moves a whole row with as few loads as it can: rows are copied
// as 4-byte words, grouped into 16- or 8-byte vector loads where the row
// width allows, one thread per row up to 32 bytes and one warp per row above
// (the warp's lanes cover consecutive 16-byte chunks of the row, so the row
// is read in full sectors).  Output writes are coalesced.
//
// Indices are int32 or int64.  An index outside [0, rows) is clamped into it,
// as the plain versions do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename I>
__device__ __forceinline__ int64_t clamp_idx(I j, int64_t n) {
  int64_t v = (int64_t)j;
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// One thread per row; a row is `nv` vectors of type V.
template <typename V, typename I>
__global__ void gather_rows_thread(const V* __restrict__ table,
                                   const I* __restrict__ idx, int64_t m,
                                   int64_t n, int nv, V* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t r = clamp_idx(idx[i], m);
  const V* src = table + r * nv;
  V* dst = out + i * nv;
  for (int v = 0; v < nv; ++v) dst[v] = __ldg(src + v);
}

// One warp per row; lane l copies vectors l, l + 32, ... of the row.
template <typename V, typename I>
__global__ void gather_rows_warp(const V* __restrict__ table,
                                 const I* __restrict__ idx, int64_t m,
                                 int64_t n, int nv, V* __restrict__ out) {
  const int64_t i =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t r = clamp_idx(idx[i], m);
  const V* src = table + r * nv;
  V* dst = out + i * nv;
  for (int v = lane; v < nv; v += 32) dst[v] = __ldg(src + v);
}

template <typename V, typename I>
int launch_rows(const void* table, const void* idx, int64_t m, int64_t n,
                int nv, bool warp, void* out, cudaStream_t s) {
  const int threads = 256;
  const int64_t work = warp ? n * 32 : n;
  const int64_t blocks = (work + threads - 1) / threads;
  if (warp)
    gather_rows_warp<V, I><<<(unsigned)blocks, threads, 0, s>>>(
        (const V*)table, (const I*)idx, m, n, nv, (V*)out);
  else
    gather_rows_thread<V, I><<<(unsigned)blocks, threads, 0, s>>>(
        (const V*)table, (const I*)idx, m, n, nv, (V*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int gather_rows_idx(const void* table, const void* idx, int64_t m, int64_t n,
                    int words, void* out, cudaStream_t s) {
  // rows of up to 8 words (32 bytes) take one thread, wider rows one warp
  const bool warp = words > 8;
  if (words % 4 == 0) return launch_rows<int4, I>(table, idx, m, n, words / 4, warp, out, s);
  if (words % 2 == 0) return launch_rows<int2, I>(table, idx, m, n, words / 2, warp, out, s);
  return launch_rows<int32_t, I>(table, idx, m, n, words, warp, out, s);
}

template <typename I>
__global__ void take_along_axis_kernel(const int32_t* __restrict__ tab,
                                       const I* __restrict__ idx, int64_t r,
                                       int64_t l, int axis,
                                       int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r * l) return;
  const int64_t row = i / l, col = i - row * l;
  const int64_t src = axis == 0 ? clamp_idx(idx[i], r) * l + col
                                : row * l + clamp_idx(idx[i], l);
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

// tab, idx, out: (r, l) row-major; out[i, j] = tab[idx[i, j], j] (axis 0) or
// tab[i, idx[i, j]] (axis 1).
extern "C" int tdb_take_along_axis(const void* tab, const void* idx, int64_t r,
                                   int64_t l, int axis, int idx_is_64,
                                   void* out, void* stream) {
  const int64_t n = r * l;
  if (n == 0) return 0;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (idx_is_64)
    take_along_axis_kernel<int64_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)tab, (const int64_t*)idx, r, l, axis, (int32_t*)out);
  else
    take_along_axis_kernel<int32_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)tab, (const int32_t*)idx, r, l, axis, (int32_t*)out);
  return (int)cudaGetLastError();
}
