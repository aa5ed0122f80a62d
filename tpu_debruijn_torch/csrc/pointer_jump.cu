// Pointer jumping: a successor walk through a fixed table, and one round of
// the pointer-doubling list ranking of chain linking.
//
// successor_walk replaces the Pallas probe scripts/probe_pallas_gather.py::k4
// (`steps` hops of s <- succ[s] through the ORIGINAL table, -1 terminal).
// The table is read-only, so the whole walk is one launch, one thread per
// element, with the hops in a register loop; a 2^18-entry table (1 MB) stays
// in L2.  It is bound by the latency of its dependent loads.
//
// rank_round is the design that probe was for: one synchronous round of
// tpu_debruijn/compress.py::_rank_all (the body at compress.py:281-295) on
// the (m, 4) int32 carry [succ, dist, mnmo, end].  Each thread reads its own
// row and its successor's row with one 16-byte load each and writes its new
// row to a second buffer: rounds are double-buffered, because an in-place
// update would let a thread read a row that another thread already advanced
// in the same round, and dist and the min lane would then depend on thread
// scheduling.  The round also raises a device flag when some pointer is
// still unresolved, so the host reads 4 bytes per round instead of running a
// reduction.  Bound on the H100: one random 32-byte sector per row, latency
// bound at the sizes of chain linking (9.3M rows: 148 MB per buffer).

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

namespace {

__global__ void successor_walk_kernel(const int32_t* __restrict__ succ,
                                      int64_t m, int steps,
                                      int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int32_t s = succ[i];
  for (int t = 0; t < steps && s >= 0; ++t)
    s = __ldg(succ + (s < m ? (int64_t)s : m - 1));
  out[i] = s;
}

__global__ void rank_round_kernel(const int4* __restrict__ x, int64_t m,
                                  int4* __restrict__ out,
                                  int32_t* __restrict__ unresolved) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool open = false;
  if (i < m) {
    int4 r = __ldg(x + i);
    if (r.x >= 0) {
      const int4 g = __ldg(x + (r.x < m ? (int64_t)r.x : m - 1));
      r.x = g.x;
      r.y = (int32_t)((uint32_t)r.y + (uint32_t)g.y);  // wraps as int32 does
      r.z = min(r.z, g.z);
      r.w = g.w;
    }
    out[i] = r;
    open = r.x >= 0;
  }
  // one store per block that still holds an unresolved pointer
  if (__syncthreads_or(open) && threadIdx.x == 0) *unresolved = 1;
}

}  // namespace

// succ, out: (m,) int32.
extern "C" int tdb_successor_walk(const void* succ, int64_t m, int steps,
                                  void* out, void* stream) {
  if (m == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((m + threads - 1) / threads);
  successor_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)succ, m, steps, (int32_t*)out);
  return (int)cudaGetLastError();
}

// x, out: (m, 4) int32, 16-byte aligned, distinct; unresolved: one int32,
// set to 0 and then to 1 iff some succ of out is >= 0.
extern "C" int tdb_rank_round(const void* x, int64_t m, void* out,
                              void* unresolved, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(unresolved, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (m == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((m + threads - 1) / threads);
  rank_round_kernel<<<blocks, threads, 0, s>>>((const int4*)x, m, (int4*)out,
                                               (int32_t*)unresolved);
  return (int)cudaGetLastError();
}

// `rounds` rounds from x, alternating between x and spare (both (m, 4)
// int32, 16-byte aligned, distinct; both overwritten), with no flag read in
// between; the result is in spare for an odd count, else in x.  unresolved:
// one int32 scratch word the rounds write to.
extern "C" int tdb_rank_rounds(void* x, void* spare, int64_t m, int rounds,
                               void* unresolved, void* stream) {
  if (m == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = (unsigned)((m + threads - 1) / threads);
  int4* a = (int4*)x;
  int4* b = (int4*)spare;
  for (int t = 0; t < rounds; ++t) {
    rank_round_kernel<<<blocks, threads, 0, s>>>(a, m, b, (int32_t*)unresolved);
    std::swap(a, b);
  }
  return (int)cudaGetLastError();
}
