// Pointer jumping: a successor walk through a fixed table, and the
// pointer-doubling loop of chain linking's list ranking as one persistent
// launch.
//
// successor_walk replaces the Pallas probe scripts/probe_pallas_gather.py::k4
// (`steps` hops of s <- succ[s] through the ORIGINAL table, -1 terminal).  The
// table is read-only, so the whole walk is one launch, one thread per element,
// with the hops in a register loop; a 2^18-entry table (1 MB) stays in L2.
// Each hop is a load that depends on the one before: 18 hops of a 2^18-entry
// table move 2 MB (0.6 us at 3.35 TB/s) but take 18 dependent L2 round trips
// per element and one random 32-byte L2 sector per hop, and the sectors bound
// it.  Walking the table in a thread block cluster's distributed shared
// memory instead (8 blocks, each holding a slice, hops by ld.shared::cluster)
// was measured 2.5x slower on the H100: random 4-byte loads across the
// SM-to-SM network run at a third of L2's sector rate (PERF.md).
//
// rank_loop replaces the loop of tpu_debruijn/compress.py::_rank_all (the
// lax.while_loop at compress.py:277-297, plain XLA; the probe above was
// written for its round).  Up to max_rounds rounds of the body at
// compress.py:281-295 on the (m, 4) int32 carry [succ, dist, mnmo, end], with
// JAX's condition kept on the card: with early_exit the loop stops after the
// first round whose result has no succ >= 0.  One cooperative launch runs the
// whole loop: a grid of resident blocks strides over the rows, every thread
// owning the same rows in every round, and a grid barrier separates the
// rounds.  Bound on the H100: the carry read and written once is 32 bytes a
// row, but the rounds are a chain of dependent steps, so its floor is rounds x
// (one dependent L2 load + one grid barrier), which latency_floor_kernel
// measures on the same grid.  The design cuts what a round adds to that:
// - a round reads only the successor's row, with one 16-byte L2 load (__ldcg:
//   a row that another block wrote in the round before must not come from a
//   stale L1 line); each thread keeps its first row in registers;
// - the barrier carries the loop condition: each block arrives on its own
//   word per round (state[t], zeroed before the launch, so no word is ever
//   reset) with one atomic add that also counts the blocks with an open row,
//   and every block leaves with the sum, so no flag is stored or read apart;
// - blocks of 1024 threads, so fewer blocks arrive on each word.
// Rounds are double-buffered, because an in-place update would let dist and
// the min lane depend on scheduling.  After an even count of rounds the
// result is in `spare`, and each thread copies back its own rows, so the
// result always ends in `out`; state[max_rounds] receives the count of rounds
// run.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWalkThreads = 256;
constexpr int kLoopThreads = 1024;
constexpr int kMaxDevices = 64;

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

// Round t's grid barrier: thread 0 of each block adds 1, plus 2^16 if the
// block has an open row, to `word` and waits until every block has arrived.
// Returns whether any block had an open row.  The blocks must be co-resident
// (a cooperative launch) and fewer than 2^16.
__device__ __forceinline__ bool grid_barrier_or(uint32_t* word, bool open) {
  __shared__ uint32_t seen;
  const bool any = __syncthreads_or(open);
  if (threadIdx.x == 0) {
    __threadfence();  // the block's rows before its arrival
    atomicAdd(word, any ? 0x10001u : 1u);
    uint32_t v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(word) : "memory");
    } while ((v & 0xFFFFu) < gridDim.x);
    __threadfence();
    seen = v;
  }
  __syncthreads();
  return seen >> 16;
}

__global__ void __launch_bounds__(kLoopThreads)
rank_loop_kernel(const int4* x, int4* out, int4* spare, int64_t m,
                 int max_rounds, int early_exit, uint32_t* state) {
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int4 mine = first < m ? __ldcg(x + first) : make_int4(-1, 0, 0, 0);
  int t = 0;
  bool more = true;
  while (t < max_rounds && more) {
    const int4* src = t == 0 ? x : (t & 1 ? out : spare);
    int4* dst = t & 1 ? spare : out;
    bool open = false;
    for (int64_t i = first; i < m; i += stride) {
      int4 r = i == first ? mine : __ldcg(src + i);
      if (r.x >= 0) {
        const int4 g = __ldcg(src + (r.x < m ? (int64_t)r.x : m - 1));
        r.x = g.x;
        r.y = (int32_t)((uint32_t)r.y + (uint32_t)g.y);  // wraps as int32 does
        r.z = min(r.z, g.z);
        r.w = g.w;
      }
      dst[i] = r;
      if (i == first) mine = r;
      open |= r.x >= 0;
    }
    const bool any = grid_barrier_or(state + t, open);
    ++t;
    more = !early_exit || any;
  }
  // an even count ends in spare; every thread wrote the same rows each round
  if ((t & 1) == 0)
    for (int64_t i = first; i < m; i += stride) out[i] = spare[i];
  if (first == 0) state[max_rounds] = t;
}

__global__ void __launch_bounds__(kLoopThreads)
latency_floor_kernel(const int32_t* __restrict__ chain, int rounds, int barrier,
                     uint32_t* state) {
  int32_t v = 0;
  for (int t = 0; t < rounds; ++t) {
    v = __ldcg(chain + v);
    if (barrier) grid_barrier_or(state + t, v == INT_MIN);
  }
  if (v == INT_MIN) state[0] = v;  // keeps the chain of loads
}

// The cooperative grid for m rows: the blocks of rank_loop_kernel that fit on
// the card at once (queried once per device), and no more than the rows need.
int loop_grid(int64_t m, unsigned* grid) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_loop_kernel,
                                                      kLoopThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = per_sm * sms;
  }
  const int64_t need = (m + kLoopThreads - 1) / kLoopThreads;
  *grid = (unsigned)(need < resident[dev] ? (need > 0 ? need : 1) : resident[dev]);
  return 0;
}

}  // namespace

// succ, out: (m,) int32.
extern "C" int tdb_successor_walk(const void* succ, int64_t m, int steps,
                                  void* out, void* stream) {
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kWalkThreads - 1) / kWalkThreads);
  successor_walk_kernel<<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)succ, m, steps, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The grid rank_loop launches for m rows, into *blocks.
extern "C" int tdb_rank_loop_grid(int64_t m, void* blocks) {
  return loop_grid(m, (unsigned*)blocks);
}

// x, out, spare: (m, 4) int32, 16-byte aligned, distinct; x is only read.
// state: max_rounds + 1 uint32, zeroed here; state[t] is round t's barrier
// word (blocks + 2^16 x blocks with an open row), state[max_rounds] receives
// the count of rounds run.  max_rounds >= 1.
extern "C" int tdb_rank_loop(const void* x, void* out, void* spare, int64_t m,
                             int max_rounds, int early_exit, void* state,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (max_rounds < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(state, 0, sizeof(uint32_t) * (max_rounds + 1), s);
  if (e != cudaSuccess || m == 0) return (int)e;
  unsigned grid = 0;
  const int g = loop_grid(m, &grid);
  if (g != 0) return g;
  const int4* xa = (const int4*)x;
  int4* oa = (int4*)out;
  int4* sa = (int4*)spare;
  uint32_t* st = (uint32_t*)state;
  void* args[] = {&xa, &oa, &sa, &m, &max_rounds, &early_exit, &st};
  e = cudaLaunchCooperativeKernel((const void*)rank_loop_kernel, dim3(grid),
                                  dim3(kLoopThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A measure of rank_loop's latency floor: `rounds` rounds of one dependent L2
// load per thread (chain[v], from v = 0), each followed by rank_loop's grid
// barrier when `barrier`, on rank_loop's grid for m rows.  chain: int32, every
// value a valid index; state: rounds + 1 uint32, zeroed here.
extern "C" int tdb_latency_floor(const void* chain, int64_t m, int rounds,
                                 int barrier, void* state, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(state, 0, sizeof(uint32_t) * (rounds + 1), s);
  if (e != cudaSuccess) return (int)e;
  unsigned grid = 0;
  const int g = loop_grid(m, &grid);
  if (g != 0) return g;
  const int32_t* c = (const int32_t*)chain;
  uint32_t* st = (uint32_t*)state;
  void* args[] = {&c, &rounds, &barrier, &st};
  e = cudaLaunchCooperativeKernel((const void*)latency_floor_kernel, dim3(grid),
                                  dim3(kLoopThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
