// List ranking by a sparse ruling set: the whole of chain linking's ranking
// (compress._rank_all) on the (m, 4) int32 carry [succ, dist0, mnmo, end0].
//
// Replaces the round loop of tpu_debruijn/compress.py::_rank_all (the
// while_loop at compress.py:277-297, plain XLA in the JAX package; the
// Pallas probe scripts/probe_pallas_gather.py::k4 was written for its round).
// The port's first design ran that loop as rank_round launches (Wyllie's
// pointer doubling): ceil(log2(m + 1)) rounds, each reading and writing the
// whole carry, 23 rounds at the 9.3M states of an E. coli table.
//
// Bound on the H100: device memory.  The function reads the carry once and
// writes it once, 2 * 16 * m bytes (297 MB, 0.089 ms at 3.35 TB/s for
// m = 9.3M).  Doubling moves 23 times that and more, since the carry is three
// times the 50 MB L2.  The design here is work-efficient instead:
//
// 1. links: one coalesced pass builds pred[succ[i]] = i by atomicCAS into an
//    int32 array (37 MB at m = 9.3M, L2-sized) and tags the rulers: every
//    terminal (succ < 0) and every state whose fmix32 hash is 0 mod the
//    spacing s (a power of two).  A second claim on one pred slot (in-degree
//    above 1) or a successor >= m sets a flag; the caller then ranks that
//    input with rank_loop instead.  A second coalesced pass writes the walk
//    rows out[v] = (pred[v], dist0, mnmo, end0).
// 2. walk: one thread per ruler r walks pred from r until a head or the next
//    ruler upstream, summing dist0 (uint32, so it wraps as int32 does) and
//    taking the min of mnmo over the states it passes (r excluded); each
//    state v it passes gets its row in `out` replaced by (ruler index,
//    seg_dist, seg_min).  When it stops at ruler r2 it writes r2's
//    ruler-level row: (index of r, dist0(r2) + seg_dist, min(mnmo(r2),
//    seg_min), end0(r2)); a terminal ruler keeps its own row.  About m / s
//    walkers, mean walk s hops, one random 16-byte row read per hop and the
//    write to the same sector.
// 3. The ruler-level carry (m / s rows, L2-resident) is ranked by the
//    caller's one rank_loop launch (csrc/pointer_jump.cu): at most
//    ceil(log2(m / s + 1)) doubling rounds, stopping on the card once every
//    pointer is resolved.
// 4. expand: one coalesced pass; a ruler takes its ruler-level result, a
//    visited state v with ruler r takes (succ(r), seg_dist(v) + dist(r),
//    min(seg_min(v), mnmo(r)), end(r)).  States that no walk reached lie on
//    cycles without a ruler; the pass raises a flag and the caller ranks them
//    apart.  Cycle successors are mapped back from ruler index to state.
//
// Sums mod 2^32 and min are associative, so resolved states are bit-exact
// against doubling; cycle states get succ >= 0 and the cycle minimum, which
// is what the callers read (tpu_debruijn/compress.py:243-245).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool hashed_ruler(uint32_t i, uint32_t mask) {
  i ^= i >> 16;
  i *= 0x85ebca6bu;
  i ^= i >> 13;
  i *= 0xc2b2ae35u;
  i ^= i >> 16;
  return (i & mask) == 0;
}

__global__ void links_kernel(const int4* __restrict__ x, int64_t m,
                             uint32_t mask, int32_t* __restrict__ pred,
                             uint8_t* __restrict__ tag,
                             int32_t* __restrict__ flag) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t s = __ldg(&x[i].x);
  uint8_t t = 1;
  if (s >= 0) {
    if (s >= m)
      atomicOr(flag, 2);
    else if (atomicCAS(pred + s, -1, (int32_t)i) != -1)
      atomicOr(flag, 1);
    t = hashed_ruler((uint32_t)i, mask) ? 1 : 0;
  }
  tag[i] = t;
}

// out[i] = (pred[i], dist0, mnmo, end0): the row a walk reads at each hop
__global__ void rows_kernel(const int4* __restrict__ x, int64_t m,
                            const int32_t* __restrict__ pred,
                            int4* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int4 r = __ldg(x + i);
  r.x = __ldg(pred + i);
  out[i] = r;
}

__global__ void ruler_ids_kernel(const int64_t* __restrict__ rulers,
                                 int64_t nr, int32_t* __restrict__ rid) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nr) rid[rulers[j]] = (int32_t)j;
}

// Each non-ruler row is read and then overwritten by the one walk that
// passes it, with -2 - (ruler index) in its first lane (a pred is >= -1);
// ruler rows are only read.  So a hop is one random 16-byte read, and its
// write goes to the sector that read just brought into L2.
__global__ void walk_kernel(const int4* __restrict__ x,
                            const int64_t* __restrict__ rulers, int64_t nr,
                            uint32_t mask, const int32_t* __restrict__ rid,
                            int4* __restrict__ out, int4* __restrict__ y) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nr) return;
  const int32_t r = (int32_t)rulers[j];
  const int4 xr = __ldg(x + r);
  if (xr.x < 0) y[j] = xr;
  uint32_t acc_d = 0;
  int32_t acc_m = INT_MAX;
  // every state met here has a successor, so it is a ruler iff its hash says so
  for (int32_t v = out[r].x; v >= 0;) {
    const int4 rv = out[v];
    if (hashed_ruler((uint32_t)v, mask)) {
      y[rid[v]] = make_int4((int32_t)j, (int32_t)((uint32_t)rv.y + acc_d),
                            min(rv.z, acc_m), rv.w);
      break;
    }
    acc_d += (uint32_t)rv.y;
    acc_m = min(acc_m, rv.z);
    out[v] = make_int4(-2 - (int32_t)j, (int32_t)acc_d, acc_m, 0);
    v = rv.x;
  }
}

// tag: 1 at rulers; set here to 2 at the states a walk passed and left 0 at
// the others, which lie on cycles without a ruler
__global__ void expand_kernel(const int4* __restrict__ y,
                              const int64_t* __restrict__ rulers,
                              const int32_t* __restrict__ rid,
                              uint8_t* __restrict__ tag, int64_t m,
                              int4* __restrict__ out,
                              int32_t* __restrict__ unvisited) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool open = false;
  if (i < m) {
    const bool ruler = tag[i] == 1;
    const int4 sg = ruler ? make_int4(-2 - rid[i], 0, INT_MAX, 0) : out[i];
    if (sg.x >= -1) {
      open = true;
    } else {
      const int4 r = __ldg(y + (-2 - sg.x));
      out[i] = make_int4(r.x >= 0 ? (int32_t)__ldg(rulers + r.x) : r.x,
                         (int32_t)((uint32_t)sg.y + (uint32_t)r.y),
                         min(sg.z, r.z), r.w);
      if (!ruler) tag[i] = 2;
    }
  }
  if (__syncthreads_or(open) && threadIdx.x == 0) *unvisited = 1;
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// x: (m, 4) int32, 16-byte aligned; pred: (m,) int32 scratch, filled with
// -1 here; tag: (m,) uint8 (1: ruler, 0: not); out: (m, 4) int32, gets the
// walk rows; flag: one int32, set to 0 and then |1 for a state with two
// predecessors, |2 for a successor >= m.
extern "C" int tdb_rank_lists_links(const void* x, int64_t m, uint32_t mask,
                                    void* pred, void* tag, void* out,
                                    void* flag, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(pred, 0xFF, m * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (m == 0) return 0;
  links_kernel<<<blocks_for(m, 256), 256, 0, s>>>(
      (const int4*)x, m, mask, (int32_t*)pred, (uint8_t*)tag, (int32_t*)flag);
  rows_kernel<<<blocks_for(m, 256), 256, 0, s>>>(
      (const int4*)x, m, (const int32_t*)pred, (int4*)out);
  return (int)cudaGetLastError();
}

// rulers: (nr,) int64 ascending state ids of the rulers; rid: (m,) int32,
// written at the rulers; out: the walk rows, overwritten at the states the
// walks pass by (-2 - ruler index, seg_dist, seg_min, 0); y: (nr, 4) int32
// ruler carry.
extern "C" int tdb_rank_lists_walk(const void* x, const void* rulers,
                                   int64_t nr, uint32_t mask, void* rid,
                                   void* out, void* y, void* stream) {
  if (nr == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  ruler_ids_kernel<<<blocks_for(nr, 256), 256, 0, s>>>(
      (const int64_t*)rulers, nr, (int32_t*)rid);
  walk_kernel<<<blocks_for(nr, 128), 128, 0, s>>>(
      (const int4*)x, (const int64_t*)rulers, nr, mask, (const int32_t*)rid,
      (int4*)out, (int4*)y);
  return (int)cudaGetLastError();
}

// y: the ranked (nr, 4) ruler carry; out: (m, 4) int32 after the walks;
// tag: as links left it, set to 2 at the states walks passed; unvisited: one
// int32, set to 0 and then to 1 iff some state no walk passed is left.
extern "C" int tdb_rank_lists_expand(const void* y, const void* rulers,
                                     const void* rid, void* tag,
                                     int64_t m, void* out, void* unvisited,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(unvisited, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (m == 0) return 0;
  expand_kernel<<<blocks_for(m, 256), 256, 0, s>>>(
      (const int4*)y, (const int64_t*)rulers, (const int32_t*)rid,
      (uint8_t*)tag, m, (int4*)out, (int32_t*)unvisited);
  return (int)cudaGetLastError();
}
