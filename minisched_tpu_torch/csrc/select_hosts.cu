// Seeded masked argmax for the scheduling hot path, hand-written for Hopper
// (sm_90a).  Two kernels share one (score, hash, idx) merge:
//
// select_hosts_kernel
//   Replaces minisched_tpu/ops/pallas_kernels.py select_hosts_pallas
//   (pallas_call at :232; body _select_kernel :114 + _reduce_and_merge :61).
//   Per pod row: among nodes with mask set, the max score; among those the
//   least mix32(seed, node_idx); on an equal hash the lowest index.
//   (choice, best) = (-1, 0) when no node is feasible.
//   Bound on this card: bytes.  It must read 5 B per (pod, node) — an i32
//   score and a bool mask — about 414 MB per main-path wave (P = 8,192,
//   N = 10,112), ~0.12 ms at 3.35 TB/s.  Design: one warp per pod row, lanes
//   striding the node axis so each warp load is one coalesced line; both
//   planes are loaded unconditionally so the loads of an unrolled loop can
//   be in flight together.
//
// nodenumber_select_hosts_kernel
//   Replaces minisched_tpu/ops/pallas_kernels.py nodenumber_select_hosts
//   (pallas_call at :192; body _nn_fused_kernel :136).  The whole
//   NodeUnschedulable + NodeNumber chain from table columns only:
//   mask = pvalid & nvalid & (~unschedulable | tolerates_unschedulable),
//   score = match_score where pod suffix == node suffix >= 0, else 0.
//   The (P, N) planes never exist in device memory.
//   Bound on this card: integer operations.  It reads O(P + N) bytes but
//   evaluates the mask and score for every (pod, node), ~83M pairs a wave.
//   Design: the node columns (6 B a node, 60 KB) are read by every warp of
//   the card and stay in L1/L2; a node is hashed only when its score is at
//   or above the lane's running maximum, so most pairs cost a few compares.
//
// Where the TPU grid walked node tiles in order and carried accumulators in
// VMEM, here the loop over nodes runs inside the warp and a warp-shuffle
// reduction merges the lanes: nothing carries between blocks, and every
// shape is accepted (P = 1, N not a multiple of anything).  Hopper compares
// u32 natively, so the TPU's sign-flipped int32 hash order is not needed.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per pod row
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kNone = INT_MAX;  // idx of "no feasible node seen"

struct Best {
  int score;
  unsigned hash;
  int idx;
};

__device__ __forceinline__ Best none() { return Best{INT_MIN, 0xFFFFFFFFu, kNone}; }

// == engine.tiebreak.mix32, in native modular u32 arithmetic
__device__ __forceinline__ unsigned mix32(unsigned seed, unsigned idx) {
  unsigned x = seed ^ (idx * 0x9E3779B9u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// a before b in the order (score desc, hash asc, idx asc).  Any feasible
// node beats none(): its idx is below INT_MAX even at INT_MIN / 0xFFFFFFFF.
__device__ __forceinline__ bool beats(const Best& a, const Best& b) {
  if (a.score != b.score) return a.score > b.score;
  if (a.hash != b.hash) return a.hash < b.hash;
  return a.idx < b.idx;
}

// offer feasible node j with score s to the lane's accumulator; the hash
// is computed only for a node that can still win
__device__ __forceinline__ void offer(Best& acc, int s, unsigned seed, int j) {
  if (s < acc.score) return;
  const Best c{s, mix32(seed, static_cast<unsigned>(j)), j};
  if (beats(c, acc)) acc = c;
}

// merge the 32 lanes' accumulators; lane 0 ends with the row's winner
__device__ __forceinline__ Best warp_merge(Best b) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    Best o;
    o.score = __shfl_down_sync(0xFFFFFFFFu, b.score, off);
    o.hash = __shfl_down_sync(0xFFFFFFFFu, b.hash, off);
    o.idx = __shfl_down_sync(0xFFFFFFFFu, b.idx, off);
    if (beats(o, b)) b = o;
  }
  return b;
}

__device__ __forceinline__ void write_row(const Best& b, int row, int* choice,
                                          int* best) {
  const bool feasible = b.idx != kNone;
  choice[row] = feasible ? b.idx : -1;
  best[row] = feasible ? b.score : 0;
}

__global__ void __launch_bounds__(kThreads)
select_hosts_kernel(const int* __restrict__ scores,
                    const unsigned char* __restrict__ mask,
                    const unsigned* __restrict__ seeds, int P, int N,
                    int* __restrict__ choice, int* __restrict__ best) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= P) return;  // warp-uniform: the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * static_cast<size_t>(N);
  const int* srow = scores + base;
  const unsigned char* mrow = mask + base;
  const unsigned seed = seeds[row];
  Best acc = none();
#pragma unroll 4
  for (int j = lane; j < N; j += kWarp) {
    const int s = srow[j];
    const unsigned char m = mrow[j];
    if (m) offer(acc, s, seed, j);
  }
  acc = warp_merge(acc);
  if (lane == 0) write_row(acc, row, choice, best);
}

__global__ void __launch_bounds__(kThreads)
nodenumber_select_hosts_kernel(
    const unsigned char* __restrict__ unsched, const int* __restrict__ nsuffix,
    const unsigned char* __restrict__ nvalid, int N,
    const unsigned char* __restrict__ tol, const int* __restrict__ psuffix,
    const unsigned* __restrict__ seeds, const unsigned char* __restrict__ pvalid,
    int P, int match_score, int* __restrict__ choice, int* __restrict__ best) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= P) return;
  Best acc = none();
  if (pvalid[row]) {
    const bool tolerates = tol[row] != 0;
    const int ps = psuffix[row];
    const unsigned seed = seeds[row];
#pragma unroll 4
    for (int j = lane; j < N; j += kWarp) {
      const int ns = nsuffix[j];
      const bool feasible = nvalid[j] && (!unsched[j] || tolerates);
      if (feasible) {
        const int s = (ps == ns && ps >= 0 && ns >= 0) ? match_score : 0;
        offer(acc, s, seed, j);
      }
    }
  }
  acc = warp_merge(acc);
  if (lane == 0) write_row(acc, row, choice, best);
}

inline unsigned grid_for(int P) {
  return static_cast<unsigned>((P + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// Plain C interface (bound with ctypes).  Each launches on the given stream
// of the calling thread's current device (the wrapper sets it), does not
// synchronise, and returns the cudaError_t of the launch.

extern "C" int minisched_select_hosts(const void* scores, const void* mask,
                                      const void* seeds, int P, int N,
                                      void* choice, void* best,
                                      void* stream) {
  if (P <= 0) return 0;
  select_hosts_kernel<<<grid_for(P), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(scores), static_cast<const unsigned char*>(mask),
      static_cast<const unsigned*>(seeds), P, N, static_cast<int*>(choice),
      static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int minisched_nodenumber_select_hosts(
    const void* unsched, const void* nsuffix, const void* nvalid, int N,
    const void* tol, const void* psuffix, const void* seeds,
    const void* pvalid, int P, int match_score, void* choice, void* best,
    void* stream) {
  if (P <= 0) return 0;
  nodenumber_select_hosts_kernel<<<grid_for(P), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(unsched),
      static_cast<const int*>(nsuffix),
      static_cast<const unsigned char*>(nvalid), N,
      static_cast<const unsigned char*>(tol), static_cast<const int*>(psuffix),
      static_cast<const unsigned*>(seeds),
      static_cast<const unsigned char*>(pvalid), P, match_score,
      static_cast<int*>(choice), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}
