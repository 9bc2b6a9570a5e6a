// Seeded masked argmax for the scheduling hot path, hand-written for Hopper
// (sm_90a).  Rule of both kernels (== engine.tiebreak.select_host): per pod
// row, among feasible nodes the max score; among those the least
// mix32(seed, node_idx); on an equal hash the lowest index.
// (choice, best) = (-1, 0) when no node is feasible.
//
// select_hosts_kernel
//   Replaces minisched_tpu/ops/pallas_kernels.py select_hosts_pallas
//   (pallas_call at :232; body _select_kernel :114 + _reduce_and_merge :61).
//   Bound on this card: bytes.  It must read 5 B per (pod, node) — an i32
//   score and a bool mask — about 414 MB per main-path wave (P = 8,192,
//   N = 10,112), ~0.12 ms at 3.35 TB/s.  Design: one warp per pod row.
//   Each lane loads 16 mask bytes (one uint4) and the 16 matching scores
//   (four int4) a step, streaming (ld.global.cs), so a warp covers 512
//   nodes a step, and the next step's 80 B a lane are in flight while this
//   step is reduced.  The running (score) is warp-uniform: a chunk max by
//   __reduce_max_sync raises it only when the chunk beats it, and only the
//   chunk's nodes at the running max are hashed — compacted with a warp
//   scan into a per-warp buffer in shared memory and hashed with all 32
//   lanes busy, so no lane waits on another's mix32.  Any shape: a row's
//   nodes before its first 16-byte-aligned mask byte and after its last
//   whole 16-node group (at most 30) take a scalar edge loop; a row whose
//   score and mask rows cannot both be 16-byte aligned (a view at an odd
//   offset) takes the edge loop whole.  A node-index base (0 for a whole
//   row; a node shard's first global index under a mesh) enters only the
//   hash and the result: the kernel hashes mix32(seed, base + idx) and
//   returns base + idx, so a shard's winner carries the global index and
//   tie-break of the whole row, and shards merge by (-best, hash, index).
//
// nodenumber_select_hosts_kernel
//   Replaces minisched_tpu/ops/pallas_kernels.py nodenumber_select_hosts
//   (pallas_call at :192; body _nn_fused_kernel :136) and its XLA prologue
//   tolerates_unschedulable.  The whole NodeUnschedulable + NodeNumber
//   chain from table columns only:
//     mask  = pvalid & nvalid & (~unschedulable | tolerates_unschedulable),
//     score = match_score where pod suffix == node suffix >= 0, else 0.
//   Bound on this card: integer operations; it reads O(P + N) bytes.  A
//   NodeNumber score takes two values, so a pod's winners are exactly its
//   usable nodes with its suffix (with match_score > 0), or, if it has
//   none, all its usable nodes (score 0): a pod's work is the mix32 of
//   its candidates, ~805 a pod on the main path, and nothing per
//   (pod, node) pair need be evaluated.  Design: one block of 1,024
//   threads per SM, persistent, each serving a contiguous range of pod
//   rows.  The block stages the node axis once per tile (10,240 nodes) in
//   shared memory as bitmaps, 32 nodes a word: the nodes a non-tolerating
//   and a tolerating pod may use, and one bitmap per suffix bucket
//   (suffix & 15, and one for no suffix), plus each node's suffix.  The
//   first tile's loads start before the pod half runs.  A warp then
//   walks one row at a time: the AND of its usable bitmap and its
//   suffix's bucket, checking the suffix of each set bit and hashing four
//   set bits a lane a step; only a row with no match walks its whole
//   usable bitmap.  The pod half reads the toleration columns (i32[P, T])
//   of kWarp / T rows at once, one slot a lane, so the entry point is one
//   launch.
//
// Where the TPU grid walked node tiles in order and carried accumulators in
// VMEM, here the node loop runs inside a warp (and, for the fused kernel,
// the tile loop inside a block, with each row's state in shared memory);
// nothing carries between blocks.  The result is the lexicographic min of
// (-score, hash, idx) over feasible nodes, which does not depend on the
// order nodes are visited in.  Hopper compares u32 natively, so the TPU's
// sign-flipped int32 hash order is not needed.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps per block of select_hosts_kernel
constexpr int kThreads = kWarp * kWarps;
constexpr int kVec = 16;                // nodes per lane per step
constexpr int kStep = kWarp * kVec;     // nodes per warp per step
constexpr int kNone = INT_MAX;          // idx of "no candidate seen"
constexpr unsigned kNoHash = 0xFFFFFFFFu;

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

// (h, i) := min((h, i), (mix32(seed, base + j), j)) in (hash, idx) order
__device__ __forceinline__ void offer_hash(unsigned& h, int& i, unsigned seed,
                                           int j, unsigned base) {
  const unsigned hj = mix32(seed, base + static_cast<unsigned>(j));
  if (hj < h || (hj == h && j < i)) {
    h = hj;
    i = j;
  }
}

// the warp's least (hash, idx); every lane ends with it
__device__ __forceinline__ void warp_min(unsigned& h, int& i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const unsigned oh = __shfl_xor_sync(kFull, h, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (oh < h || (oh == h && oi < i)) {
      h = oh;
      i = oi;
    }
  }
}

// exclusive prefix sum of c over the warp's lanes; total of all lanes
__device__ __forceinline__ int warp_exclusive_scan(int c, int lane,
                                                   int& total) {
  int inc = c;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  total = __shfl_sync(kFull, inc, kWarp - 1);
  return inc - c;
}

// ---------------------------------------------------------------------------
// select_hosts_kernel
// ---------------------------------------------------------------------------

// The row's running state, warp-uniform except the per-lane (h, i).
struct RowRun {
  int run;    // max feasible score seen
  bool seen;  // any feasible node seen
  unsigned h;
  int i;
};

// One chunk: K nodes a lane, node jbase + e for bit e of the lane's
// feasibility bits fb, scores s.  Raises the running max when the chunk
// beats it, then hashes the chunk's nodes at the running max.
template <int K>
__device__ __forceinline__ void select_chunk(const int (&s)[K], unsigned fb,
                                             int jbase, unsigned seed,
                                             unsigned base, RowRun& r,
                                             int* buf, int lane) {
  if (!__any_sync(kFull, fb != 0)) return;
  int lmax = INT_MIN;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if ((fb >> e) & 1u) lmax = max(lmax, s[e]);
  }
  // lanes with no feasible node give INT_MIN, which loses to any feasible
  // score or equals it (a feasible INT_MIN is still a feasible node)
  const int cmax = __reduce_max_sync(kFull, lmax);
  if (r.seen && cmax < r.run) return;
  if (!r.seen || cmax > r.run) {
    r.run = cmax;
    r.seen = true;
    r.h = kNoHash;
    r.i = kNone;
  }
  unsigned cb = 0;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (((fb >> e) & 1u) && s[e] == r.run) cb |= 1u << e;
  }
  int total;
  int pos = warp_exclusive_scan(__popc(cb), lane, total);
  if (total == 0) return;
  while (cb) {
    const int e = __ffs(cb) - 1;
    cb &= cb - 1;
    buf[pos++] = jbase + e;
  }
  __syncwarp();
  for (int k = lane; k < total; k += kWarp) {
    offer_hash(r.h, r.i, seed, buf[k], base);
  }
  __syncwarp();  // buf is rewritten by the next chunk
}

// 16 mask bytes → 16 feasibility bits (bit e: byte e nonzero)
__device__ __forceinline__ unsigned mask_bits(uint4 m) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // one 0x01 per nonzero byte, gathered into 4 bits at 24..27
    const unsigned x = __vcmpne4(w[q], 0u) & 0x01010101u;
    bits |= ((x * 0x01020408u) >> 24) << (4 * q);
  }
  return bits;
}

struct Group {  // one lane's 16 nodes: their mask bytes and scores
  uint4 m;
  int4 s[4];
};

__device__ __forceinline__ Group load_group(const unsigned char* mrow,
                                            const int* srow, int j) {
  Group g;
  g.m = __ldcs(reinterpret_cast<const uint4*>(mrow + j));
  const int4* sp = reinterpret_cast<const int4*>(srow + j);
#pragma unroll
  for (int q = 0; q < 4; ++q) g.s[q] = __ldcs(sp + q);
  return g;
}

__global__ void __launch_bounds__(kThreads)
select_hosts_kernel(const int* __restrict__ scores,
                    const unsigned char* __restrict__ mask,
                    const unsigned* __restrict__ seeds, int P, int N,
                    int node_base, int* __restrict__ choice,
                    int* __restrict__ best) {
  __shared__ int bufs[kWarps][kStep];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= P) return;  // warp-uniform: the whole warp leaves together
  int* buf = bufs[warp];
  const size_t base = static_cast<size_t>(row) * static_cast<size_t>(N);
  const int* srow = scores + base;
  const unsigned char* mrow = mask + base;
  const unsigned seed = seeds[row];
  const unsigned hbase = static_cast<unsigned>(node_base);
  RowRun r{INT_MIN, false, kNoHash, kNone};

  // nodes [0, head) and [tail, N) go through the edge loop
  int head = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(mrow) & 15u)) & 15u);
  if (head > N) head = N;
  if ((reinterpret_cast<uintptr_t>(srow + head) & 15u) != 0) head = N;
  const int groups = (N - head) / kVec;
  const int tail = head + groups * kVec;

  // 16-byte path, the next step's loads in flight while this one reduces
  if (groups > 0) {
    Group cur{};
    if (lane < groups) cur = load_group(mrow, srow, head + lane * kVec);
    for (int g0 = 0; g0 < groups; g0 += kWarp) {
      const int g = g0 + lane;
      const int gn = g + kWarp;
      Group nxt{};
      if (gn < groups) nxt = load_group(mrow, srow, head + gn * kVec);
      int s[kVec];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[4 * q + 0] = cur.s[q].x;
        s[4 * q + 1] = cur.s[q].y;
        s[4 * q + 2] = cur.s[q].z;
        s[4 * q + 3] = cur.s[q].w;
      }
      const unsigned fb = g < groups ? mask_bits(cur.m) : 0u;
      select_chunk<kVec>(s, fb, head + g * kVec, seed, hbase, r, buf, lane);
      cur = nxt;
    }
  }
  // scalar edge loop: the unaligned head, the ragged tail (or a whole
  // row that cannot take the 16-byte path)
  const int edge = head + (N - tail);
  for (int e0 = 0; e0 < edge; e0 += kWarp) {
    const int e = e0 + lane;
    int s[1] = {0};
    unsigned fb = 0;
    int j = 0;
    if (e < edge) {
      j = e < head ? e : tail + (e - head);
      fb = mrow[j] != 0;
      s[0] = srow[j];
    }
    select_chunk<1>(s, fb, j, seed, hbase, r, buf, lane);
  }

  warp_min(r.h, r.i);
  if (lane == 0) {
    choice[row] = r.seen ? node_base + r.i : -1;
    best[row] = r.seen ? r.run : 0;
  }
}

// ---------------------------------------------------------------------------
// nodenumber_select_hosts_kernel
// ---------------------------------------------------------------------------

constexpr int kNnWarps = 32;  // one block of 1,024 threads per SM
constexpr int kNnThreads = kWarp * kNnWarps;
constexpr int kTile = 10240;  // nodes staged per tile (the main N: one tile)
constexpr int kTileWords = kTile / kWarp;  // bitmap words of a tile
constexpr int kWordsPerWarp = kTileWords / kNnWarps;
constexpr int kMaxRowsPerBlock = 1024;
constexpr int kBuckets = 17;  // 16 by suffix & 15, one for no suffix
constexpr int kNoSuffix = 16;
constexpr int kNever = -3;    // target of a pod without a suffix
constexpr int kBucketStride = kTileWords + 1;  // bucket c's words: no bank conflict
static_assert(kTileWords % kNnWarps == 0, "whole words a warp");

// which nodes a pass takes: usable nodes whose suffix equals the pod's
// (score match_score), every usable node, or the usable ones that do not
// match (score 0)
enum Pred : int { kMatch = 0, kFeasible = 1, kFeasibleNoMatch = 2, kNoPass = 3 };

constexpr int kLive = 1;       // pvalid
constexpr int kTolerates = 2;  // tolerates the unschedulable taint
constexpr int kSecond = 4;     // the first pass found nothing: the second serves it

struct RowState {
  unsigned hash;
  int idx;
  int target;  // pod suffix, kNever if none
  unsigned seed;
  int flags;
};

struct NnArgs {
  const unsigned char* unsched;
  const int* nsuffix;
  const unsigned char* nvalid;
  int N;
  const int* psuffix;
  const unsigned* seeds;
  const unsigned char* pvalid;
  const int* tol_key;
  const int* tol_value;
  const int* tol_effect;
  const int* tol_op;
  const unsigned char* tol_empty_key;
  const int* num_tols;
  int T;
  int P;
  int match_score;
  int unsched_key_hash;
  int empty_value_hash;
  int effect_none;
  int effect_no_schedule;
  int op_exists;
  int* choice;
  int* best;
};

// shared memory: the tile's node suffixes (i32, -1 for none); bitmaps of
// the nodes a non-tolerating and a tolerating pod may use; one bitmap per
// suffix bucket; the block's row states
constexpr size_t kNnSmemBytes =
    kTile * sizeof(int) +
    (2 * kTileWords + kBuckets * kBucketStride) * sizeof(unsigned) +
    kMaxRowsPerBlock * sizeof(RowState);

__device__ __forceinline__ int bucket_of(int ns) {
  return ns >= 0 ? (ns & 15) : kNoSuffix;
}

// The pod half of the chain, into the block's row states.  A warp takes
// kWarp / T rows at a time, one toleration slot a lane, and evaluates
// == plugins/nodeunschedulable.tolerates_unschedulable for each; with
// more than kWarp slots it takes one row at a time.
__device__ void init_rows(const NnArgs& a, int r0, int nrows, RowState* state,
                          int lane, int warp) {
  const int T = a.T;
  const bool narrow = T > 0 && T <= kWarp;
  const int per = narrow ? kWarp / T : 1;  // rows a warp checks at once
  const int seg = narrow ? lane / T : 0;   // this lane's row among them
  const int slot0 = narrow ? lane % T : lane;
  const int step = narrow ? T : kWarp;
  const unsigned seg_bits =
      narrow && T < kWarp ? ((1u << T) - 1u) << (seg * T) : kFull;
  for (int rb = warp * per; rb < nrows; rb += kNnWarps * per) {
    const int r = rb + seg;
    const bool mine = seg < per && r < nrows;
    const int row = r0 + (mine ? r : 0);
    bool any = false;
    if (mine) {
      const int n = a.num_tols[row];
      for (int t = slot0; t < T; t += step) {
        const size_t k = static_cast<size_t>(row) * T + t;
        const int effect = a.tol_effect[k];
        const bool exists = a.tol_op[k] == a.op_exists;
        const bool effect_ok =
            effect == a.effect_none || effect == a.effect_no_schedule;
        const bool value_ok = exists || a.tol_value[k] == a.empty_value_hash;
        const bool wildcard = a.tol_empty_key[k] != 0 && exists;
        const bool key_matches = a.tol_key[k] == a.unsched_key_hash;
        any |= t < n && effect_ok && (wildcard || (key_matches && value_ok));
      }
    }
    const unsigned tolerating = __ballot_sync(kFull, any);
    if (mine && slot0 == 0) {
      const bool live = a.pvalid[row] != 0;
      const bool tol = live && (tolerating & seg_bits) != 0;
      const int ps = a.psuffix[row];
      state[r] = RowState{kNoHash, kNone, ps >= 0 ? ps : kNever,
                          a.seeds[row],
                          (live ? kLive : 0) | (tol ? kTolerates : 0)};
    }
  }
}

// One lane's nodes of a tile: node q of the lane is node
// tile_word(q) * 32 + lane of the tile.
struct TileCols {
  int ns[kWordsPerWarp];
  unsigned live;  // bit q: the node is valid
  unsigned un;    // bit q: the node is unschedulable
};

// The bitmap word a warp builds in its q-th step.  Each block starts at
// another word, so that the card's blocks do not all read the same lines
// of the node columns at the same moment.
__device__ __forceinline__ int tile_word(int q, int warp) {
  return (warp + q * kNnWarps + static_cast<int>(blockIdx.x) * 41) %
         kTileWords;
}

// The node columns of tile [t0, t0 + n), n >= 1: every load starts
// before any is used.
__device__ __forceinline__ TileCols load_tile(const NnArgs& a, int t0, int n,
                                              int lane, int warp) {
  TileCols c;
  c.live = 0;
  c.un = 0;
#pragma unroll
  for (int q = 0; q < kWordsPerWarp; ++q) {
    const int j = tile_word(q, warp) * kWarp + lane;
    const int g = t0 + min(j, n - 1);
    c.ns[q] = a.nsuffix[g];
    c.live |= static_cast<unsigned>(j < n && a.nvalid[g] != 0) << q;
    c.un |= static_cast<unsigned>(a.unsched[g] != 0) << q;
  }
  return c;
}

// Write a loaded tile into shared memory: suffix keys, the two usable
// bitmaps (ballots) and one bitmap per bucket (the lanes of one bucket
// found by __match_any_sync; its lowest lane writes the word), 32 nodes a
// word.
__device__ void store_tile(const TileCols& c, int* keys, unsigned* usable,
                           unsigned* buckets, int lane, int warp) {
  __syncthreads();  // every warp is done with the previous tile
  for (int k = threadIdx.x; k < kBuckets * kBucketStride; k += kNnThreads) {
    buckets[k] = 0;  // a bucket no node of a word falls in keeps 0 there
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kWordsPerWarp; ++q) {
    const int word = tile_word(q, warp);
    const bool live = (c.live >> q) & 1u;
    const int ns = c.ns[q];
    keys[word * kWarp + lane] = ns >= 0 ? ns : -1;  // never kNever
    const unsigned tol_word = __ballot_sync(kFull, live);
    const unsigned non_word = __ballot_sync(kFull, live && !((c.un >> q) & 1u));
    const int b = live ? bucket_of(ns) : kBuckets;  // invalid: no bucket
    const unsigned peers = __match_any_sync(kFull, b);
    if (b < kBuckets && lane == __ffs(peers) - 1) {
      buckets[b * kBucketStride + word] = peers;
    }
    if (lane == 0) {
      usable[word] = non_word;
      usable[kTileWords + word] = tol_word;
    }
  }
  __syncthreads();
}

// One row against the staged tile's first `words` bitmap words: each node
// whose bit is set in `use` (and, for kMatch, in its suffix's bucket)
// and that passes P is hashed into the lane's (h, i).  A lane takes four
// set bits a step, so that four mix32 chains run side by side.
template <int P>
__device__ __forceinline__ void scan_words(const unsigned* bucket,
                                           const unsigned* use,
                                           const int* keys, int words, int t0,
                                           const RowState& st, unsigned& h,
                                           int& i, int lane) {
  for (int k = lane; k < words; k += kWarp) {
    unsigned w = use[k];
    if (P == kMatch) w &= bucket[k];
    while (w) {
      int j[4];
      bool set[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        set[u] = w != 0;
        j[u] = k * kWarp + (set[u] ? __ffs(w) - 1 : 0);
        w &= w - 1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bool take = set[u];
        if (P == kMatch) take = take && keys[j[u]] == st.target;
        if (P == kFeasibleNoMatch) take = take && keys[j[u]] != st.target;
        const int node = t0 + j[u];
        const unsigned hj = mix32(st.seed, static_cast<unsigned>(node));
        if (take && (hj < h || (hj == h && node < i))) {
          h = hj;
          i = node;
        }
      }
    }
  }
}

__device__ __forceinline__ int pass_pred(int pass, int match_score) {
  if (match_score > 0) return pass == 0 ? kMatch : kFeasible;
  if (match_score == 0) return pass == 0 ? kFeasible : kNoPass;
  return pass == 0 ? kFeasibleNoMatch : kMatch;
}

__global__ void __launch_bounds__(kNnThreads)
nodenumber_select_hosts_kernel(NnArgs a, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* keys = reinterpret_cast<int*>(smem);
  unsigned* usable = reinterpret_cast<unsigned*>(keys + kTile);
  unsigned* buckets = usable + 2 * kTileWords;
  RowState* state =
      reinterpret_cast<RowState*>(buckets + kBuckets * kBucketStride);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, a.P - r0);
  if (nrows <= 0) return;  // block-uniform
  const int N = a.N;
  // the first tile's loads are in flight while the rows' tolerations load
  TileCols cols{};
  if (N > 0) cols = load_tile(a, 0, min(kTile, N), lane, warp);
  bool fresh = N > 0;  // cols holds the first tile, not yet stored

  init_rows(a, r0, nrows, state, lane, warp);
  __syncthreads();  // from here on, warp w owns rows w, w + kNnWarps, ...

  bool staged = false;  // the single tile of an N <= kTile is staged once
  for (int pass = 0; pass < 2; ++pass) {
    const int pred = pass_pred(pass, a.match_score);
    if (pred == kNoPass) break;
    // the second pass serves only rows the first found nothing for
    bool mine = false;
    for (int r = warp; r < nrows; r += kNnWarps) {
      const RowState st = state[r];
      const bool takes = (st.flags & kLive) && (pass == 0 || st.idx == kNone);
      if (pass == 1 && takes && lane == 0) state[r].flags = st.flags | kSecond;
      mine |= takes;
    }
    __syncwarp();
    if (!__syncthreads_or(mine)) break;
    for (int t0 = 0; t0 < N; t0 += kTile) {
      const int n = min(kTile, N - t0);
      if (!staged) {
        if (!fresh || t0 != 0) cols = load_tile(a, t0, n, lane, warp);
        fresh = false;
        store_tile(cols, keys, usable, buckets, lane, warp);
        staged = N <= kTile;
      }
      const int words = (n + kWarp - 1) / kWarp;
      for (int r = warp; r < nrows; r += kNnWarps) {
        const RowState st = state[r];
        if (!(st.flags & kLive) || (pass == 1 && !(st.flags & kSecond))) {
          continue;
        }
        const unsigned* use =
            usable + ((st.flags & kTolerates) ? kTileWords : 0);
        unsigned h = kNoHash;
        int i = kNone;
        if (pred == kMatch) {
          if (st.target >= 0) {  // only its suffix's bucket can hold a match
            scan_words<kMatch>(buckets + bucket_of(st.target) * kBucketStride,
                               use, keys, words, t0, st, h, i, lane);
          }
        } else if (pred == kFeasible) {
          scan_words<kFeasible>(nullptr, use, keys, words, t0, st, h, i,
                                lane);
        } else {
          scan_words<kFeasibleNoMatch>(nullptr, use, keys, words, t0, st, h,
                                       i, lane);
        }
        warp_min(h, i);
        if (lane == 0 && i != kNone &&
            (h < st.hash || (h == st.hash && i < st.idx))) {
          state[r].hash = h;
          state[r].idx = i;
        }
        __syncwarp();
      }
    }
  }

  // the winner's score follows from the pass that found it
  const int ms = a.match_score;
  const int first_score = ms > 0 ? ms : 0;
  const int second_score = ms > 0 ? 0 : ms;
  for (int r = warp; r < nrows; r += kNnWarps) {
    if (lane != 0) continue;
    const RowState st = state[r];
    const bool found = (st.flags & kLive) && st.idx != kNone;
    a.choice[r0 + r] = found ? st.idx : -1;
    a.best[r0 + r] = found ? ((st.flags & kSecond) ? second_score : first_score)
                           : 0;
  }
}

// blocks of the fused kernel resident on the card at once (0 on error)
int nn_resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(nodenumber_select_hosts_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kNnSmemBytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nodenumber_select_hosts_kernel, kNnThreads,
          kNnSmemBytes) != cudaSuccess) {
    return 0;
  }
  cached[dev] = sms * per_sm;
  return cached[dev];
}

}  // namespace

// Plain C interface (bound with ctypes).  Each launches on the given stream
// of the calling thread's current device (the wrapper sets it), does not
// synchronise, and returns the cudaError_t of the launch.

extern "C" int minisched_select_hosts(const void* scores, const void* mask,
                                      const void* seeds, int P, int N,
                                      int node_base, void* choice, void* best,
                                      void* stream) {
  if (P <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((P + kWarps - 1) / kWarps);
  select_hosts_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(scores), static_cast<const unsigned char*>(mask),
      static_cast<const unsigned*>(seeds), P, N, node_base,
      static_cast<int*>(choice), static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

// The fused kernel's dynamic shared memory a block and its resident blocks
// on the current card (for the build report; 0 blocks on error).
extern "C" int minisched_nodenumber_smem_bytes() {
  return static_cast<int>(kNnSmemBytes);
}

extern "C" int minisched_nodenumber_resident_blocks() {
  return nn_resident_blocks();
}

extern "C" int minisched_nodenumber_select_hosts(
    const void* unsched, const void* nsuffix, const void* nvalid, int N,
    const void* psuffix, const void* seeds, const void* pvalid,
    const void* tol_key, const void* tol_value, const void* tol_effect,
    const void* tol_op, const void* tol_empty_key, const void* num_tols,
    int T, int P, int match_score, int unsched_key_hash, int empty_value_hash,
    int effect_none, int effect_no_schedule, int op_exists, void* choice,
    void* best, void* stream) {
  if (P <= 0) return 0;
  const int resident = nn_resident_blocks();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // a persistent grid (one pass of resident blocks) unless a block would
  // then own more rows than its state holds
  int grid = std::min(resident, (P + kNnWarps - 1) / kNnWarps);
  grid = std::max(grid, (P + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock);
  const int rows_per_block = (P + grid - 1) / grid;
  grid = (P + rows_per_block - 1) / rows_per_block;
  NnArgs a{static_cast<const unsigned char*>(unsched),
           static_cast<const int*>(nsuffix),
           static_cast<const unsigned char*>(nvalid),
           N,
           static_cast<const int*>(psuffix),
           static_cast<const unsigned*>(seeds),
           static_cast<const unsigned char*>(pvalid),
           static_cast<const int*>(tol_key),
           static_cast<const int*>(tol_value),
           static_cast<const int*>(tol_effect),
           static_cast<const int*>(tol_op),
           static_cast<const unsigned char*>(tol_empty_key),
           static_cast<const int*>(num_tols),
           T,
           P,
           match_score,
           unsched_key_hash,
           empty_value_hash,
           effect_none,
           effect_no_schedule,
           op_exists,
           static_cast<int*>(choice),
           static_cast<int*>(best)};
  nodenumber_select_hosts_kernel<<<grid, kNnThreads, kNnSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      a, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
