// The blocked scan lane's commit of one block, hand-written for Hopper
// (sm_90a): the rest of a step after the chain's evaluation and its
// seeded argmax (ops/scan_commit.py block_commit; the plain twin there is
// the composition it replaces).
//
// Replaces no TPU kernel.  The JAX package leaves this commit to XLA,
// which fuses accept_placements, the combo and volume updates and
// apply_placements into a few fusions of its blocked step.  Eager
// PyTorch runs the same composition as ~430 small kernels a step (a
// stable argsort, segmented prefix sums, index_add_/gather/index_put_
// passes over the (C, N) combo planes and the volume planes), each one
// replayed in the step's CUDA graph.  Bound on this card: bytes, and
// tiny ones: a block of B pods reads its B rows of pod columns, one
// topology-domain row per combo a committed pod matches, and writes the
// entries its pods change (a few tens of KB at 5,120 nodes, ~0.02 us at
// 3.35 TB/s).  What rules is launch latency, so the design is two
// launches a block, whatever B and the chain:
//
// block_accept_kernel (one CTA, one thread a pod, B <= 1,024)
//   ops/repair.accept_placements, exactly, from the PRE-update node
//   columns: pods taken in index order per chosen node while the node's
//   headroom covers the cumulative demand (cpu, memory, ephemeral
//   storage, pod count, each volume family the chain limits) of the
//   earlier eligible candidates on it, where an earlier candidate that
//   does not fit still counts and a zero-demand pod always passes; the
//   first (node, port) claim wins, a pod's repeated ports dropped; per
//   (node, volume) the first mount wins unless it and the later one are
//   both read-only.  A pod's thread scans the earlier pods of its block
//   (shared memory for the per-pod flags) instead of sorting them.  It
//   writes choice / best / accepted at the block's rows, adds the
//   committed pods to combo_global, writes the volume planes' dummy-row
//   entries (the twin's index_put_ aims every slot that does not commit
//   there), and leaves in scratch the committed flags and the lists of
//   what the committed pods add to the combo planes: (combo, landing
//   node, domain) for each combo a pod matches and each term slot whose
//   landing node carries its key.
//
// block_apply_kernel (a grid over the node columns, one thread a column)
//   Owner computes: the thread of column n applies, in pod order, every
//   committed pod landing on n (req_*, nzreq_*, the used-port slots, the
//   volume planes, with every vol_any read of the block made before its
//   writes, as the twin's `attached`) and every entry of the lists whose
//   domain holds n (combo_dsum, combo_here, combo_excl, rev_weight), so
//   its work is the block's matches, not B x C.  No atomics on the state;
//   integer sums wrap as the twin's int32 sums do and commute, so every
//   state tensor is bit-equal to the twin's.
//
// Two launches, because the second writes node columns the first reads:
// stream order keeps the first's reads ahead of every write.  Neither
// kernel allocates, synchronises or is read back on the host, so both
// are recorded in the step's CUDA graph.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1024;  // pods a block (one CTA of accept)
constexpr int kMaxFamilies = 8;  // volume-limit plugins of a chain
constexpr int kApplyThreads = 256;
constexpr long long kInf32 = INT_MAX;  // the twin's dead-key sentinel

}  // namespace

// Mirrored field for field by ops/scan_commit.py _Args (ctypes): every
// pointer first, then the ints.  A plane the chain does not track is null.
struct BlockCommitArgs {
  // the block: rows of the call's tables, the evaluation's outputs
  const long long* rows;        // [B] pod-table rows of the block
  const int* choice;            // [B] node or -1
  const int* best;              // [B]
  const unsigned char* valid;   // [B]
  const int* req_cpu_p;         // [B]
  const int* req_mem_p;         // [B]
  const int* req_eph_p;         // [B]
  const int* port;              // [B, W]
  const int* num_ports;         // [B]
  // node columns: read for the accept rule, updated by the commit
  const int* alloc_cpu;  // [N]
  const int* alloc_mem;
  const int* alloc_eph;
  const int* alloc_pods;
  int* req_cpu;  // [N]
  int* req_mem;
  int* req_eph;
  int* req_pods;
  int* nzreq_cpu;
  int* nzreq_mem;
  int* used_port;       // [N, UP]
  int* num_used_ports;  // [N]
  // the call's outputs, [P]
  int* choice_out;
  int* best_out;
  unsigned char* accepted_out;
  // combo planes (track_combos)
  const unsigned char* pmc;  // [B, C] pod matches combo
  const long long* combo_key;  // [C] row of topo_domain
  const unsigned char* uniq;   // [C] the combo's key is one domain a node
  const int* topo_domain;      // [K, N] domain id, D = keyless
  const int* pan_combo;        // [B, TPAN]
  const int* pan_n;            // [B]
  const int* ppa_combo;        // [B, TPPA]
  const int* ppa_w;            // [B, TPPA]
  const int* ppa_n;            // [B]
  const int* pa_combo;         // [B, TPA]
  const int* pa_n;             // [B]
  int* combo_dsum;             // [C, N]
  int* combo_here;             // [C, N]
  int* combo_global;           // [C]
  unsigned char* combo_excl;   // [C, N]
  int* rev_weight;             // [C, N]
  // volume planes (track_vols); the slot planes are the call's [P, V]
  const int* slot_cnt;
  const int* slot_vol;
  const unsigned char* slot_ro;
  const int* slot_fam;
  const unsigned char* slot_dup;
  const int* pod_missing;   // [B]
  const int* pod_vols_fam;  // [B, F]
  unsigned char* vol_any;   // [Vd, N]
  unsigned char* vol_rw;    // [Vd, N]
  int* node_vols_fam;       // [F, N]
  // scratch (Scratch below): the accept kernel's committed flags and its
  // lists of what the committed pods add to the combo planes
  int* scratch;
  // sizes
  int B, N, W, UP, C, D, TPAN, TPPA, TPA, V, Vd, F, scratch_len;
  // the chain
  int check_resources, check_ports, check_restr, track_combos, track_vols;
  int n_fam;
  int fam_index[kMaxFamilies];
  int fam_max[kMaxFamilies];
  int nonzero_cpu, nonzero_mem, hard_weight;
};

namespace {

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// The scratch buffer's layout: three counters (combo hits, exclusion
// terms, scoring terms), the committed flags [B], then the lists the
// accept kernel fills and the apply kernel walks, so a column's thread
// visits only what the block's committed pods add, not every (pod, combo,
// slot).  An entry is (combo, landing node, the landing node's domain,
// the key's row of topo_domain or -1 for a hostname-like key), and a
// scoring term's adds its weight; the apply kernel then makes one load
// of topo_domain an entry, not a chain through combo_key and uniq.
constexpr int kEntry = 4;
struct Scratch {
  int committed, hits, excl, rev, len;
  __host__ __device__ explicit Scratch(const BlockCommitArgs& a)
      : committed(3),
        hits(committed + a.B),
        excl(hits + kEntry * a.B * a.C),
        rev(excl + kEntry * a.B * a.TPAN),
        len(rev + (kEntry + 1) * a.B * (a.TPPA + a.TPA)) {}
};

// Does pod b keep every host-port claim?  A pair (b, w) is live when w is
// in range and not a repeat of an earlier slot of b; it loses when an
// earlier live pair (in pod-major order) has its (node, port) key.  The
// key is the twin's int32 choice * 65536 + port, compared as it is.
__device__ bool ports_ok(const BlockCommitArgs& a, int b,
                         const unsigned char* live, const int* choice) {
  const int W = a.W;
  const int np = min(a.num_ports[b], W);
  for (int w = 0; w < np; ++w) {
    const int p = a.port[b * W + w];
    bool dup = false;
    for (int v = 0; v < w; ++v) dup |= a.port[b * W + v] == p;
    if (dup) continue;
    const int key = wrap_add(static_cast<int>(
        static_cast<unsigned>(choice[b]) * 65536u), p);
    if (key == INT_MAX) continue;  // the sentinel's key never loses
    for (int q = 0; q < b; ++q) {
      if (!live[q]) continue;
      const int nq = min(a.num_ports[q], W);
      for (int v = 0; v < nq; ++v) {
        const int pq = a.port[q * W + v];
        bool dq = false;
        for (int u = 0; u < v; ++u) dq |= a.port[q * W + u] == pq;
        if (dq) continue;
        if (wrap_add(static_cast<int>(
                static_cast<unsigned>(choice[q]) * 65536u), pq) == key)
          return false;
      }
    }
  }
  return true;
}

// The live mount slot (q, v) of a block row: a bound volume, not a repeat
// of an earlier slot of the same pod.
__device__ __forceinline__ bool mount_live(const BlockCommitArgs& a,
                                           long long row, int v, int* vol) {
  const int V = a.V;
  const int x = a.slot_vol[row * V + v];
  if (x < 0) return false;
  for (int u = 0; u < v; ++u)
    if (a.slot_vol[row * V + u] == x) return false;
  *vol = x;
  return true;
}

// VolumeRestrictions' same-round rule for pod b: per (node, volume) the
// first live mount in pod-major order survives; a later one only if both
// it and the first mount read-only.
__device__ bool restriction_ok(const BlockCommitArgs& a, int b,
                               const unsigned char* live, const int* choice) {
  const int V = a.V;
  const long long row = a.rows[b];
  for (int s = 0; s < V; ++s) {
    int vol;
    if (!mount_live(a, row, s, &vol)) continue;
    const long long key = static_cast<long long>(choice[b]) * a.Vd + vol;
    if (key >= kInf32) continue;  // at or past the sentinel: never loses
    const bool ro = a.slot_ro[row * V + s];
    bool found = false;
    bool first_ro = false;
    for (int q = 0; q <= b && !found; ++q) {
      if (!live[q]) continue;
      const long long qrow = a.rows[q];
      const int end = q == b ? s : V;
      for (int u = 0; u < end; ++u) {
        int qvol;
        if (!mount_live(a, qrow, u, &qvol)) continue;
        if (static_cast<long long>(choice[q]) * a.Vd + qvol == key) {
          found = true;
          first_ro = a.slot_ro[qrow * V + u];
          break;
        }
      }
    }
    if (found && !(ro && first_ro)) return false;
  }
  return true;
}

// The cumulative-demand rule for one amount: the demand of the earlier
// eligible pods on b's node plus b's own within the node's headroom, or b
// asks for nothing.  amount(q) is read by the caller's functor.
template <typename Amount>
__device__ bool prefix_fits(int b, int node, int headroom,
                            const unsigned char* elig, const int* choice,
                            Amount amount) {
  const int amt = amount(b);
  if (amt == 0) return true;
  int within = 0;
  for (int q = 0; q < b; ++q)
    if (elig[q] && choice[q] == node) within = wrap_add(within, amount(q));
  return wrap_add(within, amt) <= headroom;
}

__global__ void block_accept_kernel(BlockCommitArgs a) {
  __shared__ int s_choice[kMaxBlock];
  __shared__ unsigned char s_live[kMaxBlock];
  __shared__ unsigned char s_elig[kMaxBlock];
  __shared__ unsigned char s_acc[kMaxBlock];
  __shared__ int s_count[3];  // combo hits, exclusion and scoring terms
  const int b = threadIdx.x;
  if (b < 3) s_count[b] = 0;
  const bool in = b < a.B;
  const int ch = in ? a.choice[b] : -1;
  const bool live = in && a.valid[b] && ch >= 0;
  if (in) {
    s_choice[b] = ch;
    s_live[b] = live;
  }
  __syncthreads();
  bool ok = true;
  if (live && a.check_ports) ok = ports_ok(a, b, s_live, s_choice);
  if (live && ok && a.check_restr) ok = restriction_ok(a, b, s_live, s_choice);
  const bool elig = live && ok;
  if (in) s_elig[b] = elig;
  __syncthreads();
  bool acc = elig;
  if (elig) {
    const int n = ch;
    const int* cpu = a.req_cpu_p;
    const int* mem = a.req_mem_p;
    const int* eph = a.req_eph_p;
    if (a.check_resources) {
      acc = acc && prefix_fits(b, n, wrap_sub(a.alloc_cpu[n], a.req_cpu[n]),
                               s_elig, s_choice,
                               [cpu](int q) { return cpu[q]; });
      acc = acc && prefix_fits(b, n, wrap_sub(a.alloc_mem[n], a.req_mem[n]),
                               s_elig, s_choice,
                               [mem](int q) { return mem[q]; });
      acc = acc && prefix_fits(b, n, wrap_sub(a.alloc_eph[n], a.req_eph[n]),
                               s_elig, s_choice,
                               [eph](int q) { return eph[q]; });
      acc = acc && prefix_fits(b, n, wrap_sub(a.alloc_pods[n], a.req_pods[n]),
                               s_elig, s_choice, [](int) { return 1; });
    }
    for (int i = 0; i < a.n_fam; ++i) {
      const int f = a.fam_index[i];
      const int F = a.F;
      const int* vols = a.pod_vols_fam;
      acc = acc && prefix_fits(
          b, n,
          wrap_sub(a.fam_max[i],
                   a.node_vols_fam[static_cast<long long>(f) * a.N + n]),
          s_elig, s_choice, [vols, F, f](int q) { return vols[q * F + f]; });
    }
  }
  if (in) {
    s_acc[b] = acc;
    a.scratch[Scratch(a).committed + b] = acc;
    const long long row = a.rows[b];
    a.choice_out[row] = ch;
    a.best_out[row] = a.best[b];
    a.accepted_out[row] = acc;
    if (a.track_vols) {
      // the twin aims each slot that does not commit at the dummy row
      // (the last, no claim's) of the pod's clamped choice; nothing reads
      // that row, so the entries are written here
      const int nb = max(ch, 0);
      const long long dummy = static_cast<long long>(a.Vd - 1) * a.N + nb;
      bool any_cnt = false, any_rw = false;
      for (int v = 0; v < a.V; ++v) {
        const long long k = row * a.V + v;
        any_cnt |= !(acc && a.slot_cnt[k] >= 0);
        any_rw |= !(acc && a.slot_vol[k] >= 0 && !a.slot_ro[k]);
      }
      if (any_cnt) a.vol_any[dummy] = 1;
      if (any_rw) a.vol_rw[dummy] = 1;
    }
  }
  __syncthreads();
  if (!a.track_combos) return;
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    int k = 0;
    for (int q = 0; q < a.B; ++q) k += s_acc[q] && a.pmc[q * a.C + c];
    if (k) a.combo_global[c] = wrap_add(a.combo_global[c], k);
  }
  // the lists of what each committed pod adds; their order is the
  // atomics', and it does not matter: the apply kernel's integer sums
  // commute and its exclusion writes are ORs
  if (acc) {
    const Scratch sc(a);
    const int landing = ch;
    // append an entry to list `which` (0 hits, 1 exclusion, 2 scoring
    // terms) at `list`; none, and null, where the landing node lacks the
    // combo's key (the entry would reach nothing) unless `keyless_too`
    const auto add = [&](int which, int list, int stride, int c,
                         bool keyless_too) {
      const int key = static_cast<int>(a.combo_key[c]);
      const int d = a.topo_domain[static_cast<long long>(key) * a.N + landing];
      if (d == a.D && !keyless_too) return static_cast<int*>(nullptr);
      int* e = a.scratch + list + stride * atomicAdd(&s_count[which], 1);
      e[0] = c;
      e[1] = landing;
      e[2] = d;
      e[3] = a.uniq[c] ? -1 : key;
      return e;
    };
    // combo_here counts a match on a keyless node too
    for (int c = 0; c < a.C; ++c)
      if (a.pmc[b * a.C + c]) add(0, sc.hits, kEntry, c, true);
    for (int t = 0; t < min(a.pan_n[b], a.TPAN); ++t)
      add(1, sc.excl, kEntry, a.pan_combo[b * a.TPAN + t], false);
    const auto scores = [&](int c, int w) {
      int* e = add(2, sc.rev, kEntry + 1, c, false);
      if (e != nullptr) e[kEntry] = w;
    };
    for (int t = 0; t < min(a.ppa_n[b], a.TPPA); ++t)
      scores(a.ppa_combo[b * a.TPPA + t], a.ppa_w[b * a.TPPA + t]);
    for (int t = 0; t < min(a.pa_n[b], a.TPA); ++t)
      scores(a.pa_combo[b * a.TPA + t], a.hard_weight);
  }
  __syncthreads();
  if (threadIdx.x < 3) a.scratch[threadIdx.x] = s_count[threadIdx.x];
}

// Does a list entry (combo, landing node, its domain d, key row or -1)
// reach column n?  The landing node must carry the key (d != D); a
// hostname-like key reaches the landing node alone, any other every node
// of the domain.
__device__ __forceinline__ bool reaches(const BlockCommitArgs& a,
                                        const int* e, int n) {
  if (e[2] == a.D) return false;
  return e[3] < 0 ? e[1] == n
                  : a.topo_domain[static_cast<long long>(e[3]) * a.N + n] ==
                        e[2];
}

__global__ void block_apply_kernel(BlockCommitArgs a) {
  __shared__ int s_pod[kMaxBlock];   // committed pods, in pod order
  __shared__ int s_node[kMaxBlock];  // and their nodes
  __shared__ int s_warp[kApplyThreads / 32];
  __shared__ int s_chunk;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // the block's committed pods, compacted in order (every thread takes
  // part: the ballots need the whole warp)
  int K = 0;
  for (int start = 0; start < a.B; start += blockDim.x) {
    const int b = start + t;
    const bool c = b < a.B && a.scratch[Scratch(a).committed + b];
    const unsigned m = __ballot_sync(0xFFFFFFFFu, c);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    if (t == 0) {
      int sum = 0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
        const int x = s_warp[w];
        s_warp[w] = sum;
        sum += x;
      }
      s_chunk = sum;
    }
    __syncthreads();
    if (c) {
      const int pos = K + s_warp[warp] + __popc(m & ((1u << lane) - 1u));
      s_pod[pos] = b;
      s_node[pos] = a.choice[b];
    }
    K += s_chunk;
    __syncthreads();
  }
  const int n = blockIdx.x * blockDim.x + t;
  if (n >= a.N || K == 0) return;
  const int N = a.N;

  // the node's own columns: requests and host ports, in pod order
  int dcpu = 0, dmem = 0, deph = 0, dpods = 0, dnzc = 0, dnzm = 0;
  const int used = a.num_used_ports[n];
  int rank = 0, added = 0;
  bool here = false;
  for (int k = 0; k < K; ++k) {
    if (s_node[k] != n) continue;
    here = true;
    const int b = s_pod[k];
    const int rc = a.req_cpu_p[b], rm = a.req_mem_p[b];
    dcpu = wrap_add(dcpu, rc);
    dmem = wrap_add(dmem, rm);
    deph = wrap_add(deph, a.req_eph_p[b]);
    dpods = wrap_add(dpods, 1);
    dnzc = wrap_add(dnzc, rc == 0 ? a.nonzero_cpu : rc);
    dnzm = wrap_add(dnzm, rm == 0 ? a.nonzero_mem : rm);
    const int np = min(a.num_ports[b], a.W);
    for (int w = 0; w < np; ++w, ++rank) {
      // ports past the node's slots are dropped
      const long long slot = static_cast<long long>(used) + rank;
      if (slot < a.UP) {
        a.used_port[static_cast<long long>(n) * a.UP + slot] =
            a.port[b * a.W + w];
        ++added;
      }
    }
  }
  if (here) {
    a.req_cpu[n] = wrap_add(a.req_cpu[n], dcpu);
    a.req_mem[n] = wrap_add(a.req_mem[n], dmem);
    a.req_eph[n] = wrap_add(a.req_eph[n], deph);
    a.req_pods[n] = wrap_add(a.req_pods[n], dpods);
    a.nzreq_cpu[n] = wrap_add(a.nzreq_cpu[n], dnzc);
    a.nzreq_mem[n] = wrap_add(a.nzreq_mem[n], dnzm);
    a.num_used_ports[n] = wrap_add(used, added);
  }

  if (a.track_vols && here) {
    const int V = a.V;
    // every read of vol_any first: only NEW attachments count, against
    // the planes as the block found them
    for (int k = 0; k < K; ++k) {
      if (s_node[k] != n) continue;
      const int b = s_pod[k];
      const long long row = a.rows[b];
      for (int v = 0; v < V; ++v) {
        const long long s = row * V + v;
        const int cnt = a.slot_cnt[s];
        if (cnt < 0 || a.slot_dup[s] ||
            a.vol_any[static_cast<long long>(cnt) * N + n])
          continue;
        const int fam = a.slot_fam[s];
        if (fam >= 0 && fam < a.F) {
          int* col = a.node_vols_fam + static_cast<long long>(fam) * N + n;
          *col = wrap_add(*col, 1);
        }
      }
      // mounts of missing claims count in the generic family
      a.node_vols_fam[n] = wrap_add(a.node_vols_fam[n], a.pod_missing[b]);
    }
    for (int k = 0; k < K; ++k) {
      if (s_node[k] != n) continue;
      const long long row = a.rows[s_pod[k]];
      for (int v = 0; v < V; ++v) {
        const long long s = row * V + v;
        const int cnt = a.slot_cnt[s];
        if (cnt >= 0) a.vol_any[static_cast<long long>(cnt) * N + n] = 1;
        const int vol = a.slot_vol[s];
        if (vol >= 0 && !a.slot_ro[s])
          a.vol_rw[static_cast<long long>(vol) * N + n] = 1;
      }
    }
  }

  if (a.track_combos) {
    const Scratch sc(a);
    const int hits = a.scratch[0], excl = a.scratch[1], rev = a.scratch[2];
    // each committed pod joins every combo it matches
    const int* e = a.scratch + sc.hits;
    for (int i = 0; i < hits; ++i, e += kEntry) {
      const long long cn = static_cast<long long>(e[0]) * N + n;
      if (e[1] == n) a.combo_here[cn] = wrap_add(a.combo_here[cn], 1);
      if (reaches(a, e, n)) a.combo_dsum[cn] = wrap_add(a.combo_dsum[cn], 1);
    }
    // its required anti-affinity terms ban matchers from the domain
    e = a.scratch + sc.excl;
    for (int i = 0; i < excl; ++i, e += kEntry)
      if (reaches(a, e, n))
        a.combo_excl[static_cast<long long>(e[0]) * N + n] = 1;
    // its preferred terms (signed weight) and required affinity terms
    // (hard weight) score toward later matching pods
    e = a.scratch + sc.rev;
    for (int i = 0; i < rev; ++i, e += kEntry + 1)
      if (reaches(a, e, n)) {
        int* cell = a.rev_weight + static_cast<long long>(e[0]) * N + n;
        *cell = wrap_add(*cell, e[kEntry]);
      }
  }
}

}  // namespace

extern "C" int minisched_block_commit(const BlockCommitArgs* args,
                                      void* stream) {
  const BlockCommitArgs& a = *args;
  if (a.B < 1 || a.B > kMaxBlock || a.n_fam < 0 || a.n_fam > kMaxFamilies ||
      a.scratch_len < Scratch(a).len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (a.B + 31) / 32 * 32;
  block_accept_kernel<<<1, threads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.N <= 0) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((a.N + kApplyThreads - 1) / kApplyThreads);
  block_apply_kernel<<<grid, kApplyThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
