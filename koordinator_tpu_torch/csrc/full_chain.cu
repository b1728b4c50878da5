// One full-chain scheduling round on Hopper (sm_90a): P pods in queue order
// against N nodes, with every piece of in-round state carried from pod to
// pod.
//
// Replaces the TPU kernel `_make_kernel` of
// koordinator_tpu/ops/pallas_full_chain.py (reached through
// build_pallas_full_chain_step, pallas_call at :667). It computes what the
// plain round of models/full_chain.py computes, with the same f32
// operations in the same order, so `chosen` is bit-identical to it.
//
// What bounds it on this card: the round is serial in the pods. Pod i+1
// reads the node, quota and affinity state that pod i's Reserve wrote, and
// every pod needs an argmax over all N nodes before the next pod can start.
// Over the whole card the work is small (N x ~70 f32 operations per pod),
// so neither the card's bytes nor its operations bound it; what does is the
// per-pod chain: the Filter/Score latency of the nodes one thread owns,
// then the reduction and barrier that publish the winner.
//
// The design (kernel_common.cuh, "The cluster design") spreads the nodes
// over one thread-block cluster of C blocks on C SMs, so that at the main
// path's N = 5120 and C = 16 each thread owns one node. Each block keeps
// its slice of the carried node state (requested, the LoadAware deltas on
// the weighted axes, NUMA zones, bindable cpus, volume headroom, ports,
// affinity counts and covers), its slice of allocatable and of the
// LoadAware terms, and its own copy of the quota state in shared memory;
// `kStateInSmem = false` keeps the same state in device memory when the
// slice exceeds the budget (the wrapper's estimate_smem_bytes decides).
// The pod records arrive through a ring filled by the control warp's bulk
// copies, so a pod's rows are in shared memory before it starts. Per pod:
// the control warp checks the quota chain beside the node loop; the spread
// minima and the preferred pod-affinity max/min, where a pod has them, are
// one cluster reduction (one cluster barrier); the winner is merged as
// kernel_common.cuh describes, each block pushing its best to every block;
// the pod-level verdict (gang, quota) is applied to the merged winner; the
// owner thread reserves, every block updates its quota copy and its slice
// of the affinity domain the same way.
//
// The replay instance (`kReplay`) is the fused waves' kept-only replay
// (models/fused_waves.py, pass 2; the JAX package runs it as an XLA
// fori_loop, fused_waves.py:527-559, with no TPU kernel): the pods that
// survived the gang Permit, in queue order, each committed onto the node
// pass 1 chose for it, from the wave-start state. No Filter, Score or
// merge runs: the same Reserve code commits each pod, the owner re-picks
// the NUMA zone under the replay state and writes it to `zones`, and no
// pod waits on a barrier, since each block replays its own node slice.
//
// The terms instance (`kTerms`, koordexplain "full"; the JAX package
// computes the same rows in the XLA body of its models/full_chain.py
// build_full_chain_step and fused_waves.py pass 1, with no TPU kernel)
// runs the same round and also writes, per pod, [la, numa, pref, best,
// runner] (models/full_chain.EXPLAIN_TERMS): the winning node's three
// plugin terms, its score and the best score over the other nodes (the
// feasibility-masked score, -1 for a rejected node, at least -1). Only this
// instance carries the runner-up through the warp, block and cluster merge
// beside the lowest-index best; the owner thread of the winner writes the
// row. A pod whose gang or quota verdict fails sees every node at -1 in the
// plain round, so its row is node 0's terms with best and runner -1. Its
// `chosen`, requested and quota are the round's, bit for bit.
//
// The exchange instances (`kXchg`, kernel_common.cuh "The exchange") run
// the round, the terms round and the replay over a mesh whose shards sit on
// different cards, each card holding only its own node rows. A launch runs
// its card's L shards as L clusters. The round has two exchanges per pod,
// at the two points where the one-card round already merges over its
// cluster: the spread minima and the preferred pod-affinity max/min, for a
// pod that has them (min and max: exact under any split), and the winner.
// A shard's winner entry carries, beside its best (score, global index),
// what the owner's commit gives the others: the node's aff_dom row, and in
// the terms instance its three plugin terms and the shard's runner-up (a
// pod refused at PreFilter takes shard 0's node 0 terms). The merge takes
// (score, lowest global index), as the cluster merge does across its
// blocks; the owning shard reserves, every shard updates its quota copy
// and its own slice of the affinity domain; the gang verdict is in the
// records, the same on every card. The replay needs no merge: each card
// replays the kept pods onto its own rows, the non-owners reading the
// chosen nodes' aff_dom rows from `dom_rows`, gathered once by the wrapper
// (a mailbox would make every replayed pod wait on every card).
//
// The Filter predicates live in filter_chain.cuh, shared with the
// koordexplain stage-count pass (explain_counts.cu).

#include <cooperative_groups.h>

#include "filter_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWeights = 16;
constexpr int kNumTerms = 5;  // models/full_chain.EXPLAIN_TERMS
// The winner entry's payload: score, global index, runner-up, the three
// terms, then the node's aff_dom row [T]; the merged result pushed into
// each block: status, global index, score, runner-up, the three terms, a
// spare word, then the aff_dom row.
constexpr int kWinHead = 6;
constexpr int kResHead = 8;
using koord::kRecCores;
using koord::kRecImg;
using koord::kRecPpref;
using koord::kRecPref;
using koord::kRecQuota;
using koord::kRecTaint;

}  // namespace

// Field order is mirrored by ops/full_chain_kernel.py (_Params); the
// wrapper checks sizeof through full_chain_params_size().
struct FullChainParams {
  // ---- pods: one record per pod, the valid pods first
  const uint32_t* records;   // [P, rec_stride]
  const int32_t* n_valid;    // [1]
  // ---- nodes (read-only)
  const float* alloc;        // [N, R]
  const float* term_np;      // [N, W] weighted axes only
  const float* term_pr;      // [N, W]
  const uint8_t* node_flags;  // [N] kNode* bits
  const float* cpc;          // [N] cpus per core
  const int32_t* policy;     // [N]
  const int32_t* taint_group;  // [N]
  const int32_t* vol_group;  // [N]
  const float* aff_dom;      // [N, T]
  const float* pref_scores;  // [N, S]
  const float* img_scores;   // [N, SI]
  const float* ppref_w;      // [S2, ppref_stride]
  const float* weights;      // [R]
  const int32_t* anc;        // [G, D]
  const float* runtime;      // [G, R]
  const float* quota_init;   // [G, R]
  const uint8_t* aff_exists0;  // [T]
  // ---- carried state (initialised by the wrapper, updated in place)
  float* requested;          // [N, R] (output)
  float* delta_np;           // [N, W] (the replay: W = R, every axis)
  float* delta_pr;           // [N, W]
  float* numa;               // [N, K, R]
  float* bind_free;          // [N]
  float* vol_free;           // [N]
  float* port_used;          // [N, PT]
  float* aff_count;          // [N, T]
  float* anti_cover;         // [N, T]
  float* quota_blocks;       // [C, G, R] block copies; block 0's is output
  int32_t* chosen;           // [P] (round: output, before Permit, -1
                             // preset; replay: input, the node per pod)
  int32_t* zones;            // [P] replay: the re-picked zone (output)
  uint8_t* aff_exists_out;   // [T] the exists flags after the last pod
  float* terms;              // [P, 5] the terms instance's rows (output,
                             // zero preset); null selects the plain round
  const float* dom_rows;     // [P, T] the per-card replay: each kept pod's
                             // chosen node's aff_dom row
  // ---- sizes and static switches
  int P, N, R, K, G, D, T, S, S2, ppref_stride, PT, SI, VG;
  int prod_mode, bal_c, bal_m, n_widx;
  // ---- pod record layout (word offsets)
  int rec_stride, off_fit, off_req, off_est, off_aff, off_anti, off_match,
      off_skew, off_ports, off_vol;
  // ---- cluster plan
  int cluster_size, nodes_per_block, node_threads, state_in_smem, replay;
  int widx[kMaxWeights];
  // ---- the mesh of cards (x.L = 0: one device, N rows, one cluster)
  koord::Xchg x;
};

// Dynamic shared memory of one block (ops/full_chain_kernel.py
// estimate_smem_bytes mirrors it).
struct FcSmem {
  size_t bar, ring, part_warp, part_blk, part_red, warp_red, admit, exists;
  size_t part_wrun, part_brun;  // the terms instance's runner-up partials
  size_t xbar, xres, xout;      // the exchange's mbarriers and results
  size_t quota, runtime, anc, node, flags, total;
};

// 32-bit words of one exchange result (even, for the 8-byte pushes).
__host__ __device__ inline int fc_result_words(int T) {
  return (kResHead + T + 1) & ~1;
}

// Carried and read-only float rows per node kept in shared memory.
__host__ __device__ inline int fc_node_floats(const FullChainParams& p) {
  const int W = p.n_widx;
  return p.R + 2 * W + p.K * p.R + 2 + p.PT + 2 * p.T  // carried
         + p.R + 2 * W;                               // alloc, terms
}

__host__ __device__ inline FcSmem fc_smem_layout(const FullChainParams& p) {
  FcSmem L = {};
  size_t at = 0;
  const int nw = p.node_threads / 32, Q = p.T + 2;
  L.bar = koord::smem_take(at, (koord::kRingStages + 2) * 8);
  L.ring = koord::smem_take(at, (size_t)koord::kRingStages * p.rec_stride * 4);
  L.part_warp = koord::smem_take(at, 2 * (size_t)nw * 8);
  L.part_blk = koord::smem_take(at, 2 * (size_t)p.cluster_size * 8);
  L.part_red = koord::smem_take(at, 2 * (size_t)Q * nw * 4);
  L.warp_red = koord::smem_take(at, (size_t)(nw + 1) * Q * 4);
  L.admit = koord::smem_take(at, 2 * 4);
  L.exists = koord::smem_take(at, (size_t)(p.T > 0 ? p.T : 1) * 4);
  L.part_wrun = koord::smem_take(at, 2 * (size_t)nw * 4);
  L.part_brun = koord::smem_take(at, 2 * (size_t)p.cluster_size * 8);
  if (p.x.L > 0 && !p.replay) {
    const int xw = fc_result_words(p.T);
    L.xbar = koord::smem_take(at, 2 * 8);
    L.xres = koord::smem_take(at, 2 * (size_t)xw * 4);
    L.xout = koord::smem_take(at, (size_t)xw * 4);
  }
  if (p.state_in_smem) {
    L.quota = koord::smem_take(at, (size_t)p.G * p.R * 4);
    L.runtime = koord::smem_take(at, (size_t)p.G * p.R * 4);
    L.anc = koord::smem_take(at, (size_t)p.G * p.D * 4);
    L.node = koord::smem_take(
        at, (size_t)fc_node_floats(p) * p.nodes_per_block * 4);
    L.flags = koord::smem_take(at, (size_t)p.nodes_per_block);
  }
  L.total = at;
  return L;
}

// kR, kK, kW > 0 fix R, K and the weighted-axis count at compile time, so
// the node loop's short loops unroll completely; 0 reads them from `p`.
// kReplay selects the kept-only replay (the records are the kept pods'),
// kTerms the round that also writes the koordexplain terms rows, kXchg the
// instance over a mesh of cards (p.x).
template <bool kStateInSmem, int kR, int kK, int kW, bool kReplay,
          bool kTerms, bool kXchg>
__global__ void __launch_bounds__(koord::kMaxBlockThreads, 1)
    full_chain_kernel(const FullChainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const FcSmem L = fc_smem_layout(p);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);  // ring stages
  uint64_t* merge_bar = bar + koord::kRingStages;              // [2]
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  int2* part_warp = reinterpret_cast<int2*>(smem + L.part_warp);  // [2][NW]
  int2* part_blk = reinterpret_cast<int2*>(smem + L.part_blk);    // [2][C]
  float* part_red = reinterpret_cast<float*>(smem + L.part_red);  // [2][Q][NW]
  float* warp_red = reinterpret_cast<float*>(smem + L.warp_red);  // [NW+1][Q]
  int* s_admit = reinterpret_cast<int*>(smem + L.admit);          // [2]
  int* aff_exists = reinterpret_cast<int*>(smem + L.exists);      // [T]
  float* part_wrun = reinterpret_cast<float*>(smem + L.part_wrun);  // [2][NW]
  int2* part_brun = reinterpret_cast<int2*>(smem + L.part_brun);    // [2][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = p.node_threads, NW = NT >> 5;
  const bool ctrl = warp == NW;  // the control warp owns no node
  const int C = p.cluster_size, rank = (int)cluster.block_rank();
  const int Nb = p.nodes_per_block;
  // this cluster's shard: rows [row0, row0 + per) of the launch's arrays,
  // global rows from gbase (one device: the whole array)
  const int l = kXchg ? (int)(blockIdx.x / C) : 0;
  const int per = kXchg ? p.x.per : p.N;
  const int row0 = l * per;
  const int me = kXchg ? p.x.shard[l] : 0, gbase = me * per;
  const int lo = row0 + min(rank * Nb, per);
  const int nloc = min(rank * Nb + Nb, per) - min(rank * Nb, per);
  // writes the launch's outputs that every shard holds alike
  const bool lead = rank == 0 && l == 0;
  const int R = kR ? kR : p.R, K = kK ? kK : p.K, W = kW ? kW : p.n_widx;
  const int T = p.T, D = p.D, G = p.G;
  const int Q = T + 2, S = koord::kRingStages, stride = p.rec_stride;

  // ---- state: this block's node slice and its quota copy
  using koord::View;
  View req_v, dnp_v, dpr_v, numa_v, bind_v, vol_v, port_v, cnt_v, anti_v;
  View alloc_v, tnp_v, tpr_v;
  float* quota;
  const float* runtime;
  const int32_t* anc;
  const uint8_t* nflags;
  const View g_req{p.requested + (size_t)lo * R, R, 1};
  const View g_dnp{p.delta_np + (size_t)lo * W, W, 1};
  const View g_dpr{p.delta_pr + (size_t)lo * W, W, 1};
  const View g_numa{p.numa + (size_t)lo * K * R, K * R, 1};
  const View g_bind{p.bind_free + lo, 1, 1};
  const View g_vol{p.vol_free + lo, 1, 1};
  const View g_port{p.port_used + (size_t)lo * p.PT, p.PT, 1};
  const View g_cnt{p.aff_count + (size_t)lo * T, T, 1};
  const View g_anti{p.anti_cover + (size_t)lo * T, T, 1};
  const View g_alloc{const_cast<float*>(p.alloc) + (size_t)lo * R, R, 1};
  const View g_tnp{const_cast<float*>(p.term_np) + (size_t)lo * W, W, 1};
  const View g_tpr{const_cast<float*>(p.term_pr) + (size_t)lo * W, W, 1};
  if constexpr (kStateInSmem) {
    float* base = reinterpret_cast<float*>(smem + L.node);
    int row = 0;
    auto slot = [&](int width) {
      const View v{base + (size_t)row * Nb, 1, Nb};
      row += width;
      return v;
    };
    req_v = slot(R), dnp_v = slot(W), dpr_v = slot(W), numa_v = slot(K * R);
    bind_v = slot(1), vol_v = slot(1), port_v = slot(p.PT), cnt_v = slot(T);
    anti_v = slot(T), alloc_v = slot(R), tnp_v = slot(W), tpr_v = slot(W);
    koord::copy_view(req_v, g_req, nloc, R);
    koord::copy_view(dnp_v, g_dnp, nloc, W);
    koord::copy_view(dpr_v, g_dpr, nloc, W);
    koord::copy_view(numa_v, g_numa, nloc, K * R);
    koord::copy_view(bind_v, g_bind, nloc, 1);
    koord::copy_view(vol_v, g_vol, nloc, 1);
    koord::copy_view(port_v, g_port, nloc, p.PT);
    koord::copy_view(cnt_v, g_cnt, nloc, T);
    koord::copy_view(anti_v, g_anti, nloc, T);
    koord::copy_view(alloc_v, g_alloc, nloc, R);
    koord::copy_view(tnp_v, g_tnp, nloc, W);
    koord::copy_view(tpr_v, g_tpr, nloc, W);
    uint8_t* fl = smem + L.flags;
    for (int j = tid; j < nloc; j += blockDim.x) fl[j] = p.node_flags[lo + j];
    nflags = fl;
    quota = reinterpret_cast<float*>(smem + L.quota);
    float* rt = reinterpret_cast<float*>(smem + L.runtime);
    int32_t* an = reinterpret_cast<int32_t*>(smem + L.anc);
    for (int e = tid; e < G * R; e += blockDim.x) rt[e] = p.runtime[e];
    for (int e = tid; e < G * D; e += blockDim.x) an[e] = p.anc[e];
    runtime = rt;
    anc = an;
  } else {
    req_v = g_req, dnp_v = g_dnp, dpr_v = g_dpr, numa_v = g_numa;
    bind_v = g_bind, vol_v = g_vol, port_v = g_port, cnt_v = g_cnt;
    anti_v = g_anti, alloc_v = g_alloc, tnp_v = g_tnp, tpr_v = g_tpr;
    nflags = p.node_flags + lo;
    quota = p.quota_blocks + (size_t)(l * C + rank) * G * R;
    runtime = p.runtime;
    anc = p.anc;
  }
  for (int e = tid; e < G * R; e += blockDim.x) quota[e] = p.quota_init[e];
  for (int t = tid; t < T; t += blockDim.x) aff_exists[t] = p.aff_exists0[t];

  const int nv = *p.n_valid;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.xbar);  // [2]
  uint32_t* xres = reinterpret_cast<uint32_t*>(smem + L.xres);  // [2][XW]
  uint32_t* xout = reinterpret_cast<uint32_t*>(smem + L.xout);  // [XW]
  const int XW = fc_result_words(T);
  if (!kReplay && ctrl && lane == 0) {
    for (int s = 0; s < S + 2; ++s) koord::mbar_init(&bar[s], 1);
    if (kXchg) for (int s = 0; s < 2; ++s) koord::mbar_init(&xbar[s], 1);
    koord::fence_mbar_init();
    for (int v = 0; v < S - 1 && v < nv; ++v)
      koord::bulk_load(ring + v * stride, p.records + (size_t)v * stride,
                       stride * 4, &bar[v]);
  }
  float wsum = 0.0f;  // integer weights: any order is exact
  for (int r = 0; r < R; ++r) wsum = __fadd_rn(wsum, p.weights[r]);
  const float wdiv = fmaxf(wsum, 1.0f);
  const bool ppref_on = T > 0 && p.S2 > 0;
  const koord::RecLayout lay{p.off_fit,  p.off_req,  p.off_est,
                             p.off_aff,  p.off_anti, p.off_match,
                             p.off_skew, p.off_ports, p.off_vol};
  const koord::FilterNodes gn{p.cpc, p.policy, p.taint_group, p.vol_group,
                              p.aff_dom};
  const koord::FilterState fs{req_v, alloc_v, bind_v, numa_v,
                              cnt_v, anti_v,  port_v, vol_v};
  // every block has started and initialised its shared memory
  cluster.sync();

  // ---- Reserve of the pod in `rec` on node best_n: the owner of the node
  // updates its rows (and writes the NUMA zone it picked to zone_out, -1
  // for a pod without NUMA needs), every block adds the quota along the
  // ancestor chain to its own copy and raises the affinity counts over its
  // slice of the node's domain. One piece of code for the round and the
  // replay.
  auto reserve = [&](const uint32_t* rec, int best_n, int32_t* zone_out,
                     const float* dom_row) {
    const uint32_t pf = rec[koord::kRecFlags];
    const bool is_prod = pf & koord::kPodProd;
    const bool needs_numa = pf & koord::kPodNuma;
    const bool needs_bind = pf & koord::kPodBind;
    const float cores = __uint_as_float(rec[kRecCores]);
    const int qid = (int)rec[kRecQuota];
    const float* fit_req = reinterpret_cast<const float*>(rec + p.off_fit);
    const float* rq = reinterpret_cast<const float*>(rec + p.off_req);
    const float* est = reinterpret_cast<const float*>(rec + p.off_est);
    const uint32_t* anti_req = rec + p.off_anti;
    const uint32_t* match = rec + p.off_match;
    const uint32_t* wants = rec + p.off_ports;
    const float* vneed = reinterpret_cast<const float*>(rec + p.off_vol);
    int zone = -1;
    const int jb = best_n - lo;
    if (!ctrl && jb >= 0 && jb < nloc && jb % NT == tid) {
      for (int r = 0; r < R; ++r)
        req_v(jb, r) = __fadd_rn(req_v(jb, r), fit_req[r]);
      for (int jj = 0; jj < W; ++jj) {
        const float e = est[p.widx[jj]];
        dnp_v(jb, jj) = __fadd_rn(dnp_v(jb, jj), e);
        if (p.prod_mode && is_prod) dpr_v(jb, jj) = __fadd_rn(dpr_v(jb, jj), e);
      }
      if (needs_numa) {
        // Only SingleNUMANode pins a zone; every other policy fills the
        // lowest zones first (ops/numa.numa_spread_fill)
        koord::numa_admit(numa_v, jb, R, K, rq, __ldg(p.policy + best_n),
                          zone);
        if (zone >= 0) {
          for (int r = 0; r < R; ++r)
            numa_v(jb, zone * R + r) =
                __fsub_rn(numa_v(jb, zone * R + r), rq[r]);
        } else {
          for (int r = 0; r < R; ++r) {
            float remaining = rq[r];
            for (int k = 0; k < K; ++k) {
              const float take = fminf(numa_v(jb, k * R + r), remaining);
              numa_v(jb, k * R + r) = __fsub_rn(numa_v(jb, k * R + r), take);
              remaining = __fsub_rn(remaining, take);
            }
          }
        }
      }
      if (needs_bind) bind_v(jb, 0) = __fsub_rn(bind_v(jb, 0), cores);
      for (int s = 0; s < p.PT; ++s)
        if (koord::bit_at(wants, s)) port_v(jb, s) = fmaxf(port_v(jb, s), 1.0f);
      vol_v(jb, 0) =
          __fsub_rn(vol_v(jb, 0), vneed[__ldg(p.vol_group + best_n)]);
      if (zone_out != nullptr) *zone_out = zone;
    }
    // quota: every block adds along the ancestor chain to its own copy
    if (ctrl) {
      if (qid >= 0) {
        for (int e = lane; e < D * R; e += 32) {
          const int d = e / R, r = e - d * R;
          const int g = anc[qid * D + d];
          if (g >= 0) quota[g * R + r] = __fadd_rn(quota[g * R + r], rq[r]);
        }
      }
      __syncwarp();
    }
    // affinity: raise matched terms' counts (and carried anti terms'
    // covers) over the chosen node's whole domain, each block over its own
    // slice; every thread latches the exists flags it reads itself
    for (int t = 0; t < T; ++t) {
      const bool m = koord::bit_at(match, t), a = koord::bit_at(anti_req, t);
      if (!m && !a) continue;
      if (m) aff_exists[t] = 1;
      if (ctrl) continue;
      const float dom = kXchg ? dom_row[t] : __ldg(dom_row + t);
      if (!(dom >= 0.0f)) continue;
      for (int j = tid; j < nloc; j += NT) {
        if (__ldg(p.aff_dom + (size_t)(lo + j) * T + t) != dom) continue;
        if (m) cnt_v(j, t) += 1.0f;
        if (a) anti_v(j, t) += 1.0f;
      }
    }
  };

  if constexpr (kReplay) {
    // ---- the kept pods in queue order, each onto its chosen node. Every
    // thread reads the record from device memory (one line per pod,
    // cached); the owner of the node writes the zone.
    for (int v = 0; v < nv; ++v) {
      const uint32_t* rec = p.records + (size_t)v * stride;
      const int pod = (int)rec[koord::kRecPod];
      const int g = p.chosen[pod];
      if constexpr (kXchg) {
        // the owner's rows on its card; the domain row from the gather
        reserve(rec, g / per == me ? row0 + g - gbase : -1, p.zones + pod,
                p.dom_rows + (size_t)pod * T);
      } else {
        reserve(rec, g, p.zones + pod, p.aff_dom + (size_t)g * T);
      }
    }
  }
  // ---- the round (the replay instance ran its pods above)
  int nred = 0;  // cluster reductions passed, the same count in every thread
  int nx = 0;    // exchanges passed (kXchg), the same count in every thread
  // the last pod whose record load was issued, and the pod a failed
  // exchange stopped at (-1: none)
  int issued = min(S - 1, nv) - 1, stopped = -1;
  for (int v = 0; v < (kReplay ? 0 : nv); ++v) {
    const int st = v % S;
    koord::mbar_wait(&bar[st], (v / S) & 1);
    KOORD_STAMP(v, 0)  // the record is in
    const uint32_t* rec = ring + st * stride;
    const koord::FilterPod pod = koord::filter_pod(rec, lay);
    const uint32_t pf = pod.flags;
    const bool is_prod = pod.is_prod;
    const int qid = (int)rec[kRecQuota], pid = (int)rec[kRecPref];
    const int sid2 = (int)rec[kRecPpref], iid = (int)rec[kRecImg];
    const float* fit_req = pod.fit_req;
    const float* rq = pod.rq;
    const float* est = reinterpret_cast<const float*>(rec + p.off_est);
    const float* skew = pod.skew;

    bool any_spread = false;
    for (int t = 0; t < T; ++t) any_spread |= skew[t] > 0.0f;
    const bool ppref = ppref_on && sid2 >= 0;
    const bool reduce = any_spread || ppref;

    // ---- PreFilter beside the node loop: the control warp checks the
    // quota chain against its block's copy of the usage
    if (ctrl) {
      bool viol = false;
      if (qid >= 0) {
        for (int e = lane; e < D * R; e += 32) {
          const int d = e / R, r = e - d * R;
          const int g = anc[qid * D + d];
          if (g < 0) continue;
          const float q = rq[r];
          if (q > 0.0f &&
              !(__fadd_rn(quota[g * R + r], q) <= runtime[g * R + r]))
            viol = true;
        }
      }
      viol = __any_sync(koord::kFullMask, viol);
      if (lane == 0)
        s_admit[v & 1] = ((pf & koord::kPodGangOk) != 0) && !viol;
    }

    // ---- spread minima (over the domains the pod is eligible for) and
    // preferred pod-affinity max/min (over node_ok nodes): one cluster
    // reduction, only for a pod that has them
    const float* wred = warp_red + warp * Q;
    const float* w_row =
        ppref ? p.ppref_w + (size_t)sid2 * p.ppref_stride : nullptr;
    if (reduce) {
      float* part = part_red + (nred & 1) * Q * NW;
      if (!ctrl) {
        for (int t = 0; t < T; ++t) {
          float m = skew[t] > 0.0f
                        ? koord::spread_min_part(pod, t, lo, tid, nloc, NT,
                                                 T, cnt_v, gn)
                        : CUDART_INF_F;
          m = koord::warp_min(m);
          if (lane == 0) part[t * NW + warp] = m;
        }
        float pmx = -CUDART_INF_F, pmn = CUDART_INF_F;
        if (ppref) {
          for (int j = tid; j < nloc; j += NT) {
            if (!(nflags[j] & koord::kNodeOk)) continue;
            float raw = 0.0f;
            for (int t = 0; t < T; ++t)
              raw = __fadd_rn(raw, __fmul_rn(cnt_v(j, t), w_row[t]));
            pmx = fmaxf(pmx, raw);
            pmn = fminf(pmn, raw);
          }
        }
        pmx = koord::warp_max(pmx);
        pmn = koord::warp_min(pmn);
        if (lane == 0) {
          part[T * NW + warp] = pmx;
          part[(T + 1) * NW + warp] = pmn;
        }
      }
      cluster.sync();
      ++nred;
      for (int q = 0; q < Q; ++q) {
        const float x = koord::cluster_extreme(cluster, part + q * NW, NW, C,
                                               q == T);
        if (lane == 0) warp_red[warp * Q + q] = x;
      }
      __syncwarp();
      if constexpr (kXchg) {
        // ---- the extremes over every shard: publish the cluster's, merge
        // every shard's (min, the ppref max a max), push the result
        const int par = nx & 1;
        const unsigned long long seq = p.x.seq0 + (unsigned long long)nx;
        uint32_t* res = xres + par * XW;
        const int words = (1 + Q + 1) & ~1;
        if (ctrl && rank == 0) {
          // lane d publishes into shard d's mailbox
          if (lane < p.x.D) {
            const uint32_t* ext =
                reinterpret_cast<const uint32_t*>(warp_red + NW * Q);
            volatile uint32_t* pl = koord::xpayload(p.x, lane, par, me);
            for (int q = 0; q < Q; ++q) pl[q] = ext[q];
            koord::fence_sys();
            koord::st_relaxed_sys(koord::xentry(p.x, lane, par, me), seq);
          }
          const unsigned missing = koord::xwait(p.x, me, par, seq);
          for (int q = 0; q < Q; ++q) {
            const bool take_max = q == T;
            float y = take_max ? -CUDART_INF_F : CUDART_INF_F;
            if (lane < p.x.D && missing == 0u)
              y = __uint_as_float(koord::xpayload(p.x, me, par, lane)[q]);
            y = take_max ? koord::warp_max(y) : koord::warp_min(y);
            if (lane == 0) xout[1 + q] = __float_as_uint(y);
          }
          if (lane == 0) {
            xout[0] = missing;
            if (missing) atomicOr(p.x.err, missing);
          }
          __syncwarp();
          koord::xbroadcast(xout, res, &xbar[par], words, C);
        }
        if (ctrl && lane == 0) koord::mbar_expect(&xbar[par], words * 4);
        koord::mbar_wait(&xbar[par], (nx >> 1) & 1);
        ++nx;
        if (res[0] != 0u) {
          stopped = v;
          break;
        }
        wred = reinterpret_cast<const float*>(res + 1);
      }
    }

    // ---- Filter + Score over this thread's nodes, lowest-index best.
    float best_s = -CUDART_INF_F;
    int best_n = INT32_MAX;
    // the terms instance: the best score over this thread's other nodes,
    // the terms of its best node, and node 0's terms (a pod refused at
    // PreFilter takes node 0's row)
    float run_s = -CUDART_INF_F;
    float my_la = 0.0f, my_nu = 0.0f, my_pref = 0.0f;
    float z_la = 0.0f, z_nu = 0.0f, z_pref = 0.0f;
    int my_n = INT32_MAX;
    if (!ctrl) {
      const bool use_prod = p.prod_mode && is_prod;
      for (int j = tid; j < nloc; j += NT) {
        const int n = lo + j;
        const unsigned nf = nflags[j];
        const bool ok = koord::filter_stages(pod, j, n, nf, R, K, T, p.PT,
                                             fs, gn, aff_exists, wred) == 0u;

        // LoadAware least-allocated over est + term + in-round delta
        float acc = 0.0f, acc2 = 0.0f;
        for (int jj = 0; jj < W; ++jj) {
          const int r = p.widx[jj];
          const float base = use_prod ? __fadd_rn(tpr_v(j, jj), dpr_v(j, jj))
                                      : __fadd_rn(tnp_v(j, jj), dnp_v(j, jj));
          const float used = __fadd_rn(est[r], base);
          const float cap = alloc_v(j, r);
          const float w = __ldg(p.weights + r);
          acc = __fadd_rn(acc, __fmul_rn(w, koord::least_requested(used, cap)));
          // NodeNUMAResource least-allocated over requested + request
          const float used2 = __fadd_rn(req_v(j, r), rq[r]);
          acc2 = __fadd_rn(acc2,
                           __fmul_rn(w, koord::least_requested(used2, cap)));
        }
        const float la = (nf & koord::kNodeScoreValid)
                             ? floorf(__fdiv_rn(acc, wdiv))
                             : 0.0f;
        float nu = floorf(__fdiv_rn(acc2, wdiv));
        // NodeResourcesBalancedAllocation: |f_cpu - f_mem| / 2
        if (p.bal_c >= 0) {
          const int c = p.bal_c, mm = p.bal_m;
          const float fc = fminf(
              __fmul_rn(__fadd_rn(req_v(j, c), fit_req[c]),
                        koord::safe_reciprocal(alloc_v(j, c))), 1.0f);
          const float fm = fminf(
              __fmul_rn(__fadd_rn(req_v(j, mm), fit_req[mm]),
                        koord::safe_reciprocal(alloc_v(j, mm))), 1.0f);
          const float std_ = __fmul_rn(fabsf(__fsub_rn(fc, fm)), 0.5f);
          nu = __fadd_rn(nu, floorf(__fmul_rn(__fsub_rn(1.0f, std_), 100.0f)));
        }
        float pref = 0.0f;
        if (p.S > 0 && pid >= 0)
          pref = __ldg(p.pref_scores + (size_t)n * p.S + pid);
        if (ppref) {
          float raw = 0.0f;
          for (int t = 0; t < T; ++t)
            raw = __fadd_rn(raw, __fmul_rn(cnt_v(j, t), w_row[t]));
          const float pmx = wred[T], pmn = wred[T + 1];
          const float norm =
              pmx > pmn
                  ? floorf(__fdiv_rn(__fmul_rn(__fsub_rn(raw, pmn), 100.0f),
                                     __fsub_rn(pmx, pmn)))
                  : 0.0f;
          pref = __fadd_rn(pref, norm);
        }
        if (p.SI > 0 && iid >= 0)
          pref = __fadd_rn(pref, __ldg(p.img_scores + (size_t)n * p.SI + iid));
        const float score = ok ? __fadd_rn(__fadd_rn(la, nu), pref) : -1.0f;
        // n ascends, so a strict compare keeps the lowest index on ties
        if constexpr (kTerms) {
          if (score > best_s) {
            run_s = fmaxf(run_s, best_s);
            best_s = score;
            best_n = n;
            my_la = la, my_nu = nu, my_pref = pref;
          } else {
            run_s = fmaxf(run_s, score);
          }
          if (n == row0) z_la = la, z_nu = nu, z_pref = pref;
        } else if (score > best_s) {
          best_s = score;
          best_n = n;
        }
      }
      KOORD_STAMP(v, 1)  // node loop done
      my_n = best_n;
      const float my_s = best_s;
      koord::warp_argmax(best_s, best_n);
      if constexpr (kTerms) {
        // the warp's runner-up: the winner lane's own runner-up, every
        // other lane's best
        run_s = koord::warp_max(my_n == best_n ? run_s : my_s);
        if (lane == 0) part_wrun[(v & 1) * NW + warp] = run_s;
      }
      if (lane == 0)
        part_warp[(v & 1) * NW + warp] = koord::pack_best(best_s, best_n);
      koord::named_arrive(NT + 32);
      KOORD_STAMP(v, 2)  // warp's best published
    } else {
      // ---- the block's best, pushed into slot [rank] of every block
      koord::named_wait(NT + 32);
      koord::warp_argmax_of(part_warp + (v & 1) * NW, NW, best_s, best_n);
      float blk_run = -CUDART_INF_F;
      if constexpr (kTerms) {
        const int2 wb = lane < NW
                            ? part_warp[(v & 1) * NW + lane]
                            : koord::pack_best(-CUDART_INF_F, INT32_MAX);
        const float wr =
            lane < NW ? part_wrun[(v & 1) * NW + lane] : -CUDART_INF_F;
        blk_run = koord::warp_max(wb.y == best_n ? wr : __int_as_float(wb.x));
      }
      if (lane == 0)
        koord::mbar_expect(&merge_bar[v & 1], C * 8 * (kTerms ? 2 : 1));
      if (lane < C) {
        koord::push_pair(part_blk + (v & 1) * C + rank, &merge_bar[v & 1],
                         lane, koord::pack_best(best_s, best_n));
        if constexpr (kTerms)
          koord::push_pair(part_brun + (v & 1) * C + rank, &merge_bar[v & 1],
                           lane, make_int2(__float_as_int(blk_run), 0));
      }
      // Every node warp has finished this pod's node loop, so none still
      // reads pod v - 1's stage: refill it with pod v + S - 1.
      const int nxt = v + S - 1;
      if (nxt < nv) issued = nxt;
      if (lane == 0 && nxt < nv)
        koord::bulk_load(ring + (nxt % S) * stride,
                         p.records + (size_t)nxt * stride, stride * 4,
                         &bar[nxt % S]);
    }

    // ---- Select: every warp merges the C blocks' bests; the pod-level
    // verdict (gang, quota) applies to the winner
    koord::mbar_wait(&merge_bar[v & 1], (v >> 1) & 1);
    KOORD_STAMP(v, 3)  // every block's best is in
    koord::warp_argmax_of(part_blk + (v & 1) * C, C, best_s, best_n);
    const bool admit = s_admit[v & 1];
    // the cluster's runner-up: the winning block's own, every other
    // block's best
    float runner = -CUDART_INF_F;
    if constexpr (kTerms) {
      const int2 bb = lane < C ? part_blk[(v & 1) * C + lane]
                               : koord::pack_best(-CUDART_INF_F, INT32_MAX);
      const float br =
          lane < C ? __int_as_float(part_brun[(v & 1) * C + lane].x)
                   : -CUDART_INF_F;
      runner = koord::warp_max(bb.y == best_n ? br : __int_as_float(bb.x));
    }
    // the winner's global index, and its aff_dom row
    int gwin = best_n;
    const float* dom_row = p.aff_dom + (size_t)best_n * T;
    float x_la = 0.0f, x_nu = 0.0f, x_pref = 0.0f;
    if constexpr (kXchg) {
      // ---- the winner over every shard. The owner of the cluster's best
      // publishes it (the terms instance: for a pod refused at PreFilter
      // the owner of the shard's first node, whose terms the row takes)
      const int par = nx & 1;
      const unsigned long long seq = p.x.seq0 + (unsigned long long)nx;
      uint32_t* res = xres + par * XW;
      const int pub = (kTerms && !admit) ? row0 : best_n;
      const int jp = pub - lo;
      if (!ctrl && jp >= 0 && jp < nloc && jp % NT == tid) {
        const bool mine = my_n == pub;
        for (int d = 0; d < p.x.D; ++d) {
          volatile uint32_t* pl = koord::xpayload(p.x, d, par, me);
          pl[0] = __float_as_uint(best_s);
          pl[1] = (uint32_t)(gbase + best_n - row0);
          pl[2] = __float_as_uint(runner);
          pl[3] = __float_as_uint(mine ? my_la : z_la);
          pl[4] = __float_as_uint(mine ? my_nu : z_nu);
          pl[5] = __float_as_uint(mine ? my_pref : z_pref);
          for (int t = 0; t < T; ++t)
            pl[kWinHead + t] =
                __float_as_uint(__ldg(p.aff_dom + (size_t)pub * T + t));
        }
        koord::fence_sys();
        for (int d = 0; d < p.x.D; ++d)
          koord::st_relaxed_sys(koord::xentry(p.x, d, par, me), seq);
      }
      if (ctrl && rank == 0) {
        const unsigned missing = koord::xwait(p.x, me, par, seq);
        const bool in = lane < p.x.D && missing == 0u;
        volatile uint32_t* pl = koord::xpayload(p.x, me, par, in ? lane : 0);
        float ws = in ? __uint_as_float(pl[0]) : -CUDART_INF_F;
        int wn = in ? (int)pl[1] : INT32_MAX;
        const float es = ws;
        const int en = wn;
        koord::warp_argmax(ws, wn);
        const float er = in ? __uint_as_float(pl[2]) : -CUDART_INF_F;
        const float xr = koord::warp_max(en == wn ? er : es);
        // the entry the result's terms and aff_dom row come from
        const unsigned at = __ballot_sync(koord::kFullMask, in && en == wn);
        const int wl = at ? __ffs(at) - 1 : 0;
        const int tl = (kTerms && !admit) ? 0 : wl;
        volatile uint32_t* tp = koord::xpayload(p.x, me, par, tl);
        volatile uint32_t* dp = koord::xpayload(p.x, me, par, wl);
        if (lane == 0) {
          xout[0] = missing;
          xout[1] = (uint32_t)wn;
          xout[2] = __float_as_uint(ws);
          xout[3] = __float_as_uint(xr);
          xout[7] = 0u;
          if (missing) atomicOr(p.x.err, missing);
        }
        if (lane < 3)
          xout[4 + lane] = (kTerms && !missing) ? tp[3 + lane] : 0u;
        for (int t = lane; t < T; t += 32)
          xout[kResHead + t] = missing ? 0u : dp[kWinHead + t];
        if (lane == 0 && ((kResHead + T) & 1)) xout[kResHead + T] = 0u;
        __syncwarp();
        koord::xbroadcast(xout, res, &xbar[par], XW, C);
      }
      if (ctrl && lane == 0) koord::mbar_expect(&xbar[par], XW * 4);
      koord::mbar_wait(&xbar[par], (nx >> 1) & 1);
      ++nx;
      if (res[0] != 0u) {
        stopped = v;
        break;
      }
      gwin = (int)res[1];
      best_s = __uint_as_float(res[2]);
      runner = __uint_as_float(res[3]);
      x_la = __uint_as_float(res[4]);
      x_nu = __uint_as_float(res[5]);
      x_pref = __uint_as_float(res[6]);
      dom_row = reinterpret_cast<const float*>(res + kResHead);
    }
    const bool found = admit && best_s >= 0.0f && (pf & koord::kPodValid);
    if (ctrl && lane == 0 && lead)
      p.chosen[rec[koord::kRecPod]] = found ? gwin : -1;
    if constexpr (kTerms) {
      float* row = p.terms + (size_t)rec[koord::kRecPod] * kNumTerms;
      if constexpr (kXchg) {
        if (ctrl && lane == 0 && lead) {
          row[0] = x_la;
          row[1] = x_nu;
          row[2] = x_pref;
          row[3] = admit ? best_s : -1.0f;
          row[4] = admit ? fmaxf(runner, -1.0f) : -1.0f;
        }
      } else {
        // a pod refused at PreFilter: every node scores -1 in the plain
        // round, so the row is node 0's, with best and runner-up -1
        const int tn = admit ? best_n : 0;
        const int jt = tn - lo;
        if (!ctrl && jt >= 0 && jt < nloc && jt % NT == tid) {
          const bool mine = my_n == tn;
          row[0] = mine ? my_la : z_la;
          row[1] = mine ? my_nu : z_nu;
          row[2] = mine ? my_pref : z_pref;
          row[3] = admit ? best_s : -1.0f;
          row[4] = admit ? fmaxf(runner, -1.0f) : -1.0f;
        }
      }
    }
    KOORD_STAMP(v, 4)  // merged
    if (!found) continue;

    // the owner's rows where this shard holds the winner
    const int own =
        kXchg ? (gwin / per == me ? row0 + gwin - gbase : -1) : gwin;
    reserve(rec, own, nullptr, dom_row);
    KOORD_STAMP(v, 5)  // reserved
  }
  // A failed exchange left the loop: no block leaves while a record it
  // asked for is still being copied into its shared memory.
  if (kXchg && stopped >= 0 && ctrl && lane == 0)
    for (int u = stopped + 1; u <= issued; ++u)
      koord::mbar_wait(&bar[u % S], (u / S) & 1);

  // No block leaves while a peer may still read its shared memory.
  cluster.sync();
  if constexpr (kStateInSmem) {
    koord::copy_view(g_req, req_v, nloc, R);
    koord::copy_view(g_dnp, dnp_v, nloc, W);
    koord::copy_view(g_dpr, dpr_v, nloc, W);
    koord::copy_view(g_numa, numa_v, nloc, K * R);
    koord::copy_view(g_bind, bind_v, nloc, 1);
    koord::copy_view(g_vol, vol_v, nloc, 1);
    koord::copy_view(g_port, port_v, nloc, p.PT);
    koord::copy_view(g_cnt, cnt_v, nloc, T);
    koord::copy_view(g_anti, anti_v, nloc, T);
    float* out = p.quota_blocks + (size_t)(l * C + rank) * G * R;
    for (int e = tid; e < G * R; e += blockDim.x) out[e] = quota[e];
  }
  if (lead)
    for (int t = tid; t < T; t += blockDim.x)
      p.aff_exists_out[t] = aff_exists[t] ? 1 : 0;
}

KOORD_TRACE_COPY(full_chain_trace_copy)

namespace {

// The instance specialised for the common shape (the active-axis reduction
// of most batches: cpu, memory and pods; two NUMA zones; cpu and memory
// weighted, or every axis for the replay).
bool common_instance(const FullChainParams& p) {
  return p.R == 3 && p.K == 2 && p.n_widx == (p.replay ? 3 : 2);
}

template <bool kReplay, bool kTerms, bool kXchg, bool kSmem, bool kCommon>
int launch_one(const FullChainParams& p, void* stream, bool query) {
  constexpr int kCommonW = kReplay ? 3 : 2;
  auto kernel =
      kCommon ? full_chain_kernel<kSmem, 3, 2, kCommonW, kReplay, kTerms, kXchg>
              : full_chain_kernel<kSmem, 0, 0, 0, kReplay, kTerms, kXchg>;
  const size_t smem = fc_smem_layout(p).total;
  const int threads = p.node_threads + 32, C = p.cluster_size;
  if (query) return koord::max_clusters(kernel, C, threads, smem);
  return koord::launch_cluster(kernel, p, C, threads, smem, stream,
                               kXchg ? p.x.L : 1);
}

template <bool kReplay, bool kTerms, bool kXchg>
int launch_mode(const FullChainParams& p, void* stream, bool query) {
  if (p.state_in_smem)
    return common_instance(p)
               ? launch_one<kReplay, kTerms, kXchg, true, true>(p, stream, query)
               : launch_one<kReplay, kTerms, kXchg, true, false>(p, stream,
                                                                 query);
  return common_instance(p)
             ? launch_one<kReplay, kTerms, kXchg, false, true>(p, stream, query)
             : launch_one<kReplay, kTerms, kXchg, false, false>(p, stream,
                                                                query);
}

template <bool kXchg>
int launch_kind(const FullChainParams& p, void* stream, bool query) {
  if (p.replay) return launch_mode<true, false, kXchg>(p, stream, query);
  return p.terms != nullptr ? launch_mode<false, true, kXchg>(p, stream, query)
                            : launch_mode<false, false, kXchg>(p, stream,
                                                               query);
}

int launch_any(const FullChainParams& p, void* stream, bool query) {
  return p.x.L > 0 ? launch_kind<true>(p, stream, query)
                   : launch_kind<false>(p, stream, query);
}

}  // namespace

extern "C" {

int full_chain_params_size() { return (int)sizeof(FullChainParams); }

// Bytes of dynamic shared memory one block of this launch takes.
long long full_chain_smem_bytes(const FullChainParams* params) {
  return (long long)fc_smem_layout(*params).total;
}

// 1 where a launch takes the instance specialised for the common shape, 0
// for the generic instance.
int full_chain_instance(const FullChainParams* params) {
  return common_instance(*params);
}

// 32-bit payload words of one mailbox entry for T affinity terms (the
// winner's; the stats entry's T + 2 is never longer).
int full_chain_payload_words(int T) { return kWinHead + T; }

// Clusters of this launch's instance the current device holds at once
// (negative: a cudaError_t).
int full_chain_max_clusters(const FullChainParams* params) {
  return launch_any(*params, nullptr, true);
}

// Launches one round (with `terms` set, the terms instance; with `replay`,
// one kept-only replay; with x.L > 0, the instance over a mesh of cards, as
// x.L clusters) on `stream` on the current device; returns a cudaError_t
// (0 = launched).
int full_chain_launch(const FullChainParams* params, void* stream) {
  return launch_any(*params, stream, false);
}

// Peer access from the current device to device `peer` (0 or a
// cudaError_t; on already counts as 0).
int koord_enable_peer(int peer) { return koord::enable_peer(peer); }

}  // extern "C"
