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

#include <cooperative_groups.h>

#include "kernel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWeights = 16;
constexpr int kPolicyNone = 0;        // ops/numa.py POLICY_NONE
constexpr int kPolicySingleNuma = 1;  // ops/numa.py POLICY_SINGLE_NUMA_NODE
// pod record words after the common header (ops/full_chain_kernel.py)
constexpr int kRecCores = 2;   // f32
constexpr int kRecTaint = 3;   // f32 admission bitmask (exact integer)
constexpr int kRecQuota = 4;   // i32, -1 none
constexpr int kRecPref = 5;    // i32
constexpr int kRecPpref = 6;   // i32
constexpr int kRecImg = 7;     // i32

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
  float* delta_np;           // [N, W]
  float* delta_pr;           // [N, W]
  float* numa;               // [N, K, R]
  float* bind_free;          // [N]
  float* vol_free;           // [N]
  float* port_used;          // [N, PT]
  float* aff_count;          // [N, T]
  float* anti_cover;         // [N, T]
  float* quota_blocks;       // [C, G, R] block copies; block 0's is output
  int32_t* chosen;           // [P] (output, before Permit; -1 preset)
  // ---- sizes and static switches
  int P, N, R, K, G, D, T, S, S2, ppref_stride, PT, SI, VG;
  int prod_mode, bal_c, bal_m, n_widx;
  // ---- pod record layout (word offsets)
  int rec_stride, off_fit, off_req, off_est, off_aff, off_anti, off_match,
      off_skew, off_ports, off_vol;
  // ---- cluster plan
  int cluster_size, nodes_per_block, node_threads, state_in_smem;
  int widx[kMaxWeights];
};

// Dynamic shared memory of one block (ops/full_chain_kernel.py
// estimate_smem_bytes mirrors it).
struct FcSmem {
  size_t bar, ring, part_warp, part_blk, part_red, warp_red, admit, exists;
  size_t quota, runtime, anc, node, flags, total;
};

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

// NUMA admission of local node j: (ok, zone) as ops/numa.numa_admit_row;
// zone is -1 unless the node's policy pins a single zone.
__device__ __forceinline__ bool numa_admit(const koord::View& nf, int j,
                                           int R, int K, const float* rq,
                                           int pol, int& zone) {
  int first = -1;
  for (int k = K - 1; k >= 0; --k) {  // every zone's loads issue at once
    bool fits = true;
    for (int r = 0; r < R; ++r) {
      const float q = rq[r];
      fits &= (q <= 0.0f) | (q <= nf(j, k * R + r));
    }
    if (fits) first = k;  // lowest fitting zone wins
  }
  const bool single = pol == kPolicySingleNuma;
  zone = (single && first >= 0) ? first : -1;
  if (pol == kPolicyNone) return true;
  if (single) return first >= 0;
  bool fits_total = true;
  for (int r = 0; r < R; ++r) {
    float total = nf(j, r);  // ascending zone order, as ops/numa.zone_total
    for (int k = 1; k < K; ++k) total = __fadd_rn(total, nf(j, k * R + r));
    const float q = rq[r];
    fits_total &= (q <= 0.0f) | (q <= total);
  }
  return fits_total;
}

// kR, kK, kW > 0 fix R, K and the weighted-axis count at compile time, so
// the node loop's short loops unroll completely; 0 reads them from `p`.
template <bool kStateInSmem, int kR, int kK, int kW>
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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = p.node_threads, NW = NT >> 5;
  const bool ctrl = warp == NW;  // the control warp owns no node
  const int C = p.cluster_size, rank = (int)cluster.block_rank();
  const int Nb = p.nodes_per_block;
  const int lo = min(rank * Nb, p.N), nloc = min(lo + Nb, p.N) - lo;
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
    quota = p.quota_blocks + (size_t)rank * G * R;
    runtime = p.runtime;
    anc = p.anc;
  }
  for (int e = tid; e < G * R; e += blockDim.x) quota[e] = p.quota_init[e];
  for (int t = tid; t < T; t += blockDim.x) aff_exists[t] = p.aff_exists0[t];

  const int nv = *p.n_valid;
  if (ctrl && lane == 0) {
    for (int s = 0; s < S + 2; ++s) koord::mbar_init(&bar[s], 1);
    koord::fence_mbar_init();
    for (int v = 0; v < S - 1 && v < nv; ++v)
      koord::bulk_load(ring + v * stride, p.records + (size_t)v * stride,
                       stride * 4, &bar[v]);
  }
  float wsum = 0.0f;  // integer weights: any order is exact
  for (int r = 0; r < R; ++r) wsum = __fadd_rn(wsum, p.weights[r]);
  const float wdiv = fmaxf(wsum, 1.0f);
  const bool ppref_on = T > 0 && p.S2 > 0;
  // every block has started and initialised its shared memory
  cluster.sync();

  int nred = 0;  // cluster reductions passed, the same count in every thread
  for (int v = 0; v < nv; ++v) {
    const int st = v % S;
    koord::mbar_wait(&bar[st], (v / S) & 1);
    KOORD_STAMP(v, 0)  // the record is in
    const uint32_t* rec = ring + st * stride;
    const uint32_t pf = rec[koord::kRecFlags];
    const bool is_prod = pf & koord::kPodProd, is_ds = pf & koord::kPodDs;
    const bool needs_numa = pf & koord::kPodNuma;
    const bool needs_bind = pf & koord::kPodBind;
    const bool full_pcpus = pf & koord::kPodFullPcpus;
    const float cores = __uint_as_float(rec[kRecCores]);
    const int tmask = (int)__uint_as_float(rec[kRecTaint]);
    const int qid = (int)rec[kRecQuota], pid = (int)rec[kRecPref];
    const int sid2 = (int)rec[kRecPpref], iid = (int)rec[kRecImg];
    const float* fit_req = reinterpret_cast<const float*>(rec + p.off_fit);
    const float* rq = reinterpret_cast<const float*>(rec + p.off_req);
    const float* est = reinterpret_cast<const float*>(rec + p.off_est);
    const uint32_t* aff_req = rec + p.off_aff;
    const uint32_t* anti_req = rec + p.off_anti;
    const uint32_t* match = rec + p.off_match;
    const float* skew = reinterpret_cast<const float*>(rec + p.off_skew);
    const uint32_t* wants = rec + p.off_ports;
    const float* vneed = reinterpret_cast<const float*>(rec + p.off_vol);

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
          float m = CUDART_INF_F;
          if (skew[t] > 0.0f) {
            for (int j = tid; j < nloc; j += NT) {
              const int n = lo + j;
              const bool taint_ok =
                  ((tmask >> __ldg(p.taint_group + n)) & 1) == 1;
              if (__ldg(p.aff_dom + (size_t)n * T + t) >= 0.0f && taint_ok)
                m = fminf(m, cnt_v(j, t));
            }
          }
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
    }

    // ---- Filter + Score over this thread's nodes, lowest-index best.
    // Predicates combine with non-short-circuit & so that a node's loads
    // issue together.
    float best_s = -CUDART_INF_F;
    int best_n = INT32_MAX;
    if (!ctrl) {
      const bool use_prod = p.prod_mode && is_prod;
      for (int j = tid; j < nloc; j += NT) {
        const int n = lo + j;
        const unsigned nf = nflags[j];
        bool ok = (nf & koord::kNodeOk) != 0;
        // Fit
        for (int r = 0; r < R; ++r) {
          const float need = fit_req[r];
          ok &= (need <= 0.0f) |
                (__fadd_rn(req_v(j, r), need) <= alloc_v(j, r));
        }
        // LoadAware thresholds (daemonsets bypass)
        ok &= is_ds | ((nf & (is_prod ? koord::kNodeRejectPr
                                      : koord::kNodeRejectNp)) == 0);
        // cpuset capacity + SMT alignment. fmodf truncates where
        // torch.remainder floors; they differ only for negative operands,
        // and cores and cpus-per-core are both positive here.
        if (needs_bind) {
          const float cpc = fmaxf(__ldg(p.cpc + n), 1.0f);
          const bool smt_ok =
              !full_pcpus | (fabsf(fmodf(cores, cpc)) < 0.5f);
          ok &= ((nf & koord::kNodeHasTopo) != 0) & smt_ok &
                (cores <= bind_v(j, 0));
        }
        // NUMA topology admit
        if (needs_numa) {
          int zone;
          ok &= numa_admit(numa_v, j, R, K, rq, __ldg(p.policy + n), zone);
        }
        // TaintToleration: bit test of the admission mask
        ok &= ((tmask >> __ldg(p.taint_group + n)) & 1) == 1;
        // InterPodAffinity, symmetric anti-affinity, PodTopologySpread
        for (int t = 0; t < T; ++t) {
          const float cnt = cnt_v(j, t);
          const bool dom_valid = __ldg(p.aff_dom + (size_t)n * T + t) >= 0.0f;
          const bool m = koord::bit_at(match, t);
          ok &= !koord::bit_at(anti_req, t) | (cnt <= 0.0f);
          ok &= !m | (anti_v(j, t) <= 0.0f);
          const bool boot = m & !aff_exists[t];
          ok &= !koord::bit_at(aff_req, t) | (dom_valid & (cnt > 0.0f)) | boot;
          if (skew[t] > 0.0f) {
            const float lhs =
                __fsub_rn(__fadd_rn(cnt, m ? 1.0f : 0.0f), wred[t]);
            ok &= dom_valid & (lhs <= skew[t]);
          }
        }
        // NodePorts
        for (int s = 0; s < p.PT; ++s)
          ok &= !koord::bit_at(wants, s) | (port_v(j, s) <= 0.0f);
        // NodeVolumeLimits per volume group
        const float vn = vneed[__ldg(p.vol_group + n)];
        ok &= (vn <= 0.0f) | (vol_v(j, 0) >= vn);

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
        if (score > best_s) {
          best_s = score;
          best_n = n;
        }
      }
      KOORD_STAMP(v, 1)  // node loop done
      koord::warp_argmax(best_s, best_n);
      if (lane == 0)
        part_warp[(v & 1) * NW + warp] = koord::pack_best(best_s, best_n);
      koord::named_arrive(NT + 32);
      KOORD_STAMP(v, 2)  // warp's best published
    } else {
      // ---- the block's best, pushed into slot [rank] of every block
      koord::named_wait(NT + 32);
      koord::warp_argmax_of(part_warp + (v & 1) * NW, NW, best_s, best_n);
      if (lane == 0) koord::mbar_expect(&merge_bar[v & 1], C * 8);
      if (lane < C)
        koord::push_pair(part_blk + (v & 1) * C + rank, &merge_bar[v & 1],
                         lane, koord::pack_best(best_s, best_n));
      // Every node warp has finished this pod's node loop, so none still
      // reads pod v - 1's stage: refill it with pod v + S - 1.
      const int nxt = v + S - 1;
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
    const bool found =
        s_admit[v & 1] && best_s >= 0.0f && (pf & koord::kPodValid);
    if (ctrl && lane == 0 && rank == 0)
      p.chosen[rec[koord::kRecPod]] = found ? best_n : -1;
    KOORD_STAMP(v, 4)  // merged
    if (!found) continue;

    // ---- Reserve: the owner of the chosen node updates its rows
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
        int zone;
        numa_admit(numa_v, jb, R, K, rq, __ldg(p.policy + best_n), zone);
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
      const float dom = __ldg(p.aff_dom + (size_t)best_n * T + t);
      if (!(dom >= 0.0f)) continue;
      for (int j = tid; j < nloc; j += NT) {
        if (__ldg(p.aff_dom + (size_t)(lo + j) * T + t) != dom) continue;
        if (m) cnt_v(j, t) += 1.0f;
        if (a) anti_v(j, t) += 1.0f;
      }
    }
    KOORD_STAMP(v, 5)  // reserved
  }

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
    float* out = p.quota_blocks + (size_t)rank * G * R;
    for (int e = tid; e < G * R; e += blockDim.x) out[e] = quota[e];
  }
}

KOORD_TRACE_COPY(full_chain_trace_copy)

extern "C" {

int full_chain_params_size() { return (int)sizeof(FullChainParams); }

// Bytes of dynamic shared memory one block of this launch takes.
long long full_chain_smem_bytes(const FullChainParams* params) {
  return (long long)fc_smem_layout(*params).total;
}

// 1 where a launch takes the instance specialised for the common shape
// (the active-axis reduction of most batches: cpu, memory and pods; two
// NUMA zones; cpu and memory weighted), 0 for the generic instance.
int full_chain_instance(const FullChainParams* params) {
  return params->R == 3 && params->K == 2 && params->n_widx == 2;
}

// Launches one round on `stream` as one cluster; returns a cudaError_t
// (0 = launched).
int full_chain_launch(const FullChainParams* params, void* stream) {
  const FullChainParams& p = *params;
  const size_t smem = fc_smem_layout(p).total;
  const int threads = p.node_threads + 32, C = p.cluster_size;
  const bool common = full_chain_instance(params);
  if (p.state_in_smem)
    return common ? koord::launch_cluster(full_chain_kernel<true, 3, 2, 2>,
                                          p, C, threads, smem, stream)
                  : koord::launch_cluster(full_chain_kernel<true, 0, 0, 0>,
                                          p, C, threads, smem, stream);
  return common ? koord::launch_cluster(full_chain_kernel<false, 3, 2, 2>, p,
                                        C, threads, smem, stream)
                : koord::launch_cluster(full_chain_kernel<false, 0, 0, 0>, p,
                                        C, threads, smem, stream);
}

}  // extern "C"
