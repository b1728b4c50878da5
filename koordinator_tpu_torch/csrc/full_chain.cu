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
// every pod needs a block-wide argmax over all N nodes before the next pod
// can start. Over the whole card the work is small (N x ~70 f32 operations
// per pod), so neither the card's bytes nor its operations bound it; what
// does is the per-pod chain run on ONE SM: the Filter/Score instructions of
// all N nodes issued by one SM's four schedulers, then the block
// reductions and their barriers, P times over.
//
// The design answers that as simply as it can: one thread block of 1024
// threads runs the whole pod loop (the loop takes the place of the TPU's
// sequential grid). Thread t owns nodes n = t (mod blockDim.x) and keeps
// their carried state in device-memory scratch (a few [N, R] rows, small
// enough to stay in L2); only the owner of a node ever reads or writes that
// node's state row, so the only cross-thread traffic per pod is the
// quota verdict (__syncthreads_or), the spread minima and preferred
// pod-affinity max/min (block reductions), the argmax, and the affinity
// exists flags in shared memory. Spreading N over a thread-block cluster or
// a persistent multi-block design, so that more SMs share the per-pod
// work, is later work.

#include "kernel_common.cuh"

namespace {

constexpr int kMaxWeights = 16;
constexpr int kPolicyNone = 0;        // ops/numa.py POLICY_NONE
constexpr int kPolicySingleNuma = 1;  // ops/numa.py POLICY_SINGLE_NUMA_NODE

}  // namespace

// Field order is mirrored by ops/full_chain_kernel.py (_Params); the
// wrapper checks sizeof through full_chain_params_size().
struct FullChainParams {
  // ---- pods
  const float* fit_req;      // [P, R] requests, pods axis = 1
  const float* req;          // [P, R] raw requests (NUMA, quota)
  const float* est;          // [P, R] LoadAware estimates
  const uint8_t* is_prod;    // [P]
  const uint8_t* is_ds;      // [P]
  const uint8_t* pod_valid;  // [P]
  const uint8_t* gang_ok;    // [P] gang PreFilter validity
  const uint8_t* needs_numa;  // [P]
  const uint8_t* needs_bind;  // [P]
  const uint8_t* full_pcpus;  // [P]
  const float* cores;        // [P]
  const float* taint_mask;   // [P] admission bitmask (exact f32 integer)
  const int32_t* quota_id;   // [P] (-1 none)
  const uint8_t* aff_req;    // [P, T]
  const uint8_t* anti_req;   // [P, T]
  const uint8_t* aff_match;  // [P, T]
  const float* skew;         // [P, T]
  const int32_t* pref_id;    // [P]
  const int32_t* ppref_id;   // [P]
  const int32_t* img_id;     // [P]
  const uint8_t* port_wants;  // [P, PT]
  const float* vol_needed;   // [P, VG]
  // ---- nodes (read-only)
  const float* alloc;        // [N, R]
  const float* term_np;      // [N, R]
  const float* term_pr;      // [N, R]
  const uint8_t* node_ok;    // [N]
  const uint8_t* score_valid;  // [N]
  const uint8_t* reject_np;  // [N]
  const uint8_t* reject_pr;  // [N]
  const uint8_t* has_topo;   // [N]
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
  const uint8_t* aff_exists0;  // [T]
  // ---- carried state (initialised by the wrapper, updated in place)
  float* requested;          // [N, R] (output)
  float* delta_np;           // [N, R]
  float* delta_pr;           // [N, R]
  float* numa;               // [N, K, R]
  float* bind_free;          // [N]
  float* vol_free;           // [N]
  float* port_used;          // [N, PT]
  float* aff_count;          // [N, T]
  float* anti_cover;         // [N, T]
  float* quota_used;         // [G, R] (output)
  int32_t* chosen;           // [P] (output, before Permit)
  // ---- sizes and static switches
  int P, N, R, K, G, D, T, S, S2, ppref_stride, PT, SI, VG;
  int prod_mode, bal_c, bal_m, n_widx;
  int widx[kMaxWeights];
};

// NUMA admission of one node: (ok, zone) as ops/numa.numa_admit_row; zone
// is -1 unless the node's policy pins a single zone.
__device__ __forceinline__ bool numa_admit(const FullChainParams& p,
                                           const float* rq, const float* nf,
                                           int pol, int& zone) {
  const int R = p.R, K = p.K;
  int first = -1;
  for (int k = K - 1; k >= 0; --k) {  // every zone's loads issue at once
    bool fits = true;
    for (int r = 0; r < R; ++r) {
      const float q = rq[r];
      fits &= (q <= 0.0f) | (q <= nf[k * R + r]);
    }
    if (fits) first = k;  // lowest fitting zone wins
  }
  const bool single = pol == kPolicySingleNuma;
  zone = (single && first >= 0) ? first : -1;
  if (pol == kPolicyNone) return true;
  if (single) return first >= 0;
  bool fits_total = true;
  for (int r = 0; r < R; ++r) {
    float total = nf[r];  // ascending zone order, as ops/numa.zone_total
    for (int k = 1; k < K; ++k) total = __fadd_rn(total, nf[k * R + r]);
    const float q = rq[r];
    fits_total &= (q <= 0.0f) | (q <= total);
  }
  return fits_total;
}

__global__ void __launch_bounds__(1024, 1)
    full_chain_kernel(const FullChainParams p) {
  __shared__ float red_f[33];
  __shared__ float red_g[33];
  __shared__ int red_i[33];
  extern __shared__ float dyn[];
  float* min_count = dyn;                                  // [T]
  int* aff_exists = reinterpret_cast<int*>(dyn + p.T);     // [T]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int P = p.P, N = p.N, R = p.R, K = p.K, T = p.T, D = p.D;
  for (int t = tid; t < T; t += nthr) aff_exists[t] = p.aff_exists0[t];
  float wsum = 0.0f;  // integer weights: any order is exact
  for (int r = 0; r < R; ++r) wsum = __fadd_rn(wsum, p.weights[r]);
  const float wdiv = fmaxf(wsum, 1.0f);
  const bool ppref_on = T > 0 && p.S2 > 0;

  for (int i = 0; i < P; ++i) {
    const float* fit_req = p.fit_req + (size_t)i * R;
    const float* rq = p.req + (size_t)i * R;
    const float* est = p.est + (size_t)i * R;
    const int qid = p.quota_id[i];

    // ---- PreFilter: quota admission along the ancestor chain, read
    // against the usage every earlier pod added (thread 0 owns the quota
    // state, so reads and writes stay in one thread's program order)
    int viol = 0;
    if (tid == 0 && qid >= 0) {
      for (int d = 0; d < D; ++d) {
        const int g = p.anc[qid * D + d];
        if (g < 0) continue;
        for (int r = 0; r < R; ++r) {
          const float q = rq[r];
          if (q > 0.0f && !(__fadd_rn(p.quota_used[g * R + r], q) <=
                            p.runtime[g * R + r]))
            viol = 1;
        }
      }
    }
    // also the barrier that publishes the previous pod's aff_exists writes
    const bool quota_bad = __syncthreads_or(viol) != 0;
    const bool admit = p.gang_ok[i] && !quota_bad;

    const bool is_prod = p.is_prod[i], is_ds = p.is_ds[i];
    const bool needs_numa = p.needs_numa[i], needs_bind = p.needs_bind[i];
    const bool full_pcpus = p.full_pcpus[i];
    const float cores = p.cores[i];
    const int tmask = (int)p.taint_mask[i];
    const int pid = p.pref_id[i], sid2 = p.ppref_id[i], iid = p.img_id[i];
    const uint8_t* aff_req = p.aff_req + (size_t)i * T;
    const uint8_t* anti_req = p.anti_req + (size_t)i * T;
    const uint8_t* match = p.aff_match + (size_t)i * T;
    const float* skew = p.skew + (size_t)i * T;
    const uint8_t* wants = p.port_wants + (size_t)i * p.PT;
    const float* vneed = p.vol_needed + (size_t)i * p.VG;

    // ---- spread minima: one block-min per constrained term, over the
    // domains the pod is eligible for (valid domain + admission bit)
    bool any_spread = false;
    for (int t = 0; t < T; ++t) {
      if (!(skew[t] > 0.0f)) continue;
      any_spread = true;
      float m = CUDART_INF_F;
      for (int n = tid; n < N; n += nthr) {
        const bool taint_ok = ((tmask >> p.taint_group[n]) & 1) == 1;
        if (p.aff_dom[(size_t)n * T + t] >= 0.0f && taint_ok)
          m = fminf(m, p.aff_count[(size_t)n * T + t]);
      }
      m = koord::block_min(m, red_f, red_g);
      if (tid == 0) min_count[t] = m;
    }
    if (any_spread) __syncthreads();

    // ---- preferred pod affinity: raw = sum_t w[t] * count[n, t], max-min
    // normalised over node_ok nodes
    const bool ppref = ppref_on && sid2 >= 0;
    const float* w_row = ppref ? p.ppref_w + (size_t)sid2 * p.ppref_stride
                               : nullptr;
    float pmx = -CUDART_INF_F, pmn = CUDART_INF_F;
    if (ppref) {
      for (int n = tid; n < N; n += nthr) {
        if (!p.node_ok[n]) continue;
        float raw = 0.0f;
        for (int t = 0; t < T; ++t)
          raw = __fadd_rn(raw, __fmul_rn(p.aff_count[(size_t)n * T + t],
                                         w_row[t]));
        pmx = fmaxf(pmx, raw);
        pmn = fminf(pmn, raw);
      }
      koord::block_max_min(pmx, pmn, red_f, red_g);
    }

    // ---- Filter + Score over this thread's nodes, lowest-index best.
    // Predicates combine with non-short-circuit & and the score is computed
    // for every node, so a node's loads issue together instead of waiting
    // on each other's verdicts (short-circuit && would chain L2 latencies).
    float best_s = -CUDART_INF_F;
    int best_n = INT32_MAX;
    for (int n = tid; n < N; n += nthr) {
      const float* al = p.alloc + (size_t)n * R;
      const float* rqd = p.requested + (size_t)n * R;
      bool ok = admit & (p.node_ok[n] != 0);
      // Fit
      for (int r = 0; r < R; ++r) {
        const float need = fit_req[r];
        ok &= (need <= 0.0f) | (__fadd_rn(rqd[r], need) <= al[r]);
      }
      // LoadAware thresholds (daemonsets bypass)
      ok &= is_ds | ((is_prod ? p.reject_pr[n] : p.reject_np[n]) == 0);
      // cpuset capacity + SMT alignment. fmodf truncates where
      // torch.remainder floors; they differ only for negative operands,
      // and cores and cpus-per-core are both positive here.
      if (needs_bind) {
        const float cpc = fmaxf(p.cpc[n], 1.0f);
        const bool smt_ok = !full_pcpus | (fabsf(fmodf(cores, cpc)) < 0.5f);
        ok &= (p.has_topo[n] != 0) & smt_ok & (cores <= p.bind_free[n]);
      }
      // NUMA topology admit
      if (needs_numa) {
        int zone;
        ok &= numa_admit(p, rq, p.numa + (size_t)n * K * R, p.policy[n],
                         zone);
      }
      // TaintToleration: bit test of the admission mask
      ok &= ((tmask >> p.taint_group[n]) & 1) == 1;
      // InterPodAffinity, symmetric anti-affinity, PodTopologySpread
      for (int t = 0; t < T; ++t) {
        const float cnt = p.aff_count[(size_t)n * T + t];
        const bool dom_valid = p.aff_dom[(size_t)n * T + t] >= 0.0f;
        const bool m = match[t];
        ok &= !anti_req[t] | (cnt <= 0.0f);
        ok &= !m | (p.anti_cover[(size_t)n * T + t] <= 0.0f);
        const bool boot = m & !aff_exists[t];
        ok &= !aff_req[t] | (dom_valid & (cnt > 0.0f)) | boot;
        if (skew[t] > 0.0f) {
          const float lhs =
              __fsub_rn(__fadd_rn(cnt, m ? 1.0f : 0.0f), min_count[t]);
          ok &= dom_valid & (lhs <= skew[t]);
        }
      }
      // NodePorts
      for (int s = 0; s < p.PT; ++s)
        ok &= !wants[s] | (p.port_used[(size_t)n * p.PT + s] <= 0.0f);
      // NodeVolumeLimits per volume group
      const float vn = vneed[p.vol_group[n]];
      ok &= (vn <= 0.0f) | (p.vol_free[n] >= vn);

      // LoadAware least-allocated over est + term + in-round delta
      const float* tn = p.term_np + (size_t)n * R;
      const float* dn = p.delta_np + (size_t)n * R;
      const bool use_prod = p.prod_mode && is_prod;
      const float* tp = p.term_pr + (size_t)n * R;
      const float* dp = p.delta_pr + (size_t)n * R;
      float acc = 0.0f, acc2 = 0.0f;
      for (int j = 0; j < p.n_widx; ++j) {
        const int r = p.widx[j];
        const float base =
            use_prod ? __fadd_rn(tp[r], dp[r]) : __fadd_rn(tn[r], dn[r]);
        const float used = __fadd_rn(est[r], base);
        acc = __fadd_rn(acc, __fmul_rn(p.weights[r],
                                       koord::least_requested(used, al[r])));
        // NodeNUMAResource least-allocated over requested + request
        const float used2 = __fadd_rn(rqd[r], rq[r]);
        acc2 = __fadd_rn(acc2, __fmul_rn(p.weights[r],
                                         koord::least_requested(used2, al[r])));
      }
      const float la = p.score_valid[n] ? floorf(__fdiv_rn(acc, wdiv)) : 0.0f;
      float nu = floorf(__fdiv_rn(acc2, wdiv));
      // NodeResourcesBalancedAllocation: |f_cpu - f_mem| / 2
      if (p.bal_c >= 0) {
        const int c = p.bal_c, m = p.bal_m;
        const float fc = fminf(
            __fmul_rn(__fadd_rn(rqd[c], fit_req[c]),
                      koord::safe_reciprocal(al[c])), 1.0f);
        const float fm = fminf(
            __fmul_rn(__fadd_rn(rqd[m], fit_req[m]),
                      koord::safe_reciprocal(al[m])), 1.0f);
        const float std_ = __fmul_rn(fabsf(__fsub_rn(fc, fm)), 0.5f);
        nu = __fadd_rn(nu, floorf(__fmul_rn(__fsub_rn(1.0f, std_), 100.0f)));
      }
      float pref = 0.0f;
      if (p.S > 0 && pid >= 0) pref = p.pref_scores[(size_t)n * p.S + pid];
      if (ppref) {
        float raw = 0.0f;
        for (int t = 0; t < T; ++t)
          raw = __fadd_rn(raw, __fmul_rn(p.aff_count[(size_t)n * T + t],
                                         w_row[t]));
        const float norm =
            pmx > pmn
                ? floorf(__fdiv_rn(__fmul_rn(__fsub_rn(raw, pmn), 100.0f),
                                   __fsub_rn(pmx, pmn)))
                : 0.0f;
        pref = __fadd_rn(pref, norm);
      }
      if (p.SI > 0 && iid >= 0)
        pref = __fadd_rn(pref, p.img_scores[(size_t)n * p.SI + iid]);
      const float score = ok ? __fadd_rn(__fadd_rn(la, nu), pref) : -1.0f;
      // n ascends, so a strict compare keeps the lowest index on ties
      if (score > best_s) {
        best_s = score;
        best_n = n;
      }
    }

    // ---- Select: lowest-index argmax over the block
    koord::block_argmax(best_s, best_n, red_f, red_i);
    const bool found = best_s >= 0.0f && p.pod_valid[i];
    if (tid == 0) p.chosen[i] = found ? best_n : -1;
    if (!found) continue;

    // ---- Reserve: the owner of the chosen node updates its rows
    if (best_n % nthr == tid) {
      const int b = best_n;
      float* rqd = p.requested + (size_t)b * R;
      for (int r = 0; r < R; ++r) {
        rqd[r] = __fadd_rn(rqd[r], fit_req[r]);
        p.delta_np[(size_t)b * R + r] =
            __fadd_rn(p.delta_np[(size_t)b * R + r], est[r]);
        if (p.prod_mode && is_prod)
          p.delta_pr[(size_t)b * R + r] =
              __fadd_rn(p.delta_pr[(size_t)b * R + r], est[r]);
      }
      if (needs_numa) {
        // Only SingleNUMANode pins a zone; every other policy fills the
        // lowest zones first (ops/numa.numa_spread_fill)
        float* nf = p.numa + (size_t)b * K * R;
        int zone;
        numa_admit(p, rq, nf, p.policy[b], zone);
        if (zone >= 0) {
          for (int r = 0; r < R; ++r)
            nf[zone * R + r] = __fsub_rn(nf[zone * R + r], rq[r]);
        } else {
          for (int r = 0; r < R; ++r) {
            float remaining = rq[r];
            for (int k = 0; k < K; ++k) {
              const float take = fminf(nf[k * R + r], remaining);
              nf[k * R + r] = __fsub_rn(nf[k * R + r], take);
              remaining = __fsub_rn(remaining, take);
            }
          }
        }
      }
      if (needs_bind) p.bind_free[b] = __fsub_rn(p.bind_free[b], cores);
      for (int s = 0; s < p.PT; ++s)
        if (wants[s])
          p.port_used[(size_t)b * p.PT + s] =
              fmaxf(p.port_used[(size_t)b * p.PT + s], 1.0f);
      p.vol_free[b] = __fsub_rn(p.vol_free[b], vneed[p.vol_group[b]]);
    }
    // quota: add along the ancestor chain (thread 0 owns the quota state)
    if (tid == 0 && qid >= 0) {
      for (int d = 0; d < D; ++d) {
        const int g = p.anc[qid * D + d];
        if (g < 0) continue;
        for (int r = 0; r < R; ++r)
          p.quota_used[g * R + r] = __fadd_rn(p.quota_used[g * R + r], rq[r]);
      }
    }
    // affinity: raise matched terms' counts (and carried anti terms'
    // covers) over the chosen node's whole domain; latch exists flags
    for (int t = 0; t < T; ++t) {
      const bool m = match[t], a = anti_req[t];
      if (!m && !a) continue;
      if (tid == 0 && m) aff_exists[t] = 1;
      const float dom = p.aff_dom[(size_t)best_n * T + t];
      if (!(dom >= 0.0f)) continue;
      for (int n = tid; n < N; n += nthr) {
        if (p.aff_dom[(size_t)n * T + t] != dom) continue;
        if (m) p.aff_count[(size_t)n * T + t] += 1.0f;
        if (a) p.anti_cover[(size_t)n * T + t] += 1.0f;
      }
    }
  }
}

extern "C" {

int full_chain_params_size() { return (int)sizeof(FullChainParams); }

// Launches one round on `stream`; returns cudaGetLastError() (0 = launched).
int full_chain_launch(const FullChainParams* params, void* stream) {
  const int threads = 1024;
  const size_t dyn_bytes = 2 * (size_t)(params->T > 0 ? params->T : 1) * 4;
  full_chain_kernel<<<1, threads, dyn_bytes, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

}  // extern "C"
