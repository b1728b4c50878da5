// The Filter chain of one (pod, node) pair, shared by the full-chain round
// (full_chain.cu) and the koordexplain stage-count pass (explain_counts.cu),
// so that a stage count is exactly "nodes this stage rejected for this pod"
// under the predicates the round decides with.
//
// Counterpart of the filter half of models/full_chain.make_pod_evaluator
// (and of the JAX package's `filter_chain` closure in its
// models/full_chain.py). Every compare repeats the plain round's f32
// operation; predicates combine with non-short-circuit & so that a node's
// loads issue together.

#pragma once

#include "kernel_common.cuh"

namespace koord {

constexpr int kPolicyNone = 0;        // ops/numa.py POLICY_NONE
constexpr int kPolicySingleNuma = 1;  // ops/numa.py POLICY_SINGLE_NUMA_NODE

// Pod record words after the common header (ops/full_chain_kernel.py)
constexpr int kRecCores = 2;   // f32
constexpr int kRecTaint = 3;   // f32 admission bitmask (exact integer)
constexpr int kRecQuota = 4;   // i32, -1 none
constexpr int kRecPref = 5;    // i32
constexpr int kRecPpref = 6;   // i32
constexpr int kRecImg = 7;     // i32

// One bit per Filter stage, in EXPLAIN_STAGES order
// (models/full_chain.py): a set bit is a stage that rejects the node.
constexpr unsigned kStageNode = 1u << 0;      // node not schedulable
constexpr unsigned kStageTaint = 1u << 1;     // taint/selector mismatch
constexpr unsigned kStageFit = 1u << 2;       // insufficient resources
constexpr unsigned kStageLoad = 1u << 3;      // node load over threshold
constexpr unsigned kStagePorts = 1u << 4;     // hostPort in use
constexpr unsigned kStageVolume = 1u << 5;    // CSI volume limit
constexpr unsigned kStageCpuset = 1u << 6;    // insufficient bindable cpus
constexpr unsigned kStageNuma = 1u << 7;      // NUMA topology cannot fit
constexpr unsigned kStageAffinity = 1u << 8;  // affinity/anti/spread
constexpr int kNumNodeStages = 9;

// Word offsets of the pod record's variable part (the record_layout of
// ops/full_chain_kernel.py).
struct RecLayout {
  int off_fit, off_req, off_est, off_aff, off_anti, off_match, off_skew,
      off_ports, off_vol;
};

// One pod's Filter inputs, pointing into its record.
struct FilterPod {
  unsigned flags;
  bool is_prod, is_ds, needs_numa, needs_bind, full_pcpus;
  float cores;
  int tmask;
  const float* fit_req;
  const float* rq;
  const uint32_t* aff_req;
  const uint32_t* anti_req;
  const uint32_t* match;
  const float* skew;
  const uint32_t* wants;
  const float* vneed;
};

__device__ __forceinline__ FilterPod filter_pod(const uint32_t* rec,
                                                const RecLayout& L) {
  FilterPod f;
  f.flags = rec[kRecFlags];
  f.is_prod = f.flags & kPodProd;
  f.is_ds = f.flags & kPodDs;
  f.needs_numa = f.flags & kPodNuma;
  f.needs_bind = f.flags & kPodBind;
  f.full_pcpus = f.flags & kPodFullPcpus;
  f.cores = __uint_as_float(rec[kRecCores]);
  f.tmask = (int)__uint_as_float(rec[kRecTaint]);
  f.fit_req = reinterpret_cast<const float*>(rec + L.off_fit);
  f.rq = reinterpret_cast<const float*>(rec + L.off_req);
  f.aff_req = rec + L.off_aff;
  f.anti_req = rec + L.off_anti;
  f.match = rec + L.off_match;
  f.skew = reinterpret_cast<const float*>(rec + L.off_skew);
  f.wants = rec + L.off_ports;
  f.vneed = reinterpret_cast<const float*>(rec + L.off_vol);
  return f;
}

// NUMA admission of local node j: (ok, zone) as ops/numa.numa_admit_row;
// zone is -1 unless the node's policy pins a single zone.
__device__ __forceinline__ bool numa_admit(const View& nf, int j, int R,
                                           int K, const float* rq, int pol,
                                           int& zone) {
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

// The read-only node rows the chain indexes by global node n.
struct FilterNodes {
  const float* cpc;          // [N] cpus per core
  const int32_t* policy;     // [N]
  const int32_t* taint_group;  // [N]
  const int32_t* vol_group;  // [N]
  const float* aff_dom;      // [N, T]
};

// The node's carried Filter state, by local node j (a block's slice in
// shared memory, or rows in device memory).
struct FilterState {
  View req, alloc, bind, numa, cnt, anti, port, vol;
};

// The stages of the Filter chain that reject global node n (local j, flag
// byte nf) for `pod`: a mask of kStage* bits, 0 where the node passes.
// `aff_exists` [T] holds the first-replica bootstrap flags and
// `spread_min` [T] the pod's minimum count over the domains it is
// eligible for (read only for a term with a positive skew).
__device__ __forceinline__ unsigned filter_stages(
    const FilterPod& pod, int j, int n, unsigned nf, int R, int K, int T,
    int PT, const FilterState& s, const FilterNodes& g,
    const int* aff_exists, const float* spread_min) {
  unsigned bad = (nf & kNodeOk) ? 0u : kStageNode;
  // Fit
  bool fit = true;
  for (int r = 0; r < R; ++r) {
    const float need = pod.fit_req[r];
    fit &= (need <= 0.0f) | (__fadd_rn(s.req(j, r), need) <= s.alloc(j, r));
  }
  bad |= fit ? 0u : kStageFit;
  // LoadAware thresholds (daemonsets bypass)
  const bool la_ok =
      pod.is_ds |
      ((nf & (pod.is_prod ? kNodeRejectPr : kNodeRejectNp)) == 0);
  bad |= la_ok ? 0u : kStageLoad;
  // cpuset capacity + SMT alignment. fmodf truncates where torch.remainder
  // floors; they differ only for negative operands, and cores and
  // cpus-per-core are both positive here.
  if (pod.needs_bind) {
    const float cpc = fmaxf(__ldg(g.cpc + n), 1.0f);
    const bool smt_ok =
        !pod.full_pcpus | (fabsf(fmodf(pod.cores, cpc)) < 0.5f);
    const bool ok = ((nf & kNodeHasTopo) != 0) & smt_ok &
                    (pod.cores <= s.bind(j, 0));
    bad |= ok ? 0u : kStageCpuset;
  }
  // NUMA topology admit
  if (pod.needs_numa) {
    int zone;
    const bool ok =
        numa_admit(s.numa, j, R, K, pod.rq, __ldg(g.policy + n), zone);
    bad |= ok ? 0u : kStageNuma;
  }
  // TaintToleration: bit test of the admission mask
  const bool taint_ok = ((pod.tmask >> __ldg(g.taint_group + n)) & 1) == 1;
  bad |= taint_ok ? 0u : kStageTaint;
  // InterPodAffinity, symmetric anti-affinity, PodTopologySpread
  bool aff_ok = true;
  for (int t = 0; t < T; ++t) {
    const float cnt = s.cnt(j, t);
    const bool dom_valid = __ldg(g.aff_dom + (size_t)n * T + t) >= 0.0f;
    const bool m = bit_at(pod.match, t);
    aff_ok &= !bit_at(pod.anti_req, t) | (cnt <= 0.0f);
    aff_ok &= !m | (s.anti(j, t) <= 0.0f);
    const bool boot = m & !aff_exists[t];
    aff_ok &= !bit_at(pod.aff_req, t) | (dom_valid & (cnt > 0.0f)) | boot;
    if (pod.skew[t] > 0.0f) {
      const float lhs =
          __fsub_rn(__fadd_rn(cnt, m ? 1.0f : 0.0f), spread_min[t]);
      aff_ok &= dom_valid & (lhs <= pod.skew[t]);
    }
  }
  bad |= aff_ok ? 0u : kStageAffinity;
  // NodePorts
  bool ports_ok = true;
  for (int q = 0; q < PT; ++q)
    ports_ok &= !bit_at(pod.wants, q) | (s.port(j, q) <= 0.0f);
  bad |= ports_ok ? 0u : kStagePorts;
  // NodeVolumeLimits per volume group
  const float vn = pod.vneed[__ldg(g.vol_group + n)];
  const bool vol_ok = (vn <= 0.0f) | (s.vol(j, 0) >= vn);
  bad |= vol_ok ? 0u : kStageVolume;
  return bad;
}

// The spread filter's minimum over this thread's nodes [lo + j for j =
// first, first + stride, ... < nloc] for term t: the smallest count among
// the domain-labelled nodes the pod's admission mask admits (+inf where
// there is none).
__device__ __forceinline__ float spread_min_part(const FilterPod& pod, int t,
                                                 int lo, int first,
                                                 int nloc, int stride, int T,
                                                 const View& cnt,
                                                 const FilterNodes& g) {
  float m = CUDART_INF_F;
  for (int j = first; j < nloc; j += stride) {
    const int n = lo + j;
    const bool taint_ok =
        ((pod.tmask >> __ldg(g.taint_group + n)) & 1) == 1;
    if (__ldg(g.aff_dom + (size_t)n * T + t) >= 0.0f && taint_ok)
      m = fminf(m, cnt(j, t));
  }
  return m;
}

}  // namespace koord
