// Compiled serial floor for the full plugin-chain scheduling step.
//
// A C++ transcription of scheduler/parity.py::serial_schedule_full (itself a
// scalar transcription of the reference's per-pod Go chain: kube
// NodeResourcesFit + load_aware.go:123-335 + NUMA admit + quota admission +
// gang permit). chip_smoke.py times this on the SAME packed batch as the
// CUDA round and reports vs_compiled_floor — an order-of-magnitude-honest
// stand-in for the reference's serial Go scheduler, which the port does not
// run (no Go toolchain, no cluster). The port's copy of
// koordinator_tpu/native/serial_floor.cpp, the code unchanged.
//
// Float discipline mirrors the numpy oracle exactly so bindings are
// bit-identical: float32 arithmetic everywhere, except the usage-ratio
// computation which numpy promotes through float64 before the float32 cast.
// Build with -ffp-contract=off (see native/floor.py) so no FMA contraction changes
// results vs numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline float go_round(float x) { return std::floor(x + 0.5f); }

inline float least_requested(float requested, float capacity) {
  if (capacity <= 0.0f || requested > capacity) return 0.0f;
  return std::floor((capacity - requested) * 100.0f / capacity);
}

}  // namespace

// ABI version: bump when koord_serial_full_chain's signature changes, so a
// stale .so is rejected instead of mis-reading shifted pointers.
extern "C" int koord_floor_abi_version() { return 11; }

extern "C" {

// All 2-D arrays are row-major contiguous. Mutable state arrays (requested,
// term_np, term_pr, numa_free, bind_free, quota_used) are scratch copies the
// caller owns; they are mutated in place, as in the numpy oracle.
void koord_serial_full_chain(
    // dims
    int P, int R, int N, int K, int G, int A, int NG, int T, int S,
    int S2, int PT, int SI, int VG,
    int bal_ci, int bal_mi,  // balanced-allocation cpu/mem axes (-1 = off)
    int prod_mode,
    // pods
    const float* fit_requests,   // [P, R]
    const float* requests,       // [P, R]
    const float* estimated,      // [P, R]
    const int32_t* is_prod,      // [P]
    const int32_t* is_daemonset, // [P]
    const int32_t* pod_valid,    // [P]
    const int32_t* gang_id,      // [P]
    const int32_t* quota_id,     // [P]
    const int32_t* needs_numa,   // [P]
    const int32_t* needs_bind,   // [P]
    const float* cores_needed,   // [P]
    const int32_t* full_pcpus,   // [P]
    const int32_t* pod_taint_mask, // [P] bitmask of tolerated taint groups
    const int32_t* pod_aff_req,    // [P] bitmask of required affinity terms
    const int32_t* pod_anti_req,   // [P] bitmask of anti-affinity terms
    const int32_t* pod_aff_match,  // [P] bitmask of terms the pod matches
    const int32_t* pod_spread_skew, // [P, T] maxSkew per term (0 = none)
    const int32_t* pod_pref_id,    // [P] preferred-affinity profile (-1)
    const int32_t* pod_ppref_id,   // [P] preferred POD-affinity profile
    const float* ppref_w,          // [max(S2,1), max(T,1)] profile weights
    const int32_t* pod_port_wants, // [P] bitmask of hostPort slots
    const float* vol_needed,       // [P, VG] new PVC volume count per node
                                   //         volume group
    const int32_t* pod_img_id,     // [P] ImageLocality profile (-1)
    // nodes
    const float* allocatable,    // [N, R]
    float* requested_state,      // [N, R] (mutated)
    const int32_t* node_ok,      // [N]
    const float* filter_usage,   // [N, R]
    const int32_t* has_filter_usage, // [N]
    const float* filter_thr,     // [N, R]
    const float* prod_thr,       // [N, R]
    const float* prod_usage,     // [N, R]
    float* term_np,              // [N, R] (mutated)
    float* term_pr,              // [N, R] (mutated)
    const int32_t* score_valid,  // [N]
    const int32_t* filter_skip,  // [N]
    const float* weights,        // [R]
    // topology
    float* numa_free,            // [N, K, R] (mutated)
    const int32_t* numa_policy,  // [N]  0=none, 1=single-numa-node
    const int32_t* has_topology, // [N]
    float* bind_free,            // [N] (mutated)
    const float* cpus_per_core,  // [N]
    const int32_t* node_taint_group, // [N]
    const float* aff_dom,        // [N, T] topology domain ids (-1 invalid)
    float* aff_count,            // [N, T] matching pods per domain (mutated)
    float* anti_cover,           // [N, T] anti-term CARRIERS per domain
                                 //        (mutated; symmetric anti-affinity)
    const int32_t* aff_exists0,  // [T] any matching pod anywhere (host seed)
    const float* pref_scores,    // [N, S] preferred-affinity score rows
    float* port_used,            // [N, PT] hostPort slot bound (mutated)
    float* vol_free,             // [N] CSI attachable headroom (mutated;
                                 //     +inf when the node reports no limit)
    const int32_t* node_vol_group, // [N] volume group selecting the pod's
                                   //     NEW-attachment count
    const float* img_scores,     // [N, SI] ImageLocality score rows
    // quota
    const int32_t* ancestors,    // [G, A] (-1 padded)
    float* quota_used,           // [G, R] (mutated)
    const float* quota_runtime,  // [G, R]
    // gangs
    const int32_t* gang_valid,   // [NG]
    const float* gang_min,       // [NG]
    const float* gang_assumed,   // [NG]
    const int32_t* gang_group,   // [NG]
    int num_groups,
    // out
    int32_t* chosen)             // [P]
{
  float wsum = 0.0f;
  for (int r = 0; r < R; ++r) wsum += weights[r];
  const float wdiv = wsum > 1.0f ? wsum : 1.0f;

  // per-term "any matching pod anywhere" (host-seeded, incl. pods on nodes
  // without the topology label; flipped on every in-batch match placement)
  bool* term_has_match = T > 0 ? new bool[T]() : nullptr;
  for (int t = 0; t < T; ++t) term_has_match[t] = aff_exists0[t] != 0;

  for (int p = 0; p < P; ++p) {
    chosen[p] = -1;
    if (!pod_valid[p]) continue;
    // PreFilter: gang validity + quota admission along the ancestor chain
    if (gang_id[p] >= 0 && !gang_valid[gang_id[p]]) continue;
    bool admit = true;
    if (quota_id[p] >= 0) {
      const int32_t* chain = ancestors + (int64_t)quota_id[p] * A;
      for (int a = 0; a < A && admit; ++a) {
        int g = chain[a];
        if (g < 0) continue;
        for (int r = 0; r < R; ++r) {
          float need = requests[(int64_t)p * R + r];
          if (need > 0.0f &&
              quota_used[(int64_t)g * R + r] + need >
                  quota_runtime[(int64_t)g * R + r]) {
            admit = false;
            break;
          }
        }
      }
    }
    if (!admit) continue;

    int best_n = -1, best_zone = -1;
    float best_score = -1.0f;
    const float* fitp = fit_requests + (int64_t)p * R;
    const float* reqp = requests + (int64_t)p * R;
    const float* estp = estimated + (int64_t)p * R;
    const bool use_prod_score = prod_mode && is_prod[p];

    // preferred POD affinity: weighted count row + max-min norm, hoisted
    // per pod (counts are frozen during one pod's node scan)
    float* ppref_norm = nullptr;
    if (T > 0 && S2 > 0 && pod_ppref_id[p] >= 0) {
      const float* w = ppref_w + (int64_t)pod_ppref_id[p] * (T > 0 ? T : 1);
      ppref_norm = new float[N];
      // max-min over node_ok only (upstream NormalizeScore spans the
      // candidate set; padded rows must not anchor the scale)
      float mx = -3.4e38f, mn = 3.4e38f;
      for (int n = 0; n < N; ++n) {
        float raw = 0.0f;
        for (int t = 0; t < T; ++t)
          raw += w[t] * aff_count[(int64_t)n * T + t];
        ppref_norm[n] = raw;
        if (node_ok[n]) {
          if (raw > mx) mx = raw;
          if (raw < mn) mn = raw;
        }
      }
      for (int n = 0; n < N; ++n)
        ppref_norm[n] = mx > mn
            ? std::floor((ppref_norm[n] - mn) * 100.0f / (mx - mn))
            : 0.0f;
    }
    // spread minimums hoisted per (pod, term): invariant across the node
    // scan, restricted to domains of nodes the pod is ELIGIBLE for
    // (admission bit test), matching the batched evaluators
    float spread_min[32];
    if (T > 0) {
      bool any_spread = false;
      for (int t = 0; t < T; ++t)
        if (pod_spread_skew[(int64_t)p * T + t] > 0) { any_spread = true; break; }
      if (any_spread) {
        for (int t = 0; t < T; ++t) spread_min[t] = 3.4e38f;
        for (int n = 0; n < N; ++n) {
          if (!((pod_taint_mask[p] >> node_taint_group[n]) & 1)) continue;
          for (int t = 0; t < T; ++t) {
            float d = aff_dom[(int64_t)n * T + t];
            float c = aff_count[(int64_t)n * T + t];
            if (d >= 0.0f && c < spread_min[t]) spread_min[t] = c;
          }
        }
      }
    }

    for (int n = 0; n < N; ++n) {
      if (!node_ok[n]) continue;
      // TaintToleration: group bit test (ops/taints.py)
      if (!((pod_taint_mask[p] >> node_taint_group[n]) & 1)) continue;
      // InterPodAffinity (ops/podaffinity.py)
      if (T > 0) {
        bool affinity_ok = true;
        const float* cnt = aff_count + (int64_t)n * T;
        const float* dom = aff_dom + (int64_t)n * T;
        const float* cov = anti_cover + (int64_t)n * T;
        for (int t = 0; t < T && affinity_ok; ++t) {
          if (((pod_anti_req[p] >> t) & 1) && cnt[t] > 0.0f)
            affinity_ok = false;
          // symmetric anti-affinity: a carrier of anti term t in this
          // node's domain blocks any pod matching t
          if (((pod_aff_match[p] >> t) & 1) && cov[t] > 0.0f)
            affinity_ok = false;
          if ((pod_aff_req[p] >> t) & 1) {
            bool boot = ((pod_aff_match[p] >> t) & 1) && !term_has_match[t];
            if (!(boot || (dom[t] >= 0.0f && cnt[t] > 0.0f)))
              affinity_ok = false;
          }
          // PodTopologySpread (DoNotSchedule)
          int skew = pod_spread_skew[(int64_t)p * T + t];
          if (affinity_ok && skew > 0) {
            if (dom[t] < 0.0f) { affinity_ok = false; continue; }
            float self_m = ((pod_aff_match[p] >> t) & 1) ? 1.0f : 0.0f;
            if (cnt[t] + self_m - spread_min[t] > (float)skew)
              affinity_ok = false;
          }
        }
        if (!affinity_ok) continue;
      }
      // NodePorts: no wanted hostPort slot already bound on the node
      if (PT > 0) {
        bool port_ok = true;
        for (int s = 0; s < PT && port_ok; ++s)
          if (((pod_port_wants[p] >> s) & 1) &&
              port_used[(int64_t)n * PT + s] > 0.0f)
            port_ok = false;
        if (!port_ok) continue;
      }
      // CSI volume limit (+inf when the node reports none); the node's
      // volume group selects NEW attachments only
      {
        float vn = vol_needed[(int64_t)p * VG + node_vol_group[n]];
        if (vn > 0.0f && vol_free[n] < vn) continue;
      }
      const float* alloc = allocatable + (int64_t)n * R;
      const float* reqn = requested_state + (int64_t)n * R;
      // Filter: Fit
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        if (fitp[r] > 0.0f && reqn[r] + fitp[r] > alloc[r]) { fit = false; break; }
      }
      if (!fit) continue;
      // Filter: LoadAware thresholds (load_aware.go:123-171)
      if (!is_daemonset[p] && !filter_skip[n]) {
        bool prod_configured = false;
        const float* pthr = prod_thr + (int64_t)n * R;
        for (int r = 0; r < R; ++r)
          if (pthr[r] > 0.0f) { prod_configured = true; break; }
        const bool use_prod = is_prod[p] && prod_configured;
        const float* usage =
            (use_prod ? prod_usage : filter_usage) + (int64_t)n * R;
        const float* thr = (use_prod ? prod_thr : filter_thr) + (int64_t)n * R;
        bool skip = !use_prod && !has_filter_usage[n];
        if (!skip) {
          bool ok = true;
          for (int r = 0; r < R; ++r) {
            if (thr[r] == 0.0f || alloc[r] == 0.0f) continue;
            // numpy computes this ratio in float64 then casts to float32
            float ratio = go_round(
                (float)((double)usage[r] * 100.0 / (double)alloc[r]));
            if (ratio >= thr[r]) { ok = false; break; }
          }
          if (!ok) continue;
        }
      }
      // Filter: cpuset capacity + SMT alignment
      if (needs_bind[p]) {
        if (!has_topology[n]) continue;
        float cpc = cpus_per_core[n] > 1.0f ? cpus_per_core[n] : 1.0f;
        if (full_pcpus[p] && std::fmod(cores_needed[p], cpc) != 0.0f) continue;
        if (cores_needed[p] > bind_free[n]) continue;
      }
      // NUMA admit
      int zone = -1;
      if (needs_numa[p] && numa_policy[n] != 0) {
        const float* nf = numa_free + ((int64_t)n * K) * R;
        if (numa_policy[n] == 1) {  // single-numa-node
          for (int k = 0; k < K && zone < 0; ++k) {
            bool fits = true;
            for (int r = 0; r < R; ++r) {
              if (reqp[r] > 0.0f && reqp[r] > nf[(int64_t)k * R + r]) {
                fits = false;
                break;
              }
            }
            if (fits) zone = k;
          }
          if (zone < 0) continue;
        } else {
          bool fits = true;
          for (int r = 0; r < R && fits; ++r) {
            if (reqp[r] <= 0.0f) continue;
            float total = 0.0f;
            for (int k = 0; k < K; ++k) total += nf[(int64_t)k * R + r];
            if (reqp[r] > total) fits = false;
          }
          if (!fits) continue;
        }
      }
      // Score: LoadAware least-requested + NUMA fit score
      const float* term = (use_prod_score ? term_pr : term_np) + (int64_t)n * R;
      float acc = 0.0f, acc2 = 0.0f;
      for (int r = 0; r < R; ++r) {
        if (weights[r] == 0.0f) continue;
        acc += weights[r] * least_requested(estp[r] + term[r], alloc[r]);
        acc2 += weights[r] * least_requested(reqn[r] + reqp[r], alloc[r]);
      }
      float la_score = score_valid[n] ? std::floor(acc / wdiv) : 0.0f;
      float numa_score = std::floor(acc2 / wdiv);
      // NodeResourcesBalancedAllocation: 2-axis std == |fc - fm| / 2
      if (bal_ci >= 0) {
        // reciprocal-multiply, NOT division: matches the f32 value the
        // XLA/Pallas/numpy implementations compute (used * f32(1/cap))
        float fc_ = 0.0f, fm_ = 0.0f;
        float capc = alloc[bal_ci];
        if (capc > 0.0f) {
          float invc = 1.0f / capc;
          fc_ = (reqn[bal_ci] + fitp[bal_ci]) * invc;
          if (fc_ > 1.0f) fc_ = 1.0f;
        }
        float capm = alloc[bal_mi];
        if (capm > 0.0f) {
          float invm = 1.0f / capm;
          fm_ = (reqn[bal_mi] + fitp[bal_mi]) * invm;
          if (fm_ > 1.0f) fm_ = 1.0f;
        }
        float std_ = std::fabs(fc_ - fm_) * 0.5f;
        numa_score += std::floor((1.0f - std_) * 100.0f);
      }
      float s = la_score + numa_score;
      // preferred node affinity: static profile score row
      if (S > 0 && pod_pref_id[p] >= 0)
        s += pref_scores[(int64_t)n * S + pod_pref_id[p]];
      if (ppref_norm) s += ppref_norm[n];
      if (SI > 0 && pod_img_id[p] >= 0)
        s += img_scores[(int64_t)n * SI + pod_img_id[p]];
      if (s > best_score) {  // strict: lowest index wins ties
        best_n = n;
        best_score = s;
        best_zone = zone;
      }
    }
    delete[] ppref_norm;
    if (best_n < 0) continue;
    chosen[p] = best_n;
    // Reserve: Fit state + assign cache + NUMA/cpuset/quota accounting
    float* reqn = requested_state + (int64_t)best_n * R;
    float* tnp = term_np + (int64_t)best_n * R;
    float* tpr = term_pr + (int64_t)best_n * R;
    for (int r = 0; r < R; ++r) {
      reqn[r] += fitp[r];
      tnp[r] += estp[r];
      if (prod_mode && is_prod[p]) tpr[r] += estp[r];
    }
    if (needs_numa[p]) {
      float* nf = numa_free + ((int64_t)best_n * K) * R;
      if (best_zone >= 0) {
        for (int r = 0; r < R; ++r) nf[(int64_t)best_zone * R + r] -= reqp[r];
      } else {
        for (int r = 0; r < R; ++r) {
          float remaining = reqp[r];
          for (int k = 0; k < K; ++k) {
            float avail = nf[(int64_t)k * R + r];
            float take = avail < remaining ? avail : remaining;
            nf[(int64_t)k * R + r] -= take;
            remaining -= take;
          }
        }
      }
    }
    if (needs_bind[p]) bind_free[best_n] -= cores_needed[p];
    for (int s = 0; s < PT; ++s)
      if ((pod_port_wants[p] >> s) & 1)
        port_used[(int64_t)best_n * PT + s] = 1.0f;
    {
      float vnb = vol_needed[(int64_t)p * VG + node_vol_group[best_n]];
      if (vnb > 0.0f) vol_free[best_n] -= vnb;
    }
    if (quota_id[p] >= 0) {
      const int32_t* chain = ancestors + (int64_t)quota_id[p] * A;
      for (int a = 0; a < A; ++a) {
        int g = chain[a];
        if (g < 0) continue;
        float* qu = quota_used + (int64_t)g * R;
        for (int r = 0; r < R; ++r) qu[r] += reqp[r];
      }
    }
    for (int t = 0; t < T; ++t) {
      float d = aff_dom[(int64_t)best_n * T + t];
      if ((pod_aff_match[p] >> t) & 1) {
        term_has_match[t] = true;  // even when the node lacks the label
        if (d >= 0.0f)
          for (int n = 0; n < N; ++n)
            if (aff_dom[(int64_t)n * T + t] == d)
              aff_count[(int64_t)n * T + t] += 1.0f;
      }
      // a placed CARRIER of anti term t raises its domain's anti_cover
      if (((pod_anti_req[p] >> t) & 1) && d >= 0.0f)
        for (int n = 0; n < N; ++n)
          if (aff_dom[(int64_t)n * T + t] == d)
            anti_cover[(int64_t)n * T + t] += 1.0f;
    }
  }
  delete[] term_has_match;

  // ---- gang permit barrier (all-or-nothing per gang group)
  if (NG > 0) {
    // heap-free small passes: counts fit on the stack only for tiny NG, so
    // allocate; this is outside the timed per-pod loop's hot path anyway
    float* per_gang = new float[NG]();
    for (int p = 0; p < P; ++p)
      if (gang_id[p] >= 0 && chosen[p] >= 0) per_gang[gang_id[p]] += 1.0f;
    bool* gang_ok = new bool[NG];
    int ngrp = num_groups > 0 ? num_groups : 1;
    int* group_fail = new int[ngrp]();
    for (int g = 0; g < NG; ++g) {
      gang_ok[g] = per_gang[g] + gang_assumed[g] >= gang_min[g];
      if (!gang_ok[g]) group_fail[gang_group[g]] += 1;
    }
    for (int p = 0; p < P; ++p) {
      int g = gang_id[p];
      if (g >= 0 && (!gang_ok[g] || group_fail[gang_group[g]] > 0))
        chosen[p] = -1;
    }
    delete[] per_gang;
    delete[] gang_ok;
    delete[] group_fail;
  }
}

// Serial floor for the koord-descheduler LowNodeLoad global rebalance
// (BASELINE config 5): a per-node/per-pod transcription of the classify /
// sort / select pass (reference pkg/descheduler/framework/plugins/loadaware/
// utilization_util.go semantics as implemented by descheduler/lownodeload.py:
// classify nodes by measured utilization, walk each high node's movable
// pods sorted by (priority asc, cpu desc), select until the node would drop
// back under the high thresholds or the per-node cap hits). Same float32
// arithmetic as the python pass so the selected victim set is identical.
void koord_lownodeload_floor(
    int N, int P, int R,
    const float* alloc,          // [N, R]
    const float* usage_pct,      // [N, R] measured utilization percent
    const int32_t* has_metric,   // [N]
    const float* low_thr,        // [R] (0 = unchecked)
    const float* high_thr,       // [R]
    const int32_t* pod_node,     // [P] node index (-1 = unassigned)
    const int32_t* pod_prio,     // [P]
    const float* pod_req,        // [P, R]
    const int32_t* movable,      // [P]
    const float* pod_sort_cpu,   // [P] cpu request (sort key)
    int max_evict_per_node,
    int32_t* victim)             // [P] out: 1 = selected for migration
{
  for (int p = 0; p < P; ++p) victim[p] = 0;
  // classification
  std::vector<bool> is_low(N, false), is_high(N, false);
  for (int n = 0; n < N; ++n) {
    if (!has_metric[n]) continue;
    bool low = true, high = false;
    for (int r = 0; r < R; ++r) {
      float u = usage_pct[(int64_t)n * R + r];
      if (low_thr[r] > 0.0f && !(u < low_thr[r])) low = false;
      if (high_thr[r] > 0.0f && u > high_thr[r]) high = true;
    }
    is_high[n] = high;
    is_low[n] = low && !high;
  }
  bool any_low = false, any_high = false;
  for (int n = 0; n < N; ++n) {
    any_low = any_low || is_low[n];
    any_high = any_high || is_high[n];
  }
  if (!any_low || !any_high) return;

  // per-node movable pod lists (single pass, stable order = input order)
  std::vector<std::vector<int>> node_pods(N);
  for (int p = 0; p < P; ++p) {
    int n = pod_node[p];
    if (n >= 0 && n < N && movable[p]) node_pods[n].push_back(p);
  }
  for (int n = 0; n < N; ++n) {
    if (!is_high[n]) continue;
    // over-gate mirrors lownodeload.py exactly: NO thr>0 mask here (the
    // python pass max(usage - thr, 0).any() counts unchecked axes too)
    bool over = false;
    for (int r = 0; r < R; ++r)
      if (usage_pct[(int64_t)n * R + r] - high_thr[r] > 0.0f) over = true;
    if (!over) continue;
    std::vector<int>& cand = node_pods[n];
    std::stable_sort(cand.begin(), cand.end(), [&](int a, int b) {
      if (pod_prio[a] != pod_prio[b]) return pod_prio[a] < pod_prio[b];
      return pod_sort_cpu[a] > pod_sort_cpu[b];
    });
    // freed accumulates in DOUBLE (like the reference's int64 quantity
    // math): the python pass computes the same prefix as one global f64
    // cumsum, which is exactly this sequential accumulation for the
    // integer-valued packed requests. The still-over test uses the
    // MULTIPLY form freed*100 < (usage - thr) * alloc (alloc > 0), the
    // identical double expression the python pass evaluates, so the
    // comparison is bit-deterministic on both sides.
    std::vector<double> freed(R, 0.0), rhs(R, 0.0);
    for (int r = 0; r < R; ++r) {
      float a = alloc[(int64_t)n * R + r];
      float denom = a > 1e-9f ? a : 1e-9f;
      rhs[r] = ((double)usage_pct[(int64_t)n * R + r] -
                (double)high_thr[r]) * (double)denom;
    }
    int count = 0;
    for (int pi : cand) {
      if (count >= max_evict_per_node) break;
      bool still_over = false;
      for (int r = 0; r < R; ++r) {
        if (high_thr[r] <= 0.0f) continue;
        if (freed[r] * 100.0 < rhs[r]) still_over = true;
      }
      if (!still_over) break;
      victim[pi] = 1;
      for (int r = 0; r < R; ++r)
        freed[r] += (double)pod_req[(int64_t)pi * R + r];
      ++count;
    }
  }
}

}  // extern "C"
