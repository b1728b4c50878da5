// koordexplain's per-stage reject counts on Hopper (sm_90a): for every pod
// and every real node, the Filter chain at a frozen state, counted per
// stage.
//
// Replaces the jax.vmap of explain_stage_counts (koordinator_tpu/models/
// full_chain.py, and its per-wave call in fused_waves.py), which the JAX
// package runs in XLA, with no TPU kernel. It computes what the plain
// explain_stage_counts of models/full_chain.py computes: for pod i < P and
// node n < n_real, the stages of filter_chain.cuh's filter_stages (the very
// predicates the full-chain round decides with), counted per stage in
// EXPLAIN_STAGES order, then the pod's gang and quota verdict flags, as
// [P, 11] uint32. Every count is an integer sum, so the result is exact in
// any order.
//
// What bounds it on this card: operations. Each (pod, node) pair runs the
// chain, about 2R + 8T + 2PT + 20 f32 compares and integer operations, and
// the inputs (the pod records, the node state, a few MB at the main path's
// 10240 x 5120) are read from L2 over and over; the work is P x N pairs,
// data-parallel by nature.
//
// The design, simple first: one block per pod, its threads striding over
// the nodes. The spread filter needs the pod's minimum count over the
// domains it may use before any node's verdict (a cluster reduction in
// the round); here it is a first sweep over all N nodes inside the block
// and a block reduction. The second sweep counts each thread's nodes'
// stages in registers; warp sums and shared-memory atomics give the
// block's 9 counters. The pod's record is read from device memory (cached),
// so a record of any width fits.
//
// Over a mesh of cards each card counts its own rows (parallel/
// full_chain_mesh.py): a first launch per shard writes the shard's spread
// minima (`spread_out`, no counts), the wrapper takes their minimum over
// the shards, and a second launch counts the shard's real rows against
// those minima (`spread_in`, no first sweep); the integer counts are then
// summed over the shards.

#include "filter_chain.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumStages = koord::kNumNodeStages + 2;  // + gang, quota

}  // namespace

// Field order is mirrored by ops/explain_kernel.py (_Params); the wrapper
// checks sizeof through explain_params_size().
struct ExplainParams {
  const uint32_t* records;     // [P, rec_stride], queue order
  const float* alloc;          // [N, R]
  const float* requested;      // [N, R]
  const uint8_t* node_flags;   // [N] kNode* bits
  const float* cpc;            // [N]
  const int32_t* policy;       // [N]
  const int32_t* taint_group;  // [N]
  const int32_t* vol_group;    // [N]
  const float* aff_dom;        // [N, T]
  const float* numa;           // [N, K, R]
  const float* bind_free;      // [N]
  const float* vol_free;       // [N]
  const float* port_used;      // [N, PT]
  const float* aff_count;      // [N, T]
  const float* anti_cover;     // [N, T]
  const uint8_t* aff_exists;   // [T]
  const int32_t* anc;          // [G, D]
  const float* runtime;        // [G, R]
  const float* quota_used;     // [G, R]
  uint32_t* counts;            // [P, 11] (output)
  const float* spread_in;      // [P, T] the mesh's spread minima, or null
  float* spread_out;           // [P, T] minima only (output), or null
  int P, N, R, K, G, D, T, PT, n_real;
  int rec_stride, off_fit, off_req, off_est, off_aff, off_anti, off_match,
      off_skew, off_ports, off_vol;
};

// Dynamic shared memory of one block: the exists flags [T], the spread
// minima [T], the warps' partial minima [kWarps][T], the stage counters.
__host__ __device__ inline size_t explain_smem_bytes(int T) {
  const size_t Tp = T > 0 ? T : 1;
  return (2 + kWarps) * Tp * 4 + 16 * 4;
}

// kR, kK > 0 fix R and K at compile time (the common shape's 3 axes and 2
// zones); 0 reads them from `p`.
template <int kR, int kK>
__global__ void __launch_bounds__(kThreads)
    explain_counts_kernel(const ExplainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, Tp = T > 0 ? T : 1;
  const int R = kR ? kR : p.R, K = kK ? kK : p.K;
  int* aff_exists = reinterpret_cast<int*>(smem);
  float* spread_min = reinterpret_cast<float*>(smem) + Tp;
  float* part = spread_min + Tp;  // [kWarps][Tp]
  unsigned* stage_sum = reinterpret_cast<unsigned*>(part + kWarps * Tp);

  const int i = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const koord::RecLayout lay{p.off_fit,  p.off_req,  p.off_est,
                             p.off_aff,  p.off_anti, p.off_match,
                             p.off_skew, p.off_ports, p.off_vol};
  const uint32_t* rec = p.records + (size_t)i * p.rec_stride;
  const koord::FilterPod pod = koord::filter_pod(rec, lay);
  const koord::FilterNodes gn{p.cpc, p.policy, p.taint_group, p.vol_group,
                              p.aff_dom};
  using koord::View;
  const koord::FilterState fs{
      View{const_cast<float*>(p.requested), R, 1},
      View{const_cast<float*>(p.alloc), R, 1},
      View{const_cast<float*>(p.bind_free), 1, 1},
      View{const_cast<float*>(p.numa), K * R, 1},
      View{const_cast<float*>(p.aff_count), T, 1},
      View{const_cast<float*>(p.anti_cover), T, 1},
      View{const_cast<float*>(p.port_used), p.PT, 1},
      View{const_cast<float*>(p.vol_free), 1, 1}};

  for (int t = tid; t < T; t += kThreads) aff_exists[t] = p.aff_exists[t];
  if (tid < koord::kNumNodeStages) stage_sum[tid] = 0u;

  // ---- sweep 1: the spread minima over every node (padded ones too, as
  // the round takes them), for the terms with a positive skew; over a
  // mesh, the minima the wrapper took over every shard
  if (p.spread_in == nullptr) {
    for (int t = 0; t < T; ++t) {
      if (!(pod.skew[t] > 0.0f)) continue;  // the same branch in every thread
      const float m = koord::warp_min(koord::spread_min_part(
          pod, t, 0, tid, p.N, kThreads, T, fs.cnt, gn));
      if (lane == 0) part[warp * Tp + t] = m;
    }
    __syncthreads();
  }
  for (int t = tid; t < T; t += kThreads) {
    float m = CUDART_INF_F;
    if (pod.skew[t] > 0.0f) {
      if (p.spread_in != nullptr)
        m = p.spread_in[(size_t)i * T + t];
      else
        for (int w = 0; w < kWarps; ++w) m = fminf(m, part[w * Tp + t]);
    }
    spread_min[t] = m;
    if (p.spread_out != nullptr) p.spread_out[(size_t)i * T + t] = m;
  }
  if (p.spread_out != nullptr) return;  // the same branch in every thread
  __syncthreads();

  // ---- sweep 2: each thread's real nodes, stage by stage
  unsigned c[koord::kNumNodeStages];
#pragma unroll
  for (int k = 0; k < koord::kNumNodeStages; ++k) c[k] = 0u;
  for (int n = tid; n < p.n_real; n += kThreads) {
    const unsigned bad =
        koord::filter_stages(pod, n, n, p.node_flags[n], R, K, T, p.PT, fs,
                             gn, aff_exists, spread_min);
#pragma unroll
    for (int k = 0; k < koord::kNumNodeStages; ++k) c[k] += (bad >> k) & 1u;
  }
#pragma unroll
  for (int k = 0; k < koord::kNumNodeStages; ++k) {
    const unsigned v = __reduce_add_sync(koord::kFullMask, c[k]);
    if (lane == 0 && v) atomicAdd(&stage_sum[k], v);
  }
  __syncthreads();

  uint32_t* out = p.counts + (size_t)i * kNumStages;
  if (tid < koord::kNumNodeStages) out[tid] = stage_sum[tid];
  if (tid == koord::kNumNodeStages)
    out[tid] = (pod.flags & koord::kPodGangOk) ? 0u : 1u;
  if (tid == koord::kNumNodeStages + 1) {
    // ElasticQuota PreFilter along the ancestor chain at the frozen usage
    // (ops/quota.quota_admit_row)
    const int qid = (int)rec[koord::kRecQuota];
    bool ok = true;
    if (qid >= 0) {
      for (int d = 0; d < p.D; ++d) {
        const int g = p.anc[qid * p.D + d];
        if (g < 0) continue;
        for (int r = 0; r < p.R; ++r) {
          const float q = pod.rq[r];
          ok &= (q <= 0.0f) | (__fadd_rn(p.quota_used[g * p.R + r], q) <=
                               p.runtime[g * p.R + r]);
        }
      }
    }
    out[tid] = ok ? 0u : 1u;
  }
}

extern "C" {

int explain_params_size() { return (int)sizeof(ExplainParams); }

// 1 where a launch takes the instance specialised for the common shape.
int explain_instance(const ExplainParams* params) {
  return params->R == 3 && params->K == 2;
}

// Launches the pass on `stream`, one block per pod; returns a cudaError_t
// (0 = launched).
int explain_launch(const ExplainParams* params, void* stream) {
  const ExplainParams& p = *params;
  if (p.P == 0) return 0;
  const size_t smem = explain_smem_bytes(p.T);
  const cudaStream_t s = (cudaStream_t)stream;
  if (explain_instance(params))
    explain_counts_kernel<3, 2><<<p.P, kThreads, smem, s>>>(p);
  else
    explain_counts_kernel<0, 0><<<p.P, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
