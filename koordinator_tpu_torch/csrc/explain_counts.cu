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
// any order, atomics included.
//
// What bounds it on this card: operations, by a wide margin. At the main
// path's config 4 (P = 10240 pods, 5000 real of 5120 nodes, R = 3, K = 2,
// no affinity term or port) the work is 51.2 M (pod, node) pairs of about
// 36 compares and integer operations each, 1.85 G in all (0.028 ms at 67
// TFLOP/s, chip_smoke.py explain_ops); the bytes it must move are the pod
// records (0.8 MB), the frozen node rows (0.4 MB) and the counts (0.45 MB),
// 0.5 us at 3.35 TB/s. Measured, it is bound by instruction issue, not by
// its reads: the first design (one block per pod, its threads striding
// over every node and reading every node row from L2 once per pod) took
// 0.381 ms of device time, this one 0.355 (testing/kernel_ab.py
// --packages, H100 80GB HBM3 at 700 W); of that the cpuset stage's fmodf
// takes 0.066 ms and the NUMA stage 0.089 (testing/explain_ab.py). What
// a call cost was the wrapper, not the launch: its repack of the round's
// records was 1.6-2.4 ms of a 2.0-2.8 ms call, and the main path now
// hands it the round's pack. So the design keeps a pair's operands in
// registers or one broadcast away, keeps a warp's pods on one branch, and
// runs beside the round, on the SMs the round's one cluster leaves idle.
//
// The design. A block takes a group of `tile` pods, one a thread, and a
// split of the node range (grid: pod groups x node splits, a few blocks an
// SM, at P = 1280 as at P = 10240). It copies its pods' records into
// shared memory once, with cp.async, and deals the pods to the threads by
// the branches the chain takes for them (cpuset, NUMA), so that a warp's
// pods seldom split over both sides of one; each thread keeps its pod's
// words in registers. The block then walks its nodes a tile of `tile`
// nodes at a time: the tile's frozen rows (requested, allocatable, NUMA
// zones, bindable cpus, volume headroom, affinity counts, covers and
// domains, ports, flags, cpus per core, NUMA policy, taint and volume
// groups) are copied into shared memory once, with cp.async, and serve
// every pod of the group: each thread runs filter_stages for its pod
// against the tile's nodes in turn, each node's words a broadcast read. A
// thread counts its pod's rejections per stage in registers and at the
// end adds each count that is not zero into the output with one integer
// atomic; the launch zeroes the output first. The round's own packed
// records and node flags are taken as they are (queue order or valid pods
// first: each record names its row).
//
// The spread filter needs each pod's minimum count over the domains it may
// use, over every node (padded ones too, as the round takes them), before
// any verdict. Where the batch has affinity terms (T > 0), a first launch
// of the same kernel (`spread_out`, no counts) adds each split's minima of
// the terms a pod gives a positive skew into one [P, T] buffer, with an
// atomic min on the float's bits, and a pod with no such term does no
// minima work; the counting launch reads that buffer (`spread_in`). Over a
// mesh of cards each shard makes both launches over its own rows, into one
// minima buffer and one [P, 11] buffer on the first card (`accumulate`:
// peer atomics over NVLink, both zeroed or filled by the wrapper); the
// first shard alone writes the gang and quota flags.

#include "filter_chain.cuh"

namespace {

constexpr int kMaxThreads = 256;  // a group's pods and a tile's nodes
constexpr int kNumStages = koord::kNumNodeStages + 2;  // + gang, quota

}  // namespace

// Field order is mirrored by ops/explain_kernel.py (_Params); the wrapper
// checks sizeof through explain_params_size().
struct ExplainParams {
  const uint32_t* records;     // [P, rec_stride], each naming its row
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
  uint32_t* counts;            // [P, 11] by row (output), or null
  const float* spread_in;      // [P, T] the mesh's spread minima, or null
  float* spread_out;           // [P, T] minima only (atomic min), or null
  int P, N, R, K, G, D, T, PT, n_real;
  int rec_stride, off_fit, off_req, off_est, off_aff, off_anti, off_match,
      off_skew, off_ports, off_vol;
  int tile;         // pods of a group = nodes of a tile = threads (32..256)
  int splits;       // node splits of the grid
  int accumulate;   // 1: add into counts as they are (no zeroing)
  int write_flags;  // 1: write the gang and quota columns
};

// Byte offsets of one block's dynamic shared memory (ops/explain_kernel.py
// smem_bytes): the group's records [tile][stride], the order of its pods
// over the threads [tile] and the four branch buckets' fill counters, the
// exists flags [T],
// the spread minima [tile][T], then the node tile, axis-major
// [width][tile]: requested R, allocatable R, NUMA K * R, bindable cpus,
// volume headroom, affinity counts T, covers T, ports PT, domains T, then
// the flags, cpus per core, NUMA policy, taint and volume groups as 4-byte
// words.
struct ExplainLayout {
  size_t recs, order, exists, smin, tile, bytes;
};

__host__ __device__ inline int explain_tile_words(int R, int K, int T,
                                                  int PT) {
  return 2 * R + K * R + 2 + 3 * T + PT + 5;
}

__host__ __device__ inline ExplainLayout explain_layout(
    const ExplainParams& p) {
  const size_t Tp = p.T > 0 ? p.T : 1;
  ExplainLayout L;
  size_t at = 0;
  L.recs = koord::smem_take(at, (size_t)p.tile * p.rec_stride * 4);
  L.order = koord::smem_take(at, (size_t)p.tile * 4 + 4 * 4);
  L.exists = koord::smem_take(at, Tp * 4);
  L.smin = koord::smem_take(at, (size_t)p.tile * Tp * 4);
  L.tile = koord::smem_take(
      at, (size_t)p.tile * explain_tile_words(p.R, p.K, p.T, p.PT) * 4);
  L.bytes = at;
  return L;
}

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   koord::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   koord::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, cnt) of a row-major [*, W] array of 4-byte words into `dst`,
// axis-major with `cap` columns: element (j, a) at dst[a * cap + j].
__device__ __forceinline__ void stage(void* dst, const void* src, int W,
                                      int cnt, int cap, int tid,
                                      int nthreads) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* s = static_cast<const uint32_t*>(src);
  const int total = W * cnt;
  for (int e = tid; e < total; e += nthreads) {
    const int j = e / W, a = e - j * W;
    cp_async4(d + a * cap + j, s + e);
  }
}

// An atomic min on a float held as its bits (never NaN): a non-negative
// float orders as a signed int, a negative one in reverse as an unsigned.
__device__ __forceinline__ void atomic_min_float(float* at, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(at), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(at), __float_as_uint(v));
}

// A [tile nodes, width] array of the tile, axis-major: element (j, a) at
// p[a * cap + j], with 32-bit index arithmetic (filter_stages' state
// accessor, as View has it for the round's slices).
struct TileView {
  float* p;
  int cap;
  __device__ __forceinline__ float& operator()(int j, int a) const {
    return p[a * cap + j];
  }
};

struct TileState {
  TileView req, alloc, bind, numa, cnt, anti, port, vol;
};

// The tile's node rows in shared memory, by local node j (filter_stages'
// node accessors, as FilterNodes has them for device memory).
struct TileNodes {
  const float* cpc;
  const int* policy;
  const int* taint_group;
  const int* vol_group;
  const float* aff_dom;  // [T][cap]
  int cap;
  __device__ __forceinline__ float cpc_at(int j) const { return cpc[j]; }
  __device__ __forceinline__ int policy_at(int j) const { return policy[j]; }
  __device__ __forceinline__ int taint_at(int j) const {
    return taint_group[j];
  }
  __device__ __forceinline__ int vgroup_at(int j) const {
    return vol_group[j];
  }
  __device__ __forceinline__ float dom_at(int j, int, int t) const {
    return aff_dom[t * cap + j];
  }
};

}  // namespace

// kR, kK > 0 fix R and K at compile time (the common shape's 3 axes and 2
// zones); 0 reads them from `p`.
template <int kR, int kK>
__global__ void __launch_bounds__(kMaxThreads, 3)
    explain_counts_kernel(const ExplainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, PT = p.PT, Tp = T > 0 ? T : 1;
  const int R = kR ? kR : p.R, K = kK ? kK : p.K;
  const int cap = p.tile, nthreads = blockDim.x, tid = threadIdx.x;
  const int stride = p.rec_stride;
  const ExplainLayout L = explain_layout(p);
  uint32_t* recs = reinterpret_cast<uint32_t*>(smem + L.recs);
  int* order = reinterpret_cast<int*>(smem + L.order);
  int* fill = order + cap;
  int* exists = reinterpret_cast<int*>(smem + L.exists);
  float* smin = reinterpret_cast<float*>(smem + L.smin);
  float* t_req = reinterpret_cast<float*>(smem + L.tile);
  float* t_alloc = t_req + R * cap;
  float* t_numa = t_alloc + R * cap;
  float* t_bind = t_numa + K * R * cap;
  float* t_vol = t_bind + cap;
  float* t_cnt = t_vol + cap;
  float* t_anti = t_cnt + T * cap;
  float* t_port = t_anti + T * cap;
  float* t_dom = t_port + PT * cap;
  int* t_flags = reinterpret_cast<int*>(t_dom + T * cap);
  float* t_cpc = reinterpret_cast<float*>(t_flags + cap);
  int* t_policy = reinterpret_cast<int*>(t_cpc + cap);
  int* t_taint = t_policy + cap;
  int* t_vgroup = t_taint + cap;

  const int first = blockIdx.x * cap;
  const int npods = min(cap, p.P - first);
  const koord::RecLayout lay{p.off_fit,  p.off_req,  p.off_est,
                             p.off_aff,  p.off_anti, p.off_match,
                             p.off_skew, p.off_ports, p.off_vol};

  // ---- the group's records (contiguous rows of 16-byte multiples)
  {
    const uint32_t* src = p.records + (size_t)first * stride;
    for (int w = tid * 4; w < npods * stride; w += nthreads * 4)
      cp_async16(recs + w, src + w);
  }
  for (int t = tid; t < T; t += nthreads) exists[t] = p.aff_exists[t];
  if (tid < 4) fill[tid] = 0;
  cp_async_wait_all();
  __syncthreads();

  // the group's pods over the threads, bucketed by the branches the chain
  // takes for them (the cpuset and the NUMA stage run only where a pod
  // needs them), so that a warp's pods mostly take one path; any order
  // gives the same counts
  {
    const unsigned f = tid < npods ? recs[tid * stride + koord::kRecFlags]
                                   : 0u;
    const int key = tid < npods ? ((f & koord::kPodBind) ? 2 : 0) |
                                      ((f & koord::kPodNuma) ? 1 : 0)
                                : 4;
    int base = 0;
    for (int k = 0; k < 4; ++k) {
      const int n_k = __syncthreads_count(key == k);
      if (key == k) order[base + atomicAdd(&fill[k], 1)] = tid;
      base += n_k;
    }
    __syncthreads();
  }

  // this thread's pod (a thread past the group's end reads pod 0 and
  // counts nothing)
  const bool live = tid < npods;
  const uint32_t* rec = recs + (live ? order[tid] : 0) * stride;
  const koord::FilterPod pod = koord::filter_pod(rec, lay);
  const int row = (int)rec[koord::kRecPod];
  // this block's tiles: split blockIdx.y of the node range (every row for
  // the minima, the real ones for the counts)
  const bool minima_only = p.spread_out != nullptr;
  const int n_hi = minima_only ? p.N : p.n_real;
  const int tiles = (n_hi + cap - 1) / cap;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t_lo = min(tiles, (int)blockIdx.y * per);
  const int t_hi = min(tiles, t_lo + per);

  if (minima_only) {
    // this split's rows into the mesh's minima, for the terms the pod
    // gives a positive skew
    const int lo = t_lo * cap, hi = min(n_hi, t_hi * cap);
    if (!live || lo >= hi) return;
    const koord::FilterNodes gn{p.cpc, p.policy, p.taint_group, p.vol_group,
                                p.aff_dom};
    const koord::View cnt{const_cast<float*>(p.aff_count) + (size_t)lo * T,
                          T, 1};
    for (int t = 0; t < T; ++t)
      if (pod.skew[t] > 0.0f)
        atomic_min_float(
            p.spread_out + (size_t)row * T + t,
            koord::spread_min_part(pod, t, lo, 0, hi - lo, 1, T, cnt, gn));
    return;
  }
  float* my_min = smin + tid * Tp;
  if (live)
    for (int t = 0; t < T; ++t)
      my_min[t] = (pod.skew[t] > 0.0f && p.spread_in != nullptr)
                      ? p.spread_in[(size_t)row * T + t]
                      : CUDART_INF_F;

  // ---- the tiles: each node's rows once, against every pod of the group
  const TileState fs{{t_req, cap},  {t_alloc, cap}, {t_bind, cap},
                     {t_numa, cap}, {t_cnt, cap},   {t_anti, cap},
                     {t_port, cap}, {t_vol, cap}};
  const TileNodes tn{t_cpc, t_policy, t_taint, t_vgroup, t_dom, cap};
  unsigned c[koord::kNumNodeStages];
#pragma unroll
  for (int k = 0; k < koord::kNumNodeStages; ++k) c[k] = 0u;
  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int lo = tt * cap, cnt = min(cap, n_hi - lo);
    stage(t_req, p.requested + (size_t)lo * R, R, cnt, cap, tid, nthreads);
    stage(t_alloc, p.alloc + (size_t)lo * R, R, cnt, cap, tid, nthreads);
    stage(t_numa, p.numa + (size_t)lo * K * R, K * R, cnt, cap, tid,
          nthreads);
    stage(t_bind, p.bind_free + lo, 1, cnt, cap, tid, nthreads);
    stage(t_vol, p.vol_free + lo, 1, cnt, cap, tid, nthreads);
    if (T > 0) {
      stage(t_cnt, p.aff_count + (size_t)lo * T, T, cnt, cap, tid,
            nthreads);
      stage(t_anti, p.anti_cover + (size_t)lo * T, T, cnt, cap, tid,
            nthreads);
      stage(t_dom, p.aff_dom + (size_t)lo * T, T, cnt, cap, tid, nthreads);
    }
    if (PT > 0)
      stage(t_port, p.port_used + (size_t)lo * PT, PT, cnt, cap, tid,
            nthreads);
    stage(t_cpc, p.cpc + lo, 1, cnt, cap, tid, nthreads);
    stage(t_policy, p.policy + lo, 1, cnt, cap, tid, nthreads);
    stage(t_taint, p.taint_group + lo, 1, cnt, cap, tid, nthreads);
    stage(t_vgroup, p.vol_group + lo, 1, cnt, cap, tid, nthreads);
    if (tid < cnt) t_flags[tid] = p.node_flags[lo + tid];
    cp_async_wait_all();
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int j = 0; j < cnt; ++j) {
        const unsigned bad = koord::filter_stages(
            pod, j, j, (unsigned)t_flags[j], R, K, T, PT, fs, tn, exists,
            my_min);
#pragma unroll
        for (int k = 0; k < koord::kNumNodeStages; ++k)
          c[k] += (bad >> k) & 1u;
      }
    }
    __syncthreads();  // the tile is overwritten next
  }
  if (!live) return;

  // ---- the pod's counts into the output, one atomic per nonzero count
  uint32_t* out = p.counts + (size_t)row * kNumStages;
#pragma unroll
  for (int k = 0; k < koord::kNumNodeStages; ++k)
    if (c[k]) atomicAdd(out + k, c[k]);
  if (!p.write_flags || blockIdx.y != 0) return;
  out[koord::kNumNodeStages] = (pod.flags & koord::kPodGangOk) ? 0u : 1u;
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
  out[koord::kNumNodeStages + 1] = ok ? 0u : 1u;
}

extern "C" {

int explain_params_size() { return (int)sizeof(ExplainParams); }

// Dynamic shared memory of one block of a launch with these parameters.
long long explain_smem_bytes(const ExplainParams* params) {
  return (long long)explain_layout(*params).bytes;
}

// 1 where a launch takes the instance specialised for the common shape.
int explain_instance(const ExplainParams* params) {
  return params->R == 3 && params->K == 2;
}

// Launches the pass on `stream`: zeroes the counts unless it accumulates
// (or writes minima only), then ceil(P / tile) x splits blocks of `tile`
// threads; returns a cudaError_t (0 = launched).
int explain_launch(const ExplainParams* params, void* stream) {
  const ExplainParams& p = *params;
  if (p.P == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!p.accumulate && p.spread_out == nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        p.counts, 0, (size_t)p.P * kNumStages * sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = explain_layout(p).bytes;
  const dim3 grid((p.P + p.tile - 1) / p.tile, p.splits);
  void (*kernel)(const ExplainParams) = explain_instance(params)
                                           ? explain_counts_kernel<3, 2>
                                           : explain_counts_kernel<0, 0>;
  if (smem > 48 * 1024) {  // above the default only with the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, p.tile, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
