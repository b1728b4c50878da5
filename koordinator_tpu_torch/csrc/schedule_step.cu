// One LoadAware-only scheduling round on Hopper (sm_90a): P pods in queue
// order against N nodes, each pod seeing the Fit requests and LoadAware
// estimates that the pods before it committed.
//
// Replaces the TPU kernel `_make_kernel` of koordinator_tpu/ops/pallas_step.py
// (reached through build_pallas_schedule_step, pallas_call at :187). It
// computes what the plain round of models/scheduler_model.py computes, with
// the same f32 operations in the same order, so `chosen` is bit-identical to
// it: Fit over the axes the pod requests; the LoadAware threshold filter from
// the per-node reject bits (computed by the wrapper), which daemonsets
// bypass; the LoadAware least-allocated score over est + (term + delta) on
// the weighted axes, with the prod/nonprod split in prod mode; the
// lowest-index argmax; the commit.
//
// What bounds it on this card: the round is serial in the pods. Pod i+1
// reads the `requested` rows and LoadAware deltas that pod i committed, and
// every pod needs an argmax over all N nodes before the next pod can start.
// Over the whole card the work is small (N x ~30 f32 operations per pod), so
// neither the card's bytes nor its operations bound it; what does is the
// per-pod chain: the node loop's latency, then the reduction and barrier
// that publish the winner.
//
// The design is the cluster design of kernel_common.cuh, shared with
// full_chain.cu: one cluster of C blocks on C SMs, block b owning a slice of
// the nodes, one node per thread at the main path's N = 5120 and C = 16.
// Each block keeps its slice of `requested`, of the two deltas on the W
// weighted axes, of allocatable, of the two terms and of the node flags in
// shared memory (`kStateInSmem = false` keeps the carried part in device
// memory past the budget). The wrapper hands every node array over
// axis-major ([axis, N]) and packs each pod into one record: its flags, the
// list of axes it requests (so the Fit touches only those, typically cpu,
// memory and pods of 14), its requests and its estimates. The control warp
// streams the records into a ring in shared memory with bulk copies. The
// wrapper puts the valid pods first, so the whole cluster walks only those;
// each pod costs one push of every block's best to every block (the merge
// of kernel_common.cuh) and no cluster-wide barrier.
//
// The exchange instance (`kXchg`, kernel_common.cuh "The exchange") runs
// the round over a mesh whose shards sit on different cards, a card's L
// shards as L clusters of one launch: per pod, once the cluster has merged
// its blocks' bests, the owner of its best publishes (score, global index)
// to every shard, each block's control warp reads the D entries and merges
// them by (score, lowest global index) for its own block, and the shard
// that owns the winner commits. The plain version is parallel/mesh.py
// _plain_sharded_schedule.

#include <cooperative_groups.h>

#include "kernel_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWeights = 16;
constexpr int kRecAxes = 2;  // 4 words: the requested axes, one byte each

}  // namespace

// Field order is mirrored by ops/schedule_kernel.py (_Params); the wrapper
// checks sizeof through schedule_step_params_size().
struct ScheduleStepParams {
  // ---- pods: one record per pod, the valid pods first
  const uint32_t* records;   // [P, rec_stride]
  const int32_t* n_valid;    // [1]
  // ---- nodes (read-only), axis-major
  const float* alloc;        // [R, N]
  const float* term_np;      // [W, N] weighted axes only
  const float* term_pr;      // [W, N]
  const uint8_t* node_flags;  // [N] kNode* bits
  const float* weights;      // [R]
  // ---- carried state (initialised by the wrapper, updated in place)
  float* requested;          // [R, N] (output)
  float* delta_np;           // [W, N]
  float* delta_pr;           // [W, N]
  int32_t* chosen;           // [P] (output; -1 preset)
  // ---- sizes and switches
  int P, N, R, prod_mode, n_widx;
  // ---- pod record layout (word offsets)
  int rec_stride, off_fit, off_est;
  // ---- cluster plan
  int cluster_size, nodes_per_block, node_threads, state_in_smem;
  int widx[kMaxWeights];
  // ---- the mesh of cards (x.L = 0: one device, N rows, one cluster)
  koord::Xchg x;
};

// 32-bit words of the exchange's payload and of its result (status,
// global index, score, a spare word).
constexpr int kPayloadWords = 2;
constexpr int kResultWords = 4;

// Dynamic shared memory of one block (ops/schedule_kernel.py
// estimate_smem_bytes mirrors it).
struct SsSmem {
  size_t bar, ring, part_warp, part_blk, xbar, xres, xstage, node, flags,
      total;
};

__host__ __device__ inline SsSmem ss_smem_layout(const ScheduleStepParams& p) {
  SsSmem L = {};
  size_t at = 0;
  const int nw = p.node_threads / 32;
  L.bar = koord::smem_take(at, (koord::kRingStages + 2) * 8);
  L.ring = koord::smem_take(at, (size_t)koord::kRingStages * p.rec_stride * 4);
  L.part_warp = koord::smem_take(at, 2 * (size_t)nw * 8);
  L.part_blk = koord::smem_take(at, 2 * (size_t)p.cluster_size * 8);
  if (p.x.L > 0) {
    L.xbar = koord::smem_take(at, 2 * 8);
    L.xres = koord::smem_take(at, 2 * (size_t)kResultWords * 4);
    L.xstage = koord::smem_take(
        at, (size_t)koord::kMaxShards * koord::xpairs(kPayloadWords) * 4);
  }
  if (p.state_in_smem) {
    // requested, two deltas, allocatable, two terms
    const size_t floats = 2 * (size_t)p.R + 4 * (size_t)p.n_widx;
    L.node = koord::smem_take(at, floats * p.nodes_per_block * 4);
    L.flags = koord::smem_take(at, (size_t)p.nodes_per_block);
  }
  L.total = at;
  return L;
}

// kW > 0 fixes the weighted-axis count at compile time, so the score loop
// unrolls completely; 0 reads it from `p`. kXchg: the instance over a mesh
// of cards (p.x).
template <bool kStateInSmem, int kW, bool kXchg>
__global__ void __launch_bounds__(koord::kMaxBlockThreads, 1)
    schedule_step_kernel(const ScheduleStepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const SsSmem L = ss_smem_layout(p);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);  // ring stages
  uint64_t* merge_bar = bar + koord::kRingStages;              // [2]
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  int2* part_warp = reinterpret_cast<int2*>(smem + L.part_warp);  // [2][NW]
  int2* part_blk = reinterpret_cast<int2*>(smem + L.part_blk);    // [2][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = p.node_threads, NW = NT >> 5;
  const bool ctrl = warp == NW;  // the control warp owns no node
  const int C = p.cluster_size, rank = (int)cluster.block_rank();
  const int Nb = p.nodes_per_block, N = p.N;
  // this cluster's shard: columns [row0, row0 + per) of the launch's
  // axis-major arrays, global nodes from gbase (one device: all N)
  const int l = kXchg ? (int)(blockIdx.x / C) : 0;
  const int per = kXchg ? p.x.per : N;
  const int row0 = l * per;
  const int me = kXchg ? p.x.shard[l] : 0, gbase = me * per;
  const int lo = row0 + min(rank * Nb, per);
  const int nloc = min(rank * Nb + Nb, per) - min(rank * Nb, per);
  const int R = p.R, W = kW ? kW : p.n_widx, S = koord::kRingStages;
  const int stride = p.rec_stride;

  using koord::View;
  View req_v, dnp_v, dpr_v, alloc_v, tnp_v, tpr_v;
  const uint8_t* nflags;
  const View g_req{p.requested + lo, 1, N};
  const View g_dnp{p.delta_np + lo, 1, N};
  const View g_dpr{p.delta_pr + lo, 1, N};
  const View g_alloc{const_cast<float*>(p.alloc) + lo, 1, N};
  const View g_tnp{const_cast<float*>(p.term_np) + lo, 1, N};
  const View g_tpr{const_cast<float*>(p.term_pr) + lo, 1, N};
  if constexpr (kStateInSmem) {
    float* base = reinterpret_cast<float*>(smem + L.node);
    int row = 0;
    auto slot = [&](int width) {
      const View v{base + (size_t)row * Nb, 1, Nb};
      row += width;
      return v;
    };
    req_v = slot(R), dnp_v = slot(W), dpr_v = slot(W);
    alloc_v = slot(R), tnp_v = slot(W), tpr_v = slot(W);
    koord::copy_view(req_v, g_req, nloc, R);
    koord::copy_view(dnp_v, g_dnp, nloc, W);
    koord::copy_view(dpr_v, g_dpr, nloc, W);
    koord::copy_view(alloc_v, g_alloc, nloc, R);
    koord::copy_view(tnp_v, g_tnp, nloc, W);
    koord::copy_view(tpr_v, g_tpr, nloc, W);
    uint8_t* fl = smem + L.flags;
    for (int j = tid; j < nloc; j += blockDim.x) fl[j] = p.node_flags[lo + j];
    nflags = fl;
  } else {
    req_v = g_req, dnp_v = g_dnp, dpr_v = g_dpr;
    alloc_v = g_alloc, tnp_v = g_tnp, tpr_v = g_tpr;
    nflags = p.node_flags + lo;
  }

  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.xbar);  // [2]
  uint32_t* xres = reinterpret_cast<uint32_t*>(smem + L.xres);  // [2][4]
  uint32_t* xstage = reinterpret_cast<uint32_t*>(smem + L.xstage);
  const int nv = *p.n_valid;
  if (ctrl && lane == 0) {
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
  // every block has started and initialised its shared memory
  cluster.sync();

  // the bits of the shards whose entries this block's wait first missed
  // (kXchg; 0: none). A block whose wait timed out waits no more but goes
  // on through every pod with no winner, so no merge of its cluster waits
  // for a block that left; the wrapper discards the round.
  unsigned missed = 0u;
  for (int v = 0; v < nv; ++v) {
    const int st = v % S;
    koord::mbar_wait(&bar[st], (v / S) & 1);
    KOORD_STAMP(v, 0)  // the record is in
    const uint32_t* rec = ring + st * stride;
    const uint32_t pf = rec[koord::kRecFlags];
    const bool is_prod = pf & koord::kPodProd, is_ds = pf & koord::kPodDs;
    const bool use_prod = p.prod_mode && is_prod;
    const int nfit = (int)(pf >> 8);
    const uint8_t* axes = reinterpret_cast<const uint8_t*>(rec + kRecAxes);
    const float* fit_req = reinterpret_cast<const float*>(rec + p.off_fit);
    const float* est = reinterpret_cast<const float*>(rec + p.off_est);

    // ---- Filter + Score over this thread's nodes, lowest-index best.
    // Predicates combine with non-short-circuit & so that a node's loads
    // issue together.
    float best_s = -CUDART_INF_F;
    int best_n = INT32_MAX;
    if (!ctrl) {
      for (int j = tid; j < nloc; j += NT) {
        const unsigned nf = nflags[j];
        // LoadAware thresholds (daemonsets bypass)
        bool ok = ((nf & koord::kNodeOk) != 0) &
                  (is_ds | ((nf & (is_prod ? koord::kNodeRejectPr
                                           : koord::kNodeRejectNp)) == 0));
        // Fit: requested + need <= allocatable on every requested axis
        for (int k = 0; k < nfit; ++k) {
          const int r = axes[k];
          ok &= __fadd_rn(req_v(j, r), fit_req[r]) <= alloc_v(j, r);
        }
        // LoadAware least-allocated over est + (term + in-round delta)
        float acc = 0.0f;
        for (int jj = 0; jj < W; ++jj) {
          const int r = p.widx[jj];
          const float base = use_prod ? __fadd_rn(tpr_v(j, jj), dpr_v(j, jj))
                                      : __fadd_rn(tnp_v(j, jj), dnp_v(j, jj));
          const float used = __fadd_rn(est[r], base);
          acc = __fadd_rn(acc, __fmul_rn(__ldg(p.weights + r),
                                         koord::least_requested(
                                             used, alloc_v(j, r))));
        }
        const float la = (nf & koord::kNodeScoreValid)
                             ? floorf(__fdiv_rn(acc, wdiv))
                             : 0.0f;
        const float score = ok ? la : -1.0f;
        // n ascends, so a strict compare keeps the lowest index on ties
        if (score > best_s) {
          best_s = score;
          best_n = lo + j;
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

    // ---- Select: every warp merges the C blocks' bests
    koord::mbar_wait(&merge_bar[v & 1], (v >> 1) & 1);
    KOORD_STAMP(v, 3)  // every block's best is in
    koord::warp_argmax_of(part_blk + (v & 1) * C, C, best_s, best_n);
    int gwin = best_n;
    if constexpr (kXchg) {
      // ---- the winner over every shard (pod v is exchange v)
      const int par = v & 1;
      const unsigned flag = p.x.flag0 + (unsigned)v;
      uint32_t* res = xres + par * kResultWords;
      const int jp = best_n - lo;
      constexpr int m = koord::xpairs(kPayloadWords);
      if (!ctrl && jp >= 0 && jp < nloc && jp % NT == tid) {
        const uint32_t w0 = __float_as_uint(best_s);
        const uint32_t w1 = (uint32_t)(gbase + best_n - row0);
        for (int d = 0; d < p.x.D; ++d)
          koord::xsend(p.x, d, par, me, flag, kPayloadWords,
                       [&](int w) { return w == 0 ? w0 : w1; });
      }
      if (ctrl) {
        const unsigned missing =
            missed ? missed : koord::xwait(p.x, me, par, flag, m, xstage);
        const bool in = lane < p.x.D && missing == 0u;
        const uint32_t* pl = xstage + (in ? lane : 0) * m;
        float ws = in ? __uint_as_float(pl[0]) : -CUDART_INF_F;
        int wn = in ? (int)pl[1] : INT32_MAX;
        koord::warp_argmax(ws, wn);
        if (lane == 0) {
          res[0] = missing;
          res[1] = (uint32_t)wn;
          res[2] = __float_as_uint(ws);
          res[3] = 0u;
          if (missing && !missed) atomicOr(p.x.err, missing);
        }
        koord::xdeliver(&xbar[par]);
      }
      koord::mbar_wait(&xbar[par], (v >> 1) & 1);
      missed = res[0];  // missed: no winner, best_s is -inf
      gwin = (int)res[1];
      best_s = __uint_as_float(res[2]);
    }
    const bool found = best_s >= 0.0f && (pf & koord::kPodValid);
    if (ctrl && lane == 0 && rank == 0 && l == 0)
      p.chosen[rec[koord::kRecPod]] = found ? gwin : -1;
    KOORD_STAMP(v, 4)  // merged
    if (!found) continue;

    // ---- Commit: the owner of the chosen node updates its rows (the
    // shard that holds it)
    const int jb =
        (kXchg ? (gwin / per == me ? row0 + gwin - gbase : -1) : gwin) - lo;
    if (!ctrl && jb >= 0 && jb < nloc && jb % NT == tid) {
      for (int r = 0; r < R; ++r)
        req_v(jb, r) = __fadd_rn(req_v(jb, r), fit_req[r]);
      for (int jj = 0; jj < W; ++jj) {
        const float e = est[p.widx[jj]];
        dnp_v(jb, jj) = __fadd_rn(dnp_v(jb, jj), e);
        if (use_prod) dpr_v(jb, jj) = __fadd_rn(dpr_v(jb, jj), e);
      }
    }
    KOORD_STAMP(v, 5)  // committed
  }

  // No block leaves while a peer may still read its shared memory.
  cluster.sync();
  if constexpr (kStateInSmem) {
    koord::copy_view(g_req, req_v, nloc, R);
    koord::copy_view(g_dnp, dnp_v, nloc, W);
    koord::copy_view(g_dpr, dpr_v, nloc, W);
  }
}

KOORD_TRACE_COPY(schedule_step_trace_copy)

namespace {

template <bool kXchg, bool kSmem, bool kCommon>
int launch_one(const ScheduleStepParams& p, void* stream, bool query) {
  auto kernel = schedule_step_kernel<kSmem, kCommon ? 2 : 0, kXchg>;
  const size_t smem = ss_smem_layout(p).total;
  const int threads = p.node_threads + 32, C = p.cluster_size;
  if (query) return koord::max_clusters(kernel, C, threads, smem);
  return koord::launch_cluster(kernel, p, C, threads, smem, stream,
                               kXchg ? p.x.L : 1);
}

template <bool kXchg>
int launch_mode(const ScheduleStepParams& p, void* stream, bool query) {
  const bool common = p.n_widx == 2;
  if (p.state_in_smem)
    return common ? launch_one<kXchg, true, true>(p, stream, query)
                  : launch_one<kXchg, true, false>(p, stream, query);
  return common ? launch_one<kXchg, false, true>(p, stream, query)
                : launch_one<kXchg, false, false>(p, stream, query);
}

int launch_any(const ScheduleStepParams& p, void* stream, bool query) {
  return p.x.L > 0 ? launch_mode<true>(p, stream, query)
                   : launch_mode<false>(p, stream, query);
}

}  // namespace

extern "C" {

int schedule_step_params_size() { return (int)sizeof(ScheduleStepParams); }

// Bytes of dynamic shared memory one block of this launch takes.
long long schedule_step_smem_bytes(const ScheduleStepParams* params) {
  return (long long)ss_smem_layout(*params).total;
}

// 1 where a launch takes the instance specialised for LoadAwareArgs'
// default weights (cpu and memory), 0 for the generic instance.
int schedule_step_instance(const ScheduleStepParams* params) {
  return params->n_widx == 2;
}

// 32-bit payload words of one mailbox entry.
int schedule_step_payload_words() { return kPayloadWords; }

// Clusters of this launch's instance the current device holds at once
// (negative: a cudaError_t).
int schedule_step_max_clusters(const ScheduleStepParams* params) {
  return launch_any(*params, nullptr, true);
}

// Launches one round on `stream` on the current device, as one cluster
// (x.L > 0: the instance over a mesh of cards, as x.L clusters); returns a
// cudaError_t (0 = launched).
int schedule_step_launch(const ScheduleStepParams* params, void* stream) {
  return launch_any(*params, stream, false);
}

}  // extern "C"
