// One LoadAware-only scheduling round on Hopper (sm_90a): P pods in queue
// order against N nodes, each pod seeing the Fit requests and LoadAware
// estimates that the pods before it committed.
//
// Replaces the TPU kernel `_make_kernel` of koordinator_tpu/ops/pallas_step.py
// (reached through build_pallas_schedule_step, pallas_call at :187). It
// computes what the plain round of models/scheduler_model.py computes, with
// the same f32 operations in the same order, so `chosen` is bit-identical to
// it: Fit over the axes the pod requests; the LoadAware threshold filter from
// the per-node reject rows (computed by the wrapper), which daemonsets
// bypass; the LoadAware least-allocated score over est + (term + delta) on
// the weighted axes, with the prod/nonprod split in prod mode; the
// lowest-index argmax; the commit.
//
// What bounds it on this card: the round is serial in the pods. Pod i+1
// reads the `requested` rows and LoadAware deltas that pod i committed, and
// every pod needs a block-wide argmax over all N nodes before the next pod
// can start. Over the whole card the work is small (N x ~30 f32 operations
// per pod), so neither the card's bytes nor its operations bound it; what
// does is the per-pod chain run on ONE SM: the node loop's loads and
// instructions, then the barriers of the staging and the argmax, P times
// over.
//
// The design answers that as simply as it can: one thread block of 1024
// threads runs the whole pod loop (the loop takes the place of the TPU's
// sequential grid). Thread t owns nodes n = t (mod blockDim.x) and is the
// only reader and writer of their carried state (`requested` and the
// deltas of the weighted axes, in device memory that stays in L2). The
// wrapper hands every node array over axis-major ([axis, N]), so the 32
// threads of a warp read 32 neighbouring floats of one axis in one
// transaction, and the read-only rows a pod touches (a few axes of
// allocatable and the LoadAware terms) are small enough to stay in the
// SM's L1. Per pod, thread 0 stages the list of axes the pod requests in
// shared memory, so the Fit touches only those (typically cpu, memory and
// pods of 14). Spreading N over a thread-block cluster or a persistent
// multi-block design, so that more SMs share the per-pod work, is later
// work.

#include "kernel_common.cuh"

namespace {

constexpr int kMaxAxes = 16;
constexpr int kMaxWeights = 16;

}  // namespace

// Field order is mirrored by ops/schedule_kernel.py (_Params); the wrapper
// checks sizeof through schedule_step_params_size().
struct ScheduleStepParams {
  // ---- pods
  const float* fit_req;      // [P, R] requests, pods axis = 1
  const float* est;          // [P, R] LoadAware estimates
  const uint8_t* is_prod;    // [P]
  const uint8_t* is_ds;      // [P]
  const uint8_t* pod_valid;  // [P]
  // ---- nodes (read-only), axis-major
  const float* alloc;        // [R, N]
  const float* term_np;      // [W, N] weighted axes only
  const float* term_pr;      // [W, N]
  const uint8_t* node_ok;    // [N]
  const uint8_t* score_valid;  // [N]
  const uint8_t* reject_np;  // [N]
  const uint8_t* reject_pr;  // [N]
  const float* weights;      // [R]
  // ---- carried state (initialised by the wrapper, updated in place)
  float* requested;          // [R, N] (output)
  float* delta_np;           // [W, N]
  float* delta_pr;           // [W, N]
  int32_t* chosen;           // [P] (output)
  // ---- sizes and switches
  int P, N, R, prod_mode, n_widx;
  int widx[kMaxWeights];
};

__global__ void __launch_bounds__(1024, 1)
    schedule_step_kernel(const ScheduleStepParams p) {
  __shared__ float red_f[33];
  __shared__ int red_i[33];
  __shared__ float s_need[kMaxAxes];   // requests of the pod's Fit axes
  __shared__ int s_axis[kMaxAxes];     // those axes
  __shared__ float s_est[kMaxWeights];  // estimates on the weighted axes
  __shared__ int s_nfit;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int P = p.P, N = p.N, R = p.R, W = p.n_widx;
  float wsum = 0.0f;  // integer weights: any order is exact
  for (int r = 0; r < R; ++r) wsum = __fadd_rn(wsum, p.weights[r]);
  const float wdiv = fmaxf(wsum, 1.0f);

  for (int i = 0; i < P; ++i) {
    // pod_valid is the same for every thread: the whole block skips
    if (!p.pod_valid[i]) {
      if (tid == 0) p.chosen[i] = -1;
      continue;
    }
    const float* fit_req = p.fit_req + (size_t)i * R;
    const float* est = p.est + (size_t)i * R;
    const bool is_prod = p.is_prod[i], is_ds = p.is_ds[i];
    const bool use_prod = p.prod_mode && is_prod;

    // ---- stage the pod's rows. Every thread has passed the previous
    // pod's argmax barriers, so no one still reads the old values.
    if (tid == 0) {
      int k = 0;
      for (int r = 0; r < R; ++r) {
        const float need = fit_req[r];
        if (need > 0.0f) {  // Fit skips the axes the pod does not request
          s_need[k] = need;
          s_axis[k] = r;
          ++k;
        }
      }
      s_nfit = k;
    }
    if (tid < W) s_est[tid] = est[p.widx[tid]];
    __syncthreads();
    const int nfit = s_nfit;

    // ---- Filter + Score over this thread's nodes, lowest-index best.
    // Predicates combine with non-short-circuit & so that a node's loads
    // issue together.
    float best_s = -CUDART_INF_F;
    int best_n = INT32_MAX;
    for (int n = tid; n < N; n += nthr) {
      // LoadAware thresholds (daemonsets bypass)
      const uint8_t rej = is_prod ? __ldg(p.reject_pr + n)
                                  : __ldg(p.reject_np + n);
      bool ok = (__ldg(p.node_ok + n) != 0) & (is_ds | (rej == 0));
      // Fit: requested + need <= allocatable on every requested axis
      for (int k = 0; k < nfit; ++k) {
        const size_t at = (size_t)s_axis[k] * N + n;
        ok &= __fadd_rn(p.requested[at], s_need[k]) <= __ldg(p.alloc + at);
      }
      // LoadAware least-allocated over est + (term + in-round delta)
      float acc = 0.0f;
      for (int j = 0; j < W; ++j) {
        const int r = p.widx[j];
        const size_t at = (size_t)j * N + n;
        const float base =
            use_prod ? __fadd_rn(__ldg(p.term_pr + at), p.delta_pr[at])
                     : __fadd_rn(__ldg(p.term_np + at), p.delta_np[at]);
        const float used = __fadd_rn(s_est[j], base);
        const float cap = __ldg(p.alloc + (size_t)r * N + n);
        acc = __fadd_rn(acc, __fmul_rn(p.weights[r],
                                       koord::least_requested(used, cap)));
      }
      const float la =
          __ldg(p.score_valid + n) ? floorf(__fdiv_rn(acc, wdiv)) : 0.0f;
      const float score = ok ? la : -1.0f;
      // n ascends, so a strict compare keeps the lowest index on ties
      if (score > best_s) {
        best_s = score;
        best_n = n;
      }
    }

    // ---- Select: lowest-index argmax over the block
    koord::block_argmax(best_s, best_n, red_f, red_i);
    const bool found = best_s >= 0.0f;
    if (tid == 0) p.chosen[i] = found ? best_n : -1;
    if (!found) continue;

    // ---- Commit: the owner of the chosen node updates its rows. It reads
    // the pod's rows from device memory: thread 0 may already be staging
    // the next pod in shared memory.
    if (best_n % nthr == tid) {
      const int b = best_n;
      for (int r = 0; r < R; ++r) {
        const size_t at = (size_t)r * N + b;
        p.requested[at] = __fadd_rn(p.requested[at], fit_req[r]);
      }
      for (int j = 0; j < W; ++j) {
        const size_t at = (size_t)j * N + b;
        const float e = est[p.widx[j]];
        p.delta_np[at] = __fadd_rn(p.delta_np[at], e);
        if (use_prod) p.delta_pr[at] = __fadd_rn(p.delta_pr[at], e);
      }
    }
  }
}

extern "C" {

int schedule_step_params_size() { return (int)sizeof(ScheduleStepParams); }

// Launches one round on `stream`; returns cudaGetLastError() (0 = launched).
int schedule_step_launch(const ScheduleStepParams* params, void* stream) {
  schedule_step_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

}  // extern "C"
