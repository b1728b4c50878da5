// Shared device helpers of the port's scheduling kernels.
//
// Counterpart of koordinator_tpu/ops/pallas_common.py (the TPU kernels'
// shared fragments) and of ops/kernel_common.py (their plain torch forms).
// Every score formula here repeats the f32 operations of the JAX package's
// XLA evaluator in the same order, with explicit round-to-nearest
// intrinsics so that no multiply-add is ever contracted into an FMA (XLA
// does not contract; the build also passes --fmad=false). All packed
// quantities are integers below 2^24 or f32 values carried exactly as the
// plain round carries them, so the kernel's bindings are bit-identical to
// the plain round's.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace koord {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaxNodeScore = 100.0f;

// f32 1/cap with 0 for cap <= 0 (pallas_common.safe_reciprocal): the
// balanced-allocation fraction is min(used * (1/cap), 1) in every
// implementation, with the reciprocal computed once per node.
__device__ __forceinline__ float safe_reciprocal(float cap) {
  return cap > 0.0f ? __fdiv_rn(1.0f, cap) : 0.0f;
}

// kube-scheduler leastRequestedScore: floor((cap - used) * 100 / cap), 0
// when cap <= 0 or used > cap. Multiply first, then an IEEE divide.
__device__ __forceinline__ float least_requested(float used, float cap) {
  if (!(cap > 0.0f) || !(used <= cap)) return 0.0f;
  return floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cap, used), kMaxNodeScore), cap));
}

// ---------------------------------------------------------------------------
// The cluster design shared by both rounds (mirrored by ops/kernel_common.py).
//
// One launch is one thread-block cluster of C blocks. Block b owns the nodes
// [b * Nb, min((b + 1) * Nb, N)); thread t < node_threads of it owns the
// local nodes j = t (mod node_threads), and only that thread reads or writes
// their carried state. The block's last warp is the control warp: it keeps
// the pod records flowing into a ring in shared memory (one bulk copy per
// pod, completion on an mbarrier) and does the pod-level work (quota
// admission, the outputs, the block's part of the merge).
//
// The per-pod merge. Each node warp reduces its best (score, node) with two
// warp reductions and leaves it in shared memory, then arrives on a named
// barrier without waiting; the control warp waits there, reduces its
// block's warps, and pushes the block's best into slot [rank] of every
// block of the cluster with st.async, whose bytes complete a transaction on
// that block's merge mbarrier. Every thread then waits on its own block's
// mbarrier and reduces the C slots itself: one DSMEM store per block pair
// and no cluster-wide barrier per pod. Slots and mbarriers are
// double-buffered by pod parity: a block pushes pod v + 2 only after it
// has received every block's pod v + 1, which each block sends only after
// all its threads have read their pod v slots.
// ---------------------------------------------------------------------------

constexpr int kRingStages = 4;  // records in flight: pods v .. v + 3

// Per-pod phase stamps for testing/pod_trace.py, compiled in only with
// -DKOORD_TRACE: `clock64` of block 0's thread 0 at each phase of the first
// kTracePods pods, slot k of pod u at koord_trace[u * kTraceSlots + k].
constexpr int kTracePods = 16384;
constexpr int kTraceSlots = 8;
#ifdef KOORD_TRACE
__device__ long long koord_trace[kTracePods * kTraceSlots];
#define KOORD_STAMP(u, k)                                            \
  if (threadIdx.x == 0 && cluster.block_rank() == 0 &&               \
      (u) < koord::kTracePods)                                        \
    koord::koord_trace[(u) * koord::kTraceSlots + (k)] = clock64();
// name(dst, bytes): copy the stamps to the host, then zero them.
#define KOORD_TRACE_COPY(name)                                          \
  extern "C" int name(void* dst, size_t bytes) {                        \
    cudaError_t err = cudaMemcpyFromSymbol(dst, koord::koord_trace, bytes); \
    void* at = nullptr;                                                 \
    if (err == cudaSuccess)                                             \
      err = cudaGetSymbolAddress(&at, koord::koord_trace);              \
    if (err == cudaSuccess)                                             \
      err = cudaMemset(at, 0, sizeof(koord::koord_trace));              \
    return (int)err;                                                    \
  }
#else
#define KOORD_STAMP(u, k)
#define KOORD_TRACE_COPY(name)
#endif
// At most 15 node warps and the control warp: a thread may then hold 128
// registers (the full-chain node loop uses ~120; at 1024 threads it would
// be held to 64 and spill).
constexpr int kMaxBlockThreads = 512;

// Pod record header words and flag bits (ops/kernel_common.py REC_*, POD_*)
constexpr int kRecFlags = 0;
constexpr int kRecPod = 1;
constexpr unsigned kPodProd = 1u, kPodDs = 2u, kPodValid = 4u,
                   kPodGangOk = 8u, kPodNuma = 16u, kPodBind = 32u,
                   kPodFullPcpus = 64u;
// Node flag bits (ops/kernel_common.py NODE_*)
constexpr unsigned kNodeOk = 1u, kNodeScoreValid = 2u, kNodeRejectNp = 4u,
                   kNodeRejectPr = 8u, kNodeHasTopo = 16u;

// A [nodes, width] float array of one block's node slice: element (j, a) of
// local node j and axis a at p[j * sn + a * sa]. Shared-memory copies are
// axis-major (sn = 1, sa = slice capacity), so a warp's 32 owned nodes fall
// on 32 banks; device-memory rows keep the wrapper's layout.
struct View {
  float* p;
  int sn, sa;
  __device__ __forceinline__ float& operator()(int j, int a) const {
    return p[(size_t)j * sn + (size_t)a * sa];
  }
};

// Byte offsets of a kernel's dynamic shared memory, each region 16-aligned.
__host__ __device__ inline size_t smem_take(size_t& at, size_t bytes) {
  const size_t start = at;
  at = (at + bytes + 15) & ~(size_t)15;
  return start;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the mbarrier's phase of parity `parity` has completed. A wait
// of ~20 s (2^35 cycles) traps, so a broken protocol ends the launch with
// an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1LL << 35)) __trap();
  }
}

// Arrive on this block's mbarrier and add `bytes` to the transaction count
// its current phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Store `v` into the slot at the same offset as `slot` in block `rank` of
// the cluster, completing 8 bytes of that block's mbarrier at the offset of
// `bar`.
__device__ __forceinline__ void push_pair(const int2* slot,
                                          const uint64_t* bar, int rank,
                                          int2 v) {
  uint32_t rslot, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rslot)
               : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(rslot),
      "r"(v.x), "r"(v.y), "r"(rbar)
      : "memory");
}

// Named barrier 1 between the node warps (arrive, no wait) and the control
// warp (wait); `threads` counts both.
__device__ __forceinline__ void named_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void named_wait(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-aligned) from
// device memory into this block's shared memory with the TMA's 1-D bulk
// copy; the mbarrier's phase completes when the bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bit t of a packed bit row.
__device__ __forceinline__ bool bit_at(const uint32_t* words, int t) {
  return (words[t >> 5] >> (t & 31)) & 1u;
}

// A float's order as a signed integer (for values that are not NaN; -0
// folds into +0 first, as the float compare has them equal).
__device__ __forceinline__ int order_key(float s) {
  const int k = __float_as_int(__fadd_rn(s, 0.0f));
  return k >= 0 ? k : k ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Lowest-index argmax over a warp in two warp reductions (the highest
// score, then the lowest node among the lanes that hold it); every lane
// returns the result, as the lowest-index rule over all lanes in any
// order would.
__device__ __forceinline__ void warp_argmax(float& s, int& n) {
  const int key = order_key(s);
  const int top = __reduce_max_sync(kFullMask, key);
  n = __reduce_min_sync(kFullMask, key == top ? n : INT32_MAX);
  s = key_value(top);
}

__device__ __forceinline__ int2 pack_best(float s, int n) {
  return make_int2(__float_as_int(s), n);
}

// The best of `count` (at most 32) (score bits, node) pairs at `parts`, in
// every lane of the warp.
__device__ __forceinline__ void warp_argmax_of(const int2* parts, int count,
                                               float& s, int& n) {
  const int lane = threadIdx.x & 31;
  const int2 v = lane < count ? parts[lane]
                              : pack_best(-CUDART_INF_F, INT32_MAX);
  s = __int_as_float(v.x);
  n = v.y;
  warp_argmax(s, n);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// The min (take_max = false) or max of the floats that `nparts` warps of
// every block of the cluster left at `part` (the same offset in each
// block's shared memory), in every lane: exact in any order.
template <class Cluster>
__device__ __forceinline__ float cluster_extreme(Cluster& cluster,
                                                 const float* part,
                                                 int nparts, int nblocks,
                                                 bool take_max) {
  const int lane = threadIdx.x & 31;
  float x = take_max ? -CUDART_INF_F : CUDART_INF_F;
  for (int e = lane; e < nblocks * nparts; e += 32) {
    const int rank = e / nparts;
    const float y = cluster.map_shared_rank(part, rank)[e - rank * nparts];
    x = take_max ? fmaxf(x, y) : fminf(x, y);
  }
  return take_max ? warp_max(x) : warp_min(x);
}

// Copy a [nloc, width] slice between two views, by every thread of the block.
__device__ __forceinline__ void copy_view(const View& dst, const View& src,
                                          int nloc, int width) {
  for (int e = threadIdx.x; e < nloc * width; e += blockDim.x) {
    const int j = e / width, a = e - j * width;
    dst(j, a) = src(j, a);
  }
}

// Launch `kernel` as one cluster of `cluster` blocks of `threads` threads
// with `smem` bytes of dynamic shared memory; returns a cudaError_t (0 =
// launched). A cluster the card cannot place is reported before the launch.
template <class Kernel, class Params>
inline int launch_cluster(Kernel kernel, const Params& params, int cluster,
                          int threads, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace koord
