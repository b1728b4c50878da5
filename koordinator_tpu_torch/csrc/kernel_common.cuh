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

// Lowest index among equal maxima: the binding contract (reference
// selectHost determinism, pallas_common.lowest_index_max).
__device__ __forceinline__ void argmax_merge(float& s, int& n, float os,
                                             int on) {
  if (os > s || (os == s && on < n)) {
    s = os;
    n = on;
  }
}

// Block-wide reductions for a block of whole warps (blockDim.x a multiple
// of 32, at most 1024). `red_f`/`red_i` are 33-slot shared arrays: slots
// 0..31 take the warp partials, slot 32 broadcasts the result. Every thread
// returns the block's result. Two barriers each; consecutive reductions may
// reuse the same arrays (each thread reads slot 32 before it can reach the
// next reduction's first barrier).
__device__ __forceinline__ void block_argmax(float& s, int& n, float* red_f,
                                             int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_down_sync(kFullMask, s, off);
    int on = __shfl_down_sync(kFullMask, n, off);
    argmax_merge(s, n, os, on);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_f[warp] = s;
    red_i[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? red_f[lane] : -CUDART_INF_F;
    n = lane < nw ? red_i[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float os = __shfl_down_sync(kFullMask, s, off);
      int on = __shfl_down_sync(kFullMask, n, off);
      argmax_merge(s, n, os, on);
    }
    if (lane == 0) {
      red_f[32] = s;
      red_i[32] = n;
    }
  }
  __syncthreads();
  s = red_f[32];
  n = red_i[32];
}

// (max, min) of one value per thread in one pass: `red_f` holds the maxima
// and `red_g` the minima (33 slots each, as above).
__device__ __forceinline__ void block_max_min(float& mx, float& mn,
                                              float* red_f, float* red_g) {
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_down_sync(kFullMask, mx, off));
    mn = fminf(mn, __shfl_down_sync(kFullMask, mn, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_f[warp] = mx;
    red_g[warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    mx = lane < nw ? red_f[lane] : -CUDART_INF_F;
    mn = lane < nw ? red_g[lane] : CUDART_INF_F;
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_down_sync(kFullMask, mx, off));
      mn = fminf(mn, __shfl_down_sync(kFullMask, mn, off));
    }
    if (lane == 0) {
      red_f[32] = mx;
      red_g[32] = mn;
    }
  }
  __syncthreads();
  mx = red_f[32];
  mn = red_g[32];
}

__device__ __forceinline__ float block_min(float v, float* red_f,
                                           float* red_g) {
  float mx = -CUDART_INF_F;
  block_max_min(mx, v, red_f, red_g);
  return v;
}

}  // namespace koord
