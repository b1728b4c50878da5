// The exchange's mailbox round trip (testing/mailbox_rtt.py): two threads,
// side 0 and side 1, pass one entry of two 8-byte pairs back and forth
// through the exchange's own primitives (kernel_common.cuh st_pair and
// ld_pairs, the flag in each pair's high half). Side s polls box[s], which
// sits in its own card's memory, and stores into the other side's box, as
// a shard polls its own mailbox and stores into its peers'. Round trip k:
// side 0 stores flag k, side 1 sees it and stores flag k back, side 0 sees
// that. Side 0 times `rounds` round trips after `warm` untimed ones (which
// absorb the two sides' start skew) with %globaltimer and clock64.
//
// Either side gives up once %globaltimer has passed timeout_ns since its
// start (side 0 then writes -1), so a side that never starts cannot hang
// the other.

#include "kernel_common.cuh"

// Field order is mirrored by testing/mailbox_rtt.py (_RttParams).
struct RttParams {
  unsigned long long* box0;  // [2] pairs side 0 polls (16-byte aligned)
  unsigned long long* box1;  // [2] pairs side 1 polls
  long long* out;            // [2] side 0: ns and cycles of the timed trips
  long long timeout_ns;
  int rounds, warm;
  int gpu;    // 1: .gpu scope (both sides on one card), 0: .sys
  int side0;  // the side of block 0; block b runs side side0 + b
};

__global__ void rtt_kernel(const RttParams p) {
  if (threadIdx.x != 0) return;
  const int side = p.side0 + (int)blockIdx.x;
  unsigned long long* mine = side == 0 ? p.box0 : p.box1;
  unsigned long long* theirs = side == 0 ? p.box1 : p.box0;
  const bool gpu = p.gpu != 0;
  const long long start = koord::global_ns();
  long long t0 = start, c0 = clock64();
  for (int k = 1; k <= p.warm + p.rounds; ++k) {
    if (k == p.warm + 1) {
      t0 = koord::global_ns();
      c0 = clock64();
    }
    const unsigned long long pair =
        ((unsigned long long)(unsigned)k << 32) | (unsigned)k;
    if (side == 0) {
      koord::st_pair(theirs, pair, gpu);
      koord::st_pair(theirs + 1, pair, gpu);
    }
    for (;;) {
      unsigned long long a, b;
      koord::ld_pairs(mine, gpu, a, b);
      if ((a >> 32) == (unsigned)k && (b >> 32) == (unsigned)k) break;
      if (koord::global_ns() - start > p.timeout_ns) {
        if (side == 0) p.out[0] = -1;
        return;
      }
    }
    if (side == 1) {
      koord::st_pair(theirs, pair, gpu);
      koord::st_pair(theirs + 1, pair, gpu);
    }
  }
  if (side == 0) {
    p.out[0] = koord::global_ns() - t0;
    p.out[1] = clock64() - c0;
  }
}

extern "C" {

int rtt_params_size() { return (int)sizeof(RttParams); }

// `blocks` (1 or 2) blocks of 32 threads on `stream` on the current
// device; returns a cudaError_t (0 = launched).
int rtt_launch(const RttParams* params, int blocks, void* stream) {
  rtt_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

}  // extern "C"
