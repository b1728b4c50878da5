// The fused waves' kept-only replay on Hopper (sm_90a), node-parallel: the
// pods that survived the gang Permit, each committed onto the node pass 1
// chose for it, from the wave-start state, with the NUMA zone re-picked
// under the replay state.
//
// Replaces no TPU kernel: the JAX package runs this pass as an XLA
// fori_loop over the pods in queue order (koordinator_tpu/models/
// fused_waves.py, the `rbody` loop at :559). Its plain versions are
// models/fused_waves.replay_kept (that loop) and ops/full_chain_kernel.py
// replay_by_node (this kernel's order); the outputs are theirs bit for bit.
//
// What bounds it on this card: the bytes are small (the state once in and
// out, a few words per pod), so the bound is the longest chain of
// dependent f32 adds. A pod's commit touches only its node's rows, one
// quota cell per (ancestor, axis) and the affinity counts of its node's
// domain, so the true dependencies are per node (requested, the LoadAware
// sums on every axis, NUMA, bindable cpus, ports, volume headroom) and per
// quota cell; the root quota cell, which every kept pod with a quota
// reaches, is the longest chain (one add per pod).
//
// The design: no pod waits on another pod of another node.
//   1. replay_count_kernel, over the pods: zones preset to -1; each kept
//      pod adds 1 (integer atomics) to the (term, domain) count of every
//      term it matches (and, separately, carries as required anti), the
//      domain being its chosen node's aff_dom entry (dense ids below
//      ndom), and latches the exists flag of every term it matches.
//   2. replay_node_kernel: blocks [0, nb) each own node_threads rows, one
//      per thread, held in shared memory. A block scans every pod's kept
//      flag and chosen node (coalesced), compacts the kept pods of its rows
//      into a list in shared memory IN QUEUE ORDER (a block-wide prefix of
//      the per-thread hits), and each node thread walks the list and
//      commits its own pods through commit_node (filter_chain.cuh, the
//      round's own Reserve code): per node, queue order, so every f32 op is
//      the plain order. Then each node adds its domain's counts to its
//      affinity counts and anti covers once: every addend of the plain
//      loop is 1.0 (or 0.0), so x + c equals the plain sum exactly while x
//      is a non-negative integer and x + c <= 2^24; past that the thread
//      adds 1.0 c times itself and sets kErrBound. Domain ids are dense
//      below ndom (the encoder's contract, ops/podaffinity.py); a pod
//      whose id is not is counted nowhere and sets kErrDomain. Blocks
//      [nb, nb + G) each own a quota group:
//      the kept pods whose ancestor chain holds it, compacted in queue
//      order with their requests (times the chain's multiplicity), then one
//      thread per axis adds them serially, exactly the plain order of that
//      cell.
// Over a mesh of cards the same kernels run on a card's shard rows (L
// shards side by side); a pod whose node is on another card commits
// nothing here but its domain, read from `dom_rows` (the chosen nodes'
// aff_dom rows, gathered by the wrapper), and its quota.

#include "filter_chain.cuh"

namespace {

constexpr int kListPerThread = 16;  // the bucket list: 16 entries a thread
constexpr int kPodsPerThread = 8;   // pods one thread scans per chunk
constexpr int kNodeBits = 9;        // an entry: pod << 9 | local node
constexpr int kMaxAxes = 16;        // resource axes a pod's fields hold
constexpr unsigned kErrBound = 1u;  // a count past the exact range
constexpr unsigned kErrDomain = 2u;  // a domain id not dense below ndom

}  // namespace

// Field order is mirrored by ops/full_chain_kernel.py (_ReplayParams); the
// wrapper checks sizeof through replay_params_size().
struct ReplayParams {
  // ---- pods [P]
  const uint8_t* kept;        // [P] survived Permit
  const int32_t* chosen;      // [P] pass 1's global node
  const float* fit_req;       // [P, R]
  const float* req;           // [P, R] raw requests (quota, NUMA)
  const float* est;           // [P, R]
  const uint8_t* is_prod;     // [P]
  const uint8_t* needs_numa;  // [P]
  const uint8_t* needs_bind;  // [P]
  const float* cores;         // [P]
  const int32_t* quota_id;    // [P] (-1: none)
  const uint8_t* match;       // [P, T]
  const uint8_t* anti;        // [P, T]
  const uint8_t* wants;       // [P, PT]
  const float* vol_needed;    // [P, VG]
  const float* dom_rows;      // [P, T] a mesh of cards' gathered rows;
                              // null: aff_dom[chosen]
  // ---- the launch's node rows [N], the quota tree
  const int32_t* policy;      // [N]
  const int32_t* vol_group;   // [N]
  const float* aff_dom;       // [N, T]
  const int32_t* anc;         // [G, D]
  // ---- the wave-start state (read only)
  const float* requested;     // [N, R]
  const float* est_sum;       // [N, R]
  const float* est_pr;        // [N, R] (null: zeros)
  const float* numa;          // [N, K, R]
  const float* bind_free;     // [N]
  const float* vol_free;      // [N]
  const float* port_used;     // [N, PT]
  const float* aff_count;     // [N, T]
  const float* anti_cover;    // [N, T]
  const float* quota;         // [G, R]
  const uint8_t* exists;      // [T]
  // ---- the state after the replay (outputs, every element written)
  float* o_requested;
  float* o_est_sum;
  float* o_est_pr;
  float* o_numa;
  float* o_bind_free;
  float* o_vol_free;
  float* o_port_used;
  float* o_aff_count;
  float* o_anti_cover;
  float* o_quota;
  uint8_t* o_exists;
  int32_t* zones;             // [P] the re-picked zone, -1 elsewhere
  int32_t* scratch;           // [2, T, ndom] counts, [T] exists, [1] errors
  // ---- sizes
  int P, N, R, K, T, PT, VG, G, D, prod_mode;
  int ndom;                   // domain ids are below it (the mesh's N)
  int node_threads;           // threads (and rows) of a node block
  // ---- the launch's rows: shard[l] holds global rows [shard * per, +per)
  // at launch rows [l * per, (l + 1) * per)
  int per, L;
  int shard[koord::kMaxLocalShards];
};

// Dynamic shared memory of one node or quota block (ops/full_chain_kernel
// replay_smem_bytes mirrors it): the prefix scratch, then either the
// bucket list, its per-node segments and the node rows, or the quota
// block's multiplicities and staged requests, over the same bytes.
struct RpSmem {
  size_t scan, list, seg, node, mult, vals, total;
};

// Floats per node held in shared memory: requested, the two LoadAware sums
// (every axis), NUMA zones, bindable cpus, volume headroom, ports.
__host__ __device__ inline int rp_node_floats(const ReplayParams& p) {
  return 3 * p.R + p.K * p.R + 2 + p.PT;
}

__host__ __device__ inline RpSmem rp_smem_layout(const ReplayParams& p) {
  RpSmem L = {};
  const int NT = p.node_threads;
  size_t at = 0;
  L.scan = koord::smem_take(at, (size_t)(NT / 32 + 1) * 4);
  const size_t role = at;
  L.list = koord::smem_take(at, (size_t)kListPerThread * NT * 4);
  L.seg = koord::smem_take(at, (size_t)kListPerThread * NT * 4);
  L.node = koord::smem_take(at, (size_t)rp_node_floats(p) * NT * 4);
  const size_t node_end = at;
  at = role;
  L.mult = koord::smem_take(at, (size_t)(p.G > 0 ? p.G : 1) * 4);
  L.vals = koord::smem_take(
      at, (size_t)(p.R > 0 ? p.R : 1) * kPodsPerThread * NT * 4);
  L.total = at > node_end ? at : node_end;
  return L;
}

namespace {

// The launch row of global node g, or -1 where no shard of this launch
// holds it.
__device__ __forceinline__ int launch_row(const ReplayParams& p, int g) {
  if (g < 0) return -1;
  const int k = g / p.per;
  for (int l = 0; l < p.L; ++l)
    if (p.shard[l] == k) return l * p.per + g - k * p.per;
  return -1;
}

// A domain id as an index below ndom, or -1 where it is not one.
__device__ __forceinline__ int dom_index(float d, int ndom) {
  return (d >= 0.0f && d == floorf(d) && d < (float)ndom) ? (int)d : -1;
}

// Chosen node's aff_dom row of kept pod i.
__device__ __forceinline__ const float* pod_dom(const ReplayParams& p, int i) {
  if (p.dom_rows != nullptr) return p.dom_rows + (size_t)i * p.T;
  return p.aff_dom + (size_t)max(p.chosen[i], 0) * p.T;
}

// x plus c additions of 1.0 in the plain loop's order (any is false: no pod
// was kept, the plain loop adds nothing).
__device__ __forceinline__ float add_count(float x, int c, bool any,
                                           unsigned* err) {
  if (!any) return x;
  if (c == 0) return __fadd_rn(x, 0.0f);
  if (x >= 0.0f && x == floorf(x) && x <= (float)(16777216 - c))
    return __fadd_rn(x, (float)c);
  atomicOr(err, kErrBound);
  float y = __fadd_rn(x, 0.0f);
  for (int k = 0; k < c; ++k) y = __fadd_rn(y, 1.0f);
  return y;
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total; every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NW = blockDim.x >> 5;
  __syncthreads();  // the previous scan's readers are done
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(koord::kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NW ? scan[lane] : 0;
    int incl = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(koord::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane < NW) scan[lane] = incl - w;
    if (lane == NW - 1) scan[NW] = incl;
  }
  __syncthreads();
  total = scan[NW];
  return scan[warp] + x - v;
}

}  // namespace

__global__ void __launch_bounds__(256) replay_count_kernel(
    const ReplayParams p) {
  const int T = p.T;
  int* cnt = p.scratch;  // [2][T][ndom]: matched, then anti
  int* ex = p.scratch + (size_t)2 * T * p.ndom;
  unsigned* err = reinterpret_cast<unsigned*>(ex + T);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p.P;
       i += gridDim.x * blockDim.x) {
    p.zones[i] = -1;
    if (!p.kept[i]) continue;
    const float* dom = pod_dom(p, i);
    for (int t = 0; t < T; ++t) {
      const bool m = p.match[(size_t)i * T + t], a = p.anti[(size_t)i * T + t];
      if (!m && !a) continue;
      if (m) atomicOr(ex + t, 1);
      const float d = dom[t];
      if (!(d >= 0.0f)) continue;
      const int di = dom_index(d, p.ndom);
      if (di < 0) {
        atomicOr(err, kErrDomain);
        continue;
      }
      if (m) atomicAdd(cnt + (size_t)t * p.ndom + di, 1);
      if (a) atomicAdd(cnt + ((size_t)T + t) * p.ndom + di, 1);
    }
  }
}

namespace {

// One kept pod's fields, as the commit reads them (kR > 0: R fixed at
// compile time, the arrays in registers).
template <int kR>
struct PodFields {
  float fit[kR ? kR : kMaxAxes], req[kR ? kR : kMaxAxes],
      est[kR ? kR : kMaxAxes];
  float cores, vneed;
  bool is_prod, needs_numa, needs_bind;
  int i;

  // Issues every load; nothing waits for them until the fields are used.
  __device__ __forceinline__ void load(const ReplayParams& p, int pod, int R,
                                       int vg) {
    i = pod;
    for (int r = 0; r < R; ++r) {
      fit[r] = __ldg(p.fit_req + (size_t)pod * R + r);
      req[r] = __ldg(p.req + (size_t)pod * R + r);
      est[r] = __ldg(p.est + (size_t)pod * R + r);
    }
    cores = __ldg(p.cores + pod);
    vneed = __ldg(p.vol_needed + (size_t)pod * p.VG + vg);
    is_prod = __ldg(p.is_prod + pod) != 0;
    needs_numa = __ldg(p.needs_numa + pod) != 0;
    needs_bind = __ldg(p.needs_bind + pod) != 0;
  }
};

// A node block: rows [lo, lo + nloc) of the launch, row lo + t of thread t.
template <int kR, int kK>
__device__ __forceinline__ void node_block(const ReplayParams& p,
                                           unsigned char* smem,
                                           const RpSmem& L) {
  const int NT = p.node_threads, tid = threadIdx.x;
  const int R = kR ? kR : p.R, K = kK ? kK : p.K, T = p.T, PT = p.PT;
  const int lo = blockIdx.x * NT, nloc = min(NT, p.N - lo);
  const bool own = tid < nloc;
  const int j = tid, n = lo + tid;
  int* scan = reinterpret_cast<int*>(smem + L.scan);
  int* list = reinterpret_cast<int*>(smem + L.list);
  int* seg = reinterpret_cast<int*>(smem + L.seg);
  const int cap = kListPerThread * NT;
  constexpr int kNodeMask = (1 << kNodeBits) - 1;
  const int* cnt = p.scratch;
  const int* ex = p.scratch + (size_t)2 * T * p.ndom;
  unsigned* err =
      reinterpret_cast<unsigned*>(p.scratch + (size_t)2 * T * p.ndom + T);

  // this block's rows in shared memory, axis-major (a warp's 32 rows on 32
  // banks), as the round's state
  using koord::View;
  float* base = reinterpret_cast<float*>(smem + L.node);
  int row = 0;
  auto slot = [&](int width) {
    const View v{base + (size_t)row * NT, 1, NT};
    row += width;
    return v;
  };
  const View req = slot(R), dnp = slot(R), dpr = slot(R), numa = slot(K * R);
  const View bind = slot(1), vol = slot(1), port = slot(PT);
  if (own) {  // read-only loads (__ldg): they need not wait on the stores
    for (int r = 0; r < R; ++r) {
      req(j, r) = __ldg(p.requested + (size_t)n * R + r);
      dnp(j, r) = __ldg(p.est_sum + (size_t)n * R + r);
      dpr(j, r) =
          p.est_pr != nullptr ? __ldg(p.est_pr + (size_t)n * R + r) : 0.0f;
    }
    for (int e = 0; e < K * R; ++e)
      numa(j, e) = __ldg(p.numa + (size_t)n * K * R + e);
    bind(j, 0) = __ldg(p.bind_free + n);
    vol(j, 0) = __ldg(p.vol_free + n);
    for (int s = 0; s < PT; ++s)
      port(j, s) = __ldg(p.port_used + (size_t)n * PT + s);
  }

  // The list's pods, each node's own into its segment of `seg` in list
  // order (a count, a block-wide prefix, a copy), then every node thread
  // commits its segment, all threads at once, each pod's fields loaded
  // while the one before commits.
  auto walk = [&](int count) {
    __syncthreads();  // the list's entries are in
    int mine = 0;
    if (own)
      for (int e = 0; e < count; ++e) mine += (list[e] & kNodeMask) == j;
    int total;
    const int start = block_scan(mine, scan, total);
    if (own && mine > 0) {
      for (int e = 0, k = start; k < start + mine; ++e)
        if ((list[e] & kNodeMask) == j) seg[k++] = list[e] >> kNodeBits;
      const int policy = __ldg(p.policy + n), vg = __ldg(p.vol_group + n);
      PodFields<kR> cur, next;
      cur.load(p, seg[start], R, vg);
      for (int k = 0; k < mine; ++k) {
        if (k + 1 < mine) next.load(p, seg[start + k + 1], R, vg);
        const koord::CommitPod c{cur.fit, cur.req, cur.est, cur.cores,
                                 cur.vneed, cur.is_prod, cur.needs_numa,
                                 cur.needs_bind};
        const uint8_t* w = p.wants + (size_t)cur.i * PT;
        p.zones[cur.i] = koord::commit_node(
            req, dnp, dpr, numa, bind, port, vol, j, R, K, R, PT,
            [](int jj) { return jj; }, p.prod_mode != 0, policy, c,
            [&](int s) { return w[s] != 0; });
        if (k + 1 < mine) cur = next;
      }
    }
    __syncthreads();  // every walker is done with the list
  };

  // ---- bucket this block's kept pods in queue order: each thread's pods
  // of a chunk loaded at once, then a block-wide prefix of the hits
  int count = 0;
  bool any_kept = false;
  for (int b = 0; b < p.P; b += kPodsPerThread * NT) {
    const int i0 = b + kPodsPerThread * tid;
    int kk[kPodsPerThread], gg[kPodsPerThread];
#pragma unroll
    for (int q = 0; q < kPodsPerThread; ++q) {
      const bool in = i0 + q < p.P;
      kk[q] = in ? __ldg(p.kept + i0 + q) : 0;
      gg[q] = in ? __ldg(p.chosen + i0 + q) : -1;
    }
    int ent[kPodsPerThread];
    unsigned hit = 0u;
    int h = 0;
#pragma unroll
    for (int q = 0; q < kPodsPerThread; ++q) {
      any_kept |= kk[q] != 0;
      const int r = kk[q] ? launch_row(p, gg[q]) - lo : -1;
      const bool mine = r >= 0 && r < nloc;
      ent[q] = ((i0 + q) << kNodeBits) | (mine ? r : 0);
      hit |= (unsigned)mine << q;
      h += mine;
    }
    int total;
    const int pos = block_scan(h, scan, total);
    if (count + total > cap) {
      walk(count);
      count = 0;
    }
    int at = count + pos;
#pragma unroll
    for (int q = 0; q < kPodsPerThread; ++q)
      if ((hit >> q) & 1u) list[at++] = ent[q];
    count += total;
  }
  walk(count);
  any_kept = __syncthreads_or(any_kept);

  if (own) {
    for (int r = 0; r < R; ++r) {
      p.o_requested[(size_t)n * R + r] = req(j, r);
      p.o_est_sum[(size_t)n * R + r] = dnp(j, r);
      p.o_est_pr[(size_t)n * R + r] = dpr(j, r);
    }
    for (int e = 0; e < K * R; ++e)
      p.o_numa[(size_t)n * K * R + e] = numa(j, e);
    p.o_bind_free[n] = bind(j, 0);
    p.o_vol_free[n] = vol(j, 0);
    for (int s = 0; s < PT; ++s) p.o_port_used[(size_t)n * PT + s] = port(j, s);
    // ---- the affinity counts and anti covers of this node's domains
    for (int t = 0; t < T; ++t) {
      const int di = dom_index(p.aff_dom[(size_t)n * T + t], p.ndom);
      const int cm = di >= 0 ? cnt[(size_t)t * p.ndom + di] : 0;
      const int ca = di >= 0 ? cnt[((size_t)T + t) * p.ndom + di] : 0;
      p.o_aff_count[(size_t)n * T + t] =
          add_count(p.aff_count[(size_t)n * T + t], cm, any_kept, err);
      p.o_anti_cover[(size_t)n * T + t] =
          add_count(p.anti_cover[(size_t)n * T + t], ca, any_kept, err);
    }
  }
  if (blockIdx.x == 0)
    for (int t = tid; t < T; t += NT)
      p.o_exists[t] = (p.exists[t] != 0 || ex[t] != 0) ? 1 : 0;
}

// A quota block: group g's R cells.
template <int kR>
__device__ __forceinline__ void quota_block(const ReplayParams& p, int g,
                                            unsigned char* smem,
                                            const RpSmem& L) {
  const int NT = p.node_threads, tid = threadIdx.x, R = kR ? kR : p.R;
  const int chunk = kPodsPerThread * NT;
  int* scan = reinterpret_cast<int*>(smem + L.scan);
  int* mult = reinterpret_cast<int*>(smem + L.mult);
  float* vals = reinterpret_cast<float*>(smem + L.vals);  // [R][chunk]
  // how often g stands in each group's ancestor chain
  for (int q = tid; q < p.G; q += NT) {
    int m = 0;
    for (int d = 0; d < p.D; ++d) m += p.anc[(size_t)q * p.D + d] == g;
    mult[q] = m;
  }
  __syncthreads();
  float acc = tid < R ? p.quota[(size_t)g * R + tid] : 0.0f;
  for (int b = 0; b < p.P; b += chunk) {
    const int i0 = b + kPodsPerThread * tid;
    int kk[kPodsPerThread], qq[kPodsPerThread], ms[kPodsPerThread];
#pragma unroll
    for (int q = 0; q < kPodsPerThread; ++q) {
      const bool in = i0 + q < p.P;
      kk[q] = in ? __ldg(p.kept + i0 + q) : 0;
      qq[q] = in ? __ldg(p.quota_id + i0 + q) : -1;
    }
    int h = 0;
#pragma unroll
    for (int q = 0; q < kPodsPerThread; ++q) {
      ms[q] = (kk[q] && qq[q] >= 0 && qq[q] < p.G) ? mult[qq[q]] : 0;
      h += ms[q] > 0;
    }
    int total;
    const int pos = block_scan(h, scan, total);
    // one axis at a time: that axis's loads of every hit in flight at
    // once, then their stores
    for (int r = 0; r < R; ++r) {
      float x[kPodsPerThread];
#pragma unroll
      for (int q = 0; q < kPodsPerThread; ++q)
        x[q] = ms[q] ? __ldg(p.req + (size_t)(i0 + q) * R + r) : 0.0f;
      int at = pos;
#pragma unroll
      for (int q = 0; q < kPodsPerThread; ++q)
        if (ms[q])
          vals[(size_t)r * chunk + at++] = __fmul_rn((float)ms[q], x[q]);
    }
    __syncthreads();
    // the cell's adds in queue order (models/fused_waves.replay_kept adds
    // the chain's one-hot times the request, pod by pod), four values a
    // load; the other warps load the next chunk meanwhile
    if (tid < R) {
      const float* v = vals + (size_t)tid * chunk;
      int e = 0;
#pragma unroll 4
      for (; e + 4 <= total; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(v + e);
        acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, x.x), x.y), x.z),
                        x.w);
      }
      for (; e < total; ++e) acc = __fadd_rn(acc, v[e]);
    }
  }
  if (tid < R) p.o_quota[(size_t)g * R + tid] = acc;
}

}  // namespace

// kR, kK > 0 fix R and K at compile time (the common shape: cpu, memory
// and pods; two NUMA zones), so the commit's loops unroll and a pod's
// fields stay in registers; 0 reads them from `p`.
template <int kR, int kK>
__global__ void __launch_bounds__(256) replay_node_kernel(
    const ReplayParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RpSmem L = rp_smem_layout(p);
  const int nb = (p.N + p.node_threads - 1) / p.node_threads;
  if ((int)blockIdx.x < nb)
    node_block<kR, kK>(p, smem, L);
  else
    quota_block<kR>(p, (int)blockIdx.x - nb, smem, L);
}

extern "C" {

int replay_params_size() { return (int)sizeof(ReplayParams); }

// 1 where a launch takes the instance specialised for the common shape
// (R = 3, K = 2), 0 for the generic instance.
int replay_instance(const ReplayParams* params) {
  return params->R == 3 && params->K == 2;
}

// Bytes of dynamic shared memory one block of replay_node_kernel takes.
long long replay_smem_bytes(const ReplayParams* params) {
  return (long long)rp_smem_layout(*params).total;
}

// Zeroes the scratch, then launches the count and the node kernels on
// `stream` on the current device; returns a cudaError_t (0 = launched).
int replay_launch(const ReplayParams* params, void* stream) {
  const ReplayParams& p = *params;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = rp_smem_layout(p).total;
  const size_t scratch = ((size_t)2 * p.T * p.ndom + p.T + 1) * 4;
  cudaError_t err = cudaMemsetAsync(p.scratch, 0, scratch, s);
  if (err != cudaSuccess) return (int)err;
  const bool common = p.R == 3 && p.K == 2;
  auto node_kernel =
      common ? replay_node_kernel<3, 2> : replay_node_kernel<0, 0>;
  err = cudaFuncSetAttribute(node_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (p.P + 255) / 256;
  const int cgrid = need < 1 ? 1 : (need > 1024 ? 1024 : need);
  replay_count_kernel<<<cgrid, 256, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.N + p.node_threads - 1) / p.node_threads + p.G;
  if (blocks > 0) node_kernel<<<blocks, p.node_threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
