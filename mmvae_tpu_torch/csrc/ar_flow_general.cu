// Fused autoregressive-flow solve for Hopper (sm_90a) at any MADE widths
// that eight CTAs' shared memory holds: a forward kernel, the backward's
// reverse chain with the weight and bias sums on chip, and the sum of the
// clusters' partial sums.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (:96, body _make_kernel :34) and the gradient the JAX package takes around
// it (_ar_solve_bwd :156, jax.vjp of unrolled_solve :113) at the shapes that
// the 128-wide kernels of ar_flow.cu refuse: hidden layers of any width,
// widths that differ from layer to layer, more hidden layers than their
// shared memory holds. They compute the same functions as ar_flow.cu's pair,
// read and write the same tape (each hidden layer's pre-activation z[l],
// (D, N, width_l), and the head's raw log-scale s, (D, N)), and take JAX's
// slope 1/2 at an exact ReLU tie (jnp.maximum(z, 0)). Where eight CTAs
// cannot hold a MADE, ops/ar_flow.py routes the call to ar_flow_streamed.cu.
//
// What bounds them: latency. The solve is a chain of D steps of L + 1
// dependent matrix-vector products over a few rows, with a barrier between
// links; flops and bytes are far below what the card could do in the same
// time. So the design keeps every operand of a link on chip, spreads each
// link over all threads, and keeps the weight-gradient sums off the chain.
//
// The plan (ar_solve_general_plan, a function of numbers; ops/ar_flow.py
// keeps a copy): C, the CTAs of a thread-block cluster that share one row
// tile's weights, the least of 1, 2, 4 and 8 whose shared memory holds them;
// R, the rows of a tile, 4, 8 or 16: of those shared memory holds, the one
// with the fewest rounds of tiles over the clusters the card runs at once,
// the fewer rows on a tie (make_plan).
//
// Design, both kernels:
// - Weights on chip. Each CTA stages its share of every layer once, by
//   cp.async from the weights as they are, and keeps it for all D steps and
//   all its tiles. The forward splits each layer's output features over the
//   cluster (CTA c holds columns c*P.. of every layer, P = the slice width
//   rounded up to 4); the backward splits the input features (CTA c holds
//   rows c*P.. of every layer, transposed, so that a step reads them along
//   the rows as the forward does). The head's columns i and i + D are
//   staged side by side ([i][feature][2]) so a step reads them together.
// - Clusters. Where C > 1 each CTA computes its slice of a layer's outputs
//   and writes it into every peer's copy of the activations through
//   distributed shared memory (cluster.map_shared_rank); the cluster then
//   meets before the next layer, so the writes are seen: at the hardware
//   cluster barrier in the forward, whose threads all run the chain; in the
//   backward, where the accumulator warps take no part, at an mbarrier that
//   every CTA's first thread arrives at with release at cluster scope. The
//   grid is persistent: cudaOccupancyMaxActiveClusters clusters (at most
//   the tiles), each walking tiles cid, cid + grid, ...; a one-CTA plan
//   launches without the cluster attribute.
// - Every link on every chain thread: a product of an input of K features
//   with a slice of P columns is split into ks slices of K (ks a power of
//   two, at least 8 features each), P / 4 column groups and R / 4 quads of
//   rows; a thread sums 4 columns x 4 rows over its slice (one 16-byte
//   weight read and one activation read feed 16 FMAs), and the partial sums
//   meet in shared memory, added in a fixed order (part_sum).
// - Activations are feature-major ([feature][row]): one 16-byte read of a
//   feature feeds four rows.
// - The forward keeps the first layer's pre-activation and adds one rank-1
//   term a step, each thread solving y_{i-1} for its rows from the head's
//   sums itself; the head's partial dot products are taken in the last
//   layer's epilogue and summed over the lanes of the same rows, then over
//   warps and CTAs in a fixed order.
// Backward only:
// - Two warp groups. The chain (warps 0-7) runs the reverse chain; the
//   accumulators (warps 8-15) add step t's rank-R updates to the weight and
//   bias gradients of the slices the CTA holds while the chain runs step
//   t + 1. The chain hands each step over through named barriers (full and
//   empty, two slots); it waits on the accumulators only at a step's end.
// - The hidden layers' weight gradients and every bias gradient are summed
//   in shared memory; the first layer's row i and the head's columns i and
//   i + D, touched once a tile, in the cluster's own row of an L2-resident
//   workspace (read, added, written back by the one thread that owns each
//   entry; the reads issued before the step's other updates). A second
//   launch sums the clusters' rows in cluster order.
// - The tape of step t + 1 is copied into a third of a three-slot ring
//   while step t runs: one cp.async.bulk a (layer, row), each issued by its
//   own thread, completing on an mbarrier, where every hidden width is a
//   multiple of 4, else by 4-byte cp.async; rows past the last are zero.
// - Every sum is taken in an order fixed by the shapes and the grid (no
//   floating-point atomics): two calls give bitwise equal results.
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChainThreads = 256;                     // the forward's block, the backward's chain
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kAccThreads = 256;                       // the backward's accumulators
constexpr int kBackwardThreads = kChainThreads + kAccThreads;
constexpr int kMaxLayers = 64;                         // hidden layers + head
constexpr int kMaxCluster = 8;
constexpr int kMinChunk = 8;                           // least input features a K slice sums
constexpr int kSumThreads = 256;
constexpr int kStaticSmem = 9216;                      // bytes counted for the static shared memory
constexpr unsigned kFull = 0xffffffffu;
// named barriers: 0 is __syncthreads; the chain; full and empty, two slots each
constexpr int kBarChain = 1, kBarFull = 2, kBarEmpty = 4;

struct Net {
  const float* w[kMaxLayers];  // (in, out) row-major, mask applied
  const float* b[kMaxLayers];  // (out,); null in the backward
  int width[kMaxLayers + 1];   // width[0] = D, width[n] = 2D
  int n;                       // hidden layers + head
};

// The forward's record of each step (z[l]: (D, N, width[l + 1]); s: (D, N));
// nothing is recorded when s is null.
struct Tape {
  float* z[kMaxLayers];
  float* s;
};

// Where each buffer of a CTA's dynamic shared memory starts, in floats
// (layout() below); every start is a multiple of 4 floats.
struct Offsets {
  int P[kMaxLayers];     // slice width of hidden layer l (l < L), a multiple of 4
  int ks[kMaxLayers];    // K slices of the product that gives hidden layer l (fwd) or delta l - 1 (bwd)
  int w[kMaxLayers + 1]; // staged weights of layer l (0: first, L: head)
  int acc[kMaxLayers];   // bwd: weight-gradient sums of hidden-to-hidden layer l
  int bias[kMaxLayers + 1];  // fwd: staged bias slices; bwd: bias-gradient sums
  int act[kMaxLayers];   // fwd: full activations of layer l (l < L - 1); bwd: the delta of layer l, 2 slots
  int tape[kMaxLayers];  // bwd: layer l's slice within a tape slot ([row][P])
  int tape_slot, tape0, z0, part, xs, ys, hsum, d0, ring, dsum, dsum_acc, total;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int slice_width(int h, int c) { return round4((h + c - 1) / c); }
__host__ __device__ inline int log2up(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// K slices of a product with P columns, K input features and rv quads of
// rows: a power of two, with ks times the column groups (P / 4, rounded up
// to a power of two) times rv at most the chain's threads, and at least
// kMinChunk features a slice.
__host__ __device__ inline int ksplit(int p, int k, int rv) {
  const int g2 = 1 << log2up(p / 4);
  int ks = 1;
  while (2 * ks * g2 * rv <= kChainThreads && 2 * ks * kMinChunk <= k) ks *= 2;
  return ks;
}

// One link of the chain, a K-sliced product and its epilogue, as the
// threads read it at once (four 16-byte reads): the forward's hidden layer
// l (from l - 1), the backward's delta l - 1 (from delta l).
struct __align__(16) Link {
  int P, K, gshift, kshift;    // columns (padded slice), inputs, log2 of the groups' power of two, of ks
  int w, in, out, ks;          // offsets: weights, input, output (-1: none), K slices
  int cnt, c0, in_slot, out_slot;  // this CTA's features of the output and its first; slot strides
  int bias, tape, wout, heads;     // fwd: bias slice, -, output width; bwd: -, tape slice, -; warps with items
};

// A CTA's shared-memory layout at cluster size C and R rows a tile; returns
// its floats.
// Forward: the first layer's columns [D][P0], each hidden-to-hidden layer's
// [width_in][P], the head [D][P_last][2], the bias slices and the head's
// biases, the full activations of every hidden layer but the last, the
// first layer's pre-activation, the K slices' partial sums, the x and y
// tiles, the head's partial sums ([2 slots][C][warp][2][R]).
// Backward: the first layer [D][P0], each hidden-to-hidden layer transposed
// [width_out][P_in], the head [D][P_last][2]; the hidden layers' weight-
// gradient sums, the bias-gradient sums; three tape slots; every delta but
// the first layer's, full width, two slots; the first layer's delta slice,
// two slots; the step's g_mu, g_s and y_i, two slots; the chain's and the
// accumulators' running sums of the first layer's deltas; the x and y
// tiles; the partial sums; the partial sums of y's gradient ([2][C][warp][R]).
__host__ __device__ inline int layout(const int* width, int n, int c, int r, bool backward,
                                      Offsets* o) {
  const int d = width[0], L = n - 1;
  int at = 0;
  for (int l = 0; l < L; ++l) o->P[l] = slice_width(width[l + 1], c);
  if (!backward) {
    o->w[0] = at; at += d * o->P[0];
    for (int l = 1; l < L; ++l) { o->w[l] = at; at += width[l] * o->P[l]; }
    o->w[L] = at; at += 2 * d * o->P[L - 1];
    for (int l = 0; l < L; ++l) { o->bias[l] = at; at += o->P[l]; }
    o->bias[L] = at; at += round4(2 * d);
    for (int l = 0; l + 1 < L; ++l) { o->act[l] = at; at += round4(width[l + 1]) * r; }
    o->z0 = at; at += o->P[0] * r;
    int part = 0;
    for (int l = 1; l < L; ++l) {
      o->ks[l] = ksplit(o->P[l], width[l], r / 4);
      part = imax(part, o->ks[l] * o->P[l] * r);
    }
    o->part = at; at += part;
    o->xs = at; at += d * r;
    o->ys = at; at += d * r;
    o->hsum = at; at += 2 * c * kChainWarps * 2 * r;
  } else {
    o->w[0] = at; at += d * o->P[0];
    for (int l = 1; l < L; ++l) { o->w[l] = at; at += width[l + 1] * o->P[l - 1]; }
    o->w[L] = at; at += 2 * d * o->P[L - 1];
    for (int l = 1; l < L; ++l) { o->acc[l] = at; at += width[l + 1] * o->P[l - 1]; }
    for (int l = 0; l < L; ++l) { o->bias[l] = at; at += o->P[l]; }
    o->bias[L] = at; at += round4(2 * d);
    int slot = 0;
    for (int l = 0; l < L; ++l) { o->tape[l] = slot; slot += o->P[l] * r; }
    o->tape_slot = slot;
    o->tape0 = at; at += 3 * slot;
    for (int l = 1; l < L; ++l) { o->act[l] = at; at += 2 * round4(width[l + 1]) * r; }
    o->d0 = at; at += 2 * o->P[0] * r;
    o->ring = at; at += 2 * 3 * r;
    o->dsum = at; at += o->P[0] * r;
    o->dsum_acc = at; at += o->P[0] * r;
    o->xs = at; at += d * r;
    o->ys = at; at += d * r;
    int part = 0;
    for (int l = 1; l < L; ++l) {
      o->ks[l] = ksplit(o->P[l - 1], width[l + 1], r / 4);
      part = imax(part, o->ks[l] * o->P[l - 1] * r);
    }
    o->part = at; at += part;
    o->hsum = at; at += 2 * c * kChainWarps * r;
  }
  o->total = at;
  return at;
}

bool takes(const int* width, int n) {
  if (n < 2 || n > kMaxLayers || width[0] < 2 || width[n] != 2 * width[0]) return false;
  for (int l = 1; l < n; ++l) {
    if (width[l] < 1) return false;
  }
  return true;
}

struct Plan {
  int cluster, rows, bytes;
};

// The plan at these widths: the least cluster of 1, 2, 4, 8 CTAs whose
// shared memory holds the MADE at 4-row tiles; and of the tiles of 4, 8 and
// 16 rows that shared memory holds, the one with the fewest rounds of tiles
// over the clusters the card runs at once, the fewer rows on a tie (a step
// takes longer at more rows). The clusters the card runs at once are taken
// as SMs / cluster, seven eighths of it past one CTA: clusters are placed
// within a GPC and do not fill every SM. That is a floor of what
// cudaOccupancyMaxActiveClusters, which gives the launch its grid, reads on
// an H100 SXM (132 SMs) at the plans' shared memory: 66 clusters of 2 where
// 7/8 gives 57, 30 of 4 where it gives 28, 15 of 8 where it gives 14 (and
// 264 single CTAs, two an SM, at 112,288 bytes a CTA). cluster = 0
// where no cluster of at most 8 holds the MADE.
Plan make_plan(const int* width, int n, bool backward, int n_rows, int n_sms, int limit) {
  Offsets o;
  for (int c = 1; c <= kMaxCluster; c *= 2) {
    const int slots = c == 1 ? n_sms : (7 * n_sms) / (8 * c);
    Plan best{0, 0, 0};
    long long best_rounds = 0;
    for (int r = 4; r <= 16; r *= 2) {
      const int bytes = layout(width, n, c, r, backward, &o) * 4 + kStaticSmem;
      if (bytes > limit) break;
      const long long tiles = (n_rows + r - 1) / r;
      const long long rounds = (tiles + slots - 1) / (slots > 0 ? slots : 1);
      if (best.cluster == 0 || rounds < best_rounds) {
        best = Plan{c, r, bytes};
        best_rounds = rounds;
      }
    }
    if (best.cluster != 0) return best;
  }
  return Plan{0, 0, 0};
}

// Kernel parameters and the layout, in static shared memory: kernel
// parameters indexed at run time would be copied to local memory.
struct Shared {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* z[kMaxLayers];
  int width[kMaxLayers + 1];
  int c0[kMaxLayers];    // this CTA's first feature of hidden layer l's slice
  int cnt[kMaxLayers];   // the features in it (at most P[l]; 0 past the width)
  int pw[kMaxLayers + 1], pb[kMaxLayers + 1];  // each weight's and bias's offset in the flat gradients
  Offsets o;
  Link link[kMaxLayers];
  int head_warps;        // fwd: warps with head items; bwd: warps with first-layer delta items
  int cnt_sum;           // the features of every hidden layer's slice
};
static_assert(sizeof(Shared) + 64 <= kStaticSmem, "the static shared memory outgrew its bound");

__device__ inline void setup(Shared& S, const Net& P, const Tape& T, int c, int rank, int r,
                             bool backward) {
  for (int l = threadIdx.x; l < P.n; l += blockDim.x) {
    S.w[l] = P.w[l];
    S.b[l] = P.b[l];
    S.z[l] = T.z[l];
  }
  for (int l = threadIdx.x; l <= P.n; l += blockDim.x) S.width[l] = P.width[l];
  __syncthreads();
  if (threadIdx.x == 0) {
    layout(S.width, P.n, c, r, backward, &S.o);
    S.cnt_sum = 0;
    for (int l = 0; l + 1 < P.n; ++l) {
      S.c0[l] = rank * S.o.P[l];
      const int left = S.width[l + 1] - S.c0[l];
      S.cnt[l] = left < 0 ? 0 : (left < S.o.P[l] ? left : S.o.P[l]);
      S.cnt_sum += S.cnt[l];
    }
    int at = 0;
    for (int l = 0; l < P.n; ++l) { S.pw[l] = at; at += S.width[l] * S.width[l + 1]; }
    for (int l = 0; l < P.n; ++l) { S.pb[l] = at; at += S.width[l + 1]; }
    const Offsets& o = S.o;
    const int L = P.n - 1;
    for (int l = 1; l < L; ++l) {
      Link& k = S.link[l];
      // fwd: layer l's slice from layer l - 1 in full; bwd: delta l - 1's
      // slice from delta l in full
      const int out = backward ? l - 1 : l;
      k.P = o.P[out];
      k.K = backward ? S.width[l + 1] : S.width[l];
      k.gshift = log2up(k.P / 4);
      k.ks = o.ks[l];
      k.kshift = log2up(k.ks);
      k.w = o.w[l];
      k.in = backward ? o.act[l] : o.act[l - 1];
      k.out = backward ? (l > 1 ? o.act[l - 1] : -1) : (l < L - 1 ? o.act[l] : -1);
      k.cnt = S.cnt[out];
      k.c0 = S.c0[out];
      k.in_slot = backward ? round4(S.width[l + 1]) * r : 0;
      k.out_slot = backward ? round4(S.width[l]) * r : 0;
      k.bias = backward ? 0 : o.bias[l];
      k.tape = backward ? o.tape[l - 1] : 0;
      k.wout = S.width[out + 1];
      k.heads = 0;
    }
    const int items = (backward ? o.P[0] : o.P[L - 1]) * (r / 4);
    S.head_warps = imin((items + 31) / 32, kChainWarps);
  }
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void copy4_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ inline void copy16_async(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ inline void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ inline void chain_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarChain), "n"(kChainThreads) : "memory");
}

__device__ inline void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kBackwardThreads) : "memory");
}

__device__ inline void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kBackwardThreads) : "memory");
}

__device__ inline void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// One arrival, with release at cluster scope, at the mbarrier `bar` of the
// cluster's CTA `rank`.
__device__ inline void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

__device__ inline void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ inline void bulk_copy(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The backward chain's threads of every CTA of the cluster meet: a barrier
// of the CTA's chain, then its first thread arrives, with release at
// cluster scope, at every CTA's mbarrier (C arrivals complete a phase), and
// the chain waits for its own mbarrier's phase with acquire. What a CTA
// wrote into its peers' shared memory before the barrier is seen after it.
// The accumulator warps take no part (the hardware cluster barrier would
// hold them to the chain's pace).
struct ChainSync {
  uint64_t* bar;
  unsigned phase;
  int c;
  __device__ inline void operator()() {
    chain_bar();
    if (c > 1) {
      if (threadIdx.x == 0) {
        for (int k = 0; k < c; ++k) mbar_arrive_cluster(bar, k);
      }
      mbar_wait_cluster(bar, phase);
      phase ^= 1u;
    }
  }
};

// v stored at `local` in this CTA and at the same place in every peer.
__device__ inline void put4(cg::cluster_group& cluster, float* local, const float4& v, int c) {
  if (c == 1) {
    *reinterpret_cast<float4*>(local) = v;
    return;
  }
  for (int k = 0; k < c; ++k) *reinterpret_cast<float4*>(cluster.map_shared_rank(local, k)) = v;
}

__device__ inline void fma4(float4& acc, const float4& a, float w) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
}

__device__ inline float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ inline float4 mul4(const float4& a, const float4& b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ inline float4 relu4(const float4& v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// jnp.maximum(z, 0)'s slope: 1 above 0, 1/2 at the tie, 0 below.
__device__ inline float slope(float z) { return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f); }

__device__ inline float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// dst[r * ld + c] = src[r * gs + c] for r < rows, c < cols, and 0 for
// cols <= c < ld, by cp.async (16 bytes where aligned).
__device__ inline void stage_rows(float* dst, int ld, const float* src, int gs, int rows, int cols,
                                  int tid, int threads) {
  const int q = ld / 4;
  const bool vec = (gs & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int u = tid; u < rows * q; u += threads) {
    const int r = u / q, c = (u % q) * 4;
    float* dp = dst + r * ld + c;
    const float* sp = src + (size_t)r * gs + c;
    if (vec && c + 4 <= cols) {
      copy16_async(dp, sp);
    } else {
      for (int e = 0; e < 4; ++e) {
        if (c + e < cols) copy4_async(dp + e, sp + e);
        else dp[e] = 0.f;
      }
    }
  }
}

// dst[j * ld + k] = src[k * gs + j] for j < rows, k < cols, and 0 for
// cols <= k < ld (a transposed slice), by 4-byte cp.async.
__device__ inline void stage_cols(float* dst, int ld, const float* src, int gs, int rows, int cols,
                                  int tid, int threads) {
  for (int u = tid; u < ld * rows; u += threads) {
    const int k = u / rows, j = u % rows;
    float* dp = dst + j * ld + k;
    if (k < cols) copy4_async(dp, src + (size_t)k * gs + j);
    else *dp = 0.f;
  }
}

// The head's columns i and i + d for features c0.. (cnt of them), as
// dst[(i * ld + k) * 2 + e] = head[(c0 + k) * 2d + i + e * d]; 0 past cnt.
__device__ inline void stage_head(float* dst, int ld, const float* head, int d, int c0, int cnt,
                                  int tid, int threads) {
  for (int u = tid; u < d * ld * 2; u += threads) {
    const int e = u & 1, k = (u >> 1) % ld, i = (u >> 1) / ld;
    if (k < cnt) copy4_async(dst + u, head + (size_t)(c0 + k) * 2 * d + i + e * d);
    else dst[u] = 0.f;
  }
}

// One K-sliced product over the chain's threads: thread (g, v, s), g <
// P / 4, v < R / 4, s < ks, sums in[k][4v..4v+3] * M[k][4g..4g+3] over its
// slice of k < K into part[s][col][R] (a thread takes several where there
// are more than the chain's threads; then ks is 1).
template <int R>
__device__ inline void product(const float* __restrict__ in, const float* __restrict__ M,
                               const Link& lk, float* __restrict__ part) {
  constexpr int RV = R / 4;
  const int groups = lk.P / 4, gmask = (1 << lk.gshift) - 1, P = lk.P;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  for (int gs = threadIdx.x; gs < ((lk.ks * RV) << lk.gshift); gs += kChainThreads) {
    const int g = gs & gmask, v = (gs >> lk.gshift) & (RV - 1), s = (gs >> lk.gshift) / RV;
    if (g >= groups) continue;
    const int k0 = (s * lk.K) >> lk.kshift, k1 = ((s + 1) * lk.K) >> lk.kshift;
    float4 acc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* m4 = reinterpret_cast<const float4*>(M) + g;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 w = m4[k * groups];
      const float4 a = in4[k * RV + v];
      fma4(acc[0], a, w.x);
      fma4(acc[1], a, w.y);
      fma4(acc[2], a, w.z);
      fma4(acc[3], a, w.w);
    }
    float4* p4 = reinterpret_cast<float4*>(part) + (s * P + 4 * g) * RV + v;
#pragma unroll
    for (int c = 0; c < 4; ++c) p4[c * RV] = acc[c];
  }
}

// The K slices' partial sums at column col, rows 4v..4v+3: the even and
// the odd slices each in order, then the two (ks a power of two; the
// usual counts unrolled, so that every read is issued at once).
template <int KS>
__device__ inline float4 part_sum_n(const float4* p4, int stride) {
  float4 a = p4[0], b = p4[stride];
#pragma unroll
  for (int k = 2; k < KS; k += 2) {
    a = add4(a, p4[k * stride]);
    b = add4(b, p4[(k + 1) * stride]);
  }
  return add4(a, b);
}

template <int R>
__device__ inline float4 part_sum(const float* part, int col, int v, const Link& lk) {
  constexpr int RV = R / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part) + col * RV + v;
  const int stride = lk.P * RV;
  switch (lk.ks) {
    case 1: return p4[0];
    case 2: return part_sum_n<2>(p4, stride);
    case 4: return part_sum_n<4>(p4, stride);
    case 8: return part_sum_n<8>(p4, stride);
    case 16: return part_sum_n<16>(p4, stride);
    default: {
      float4 a = p4[0], b = p4[stride];
      for (int k = 2; k < lk.ks; k += 2) {
        a = add4(a, p4[k * stride]);
        b = add4(b, p4[(k + 1) * stride]);
      }
      return add4(a, b);
    }
  }
}

// Sums over the warp's lanes that agree with this lane below `low` (a power
// of two, at most 4) of the N values v (N = 4 or 8), transposed: halving
// exchanges at offsets 16, 8 (and 4) leave each lane one value, v[0], whose
// index it returns; then plain exchanges down to `low`. A lane whose bits
// below 32 / N are under `low` holds a distinct sum.
template <int N>
__device__ inline int warp_sum_t(float (&v)[N], int low) {
  const int lane = threadIdx.x & 31;
  int idx = 0, off = 16;
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = up ? v[j] : v[j + h];
      const float keep = up ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
    idx = 2 * idx + (up ? 1 : 0);
    off /= 2;
  }
  for (; off >= low; off /= 2) v[0] += __shfl_xor_sync(kFull, v[0], off);
  return idx;
}

template <int R>
__global__ void __launch_bounds__(kChainThreads)
general_forward_kernel(const float* __restrict__ x, Net P, Tape T, int n_rows, int sign,
                       float s_bound, float* __restrict__ y_out, float* __restrict__ ld_out) {
  constexpr int RV = R / 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  setup(S, P, T, C, rank, R, false);
  __syncthreads();
  const Offsets& o = S.o;
  const int n = P.n, L = n - 1, d = S.width[0];
  const bool record = T.s != nullptr;

  // this CTA's columns of every layer, the head's rows, the biases
  stage_rows(smem + o.w[0], o.P[0], S.w[0] + S.c0[0], S.width[1], d, S.cnt[0], tid, kChainThreads);
  for (int l = 1; l < L; ++l)
    stage_rows(smem + o.w[l], o.P[l], S.w[l] + S.c0[l], S.width[l + 1], S.width[l], S.cnt[l], tid,
               kChainThreads);
  stage_head(smem + o.w[L], o.P[L - 1], S.w[L], d, S.c0[L - 1], S.cnt[L - 1], tid, kChainThreads);
  for (int l = 0; l < L; ++l)
    stage_rows(smem + o.bias[l], o.P[l], S.b[l] + S.c0[l], 0, 1, S.cnt[l], tid, kChainThreads);
  for (int u = tid; u < 2 * d; u += kChainThreads) copy4_async(smem + o.bias[L] + u, S.b[L] + u);
  // and the first tile's x
  const int n_tiles = (n_rows + R - 1) / R;
  const int cid = blockIdx.x / C, grid = gridDim.x / C;
  auto load_x = [&](int tile) {
    for (int u = tid; u < d * R; u += kChainThreads) {
      const int c = u / R, row = tile * R + u % R;
      if (row < n_rows) copy4_async(smem + o.xs + u, x + (size_t)row * d + c);
      else smem[o.xs + u] = 0.f;
    }
  };
  if (cid < n_tiles) load_x(cid);
  copy_wait();
  __syncthreads();

  float* z0 = smem + o.z0;
  float* xs = smem + o.xs;
  float* ys = smem + o.ys;
  float* part = smem + o.part;
  const float* W0 = smem + o.w[0];
  const float* Hs = smem + o.w[L];
  const float* bh = smem + o.bias[L];
  // the threads of every CTA of the cluster meet (all run the chain): what a
  // CTA wrote into its peers' shared memory before is seen after
  auto sync = [&]() {
    if (C > 1) cluster_barrier();
    else chain_bar();
  };
  const int hw = S.head_warps;
  int step = 0;  // this cluster's steps so far, for the head sums' two slots
  // y_j for rows 4v..4v+3 from step j's head sums (slot `slot`): mu and the
  // raw s summed over the CTAs and warps in order after the head's biases;
  // the raw s returned in s_raw, the bounded one in s_out
  auto solve_y = [&](int j, int v, int slot, float4& s_raw, float4& s_out) {
    float4 mu = make_float4(bh[j], bh[j], bh[j], bh[j]);
    float4 s = make_float4(bh[j + d], bh[j + d], bh[j + d], bh[j + d]);
    const float* hs = smem + o.hsum + slot * C * kChainWarps * 2 * R + 4 * v;
    for (int c = 0; c < C; ++c) {
      for (int w = 0; w < hw; ++w) {
        const float* h = hs + (c * kChainWarps + w) * 2 * R;
        mu = add4(mu, *reinterpret_cast<const float4*>(h));
        s = add4(s, *reinterpret_cast<const float4*>(h + R));
      }
    }
    s_raw = s;
    if (s_bound > 0.f) {
      s.x = s_bound * tanhf(s.x / s_bound);
      s.y = s_bound * tanhf(s.y / s_bound);
      s.z = s_bound * tanhf(s.z / s_bound);
      s.w = s_bound * tanhf(s.w / s_bound);
    }
    s_out = s;
    const float4 xv = reinterpret_cast<const float4*>(xs)[j * RV + v];
    if (sign < 0)
      return make_float4((xv.x - mu.x) * expf(-s.x), (xv.y - mu.y) * expf(-s.y),
                         (xv.z - mu.z) * expf(-s.z), (xv.w - mu.w) * expf(-s.w));
    return make_float4(xv.x * expf(s.x) + mu.x, xv.y * expf(s.y) + mu.y,
                       xv.z * expf(s.z) + mu.z, xv.w * expf(s.w) + mu.w);
  };
  for (int tile = cid; tile < n_tiles; tile += grid) {
    const int row0 = tile * R;
    if (tile != cid) {
      load_x(tile);
      copy_wait();
    }
    for (int u = tid; u < o.P[0] * R; u += kChainThreads) z0[u] = smem[o.bias[0] + u / R];
    // thread v < RV keeps the log-det of rows 4v..4v+3, writes their y_j and
    // records their raw s_j
    float4 ld = make_float4(0.f, 0.f, 0.f, 0.f);
    auto keep = [&](int j, int v, const float4& y, const float4& s_raw, const float4& s) {
      reinterpret_cast<float4*>(ys)[j * RV + v] = y;
      ld = sign < 0 ? make_float4(ld.x - s.x, ld.y - s.y, ld.z - s.z, ld.w - s.w) : add4(ld, s);
      if (record && rank == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + 4 * v + q;
          if (row < n_rows) T.s[(size_t)j * n_rows + row] = comp(s_raw, q);
        }
      }
    };
    chain_bar();
    for (int i = 0; i < d; ++i, ++step) {
      const int slot = step & 1;
      float4 pm = make_float4(0.f, 0.f, 0.f, 0.f), ps = pm;  // the head's partial sums

      // the last hidden layer's epilogue: its outputs, times the head's
      // columns i and i + d, into this thread's partial sums
      auto to_head = [&](int col, const float4& h) {
        const float2 w = reinterpret_cast<const float2*>(Hs)[i * o.P[L - 1] + col];
        fma4(pm, h, w.x);
        fma4(ps, h, w.y);
      };
      // first layer: y gained feature i - 1 in the last step (each thread
      // solves it for its rows from the last step's head sums), so its
      // pre-activation gains one rank-1 term, y_{i-1} * W0[i-1, :]
      {
        const int p0 = o.P[0], c0 = S.c0[0], w1 = S.width[1], cnt0 = S.cnt[0];
        float4* z4 = reinterpret_cast<float4*>(z0);
        for (int u = tid; u < p0 * RV; u += kChainThreads) {
          const int col = u / RV, v = u % RV;
          float4 z = z4[u];
          if (i > 0) {
            float4 s_raw, s;
            const float4 y = solve_y(i - 1, v, slot ^ 1, s_raw, s);
            if (col == 0) keep(i - 1, v, y, s_raw, s);
            fma4(z, y, W0[(i - 1) * p0 + col]);
            z4[u] = z;
          }
          if (col < cnt0) {
            if (record) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = row0 + 4 * v + q;
                if (row < n_rows) S.z[0][((size_t)i * n_rows + row) * w1 + c0 + col] = comp(z, q);
              }
            }
            if (L > 1) put4(cluster, smem + o.act[0] + (c0 + col) * R + 4 * v, relu4(z), C);
            else to_head(col, relu4(z));
          }
        }
      }
      if (L > 1) sync();

      for (int l = 1; l < L; ++l) {
        const Link lk = S.link[l];
        product<R>(smem + lk.in, smem + lk.w, lk, part);
        chain_bar();
        const float* b = smem + lk.bias;
        float* tape = record ? S.z[l] : nullptr;
        for (int u = tid; u < lk.P * RV; u += kChainThreads) {
          const int col = u / RV, v = u % RV;
          if (col >= lk.cnt) continue;
          float4 z = part_sum<R>(part, col, v, lk);
          const float bj = b[col];
          z = make_float4(z.x + bj, z.y + bj, z.z + bj, z.w + bj);
          if (tape != nullptr) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = row0 + 4 * v + q;
              if (row < n_rows) tape[((size_t)i * n_rows + row) * lk.wout + lk.c0 + col] = comp(z, q);
            }
          }
          if (lk.out >= 0) put4(cluster, smem + lk.out + (lk.c0 + col) * R + 4 * v, relu4(z), C);
          else to_head(col, relu4(z));
        }
        if (lk.out >= 0) sync();
      }

      // the head's partial sums: over the warp's lanes of the same rows
      // (transposed: a lane ends with one of its 8 sums), then each warp's
      // into every CTA's slot; only the warps that had items
      if (warp < hw) {
        float v8[8] = {pm.x, pm.y, pm.z, pm.w, ps.x, ps.y, ps.z, ps.w};
        const int idx = warp_sum_t<8>(v8, RV);
        if ((lane & 3) < RV) {
          const int row = 4 * (lane & (RV - 1)) + (idx & 3);
          float* hs = smem + o.hsum + ((slot * C + rank) * kChainWarps + warp) * 2 * R +
                      (idx >> 2) * R + row;
          if (C == 1) *hs = v8[0];
          else for (int k = 0; k < C; ++k) *cluster.map_shared_rank(hs, k) = v8[0];
        }
      }
      sync();
    }
    // the last feature's y, then the tile's y and log-det out
    if (tid < RV) {
      float4 s_raw, s;
      const float4 y = solve_y(d - 1, tid, (step - 1) & 1, s_raw, s);
      keep(d - 1, tid, y, s_raw, s);
    }
    chain_bar();
    if (rank == 0) {
      for (int u = tid; u < d * R; u += kChainThreads) {
        const int c = u % d, r = u / d;
        if (row0 + r < n_rows) y_out[(size_t)(row0 + r) * d + c] = ys[c * R + r];
      }
      if (tid < RV) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + 4 * tid + q;
          if (row < n_rows) ld_out[row] = comp(ld, q);
        }
      }
    }
    chain_bar();
  }
  if (C > 1) cluster.sync();  // no CTA leaves while a peer may still write to it
}

template <int R>
__global__ void __launch_bounds__(kBackwardThreads, 1)
general_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ gy, const float* __restrict__ gld, Net P,
                        Tape T, int n_rows, int sign, float s_bound, float* __restrict__ gx,
                        float* __restrict__ work, int n_params, int bulk) {
  constexpr int RV = R / 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  __shared__ uint64_t cbar, tbar[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  setup(S, P, T, C, rank, R, true);
  if (tid == 0) {
    if (C > 1) mbar_init(&cbar, C);
    for (int k = 0; k < 3; ++k) mbar_init(&tbar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Offsets& o = S.o;
  const int n = P.n, L = n - 1, d = S.width[0];

  // this CTA's rows of every layer: the first layer's columns [D][P0], the
  // hidden-to-hidden layers transposed, the head; every sum and the tape
  // ring to 0
  stage_rows(smem + o.w[0], o.P[0], S.w[0] + S.c0[0], S.width[1], d, S.cnt[0], tid,
             kBackwardThreads);
  for (int l = 1; l < L; ++l)
    stage_cols(smem + o.w[l], o.P[l - 1], S.w[l] + (size_t)S.c0[l - 1] * S.width[l + 1],
               S.width[l + 1], S.width[l + 1], S.cnt[l - 1], tid, kBackwardThreads);
  stage_head(smem + o.w[L], o.P[L - 1], S.w[L], d, S.c0[L - 1], S.cnt[L - 1], tid,
             kBackwardThreads);
  {
    const int a0 = L > 1 ? o.acc[1] : o.bias[0];
    for (int u = a0 + tid; u < o.tape0 + 3 * o.tape_slot; u += kBackwardThreads) smem[u] = 0.f;
  }
  // and the first tile's x and y
  const int n_tiles = (n_rows + R - 1) / R;
  const int cid = blockIdx.x / C, grid = gridDim.x / C;
  auto load_xy = [&](int tile, int t0, int threads) {
    for (int u = t0; u < d * R; u += threads) {
      const int c = u / R, row = tile * R + u % R;
      if (row < n_rows) {
        copy4_async(smem + o.xs + u, x + (size_t)row * d + c);
        copy4_async(smem + o.ys + u, y + (size_t)row * d + c);
      } else {
        smem[o.xs + u] = smem[o.ys + u] = 0.f;
      }
    }
  };
  if (cid < n_tiles) load_xy(cid, tid, kBackwardThreads);
  fence_proxy_async();  // the tape ring's zeros before any bulk copy into it
  copy_wait();
  __syncthreads();
  if (C > 1) cluster.sync();  // every peer's mbarrier is initialised

  const int my_tiles = cid < n_tiles ? (n_tiles - cid + grid - 1) / grid : 0;
  const int steps = my_tiles * d;
  float* tz = smem + o.tape0;
  float* ring = smem + o.ring;  // [slot][g_mu, g_s, y_i][R]
  float* d0 = smem + o.d0;
  float* wrow = work + (size_t)cid * n_params;

  // step t's tape (tile cid + (t / d) * grid, feature d - 1 - t % d) into
  // slot t % 3, by the accumulator warps (thread a of them): one bulk copy
  // a (layer, row), each by its own thread, thread 0 arriving with the
  // step's byte count; or 4-byte cp.async, which they wait for before they
  // hand the step back
  auto tape_issue = [&](int t, int a) {
    const int row0 = (cid + (t / d) * grid) * R, i = d - 1 - t % d;
    float* dst = tz + (t % 3) * o.tape_slot;
    if (bulk) {
      const int rows = imin(R, n_rows - row0);
      if (a == 0) mbar_expect_tx(&tbar[t % 3], 4u * rows * S.cnt_sum);
      for (int u = a; u < L * R; u += kAccThreads) {
        const int l = u / R, r = u % R;
        if (r < rows && S.cnt[l] > 0) {
          fence_proxy_async();
          bulk_copy(dst + o.tape[l] + r * o.P[l],
                    S.z[l] + ((size_t)i * n_rows + row0 + r) * S.width[l + 1] + S.c0[l],
                    4u * S.cnt[l], &tbar[t % 3]);
        }
      }
      if (row0 + R > n_rows) {  // the last tile: rows past the end are 0
        for (int l = 0; l < L; ++l) {
          const int lo = (n_rows - row0) * o.P[l];
          for (int u = lo + a; u < R * o.P[l]; u += kAccThreads) dst[o.tape[l] + u] = 0.f;
        }
      }
    } else {
      for (int l = 0; l < L; ++l) {
        const int p = o.P[l];
        for (int u = a; u < R * p; u += kAccThreads) {
          const int r = u / p, k = u % p, row = row0 + r;
          float* dp = dst + o.tape[l] + u;
          if (row < n_rows && k < S.cnt[l])
            copy4_async(dp, S.z[l] + ((size_t)i * n_rows + row) * S.width[l + 1] + S.c0[l] + k);
          else
            *dp = 0.f;
        }
      }
    }
  };
  // the first two steps' tapes, before either group starts
  if (tid >= kChainThreads) {
    for (int t = 0; t < imin(2, steps); ++t) tape_issue(t, tid - kChainThreads);
    copy_wait();
  }
  __syncthreads();

  if (tid < kChainThreads) {
    // ---- the reverse chain ----
    const int lane = tid % 32, warp = tid / 32;
    float* xs = smem + o.xs;
    float* ys = smem + o.ys;
    float* dsum = smem + o.dsum;
    float* part = smem + o.part;
    const float* W0 = smem + o.w[0];
    const float* Hs = smem + o.w[L];
    const int gw = S.head_warps;
    ChainSync sync{&cbar, 0u, C};

    // step t's tape has landed (bulk copies: its mbarrier; cp.async: the
    // accumulators waited for theirs before handing step t - 2 back)
    auto tape_wait = [&](int t) {
      if (bulk) mbar_wait(&tbar[t % 3], (unsigned)((t / 3) & 1));
    };
    // thread r < R's gy and raw log-scale of step t, one step ahead
    auto scalars = [&](int t, float& g, float& sr) {
      const int row = (cid + (t / d) * grid) * R + tid, i = d - 1 - t % d;
      const bool in = tid < R && row < n_rows;
      g = in ? gy[(size_t)row * d + i] : 0.f;
      sr = in ? T.s[(size_t)i * n_rows + row] : 0.f;
    };

    float g_next = 0.f, s_next = 0.f;
    if (steps > 0) scalars(0, g_next, s_next);
    int t = 0;
    for (int tile = cid; tile < n_tiles; tile += grid) {
      const int row0 = tile * R;
      if (tile != cid) {
        load_xy(tile, tid, kChainThreads);
        copy_wait();
      }
      for (int u = tid; u < o.P[0] * R; u += kChainThreads) dsum[u] = 0.f;
      const float glr = tid < R && row0 + tid < n_rows ? gld[row0 + tid] : 0.f;
      chain_bar();
      for (int i = d - 1; i >= 0; --i, ++t) {
        const int s2 = t & 1, s3 = t % 3;
        float* rs = ring + s2 * 3 * R;
        const float* zs = tz + s3 * o.tape_slot;
        // y's gradient at feature i: gy_i plus what the first layer of every
        // later step sent back (the CTAs' and warps' partial sums of W0[i, :]
        // . dsum, in order); then the head's two gradients
        if (tid < R) {
          const int r = tid, row = row0 + r;
          float g = g_next;
          const float sraw = s_next;
          if (i < d - 1) {
            const float* gp = smem + o.hsum + s2 * C * kChainWarps * R;
            for (int c = 0; c < C; ++c) {
              for (int w = 0; w < gw; ++w) g += gp[(c * kChainWarps + w) * R + r];
            }
          }
          float s = sraw, ds = 1.f;
          if (s_bound > 0.f) {
            const float th = tanhf(sraw / s_bound);
            s = s_bound * th;
            ds = 1.f - th * th;
          }
          float gmu, gs, gxi;
          if (sign < 0) {
            gxi = g * expf(-s);
            gmu = -gxi;
            gs = -g * ys[i * R + r] - glr;
          } else {
            const float e = expf(s);
            gxi = g * e;
            gmu = g;
            gs = g * xs[i * R + r] * e + glr;
          }
          if (rank == 0 && row < n_rows) gx[(size_t)row * d + i] = gxi;
          rs[r] = gmu;
          rs[R + r] = gs * ds;
          rs[2 * R + r] = ys[i * R + r];
        }
        if (t + 1 < steps) scalars(t + 1, g_next, s_next);
        tape_wait(t);
        chain_bar();

        // the first layer's delta slice, from the product that reached it:
        // it joins dsum, and W0[i - 1, :] . dsum goes to every CTA for the
        // next step
        float4 pg = make_float4(0.f, 0.f, 0.f, 0.f);
        auto first_delta = [&](int col, int v, const float4& dl) {
          reinterpret_cast<float4*>(d0 + s2 * o.P[0] * R)[col * RV + v] = dl;
          float4* ds4 = reinterpret_cast<float4*>(dsum) + col * RV + v;
          const float4 sum = add4(*ds4, dl);
          *ds4 = sum;
          if (i > 0) fma4(pg, sum, W0[(i - 1) * o.P[0] + col]);
        };
        auto slopes = [&](const float* z, int p, int col, int v) {
          return make_float4(slope(z[(4 * v) * p + col]), slope(z[(4 * v + 1) * p + col]),
                             slope(z[(4 * v + 2) * p + col]), slope(z[(4 * v + 3) * p + col]));
        };

        // the last hidden layer's delta through head columns i and i + d
        {
          const int p = o.P[L - 1], c0 = S.c0[L - 1];
          for (int u = tid; u < p * RV; u += kChainThreads) {
            const int col = u / RV, v = u % RV;
            const float4 gmu = reinterpret_cast<const float4*>(rs)[v];
            const float4 gsv = reinterpret_cast<const float4*>(rs + R)[v];
            const float2 w = reinterpret_cast<const float2*>(Hs)[i * p + col];
            float4 dl = make_float4(0.f, 0.f, 0.f, 0.f);
            fma4(dl, gmu, w.x);
            fma4(dl, gsv, w.y);
            dl = mul4(dl, slopes(zs + o.tape[L - 1], p, col, v));
            if (L > 1) {
              if (col < S.cnt[L - 1])
                put4(cluster, smem + o.act[L - 1] + (s2 * round4(S.width[L]) + c0 + col) * R + 4 * v,
                     dl, C);
            } else {
              first_delta(col, v, dl);
            }
          }
        }
        if (L > 1) sync();

        // down the hidden layers: layer l's delta (full width, in every
        // CTA) through this CTA's rows of W_l to its slice of layer l - 1's
#pragma unroll 1
        for (int l = L - 1; l >= 1; --l) {
          const Link lk = S.link[l];
          product<R>(smem + lk.in + s2 * lk.in_slot, smem + lk.w, lk, part);
          chain_bar();
          for (int u = tid; u < lk.P * RV; u += kChainThreads) {
            const int col = u / RV, v = u % RV;
            const float4 dl =
                mul4(part_sum<R>(part, col, v, lk), slopes(zs + lk.tape, lk.P, col, v));
            if (lk.out >= 0) {
              if (col < lk.cnt)
                put4(cluster, smem + lk.out + s2 * lk.out_slot + (lk.c0 + col) * R + 4 * v, dl, C);
            } else {
              first_delta(col, v, dl);
            }
          }
          if (lk.out >= 0) sync();
        }

        // W0[i - 1, :] . dsum over the warp's lanes of the same rows
        // (transposed), each warp's into every CTA's slot for the next step;
        // only the warps that had items
        if (i > 0 && warp < gw) {
          float v4[4] = {pg.x, pg.y, pg.z, pg.w};
          const int idx = warp_sum_t<4>(v4, RV);
          if ((lane & 7) < RV) {
            float* gp = smem + o.hsum + ((((t + 1) & 1) * C + rank) * kChainWarps + warp) * R +
                        4 * (lane & (RV - 1)) + idx;
            if (C == 1) *gp = v4[0];
            else for (int k = 0; k < C; ++k) *cluster.map_shared_rank(gp, k) = v4[0];
          }
        }
        bar_arrive(kBarFull + s2);                    // step t is the accumulators'
        if (t >= 1) bar_sync(kBarEmpty + ((t - 1) & 1));  // they are done with step t - 1
        sync();
      }
    }
    if (steps > 0) bar_sync(kBarEmpty + ((steps - 1) & 1));
  } else {
    // ---- the accumulators: step t's updates while the chain runs t + 1 ----
    const int a = tid - kChainThreads;
    float* dsa = smem + o.dsum_acc;
    const int p0 = o.P[0], pl = o.P[L - 1], w1 = S.width[1];
    for (int t = 0; t < steps; ++t) {
      const int s2 = t & 1, i = d - 1 - t % d;
      const bool first = t < d;  // the cluster's first tile writes its workspace row
      bar_sync(kBarFull + s2);
      // slot (t + 2) % 3 was step t - 1's: the chain and these warps are done
      // with it
      if (t + 2 < steps) tape_issue(t + 2, a);
      const float* rs = ring + s2 * 3 * R;
      const float* zs = tz + (t % 3) * o.tape_slot;
      const float* dl0 = d0 + s2 * p0 * R;
      // the workspace entries this thread adds to (row i of the first
      // layer's gradient, head columns i and i + d), their old values
      // loaded first, so that the loads fly while the rest runs
      float old_w[2] = {0.f, 0.f}, old_m[2] = {0.f, 0.f}, old_s[2] = {0.f, 0.f};
      if (!first) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int col = a + m * kAccThreads;
          if (col < S.cnt[0]) old_w[m] = wrow[(size_t)i * w1 + S.c0[0] + col];
          if (col < S.cnt[L - 1]) {
            const float* e = wrow + S.pw[L] + (size_t)(S.c0[L - 1] + col) * 2 * d + i;
            old_m[m] = e[0];
            old_s[m] = e[d];
          }
        }
      }
      // the hidden-to-hidden layers: W_l's rows that this CTA holds gain
      // relu(z[l - 1]) x delta_l over the tile's rows; a thread keeps one
      // quad of relu(z[l - 1]) for all its rows of W_l. Biases of layer l.
      for (int l = 1; l < L; ++l) {
        const int p = o.P[l - 1], q4 = p / 4, wl = S.width[l + 1];
        const int qshift = log2up(q4), q2 = 1 << qshift;
        const int jstep = q2 >= kAccThreads ? 1 : kAccThreads >> qshift;
        const float4* dl4 = reinterpret_cast<const float4*>(smem + o.act[l] + s2 * round4(wl) * R);
        const float4* h4 = reinterpret_cast<const float4*>(zs + o.tape[l - 1]);
        float4* acc4 = reinterpret_cast<float4*>(smem + o.acc[l]);
        for (int it = a; it < q2 * jstep; it += kAccThreads) {
          const int q = it & (q2 - 1);
          if (q >= q4) continue;
          float4 h[R];
#pragma unroll
          for (int r = 0; r < R; ++r) h[r] = relu4(h4[r * q4 + q]);
          for (int j = it >> qshift; j < wl; j += jstep) {
            float4 acc = acc4[j * q4 + q];
#pragma unroll
            for (int v = 0; v < R / 4; ++v) {
              const float4 dv = dl4[j * (R / 4) + v];
              fma4(acc, h[4 * v], dv.x);
              fma4(acc, h[4 * v + 1], dv.y);
              fma4(acc, h[4 * v + 2], dv.z);
              fma4(acc, h[4 * v + 3], dv.w);
            }
            acc4[j * q4 + q] = acc;
          }
        }
        const float* dl = smem + o.act[l] + s2 * round4(wl) * R;
        for (int col = a; col < S.cnt[l]; col += kAccThreads) {
          float bsum = 0.f;
          for (int r = 0; r < R; ++r) bsum += dl[(S.c0[l] + col) * R + r];
          smem[o.bias[l] + col] += bsum;
        }
      }
      // the first layer: row i of its weight gradient, sum over rows of y_i
      // times dsum (the later steps' deltas), before step i's delta joins;
      // its bias gradient
      for (int col = a, m = 0; col < p0; col += kAccThreads, ++m) {
        float* sa = dsa + col * R;
        float v = 0.f, bsum = 0.f;
        if (i == d - 1) {
          for (int r = 0; r < R; ++r) sa[r] = 0.f;
        }
        for (int r = 0; r < R; ++r) {
          v = fmaf(rs[2 * R + r], sa[r], v);
          const float dv = dl0[col * R + r];
          sa[r] += dv;
          bsum += dv;
        }
        smem[o.bias[0] + col] += bsum;
        if (col < S.cnt[0]) {
          float* e = wrow + (size_t)i * w1 + S.c0[0] + col;
          *e = first ? v : (m < 2 ? (m == 0 ? old_w[0] : old_w[1]) : *e) + v;
        }
      }
      // the head: columns i and i + d of the rows this CTA holds, and (CTA
      // 0) its biases i and i + d
      {
        const float* z = zs + o.tape[L - 1];
        for (int col = a, m = 0; col < pl; col += kAccThreads, ++m) {
          float mu = 0.f, s = 0.f;
          for (int r = 0; r < R; ++r) {
            const float h = fmaxf(z[r * pl + col], 0.f);
            mu = fmaf(h, rs[r], mu);
            s = fmaf(h, rs[R + r], s);
          }
          if (col < S.cnt[L - 1]) {
            float* e = wrow + S.pw[L] + (size_t)(S.c0[L - 1] + col) * 2 * d + i;
            const float om = m < 2 ? (m == 0 ? old_m[0] : old_m[1]) : e[0];
            const float os = m < 2 ? (m == 0 ? old_s[0] : old_s[1]) : e[d];
            e[0] = first ? mu : om + mu;
            e[d] = first ? s : os + s;
          }
        }
        if (rank == 0 && a == 0) {
          float mu = 0.f, s = 0.f;
          for (int r = 0; r < R; ++r) {
            mu += rs[r];
            s += rs[R + r];
          }
          smem[o.bias[L] + i] += mu;
          smem[o.bias[L] + i + d] += s;
        }
      }
      copy_wait();
      bar_arrive(kBarEmpty + s2);
    }
  }

  // this CTA's partial sums into its cluster's workspace row, in the
  // parameters' order (the first layer's and the head's are there already)
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    const int p = o.P[l - 1], wl = S.width[l + 1], c0 = S.c0[l - 1];
    const float* acc = smem + o.acc[l];
    for (int u = tid; u < S.cnt[l - 1] * wl; u += kBackwardThreads) {
      const int k = u / wl, j = u % wl;
      wrow[S.pw[l] + (size_t)(c0 + k) * wl + j] = acc[j * p + k];
    }
  }
  for (int l = 0; l < L; ++l) {
    for (int k = tid; k < S.cnt[l]; k += kBackwardThreads)
      wrow[S.pb[l] + S.c0[l] + k] = smem[o.bias[l] + k];
  }
  if (rank == 0) {
    for (int e = tid; e < 2 * d; e += kBackwardThreads) wrow[S.pb[L] + e] = smem[o.bias[L] + e];
  }
  if (C > 1) cluster.sync();  // no CTA leaves while a peer may still write to it
}

// out[p] = sum over clusters b = 0, 1, ... of work[b * n + p], in that order.
__global__ void __launch_bounds__(kSumThreads)
general_sum_kernel(const float* __restrict__ work, int n_parts, int n, float* __restrict__ out) {
  const int p = blockIdx.x * kSumThreads + threadIdx.x;
  if (p >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < n_parts; ++b) s += work[(size_t)b * n + p];
  out[p] = s;
}

// Dynamic shared memory each kernel is opted in to, per device (bytes): the
// forward and the backward at 4, 8 and 16 rows.
constexpr int kMaxDevices = 64;
int g_opt_in[6][kMaxDevices] = {};

template <class K>
cudaError_t opt_in(K kernel, int which, int dev, size_t smem) {
  if (dev < kMaxDevices && (int)smem <= g_opt_in[which][dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) g_opt_in[which][dev] = (int)smem;
  return err;
}

Net make_net(const void* const* ws, const void* const* bs, const int* width, int n) {
  Net P = {};
  P.n = n;
  for (int l = 0; l < n; ++l) {
    P.w[l] = static_cast<const float*>(ws[l]);
    P.b[l] = bs != nullptr ? static_cast<const float*>(bs[l]) : nullptr;
  }
  for (int l = 0; l <= n; ++l) P.width[l] = width[l];
  return P;
}

Tape make_tape(void* const* zs, void* s, int n) {
  Tape T = {};
  for (int l = 0; zs != nullptr && l < n - 1; ++l) T.z[l] = static_cast<float*>(zs[l]);
  T.s = static_cast<float*>(s);
  return T;
}

// The current device, its SM count and the shared memory a block may opt in to.
cudaError_t device_limits(int* dev, int* sms, int* limit) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  return err;
}

// A launch of `clusters` clusters of c CTAs; a launch of one-CTA clusters
// (`plain`) goes without the cluster attribute (an implicit cluster of one),
// the occupancy query always with it.
cudaLaunchConfig_t cluster_config(int clusters, int c, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr,
                                  bool plain = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = plain && c == 1 ? 0 : 1;
  return cfg;
}

template <class K>
cudaError_t kernel_at(K kernel, int which, int dev, size_t smem, const void** fn) {
  *fn = reinterpret_cast<const void*>(kernel);
  return opt_in(kernel, which, dev, smem);
}

// The kernel a plan launches, opted in to its shared memory.
cudaError_t kernel_for(bool backward, int rows, int dev, size_t smem, const void** fn) {
  const int which = (backward ? 3 : 0) + (rows == 4 ? 0 : (rows == 8 ? 1 : 2));
  switch (which) {
    case 0: return kernel_at(general_forward_kernel<4>, which, dev, smem, fn);
    case 1: return kernel_at(general_forward_kernel<8>, which, dev, smem, fn);
    case 2: return kernel_at(general_forward_kernel<16>, which, dev, smem, fn);
    case 3: return kernel_at(general_backward_kernel<4>, which, dev, smem, fn);
    case 4: return kernel_at(general_backward_kernel<8>, which, dev, smem, fn);
    default: return kernel_at(general_backward_kernel<16>, which, dev, smem, fn);
  }
}

}  // namespace

extern "C" {

// The plan at these widths ([D, hidden..., 2D], n_layers + 1 of them) for
// the forward (backward = 0) or the backward (1), n_rows rows, on a card of
// n_sms SMs that allows smem_limit bytes of shared memory a block: out[0]
// the CTAs of a cluster, out[1] the rows of a tile, out[2] the shared
// memory of a CTA in bytes (dynamic and static). Returns 0, or -1 where the
// kernels do not take these widths or no cluster of at most 8 CTAs holds
// them.
int ar_solve_general_plan(const int* width, int n_layers, int backward, int n_rows, int n_sms,
                          int smem_limit, int* out) {
  if (!takes(width, n_layers) || n_rows <= 0) return -1;
  const Plan p = make_plan(width, n_layers, backward != 0, n_rows, n_sms, smem_limit);
  if (p.cluster == 0) return -1;
  out[0] = p.cluster;
  out[1] = p.rows;
  out[2] = p.bytes;
  return 0;
}

// The clusters a launch at these widths and rows runs at once on the
// current device (cudaOccupancyMaxActiveClusters), at most the row tiles:
// the persistent grid. Returns it (> 0); -1 where there is no plan, 0 where
// the card runs no such cluster, or -(CUDA error).
int ar_solve_general_clusters(const int* width, int n_layers, int backward, int n_rows) {
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = device_limits(&dev, &sms, &limit);
  if (err != cudaSuccess) return -(int)err;
  if (!takes(width, n_layers) || n_rows <= 0) return -1;
  const Plan p = make_plan(width, n_layers, backward != 0, n_rows, sms, limit);
  if (p.cluster == 0) return -1;
  const size_t smem = (size_t)p.bytes - kStaticSmem;
  const void* fn = nullptr;
  err = kernel_for(backward != 0, p.rows, dev, smem, &fn);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      1, p.cluster, backward ? kBackwardThreads : kChainThreads, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (n_rows + p.rows - 1) / p.rows;
  return clusters < tiles ? clusters : tiles;
}

// x, y: (n_rows, D) f32; ld: (n_rows,); ws[l]: (width[l], width[l+1]) with
// the mask applied; bs[l]: (width[l+1],). When s is not null the launch also
// records the tape: zs[l] (D, n_rows, width[l+1]) for every hidden layer and
// s (D, n_rows). n_clusters: the grid, from ar_solve_general_clusters. One
// launch on `stream`; returns its error (0 on success).
int ar_solve_general_forward(const void* x, const void* const* ws, const void* const* bs,
                             const int* width, int n_layers, int n_rows, int sign, float s_bound,
                             void* y, void* ld, void* const* zs, void* s, int n_clusters,
                             void* stream) {
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = device_limits(&dev, &sms, &limit);
  if (err != cudaSuccess) return (int)err;
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(width, n_layers, false, n_rows, sms, limit);
  if (p.cluster == 0 || n_clusters <= 0 || n_clusters > (n_rows + p.rows - 1) / p.rows)
    return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, bs, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  const size_t smem = (size_t)p.bytes - kStaticSmem;
  const void* fn = nullptr;
  err = kernel_for(false, p.rows, dev, smem, &fn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n_clusters, p.cluster, kChainThreads, smem,
                                                static_cast<cudaStream_t>(stream), &attr, true);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  auto* lf = static_cast<float*>(ld);
  if (p.rows == 4)
    err = cudaLaunchKernelEx(&cfg, general_forward_kernel<4>, xf, P, T, n_rows, sign, s_bound, yf,
                             lf);
  else if (p.rows == 8)
    err = cudaLaunchKernelEx(&cfg, general_forward_kernel<8>, xf, P, T, n_rows, sign, s_bound, yf,
                             lf);
  else
    err = cudaLaunchKernelEx(&cfg, general_forward_kernel<16>, xf, P, T, n_rows, sign, s_bound,
                             yf, lf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The reverse chain with the weight and bias sums, then the sum of the
// clusters' partial sums. x, y, gy, gx: (n_rows, D); gld: (n_rows,); ws as
// for the forward; zs and s: the forward's tape; grads: every weight
// gradient then every bias gradient, flat in the parameters' order, written
// in full; work: (n_clusters, that many floats) scratch. Two launches on
// `stream`; returns the error (0 on success).
int ar_solve_general_backward(const void* x, const void* y, const void* gy, const void* gld,
                              const void* const* ws, const int* width, int n_layers, int n_rows,
                              int sign, float s_bound, void* const* zs, void* s, void* gx,
                              void* grads, void* work, int n_clusters, void* stream) {
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = device_limits(&dev, &sms, &limit);
  if (err != cudaSuccess) return (int)err;
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(width, n_layers, true, n_rows, sms, limit);
  if (p.cluster == 0 || n_clusters <= 0 || n_clusters > (n_rows + p.rows - 1) / p.rows)
    return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, nullptr, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  int n_params = 0;
  for (int l = 0; l < n_layers; ++l) n_params += width[l] * width[l + 1] + width[l + 1];
  // the tape's rows by bulk copies where every slice is whole 16-byte units
  int bulk = 1;
  for (int l = 0; l + 1 < n_layers; ++l) {
    if (width[l + 1] % 4 != 0 || (reinterpret_cast<uintptr_t>(zs[l]) & 15) != 0) bulk = 0;
  }
  const size_t smem = (size_t)p.bytes - kStaticSmem;
  const void* fn = nullptr;
  err = kernel_for(true, p.rows, dev, smem, &fn);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_clusters, p.cluster, kBackwardThreads, smem, st, &attr, true);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* gyf = static_cast<const float*>(gy);
  const auto* gldf = static_cast<const float*>(gld);
  auto* gxf = static_cast<float*>(gx);
  auto* wf = static_cast<float*>(work);
  if (p.rows == 4)
    err = cudaLaunchKernelEx(&cfg, general_backward_kernel<4>, xf, yf, gyf, gldf, P, T, n_rows,
                             sign, s_bound, gxf, wf, n_params, bulk);
  else if (p.rows == 8)
    err = cudaLaunchKernelEx(&cfg, general_backward_kernel<8>, xf, yf, gyf, gldf, P, T, n_rows,
                             sign, s_bound, gxf, wf, n_params, bulk);
  else
    err = cudaLaunchKernelEx(&cfg, general_backward_kernel<16>, xf, yf, gyf, gldf, P, T, n_rows,
                             sign, s_bound, gxf, wf, n_params, bulk);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  general_sum_kernel<<<(n_params + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
      wf, n_clusters, n_params, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
