// Fused autoregressive-flow solve for Hopper (sm_90a) for the MADEs that no
// thread-block cluster of 8 CTAs holds: a forward kernel and the backward's
// reverse chain, each one cooperative launch over the whole card, after a
// launch that packs the weights. ops/ar_flow.py routes a call here (the
// "streamed" route) only where neither the 128-wide pair of ar_flow.cu nor
// the general pair of ar_flow_general.cu takes the MADE (hidden widths near
// 1,000, dozens of hidden layers).
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (:96, body _make_kernel :34) and the gradient the JAX package takes around
// it (_ar_solve_bwd :156, jax.vjp of unrolled_solve :113) at those shapes:
// hidden layers of any width, widths that differ from layer to layer, up to
// 63 hidden layers. They compute the same functions as ar_flow.cu's pair,
// read and write the same tape (each hidden layer's pre-activation z[l],
// (D, N, width_l), and the head's raw log-scale s, (D, N)), and take JAX's
// slope 1/2 at an exact ReLU tie (jnp.maximum(z, 0)).
//
// What bounds them: latency at a few rows, operations at many, and at
// every size the weights. The solve is a chain of D steps of L + 1
// dependent matrix-vector products; a MADE of 1,024 x 2 holds 4.4 MB of
// weights, more than a cluster of 8 CTAs (1.8 MB of shared memory), but the
// card's 132 SMs hold 30 MB. So the design spreads one copy of the MADE
// over many SMs' shared memory and trades each link's activations between
// them through L2; or, at many rows, lets each CTA take its own rows and
// stream every weight through its shared memory once a step for all of
// them.
//
// The plan (ar_solve_streamed_plan, a function of numbers; ops/ar_flow.py
// keeps a copy): the card runs `ctas` CTAs at once (the occupancy reading
// at the most shared memory a CTA may take, ar_solve_streamed_ctas). They
// are cut into row groups of C CTAs; CTA c of a group holds slice c of
// every hidden layer's columns (P = the width over C, rounded up to 4) and
// the matching rows of the head. A group walks row tiles of R rows: tiles
// g, g + groups, .... The weights of a CTA's slices are resident (loaded
// once) or streamed (each link's slice, a chunk of its inputs at a time,
// through a ring of two slots, at every step of every tile, by bulk copies
// (cp.async.bulk) that a producer warp issues ahead of the consumers,
// completing on mbarriers; each consumer warp releases a slot once). Of
// every layout that fits (each C from 1 to ctas, R from 4 to 64, resident
// and streamed through slots of 8,192 floats; slots narrowed to what the
// other buffers leave only where nothing else fits), the plan takes the
// least rounds of tiles over the groups times a step's estimated cost
// (step_cost: barriers, chunks, FMAs over the threads kept busy or
// streamed bytes, staged floats). Past the card's shared memory (12 x
// 1,024: 46 MB) only streamed layouts fit; at 128 rows of 1,024 x 2 and at
// an importance-sampling call's 10,000 the streamed layouts of small groups
// cost less than the resident ones. The wrapper computes the plan once for
// each widths and rows and passes it to every launch, which checks it
// against its own layout and the device.
//
// Design, both kernels:
// - A first launch packs the weights into a workspace: the head as
//   [i][feature][2] (columns i and i + D side by side) and, for each
//   hidden-to-hidden layer and CTA c, its slice, [input][P] forward,
//   transposed [output][P] backward, one contiguous run: one bulk copy
//   moves a slice (resident) or a chunk of its inputs (streamed).
// - The cooperative launch makes every CTA resident, so a group can meet
//   at a barrier of its own in global memory: after a bar.sync of the
//   consumers, thread 0 makes the CTA's writes visible (__threadfence),
//   adds one to the group's counter with release and waits, with acquire
//   loads, until it reaches the barrier's number times C. The counters are
//   set to 0 before each launch (a memset on the stream), so a call never
//   sees another's. Activations written by other SMs are read with
//   ld.global.cg (__ldcg), past the non-coherent L1. A wait that outlasts
//   about 10 s traps.
// - A link: stage the group's input activations ([feature][row]) from L2
//   into shared memory; multiply by the CTA's slice, chunk by chunk (a
//   thread keeps 4 columns x 4 rows, up to 4 row quads, in registers over
//   every chunk, one 16-byte weight read feeding each quad; where the slice
//   has too few outputs for the threads, K slices of every chunk, whose
//   sums meet in shared memory and are added in order); finish the outputs
//   (bias, tape, ReLU; out to L2 for the group). Every sum is taken in an
//   order fixed by the shapes and the plan (no floating-point atomics): two
//   calls give bitwise equal results.
// - Forward: each CTA keeps the first layer's whole pre-activation for its
//   tile and adds one rank-1 term a step (y gained one feature), so the
//   first layer needs no exchange; the last hidden layer's slice is
//   multiplied by the head's columns i and i + D into a partial sum per
//   row (each column group's, then their sum in order), which every CTA of
//   the group reads back and adds in CTA order to solve y_i. L - 1 group
//   barriers a step (one at L = 1).
// - Backward: each CTA computes the last hidden layer's whole delta from
//   the head's two columns and the tape, then the links down to the first
//   layer, each a slice of the product with the transposed weight times
//   the ReLU's slope from the tape (1, 1/2 at the tie, 0); the first
//   layer's deltas are summed over the steps in each CTA's slice (dsum),
//   and y's gradient at feature i is gy_i plus W0[i, :] . dsum, a partial
//   sum per CTA added in CTA order. It writes gx, every hidden layer's
//   delta at every step, (D, N, width_l), and the head's two delta columns
//   (mu_i, s_i) at every step, (D, N, 2); the weight and bias gradients
//   are their sums over rows and steps, which the wrapper takes as one
//   matrix product and one sum per layer (ops/ar_flow.py:sum_grads), as
//   JAX leaves them to XLA's autodiff.
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // the consumers (8 warps)
constexpr int kBlock = kThreads + 32;     // and one producer warp
constexpr int kMaxLayers = 64;            // hidden layers + head
constexpr int kMaxRows = 64;              // rows of a tile, a multiple of 4
constexpr int kSlots = 2;                 // the streamed ring's slots
constexpr int kSlotFloats = 8192;         // a full slot's floats at most (or one input row)
constexpr int kMinChunk = 8;              // least input features a K slice sums
constexpr int kMaxSlices = 16;            // K slices a link takes at most
constexpr int kHeadPass = 64;             // CTAs' head partial sums staged at a time
constexpr int kGradPass = 128;            // CTAs' y-gradient partial sums staged at a time
constexpr int kStaticSmem = 6144;         // bytes counted for the static shared memory
constexpr int kBarCompute = 1;            // the consumers' named barrier
constexpr int kPackThreads = 256;
constexpr int kBatch = 8;                 // items a thread loads for before it computes
constexpr int kItems = 4;                 // row quads a thread keeps the sums of in a link
// the plan's estimate of a step's cost, in cycles of one SM: a group
// barrier (with a step's other fixed costs), a chunk of a link, FMAs a
// cycle (half the SM's 128 lanes), floats staged from L2 a cycle, floats
// streamed into the ring a cycle; the barrier's and the stream's fitted to
// steps timed on an H100 at 16 to 32 rows
constexpr long long kSyncCycles = 8000, kChunkCycles = 100, kFmaPerCycle = 64;
constexpr long long kStagePerCycle = 8, kStreamPerCycle = 3;

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

// The backward's per-step deltas: d[l] (D, N, width[l + 1]) of hidden layer
// l, head (D, N, 2): the head's delta at columns i and i + D at step i.
struct Deltas {
  float* d[kMaxLayers];
  float* head;
};

// The workspace: the packed weights, then each group's exchange buffers,
// then one barrier counter a group.
struct Work {
  float* f;
  unsigned* ctr;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Where each buffer of a CTA's dynamic shared memory starts, in floats;
// every start a multiple of 4.
struct Layout {
  int P[kMaxLayers];     // hidden layer l's slice width (l < L), a multiple of 4
  int kc[kMaxLayers];    // link l's chunk of inputs (1 <= l < L): all of them when resident
  int ks[kMaxLayers];    // link l's K slices
  int wres[kMaxLayers];  // resident: link l's slice
  int boff[kMaxLayers + 1];  // forward: hidden layer l's bias slice within `bias`; [L] the head's
  int slot;              // streamed: a ring slot's floats
  int ring, hrow, bias, z0, w0r, stage, part, hpart, xs, ys, dsum, gys, gxs, sr, hg;
};

// Link l (1 <= l < L): the forward's product that gives hidden layer l
// from l - 1 (K = width[l] inputs, the slice of layer l's columns), the
// backward's that gives layer l - 1's delta from layer l's (K = width[l + 1],
// the slice of layer l - 1).
__host__ __device__ inline int link_k(const int* width, int l, bool backward) {
  return backward ? width[l + 1] : width[l];
}
__host__ __device__ inline int link_p(const Layout& o, int l, bool backward) {
  return backward ? o.P[l - 1] : o.P[l];
}

// A link's threads: each takes a column group g (of G = P / 4, at most the
// consumers) and, of the kThreads / G threads of that group, the q-th: row
// quads q, q + kThreads / G, ... (at most kItems of them), or, where the
// group has threads to spare, one row quad and one of ks K slices of every
// chunk (ks a power of two, at most kMaxSlices, at least kMinChunk inputs a
// slice). See link() for the threads' order.
__host__ __device__ inline int row_items(int p, int r) {
  const int tg = kThreads / (p / 4);
  return (r / 4 + tg - 1) / tg;
}

__host__ __device__ inline int kslices(int p, int r, int kc) {
  const int tg = kThreads / (p / 4), rv = r / 4;
  int ks = 1;
  while (2 * ks <= kMaxSlices && 2 * ks * rv <= tg && 2 * ks * kMinChunk <= kc) ks *= 2;
  return ks;
}

// A CTA's layout at C CTAs a group and r rows a tile, the weights resident
// (cap 0) or streamed through a ring of two slots of at most `cap` floats
// (each link a chunk of cap / P of its inputs at a time, at least one);
// returns its floats, or -1 where a link's slice is too wide for its
// threads. Forward: the weights (resident slices, or the ring), the
// head's columns i and i + D over the slice of the last hidden layer
// [P_last][2], the bias slices and the head's biases, the first layer's
// whole pre-activation [width_1][r] and the step's row of W0, the stage (a
// link's input, or the partial sums), the K slices' partial sums, the head's
// partial sums of each column group of the last hidden layer, the x and y
// tiles. Backward: the weights, the stage (a delta, or the partial sums),
// the partial sums, the step's row of W0 over the first layer's slice,
// its dsum slice, the x, y, gy, gx and raw-s tiles, and g_mu, g_s and the
// log-det gradient of each row.
__host__ __device__ inline long long layout(const int* width, int n, int c, int r, bool backward,
                                            int cap, Layout* o) {
  const int d = width[0], L = n - 1;
  long long at = 0;
  for (int l = 0; l < L; ++l) o->P[l] = round4((width[l + 1] + c - 1) / c);
  int slot = 0;
  long long part = 0;
  for (int l = 1; l < L; ++l) {
    const int K = link_k(width, l, backward), P = link_p(*o, l, backward);
    if (P > 4 * kThreads || row_items(P, r) > kItems) return -1;
    if (cap) {
      o->kc[l] = imin(K, imax(cap / P, 1));
      slot = imax(slot, o->kc[l] * P);
      o->wres[l] = 0;
    } else {
      o->kc[l] = K;
      o->wres[l] = (int)at;
      at += (long long)K * P;
    }
    o->ks[l] = kslices(P, r, o->kc[l]);
    if (o->ks[l] > 1 && (long long)o->ks[l] * P * r > part) part = (long long)o->ks[l] * P * r;
  }
  o->slot = slot;
  o->ring = (int)at;
  at += (long long)kSlots * slot;
  int sw = backward ? imin(c, kGradPass) : 2 * imin(c, kHeadPass);
  if (!backward) {
    o->hrow = (int)at; at += 2LL * o->P[L - 1];
    o->bias = (int)at;
    int b = 0;
    for (int l = 1; l < L; ++l) { o->boff[l] = b; b += o->P[l]; }
    o->boff[L] = b; b += round4(2 * d);
    at += b;
    o->z0 = (int)at; at += (long long)width[1] * r;
    o->w0r = (int)at; at += round4(width[1]);
    for (int l = 2; l < L; ++l) sw = imax(sw, width[l]);
    o->stage = (int)at; at += (long long)sw * r;
    o->part = (int)at; at += part;
    o->hpart = (int)at; at += (long long)(L > 1 ? o->P[L - 1] / 4 : 0) * 2 * r;
    o->xs = (int)at; at += (long long)d * r;
    o->ys = (int)at; at += (long long)d * r;
  } else {
    for (int l = 2; l <= L; ++l) sw = imax(sw, width[l]);
    o->stage = (int)at; at += (long long)sw * r;
    o->part = (int)at; at += part;
    o->w0r = (int)at; at += o->P[0];
    o->dsum = (int)at; at += (long long)o->P[0] * r;
    o->xs = (int)at; at += (long long)d * r;
    o->ys = (int)at; at += (long long)d * r;
    o->gys = (int)at; at += (long long)d * r;
    o->gxs = (int)at; at += (long long)d * r;
    o->sr = (int)at; at += (long long)d * r;
    o->hg = (int)at; at += 3LL * r;
  }
  return at;
}

// The streamed layout with the widest ring that fits `limit`: slots of at
// most kSlotFloats where they fit, else of at most the floats that the other
// buffers leave (a multiple of 4, at least every link's slice: three or more
// hidden layers of ~4,500 units). Returns its floats and sets *cap, or -1.
__host__ __device__ inline long long ring_layout(const int* width, int n, int c, int r,
                                                 bool backward, int limit, int* cap, Layout* o) {
  *cap = kSlotFloats;
  const long long floats = layout(width, n, c, r, backward, kSlotFloats, o);
  if (floats < 0 || floats * 4 + kStaticSmem <= limit) return floats;
  int widest = 0;
  for (int l = 1; l < n - 1; ++l) widest = imax(widest, link_p(*o, l, backward));
  if (widest == 0) return -1;  // one hidden layer: no ring to narrow
  const long long room = (limit - kStaticSmem) / 4 - (floats - (long long)kSlots * o->slot);
  *cap = (int)((room / kSlots) & ~3LL);
  if (*cap < widest) return -1;
  return layout(width, n, c, r, backward, *cap, o);
}

// The packed weights' floats: the head [D][width_L][2], then each link's C
// slices; and a group's exchange: each hidden layer between the first and
// the last, [width][r], then two slots of the CTAs' partial sums (forward:
// mu and s, [C][2][r]; backward: [C][r]).
__host__ __device__ inline long long packed_floats(const int* width, int n, int c, bool backward,
                                                   const Layout& o) {
  const int L = n - 1;
  long long at = round4(2 * width[0] * width[L]);
  for (int l = 1; l < L; ++l)
    at += (long long)c * link_k(width, l, backward) * link_p(o, l, backward);
  return at;
}

__host__ __device__ inline long long exchange_floats(const int* width, int n, int c, int r,
                                                     bool backward) {
  long long at = 0;
  for (int l = 1; l + 1 < n - 1; ++l) at += (long long)width[l + 1] * r;
  return at + 2LL * c * (backward ? 1 : 2) * r;
}

// A step's estimated cost on one SM, in cycles: its group barriers, its
// links' chunks, its FMAs (every link's slice, over the share of the
// consumers it keeps busy, beside the first layer's rank-1 term in full and
// the head's columns, or the last hidden layer's delta in full and
// W0[i, :] . dsum) or, where more, the floats it streams, and its floats
// staged from L2.
__host__ __device__ inline long long step_cost(const int* width, int n, const Layout& o, int c,
                                               int r, bool backward, bool streamed) {
  const int L = n - 1;
  long long fma = 0, weights = 0, staged = 0, chunks = 0;
  for (int l = 1; l < L; ++l) {
    const long long k = link_k(width, l, backward), p = link_p(o, l, backward);
    // the threads' share of the slowest thread's work (row_items quads each)
    const long long busy = imin(kThreads, (int)(p / 4) * (r / 4) * o.ks[l] / row_items((int)p, r));
    weights += k * p;
    fma += k * p * kThreads / busy;
    chunks += cdiv(k, o.kc[l]);
  }
  for (int l = 2; l < L; ++l) staged += width[l];
  if (!backward) {
    fma += width[1] + 2LL * o.P[L - 1];
    staged += 2LL * c;
  } else {
    fma += 2LL * width[L] + o.P[0];
    staged += c;
  }
  const long long syncs = L > 1 ? L - 1 : 1;
  long long work = r * fma / kFmaPerCycle;
  if (streamed && weights / kStreamPerCycle > work) work = weights / kStreamPerCycle;
  return syncs * kSyncCycles + chunks * kChunkCycles + work + r * staged / kStagePerCycle;
}

bool takes(const int* width, int n) {
  if (n < 2 || n > kMaxLayers || width[0] < 2 || width[n] != 2 * width[0]) return false;
  for (int l = 1; l < n; ++l) {
    if (width[l] < 1) return false;
  }
  return true;
}

struct Plan {
  int cap, c, rows, groups, bytes;  // cap: a ring slot's floats at most, 0 resident
  long long work;                   // floats of the workspace, its counters included
};

// The plan at these widths for n_rows rows on a card that runs `ctas` CTAs
// at once and allows `limit` bytes of shared memory a CTA: of every layout
// that fits (the weights resident or streamed through a ring of full slots;
// a ring narrowed to fit, ring_layout, only where none of those fits; C
// from 1 to ctas; r from 4 to kMaxRows, step 4), the least rounds of tiles
// over the groups times a step's cost (step_cost), the fewer CTAs on a tie,
// then the first found. c = 0 where none fits.
Plan make_plan(const int* width, int n, bool backward, int n_rows, int ctas, int limit) {
  Layout o;
  Plan best{0, 0, 0, 0, 0, 0};
  long long best_cost = -1;
  // resident, a ring of full slots, then a narrowed ring only where neither fits
  for (int mode = 0; mode < 3 && !(mode == 2 && best.c != 0); ++mode) {
    for (int c = 1; c <= ctas; ++c) {
      for (int r = 4; r <= kMaxRows; r += 4) {
        int cap = mode * kSlotFloats;
        const long long floats = mode == 2 ? ring_layout(width, n, c, r, backward, limit, &cap, &o)
                                           : layout(width, n, c, r, backward, cap, &o);
        if (floats < 0 || floats * 4 + kStaticSmem > limit) break;
        const long long tiles = cdiv(n_rows, r);
        const int groups = (int)(ctas / c < tiles ? ctas / c : tiles);
        const long long cost =
            cdiv(tiles, groups) * step_cost(width, n, o, c, r, backward, cap != 0);
        if (best.c == 0 || cost < best_cost ||
            (cost == best_cost && (long long)groups * c < (long long)best.groups * best.c)) {
          best_cost = cost;
          const long long work = packed_floats(width, n, c, backward, o) +
                                 groups * exchange_floats(width, n, c, r, backward) + groups;
          best = Plan{cap, c, r, groups, (int)(floats * 4 + kStaticSmem), work};
        }
      }
    }
  }
  return best;
}

// Kernel parameters and the layout, in static shared memory: kernel
// parameters indexed at run time would be copied to local memory.
struct Shared {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* z[kMaxLayers];
  float* dl[kMaxLayers];
  int width[kMaxLayers + 1];
  int c0[kMaxLayers];        // this CTA's first feature of hidden layer l's slice
  int cnt[kMaxLayers];       // the features in it (at most P[l]; 0 past the width)
  long long pk[kMaxLayers];  // link l's packed slice of this CTA, in the workspace
  long long ex[kMaxLayers];  // this group's exchange of hidden layer l
  long long ex_part;         // this group's partial sums, two slots
  Layout o;
};
static_assert(sizeof(Shared) + 2 * (kSlots + 1) * 8 + 64 <= kStaticSmem,
              "the static shared memory outgrew its bound");

__device__ inline void setup(Shared& S, const Net& P, const Tape& T, float* const* dl, int c,
                             int r, int rank, int grp, bool backward, int cap) {
  for (int l = threadIdx.x; l < P.n; l += blockDim.x) {
    S.w[l] = P.w[l];
    S.b[l] = P.b[l];
    S.z[l] = T.z[l];
    S.dl[l] = dl != nullptr ? dl[l] : nullptr;
  }
  for (int l = threadIdx.x; l <= P.n; l += blockDim.x) S.width[l] = P.width[l];
  __syncthreads();
  if (threadIdx.x == 0) {
    layout(S.width, P.n, c, r, backward, cap, &S.o);
    const int L = P.n - 1;
    for (int l = 0; l < L; ++l) {
      S.c0[l] = rank * S.o.P[l];
      const int left = S.width[l + 1] - S.c0[l];
      S.cnt[l] = left < 0 ? 0 : (left < S.o.P[l] ? left : S.o.P[l]);
    }
    long long at = round4(2 * S.width[0] * S.width[L]);
    for (int l = 1; l < L; ++l) {
      const long long slice = (long long)link_k(S.width, l, backward) * link_p(S.o, l, backward);
      S.pk[l] = at + rank * slice;
      at += c * slice;
    }
    at += grp * exchange_floats(S.width, P.n, c, r, backward);
    for (int l = 1; l + 1 < L; ++l) {
      S.ex[l] = at;
      at += (long long)S.width[l + 1] * r;
    }
    S.ex_part = at;
  }
  __syncthreads();
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void compute_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarCompute), "n"(kThreads) : "memory");
}

// A wait that outlasts kSpinCycles (about 10 s) traps: the launch fails
// with an error instead of holding the card.
constexpr long long kSpinCycles = 20000000000LL;

__device__ inline void spin_check(long long t0) {
  if (clock64() - t0 > kSpinCycles) __trap();
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    spin_check(t0);
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

__device__ inline unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// The consumers of every CTA of the group meet: what each wrote to global
// memory before is seen by every consumer after (read past L1, __ldcg).
// The counter reaches `target` = the barrier's number times C.
__device__ inline void group_sync(unsigned* ctr, unsigned target, int c) {
  compute_bar();
  if (c > 1 && threadIdx.x == 0) {
    __threadfence();
    red_release(ctr);
    const long long t0 = clock64();
    while (ld_acquire(ctr) < target) spin_check(t0);
    __threadfence();
  }
  compute_bar();
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

__device__ inline float4 relu4(const float4& v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// jnp.maximum(z, 0)'s slope: 1 above 0, 1/2 at the tie, 0 below.
__device__ inline float slope(float z) { return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f); }

__device__ inline float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__device__ inline void set_comp(float4& v, int q, float a) {
  if (q == 0) v.x = a;
  else if (q == 1) v.y = a;
  else if (q == 2) v.z = a;
  else v.w = a;
}

// dst[u] = src[u] for u < n4 float4s, read past L1 (src written by other SMs).
__device__ inline void stage_cg(float* dst, const float* src, int n4) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
  for (int u = threadIdx.x; u < n4; u += kThreads) d4[u] = __ldcg(s4 + u);
}

// The ring a producer fills and the consumers drain, chunk by chunk, in the
// same order; `seq` counts the chunks.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  float* slots;
  int slot_floats;
  unsigned seq;
};

// A thread's share of a chunk: NV row quads (at ak + off[m]) times its 4
// columns, over inputs k of n, weights mk (G float4s a row), activations ak
// (RV float4s a row).
template <int NV, bool RELU>
__device__ inline void mac(const float4* __restrict__ mk, const float4* __restrict__ ak, int n,
                           int G, int RV, const int (&off)[kItems], float4 (&acc)[kItems][4]) {
#pragma unroll 8
  for (int k = 0; k < n; ++k, mk += G, ak += RV) {
    const float4 w = *mk;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      float4 a = ak[off[m]];
      if (RELU) a = relu4(a);
      fma4(acc[m][0], a, w.x);
      fma4(acc[m][1], a, w.y);
      fma4(acc[m][2], a, w.z);
      fma4(acc[m][3], a, w.w);
    }
  }
}

// One link over the consumers (see row_items): out[col][row] = sum over
// k < K of in[k][row] * M[k][col] (relu(in) where RELU), M the CTA's slice
// [K][P] in chunks of kc inputs (resident: one chunk, in place; streamed:
// each from the ring). A thread keeps the sums of its columns 4g..4g+3 and
// its row quads in registers over every chunk; where K slices split the
// inputs, their sums meet in part[s][col][r] and are added in slice order.
// Then epi(g, v, z) for every column group g and row quad v, z[c] the sums
// of column 4g + c at rows 4v..4v+3, by one thread each.
template <bool RELU, class Epi>
__device__ inline void link(const float* __restrict__ in, const float* resident, int K, int P,
                            int kc, int ks, int R, float* __restrict__ part, bool streamed,
                            Ring& ring, Epi epi) {
  const int RV = R / 4, G = P / 4, TG = kThreads / G;
  // thread t = ((g / 8) TG + q) 8 + g % 8 where 8 divides G: a warp spans 8
  // column groups and 4 of their q, so that its weight and activation
  // reads are 128 bytes each; else t = q G + g
  const int t = threadIdx.x;
  const int g = G % 8 == 0 ? (t / 8 / TG) * 8 + t % 8 : t % G;
  const int q = G % 8 == 0 ? (t / 8) % TG : t / G;
  const bool active = g < G && q < TG && (ks > 1 ? q < RV * ks : q < RV);
  const int v0 = ks > 1 ? q % RV : q, s = ks > 1 ? q / RV : 0;
  // every thread's count of row quads, the same for all (a thread past the
  // last quad repeats it and drops the sums): no warp diverges on it
  const int nv = active ? (ks > 1 ? 1 : imin(kItems, (RV + TG - 1) / TG)) : 0;
  int off[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) off[m] = imin(v0 + m * TG, RV - 1) - v0;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4 acc[kItems][4];
#pragma unroll
  for (int m = 0; m < kItems; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nch = (K + kc - 1) / kc;
#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
    const int k0 = j * kc, len = imin(kc, K - k0);
    const float* M = resident + (size_t)k0 * P;
    unsigned slot = 0;
    if (streamed) {
      slot = ring.seq % kSlots;
      mbar_wait(&ring.full[slot], (ring.seq / kSlots) & 1);
      M = ring.slots + (size_t)slot * ring.slot_floats;
    }
    if (active) {
      const int kb = (s * len) / ks, ke = ((s + 1) * len) / ks;
      const float4* mk = reinterpret_cast<const float4*>(M) + (size_t)kb * G + g;
      const float4* ak = in4 + (size_t)(k0 + kb) * RV + v0;
      switch (nv) {
        case 1: mac<1, RELU>(mk, ak, ke - kb, G, RV, off, acc); break;
        case 2: mac<2, RELU>(mk, ak, ke - kb, G, RV, off, acc); break;
        case 3: mac<3, RELU>(mk, ak, ke - kb, G, RV, off, acc); break;
        default: mac<4, RELU>(mk, ak, ke - kb, G, RV, off, acc); break;
      }
    }
    if (streamed) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[slot]);
      ++ring.seq;
    }
  }
  if (ks == 1) {
#pragma unroll
    for (int m = 0; m < kItems; ++m)
      if (m < nv && v0 + m * TG < RV) epi(g, v0 + m * TG, acc[m]);
    return;
  }
  float4* part4 = reinterpret_cast<float4*>(part);
  if (active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) part4[(s * P + 4 * g + c) * RV + v0] = acc[0][c];
  }
  compute_bar();
  if (threadIdx.x < G * RV) {
    const int gg = threadIdx.x % G, v = threadIdx.x / G;
    float4 z[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4* p4 = part4 + (4 * gg + c) * RV + v;
      z[c] = p4[0];
      for (int t = 1; t < ks; ++t) z[c] = add4(z[c], p4[t * P * RV]);
    }
    epi(gg, v, z);
  }
}

// The producer: lane 0 of the last warp. Resident: every link's slice in
// one phase of `wbar`. Streamed: each chunk in the consumers' order (for
// each of the group's tiles, each step, each link in the kernel's order),
// into the next ring slot once the consumers have released it.
template <bool BACKWARD>
__device__ inline void producer(const Shared& S, int n_layers, float* smem, const float* packed,
                                int n_rows, int R, int grp, int groups, bool streamed,
                                uint64_t* full, uint64_t* empty, uint64_t* wbar) {
  const Layout& o = S.o;
  const int L = n_layers - 1, d = S.width[0];
  if (!streamed) {
    unsigned bytes = 0;
    for (int l = 1; l < L; ++l)
      bytes += (unsigned)(link_k(S.width, l, BACKWARD) * link_p(o, l, BACKWARD) * 4);
    if (bytes == 0) return;
    mbar_expect_tx(wbar, bytes);
    for (int l = 1; l < L; ++l)
      bulk_copy(smem + o.wres[l], packed + S.pk[l],
                (unsigned)(link_k(S.width, l, BACKWARD) * link_p(o, l, BACKWARD) * 4), wbar);
    return;
  }
  const int n_tiles = (n_rows + R - 1) / R;
  unsigned seq = 0;
  for (int tile = grp; tile < n_tiles; tile += groups) {
    for (int i = 0; i < d; ++i) {
      for (int t = 1; t < L; ++t) {
        const int l = BACKWARD ? L - t : t;
        const int K = link_k(S.width, l, BACKWARD), P = link_p(o, l, BACKWARD), kc = o.kc[l];
        for (int k0 = 0; k0 < K; k0 += kc, ++seq) {
          const unsigned slot = seq % kSlots, use = seq / kSlots;
          if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
          const unsigned bytes = (unsigned)(imin(kc, K - k0) * P * 4);
          mbar_expect_tx(&full[slot], bytes);
          bulk_copy(smem + o.ring + (size_t)slot * o.slot, packed + S.pk[l] + (size_t)k0 * P,
                    bytes, &full[slot]);
        }
      }
    }
  }
}

__device__ inline void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* wbar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

__global__ void __launch_bounds__(kBlock, 1)
streamed_forward_kernel(const float* __restrict__ x, Net P, Tape T, Work W, int C, int R,
                        int cap, int n_rows, int sign, float s_bound,
                        float* __restrict__ y_out, float* __restrict__ ld_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots], wbar;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % C, grp = blockIdx.x / C, groups = gridDim.x / C;
  setup(S, P, T, nullptr, C, R, rank, grp, false, cap);
  const bool streamed = cap != 0;
  init_barriers(full, empty, &wbar);
  __syncthreads();
  const int n = P.n, L = n - 1, d = S.width[0], w1 = S.width[1];
  if (tid >= kThreads) {
    if (tid == kThreads)
      producer<false>(S, n, smem, W.f, n_rows, R, grp, groups, streamed, full, empty, &wbar);
    return;
  }
  const Layout& o = S.o;
  const bool record = T.s != nullptr;
  const int RV = R / 4, n_tiles = (n_rows + R - 1) / R;
  float* z0 = smem + o.z0;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  float* hpart = smem + o.hpart;
  float* xs = smem + o.xs;
  float* ys = smem + o.ys;
  float* hrow = smem + o.hrow;
  float* bias = smem + o.bias;
  float* w0r = smem + o.w0r;
  float4* z04 = reinterpret_cast<float4*>(z0);
  const float4* ys4 = reinterpret_cast<const float4*>(ys);
  const int PL = o.P[L - 1], c0L = S.c0[L - 1], cntL = S.cnt[L - 1], wL = S.width[L];
  const float* bh = bias + o.boff[L];

  // the bias slices and the head's biases
  for (int l = 1; l < L; ++l)
    for (int p = tid; p < o.P[l]; p += kThreads)
      bias[o.boff[l] + p] = p < S.cnt[l] ? __ldg(S.b[l] + S.c0[l] + p) : 0.f;
  for (int j = tid; j < 2 * d; j += kThreads) bias[o.boff[L] + j] = __ldg(S.b[L] + j);
  if (!streamed && L > 1) mbar_wait(&wbar, 0);
  compute_bar();

  Ring ring{full, empty, smem + o.ring, o.slot, 0};
  unsigned* ctr = W.ctr + grp;
  unsigned syncs = 0;
  int step = 0;    // this group's steps so far: the partial sums' slot
  float ld = 0.f;  // thread r < R: row r's log-det

  // y_j for the tile's rows from step j's head partial sums (slot `slot`):
  // staged kHeadPass CTAs at a time, added in CTA order, then the head's
  // biases; the raw s recorded, the log-det kept
  auto solve_y = [&](int j, int slot, int row0) {
    float mu = 0.f, s = 0.f;
    for (int cb = 0; cb < C; cb += kHeadPass) {
      const int nc = imin(kHeadPass, C - cb);
      stage_cg(stage, W.f + S.ex_part + ((size_t)slot * C + cb) * 2 * R, nc * 2 * RV);
      compute_bar();
      if (tid < R) {
        for (int c = 0; c < nc; ++c) {
          mu += stage[(2 * c) * R + tid];
          s += stage[(2 * c + 1) * R + tid];
        }
      }
      compute_bar();
    }
    if (tid < R) {
      const int row = row0 + tid;
      mu += bh[j];
      s += bh[j + d];
      if (record && rank == 0 && row < n_rows) T.s[(size_t)j * n_rows + row] = s;
      if (s_bound > 0.f) s = s_bound * tanhf(s / s_bound);
      const float xi = xs[j * R + tid];
      ys[j * R + tid] = sign < 0 ? (xi - mu) * expf(-s) : xi * expf(s) + mu;
      ld += sign < 0 ? -s : s;
    }
    compute_bar();
  };

  for (int tile = grp; tile < n_tiles; tile += groups) {
    const int row0 = tile * R;
    for (int u = tid; u < d * R; u += kThreads) {
      const int c = u / R, row = row0 + u % R;
      xs[u] = row < n_rows ? __ldg(x + (size_t)row * d + c) : 0.f;
      ys[u] = 0.f;
    }
    for (int u = tid; u < w1 * R; u += kThreads) z0[u] = __ldg(S.b[0] + u / R);
    ld = 0.f;
    compute_bar();
    for (int i = 0; i < d; ++i, ++step) {
      // this step's rows: W0's row i - 1, the head's columns i and i + d
      // over the slice of the last hidden layer (loads issued before the
      // partial sums' are waited for)
      if (i > 0) {
        const float* wrow = S.w[0] + (size_t)(i - 1) * w1;
#pragma unroll 4
        for (int k = tid; k < w1; k += kThreads) w0r[k] = __ldg(wrow + k);
      }
      for (int u = tid; u < 2 * PL; u += kThreads)
        hrow[u] = (u >> 1) < cntL ? W.f[((size_t)i * wL + c0L + (u >> 1)) * 2 + (u & 1)] : 0.f;
      if (i > 0) solve_y(i - 1, (step - 1) & 1, row0);
      else compute_bar();
      // first layer, in full: y gained feature i - 1, so its pre-activation
      // gains one rank-1 term, y_{i-1} * W0[i-1, :]; the tape of this CTA's slice
      {
        const int c0 = S.c0[0], cnt = S.cnt[0];
        for (int u = tid; u < w1 * RV; u += kThreads) {
          const int k = u % w1, v = u / w1;
          float4 z = z04[k * RV + v];
          if (i > 0) {
            fma4(z, ys4[(i - 1) * RV + v], w0r[k]);
            z04[k * RV + v] = z;
          }
          if (record && k >= c0 && k < c0 + cnt) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = row0 + 4 * v + q;
              if (row < n_rows) S.z[0][((size_t)i * n_rows + row) * w1 + k] = comp(z, q);
            }
          }
        }
      }
      compute_bar();

      // the hidden-to-hidden links: layer l's slice from layer l - 1 in full
      for (int l = 1; l < L; ++l) {
        const int K = S.width[l], Pl = o.P[l], ks = o.ks[l];
        const int cnt = S.cnt[l], c0 = S.c0[l], wout = S.width[l + 1];
        const float* b = bias + o.boff[l];
        const bool last = l == L - 1;
        // a column group's sums at a row quad: bias, tape, ReLU; out to the
        // group, or times the head's columns i and i + d into hpart
        auto epi = [&](int g, int v, float4 (&z)[4]) {
          float4 ph[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gc = 4 * g + c;
            if (gc >= cnt) continue;
            const float bj = b[gc];
            const float4 zc = make_float4(z[c].x + bj, z[c].y + bj, z[c].z + bj, z[c].w + bj);
            if (record) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = row0 + 4 * v + q;
                if (row < n_rows) S.z[l][((size_t)i * n_rows + row) * wout + c0 + gc] = comp(zc, q);
              }
            }
            const float4 h = relu4(zc);
            if (!last) {
              *reinterpret_cast<float4*>(W.f + S.ex[l] + (size_t)(c0 + gc) * R + 4 * v) = h;
            } else {
              fma4(ph[0], h, hrow[2 * gc]);
              fma4(ph[1], h, hrow[2 * gc + 1]);
            }
          }
          if (last) {
            reinterpret_cast<float4*>(hpart)[(2 * g) * RV + v] = ph[0];
            reinterpret_cast<float4*>(hpart)[(2 * g + 1) * RV + v] = ph[1];
          }
        };
        if (l >= 2) {
          stage_cg(stage, W.f + S.ex[l - 1], K * RV);
          compute_bar();
          link<false>(stage, smem + o.wres[l], K, Pl, o.kc[l], ks, R, part, streamed, ring,
                      epi);
        } else {
          link<true>(z0, smem + o.wres[l], K, Pl, o.kc[l], ks, R, part, streamed, ring, epi);
        }
        if (!last) group_sync(ctr, ++syncs * C, C);
        else compute_bar();
      }

      // the head's columns i (mu) and i + d (s) over this CTA's slice of
      // the last hidden layer: one partial sum a row and column, out to the
      // group's slot
      if (tid < 2 * R) {
        const int e = tid / R, r = tid % R;
        float hp = 0.f;
        if (L == 1) {
          for (int col = 0; col < cntL; ++col)
            hp += fmaxf(z0[(c0L + col) * R + r], 0.f) * hrow[2 * col + e];
        } else {
          for (int g = 0; g < PL / 4; ++g) hp += hpart[(2 * g + e) * R + r];
        }
        W.f[S.ex_part + (((size_t)(step & 1) * C + rank) * 2 + e) * R + r] = hp;
      }
      group_sync(ctr, ++syncs * C, C);
    }
    // the last feature's y, then the tile's y and log-det out
    solve_y(d - 1, (step - 1) & 1, row0);
    if (rank == 0) {
      for (int u = tid; u < d * R; u += kThreads) {
        const int c = u % d, r = u / d;
        if (row0 + r < n_rows) y_out[(size_t)(row0 + r) * d + c] = ys[c * R + r];
      }
      if (tid < R && row0 + tid < n_rows) ld_out[row0 + tid] = ld;
    }
    compute_bar();
  }
}

__global__ void __launch_bounds__(kBlock, 1)
streamed_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ gy, const float* __restrict__ gld, Net P,
                         Tape T, Deltas G, Work W, int C, int R, int cap, int n_rows,
                         int sign, float s_bound, float* __restrict__ gx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots], wbar;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % C, grp = blockIdx.x / C, groups = gridDim.x / C;
  setup(S, P, T, G.d, C, R, rank, grp, true, cap);
  const bool streamed = cap != 0;
  init_barriers(full, empty, &wbar);
  __syncthreads();
  const int n = P.n, L = n - 1, d = S.width[0], w1 = S.width[1], wL = S.width[L];
  if (tid >= kThreads) {
    if (tid == kThreads)
      producer<true>(S, n, smem, W.f, n_rows, R, grp, groups, streamed, full, empty, &wbar);
    return;
  }
  const Layout& o = S.o;
  const int RV = R / 4, n_tiles = (n_rows + R - 1) / R;
  float* stage = smem + o.stage;
  float* part = smem + o.part;
  float* dsum = smem + o.dsum;
  float* xs = smem + o.xs;
  float* ys = smem + o.ys;
  float* gys = smem + o.gys;
  float* gxs = smem + o.gxs;
  float* sr = smem + o.sr;
  float* hg = smem + o.hg;  // [g_mu, g_s, gld][R]
  float* w0r = smem + o.w0r;
  float4* dsum4 = reinterpret_cast<float4*>(dsum);
  float4* stage4 = reinterpret_cast<float4*>(stage);
  const float4* hg4 = reinterpret_cast<const float4*>(hg);
  // the packed head: [i][feature] of (mu_i, s_i) columns
  const float2* head2 = reinterpret_cast<const float2*>(W.f);
  if (!streamed && L > 1) mbar_wait(&wbar, 0);
  compute_bar();

  Ring ring{full, empty, smem + o.ring, o.slot, 0};
  unsigned* ctr = W.ctr + grp;
  unsigned syncs = 0;
  int step = 0;

  // hidden layer l's delta at step i, feature k, rows 4v..4v+3: g times the
  // slope of the layer's ReLU there (the tape, read-only here), 0 past the
  // last row; and out to the deltas
  auto delta = [&](int l, int i, int k, int v, int row0, float4 g) {
    const int w = S.width[l + 1];
    const float* z = S.z[l];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + 4 * v + q;
      float val = 0.f;
      if (row < n_rows) val = comp(g, q) * slope(__ldg(z + ((size_t)i * n_rows + row) * w + k));
      set_comp(g, q, val);
    }
    return g;
  };
  auto write_delta = [&](int l, int i, int k, int v, int row0, const float4& g) {
    const int w = S.width[l + 1];
    float* out = S.dl[l];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + 4 * v + q;
      if (row < n_rows) out[((size_t)i * n_rows + row) * w + k] = comp(g, q);
    }
  };

  for (int tile = grp; tile < n_tiles; tile += groups) {
    const int row0 = tile * R;
    for (int u = tid; u < d * R; u += kThreads) {
      const int c = u / R, row = row0 + u % R;
      const bool in = row < n_rows;
      xs[u] = in ? __ldg(x + (size_t)row * d + c) : 0.f;
      ys[u] = in ? __ldg(y + (size_t)row * d + c) : 0.f;
      gys[u] = in ? __ldg(gy + (size_t)row * d + c) : 0.f;
      sr[u] = in ? T.s[(size_t)c * n_rows + row] : 0.f;
    }
    for (int u = tid; u < o.P[0] * R; u += kThreads) dsum[u] = 0.f;
    if (tid < R) hg[2 * R + tid] = row0 + tid < n_rows ? __ldg(gld + row0 + tid) : 0.f;
    compute_bar();
    for (int i = d - 1; i >= 0; --i, ++step) {
      // W0's row i - 1 over the first layer's slice (for this step's end);
      // y's gradient at feature i: gy_i plus what the first layer of every
      // later step sent back, W0[i, :] . dsum, a partial sum a CTA (the last
      // step's slot) added in CTA order; then the head's step
      if (i > 0) {
        const float* wrow = S.w[0] + (size_t)(i - 1) * w1 + S.c0[0];
        for (int p = tid; p < o.P[0]; p += kThreads) w0r[p] = p < S.cnt[0] ? __ldg(wrow + p) : 0.f;
      }
      {
        float g = tid < R ? gys[i * R + tid] : 0.f;
        if (i < d - 1) {
          float acc = 0.f;
          for (int cb = 0; cb < C; cb += kGradPass) {
            const int nc = imin(kGradPass, C - cb);
            stage_cg(stage, W.f + S.ex_part + ((size_t)((step - 1) & 1) * C + cb) * R, nc * RV);
            compute_bar();
            if (tid < R)
              for (int c = 0; c < nc; ++c) acc += stage[c * R + tid];
            compute_bar();
          }
          g += acc;
        }
        if (tid < R) {
          const int r = tid, row = row0 + r;
          const float sraw = sr[i * R + r];
          float s = sraw, ds = 1.f;
          if (s_bound > 0.f) {
            const float t = tanhf(sraw / s_bound);
            s = s_bound * t;
            ds = 1.f - t * t;
          }
          float gmu, gs;
          if (sign < 0) {
            const float gxi = g * expf(-s);
            gxs[i * R + r] = gxi;
            gmu = -gxi;
            gs = -g * ys[i * R + r] - hg[2 * R + r];
          } else {
            const float e = expf(s);
            gxs[i * R + r] = g * e;
            gmu = g;
            gs = g * xs[i * R + r] * e + hg[2 * R + r];
          }
          gs *= ds;
          hg[r] = gmu;
          hg[R + r] = gs;
          if (rank == 0 && row < n_rows) {
            G.head[((size_t)i * n_rows + row) * 2] = gmu;
            G.head[((size_t)i * n_rows + row) * 2 + 1] = gs;
          }
        }
      }
      compute_bar();

      // the last hidden layer's delta through head columns i and i + d: in
      // full into the stage (the next link's input), or at L = 1 this CTA's
      // slice into dsum; each thread's items kBatch at a time, their loads
      // (the head's columns, the tape) issued first
      {
        const float2* hcol = head2 + (size_t)i * wL;
        const float* zt = S.z[L - 1];
        const int c0 = S.c0[L - 1], cnt = S.cnt[L - 1];
        const int span = L > 1 ? wL : cnt, total = span * RV;
        for (int u0 = tid; u0 < total; u0 += kBatch * kThreads) {
          float2 h[kBatch];
          float4 zz[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int u = u0 + b * kThreads;
            h[b] = make_float2(0.f, 0.f);
            zz[b] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (u < total) {
              const int kk = u % span, v = u / span, k = L > 1 ? kk : c0 + kk;
              h[b] = __ldg(hcol + k);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int row = row0 + 4 * v + q;
                if (row < n_rows)
                  set_comp(zz[b], q, __ldg(zt + ((size_t)i * n_rows + row) * wL + k));
              }
            }
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int u = u0 + b * kThreads;
            if (u >= total) break;
            const int kk = u % span, v = u / span, k = L > 1 ? kk : c0 + kk;
            const float4 gm = hg4[v], gsv = hg4[RV + v];
            float4 g = make_float4(gm.x * h[b].x + gsv.x * h[b].y, gm.y * h[b].x + gsv.y * h[b].y,
                                   gm.z * h[b].x + gsv.z * h[b].y, gm.w * h[b].x + gsv.w * h[b].y);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              set_comp(g, q, row0 + 4 * v + q < n_rows ? comp(g, q) * slope(comp(zz[b], q)) : 0.f);
            if (k >= c0 && k < c0 + cnt) write_delta(L - 1, i, k, v, row0, g);
            if (L > 1) stage4[k * RV + v] = g;
            else dsum4[kk * RV + v] = add4(dsum4[kk * RV + v], g);
          }
        }
      }
      compute_bar();

      // down the links: layer l's delta (in full, in the stage) back
      // through the slice of W_l's rows to layer l - 1's slice
      for (int l = L - 1; l >= 1; --l) {
        const int K = S.width[l + 1], Pl = o.P[l - 1], ks = o.ks[l];
        const int cnt = S.cnt[l - 1], c0 = S.c0[l - 1];
        auto epi = [&](int g, int v, float4 (&z)[4]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gc = 4 * g + c;
            if (gc >= cnt) continue;
            const float4 dv = delta(l - 1, i, c0 + gc, v, row0, z[c]);
            write_delta(l - 1, i, c0 + gc, v, row0, dv);
            if (l - 1 >= 1)
              *reinterpret_cast<float4*>(W.f + S.ex[l - 1] + (size_t)(c0 + gc) * R + 4 * v) = dv;
            else
              dsum4[gc * RV + v] = add4(dsum4[gc * RV + v], dv);
          }
        };
        if (l < L - 1) {
          stage_cg(stage, W.f + S.ex[l], K * RV);
          compute_bar();
        }
        link<false>(stage, smem + o.wres[l], K, Pl, o.kc[l], ks, R, part, streamed, ring,
                    epi);
        if (l - 1 >= 1) group_sync(ctr, ++syncs * C, C);
        else compute_bar();
      }

      // W0[i - 1, :] . dsum over this CTA's slice, one partial sum a row,
      // out to the group's slot for the next step
      if (i > 0) {
        if (tid < R) {
          float p = 0.f;
          for (int col = 0; col < S.cnt[0]; ++col) p += w0r[col] * dsum[col * R + tid];
          W.f[S.ex_part + ((size_t)(step & 1) * C + rank) * R + tid] = p;
        }
        group_sync(ctr, ++syncs * C, C);
      }
    }
    if (rank == 0) {
      for (int u = tid; u < d * R; u += kThreads) {
        const int c = u % d, r = u / d;
        if (row0 + r < n_rows) gx[(size_t)(row0 + r) * d + c] = gxs[c * R + r];
      }
    }
    // no CTA starts the next tile's exchange while a peer still reads this one's
    group_sync(ctr, ++syncs * C, C);
  }
}

// The packed weights (blockIdx.y = 0: the head; y = l: link l's C slices).
struct Pack {
  long long base[kMaxLayers];
  int K[kMaxLayers], P[kMaxLayers];
  int C, backward;
};

__global__ void __launch_bounds__(kPackThreads)
streamed_pack_kernel(Net N, Pack K, float* __restrict__ out) {
  const int l = blockIdx.y, d = N.width[0], L = N.n - 1;
  const size_t step = (size_t)gridDim.x * kPackThreads;
  if (l == 0) {
    const int wL = N.width[L];
    const float* h = N.w[L];
    const size_t total = (size_t)d * wL * 2;
    for (size_t e = (size_t)blockIdx.x * kPackThreads + threadIdx.x; e < total; e += step) {
      const int c = (int)(e & 1);
      const size_t fk = e >> 1;
      const int k = (int)(fk % wL), i = (int)(fk / wL);
      out[e] = __ldg(h + (size_t)k * 2 * d + i + c * d);
    }
    return;
  }
  const int Kl = K.K[l], Pl = K.P[l];
  const float* w = N.w[l];
  const size_t slice = (size_t)Kl * Pl, total = (size_t)K.C * slice;
  float* dst = out + K.base[l];
  for (size_t e = (size_t)blockIdx.x * kPackThreads + threadIdx.x; e < total; e += step) {
    const int c = (int)(e / slice);
    const size_t es = e - (size_t)c * slice;
    if (!K.backward) {
      // slice c: [k][p] = W_l[k][c * P + p], read along p
      const int k = (int)(es / Pl), p = (int)(es % Pl);
      const int col = c * Pl + p, wout = N.width[l + 1];
      dst[e] = col < wout ? __ldg(w + (size_t)k * wout + col) : 0.f;
    } else {
      // slice c: [j][p] = W_l[c * P + p][j], read along j
      const int p = (int)(es / Kl), j = (int)(es % Kl);
      const int f = c * Pl + p;
      dst[(size_t)c * slice + (size_t)j * Pl + p] =
          f < N.width[l] ? __ldg(w + (size_t)f * Kl + j) : 0.f;
    }
  }
}

// Dynamic shared memory each kernel is opted in to, per device (bytes).
constexpr int kMaxDevices = 64;
int g_opt_in[2][kMaxDevices] = {};

template <class Kern>
cudaError_t opt_in(Kern kernel, int which, int dev, size_t smem) {
  if (dev < kMaxDevices && (int)smem <= g_opt_in[which][dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) g_opt_in[which][dev] = (int)smem;
  return err;
}

// The current device, its SM count and the shared memory a block may opt in to.
cudaError_t device_limits(int* dev, int* sms, int* limit) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  return err;
}

// The CTAs the current device runs at once of the forward (backward = 0)
// or the backward kernel at the most shared memory a CTA may take: the
// occupancy reading that every plan's grid is held to, read once a device.
// Every plan's CTA takes at most that shared memory, so at least as many
// run at once.
int g_ctas[2][kMaxDevices] = {};

cudaError_t device_ctas(bool backward, int* dev, int* ctas, int* limit) {
  int sms = 0;
  cudaError_t err = device_limits(dev, &sms, limit);
  if (err != cudaSuccess) return err;
  if (*dev < kMaxDevices && g_ctas[backward][*dev] > 0) {
    *ctas = g_ctas[backward][*dev];
    return cudaSuccess;
  }
  const size_t smem = (size_t)(*limit - kStaticSmem);
  int per_sm = 0;
  if (backward) {
    err = opt_in(streamed_backward_kernel, 1, *dev, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, streamed_backward_kernel, kBlock,
                                                          smem);
  } else {
    err = opt_in(streamed_forward_kernel, 0, *dev, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, streamed_forward_kernel, kBlock,
                                                          smem);
  }
  *ctas = per_sm * sms;
  if (err == cudaSuccess && *dev < kMaxDevices) g_ctas[backward][*dev] = *ctas;
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

// The caller's plan (ar_solve_streamed_plan's out, computed once for these
// widths and rows) checked against the current device and its own layout;
// the packing launch and the counters' memset on `st`. Returns the error.
cudaError_t prepare(const Net& P, bool backward, int n_rows, const long long* in, void* work,
                    cudaStream_t st, Plan* plan, Work* W) {
  int dev = 0, ctas = 0, limit = 0;
  cudaError_t err = device_ctas(backward, &dev, &ctas, &limit);
  if (err != cudaSuccess) return err;
  const int n = P.n;
  *plan = Plan{(int)in[0], (int)in[1], (int)in[2], (int)in[3], (int)in[4], in[5]};
  if (plan->c <= 0 || plan->rows < 4 || plan->rows > kMaxRows || plan->rows % 4 != 0 ||
      plan->groups <= 0 || plan->groups > cdiv(n_rows, plan->rows))
    return cudaErrorInvalidValue;
  if ((long long)plan->groups * plan->c > ctas) return cudaErrorCooperativeLaunchTooLarge;
  Layout o;
  const long long floats = layout(P.width, n, plan->c, plan->rows, backward, plan->cap, &o);
  if (floats < 0 || floats * 4 + kStaticSmem != plan->bytes || plan->bytes > limit ||
      plan->work != packed_floats(P.width, n, plan->c, backward, o) +
                        plan->groups * exchange_floats(P.width, n, plan->c, plan->rows, backward) +
                        plan->groups)
    return cudaErrorInvalidValue;
  err = backward ? opt_in(streamed_backward_kernel, 1, dev, (size_t)plan->bytes - kStaticSmem)
                 : opt_in(streamed_forward_kernel, 0, dev, (size_t)plan->bytes - kStaticSmem);
  if (err != cudaSuccess) return err;
  Pack K = {};
  K.C = plan->c;
  K.backward = backward;
  long long at = round4(2 * P.width[0] * P.width[n - 1]);
  for (int l = 1; l < n - 1; ++l) {
    K.base[l] = at;
    K.K[l] = link_k(P.width, l, backward);
    K.P[l] = link_p(o, l, backward);
    at += (long long)plan->c * K.K[l] * K.P[l];
  }
  W->f = static_cast<float*>(work);
  W->ctr = reinterpret_cast<unsigned*>(W->f + plan->work - plan->groups);
  streamed_pack_kernel<<<dim3(2 * ctas, n - 1), kPackThreads, 0, st>>>(P, K, W->f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(W->ctr, 0, sizeof(unsigned) * plan->groups, st);
}

cudaLaunchConfig_t coop_config(const Plan& p, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups * p.c);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = (size_t)p.bytes - kStaticSmem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeCooperative;
  attr->val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The CTAs of the forward (backward = 0) or the backward kernel the current
// device runs at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
// opt-in shared-memory limit, times the SMs): the plan's `ctas`. Returns
// it, or -(CUDA error).
int ar_solve_streamed_ctas(int backward) {
  int dev = 0, ctas = 0, limit = 0;
  const cudaError_t err = device_ctas(backward != 0, &dev, &ctas, &limit);
  return err != cudaSuccess ? -(int)err : ctas;
}

// The plan at these widths ([D, hidden..., 2D], n_layers + 1 of them) for
// the forward (backward = 0) or the backward (1), n_rows rows, on a card
// that runs `ctas` CTAs at once and allows smem_limit bytes of shared
// memory a CTA: out[0] a ring slot's floats at most (0: the weights
// resident),
// out[1] the CTAs of a row group, out[2] the rows of a tile, out[3] the
// groups, out[4] the shared memory of a CTA in bytes (dynamic and static),
// out[5] the floats of the workspace. Returns 0, or -1 where the kernels do
// not take these widths or no layout fits.
int ar_solve_streamed_plan(const int* width, int n_layers, int backward, int n_rows, int ctas,
                           int smem_limit, long long* out) {
  if (!takes(width, n_layers) || n_rows <= 0 || ctas <= 0) return -1;
  const Plan p = make_plan(width, n_layers, backward != 0, n_rows, ctas, smem_limit);
  if (p.c == 0) return -1;
  out[0] = p.cap;
  out[1] = p.c;
  out[2] = p.rows;
  out[3] = p.groups;
  out[4] = p.bytes;
  out[5] = p.work;
  return 0;
}

// x, y: (n_rows, D) f32; ld: (n_rows,); ws[l]: (width[l], width[l+1]) with
// the mask applied; bs[l]: (width[l+1],). When s is not null the launch also
// records the tape: zs[l] (D, n_rows, width[l+1]) for every hidden layer and
// s (D, n_rows). plan: ar_solve_streamed_plan's out for these widths and
// rows on this device, which the call checks but does not search again;
// work: its workspace (out[5] floats, 16-byte aligned). The packing launch,
// a memset, the cooperative launch on `stream`; returns the error (0 on
// success).
int ar_solve_streamed_forward(const void* x, const void* const* ws, const void* const* bs,
                              const int* width, int n_layers, int n_rows, int sign, float s_bound,
                              void* y, void* ld, void* const* zs, void* s, const long long* plan,
                              void* work, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, bs, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  const auto st = static_cast<cudaStream_t>(stream);
  Plan p;
  Work W;
  cudaError_t err = prepare(P, false, n_rows, plan, work, st, &p, &W);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = coop_config(p, st, &attr);
  err = cudaLaunchKernelEx(&cfg, streamed_forward_kernel, static_cast<const float*>(x), P, T, W,
                           p.c, p.rows, p.cap, n_rows, sign, s_bound, static_cast<float*>(y),
                           static_cast<float*>(ld));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The reverse chain. x, y, gy, gx: (n_rows, D); gld: (n_rows,); ws as for the
// forward; zs and s: the forward's tape; deltas[l]: (D, n_rows, width[l+1])
// for every hidden layer and head (D, n_rows, 2), written in full; plan and
// work as for the forward. The packing launch, a memset, the cooperative launch on
// `stream`; returns the error (0 on success).
int ar_solve_streamed_backward(const void* x, const void* y, const void* gy, const void* gld,
                               const void* const* ws, const int* width, int n_layers, int n_rows,
                               int sign, float s_bound, void* const* zs, void* s,
                               void* const* deltas, void* head, void* gx,
                               const long long* plan, void* work, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, nullptr, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  Deltas G = {};
  for (int l = 0; l < n_layers - 1; ++l) G.d[l] = static_cast<float*>(deltas[l]);
  G.head = static_cast<float*>(head);
  const auto st = static_cast<cudaStream_t>(stream);
  Plan p;
  Work W;
  cudaError_t err = prepare(P, true, n_rows, plan, work, st, &p, &W);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = coop_config(p, st, &attr);
  err = cudaLaunchKernelEx(&cfg, streamed_backward_kernel, static_cast<const float*>(x),
                           static_cast<const float*>(y), static_cast<const float*>(gy),
                           static_cast<const float*>(gld), P, T, G, W, p.c, p.rows, p.cap,
                           n_rows, sign, s_bound, static_cast<float*>(gx));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
