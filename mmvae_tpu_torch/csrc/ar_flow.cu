// Fused autoregressive-flow solve for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (:96, body _make_kernel :34) and the gradient the JAX package takes around
// it (_ar_solve_bwd :156: jax.vjp of unrolled_solve :113). The forward runs
// the whole D-step sequential solve of one MADE block in one launch: for i
// in 0..D-1 the masked MLP is evaluated on the partly built y, the head
// gives mu_i and s_i, and y_i and the log-det are updated:
//   sign -1 (IAF density):  y_i = (x_i - mu_i) * exp(-s_i)
//   sign +1 (MAF sampling): y_i = x_i * exp(s_i) + mu_i
//   logdet += sign * s_i, with s_i = B * tanh(s_i / B) when s_bound B > 0.
// The hidden ReLUs are JAX's jnp.maximum(z, 0): their slope is 1 above 0, 0
// below and 1/2 at an exact tie. The backward runs the reverse-mode chain
// over i = D-1..0 and returns the gradients of x, every weight and every
// bias, in two launches: the chain, whose blocks sum their own rows' weight
// and bias gradients as they go, then the sum of the blocks' partial sums
// in block order (no floating-point atomics: two launches on the same
// inputs give bitwise equal gradients).
//
// Widths: every hidden layer is kHidden = 128 wide, the only width the
// port's MADE blocks have and the only one the kernels are tested at; the
// launchers refuse others. D and the number of hidden layers are free, up
// to what shared memory holds (ar_solve_smem_bytes computes it): the
// forward takes three hidden layers at every D up to 256, five at none; the
// backward one to three (shared memory refuses four).
//
// What bounds them: latency. Each chain needs 2*N*D*(H + (L-1)*H*H + 2*H)
// flops (170 MFLOP at N=128, D=20, H=128, L=3 hidden layers), 2.5 us at the
// f32 peak, and the backward as much again for the weight gradients. But
// the work is a chain of D x (L+1) dependent matrix-vector products over a
// few rows, each a few thousand cycles for one SM, with a block-wide
// barrier between links. The length of each link and the number of SMs
// that share the rows set the time, not flops or bytes. The backward reads
// the forward's tape once (N*D*L*H floats, 0.76 GB at N=7,680, D=64), and
// no per-step delta reaches device memory: a step writes only its row of
// the first layer's gradient and its two columns of the head's, 3 * 128
// floats a block, into the block's own slice of an L2-resident workspace.
//
// Tensor cores: not used. A link of the chain is a matrix-vector product
// over a tile of 4 rows, thinner than an mma tile, and TF32 keeps three
// decimal digits where the plain versions are float32. The weight-gradient
// updates (outer products of depth 4) ran on them in 3xTF32 (m16n8k4) and
// held the tolerances, but took no less time than on the CUDA cores: they
// run beside the chain's links, which set the time.
//
// Design, both kernels:
// - A block owns kTile=4 rows at a time and has 16 warps. The hidden
//   kHidden x kHidden layers (132 KB with two of them) are staged once into
//   dynamic shared memory by cp.async, with row stride out+1 so that they
//   read without bank conflicts along either index, and stay there for all
//   D steps. Activations are feature-major ([feature][row]): one float4
//   broadcast read feeds the four rows.
// - Step i reads only one row of the first layer and two columns of the
//   head, so those two weights stay in device memory (L2 after the first
//   block): each thread loads the three values it needs for the next step
//   into registers while the current step runs. Shared memory then grows
//   with D only by the O(D) tiles, and latent 64 (MADE widths [64, 128, 128,
//   128, 128]) fits, where staging the first layer and the head as well
//   needed more than the H100's 227 KB.
// - A hidden layer (hidden_layer) is spread over the block: warp s < 8
//   sums input features 16s..16s+15 for all 128 output columns, four per
//   thread, and the eight partial sums meet in shared memory. A warp's
//   serial loop is 16 features long, not 128.
// - The first layer's input, the partly built y, gains one feature per
//   step. The forward keeps the first layer's pre-activation and adds one
//   rank-1 term per step (O(H), no reduction). The backward keeps dsum, the
//   first layer's deltas summed over the later steps, and reads y's
//   gradient at feature i as gy_i + W0[i, :] . dsum.
// - Step i needs only head columns i and i+D: every warp sums its share of
//   the two dot products and four threads finish the rows.
// - When gradients are wanted the forward records each step's hidden
//   pre-activations and the head's raw log-scale (the tape).
// Backward only:
// - Persistent blocks: the grid is min(tiles, SMs) (the wrapper sizes it),
//   and block b walks tiles b, b + grid, ... in turn, so that each block
//   keeps one partial sum of the weight gradients for all its tiles.
// - Each step copies the tile's pre-activations of step i - 1 from the tape
//   into a second shared buffer by cp.async while step i runs. A thread
//   reads its own (feature, row) of every layer once: its three ReLU
//   slopes (1, 1/2, 0), kept in registers for the step's links, and the
//   layer's output max(z, 0), written back in place.
// - A hidden layer's links run on one group of 8 warps while the other
//   group adds the step's rank-4 update to that layer's weight gradient,
//   from the step's activations and deltas in shared memory, and
//   the next layer down swaps the groups. The gradient lives in the
//   registers of the group that updates it, 64 entries a thread, so the
//   updates of both 128 x 128 layers at three hidden layers take no time of
//   their own on the chain.
// - Step i touches only row i of the first layer's gradient (the rank-1
//   form y_i * dsum, dsum read before step i's delta joins it) and head
//   columns i and i + D. Those go to the block's own slice of a workspace
//   in device memory, which no other block writes (3 * 128 * D floats a
//   block, L2-resident): the staged hidden layers and D x 384 floats of
//   them do not both fit in shared memory. One thread owns each entry,
//   loads its old value one step ahead and stores the new one just before
//   the step's hidden layers, whose links outlast the store.
// - The bias sums go beside the weight gradients (the hidden ones in
//   registers, the head's in the slice).
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32), so both kernels
// agree with the f32 PyTorch versions up to summation order, and every sum
// is taken in an order fixed by the shapes and the SM count alone.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHidden = 128;                   // width of every hidden layer
constexpr int kChunk = 16;                     // input features one warp sums in a hidden layer
constexpr int kSlices = kHidden / kChunk;      // warps that share a hidden layer's inputs
constexpr int kPartFloats = kSlices * kHidden * kTile;  // partial sums of one hidden layer
constexpr int kMaxLayers = 8;
constexpr int kMaxBackwardHidden = 3;          // hidden layers the backward takes
constexpr int kGroupEntries = 2 * kHidden * kHidden / kThreads;  // weight-gradient entries a thread owns
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 4, "activations are read as one float4 per feature");
static_assert(kHidden == 32 * 4, "a lane owns four columns of a hidden layer, 32 apart");
static_assert(kHidden * kTile == kThreads, "one thread per (hidden feature, row)");
static_assert(kSlices <= kWarps && kSlices % 4 == 0, "slices are summed four at a time");
static_assert(3 * kHidden + 2 <= kThreads, "one thread per entry of a step's workspace row");
static_assert(kWarps == 2 * kSlices, "the backward's hidden layers alternate two warp groups");
static_assert(kGroupEntries == 16 * 4, "16 rows x 4 columns of a weight gradient a thread");

struct Layers {
  const float* w[kMaxLayers];  // (in, out) row-major, mask applied
  const float* b[kMaxLayers];  // (out,)
  int width[kMaxLayers + 1];   // width[0] = D, width[1..n-1] = kHidden, width[n] = 2D
  int n;                       // hidden layers + head
};

// The forward's record of each step, read by the backward. z[l] is
// (D, N, kHidden): hidden layer l's pre-activation at step i; s is (D, N),
// the head's log-scale before the bound. The forward records nothing when
// s is null.
struct Tape {
  float* z[kMaxLayers];
  float* s;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// A staged hidden layer (kHidden, kHidden) is kept with row stride
// kHidden + 1, so that reading it along either index is free of bank
// conflicts.
constexpr int kPadded = round4(kHidden * (kHidden + 1));

// The staged weights: the n - 2 hidden kHidden x kHidden layers. The first
// layer and the head stay in device memory.
inline int weight_floats(int n) { return (n - 2) * kPadded; }

// Whether the kernels take these widths: 1..kMaxLayers-1 hidden layers of
// kHidden, a head of 2D.
bool takes(const int* width, int n) {
  if (n < 2 || n > kMaxLayers || width[0] < 2 || width[n] != 2 * width[0]) return false;
  for (int l = 1; l < n; ++l) {
    if (width[l] != kHidden) return false;
  }
  return true;
}

// Floats of every weight and bias, in the parameters' order: the n weights
// (width[l], width[l+1]), then the n biases (width[l+1],). The layout of
// the backward's gradients and of each block's partial sums.
inline int param_floats(const int* width, int n) {
  int p = 0;
  for (int l = 0; l < n; ++l) p += width[l] * width[l + 1] + width[l + 1];
  return p;
}

// Shared-memory layout, in floats; every segment is a multiple of four.
// Forward: the staged hidden weights, biases, the x and y tiles, two
// activation buffers, the first layer's pre-activation, the head's per-warp
// sums, the partial sums. Backward: the staged hidden weights; the x, y,
// y-gradient, x-gradient and raw-s tiles; the log-det gradient and the head
// gradients (4 * kTile); two buffers of every hidden layer's pre-activation
// at a step; every hidden layer's delta at the step; dsum; the per-warp
// sums of y's gradient; the partial sums.
inline int smem_floats(const int* width, int n, bool backward) {
  const int d = width[0];
  if (!backward) {
    int biases = 0;
    for (int l = 0; l < n; ++l) biases += round4(width[l + 1]);
    return weight_floats(n) + 2 * kHidden * kTile + kPartFloats + biases + 2 * d * kTile +
           kHidden * kTile + 2 * kWarps * kTile;
  }
  return weight_floats(n) + 5 * d * kTile + 4 * kTile + 3 * (n - 1) * kHidden * kTile +
         kHidden * kTile + kWarps * kTile + kPartFloats;
}

// The head's weights, L.w[L.n - 1], read with static indices only (a
// kernel parameter indexed at run time is copied to local memory).
__device__ inline const float* head_weights(const Layers& L) {
  const float* w = nullptr;
#pragma unroll
  for (int l = 1; l < kMaxLayers; ++l) {
    if (l == L.n - 1) w = L.w[l];
  }
  return w;
}

__device__ inline void fma4(float4& acc, const float4& a, float w) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
}

__device__ inline void stage_wait() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ inline void copy4_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// dst = src (kHidden, kHidden) with row stride kHidden + 1, by 4-byte
// cp.async: neighbouring threads copy neighbouring floats of a row.
// Completed by cp.async.wait_all.
__device__ inline void stage_padded(float* dst, const float* __restrict__ src) {
  constexpr int per = kThreads / kHidden;
  const int k0 = threadIdx.x / kHidden, j = threadIdx.x % kHidden;
  for (int k = k0; k < kHidden; k += per)
    copy4_async(dst + k * (kHidden + 1) + j, src + k * kHidden + j);
}

// One slice of a kHidden -> kHidden layer over the tile, by one warp:
// slice s < kSlices sums input features kChunk*s.. of in[k][r] * M[k * ks +
// j * js] for columns j = lane + 32c (c < 4), so each broadcast read of
// in[k] feeds 16 FMAs, and leaves its partial sums in `part`.
__device__ __forceinline__ void layer_slice(const float* __restrict__ in,
                                            const float* __restrict__ M, int ks, int js,
                                            float4* __restrict__ part, int s) {
  const int lane = threadIdx.x % 32;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4 acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = s * kChunk; k < (s + 1) * kChunk; ++k) {
    const float4 a = in4[k];
    const float* w = M + k * ks + lane * js;
#pragma unroll
    for (int c = 0; c < 4; ++c) fma4(acc[c], a, w[32 * c * js]);
  }
  float4* ps = part + s * kHidden + lane;
#pragma unroll
  for (int c = 0; c < 4; ++c) ps[32 * c] = acc[c];
}

// The slices' partial sums at column threadIdx.x / kTile, row
// threadIdx.x % kTile: the layer's output there.
__device__ __forceinline__ float layer_sum(const float4* __restrict__ part) {
  const float* q = reinterpret_cast<const float*>(part) + threadIdx.x;
  constexpr int stride = kHidden * kTile;  // floats between slices
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
#pragma unroll
  for (int t = 0; t < kSlices; t += 4) {
    v0 += q[t * stride];
    v1 += q[(t + 1) * stride];
    v2 += q[(t + 2) * stride];
    v3 += q[(t + 3) * stride];
  }
  return (v0 + v1) + (v2 + v3);
}

// One kHidden -> kHidden layer over the tile:
// epi(j, r, sum_k in[k][r] * M[k * ks + j * js]) for every column j and row
// r < kTile, one (j, r) per thread: j = threadIdx.x / kTile, r =
// threadIdx.x % kTile. Warps s < kSlices run the slices (layer_slice).
// Ends with a barrier, so the outputs are visible to all threads.
template <class Epi>
__device__ __forceinline__ void hidden_layer(const float* in, const float* M, int ks, int js,
                                             float4* part, Epi epi) {
  const int s = threadIdx.x / 32;
  if (s < kSlices) layer_slice(in, M, ks, js, part, s);
  __syncthreads();
  epi(threadIdx.x / kTile, threadIdx.x % kTile, layer_sum(part));
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ar_solve_forward_kernel(const float* __restrict__ x, Layers L, Tape T, int n_rows, int sign,
                        float s_bound, float* __restrict__ y_out, float* __restrict__ ld_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float* zt[kMaxLayers];
  const int n = L.n, d = L.width[0], tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kTile;
  const bool record = T.s != nullptr;

  // the hidden kHidden x kHidden layers, then every bias
  float* p = smem;
#pragma unroll
  for (int l = 1; l < kMaxLayers - 1; ++l) {
    if (l < n - 1) {
      stage_padded(p, L.w[l]);
      p += kPadded;
    }
  }
  const float* bias = p;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l < n) {
      for (int k = tid; k < L.width[l + 1]; k += kThreads) copy4_async(p + k, L.b[l] + k);
      p += round4(L.width[l + 1]);
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (tid == l) zt[l] = T.z[l];
  }
  float* xs = p;
  float* yT = xs + d * kTile;
  float* hA = yT + d * kTile;
  float* hB = hA + kHidden * kTile;
  float* z0 = hB + kHidden * kTile;    // the first layer's pre-activation
  float* hsum = z0 + kHidden * kTile;  // the head's per-warp sums
  float4* part = reinterpret_cast<float4*>(hsum + 2 * kWarps * kTile);
  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u / kTile, row = row0 + u % kTile;
    xs[u] = row < n_rows ? x[(size_t)row * d + c] : 0.f;
    yT[u] = 0.f;
  }
  z0[tid] = L.b[0][tid / kTile];
  stage_wait();
  __syncthreads();

  float ld = 0.f;  // owned by thread r < kTile for row r of the tile
  const int jt = tid / kTile, rt = tid % kTile;  // this thread's hidden feature and row
  const bool row_in = row0 + rt < n_rows;
  // the first layer (d, kHidden) and the head (kHidden, 2d) in device
  // memory: this thread's W0[i - 1, jt] and head entries (jt, i), (jt, i + d)
  // for step i, loaded one step ahead
  const float* W0 = L.w[0];
  const float* Wh = head_weights(L) + jt * 2 * d;
  float w0 = 0.f, wm = __ldg(Wh), ws = __ldg(Wh + d);
  for (int i = 0; i < d; ++i) {
    float w0_next = 0.f, wm_next = 0.f, ws_next = 0.f;
    if (i + 1 < d) {
      w0_next = __ldg(W0 + i * kHidden + jt);
      wm_next = __ldg(Wh + i + 1);
      ws_next = __ldg(Wh + i + 1 + d);
    }
    // first layer: y gained feature i - 1 in the last step, so its
    // pre-activation gains one rank-1 term, y_{i-1} * W0[i-1, :]
    if (i > 0) z0[tid] = fmaf(yT[(i - 1) * kTile + rt], w0, z0[tid]);
    {
      const float z = z0[tid];
      hA[tid] = fmaxf(z, 0.f);
      if (record && row_in) zt[0][((size_t)i * n_rows + row0 + rt) * kHidden + jt] = z;
    }
    __syncthreads();
    const float* in = hA;
    const float* W = smem;
    const float* b = bias + kHidden;
    float* out = hB;
    for (int l = 1; l < n - 1; ++l) {
      float* tape = record ? zt[l] : nullptr;
      hidden_layer(in, W, kHidden + 1, 1, part, [&](int j, int r, float v) {
        const float z = v + b[j];
        out[j * kTile + r] = fmaxf(z, 0.f);
        if (tape != nullptr && row0 + r < n_rows)
          tape[((size_t)i * n_rows + row0 + r) * kHidden + j] = z;
      });
      W += kPadded;
      b += kHidden;
      in = out;
      out = (out == hA) ? hB : hA;
    }

    // head: columns i (mu) and i + d (s). Every thread multiplies its
    // hidden feature, the warps' sums meet in hsum, and thread r < kTile
    // finishes row r.
    {
      const float h = in[tid];
      float pm = h * wm, ps = h * ws;  // this thread's row is lane % kTile
#pragma unroll
      for (int off = kTile; off < 32; off *= 2) {
        pm += __shfl_xor_sync(kFull, pm, off);
        ps += __shfl_xor_sync(kFull, ps, off);
      }
      if (lane < kTile) {
        hsum[warp * kTile + lane] = pm;
        hsum[(kWarps + warp) * kTile + lane] = ps;
      }
    }
    __syncthreads();
    if (tid < kTile) {
      const int row = row0 + tid;
      float mu = b[i], s = b[i + d];
      for (int w = 0; w < kWarps; ++w) {
        mu += hsum[w * kTile + tid];
        s += hsum[(kWarps + w) * kTile + tid];
      }
      if (record && row < n_rows) T.s[(size_t)i * n_rows + row] = s;
      if (s_bound > 0.f) s = s_bound * tanhf(s / s_bound);
      const float xi = xs[i * kTile + tid];
      yT[i * kTile + tid] = sign < 0 ? (xi - mu) * expf(-s) : xi * expf(s) + mu;
      ld += sign < 0 ? -s : s;
    }
    w0 = w0_next;
    wm = wm_next;
    ws = ws_next;
    __syncthreads();
  }

  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u % d, r = u / d;
    if (row0 + r < n_rows) y_out[(size_t)(row0 + r) * d + c] = yT[c * kTile + r];
  }
  if (tid < kTile && row0 + tid < n_rows) ld_out[row0 + tid] = ld;
}

// The tile's pre-activations of every hidden layer at step i, from the tape
// into dst ([layer][feature][row]) by 4-byte cp.async: thread t copies
// feature t / kTile of row t % kTile. Rows past n_rows are 0.
template <int kH>
__device__ inline void load_z(float* dst, const Tape& T, int i, int row0, int n_rows) {
  const int k = threadIdx.x / kTile, row = row0 + threadIdx.x % kTile;
#pragma unroll
  for (int l = 0; l < kH; ++l) {
    float* out = dst + l * kHidden * kTile + threadIdx.x;
    if (row < n_rows)
      copy4_async(out, T.z[l] + ((size_t)i * n_rows + row) * kHidden + k);
    else
      *out = 0.f;
  }
}

// The reverse chain at kHH + 1 hidden layers (kHH hidden-to-hidden ones).
// Block b walks tiles b, b + gridDim.x, ...; at the end it leaves its
// partial sums of every weight and bias gradient in work + b * n_params, in
// the parameters' order (param_floats).
template <int kHH>
__global__ void __launch_bounds__(kThreads, 1)
ar_solve_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ gy, const float* __restrict__ gld, Layers L,
                         Tape T, int n_rows, int sign, float s_bound, float* __restrict__ gx,
                         float* __restrict__ work, int n_params) {
  constexpr int kH = kHH + 1;               // hidden layers
  constexpr int kLayer = kHidden * kTile;   // floats of one layer over the tile
  extern __shared__ __align__(16) float smem[];
  const int d = L.width[0], tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (n_rows + kTile - 1) / kTile;

  // the hidden kHidden x kHidden layers: layer l (1 <= l <= kHH) at
  // (l - 1) * kPadded
  float* p = smem;
#pragma unroll
  for (int l = 1; l <= kHH; ++l) {
    stage_padded(p, L.w[l]);
    p += kPadded;
  }
  float* xs = p;
  float* ys = xs + d * kTile;
  float* gyT = ys + d * kTile;
  float* gxT = gyT + d * kTile;
  float* sr = gxT + d * kTile;  // raw log-scale of each step
  float* gl = sr + d * kTile;   // log-det gradient of each row
  float* hd = gl + kTile;       // mu and s gradients of the step
  float* zbuf = gl + 4 * kTile;          // two buffers of the step's pre-activations
  float* dl = zbuf + 2 * kH * kLayer;    // every hidden layer's delta at the step
  float* dsum = dl + kH * kLayer;        // the first layer's deltas, summed over later steps
  float* ysum = dsum + kLayer;           // per-warp sums of y's gradient at the step's feature
  float4* part = reinterpret_cast<float4*>(ysum + kWarps * kTile);

  // this block's partial sums in the parameters' order: W0 (d, kHidden),
  // the hidden layers, the head (kHidden, 2d), the hidden biases, the head's
  float* mine = work + (size_t)blockIdx.x * n_params;
  float* pW0 = mine;
  float* pWh = mine + d * kHidden + kHH * kHidden * kHidden;
  float* pB = pWh + kHidden * 2 * d;
  float* pBh = pB + kH * kHidden;
  // the workspace entry this thread owns at step i: row i of the first
  // layer's gradient (threads 0..127), head columns i and i + d (128..383),
  // the head's biases i and i + d (384, 385)
  const bool owns = tid < 3 * kHidden + 2;
  auto slot = [&](int i) -> float* {
    if (tid < kHidden) return pW0 + i * kHidden + tid;
    if (tid < 3 * kHidden) return pWh + (tid % kHidden) * 2 * d + i + (tid / kHidden - 1) * d;
    return pBh + i + (tid - 3 * kHidden) * d;
  };

  // The hidden-to-hidden weight gradients: hidden layer l's links run on
  // warp group (kH - 1 - l) % 2 (warps 0-7 or 8-15) while the other group
  // updates layer l's weight gradient, so each of the (at most
  // two) hidden-to-hidden layers is owned by one group, kGroupEntries
  // entries a thread: my_l, 0 for none. The hidden biases: entry tid of
  // each, by threads < kHidden.
  const int group = warp / kSlices;
  int my_l = 0;
#pragma unroll
  for (int l = 1; l <= kHH; ++l) {
    if (1 - ((kH - 1 - l) & 1) == group) my_l = l;
  }
  float acc[kGroupEntries];
  float accB[kH];
#pragma unroll
  for (int m = 0; m < kGroupEntries; ++m) acc[m] = 0.f;
#pragma unroll
  for (int l = 0; l < kH; ++l) accB[l] = 0.f;

  const int kt = tid / kTile, rt = tid % kTile;  // this thread's hidden feature and row
  // the first layer (d, kHidden) and the head (kHidden, 2d) in device
  // memory: this thread's W0[i, kt] and head entries (kt, i), (kt, i + d)
  const float* W0 = L.w[0] + kt;
  const float* Wh = head_weights(L) + kt * 2 * d;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    const bool first = tile == (int)blockIdx.x;
    __syncthreads();  // the last tile's reads of the tiles are done
    dsum[tid] = 0.f;
    for (int u = tid; u < d * kTile; u += kThreads) {
      const int c = u / kTile, row = row0 + u % kTile;
      const bool in = row < n_rows;
      xs[u] = in ? x[(size_t)row * d + c] : 0.f;
      ys[u] = in ? y[(size_t)row * d + c] : 0.f;
      gyT[u] = in ? gy[(size_t)row * d + c] : 0.f;
      sr[u] = in ? T.s[(size_t)c * n_rows + row] : 0.f;
    }
    if (tid < kTile) gl[tid] = row0 + tid < n_rows ? gld[row0 + tid] : 0.f;
    load_z<kH>(zbuf + ((d - 1) & 1) * kH * kLayer, T, d - 1, row0, n_rows);
    // this thread's weights and workspace entry for step i, loaded one step
    // ahead
    float w0 = __ldg(W0 + (d - 1) * kHidden), wm = __ldg(Wh + d - 1), ws = __ldg(Wh + 2 * d - 1);
    float old = owns && !first ? *slot(d - 1) : 0.f;
    for (int i = d - 1; i >= 0; --i) {
      float w0_next = 0.f, wm_next = 0.f, ws_next = 0.f, old_next = 0.f;
      if (i > 0) {
        w0_next = __ldg(W0 + (i - 1) * kHidden);
        wm_next = __ldg(Wh + i - 1);
        ws_next = __ldg(Wh + i - 1 + d);
        if (owns && !first) old_next = *slot(i - 1);
      }
      stage_wait();
      __syncthreads();  // step i's pre-activations are in; step i + 1 is done
      if (i > 0) load_z<kH>(zbuf + ((i - 1) & 1) * kH * kLayer, T, i - 1, row0, n_rows);
      float* zs = zbuf + (i & 1) * kH * kLayer;
      // this thread's ReLU slopes at step i, and each layer's output in place
      float slope[kH];
#pragma unroll
      for (int l = 0; l < kH; ++l) {
        const float z = zs[l * kLayer + tid];
        slope[l] = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
        zs[l * kLayer + tid] = fmaxf(z, 0.f);
      }

      // y's gradient at feature i: gy_i plus what the first layer of every
      // later step sent back, W0[i, :] . dsum; and row i of the first
      // layer's gradient, sum over rows of y_i * dsum
      {
        float pg = w0 * dsum[tid];  // this thread's row is lane % kTile
#pragma unroll
        for (int off = kTile; off < 32; off *= 2) pg += __shfl_xor_sync(kFull, pg, off);
        if (lane < kTile) ysum[warp * kTile + lane] = pg;
      }
      // this thread's workspace entry at step i, stored once the step's
      // head gradient is known too, just before the hidden layers' links
      // (a store just before a barrier held that barrier up)
      float entry = old;
      if (tid < kHidden) {
        const float4 s4 = reinterpret_cast<const float4*>(dsum)[tid];
        const float* yi = ys + i * kTile;
        entry += ((yi[0] * s4.x + yi[1] * s4.y) + yi[2] * s4.z) + yi[3] * s4.w;
      }
      __syncthreads();
      if (tid < kTile) {
        const int r = tid;
        float g = gyT[i * kTile + r];
        for (int w = 0; w < kWarps; ++w) g += ysum[w * kTile + r];
        const float sraw = sr[i * kTile + r];
        float s = sraw, ds = 1.f;
        if (s_bound > 0.f) {
          const float t = tanhf(sraw / s_bound);
          s = s_bound * t;
          ds = 1.f - t * t;
        }
        float gs;
        if (sign < 0) {
          const float gxi = g * expf(-s);
          gxT[i * kTile + r] = gxi;
          hd[r] = -gxi;
          gs = -g * ys[i * kTile + r] - gl[r];
        } else {
          const float e = expf(s);
          gxT[i * kTile + r] = g * e;
          hd[r] = g;
          gs = g * xs[i * kTile + r] * e + gl[r];
        }
        hd[kTile + r] = gs * ds;
      }
      __syncthreads();

      // the last hidden layer's delta through head columns i and i + D; the
      // head's gradient at those columns and its biases
      {
        const float v = (hd[rt] * wm + hd[kTile + rt] * ws) * slope[kH - 1];
        dl[(kH - 1) * kLayer + tid] = v;
        if (kH == 1) dsum[tid] += v;
      }
      if (tid >= kHidden && tid < 3 * kHidden) {
        const float4 h = reinterpret_cast<const float4*>(zs + (kH - 1) * kLayer)[tid % kHidden];
        const float* g = hd + (tid / kHidden - 1) * kTile;
        entry += ((h.x * g[0] + h.y * g[1]) + h.z * g[2]) + h.w * g[3];
      } else if (tid >= 3 * kHidden && owns) {
        const float* g = hd + (tid - 3 * kHidden) * kTile;
        entry += (g[0] + g[1]) + (g[2] + g[3]);
      }
      __syncthreads();
      if (owns) *slot(i) = entry;

      // back through the hidden layers with W^T (W read along its rows),
      // down to the first layer's delta, which joins dsum. Layer l's links
      // run on warp group (kH - 1 - l) % 2 while the other group adds the
      // step's rank-4 update to layer l's weight gradient, the sum over the
      // tile's rows of its input h (the layer below's output) times its
      // delta: a thread of the owning group holds entries (16 * (warp % 8) +
      // a, lane + 32 * c), a < 16, c < 4, in acc[4 * a + c], and one
      // broadcast read of h feeds 16 FMAs. Not unrolled: with two layers'
      // code one after the other, nvcc reordered their shared-memory
      // accesses across the barriers between them (wrong deltas, different
      // from run to run).
#pragma unroll 1
      for (int l = kH - 1; l >= 1; --l) {
        const float* in = dl + l * kLayer;
        const int s = warp - ((kH - 1 - l) & 1) * kSlices;
        if (s >= 0 && s < kSlices) {
          layer_slice(in, smem + (l - 1) * kPadded, 1, kHidden + 1, part, s);
        } else if (l == my_l) {
          const float4* h4 = reinterpret_cast<const float4*>(zs + (l - 1) * kLayer) +
                             16 * (warp % kSlices);
          const float4* d4 = reinterpret_cast<const float4*>(in) + lane;
          float4 dv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) dv[c] = d4[32 * c];
#pragma unroll
          for (int a = 0; a < 16; ++a) {
            const float4 h = h4[a];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float v = fmaf(h.x, dv[c].x, acc[4 * a + c]);
              v = fmaf(h.y, dv[c].y, v);
              v = fmaf(h.z, dv[c].z, v);
              acc[4 * a + c] = fmaf(h.w, dv[c].w, v);
            }
          }
        }
        __syncthreads();
        float f = slope[0];  // slope[l - 1], by static indices
#pragma unroll
        for (int q = 1; q < kH - 1; ++q) {
          if (q == l - 1) f = slope[q];
        }
        const float v = layer_sum(part) * f;
        dl[(l - 1) * kLayer + tid] = v;
        if (l == 1) dsum[tid] += v;
        __syncthreads();
      }

      // the step's hidden bias gradients, summed over the tile's rows
      if (tid < kHidden) {
#pragma unroll
        for (int l = 0; l < kH; ++l) {
          const float4 v = reinterpret_cast<const float4*>(dl + l * kLayer)[tid];
          accB[l] += (v.x + v.y) + (v.z + v.w);
        }
      }
      w0 = w0_next;
      wm = wm_next;
      ws = ws_next;
      old = old_next;
    }

    for (int u = tid; u < d * kTile; u += kThreads) {
      const int c = u % d, r = u / d;
      if (row0 + r < n_rows) gx[(size_t)(row0 + r) * d + c] = gxT[c * kTile + r];
    }
  }

  if (my_l > 0) {
    float* dst = mine + d * kHidden + (my_l - 1) * kHidden * kHidden + 16 * (warp % kSlices) *
                 kHidden + lane;
#pragma unroll
    for (int a = 0; a < 16; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[a * kHidden + 32 * c] = acc[4 * a + c];
    }
  }
  if (tid < kHidden) {
#pragma unroll
    for (int l = 0; l < kH; ++l) pB[l * kHidden + tid] = accB[l];
  }
}

// out[p] = sum over blocks b = 0, 1, ... of work[b * n + p], in that order.
__global__ void __launch_bounds__(kSumThreads)
ar_solve_sum_kernel(const float* __restrict__ work, int n_parts, int n, float* __restrict__ out) {
  const int p = blockIdx.x * kSumThreads + threadIdx.x;
  if (p >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < n_parts; ++b) s += work[(size_t)b * n + p];
  out[p] = s;
}

// Dynamic shared memory each kernel is opted in to, per device (bytes):
// the forward, then the backward at 1, 2 and 3 hidden layers.
constexpr int kMaxDevices = 64;
int g_opt_in[1 + kMaxBackwardHidden][kMaxDevices] = {};

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device, once per size.
template <class K>
cudaError_t opt_in(K kernel, int which, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (int)smem <= g_opt_in[which][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) g_opt_in[which][dev] = (int)smem;
  return err;
}

Layers make_layers(const void* const* ws, const void* const* bs, const int* width, int n) {
  Layers L = {};
  L.n = n;
  for (int l = 0; l < n; ++l) {
    L.w[l] = static_cast<const float*>(ws[l]);
    L.b[l] = bs != nullptr ? static_cast<const float*>(bs[l]) : nullptr;
  }
  for (int l = 0; l <= n; ++l) L.width[l] = width[l];
  return L;
}

Tape make_tape(void* const* zs, void* s, int n) {
  Tape T = {};
  for (int l = 0; zs != nullptr && l < n - 1; ++l) T.z[l] = static_cast<float*>(zs[l]);
  T.s = static_cast<float*>(s);
  return T;
}

template <int kHH>
cudaError_t launch_backward(const float* x, const float* y, const float* gy, const float* gld,
                            const Layers& L, const Tape& T, int n_rows, int sign, float s_bound,
                            float* gx, float* work, int n_params, int n_blocks, size_t smem,
                            cudaStream_t stream) {
  const cudaError_t err = opt_in(ar_solve_backward_kernel<kHH>, 1 + kHH, smem);
  if (err != cudaSuccess) return err;
  ar_solve_backward_kernel<kHH><<<n_blocks, kThreads, smem, stream>>>(
      x, y, gy, gld, L, T, n_rows, sign, s_bound, gx, work, n_params);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the forward (backward = 0) or the
// backward (backward = 1) needs, in bytes; -1 if the kernels do not take
// these widths.
long long ar_solve_smem_bytes(const int* width, int n_layers, int backward) {
  if (!takes(width, n_layers)) return -1;
  return (long long)smem_floats(width, n_layers, backward != 0) * (long long)sizeof(float);
}

// x, y: (n_rows, D) f32; ld: (n_rows,) f32; ws[l]: (width[l], width[l+1])
// f32 with the mask applied; bs[l]: (width[l+1],). When s is not null the
// launch also records the tape: zs[l] (D, n_rows, kHidden) for every hidden
// layer and s (D, n_rows). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int ar_solve_forward(const void* x, const void* const* ws, const void* const* bs,
                     const int* width, int n_layers, int n_rows, int sign, float s_bound,
                     void* y, void* ld, void* const* zs, void* s, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Layers L = make_layers(ws, bs, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  const size_t smem = (size_t)smem_floats(width, n_layers, false) * sizeof(float);
  const cudaError_t err = opt_in(ar_solve_forward_kernel, 0, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + kTile - 1) / kTile);
  ar_solve_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), L, T, n_rows, sign, s_bound, static_cast<float*>(y),
      static_cast<float*>(ld));
  return (int)cudaGetLastError();
}

// The reverse chain and the sum of its blocks' partial sums. x, y, gy, gx:
// (n_rows, D); gld: (n_rows,); ws as for the forward; zs and s: the
// forward's tape; grads: every weight gradient then every bias gradient,
// flat in the parameters' order (param_floats of them), written in full;
// work: (n_blocks, param_floats) scratch, n_blocks at most the number of
// row tiles. Two launches on `stream`; returns cudaGetLastError().
int ar_solve_backward(const void* x, const void* y, const void* gy, const void* gld,
                      const void* const* ws, const int* width, int n_layers, int n_rows,
                      int sign, float s_bound, void* const* zs, void* s, void* gx, void* grads,
                      void* work, int n_blocks, void* stream) {
  if (!takes(width, n_layers) || n_layers - 1 > kMaxBackwardHidden || n_rows <= 0 ||
      n_blocks <= 0 || n_blocks > (n_rows + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  const Layers L = make_layers(ws, nullptr, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  const int n_params = param_floats(width, n_layers);
  const size_t smem = (size_t)smem_floats(width, n_layers, true) * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* gyf = static_cast<const float*>(gy);
  const auto* gldf = static_cast<const float*>(gld);
  auto* gxf = static_cast<float*>(gx);
  auto* wf = static_cast<float*>(work);
  cudaError_t err;
  switch (n_layers - 2) {
    case 0:
      err = launch_backward<0>(xf, yf, gyf, gldf, L, T, n_rows, sign, s_bound, gxf, wf, n_params,
                               n_blocks, smem, st);
      break;
    case 1:
      err = launch_backward<1>(xf, yf, gyf, gldf, L, T, n_rows, sign, s_bound, gxf, wf, n_params,
                               n_blocks, smem, st);
      break;
    default:
      err = launch_backward<2>(xf, yf, gyf, gldf, L, T, n_rows, sign, s_bound, gxf, wf, n_params,
                               n_blocks, smem, st);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  ar_solve_sum_kernel<<<(n_params + kSumThreads - 1) / kSumThreads, kSumThreads, 0, st>>>(
      wf, n_blocks, n_params, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
