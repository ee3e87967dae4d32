// Fused autoregressive-flow solve for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (body _make_kernel) and the gradient the JAX package takes around it
// (_ar_solve_bwd: jax.vjp of unrolled_solve). The forward runs the whole
// D-step sequential solve of one MADE block in one launch: for i in 0..D-1
// the masked MLP is evaluated on the partly built y, the head gives mu_i and
// s_i, and y_i and the log-det are updated:
//   sign -1 (IAF density):  y_i = (x_i - mu_i) * exp(-s_i)
//   sign +1 (MAF sampling): y_i = x_i * exp(s_i) + mu_i
//   logdet += sign * s_i, with s_i = B * tanh(s_i / B) when s_bound B > 0.
// The backward runs the reverse-mode chain over i = D-1..0 in one launch and
// writes, per step, the gradient at every layer's pre-activation output; the
// wrapper (ops/ar_flow.py) turns those and the forward's per-step layer
// inputs into the weight and bias gradients, one matrix product per layer.
//
// Widths: every hidden layer is kHidden = 128 wide, the only width the
// port's MADE blocks have and the only one the kernels are tested at; the
// launchers refuse others. D and the number of hidden layers are free, up
// to what shared memory holds (ar_solve_smem_bytes computes it): three
// hidden layers at every D up to 256, five at none.
//
// What bounds it: latency. Each chain needs 2*N*D*(H + (L-1)*H*H + 2*H)
// flops (170 MFLOP at N=128, D=20, H=128, L=3 hidden layers), 2.5 us at the
// f32 peak. But the work is a chain of D x (L+1) dependent matrix-vector
// products over a few rows, each a few thousand cycles for one SM, with a
// block-wide barrier between links. The length of each link and the number
// of SMs that share the rows set the time, not flops or bytes.
//
// Design, both kernels:
// - A block owns kTile=4 rows (32 blocks, one per SM, at N=128) and has 16
//   warps. The hidden kHidden x kHidden layers (132 KB with two of them)
//   are staged once into dynamic shared memory by cp.async, with row
//   stride out+1 so that they read without bank conflicts along either
//   index, and stay there for all D steps. Activations are feature-major
//   ([feature][row]): one float4 broadcast read feeds the four rows.
// - Step i reads only one row of the first layer and two columns of the
//   head, so those two weights stay in device memory (L2 after the first
//   block): each thread loads the three values it needs for the next step
//   into registers while the current step runs. Shared memory then grows
//   with D only by the O(D) tiles and the backward's relu bits, and latent
//   64 (MADE widths [64, 128, 128, 128, 128]) fits, where staging the first
//   layer and the head as well needed 258 KB for the forward and 271 KB for
//   the backward, over the H100's 227 KB.
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
// - When gradients are wanted the forward records each step's layer inputs
//   and the head's raw log-scale (the tape). The backward reads the relu
//   patterns of the whole chain from it once, as bits in shared memory,
//   instead of re-running the forward chain.
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32), so both kernels
// agree with the f32 PyTorch versions up to summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHidden = 128;                   // width of every hidden layer
constexpr int kChunk = 16;                     // input features one warp sums in a hidden layer
constexpr int kSlices = kHidden / kChunk;      // warps that share a hidden layer's inputs
constexpr int kMaskWords = kHidden / 32;       // relu-pattern words per row, layer and step
constexpr int kPartFloats = kSlices * kHidden * kTile;  // partial sums of one hidden layer
constexpr int kMaxLayers = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 4, "activations are read as one float4 per feature");
static_assert(kHidden == 32 * 4, "a lane owns four columns of a hidden layer, 32 apart");
static_assert(kHidden * kTile == kThreads, "one thread per (hidden feature, row)");
static_assert(kSlices <= kWarps && kSlices % 4 == 0, "slices are summed four at a time");
static_assert(kMaskWords == 4, "the relu bits are read four words per row");

struct Layers {
  const float* w[kMaxLayers];  // (in, out) row-major, mask applied
  const float* b[kMaxLayers];  // (out,)
  int width[kMaxLayers + 1];   // width[0] = D, width[1..n-1] = kHidden, width[n] = 2D
  int n;                       // hidden layers + head
};

// The forward's record of each step, read by the backward. act[l] is
// (D, N, width[l]): the input of layer l at step i (act[0] is the partly
// built y); s is (D, N), the head's log-scale before the bound. The forward
// records nothing when s is null.
struct Tape {
  float* act[kMaxLayers];
  float* s;
};

// delta[l] is (D, N, width[l+1]): the gradient at layer l's pre-activation
// output at step i.
struct Deltas {
  float* d[kMaxLayers];
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

// Shared-memory layout, in floats; every segment is a multiple of four.
// Forward: the staged hidden weights, biases, the x and y tiles, two
// activation buffers, the first layer's pre-activation, the head's per-warp
// sums, the partial sums. Backward: the staged hidden weights; the x, y,
// y-gradient, x-gradient and raw-s tiles; the log-det gradient and the head
// gradients (4 * kTile); the relu bits of every step; two activation
// buffers, dsum, the per-warp sums of y's gradient, the partial sums.
inline int smem_floats(const int* width, int n, bool backward) {
  const int d = width[0];
  const int common = weight_floats(n) + 2 * kHidden * kTile + kPartFloats;
  if (!backward) {
    int biases = 0;
    for (int l = 0; l < n; ++l) biases += round4(width[l + 1]);
    return common + biases + 2 * d * kTile + kHidden * kTile + 2 * kWarps * kTile;
  }
  const int mask = round4((n - 1) * d * kTile * kMaskWords);
  return common + 5 * d * kTile + 4 * kTile + mask + kHidden * kTile + kWarps * kTile;
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

// One kHidden -> kHidden layer over the tile:
// epi(j, r, sum_k in[k][r] * M[k * ks + j * js]) for every column j and row
// r < kTile, one (j, r) per thread. Warp s < kSlices sums input features
// kChunk*s.. for columns lane + 32c (c < 4), so each broadcast read of in[k]
// feeds 16 FMAs; the slices' partial sums meet in `part`. Ends with a
// barrier, so the outputs are visible to all threads.
template <class Epi>
__device__ __forceinline__ void hidden_layer(const float* __restrict__ in,
                                             const float* __restrict__ M, int ks, int js,
                                             float4* __restrict__ part, Epi epi) {
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  if (s < kSlices) {
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
  __syncthreads();
  // column threadIdx.x / kTile, row threadIdx.x % kTile of every slice
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
  epi(threadIdx.x / kTile, threadIdx.x % kTile, (v0 + v1) + (v2 + v3));
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ar_solve_forward_kernel(const float* __restrict__ x, Layers L, Tape T, int n_rows, int sign,
                        float s_bound, float* __restrict__ y_out, float* __restrict__ ld_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float* act[kMaxLayers];
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
    if (tid == l) act[l] = T.act[l];
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
    if (record) {
      for (int u = tid; u < d * kTile; u += kThreads) {
        const int c = u % d, r = u / d;
        if (row0 + r < n_rows) act[0][((size_t)i * n_rows + row0 + r) * d + c] = yT[c * kTile + r];
      }
    }
    // first layer: y gained feature i - 1 in the last step, so its
    // pre-activation gains one rank-1 term, y_{i-1} * W0[i-1, :]
    if (i > 0) z0[tid] = fmaf(yT[(i - 1) * kTile + rt], w0, z0[tid]);
    {
      const float h = fmaxf(z0[tid], 0.f);
      hA[tid] = h;
      if (record && row_in) act[1][((size_t)i * n_rows + row0 + rt) * kHidden + jt] = h;
    }
    __syncthreads();
    const float* in = hA;
    const float* W = smem;
    const float* b = bias + kHidden;
    float* out = hB;
    for (int l = 1; l < n - 1; ++l) {
      float* tape = record ? act[l + 1] : nullptr;
      hidden_layer(in, W, kHidden + 1, 1, part, [&](int j, int r, float v) {
        const float h = fmaxf(v + b[j], 0.f);
        out[j * kTile + r] = h;
        if (tape != nullptr && row0 + r < n_rows)
          tape[((size_t)i * n_rows + row0 + r) * kHidden + j] = h;
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

__global__ void __launch_bounds__(kThreads, 1)
ar_solve_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const float* __restrict__ gy, const float* __restrict__ gld, Layers L,
                         Tape T, Deltas G, int n_rows, int sign, float s_bound,
                         float* __restrict__ gx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float* act[kMaxLayers];
  __shared__ float* delta[kMaxLayers];
  const int n = L.n, d = L.width[0], tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kTile;

  // the hidden kHidden x kHidden layers: layer l (1 <= l < n - 1) at
  // (l - 1) * kPadded
  float* p = smem;
#pragma unroll
  for (int l = 1; l < kMaxLayers - 1; ++l) {
    if (l < n - 1) {
      stage_padded(p, L.w[l]);
      p += kPadded;
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (tid == l) {
      act[l] = T.act[l];
      delta[l] = G.d[l];
    }
  }
  float* xs = p;
  float* ys = xs + d * kTile;
  float* gyT = ys + d * kTile;
  float* gxT = gyT + d * kTile;
  float* sr = gxT + d * kTile;  // raw log-scale of each step
  float* gl = sr + d * kTile;   // log-det gradient of each row
  float* hd = gl + kTile;       // mu and s gradients of the step
  unsigned* mask = reinterpret_cast<unsigned*>(hd + 3 * kTile);
  float* hA = reinterpret_cast<float*>(mask) + round4((n - 1) * d * kTile * kMaskWords);
  float* hB = hA + kHidden * kTile;
  float* dsum = hB + kHidden * kTile;    // the first layer's deltas, summed over later steps
  float* ysum = dsum + kHidden * kTile;  // per-warp sums of y's gradient at the step's feature
  float4* part = reinterpret_cast<float4*>(ysum + kWarps * kTile);
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
  __syncthreads();

  // relu pattern of every hidden output at every step, one bit each: word
  // (((l - 1) * d + i) * kTile + r) * kMaskWords + q holds features 32q..
  // of act[l]. A warp takes one (l, i) at a time and keeps 4 * kTile loads
  // in flight.
  for (int li = warp; li < (n - 1) * d; li += kWarps) {
    const int l = 1 + li / d, i = li - (l - 1) * d;
    const float* src = act[l] + (size_t)i * n_rows * kHidden;
    unsigned* dst = mask + li * kTile * kMaskWords;
    float v[kTile][kMaskWords];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int q = 0; q < kMaskWords; ++q)
        v[r][q] = row0 + r < n_rows ? src[(size_t)(row0 + r) * kHidden + 32 * q + lane] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int q = 0; q < kMaskWords; ++q) {
        const unsigned bits = __ballot_sync(kFull, v[r][q] > 0.f);
        if (lane == 0) dst[r * kMaskWords + q] = bits;
      }
    }
  }
  stage_wait();
  __syncthreads();

  const int kt = tid / kTile, rt = tid % kTile;  // this thread's hidden feature and row
  const bool row_in = row0 + rt < n_rows;
  // the first layer (d, kHidden) and the head (kHidden, 2d) in device
  // memory: this thread's W0[i, kt] and head entries (kt, i), (kt, i + d)
  // for step i, loaded one step ahead
  const float* W0 = L.w[0] + kt;
  const float* Wh = head_weights(L) + kt * 2 * d;
  float w0 = __ldg(W0 + (d - 1) * kHidden), wm = __ldg(Wh + d - 1), ws = __ldg(Wh + 2 * d - 1);
  for (int i = d - 1; i >= 0; --i) {
    float w0_next = 0.f, wm_next = 0.f, ws_next = 0.f;
    if (i > 0) {
      w0_next = __ldg(W0 + (i - 1) * kHidden);
      wm_next = __ldg(Wh + i - 1);
      ws_next = __ldg(Wh + i - 1 + d);
    }
    // y's gradient at feature i: gy_i plus what the first layer of every
    // later step sent back, W0[i, :] . dsum
    {
      float pg = w0 * dsum[tid];  // this thread's row is lane % kTile
#pragma unroll
      for (int off = kTile; off < 32; off *= 2) pg += __shfl_xor_sync(kFull, pg, off);
      if (lane < kTile) ysum[warp * kTile + lane] = pg;
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

    // the head's delta row (columns i and i + D), and the last hidden
    // layer's delta through head columns i and i + D and its relu pattern
    float* dh = delta[n - 1];
    for (int u = tid; u < 2 * d * kTile; u += kThreads) {
      const int c = u % (2 * d), r = u / (2 * d);
      if (row0 + r < n_rows)
        dh[((size_t)i * n_rows + row0 + r) * 2 * d + c] =
            c == i ? hd[r] : (c == i + d ? hd[kTile + r] : 0.f);
    }
    {
      const unsigned* mk = mask + ((n - 2) * d + i) * kTile * kMaskWords;
      const float g = hd[rt] * wm + hd[kTile + rt] * ws;
      const float v = (mk[rt * kMaskWords + kt / 32] >> (kt % 32)) & 1u ? g : 0.f;
      hA[tid] = v;
      if (n == 2) dsum[tid] += v;
      if (row_in) delta[n - 2][((size_t)i * n_rows + row0 + rt) * kHidden + kt] = v;
    }
    __syncthreads();

    // back through the hidden layers with W^T (W read along its rows),
    // down to the first layer's delta, which joins dsum
    float* in = hA;
    float* out = hB;
    for (int l = n - 2; l >= 1; --l) {
      const unsigned* mk = mask + ((l - 1) * d + i) * kTile * kMaskWords;
      float* dl = delta[l - 1];
      const float* W = smem + (l - 1) * kPadded;
      hidden_layer(in, W, 1, kHidden + 1, part, [&](int k, int r, float g) {
        const float v = (mk[r * kMaskWords + k / 32] >> (k % 32)) & 1u ? g : 0.f;
        out[k * kTile + r] = v;
        if (l == 1) dsum[k * kTile + r] += v;
        if (row0 + r < n_rows) dl[((size_t)i * n_rows + row0 + r) * kHidden + k] = v;
      });
      float* t = in;
      in = out;
      out = t;
    }
    w0 = w0_next;
    wm = wm_next;
    ws = ws_next;
  }

  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u % d, r = u / d;
    if (row0 + r < n_rows) gx[(size_t)(row0 + r) * d + c] = gxT[c * kTile + r];
  }
}

// Dynamic shared memory each kernel is opted in to, per device (bytes).
constexpr int kMaxDevices = 64;
int g_opt_in[2][kMaxDevices] = {};

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

Tape make_tape(void* const* acts, void* s, int n) {
  Tape T = {};
  for (int l = 0; acts != nullptr && l < n; ++l) T.act[l] = static_cast<float*>(acts[l]);
  T.s = static_cast<float*>(s);
  return T;
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
// launch also records the tape: acts[l] (D, n_rows, width[l]) for every
// layer and s (D, n_rows). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int ar_solve_forward(const void* x, const void* const* ws, const void* const* bs,
                     const int* width, int n_layers, int n_rows, int sign, float s_bound,
                     void* y, void* ld, void* const* acts, void* s, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Layers L = make_layers(ws, bs, width, n_layers);
  const Tape T = make_tape(acts, s, n_layers);
  const size_t smem = (size_t)smem_floats(width, n_layers, false) * sizeof(float);
  const cudaError_t err = opt_in(ar_solve_forward_kernel, 0, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + kTile - 1) / kTile);
  ar_solve_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), L, T, n_rows, sign, s_bound, static_cast<float*>(y),
      static_cast<float*>(ld));
  return (int)cudaGetLastError();
}

// The reverse chain. x, y, gy, gx: (n_rows, D); gld: (n_rows,); ws as for
// the forward; acts and s: the forward's tape; deltas[l]:
// (D, n_rows, width[l+1]), written in full. Launches on `stream` and returns
// cudaGetLastError().
int ar_solve_backward(const void* x, const void* y, const void* gy, const void* gld,
                      const void* const* ws, const int* width, int n_layers, int n_rows,
                      int sign, float s_bound, void* const* acts, void* s, void* gx,
                      void* const* deltas, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Layers L = make_layers(ws, nullptr, width, n_layers);
  const Tape T = make_tape(acts, s, n_layers);
  Deltas G = {};
  for (int l = 0; l < n_layers; ++l) G.d[l] = static_cast<float*>(deltas[l]);
  const size_t smem = (size_t)smem_floats(width, n_layers, true) * sizeof(float);
  const cudaError_t err = opt_in(ar_solve_backward_kernel, 1, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + kTile - 1) / kTile);
  ar_solve_backward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(gy), static_cast<const float*>(gld), L, T, G, n_rows, sign,
      s_bound, static_cast<float*>(gx));
  return (int)cudaGetLastError();
}

}  // extern "C"
