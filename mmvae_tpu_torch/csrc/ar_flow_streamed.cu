// Fused autoregressive-flow solve for Hopper (sm_90a) at any MADE widths,
// with the weights streamed through the cache: a forward kernel and the
// backward's reverse chain. ops/ar_flow.py routes a call here (the
// "streamed" route) only where neither the 128-wide pair of ar_flow.cu nor
// the general pair of ar_flow_general.cu takes the MADE: where eight CTAs'
// shared memory cannot hold its weights (hidden widths near 1,000, dozens
// of hidden layers).
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (:96, body _make_kernel :34) and the gradient the JAX package takes around
// it (_ar_solve_bwd :156, jax.vjp of unrolled_solve :113) at those shapes:
// hidden layers of any width, widths that differ from layer to layer, up to
// 63 hidden layers. JAX's kernel builds for any number of hidden layers and
// any widths, and so do these. They compute the same functions as ar_flow.cu's pair, read and
// write the same tape (each hidden layer's pre-activation z[l], (D, N,
// width_l), and the head's raw log-scale s, (D, N)), and take JAX's slope
// 1/2 at an exact ReLU tie (jnp.maximum(z, 0)).
//
// What bounds them: latency, as ar_flow.cu's header argues. The solve is a
// chain of D steps of L + 1 dependent matrix-vector products over a few
// rows, with a block-wide barrier between links; flops and bytes are far
// below what the card could do in the same time.
//
// Design (simple first; weights read from the cache at every step, so that
// shared memory holds only activations and any width fits):
// - A block owns kTile = 4 rows and has 256 threads. Activations and deltas
//   are kept feature-major ([feature][row]) in dynamic shared memory sized by
//   the widest hidden layer, so one float4 read of a feature feeds the tile's
//   four rows.
// - No weight is staged: each link reads its weights through the L1/L2
//   caches (__ldg). In the forward, threads stride over a layer's output
//   features j and read column j of the (in, out) weight, neighbouring
//   threads on neighbouring addresses; in the backward, a warp takes one
//   input feature k and its lanes read row k of the weight, then sum across
//   the warp. A ragged width such as 100 needs no padded copy.
// - The forward keeps the first layer's pre-activation and adds one rank-1
//   term a step (y gained one feature); the head computes only columns i and
//   i + D, every thread its share of the two dot products, summed across each
//   warp and then over the warps in order.
// - The backward keeps dsum, the first layer's deltas summed over the later
//   steps, and reads y's gradient at feature i as gy_i + W0[i, :] . dsum. It
//   writes gx, every hidden layer's delta at every step, (D, N, width_l),
//   and the head's two delta columns (mu_i, s_i) at every step, (D, N, 2).
//   The weight and bias gradients are the sums of those over rows and steps,
//   which the wrapper takes as one matrix product and one sum per layer
//   (ops/ar_flow.py:sum_grads), as JAX leaves them to XLA's autodiff. The
//   deltas are as large as the tape: 2.0 GB at N = 7,680, D = 64 and 4 x 256
//   hidden units, 0.5 GB at 4 x 64.
// - Every sum is taken in an order fixed by the shapes (warp butterflies,
//   then the warps in order; no floating-point atomics): two calls on the
//   same inputs give bitwise equal results.
// Arithmetic is plain f32 FMA on the CUDA cores (no TF32).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;         // rows a block owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 64;   // hidden layers + head
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 4, "activations are read as one float4 per feature");

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

// Kernel parameters are copied into shared memory before they are indexed
// at run time (indexed in place, they would be copied to local memory).
struct Shared {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* z[kMaxLayers];
  float* d[kMaxLayers];
  int width[kMaxLayers + 1];
};
// The static shared memory a block counts, bounded from above: the copy, and
// the dynamic buffer's alignment after it (ptxas reported 2,320 bytes).
constexpr int kStaticSmem = 2560;
static_assert(sizeof(Shared) + 16 <= kStaticSmem, "the parameters' copy outgrew its bound");

__device__ __forceinline__ void load_params(Shared& S, const Net& P, const Tape& T) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      S.w[l] = P.w[l];
      S.b[l] = P.b[l];
      S.z[l] = T.z[l];
    }
#pragma unroll
    for (int l = 0; l <= kMaxLayers; ++l) S.width[l] = P.width[l];
  }
  __syncthreads();
}

// The widest hidden layer.
__host__ __device__ inline int max_hidden(const int* width, int n) {
  int m = 0;
  for (int l = 1; l < n; ++l) m = width[l] > m ? width[l] : m;
  return m;
}

bool takes(const int* width, int n) {
  if (n < 2 || n > kMaxLayers || width[0] < 2 || width[n] != 2 * width[0]) return false;
  for (int l = 1; l < n; ++l) {
    if (width[l] < 1) return false;
  }
  return true;
}

// Shared-memory layout, in floats, every segment a multiple of four.
// Forward: the x and y tiles, the first layer's pre-activation, two
// activation buffers of the widest hidden layer, the head's per-warp sums.
// Backward: the x, y, y-gradient, x-gradient and raw-s tiles; dsum; two delta
// buffers of the widest hidden layer; the per-warp sums of y's gradient; the
// head's two deltas and the log-det gradient of each row.
inline long long smem_floats(const int* width, int n, bool backward) {
  const long long d = width[0], w1 = width[1], wmax = max_hidden(width, n);
  if (!backward) return (2 * d + w1 + 2 * wmax + 2 * kWarps) * kTile;
  return (5 * d + w1 + 2 * wmax + kWarps + 3) * kTile;
}

__device__ inline void fma4(float4& acc, const float4& a, float w) {
  acc.x = fmaf(a.x, w, acc.x);
  acc.y = fmaf(a.y, w, acc.y);
  acc.z = fmaf(a.z, w, acc.z);
  acc.w = fmaf(a.w, w, acc.w);
}

__device__ inline float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// The sum over the warp, the same bits in every lane.
__device__ inline float4 warp_sum4(float4 v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v.x += __shfl_xor_sync(kFull, v.x, off);
    v.y += __shfl_xor_sync(kFull, v.y, off);
    v.z += __shfl_xor_sync(kFull, v.z, off);
    v.w += __shfl_xor_sync(kFull, v.w, off);
  }
  return v;
}

// jnp.maximum(z, 0)'s slope: 1 above 0, 1/2 at the tie, 0 below.
__device__ inline float slope(float z) { return z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f); }

__device__ inline float comp(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kThreads)
streamed_forward_kernel(const float* __restrict__ x, Net P, Tape T, int n_rows, int sign,
                       float s_bound, float* __restrict__ y_out, float* __restrict__ ld_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  load_params(S, P, T);
  const int n = P.n, d = P.width[0], w1 = P.width[1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kTile;
  const bool record = T.s != nullptr;
  const int wmax = max_hidden(S.width, n);

  float* xs = smem;                  // [D][kTile]
  float* yT = xs + d * kTile;        // [D][kTile]
  float* z0 = yT + d * kTile;        // the first layer's pre-activation, [w1][kTile]
  float* hA = z0 + w1 * kTile;       // [wmax][kTile]
  float* hB = hA + wmax * kTile;
  float* hsum = hB + wmax * kTile;   // the head's per-warp sums, [2][kWarps][kTile]
  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u / kTile, row = row0 + u % kTile;
    xs[u] = row < n_rows ? x[(size_t)row * d + c] : 0.f;
    yT[u] = 0.f;
  }
  for (int j = tid; j < w1; j += kThreads) {
    const float b = __ldg(S.b[0] + j);
    reinterpret_cast<float4*>(z0)[j] = make_float4(b, b, b, b);
  }
  __syncthreads();

  float ld = 0.f;  // owned by thread r < kTile for row r of the tile
  const float* W0 = S.w[0];
  const float* Wh = S.w[n - 1];
  const float* bh = S.b[n - 1];
  for (int i = 0; i < d; ++i) {
    // first layer: y gained feature i - 1 in the last step, so its
    // pre-activation gains one rank-1 term, y_{i-1} * W0[i-1, :]
    {
      float4* z4 = reinterpret_cast<float4*>(z0);
      float4* h4 = reinterpret_cast<float4*>(hA);
      const float4 yv = i > 0 ? reinterpret_cast<const float4*>(yT)[i - 1]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = tid; j < w1; j += kThreads) {
        float4 z = z4[j];
        if (i > 0) {
          fma4(z, yv, __ldg(W0 + (size_t)(i - 1) * w1 + j));
          z4[j] = z;
        }
        h4[j] = relu4(z);
        if (record) {
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            if (row0 + r < n_rows) S.z[0][((size_t)i * n_rows + row0 + r) * w1 + j] = comp(z, r);
          }
        }
      }
    }
    __syncthreads();
    const float* in = hA;
    float* out = hB;
    for (int l = 1; l < n - 1; ++l) {
      const int win = S.width[l], wout = S.width[l + 1];
      const float* W = S.w[l];
      const float* b = S.b[l];
      float* tape = S.z[l];
      const float4* in4 = reinterpret_cast<const float4*>(in);
      for (int j = tid; j < wout; j += kThreads) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < win; ++k) fma4(acc, in4[k], __ldg(W + (size_t)k * wout + j));
        const float bj = __ldg(b + j);
        const float4 z = make_float4(acc.x + bj, acc.y + bj, acc.z + bj, acc.w + bj);
        reinterpret_cast<float4*>(out)[j] = relu4(z);
        if (record) {
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            if (row0 + r < n_rows) tape[((size_t)i * n_rows + row0 + r) * wout + j] = comp(z, r);
          }
        }
      }
      __syncthreads();
      in = out;
      out = (out == hA) ? hB : hA;
    }

    // head: columns i (mu) and i + d (s), each thread its share of the
    // features, summed across the warp and then over the warps in order
    {
      const int win = S.width[n - 1];
      const float4* in4 = reinterpret_cast<const float4*>(in);
      float4 pm = make_float4(0.f, 0.f, 0.f, 0.f), ps = pm;
      for (int k = tid; k < win; k += kThreads) {
        const float4 a = in4[k];
        fma4(pm, a, __ldg(Wh + (size_t)k * 2 * d + i));
        fma4(ps, a, __ldg(Wh + (size_t)k * 2 * d + i + d));
      }
      pm = warp_sum4(pm);
      ps = warp_sum4(ps);
      if (lane == 0) {
        reinterpret_cast<float4*>(hsum)[warp] = pm;
        reinterpret_cast<float4*>(hsum)[kWarps + warp] = ps;
      }
    }
    __syncthreads();
    if (tid < kTile) {
      const int row = row0 + tid;
      float mu = 0.f, s = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        mu += hsum[w * kTile + tid];
        s += hsum[(kWarps + w) * kTile + tid];
      }
      mu += __ldg(bh + i);
      s += __ldg(bh + i + d);
      if (record && row < n_rows) T.s[(size_t)i * n_rows + row] = s;
      if (s_bound > 0.f) s = s_bound * tanhf(s / s_bound);
      const float xi = xs[i * kTile + tid];
      yT[i * kTile + tid] = sign < 0 ? (xi - mu) * expf(-s) : xi * expf(s) + mu;
      ld += sign < 0 ? -s : s;
    }
    __syncthreads();
  }

  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u % d, r = u / d;
    if (row0 + r < n_rows) y_out[(size_t)(row0 + r) * d + c] = yT[c * kTile + r];
  }
  if (tid < kTile && row0 + tid < n_rows) ld_out[row0 + tid] = ld;
}

__global__ void __launch_bounds__(kThreads)
streamed_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ gy, const float* __restrict__ gld, Net P,
                        Tape T, Deltas G, int n_rows, int sign, float s_bound,
                        float* __restrict__ gx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared S;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) S.d[l] = G.d[l];
  }
  load_params(S, P, T);
  const int n = P.n, d = P.width[0], w1 = P.width[1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * kTile;
  const int wmax = max_hidden(S.width, n);

  float* xs = smem;
  float* ys = xs + d * kTile;
  float* gyT = ys + d * kTile;
  float* gxT = gyT + d * kTile;
  float* sr = gxT + d * kTile;          // raw log-scale of each step
  float* dsum = sr + d * kTile;         // the first layer's deltas, summed over later steps
  float* dA = dsum + w1 * kTile;        // two delta buffers, [wmax][kTile]
  float* dB = dA + wmax * kTile;
  float* red = dB + wmax * kTile;       // per-warp sums of y's gradient, [kWarps][kTile]
  float* hd = red + kWarps * kTile;     // the head's mu and s deltas, [2][kTile]
  float* gl = hd + 2 * kTile;           // the log-det gradient of each row
  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u / kTile, row = row0 + u % kTile;
    const bool in = row < n_rows;
    xs[u] = in ? x[(size_t)row * d + c] : 0.f;
    ys[u] = in ? y[(size_t)row * d + c] : 0.f;
    gyT[u] = in ? gy[(size_t)row * d + c] : 0.f;
    sr[u] = in ? T.s[(size_t)c * n_rows + row] : 0.f;
  }
  for (int u = tid; u < w1 * kTile; u += kThreads) dsum[u] = 0.f;
  if (tid < kTile) gl[tid] = row0 + tid < n_rows ? gld[row0 + tid] : 0.f;
  __syncthreads();

  const float* W0 = S.w[0];
  const float* Wh = S.w[n - 1];
  for (int i = d - 1; i >= 0; --i) {
    // y's gradient at feature i: gy_i plus what the first layer of every
    // later step sent back, W0[i, :] . dsum
    {
      const float4* s4 = reinterpret_cast<const float4*>(dsum);
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = tid; j < w1; j += kThreads) fma4(p, s4[j], __ldg(W0 + (size_t)i * w1 + j));
      p = warp_sum4(p);
      if (lane == 0) reinterpret_cast<float4*>(red)[warp] = p;
    }
    __syncthreads();
    if (tid < kTile) {
      const int r = tid, row = row0 + r;
      float g = gyT[i * kTile + r];
      for (int w = 0; w < kWarps; ++w) g += red[w * kTile + r];
      const float sraw = sr[i * kTile + r];
      float s = sraw, ds = 1.f;
      if (s_bound > 0.f) {
        const float t = tanhf(sraw / s_bound);
        s = s_bound * t;
        ds = 1.f - t * t;
      }
      float gmu, gs;
      if (sign < 0) {
        const float gxi = g * expf(-s);
        gxT[i * kTile + r] = gxi;
        gmu = -gxi;
        gs = -g * ys[i * kTile + r] - gl[r];
      } else {
        const float e = expf(s);
        gxT[i * kTile + r] = g * e;
        gmu = g;
        gs = g * xs[i * kTile + r] * e + gl[r];
      }
      gs *= ds;
      hd[r] = gmu;
      hd[kTile + r] = gs;
      if (row < n_rows) {
        G.head[((size_t)i * n_rows + row) * 2] = gmu;
        G.head[((size_t)i * n_rows + row) * 2 + 1] = gs;
      }
    }
    __syncthreads();

    // the last hidden layer's delta through head columns i and i + d
    {
      const int wl = S.width[n - 1];
      const float* z = S.z[n - 2];
      float* out = S.d[n - 2];
      for (int u = tid; u < kTile * wl; u += kThreads) {
        const int r = u / wl, j = u % wl, row = row0 + r;
        float v = 0.f;
        if (row < n_rows) {
          const size_t at = ((size_t)i * n_rows + row) * wl + j;
          const float g = hd[r] * __ldg(Wh + (size_t)j * 2 * d + i) +
                          hd[kTile + r] * __ldg(Wh + (size_t)j * 2 * d + i + d);
          v = g * slope(z[at]);
          out[at] = v;
        }
        dA[j * kTile + r] = v;
        if (n == 2) dsum[j * kTile + r] += v;
      }
    }
    __syncthreads();

    // down the hidden layers: layer l's delta (width[l + 1], in cur) back
    // through its weight to layer l - 1's (width[l], into nxt), a warp per
    // input feature k summing row k of the weight against the delta
    float* cur = dA;
    float* nxt = dB;
    for (int l = n - 2; l >= 1; --l) {
      const int win = S.width[l], wout = S.width[l + 1];
      const float* W = S.w[l];
      const float4* c4 = reinterpret_cast<const float4*>(cur);
      for (int k = warp; k < win; k += kWarps) {
        const float* wr = W + (size_t)k * wout;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = lane; j < wout; j += 32) fma4(p, c4[j], __ldg(wr + j));
        p = warp_sum4(p);
        if (lane == 0) reinterpret_cast<float4*>(nxt)[k] = p;
      }
      __syncthreads();
      // times the slope of layer l - 1's ReLU at this step, from the tape
      const float* z = S.z[l - 1];
      float* out = S.d[l - 1];
      for (int u = tid; u < kTile * win; u += kThreads) {
        const int r = u / win, k = u % win, row = row0 + r;
        float v = 0.f;
        if (row < n_rows) {
          const size_t at = ((size_t)i * n_rows + row) * win + k;
          v = nxt[k * kTile + r] * slope(z[at]);
          out[at] = v;
        }
        nxt[k * kTile + r] = v;
        if (l == 1) dsum[k * kTile + r] += v;
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  for (int u = tid; u < d * kTile; u += kThreads) {
    const int c = u % d, r = u / d;
    if (row0 + r < n_rows) gx[(size_t)(row0 + r) * d + c] = gxT[c * kTile + r];
  }
}

// Dynamic shared memory each kernel is opted in to, per device (bytes).
constexpr int kMaxDevices = 64;
int g_opt_in[2][kMaxDevices] = {};

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

}  // namespace

extern "C" {

// Shared memory one block of the forward (backward = 0) or the backward
// (backward = 1) needs, dynamic and static, in bytes; -1 if the kernels do
// not take these widths.
long long ar_solve_streamed_smem_bytes(const int* width, int n_layers, int backward) {
  if (!takes(width, n_layers)) return -1;
  return smem_floats(width, n_layers, backward != 0) * (long long)sizeof(float) + kStaticSmem;
}

// x, y: (n_rows, D) f32; ld: (n_rows,); ws[l]: (width[l], width[l+1]) with
// the mask applied; bs[l]: (width[l+1],). When s is not null the launch also
// records the tape: zs[l] (D, n_rows, width[l+1]) for every hidden layer and
// s (D, n_rows). One launch on `stream`; returns cudaGetLastError().
int ar_solve_streamed_forward(const void* x, const void* const* ws, const void* const* bs,
                             const int* width, int n_layers, int n_rows, int sign, float s_bound,
                             void* y, void* ld, void* const* zs, void* s, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, bs, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  const size_t smem = (size_t)smem_floats(width, n_layers, false) * sizeof(float);
  const cudaError_t err = opt_in(streamed_forward_kernel, 0, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + kTile - 1) / kTile);
  streamed_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), P, T, n_rows, sign, s_bound, static_cast<float*>(y),
      static_cast<float*>(ld));
  return (int)cudaGetLastError();
}

// The reverse chain. x, y, gy, gx: (n_rows, D); gld: (n_rows,); ws as for the
// forward; zs and s: the forward's tape; deltas[l]: (D, n_rows, width[l+1])
// for every hidden layer and head (D, n_rows, 2), written in full. One
// launch on `stream`; returns cudaGetLastError().
int ar_solve_streamed_backward(const void* x, const void* y, const void* gy, const void* gld,
                              const void* const* ws, const int* width, int n_layers, int n_rows,
                              int sign, float s_bound, void* const* zs, void* s,
                              void* const* deltas, void* head, void* gx, void* stream) {
  if (!takes(width, n_layers) || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const Net P = make_net(ws, nullptr, width, n_layers);
  const Tape T = make_tape(zs, s, n_layers);
  Deltas G = {};
  for (int l = 0; l < n_layers - 1; ++l) G.d[l] = static_cast<float*>(deltas[l]);
  G.head = static_cast<float*>(head);
  const size_t smem = (size_t)smem_floats(width, n_layers, true) * sizeof(float);
  const cudaError_t err = opt_in(streamed_backward_kernel, 1, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + kTile - 1) / kTile);
  streamed_backward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(gy),
      static_cast<const float*>(gld), P, T, G, n_rows, sign, s_bound, static_cast<float*>(gx));
  return (int)cudaGetLastError();
}

}  // extern "C"
