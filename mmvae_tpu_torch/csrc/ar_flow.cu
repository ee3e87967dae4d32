// Fused autoregressive-flow solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmvae_tpu/ops/ar_flow.py:_pallas_solve
// (body _make_kernel). It runs the whole D-step sequential solve of one MADE
// block in one launch: for i in 0..D-1 the masked MLP is evaluated on the
// partly built y, the head gives mu_i and s_i, and y_i and the log-det are
// updated:
//   sign -1 (IAF density):  y_i = (x_i - mu_i) * exp(-s_i)
//   sign +1 (MAF sampling): y_i = x_i * exp(s_i) + mu_i
//   logdet += sign * s_i, with s_i = B * tanh(s_i / B) when s_bound B > 0.
//
// What bounds it: arithmetic. One launch at N rows needs
// 2*N*D*(D*H + (L-1)*H*H + 2*H) flops (the hidden layers and the two head
// columns of each step; 182 MFLOP at N=128, D=20, H=128, L=3 hidden
// layers) on about 180 KB of input, far above the card's flop-per-byte
// balance, and the D steps are a dependent chain.
//
// Design: one block of 128 threads per tile of kTile=8 rows. Every masked
// weight and bias (163.5 KB at the sizes above) is staged once into dynamic
// shared memory and stays there for all D steps; the tile's y, the two
// hidden activations and the two head outputs live there too, stored
// feature-major ([feature][row]) so that one float4 broadcast read feeds
// four rows. In a hidden layer thread j owns output column j for all rows of
// the tile: each weight read from shared memory feeds kTile FMAs, and
// consecutive threads read consecutive weights (no bank conflicts). Step i
// needs only head columns i and i+D, so the head is 2*kTile warp-reduced
// dot products instead of a full 2D-wide layer. Arithmetic is plain f32 FMA
// on the CUDA cores (no TF32), so it agrees with the f32 PyTorch version up
// to summation order. kTile=8 keeps shared memory under the 227 KB a block
// may use and gives 16 blocks at N=128.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kThreads = 128;
constexpr int kMaxLayers = 8;
static_assert(kTile == 8, "the hidden-layer loop reads each tile column as two float4");

// Dynamic shared memory ar_solve_kernel is opted in to, per device (bytes).
constexpr int kMaxDevices = 64;
int g_smem_opt_in[kMaxDevices] = {};

struct Layers {
  const float* w[kMaxLayers];  // (in, out) row-major, mask applied
  const float* b[kMaxLayers];  // (out,)
  int width[kMaxLayers + 1];   // width[0] = D, width[n] = 2D
  int n;                       // hidden layers + head
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout, in floats: every layer's weights, then every
// layer's biases, then yT (D x kTile), two activation buffers
// (max hidden width x kTile) and the head outputs (2 x kTile). Each block
// starts on a 16-byte boundary.
__host__ __device__ inline int smem_floats(const int* width, int n) {
  int total = 0, hmax = 0;
  for (int l = 0; l < n; ++l) total += round4(width[l] * width[l + 1]);
  for (int l = 0; l < n; ++l) total += round4(width[l + 1]);
  for (int l = 1; l < n; ++l) hmax = width[l] > hmax ? width[l] : hmax;
  return total + round4(width[0] * kTile) + 2 * hmax * kTile + 2 * kTile;
}

__device__ inline void stage(float* dst, const float* __restrict__ src, int count) {
  const bool vec = (count % 4 == 0) && ((reinterpret_cast<size_t>(src) & 15) == 0);
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < count / 4; k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
  }
}

__global__ void __launch_bounds__(kThreads)
ar_solve_kernel(const float* __restrict__ x, Layers L, int n_rows, int sign,
                float s_bound, float* __restrict__ y_out,
                float* __restrict__ ld_out) {
  extern __shared__ __align__(16) float smem[];
  const int d = L.width[0];
  const int n = L.n;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTile;

  const float* sw[kMaxLayers];
  const float* sb[kMaxLayers];
  float* p = smem;
  int hmax = 0;
  for (int l = 0; l < n; ++l) {
    const int count = L.width[l] * L.width[l + 1];
    stage(p, L.w[l], count);
    sw[l] = p;
    p += round4(count);
  }
  for (int l = 0; l < n; ++l) {
    stage(p, L.b[l], L.width[l + 1]);
    sb[l] = p;
    p += round4(L.width[l + 1]);
  }
  for (int l = 1; l < n; ++l) hmax = max(hmax, L.width[l]);
  float* yT = p;
  p += round4(d * kTile);
  float* hA = p;
  float* hB = p + hmax * kTile;
  float* head = p + 2 * hmax * kTile;

  for (int k = tid; k < d * kTile; k += blockDim.x) yT[k] = 0.f;
  __syncthreads();

  float ld = 0.f;  // owned by thread r < kTile for row r of the tile
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  for (int i = 0; i < d; ++i) {
    // hidden layers: relu(in @ W + b), thread j owns output column j
    const float* in = yT;
    float* out = hA;
    int in_w = d;
    for (int l = 0; l < n - 1; ++l) {
      const int out_w = L.width[l + 1];
      const float* W = sw[l];
      for (int j = tid; j < out_w; j += blockDim.x) {
        float acc[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < in_w; ++k) {
          const float w = W[k * out_w + j];
          const float4 a = *reinterpret_cast<const float4*>(in + k * kTile);
          const float4 c = *reinterpret_cast<const float4*>(in + k * kTile + 4);
          acc[0] = fmaf(a.x, w, acc[0]);
          acc[1] = fmaf(a.y, w, acc[1]);
          acc[2] = fmaf(a.z, w, acc[2]);
          acc[3] = fmaf(a.w, w, acc[3]);
          acc[4] = fmaf(c.x, w, acc[4]);
          acc[5] = fmaf(c.y, w, acc[5]);
          acc[6] = fmaf(c.z, w, acc[6]);
          acc[7] = fmaf(c.w, w, acc[7]);
        }
        const float bj = sb[l][j];
#pragma unroll
        for (int r = 0; r < kTile; ++r) out[j * kTile + r] = fmaxf(acc[r] + bj, 0.f);
      }
      __syncthreads();
      in = out;
      in_w = out_w;
      out = (out == hA) ? hB : hA;
    }

    // head: only columns i (mu) and i + d (s); one warp per dot product
    const int out_w = L.width[n];
    const float* W = sw[n - 1];
    for (int o = warp; o < 2 * kTile; o += n_warps) {
      const int r = o % kTile;
      const int col = i + (o / kTile) * d;
      float acc = 0.f;
      for (int k = lane; k < in_w; k += 32) acc = fmaf(in[k * kTile + r], W[k * out_w + col], acc);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) head[o] = acc + sb[n - 1][col];
    }
    __syncthreads();

    if (tid < kTile) {
      const int row = row0 + tid;
      const float mu = head[tid];
      float s = head[kTile + tid];
      if (s_bound > 0.f) s = s_bound * tanhf(s / s_bound);
      const float xi = row < n_rows ? x[(size_t)row * d + i] : 0.f;
      yT[i * kTile + tid] = sign < 0 ? (xi - mu) * expf(-s) : xi * expf(s) + mu;
      ld += sign < 0 ? -s : s;
    }
    __syncthreads();
  }

  for (int k = tid; k < d * kTile; k += blockDim.x) {
    const int r = k / d, c = k % d;
    if (row0 + r < n_rows) y_out[(size_t)(row0 + r) * d + c] = yT[c * kTile + r];
  }
  if (tid < kTile && row0 + tid < n_rows) ld_out[row0 + tid] = ld;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes; -1 if the layer count is
// out of range.
long long ar_solve_smem_bytes(const int* width, int n_layers) {
  if (n_layers < 2 || n_layers > kMaxLayers) return -1;
  return (long long)smem_floats(width, n_layers) * (long long)sizeof(float);
}

// x, y: (n_rows, D) f32; ld: (n_rows,) f32; ws[l]: (width[l], width[l+1])
// f32 with the mask applied; bs[l]: (width[l+1],). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int ar_solve_forward(const void* x, const void* const* ws, const void* const* bs,
                     const int* width, int n_layers, int n_rows, int sign,
                     float s_bound, void* y, void* ld, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || n_rows <= 0) return (int)cudaErrorInvalidValue;
  Layers L;
  L.n = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = static_cast<const float*>(ws[l]);
    L.b[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n_layers; ++l) L.width[l] = width[l];
  const size_t smem = (size_t)smem_floats(width, n_layers) * sizeof(float);
  // opt in to more dynamic shared memory only when this launch needs more
  // than the current device was last set to
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || (int)smem > g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(ar_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_opt_in[dev] = (int)smem;
  }
  const dim3 grid((n_rows + kTile - 1) / kTile);
  ar_solve_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), L, n_rows, sign, s_bound,
      static_cast<float*>(y), static_cast<float*>(ld));
  return (int)cudaGetLastError();
}

}  // extern "C"
