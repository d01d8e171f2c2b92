// VRACER policy-MLP acting forward, for sm_90a.
//
// Replaces the TPU kernel marlpde_tpu/ops/mlp_pallas.py:mlp_forward
// (pallas_call at :71, body _kernel at :27-39), and goes one step beyond it:
// it computes the whole acting forward of networks.VracerNet, so besides
//   h1 = tanh(x W1^T + b1),  h2 = tanh(h1 W2^T + b2)
//   V = h2 wv + bv,  mu = h2 Wm^T + bm,
//   sigma = softplus(h2 Ws^T + bs) * iex/ln2 + floor
// it applies the sigma cap's forward value min(sigma, sigma_max) and, under
// mu_param='sigma_relative', mu = mu * sigma (networks.py:89-98).  Weights
// are taken in nn.Linear's (out, in) layout.
//
// What bounds it on the H100: at the flagship shape (R=32768 rows, obs 3,
// width 128, 1 action) one call is 2*R*(3*128 + 128*128 + 3*128) = 1.1 GFLOP
// of fp32 FMAs against 0.8 MB of obs in and heads out, so it is bound by
// fp32 arithmetic and the shared-memory reads that feed it, not by HBM.  The
// simple design keeps every activation on chip: each block stages W2 (64 KB
// at width 128, so dynamic shared memory above the 48 KB static limit), W1,
// the biases and the heads once, then walks tiles of 32 rows.  A block has
// 4*width threads: thread (g, j) owns hidden unit j for the 8 rows of row
// group g, keeps their accumulators in registers, reads h1 as float4
// broadcasts and its W2 column from a padded, conflict-free layout.  Four
// row groups per block keep 32 warps on an SM although a block's shared
// memory allows only two blocks there.  The heads are warp-shuffle dot
// products.  No tensor cores yet (wgmma is later work).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;           // rows per tile
constexpr int kRowsPerThread = 8;   // rows of one row group
constexpr int kGroups = kRows / kRowsPerThread;
// threads per block = kGroups * width; W2 is staged whole in shared memory, and
// 192 is the largest multiple of 32 whose block fits the 227 KB of one SM
constexpr int kMaxWidth = 192;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus = logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(kGroups * kMaxWidth) mlp_forward_kernel(
    const float* __restrict__ obs, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ wv,
    const float* __restrict__ bv, const float* __restrict__ wm,
    const float* __restrict__ bm, const float* __restrict__ ws,
    const float* __restrict__ bs, float* __restrict__ v_out,
    float* __restrict__ mu_out, float* __restrict__ sigma_out,
    int R, int D, int W, int A, float sigma_scale, float sigma_floor,
    float sigma_max, int sigma_relative) {
  extern __shared__ __align__(16) float smem[];
  const int H = 1 + 2 * A;  // head outputs per row: V, mu[A], raw sigma[A]
  float* h1 = smem;                    // kRows * W
  float* h2 = h1 + kRows * W;          // kRows * W
  float* w2s = h2 + kRows * W;         // W * (W + 1), [i][j] = W2[j][i]
  float* w1s = w2s + W * (W + 1);      // D * W,       [d][j] = W1[j][d]
  float* b1s = w1s + D * W;            // W
  float* b2s = b1s + W;                // W
  float* hs = b2s + W;                 // H * W, rows: wv, wm[A], ws[A]
  float* hb = hs + H * W;              // H
  float* xs = hb + H;                  // kRows * D
  float* outs = xs + kRows * D;        // kRows * H

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int e = tid; e < W * W; e += blockDim.x) {
    const int j = e / W, i = e - j * W;
    w2s[i * (W + 1) + j] = w2[e];
  }
  for (int e = tid; e < W * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    w1s[d * W + j] = w1[e];
  }
  for (int e = tid; e < W; e += blockDim.x) {
    b1s[e] = b1[e];
    b2s[e] = b2[e];
    hs[e] = wv[e];
  }
  for (int e = tid; e < A * W; e += blockDim.x) {
    hs[W + e] = wm[e];
    hs[(1 + A) * W + e] = ws[e];
  }
  if (tid == 0) hb[0] = bv[0];
  for (int e = tid; e < A; e += blockDim.x) {
    hb[1 + e] = bm[e];
    hb[1 + A + e] = bs[e];
  }

  const int j = tid % W;                    // hidden unit
  const int r0 = (tid / W) * kRowsPerThread;  // first row of the row group
  const int n_tiles = (R + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kRows;
    for (int e = tid; e < kRows * D; e += blockDim.x) {
      const long long g = row0 * D + e;
      xs[e] = g < (long long)R * D ? obs[g] : 0.f;
    }
    __syncthreads();

    // layer 1
    for (int r = r0; r < r0 + kRowsPerThread; ++r) {
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(xs[r * D + d], w1s[d * W + j], acc);
      h1[r * W + j] = tanhf(acc + b1s[j]);
    }
    __syncthreads();

    // layer 2: thread (g, j) accumulates unit j for the rows of group g
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int i = 0; i < W; i += 4) {
      const float c0 = w2s[(i + 0) * (W + 1) + j];
      const float c1 = w2s[(i + 1) * (W + 1) + j];
      const float c2 = w2s[(i + 2) * (W + 1) + j];
      const float c3 = w2s[(i + 3) * (W + 1) + j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(&h1[(r0 + r) * W + i]);
        acc[r] = fmaf(h.x, c0, acc[r]);
        acc[r] = fmaf(h.y, c1, acc[r]);
        acc[r] = fmaf(h.z, c2, acc[r]);
        acc[r] = fmaf(h.w, c3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) h2[(r0 + r) * W + j] = tanhf(acc[r] + b2s[j]);
    __syncthreads();

    // heads: one warp-shuffle dot product per (row, output)
    for (int o = warp; o < kRows * H; o += nwarps) {
      const int r = o / H, h = o - r * H;
      float p = 0.f;
      for (int i = lane; i < W; i += 32) p = fmaf(h2[r * W + i], hs[h * W + i], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) outs[o] = p + hb[h];
    }
    __syncthreads();

    for (int r = tid; r < kRows; r += blockDim.x) {
      const long long row = row0 + r;
      if (row < R) v_out[row] = outs[r * H];
    }
    for (int e = tid; e < kRows * A; e += blockDim.x) {
      const int r = e / A, a = e - r * A;
      const long long row = row0 + r;
      if (row < R) {
        float sigma = softplus(outs[r * H + 1 + A + a]) * sigma_scale + sigma_floor;
        if (sigma > sigma_max) sigma = sigma_max;  // min() that keeps a NaN
        float mu = outs[r * H + 1 + a];
        if (sigma_relative) mu = mu * sigma;
        mu_out[row * A + a] = mu;
        sigma_out[row * A + a] = sigma;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mlp_forward(
    const float* obs, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* wv, const float* bv, const float* wm,
    const float* bm, const float* ws, const float* bs, float* v_out,
    float* mu_out, float* sigma_out, int R, int D, int W, int A,
    float sigma_scale, float sigma_floor, float sigma_max, int sigma_relative,
    void* stream) {
  if (R <= 0 || D <= 0 || A <= 0 || W < 32 || W > kMaxWidth || W % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int H = 1 + 2 * A;
  const size_t smem = sizeof(float) * ((size_t)2 * kRows * W + (size_t)W * (W + 1) +
                                       (size_t)D * W + 2 * W + (size_t)H * W + H +
                                       (size_t)kRows * D + (size_t)kRows * H);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = kGroups * W;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_forward_kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (R + kRows - 1) / kRows;
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  mlp_forward_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      obs, w1, b1, w2, b2, wv, bv, wm, bm, ws, bs, v_out, mu_out, sigma_out,
      R, D, W, A, sigma_scale, sigma_floor, sigma_max, sigma_relative);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
