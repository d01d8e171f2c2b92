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
// What bounds it on the H100: layer 2 is 98% of the arithmetic at width 256
// (2*R*W^2 of 2*R*(D*W + W^2 + (1+2A)*W)), so it runs on the tensor cores.
// TF32 alone keeps 10 mantissa bits and misses the float32 tolerance (2e-5
// against the module) by some 25x, so layer 2 is 3xTF32: each operand x is
// split into hi = tf32(x) and lo = x - hi, and one float32 accumulator takes
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, which is as exact as float32 (the
// dropped a_lo*b_lo is 2^-22 of the product).  At R=32768, W=256 that is
// 12.9 GFLOP of TF32 work, 26 us at the datasheet's 495 TFLOP/s.
//
// Design.  A block has two consumer warpgroups and one producer warpgroup
// (setmaxnreg moves registers to the consumers: 232 a thread, which the
// m64x256 accumulator of width 256 needs to keep its wgmmas unserialised), and
// walks tiles of 128 rows (64 a warpgroup); the grid is at most one block per
// SM per what fits, each block looping over tiles.
// - W2 is split once per parameter version by the wrapper
//   (kernels/mlp.py:w2_image) into an image of K-chunks of 32 input units:
//   chunk kc holds hi then lo, each W rows of 128 bytes laid out as the
//   128-byte swizzle of a K-major wgmma operand (16-byte group j of row n at
//   j ^ (n % 8)).  The producer copies whole chunks (up to 64 KB) into a ring
//   of shared-memory stages with cp.async.bulk, completion on an mbarrier;
//   the consumers release a stage on a second mbarrier once their wgmmas have
//   read it, which they learn one chunk later, so a streaming ring needs two
//   stages.  Where every chunk fits (width <= 160 at obs 3: 128 KB of hi+lo
//   at width 128), the ring holds all of W2 and it is loaded once for the
//   whole call; above, it streams, once per 128-row tile.
// - Layer 1 (D FMAs and one tanhf an element) is computed straight into the
//   wgmma A fragment (m64k8, 4 values a thread), split into hi/lo in
//   registers; every element is computed once per tile.  Where D <= 4 a
//   row's inputs are held in registers and W1 sits in shared memory (4 W
//   floats at most); above, W1 and x are read from global memory through the
//   read-only cache, 4 inputs at a time (16-byte loads) where D is a
//   multiple of 4, else one at a time, with the FMAs in the same order.  So
//   the shared memory a block needs besides the W2 ring (1 KB of alignment,
//   b1, that W1 and the mbarriers) does not depend on D, and every obs width
//   runs.  (W1 and the x tile staged in shared memory for every D, 4 (W +
//   128) D bytes, left no room for the ring from D = 108 at width 256, and
//   were slower than these loads from D = 32 on: PERF.md.)  A is
//   double-buffered by k-step, so layer 1 of k-step k+1 runs while the
//   three wgmmas of k run (one group a k-step: a group per 4-k-step chunk
//   measured 40% slower at width 256).
// - Layer 2 is wgmma.mma_async m64nWk8 tf32, three per k-step, with the
//   m64xW float32 accumulator in registers (W/2 a thread).
// - The epilogue forms h2 = tanh(acc + b2) in the accumulator registers; each
//   head is a per-thread partial dot over the thread's columns, reduced over
//   the 4 threads of a row by shuffles.  No atomics: two calls give the
//   same bits.
// tanhf and log1pf/expf are the accurate ones; tanh.approx (~5e-4 relative)
// would break the tolerance.
//
// Measured on the H100 (PERF.md): at R=32768 the kernel takes 0.026 ms
// at width 128 and 0.052 ms at 256, about half the tensor-core peak at 256.
// What is left is split: without the two extra products it is 19% faster,
// without layer 1 17-33%, without the epilogue's tanhf and heads 18-25%;
// streaming W2 costs nothing measurable (1 KB copies in place of 64 KB change
// under 1%).  The SIMT work (one tanhf per hidden value, the heads) and the
// tensor work of a warpgroup overlap only partly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kTileRows = 128;           // rows per tile: two warpgroups of 64
constexpr int kConsumers = 256;          // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: 2*128*232 + 128*40 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kChunkK = 32;              // input units per W2 chunk: one 128-byte row
constexpr int kMaxWidth = 256;
constexpr int kSmallD = 4;               // inputs a thread keeps in registers

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus = logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one bulk copy of `bytes` from global to shared, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart; `addr` may step by 32 bytes
// (one k8 slice of tf32) inside a 1024-byte aligned atom
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

struct Args {
  const float* obs;
  const float* w2img;  // kernels/mlp.py:w2_image, (W/32) chunks of 2*W*32 floats
  const float* w1;
  const float* b1;
  const float* b2;
  const float* wv;
  const float* bv;
  const float* wm;
  const float* bm;
  const float* ws;
  const float* bs;
  float* v_out;
  float* mu_out;
  float* sigma_out;
  int R, D, A;
  float sigma_scale, sigma_floor, sigma_max;
  int sigma_relative;
  int stages;  // shared-memory stages of the W2 ring; == W/32: W2 resident
};

// shared memory, from a 1024-byte aligned base: stages * chunk bytes of W2
// images, then b1 (W), W1 (W * kSmallD, filled where D <= kSmallD), then
// 2*stages mbarriers
template <int W>
__global__ void __launch_bounds__(kThreads, 1) mlp_forward_kernel(const Args args) {
  static_assert(W % kChunkK == 0 && W <= kMaxWidth, "width: a multiple of 32 up to 256");
  constexpr int kChunks = W / kChunkK;
  constexpr uint32_t kChunkBytes = 2u * W * kChunkK * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int R = args.R, D = args.D, A = args.A, S = args.stages;
  const bool resident = S == kChunks;
  float* b1s = reinterpret_cast<float*>(base + (size_t)S * kChunkBytes);
  float* w1s = b1s + W;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w1s + W * kSmallD);  // full[S], empty[S]
  const uint32_t ring = smem_addr(base);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * S;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < W; e += kThreads) b1s[e] = args.b1[e];
  if (D <= kSmallD)
    for (int e = tid; e < W * D; e += kThreads) w1s[e] = args.w1[e];
  __syncthreads();

  const int n_tiles = (R + kTileRows - 1) / kTileRows;

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring of W2 chunks in flight; its
    // warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != kConsumers) return;
    if (resident) {
      for (int kc = 0; kc < kChunks; ++kc)
        bulk_load(ring + kc * kChunkBytes, args.w2img + (size_t)kc * kChunkBytes / 4,
                  kChunkBytes, full0 + 8 * kc);
      return;
    }
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int kc = 0; kc < kChunks; ++kc, ++it) {
        const int s = it % S;
        mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
        bulk_load(ring + s * kChunkBytes, args.w2img + (size_t)kc * kChunkBytes / 4,
                  kChunkBytes, full0 + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile; in
  // the wgmma fragments thread (warp w, lane 4g + t) holds rows 16w + g and
  // 16w + g + 8 of them, A columns t and t + 4 of each k8 slice, and
  // accumulator columns 8j + 2t, 8j + 2t + 1
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // row of the tile; r0 + 8 the other
  // 16-byte loads of W1 and x rows: D a multiple of 4, both 16-byte aligned
  const bool vec4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(args.obs) |
                                   reinterpret_cast<uintptr_t>(args.w1)) % 16 == 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kTileRows;
    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
    uint32_t a_hi[2][4], a_lo[2][4];
    // the thread's two rows; a row past R is read as the last one (its
    // outputs are not written)
    const float* x0 = args.obs + (size_t)min(row0 + r0, (long long)R - 1) * D;
    const float* x1 = args.obs + (size_t)min(row0 + r0 + 8, (long long)R - 1) * D;
    // up to kSmallD inputs (the burger envs' 3) stay in registers for the tile
    float xr0[kSmallD], xr1[kSmallD];
#pragma unroll
    for (int d = 0; d < kSmallD; ++d) {
      xr0[d] = d < D ? __ldg(x0 + d) : 0.f;
      xr1[d] = d < D ? __ldg(x1 + d) : 0.f;
    }
    int prev_stage = -1;
    for (int kc = 0; kc < kChunks; ++kc, ++it) {
      const int s = resident ? kc : it % S;
      mbar_wait(full0 + 8 * s, resident ? 0 : (it / S) & 1);
      __syncwarp();  // converged again for the .aligned wgmma instructions
      const uint32_t hi_b = ring + s * kChunkBytes, lo_b = hi_b + W * kChunkK * 4;
#pragma unroll
      for (int kk = 0; kk < kChunkK / 8; ++kk) {
        const int p = kk & 1;
        // layer 1 into the A fragment: (r0, c), (r0+8, c), (r0, c+4), (r0+8, c+4)
        const int c = kc * kChunkK + kk * 8 + t;
        float h00 = 0.f, h10 = 0.f, h01 = 0.f, h11 = 0.f;
        const float* wa = args.w1 + (size_t)c * D;
        const float* wb = wa + 4 * D;
        if (D <= kSmallD) {
          const float* sa = w1s + c * D;
          const float* sb = sa + 4 * D;
#pragma unroll
          for (int d = 0; d < kSmallD; ++d) {
            if (d < D) {
              h00 = fmaf(xr0[d], sa[d], h00);
              h10 = fmaf(xr1[d], sa[d], h10);
              h01 = fmaf(xr0[d], sb[d], h01);
              h11 = fmaf(xr1[d], sb[d], h11);
            }
          }
        } else if (vec4) {
#pragma unroll 4
          for (int d = 0; d < D; d += 4) {
            const float4 xa = __ldg(reinterpret_cast<const float4*>(x0 + d));
            const float4 xb = __ldg(reinterpret_cast<const float4*>(x1 + d));
            const float4 va = __ldg(reinterpret_cast<const float4*>(wa + d));
            const float4 vb = __ldg(reinterpret_cast<const float4*>(wb + d));
            const float ra[4] = {xa.x, xa.y, xa.z, xa.w}, rb[4] = {xb.x, xb.y, xb.z, xb.w};
            const float ca[4] = {va.x, va.y, va.z, va.w}, cb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              h00 = fmaf(ra[q], ca[q], h00);
              h10 = fmaf(rb[q], ca[q], h10);
              h01 = fmaf(ra[q], cb[q], h01);
              h11 = fmaf(rb[q], cb[q], h11);
            }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            const float xa = __ldg(x0 + d), xb = __ldg(x1 + d);
            const float wad = __ldg(wa + d), wbd = __ldg(wb + d);
            h00 = fmaf(xa, wad, h00);
            h10 = fmaf(xb, wad, h10);
            h01 = fmaf(xa, wbd, h01);
            h11 = fmaf(xb, wbd, h11);
          }
        }
        const float h[4] = {tanhf(h00 + b1s[c]), tanhf(h10 + b1s[c]), tanhf(h01 + b1s[c + 4]),
                            tanhf(h11 + b1s[c + 4])};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a_hi[p][q] = tf32_hi(h[q]);
          a_lo[p][q] = __float_as_uint(h[q] - __uint_as_float(a_hi[p][q]));
        }
        fence_a(a_hi[p]);
        fence_a(a_lo[p]);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        WgmmaTf32<W>::mma(acc, a_lo[p], sw128_desc(hi_b + kk * 32));
        WgmmaTf32<W>::mma(acc, a_hi[p], sw128_desc(lo_b + kk * 32));
        WgmmaTf32<W>::mma(acc, a_hi[p], sw128_desc(hi_b + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the group before this one is done: its A buffer may be rewritten,
        // and at kk == 0 every wgmma of the previous chunk has read its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc);
        if (kk == 0 && prev_stage >= 0 && !resident) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev_stage);
        }
      }
      prev_stage = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (!resident) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev_stage);
    }

    // h2 in place, then the heads
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(args.b2 + 8 * j + 2 * t));
      acc[4 * j + 0] = tanhf(acc[4 * j + 0] + b.x);
      acc[4 * j + 1] = tanhf(acc[4 * j + 1] + b.y);
      acc[4 * j + 2] = tanhf(acc[4 * j + 2] + b.x);
      acc[4 * j + 3] = tanhf(acc[4 * j + 3] + b.y);
    }
    // one head row w (W floats) dotted with rows r0 and r0 + 8, summed over the quad
    auto head = [&](const float* w, float& p0, float& p1) {
      p0 = 0.f;
      p1 = 0.f;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 h = __ldg(reinterpret_cast<const float2*>(w + 8 * j + 2 * t));
        p0 = fmaf(acc[4 * j + 0], h.x, p0);
        p0 = fmaf(acc[4 * j + 1], h.y, p0);
        p1 = fmaf(acc[4 * j + 2], h.x, p1);
        p1 = fmaf(acc[4 * j + 3], h.y, p1);
      }
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    };
    const long long row_a = row0 + r0, row_b = row_a + 8;
    float v0, v1;
    head(args.wv, v0, v1);
    if (t == 0) {
      const float bv = __ldg(args.bv);
      if (row_a < R) args.v_out[row_a] = v0 + bv;
      if (row_b < R) args.v_out[row_b] = v1 + bv;
    }
    for (int a = 0; a < A; ++a) {
      float m0, m1, s0, s1;
      head(args.wm + (size_t)a * W, m0, m1);
      head(args.ws + (size_t)a * W, s0, s1);
      if (t == 0) {
        const float bm = __ldg(args.bm + a), bs = __ldg(args.bs + a);
        const float mm[2] = {m0 + bm, m1 + bm}, ss[2] = {s0 + bs, s1 + bs};
        const long long rows[2] = {row_a, row_b};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (rows[q] >= R) continue;
          float sigma = softplus(ss[q]) * args.sigma_scale + args.sigma_floor;
          if (sigma > args.sigma_max) sigma = args.sigma_max;  // min() that keeps a NaN
          float mu = mm[q];
          if (args.sigma_relative) mu = mu * sigma;
          args.mu_out[rows[q] * A + a] = mu;
          args.sigma_out[rows[q] * A + a] = sigma;
        }
      }
    }
  }
}

template <int W>
int launch(const Args& args, cudaStream_t stream) {
  constexpr int kChunks = W / kChunkK;
  constexpr size_t kChunkBytes = 2u * W * kChunkK * sizeof(float);
  int device = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // The ring takes what b1 and the small-D W1 leave, all of W2 where it
  // fits, else as many stages as fit, at least two (a stage is released one
  // chunk after it is read): three of the widest chunk (2 * 256 * 32 * 4
  // bytes) fit in 227 KB
  const size_t fixed = 1024 + sizeof(float) * W * (1 + kSmallD);
  const int min_stages = kChunks < 2 ? kChunks : 2;
  int stages = kChunks;
  while (stages > 0 && fixed + stages * (kChunkBytes + 16) > (size_t)max_smem) --stages;
  if (stages < min_stages) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + stages * (kChunkBytes + 16);
  Args a = args;
  a.stages = stages;
  err = cudaFuncSetAttribute(mlp_forward_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_forward_kernel<W>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (args.R + kTileRows - 1) / kTileRows;
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  mlp_forward_kernel<W><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mlp_forward(
    const float* obs, const float* w1, const float* b1, const float* w2img,
    const float* b2, const float* wv, const float* bv, const float* wm,
    const float* bm, const float* ws, const float* bs, float* v_out,
    float* mu_out, float* sigma_out, int R, int D, int W, int A,
    float sigma_scale, float sigma_floor, float sigma_max, int sigma_relative,
    void* stream) {
  if (R <= 0 || D <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  const Args args{obs, w2img, w1, b1, b2, wv, bv, wm, bm, ws, bs, v_out, mu_out, sigma_out,
                  R, D, A, sigma_scale, sigma_floor, sigma_max, sigma_relative, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 32: return launch<32>(args, s);
    case 64: return launch<64>(args, s);
    case 96: return launch<96>(args, s);
    case 128: return launch<128>(args, s);
    case 160: return launch<160>(args, s);
    case 192: return launch<192>(args, s);
    case 224: return launch<224>(args, s);
    case 256: return launch<256>(args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
