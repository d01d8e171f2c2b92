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
// Every tensor-core product is 3xTF32: TF32 alone keeps 10 mantissa bits and
// misses the float32 tolerance (2e-5 against the module) by some 25x, so each
// operand x is split into hi = tf32(x) and lo = x - hi, and one float32
// accumulator takes a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, which is as exact as
// float32 (the dropped a_lo*b_lo is 2^-22 of the product).
//
// Two routes, chosen by the obs width D alone (kernels/mlp.py:wide_route):
//
// The narrow route (D <= 4: the Burgers flagship, run 918, laplace, [mesh]).
// Layer 2 is 98% of the arithmetic at width 256 (2*R*W^2 of 2*R*(D*W + W^2 +
// (1+2A)*W)), so it alone runs on the tensor cores.  A block has two
// consumer warpgroups and one producer warpgroup (setmaxnreg moves registers
// to the consumers: 232 a thread, which the m64x256 accumulator of width 256
// needs to keep its wgmmas unserialised), and walks tiles of 128 rows (64 a
// warpgroup); the grid is at most one block per SM, each block looping over
// tiles.
// - W2 is split once per parameter version by the wrapper
//   (kernels/mlp.py:w2_image) into an image of K-chunks of 32 input units:
//   chunk kc holds hi then lo, each W rows of 128 bytes laid out as the
//   128-byte swizzle of a K-major wgmma operand (16-byte group j of row n at
//   j ^ (n % 8)).  The producer copies whole chunks (up to 64 KB) into a ring
//   of shared-memory stages with cp.async.bulk, completion on an mbarrier;
//   the consumers release a stage on a second mbarrier once their wgmmas have
//   read it, which they learn one chunk later, so a streaming ring needs two
//   stages.  Where every chunk fits (width <= 160: 128 KB of hi+lo at width
//   128), the ring holds all of W2 and it is loaded once for the whole call;
//   above, it streams, once per 128-row tile.
// - Layer 1 (D FMAs and one tanhf an element) is computed straight into the
//   wgmma A fragment (m64k8, 4 values a thread) from a row's inputs held in
//   registers and W1 in shared memory, split into hi/lo in registers.  A is
//   double-buffered by k-step, so layer 1 of k-step k+1 runs while the three
//   wgmmas of k run.
// - The epilogue forms h2 = tanh(acc + b2) in the accumulator registers; each
//   head is a per-thread partial dot over the thread's columns, reduced over
//   the 4 threads of a row by shuffles.
// Measured on the H100 (PERF.md): at R=32768 0.026 ms at width 128 and 0.052
// ms at 256, about half the tensor-core peak at 256.
//
// The wide route (D > 4: KS, burger-fd, the diffusion and advection presets,
// the Burgers variants, APG's --test, the dry run).  Here layer 1 (D up to
// 256) and the heads (1 + 2A columns, A up to 256) hold as much arithmetic
// as layer 2, and the acting calls have R = 8-16 rows: one block per 128-row
// tile with the heads one action after another, as the narrow route does,
// ran on one SM in series and lost to the module on cuBLAS by up to 5.5x.
// So all three products run on the tensor cores, and the grid spreads the
// heads' columns as well as the rows.  What the card showed (PERF.md): a
// chain of wgmmas on one accumulator costs nearly the same a step whatever
// its N from 64 to 256, far below the tensor cores' rate at M = 64, and
// independent wgmmas of one warpgroup barely overlap, those of two
// warpgroups do.
// - A block (512 threads) owns a 64-row tile (the wgmma M) and a run of head
//   steps: the grid is ceil(R/64) row tiles by as many column blocks as fill
//   the SMs, up to one a step.  Each block computes h1 and h2 of its rows
//   itself, so no output is written by two blocks (no atomics, no split-K:
//   two calls give the same bits).  At R <= 64 and A = 128 to 256 that is 3
//   to 5 blocks, each recomputing R*(D*W + W^2) MACs.
// - Two consumer warpgroups split every product's columns: each computes W/2
//   of h1 (K = D in chunks of 32, the last zero-padded, k-steps wholly past D
//   skipped) and of h2 (K = W), and one head tile of a step.  The heads are
//   one product of h2 with a head matrix of tiles of kHeadN = 64 columns:
//   tile ct's columns 0..31 are the mu rows of action slots 32 ct .. 32 ct +
//   31, columns 32..63 their sigma rows, and slot A is the value head (its
//   sigma row is zero).  So an action's mu and sigma land in one thread's
//   accumulator fragment (columns 8j + 2t, 8j + 2t + 1 and 32 more), and the
//   epilogue (bias, softplus, floor, the cap, sigma_relative) runs on the
//   fragments and writes two consecutive actions of mu and of sigma a thread.
//   kernels/mlp.py:head_matrix is this layout in torch.
// - The tensor cores round each wgmma's sum toward zero; one accumulator
//   carried through a product's 3 K / 8 wgmmas missed the 2e-5 tolerance by
//   2x at K = 128 to 256.  So each 32-input chunk's products (the small
//   lo*hi and hi*lo first, then hi*hi) go into a fresh accumulator, summed
//   into the product's total in registers, rounding to nearest, once they
//   are done (read while a wgmma is in flight, ptxas serialises them all).
// - Every B operand (W1, W2, the head matrix) is read raw, as nn.Linear
//   holds it, and split as it is staged, so no weight image exists for this
//   route and nothing has to be rewritten when an optimizer step or a
//   replayed graph changes a weight.  Two producer warpgroups, one for each
//   consumer warpgroup, load a stage's chunk from global memory into
//   registers (16-byte loads where aligned) and store B's hi rows as the raw
//   float32 (the tensor cores read its top 19 bits) and its lo rows as what
//   that truncation drops, rounded to TF32, in the 128-byte swizzle; then
//   they arrive on the stage's mbarrier after a proxy fence (the wgmmas read
//   shared memory through the async proxy).  One producer warpgroup for both
//   consumers could not keep up.  The x tile rides in layer 1's stages in
//   the A fragment's order (one 16-byte shared load a thread a k-step), and
//   is split by the consumers.
// - Each consumer warpgroup has its own stages, every other one of the ring
//   (2 or 3 each, 40 KB at width 256), and releases a stage once its chunk's
//   wgmmas are done.  h1 and h2 pass between products through one padded
//   shared buffer (64 rows of W + 4 floats, conflict-free fragment loads),
//   the two warpgroups meeting at a named barrier before h1 is read, before
//   h2 overwrites it, and before h2 is read.
// - setmaxnreg gives the consumers 184 registers a thread (a total of W/4
//   floats, a chunk's accumulator of W/4, 32 of A fragments) and the
//   producers 72; at widths 224 and 256 ptxas spills a few bytes.
// The route is chosen by D alone: at every obs <= 4 row of [kernels] the
// wide route forced takes 1.3-3.5x the narrow route's time.
// tanhf and log1pf/expf are the accurate ones; tanh.approx (~5e-4 relative)
// would break the tolerance.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kTileRows = 128;           // narrow: rows per tile, two warpgroups of 64
constexpr int kConsumers = 256;          // narrow: threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: 2*128*232 + 128*40 = 384*168, what
// the launch holds (65536 / 384, rounded down to a multiple of 8)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kChunkK = 32;              // input units per chunk: one 128-byte row
constexpr int kMaxWidth = 256;
constexpr int kSmallD = 4;               // the narrow route's obs widths: inputs in registers

constexpr int kWideRows = 64;            // wide: rows per tile, the wgmma M
constexpr int kWideThreads = 512;        // two consumer warpgroups, then two producers
// registers a thread after setmaxnreg: the launch holds 128 a thread (65536
// / 512), and setmaxnreg.inc waits until the producers' dec has returned
// enough: 2*128*184 + 2*128*72 = 512*128
constexpr int kWideConsumerRegs = 184;
constexpr int kWideProducerRegs = 72;
static_assert(2 * 128 * kWideConsumerRegs + 2 * 128 * kWideProducerRegs <= 512 * 128,
              "setmaxnreg: the consumers' registers come from the producers'");
constexpr int kHeadN = 64;               // wide: head columns a tile
constexpr int kHeadSlots = kHeadN / 2;   // action slots a tile: mu columns, then sigma's
constexpr int kMaxStages = 6;


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
  const float* w2img;  // kernels/mlp.py:w2_image, (W/32) chunks of 2*W*32 floats (narrow)
  const float* w1;
  const float* b1;
  const float* w2;     // W2 as nn.Linear holds it (wide)
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
  int stages;      // shared-memory stages of the ring; narrow: == W/32 when W2 is resident
  int head_tiles;  // wide: head steps (two head tiles each) a column block
};

// sigma of a raw sigma-head value, capped; mu under sigma_relative
__device__ __forceinline__ void policy_head(const Args& args, float m, float raw, float& mu,
                                            float& sigma) {
  sigma = softplus(raw) * args.sigma_scale + args.sigma_floor;
  if (sigma > args.sigma_max) sigma = args.sigma_max;  // min() that keeps a NaN
  mu = args.sigma_relative ? m * sigma : m;
}

// ------------------------------------------------------------ narrow route

// shared memory, from a 1024-byte aligned base: stages * chunk bytes of W2
// images, then b1 (W), W1 (W * kSmallD), then 2*stages mbarriers
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
    // the row's inputs (the burger envs' 3) stay in registers for the tile
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
          float mu, sigma;
          policy_head(args, mm[q], ss[q], mu, sigma);
          args.mu_out[rows[q] * A + a] = mu;
          args.sigma_out[rows[q] * A + a] = sigma;
        }
      }
    }
  }
}

template <int W>
int launch_narrow(const Args& args, cudaStream_t stream, int sms, int max_smem) {
  constexpr int kChunks = W / kChunkK;
  constexpr size_t kChunkBytes = 2u * W * kChunkK * sizeof(float);
  // The ring takes what b1 and W1 leave, all of W2 where it fits, else as
  // many stages as fit, at least two (a stage is released one chunk after it
  // is read): three of the widest chunk (2 * 256 * 32 * 4 bytes) fit in 227 KB
  const size_t fixed = 1024 + sizeof(float) * W * (1 + kSmallD);
  const int min_stages = kChunks < 2 ? kChunks : 2;
  int stages = kChunks;
  while (stages > 0 && fixed + stages * (kChunkBytes + 16) > (size_t)max_smem) --stages;
  if (stages < min_stages) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + stages * (kChunkBytes + 16);
  Args a = args;
  a.stages = stages;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_forward_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_forward_kernel<W>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (args.R + kTileRows - 1) / kTileRows;
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  mlp_forward_kernel<W><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- wide route

// TF32 hi of x and the TF32 rounding of what it leaves, lo: both round to
// nearest, so the tensor cores' truncation of an operand to its top 19 bits
// loses nothing
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = tf32_hi(x - __uint_as_float(hi));
}

// what the TF32 truncation of float32 bits x drops, rounded to TF32
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
  return tf32_hi(__uint_as_float(x) - __uint_as_float(x & 0xFFFFE000u));
}

// 4 inputs k .. k+3 of a row (zero past kmax, or where the row is null)
__device__ __forceinline__ void load4(const float* row, int k, int kmax, bool vec,
                                      float (&v)[4]) {
  if (row != nullptr && vec && k + 4 <= kmax) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(row + k));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = (row != nullptr && k + q < kmax) ? __ldg(row + k + q) : 0.f;
  }
}

// the ring of the wide kernel, as one consumer thread sees it
struct Ring {
  unsigned char* base;  // stage s at base + s * bytes
  uint32_t addr;        // its shared address
  uint32_t full0, empty0;
  int stages;
  uint32_t bytes;
  uint32_t lo;          // bytes from a stage's hi rows to its lo rows
  int it;               // the next stage of this warpgroup: every other one
};

// total (m64 x NT, float32) = A B^T over `chunks` stages of the ring, B being
// the first NT rows of each stage (inputs 32 kc .. 32 kc + 31 of chunk kc,
// hi and lo), and load_a(st, kc, kk, a) giving the thread's 4 A
// values of its k-step kk.  K-steps at or past kmax are skipped (their
// inputs are zero).  A warpgroup that is not `active` only passes the
// stages on.  The tensor cores round each wgmma's sum toward zero, so a
// chunk's products go into a fresh accumulator, the small ones first (lo*hi
// and hi*lo of its k-steps, then hi*hi), and the chunk's sum is added to
// total in registers, rounding to nearest: one accumulator that carried the
// whole sum through 3 K / 8 wgmmas missed the 2e-5 tolerance by 2x at K =
// 128 to 256.  The accumulator is read only once its wgmmas are done
// (wait_group 0): read while one is in flight, ptxas serialises every wgmma
// of the kernel.
template <int NT, class LoadA>
__device__ __forceinline__ void product(float (&total)[NT / 2], Ring& ring, int chunks, int kmax,
                                        bool active, int lane, LoadA load_a) {
  constexpr int kSteps = kChunkK / 8;
  float acc[NT / 2];
  uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) total[i] = 0.f;
  for (int kc = 0; kc < chunks; ++kc, ring.it += 2) {
    const int s = ring.it % ring.stages;
    mbar_wait(ring.full0 + 8 * s, (ring.it / ring.stages) & 1);
    if (active) {
      __syncwarp();  // converged again for the .aligned wgmma instructions
      unsigned char* st = ring.base + (size_t)s * ring.bytes;
      const uint32_t hi_b = ring.addr + s * ring.bytes, lo_b = hi_b + ring.lo;
      const int steps = min(kSteps, (kmax - kc * kChunkK + 7) / 8);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (kk < steps) load_a(st, kc, kk, a);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], a_hi[kk][q], a_lo[kk][q]);
        fence_a(a_hi[kk]);
        fence_a(a_lo[kk]);
      }
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk < steps) {
          WgmmaTf32<NT>::mma(acc, a_lo[kk], sw128_desc(hi_b + kk * 32), kk > 0);
          WgmmaTf32<NT>::mma(acc, a_hi[kk], sw128_desc(lo_b + kk * 32));
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        if (kk < steps) WgmmaTf32<NT>::mma(acc, a_hi[kk], sw128_desc(hi_b + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) total[i] += acc[i];
    }
    // the stage is read: release it
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty0 + 8 * s);
  }
}

// the two consumer warpgroups, and only they, meet here
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wide kernel.  Shared memory, from a 1024-byte aligned base: `stages`
// stages (kRows rows of B's hi, as many of its lo, each row 128 bytes in the
// 128-byte swizzle, then in layer 1's stages the x chunk in fragment order;
// rows past those the stage's product reads are zero), the h buffer (64
// rows of W + 4 floats), then 2*stages mbarriers
template <int W>
__global__ void __launch_bounds__(kWideThreads, 1) mlp_wide_kernel(const Args args) {
  static_assert(W % kChunkK == 0 && W <= kMaxWidth, "width: a multiple of 32 up to 256");
  constexpr int kHalf = W / 2;  // hidden columns a consumer warpgroup computes
  constexpr int kRows = kHalf > kHeadN ? kHalf : kHeadN;  // B rows a stage holds
  constexpr uint32_t kStage = 2 * kRows * 128 + kWideRows * kChunkK * 4;
  constexpr int kHS = W + 4;  // h buffer row stride, floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int R = args.R, D = args.D, A = args.A, S = args.stages;
  float* hbuf = reinterpret_cast<float*>(base + (size_t)S * kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(hbuf + kWideRows * kHS);  // full[S], empty[S]
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 128);  // every producer thread arrives
      mbar_init(empty0 + 8 * s, 4);   // one arrival per warp of its consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * kWideRows;
  // head tiles: tile ct is slots 32 ct .. 32 ct + 31; a block step is two
  // tiles, one a consumer warpgroup
  const int n_ct = (A + 1 + kHeadSlots - 1) / kHeadSlots;
  const int n_steps = (n_ct + 1) / 2;
  const int cs0 = blockIdx.y * args.head_tiles;
  const int cs1 = min(cs0 + args.head_tiles, n_steps);
  const int n1 = (D + kChunkK - 1) / kChunkK;  // layer 1's chunks
  constexpr int n2 = W / kChunkK;              // layer 2's and each head step's

  if (tid >= 256) {
    // producer warpgroups: stage q is consumer warpgroup q % 2's stage c =
    // q / 2 (layer 1's chunk c of W1's rows of its columns and the x chunk,
    // then layer 2's, then each head step's), and producer warpgroup q % 2
    // fills it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProducerRegs));
    const int pw = (tid - 256) / 128, ptid = tid % 128;
    const int c1 = n1, c2 = c1 + n2, q3 = 2 * (c2 + (cs1 - cs0) * n2);  // c: stage of a warpgroup
    const bool vec1 = D % 4 == 0 && reinterpret_cast<uintptr_t>(args.w1) % 16 == 0;
    const bool vec2 = reinterpret_cast<uintptr_t>(args.w2) % 16 == 0;
    const bool vech = (reinterpret_cast<uintptr_t>(args.wv) | reinterpret_cast<uintptr_t>(args.wm) |
                       reinterpret_cast<uintptr_t>(args.ws)) % 16 == 0;
    // the x fragment this thread stages is consumer thread ptid's: rows r0
    // and r0 + 8 of the tile, inputs t and t + 4 of each k8 slice
    const int xr = (ptid / 32) * 16 + (ptid % 32) / 4, xt = ptid % 4;
    const float* xa = row0 + xr < R ? args.obs + (size_t)(row0 + xr) * D : nullptr;
    const float* xb = row0 + xr + 8 < R ? args.obs + (size_t)(row0 + xr + 8) * D : nullptr;
    // row n of stage q's B and its inputs (null: zeros)
    auto source = [&](int q, int n, int& K, bool& vec) -> const float* {
      const int b = q & 1, c = q >> 1;
      if (c < c1) {
        K = D, vec = vec1;
        return n < kHalf ? args.w1 + (size_t)(b * kHalf + n) * D : nullptr;
      }
      K = W;
      if (c < c2) {
        vec = vec2;
        return n < kHalf ? args.w2 + (size_t)(b * kHalf + n) * W : nullptr;
      }
      vec = vech;
      // the head matrix's row n of tile 2 step + b (kernels/mlp.py:head_matrix)
      const int ct = 2 * (cs0 + (c - c2) / n2) + b;
      const int slot = ct * kHeadSlots + n % kHeadSlots;
      if (n >= kHeadN) return nullptr;
      if (n < kHeadSlots)
        return slot < A ? args.wm + (size_t)slot * W : (slot == A ? args.wv : nullptr);
      return slot < A ? args.ws + (size_t)slot * W : nullptr;
    };
    auto chunk = [&](int q) {
      const int c = q >> 1;
      return c < c1 ? c : (c < c2 ? c - c1 : (c - c2) % n2);
    };
    // a thread's share of a stage: B groups e = ptid + 128 i (row e / 8,
    // inputs 4 (e % 8) .. + 3), and in layer 1 its x fragment
    struct Share {
      float b[kRows * 8 / 128][4];
      float4 x[kChunkK / 8];
    };
    auto load = [&](int q, Share& sh) {
      const int k0 = chunk(q) * kChunkK;
#pragma unroll
      for (int i = 0; i < kRows * 8 / 128; ++i) {
        const int e = ptid + 128 * i, n = e >> 3;
        int K;
        bool vec;
        const float* row = source(q, n, K, vec);
        load4(row, k0 + 4 * (e & 7), K, vec, sh.b[i]);
      }
      if ((q >> 1) < c1) {
#pragma unroll
        for (int kk = 0; kk < kChunkK / 8; ++kk) {
          const int k = k0 + kk * 8 + xt;
          sh.x[kk].x = xa != nullptr && k < D ? __ldg(xa + k) : 0.f;
          sh.x[kk].y = xb != nullptr && k < D ? __ldg(xb + k) : 0.f;
          sh.x[kk].z = xa != nullptr && k + 4 < D ? __ldg(xa + k + 4) : 0.f;
          sh.x[kk].w = xb != nullptr && k + 4 < D ? __ldg(xb + k + 4) : 0.f;
        }
      }
    };
    // B's hi rows take the raw values (the tensor cores read a float32 as
    // its top 19 bits, the TF32 truncation), its lo rows what the truncation
    // drops, rounded to TF32; each row 128 bytes in the 128-byte swizzle
    auto store = [&](int q, const Share& sh) {
      const int s = q % S;
      mbar_wait(empty0 + 8 * s, ((q / S) & 1) ^ 1);
      unsigned char* st = base + (size_t)s * kStage;
#pragma unroll
      for (int i = 0; i < kRows * 8 / 128; ++i) {
        const int e = ptid + 128 * i, n = e >> 3, j = e & 7;
        const int off = n * 128 + ((j ^ (n & 7)) << 4);
        const uint4 h = make_uint4(__float_as_uint(sh.b[i][0]), __float_as_uint(sh.b[i][1]),
                                   __float_as_uint(sh.b[i][2]), __float_as_uint(sh.b[i][3]));
        *reinterpret_cast<uint4*>(st + off) = h;
        *reinterpret_cast<uint4*>(st + kRows * 128 + off) =
            make_uint4(tf32_lo(h.x), tf32_lo(h.y), tf32_lo(h.z), tf32_lo(h.w));
      }
      if ((q >> 1) < c1) {
        float4* xs = reinterpret_cast<float4*>(st + 2 * kRows * 128);
#pragma unroll
        for (int kk = 0; kk < kChunkK / 8; ++kk) xs[kk * 128 + ptid] = sh.x[kk];
      }
      // the wgmmas read the stage through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full0 + 8 * s);
    };
    // producer warpgroup pw fills consumer warpgroup pw's stages, one at a time
    Share sh;
    for (int q = pw; q < q3; q += 2) {
      load(q, sh);
      store(q, sh);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsumerRegs));
  // consumer warpgroup wg: thread (warp w, lane 4g + t) holds rows r0 = 16w
  // + g and r0 + 8 of the tile, A columns t and t + 4 of each k8 slice, and
  // accumulator columns 8j + 2t, 8j + 2t + 1 of the warpgroup's columns
  const int wg = tid / 128, ctid = tid % 128;
  const int warp = ctid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;
  // this warpgroup's stages are every other one, from its own index
  Ring ring{base, smem_addr(base), full0, empty0, S, kStage, kRows * 128, wg};

  // layer 1's A: the x chunk the producer staged in fragment order
  auto load_x = [&](unsigned char* st, int, int kk, float(&a)[4]) {
    const float4 f = reinterpret_cast<const float4*>(st + 2 * kRows * 128)[kk * 128 + ctid];
    a[0] = f.x;
    a[1] = f.y;
    a[2] = f.z;
    a[3] = f.w;
  };
  // A from the h buffer: (r0, c), (r0 + 8, c), (r0, c + 4), (r0 + 8, c + 4)
  auto load_h = [&](unsigned char*, int kc, int kk, float(&a)[4]) {
    const float* h = hbuf + r0 * kHS + kc * kChunkK + kk * 8 + t;
    a[0] = h[0];
    a[1] = h[8 * kHS];
    a[2] = h[4];
    a[3] = h[8 * kHS + 4];
  };
  // tanh(total + b) into this warpgroup's columns of the h buffer
  const int c0 = wg * kHalf;
  auto store_h = [&](const float(&total)[kHalf / 2], const float* bias) {
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
      *reinterpret_cast<float2*>(hbuf + r0 * kHS + c) =
          make_float2(tanhf(total[4 * j + 0] + b0), tanhf(total[4 * j + 1] + b1));
      *reinterpret_cast<float2*>(hbuf + (r0 + 8) * kHS + c) =
          make_float2(tanhf(total[4 * j + 2] + b0), tanhf(total[4 * j + 3] + b1));
    }
  };
  {
    float total[kHalf / 2];
    product<kHalf>(total, ring, n1, D, true, lane, load_x);  // layer 1
    store_h(total, args.b1);
    consumers_sync();  // h1 whole
    product<kHalf>(total, ring, n2, W, true, lane, load_h);  // layer 2
    consumers_sync();  // every read of h1 done
    store_h(total, args.b2);
    consumers_sync();  // h2 whole
  }

  // the heads: a step is tiles 2 step (warpgroup 0) and 2 step + 1 (1)
  const long long rows[2] = {row0 + r0, row0 + r0 + 8};
  for (int step = cs0; step < cs1; ++step) {
    const int ct = 2 * step + wg;
    float acc[kHeadN / 2];
    product<kHeadN>(acc, ring, n2, W, ct < n_ct, lane, load_h);
    if (ct >= n_ct) continue;
    // fragment j < kHeadN/16 holds the mu columns of slots 8j + 2t + e, and
    // j + kHeadN/16 their sigma columns
#pragma unroll
    for (int j = 0; j < kHeadN / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = ct * kHeadSlots + 8 * j + 2 * t + e;
        if (slot > A) continue;
        const float bm = slot < A ? __ldg(args.bm + slot) : __ldg(args.bv);
        const float bs = slot < A ? __ldg(args.bs + slot) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rows[h] >= R) continue;
          const float m = acc[4 * j + 2 * h + e] + bm;
          if (slot == A) {
            args.v_out[rows[h]] = m;
            continue;
          }
          float mu, sigma;
          policy_head(args, m, acc[4 * (j + kHeadN / 16) + 2 * h + e] + bs, mu, sigma);
          args.mu_out[rows[h] * A + slot] = mu;
          args.sigma_out[rows[h] * A + slot] = sigma;
        }
      }
    }
  }
}

template <int W>
int launch_wide(const Args& args, cudaStream_t stream, int sms, int max_smem) {
  constexpr int kRows = W / 2 > kHeadN ? W / 2 : kHeadN;
  constexpr size_t kStage = 2 * kRows * 128 + kWideRows * kChunkK * 4;
  const size_t fixed = 1024 + sizeof(float) * kWideRows * (W + 4) + 16 * kMaxStages;
  int stages = (int)((max_smem - fixed) / kStage);
  if (stages > kMaxStages) stages = kMaxStages;
  stages &= ~1;  // as many a consumer warpgroup, at least two
  if (stages < 4) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + stages * kStage;
  // column blocks: as many as fill the SMs beside the row tiles, up to one a
  // head step (two head tiles), each taking an equal run of steps
  const int n_rt = (args.R + kWideRows - 1) / kWideRows;
  const int n_steps = ((args.A + 1 + kHeadSlots - 1) / kHeadSlots + 1) / 2;
  int n_cb = sms / n_rt;
  if (n_cb < 1) n_cb = 1;
  if (n_cb > n_steps) n_cb = n_steps;
  const int per = (n_steps + n_cb - 1) / n_cb;
  n_cb = (n_steps + per - 1) / per;
  Args a = args;
  a.stages = stages;
  a.head_tiles = per;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_wide_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_wide_kernel<W><<<dim3(n_rt, n_cb), kWideThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int launch(const Args& args, int route, cudaStream_t stream) {
  int device = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (route == 1) return launch_narrow<W>(args, stream, sms, max_smem);
  return launch_wide<W>(args, stream, sms, max_smem);
}

}  // namespace

// route: 0 by the obs width (narrow where D <= 4), 1 narrow (D <= 4 only),
// 2 wide
extern "C" int mlp_forward(
    const float* obs, const float* w1, const float* b1, const float* w2img, const float* w2,
    const float* b2, const float* wv, const float* bv, const float* wm,
    const float* bm, const float* ws, const float* bs, float* v_out,
    float* mu_out, float* sigma_out, int R, int D, int W, int A,
    float sigma_scale, float sigma_floor, float sigma_max, int sigma_relative,
    int route, void* stream) {
  if (R <= 0 || D <= 0 || A <= 0 || route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  if (route == 0) route = D <= kSmallD ? 1 : 2;
  if (route == 1 && (D > kSmallD || w2img == nullptr)) return (int)cudaErrorInvalidValue;
  const Args args{obs, w2img, w1, b1, w2, b2, wv, bv, wm, bm, ws, bs, v_out, mu_out, sigma_out,
                  R, D, A, sigma_scale, sigma_floor, sigma_max, sigma_relative, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (W) {
    case 32: return launch<32>(args, route, s);
    case 64: return launch<64>(args, route, s);
    case 96: return launch<96>(args, route, s);
    case 128: return launch<128>(args, route, s);
    case 160: return launch<160>(args, route, s);
    case 192: return launch<192>(args, route, s);
    case 224: return launch<224>(args, route, s);
    case 256: return launch<256>(args, route, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
