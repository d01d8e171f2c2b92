// The experience-mode VRACER loss head for sm_90a: everything between the
// network's (V, mu, sigma) on a minibatch and dL/dV, dL/dmu, dL/dsigma.
//
// Replaces no TPU kernel: the JAX package leaves this algebra to XLA, which
// fuses it into the update's program.  It was written because eager PyTorch
// spells it out as ~260-290 elementwise and reduction kernels an update (two
// clipped-normal joint_log_probs, the importance weights, the V-RACER loss,
// the KL and their autograd backward; rl/vracer.py:update_experience), each
// of 256 to 8192 floats, so an update graph's time went to launch gaps and
// not to bytes or operations.  Two launches take their place:
//
//   vracer_rho     before the metadata refresh: both policies' joint log
//                  densities, the importance weight rho and its off-policy
//                  flag, and the rescaled (team-pooled) rewards;
//   vracer_loss    after the retrace refresh: the loss, its nine metrics and
//                  its gradients in (V, mu, sigma), which the update passes
//                  to autograd as the module outputs' cotangents.
//
// What bounds it on the H100: at run 926's shape (256 rows x 32 actions) the
// two launches read and write about 0.4 MB, 0.12 us at 3.35 TB/s; at run
// 918's (8 x 32 agents x 1 action) 30 KB.  The operations (two log_ndtr and a
// division chain an element and policy) take one SM's instructions a few
// microseconds at most, so the launch floor bounds each kernel.  Design: one
// pass an element per launch, every sum a fixed tree, no atomics on floats.
//
// Numerics.  Each element follows the operations PyTorch runs for the plain
// version (rl/vracer_loss.py: joint_rho, loss_experience) in their order
// and float32 rounding, so that the values agree bit for bit where PyTorch's
// own functions are used: every multiply, divide, add and subtract is its own
// IEEE operation (the __f*_rn intrinsics: nothing fuses into an FMA), logf,
// expf, erfcf and log1pf are libdevice's (no fast math), clamp/minimum pass
// NaN on as torch's do.  torch.special.log_ndtr is taken in its CUDA formula
// with CUDA's erfcxf (PyTorch carries its own erfcx).  The gradients are
// autograd's backward formulas of each forward operation, summed into mu and
// sigma in the order autograd's engine delivers them (highest sequence
// number first: the reverse KL, the forward KL, then log_prob's upper tail,
// lower tail and density); the unselected branches of log_prob's where get a
// zero cotangent, which is multiplied through as in autograd, and
// _LogNdtr's derivative keeps its asymptotic series below -10 (fault F2).
// tests/test_torch_vracer_loss.py:loss_grads_by_hand is this arithmetic in
// torch.
//
// Sums: the act-dim sums (joint_log_prob, the KL), the agent sums
// (multi-agent correlation, cooperation) and the loss's and metrics' sums
// over the agent-rows take the order of torch's CUDA sum over a contiguous
// last axis (ATen's Reduce.cuh; measured on the card for 1 to 8192 rows of 8
// to 1024 entries, torch 2.11), so that they agree with torch's bit for bit:
// see Order.  The act-dim sums run across a group of G = min(width, 32) lanes
// an agent-row, the agent sums in one thread, the sums over the agent-rows a
// warp each in the last block to finish (a ticket the rho kernel zeroes).
// The means of sigma and mu over every entry take a fixed tree inside a block
// and the block order.  Graphs and eager calls and repeated runs give the
// same bits.  Every value that changes between updates (cutoff, 1/cutoff,
// beta, the reward scale) is read through a pointer: a graph replay runs no
// host code.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int ROW_TERMS = 6;  // per agent-row: (V - vtarget)^2, pg_w logp, far kl, far, rho, V
constexpr int NSUM = 2;       // block sums: sigma, mu
constexpr float LOG_SQRT_2PI = 0.9189385332046727f;
constexpr float SQRT1_2 = 0.707106781186547524400844362104849039f;
constexpr float NDTR_LOWER = -10.0f;  // distributions._LOG_NDTR_LOWER[float32]

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ bool is_nan(float v) { return v != v; }
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return is_nan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return is_nan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
// ((a + b) + c) + ...: a sum in the order its terms are given
__device__ __forceinline__ float fold(float a) { return a; }
template <typename... T>
__device__ __forceinline__ float fold(float a, float b, T... rest) {
  return fold(add_rn(a, b), rest...);
}

// torch.special.log_ndtr's CUDA formula (ATen/native/cuda/Math.cuh)
__device__ __forceinline__ float log_ndtr(float x) {
  const float t = mul_rn(x, SQRT1_2);
  if (x < -1.0f) return __fmaf_rn(-t, t, logf(div_rn(erfcxf(-t), 2.0f)));
  return log1pf(div_rn(-erfcf(t), 2.0f));
}

// distributions._log_ndtr_lower: log ndtr(x) by its asymptotic series
__device__ __forceinline__ float log_ndtr_lower(float x) {
  const float x2 = mul_rn(x, x), x4 = mul_rn(x2, x2);
  const float log_scale = sub_rn(sub_rn(mul_rn(x2, -0.5f), logf(-x)), LOG_SQRT_2PI);
  const float odd =
      add_rn(mul_rn(div_rn(1.0f, x2), 1.0f), mul_rn(div_rn(1.0f, mul_rn(x4, x2)), 15.0f));
  const float even = mul_rn(div_rn(1.0f, x4), 3.0f);
  return add_rn(log_scale, logf(sub_rn(add_rn(even, 1.0f), odd)));
}

// d log_ndtr(x) / dx as distributions._LogNdtr.backward forms it
__device__ __forceinline__ float ndtr_ratio(float x) {
  const float ans = x > NDTR_LOWER ? log_ndtr(x) : log_ndtr_lower(clamp_max(x, NDTR_LOWER));
  return expf(sub_rn(sub_rn(mul_rn(mul_rn(x, x), -0.5f), LOG_SQRT_2PI), ans));
}

// distributions.log_prob: the clipped normal's log density or boundary mass
__device__ __forceinline__ float log_prob(float a, float m, float s, float lb, float ub) {
  const float z = div_rn(sub_rn(a, m), s);
  const float pdf = sub_rn(sub_rn(mul_rn(mul_rn(z, -0.5f), z), logf(s)), LOG_SQRT_2PI);
  const float lo = log_ndtr(div_rn(sub_rn(lb, m), s));
  const float hi = log_ndtr(-div_rn(sub_rn(ub, m), s));
  return a <= lb ? lo : (a >= ub ? hi : pdf);
}

// the sum over a group of G lanes, halving (offsets G/2 .. 1): every lane
// gets the sum lane 0 gets from torch's tree
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v = add_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// torch's order for the sum of a row of m float32 entries (the row index r
// of a contiguous (rows, m) tensor whose base is 16-byte aligned): `width`
// lanes v (a power of two, rl/vracer_loss.py:reduce_order) each sum into four
// partial sums, from 0:
//   m < 128 (vec 0): the entries v, v + width, ...: entry v + i width of
//     each run of four into partial sum i;
//   m >= 128 (vec 1): the row's 16-byte units v, v + width, ...: entry i of
//     a unit into partial sum i.  A row that starts `shift` entries into a
//     unit first gives its entries 0 .. 3 - shift to lanes shift .. 3, and
//     the entries after its last whole unit to lanes 0, 1, ...;
// then the partial sums in order, then a halving tree over the lanes (at
// most 512; those past a warp halved first, each lane's own).
struct Order {
  int m, vec, width;
};

struct Sum2 {  // two sums at once: both policies' log densities, or both KLs
  float a, b;
};
__device__ __forceinline__ Sum2 add2(Sum2 x, Sum2 y) {
  return {add_rn(x.a, y.a), add_rn(x.b, y.b)};
}

// lane v's part of row r's sum of f(k) over the entries k; f also does each
// entry's other work, once
template <typename F>
__device__ __forceinline__ Sum2 lane_part(const Order o, long long r, int v, F& f) {
  Sum2 acc[4] = {};
  const int W = o.width;
  if (!o.vec) {
    int k = v;
    for (; k + 3 * W < o.m; k += 4 * W) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add2(acc[i], f(k + i * W));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i, k += W) {
      if (k < o.m) acc[i] = add2(acc[i], f(k));
    }
  } else {
    const int shift = (int)((r * o.m) % 4);
    const int head = shift ? 4 - shift : 0;
    if (shift && v >= shift && v < 4) acc[0] = add2(acc[0], f(v - shift));
    const int n = o.m - head;
    int u = v;
    for (; 4 * u + 3 < n; u += W) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add2(acc[i], f(head + 4 * u + i));
    }
    const int t = n - n % 4 + v;
    if (t < n) acc[0] = add2(acc[0], f(head + t));
  }
  return add2(add2(add2(acc[0], acc[1]), acc[2]), acc[3]);
}

// lane l's part of the sum when the width is G lanes or more: its lanes
// l + G j, j < width / G, summed as the halving tree over them (a tree whose
// leaves, in bit-reversed order of j, merge as they come)
template <typename F>
__device__ __forceinline__ Sum2 group_part(const Order o, long long r, int G, int l, F& f) {
  const int J = o.width / G, bits = 31 - __clz(J);
  Sum2 stack[5];  // J <= 512 / 32: a stack of log2(J) + 1
  int depth = 0;
  for (int q = 0; q < J; ++q) {
    const int j = bits ? (int)(__brev(q) >> (32 - bits)) : 0;
    Sum2 x = lane_part(o, r, l + G * j, f);
    for (int t = q; t & 1; t >>= 1) x = add2(stack[--depth], x);
    stack[depth++] = x;
  }
  return stack[0];
}

// the sum of v[0..o.m), row r, in one thread
__device__ float torch_sum(const float* v, const Order o, long long r) {
  const int G = min(o.width, 32);
  auto f = [v](int k) { return Sum2{v[k], 0.0f}; };
  float part[32];
  for (int l = 0; l < G; ++l) part[l] = group_part(o, r, G, l, f).a;
  for (int off = G / 2; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) part[l] = add_rn(part[l], part[l + off]);
  return part[0];
}

struct RhoParams {
  const float *a, *mu, *sigma, *mu_b, *sigma_b, *rewards, *scale, *cutoff, *inv_cutoff;
  float *rho, *logp, *rew;
  unsigned char* off;
  int* ticket;
  int n, na, A, rows_per_block, passes, mac, coop;
  Order act, agents;  // the sums over a row's actions and over an agent-row's agents
  float lb, ub, temper, reward_floor, scaled_floor, coop_factor;
};

// A block takes rows_per_block whole rows (all na agents), so the agent sums
// stay inside it: first each agent-row's joint log densities (a group of G
// lanes an agent-row, passes over the block's agent-rows), into shared memory,
// then each agent-row's rho, flag and reward.
template <int G>
__global__ void __launch_bounds__(THREADS) vracer_rho_kernel(const RhoParams p) {
  extern __shared__ float smem[];
  float* log_ratio = smem;
  float* reward = smem + p.rows_per_block * p.na;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nar = min(p.rows_per_block, p.n - row0) * p.na;
  const long long ar0 = (long long)row0 * p.na;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.ticket = 0;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int ar = pass * (THREADS / G) + group;
    const bool live = ar < nar;
    Sum2 lp = {0.0f, 0.0f};
    if (live) {
      const long long row = ar0 + ar;
      auto f = [&](int k) {
        const long long e = row * p.A + k;
        const float a = p.a[e];
        return Sum2{log_prob(a, p.mu[e], p.sigma[e], p.lb, p.ub),
                    log_prob(a, p.mu_b[e], p.sigma_b[e], p.lb, p.ub)};
      };
      lp = group_part(p.act, row, G, lane, f);
    }
    const float cur = group_sum<G>(lp.a);
    const float beh = group_sum<G>(lp.b);
    if (live && lane == 0) {
      p.logp[ar0 + ar] = cur;
      log_ratio[ar] = sub_rn(cur, beh);
      reward[ar] = clamp_min(div_rn(clamp_min(p.rewards[ar0 + ar], p.reward_floor), *p.scale),
                             p.scaled_floor);
    }
  }
  __syncthreads();
  const float c = *p.cutoff, ic = *p.inv_cutoff;
  for (int ar = threadIdx.x; ar < nar; ar += THREADS) {
    const int first = ar - ar % p.na;  // the row's first agent
    const long long row = (ar0 + ar) / p.na;
    const float x = p.mac ? torch_sum(log_ratio + first, p.agents, row) : log_ratio[ar];
    const float rho = expf(clamp(mul_rn(x, p.temper), -20.0f, 20.0f));
    p.rho[ar0 + ar] = rho;
    p.off[ar0 + ar] = !(rho > ic && rho < c);
    p.rew[ar0 + ar] =
        p.coop ? mul_rn(torch_sum(reward + first, p.agents, row), p.coop_factor) : reward[ar];
  }
}

struct LossParams {
  const float *V, *mu, *sigma, *a, *mu_b, *sigma_b, *rho, *logp, *rew, *vtg_next, *cutoff, *beta;
  float *gV, *gmu, *gsig, *row_terms, *partials, *metrics;
  int* ticket;
  int nr, A;
  Order act, rows;  // the sums over a row's actions, and over the agent-rows
  float lb, ub, gamma, value_coef, inv_n, row_factor, elem_factor;
};

struct Element {
  float kl_fwd, kl_rev, gmu, gsig;
};

// One element's KL terms and its dL/dmu, dL/dsigma: gp is the cotangent of
// the agent-row's log density, gk that of each of its KL terms.
template <bool JEFFREYS>
__device__ __forceinline__ Element element(float a, float m, float s, float mb, float sb,
                                           float gp, float gk, float lb, float ub) {
  // log_prob's where: the cotangent to each branch
  const bool lo = a <= lb, hi = a >= ub;
  const float g_cdf = lo ? gp : 0.0f, g_in = lo ? 0.0f : gp;
  const float g_sf = hi ? g_in : 0.0f, g_pdf = hi ? 0.0f : g_in;
  // the density: -0.5 z z - log(sigma) - C, z = (a - mu) / sigma
  const float z = div_rn(sub_rn(a, m), s);
  const float sig_log = div_rn(-g_pdf, s);
  const float gz = add_rn(mul_rn(g_pdf, mul_rn(z, -0.5f)), mul_rn(mul_rn(g_pdf, z), -0.5f));
  const float sig_pdf = mul_rn(-gz, div_rn(z, s));
  const float mu_pdf = -div_rn(gz, s);
  // the lower tail: log_ndtr((lb - mu) / sigma)
  const float xl = div_rn(sub_rn(lb, m), s);
  const float gxl = mul_rn(g_cdf, ndtr_ratio(xl));
  const float sig_lo = mul_rn(-gxl, div_rn(xl, s));
  const float mu_lo = -div_rn(gxl, s);
  // the upper tail: log_ndtr(-((ub - mu) / sigma))
  const float vh = div_rn(sub_rn(ub, m), s);
  const float gvh = -mul_rn(g_sf, ndtr_ratio(-vh));
  const float sig_hi = mul_rn(-gvh, div_rn(vh, s));
  const float mu_hi = -div_rn(gvh, s);
  // kl_normal(mu_b, sigma_b, mu, sigma):
  //   log(sigma / sigma_b) + (sigma_b^2 + (mu - mu_b)^2) / (2 sigma^2) - 1/2
  const float ratio = div_rn(s, sb);
  const float dm = sub_rn(m, mb);
  const float num = add_rn(mul_rn(sb, sb), mul_rn(dm, dm));
  const float den = mul_rn(mul_rn(s, s), 2.0f);
  const float fr = div_rn(num, den);
  Element out;
  out.kl_fwd = sub_rn(add_rn(logf(ratio), fr), 0.5f);
  const float sig_kl = div_rn(div_rn(gk, ratio), sb);
  const float g_num = div_rn(gk, den);
  const float mu_kl = mul_rn(g_num, mul_rn(dm, 2.0f));
  const float sig_var = mul_rn(mul_rn(mul_rn(-gk, div_rn(fr, den)), 2.0f), s);  // twice: s * s
  if (JEFFREYS) {
    // kl_normal(mu, sigma, mu_b, sigma_b)
    const float ratio_r = div_rn(sb, s);
    const float dm_r = sub_rn(mb, m);
    const float num_r = add_rn(mul_rn(s, s), mul_rn(dm_r, dm_r));
    const float den_r = mul_rn(mul_rn(sb, sb), 2.0f);
    out.kl_rev = sub_rn(add_rn(logf(ratio_r), div_rn(num_r, den_r)), 0.5f);
    const float sig_klr = mul_rn(-div_rn(gk, ratio_r), div_rn(ratio_r, s));
    const float g_num_r = div_rn(gk, den_r);
    const float mu_klr = -mul_rn(g_num_r, mul_rn(dm_r, 2.0f));
    const float sig_var_r = mul_rn(g_num_r, s);  // twice: s * s
    out.gmu = fold(mu_klr, mu_kl, mu_hi, mu_lo, mu_pdf);
    out.gsig = fold(sig_klr, sig_var_r, sig_var_r, sig_kl, sig_var, sig_var, sig_hi, sig_lo,
                    sig_log, sig_pdf);
  } else {
    out.kl_rev = 0.0f;
    out.gmu = fold(mu_kl, mu_hi, mu_lo, mu_pdf);
    out.gsig = fold(sig_kl, sig_var, sig_var, sig_hi, sig_lo, sig_log, sig_pdf);
  }
  return out;
}

// A group of G lanes an agent-row (r = i * na + j), one pass: per element the
// gradients and the KL; per agent-row dL/dV and the terms of the sums over
// rows; per block the sums of sigma and mu.  The last block to finish sums
// each row term in torch's order over the agent-rows (a warp each), and the
// blocks' sums in block order.
template <int G, bool JEFFREYS>
__global__ void __launch_bounds__(THREADS) vracer_loss_kernel(const LossParams p) {
  __shared__ float warp_sums[THREADS / 32][NSUM];
  __shared__ float totals[ROW_TERMS + NSUM];
  __shared__ bool last;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int r = blockIdx.x * (THREADS / G) + group;
  const bool live = r < p.nr;
  const float c = *p.cutoff, ic = div_rn(1.0f, c), beta = *p.beta;
  // the cotangents autograd derives from the loss's cotangent of 1:
  // loss = value_coef * (0.5 sum d^2) / n + beta * -(sum pg_w logp) / n
  //        + (1 - beta) * (sum far kl) / n, a division by n being a product
  // with its reciprocal on the card
  const float g_v = mul_rn(mul_rn(mul_rn(1.0f, p.value_coef), p.inv_n), 0.5f);
  const float g_pg = -mul_rn(mul_rn(1.0f, beta), p.inv_n);
  const float g_kl = mul_rn(mul_rn(1.0f, sub_rn(1.0f, beta)), p.inv_n);
  float sum_sigma = 0.0f, sum_mu = 0.0f;
  float kl_fwd = 0.0f, kl_rev = 0.0f, farf = 0.0f;
  if (live) {
    const float rho = p.rho[r];
    const bool near = rho > ic && rho < c;
    farf = near ? 0.0f : 1.0f;
    const float V = p.V[r];
    const float td = sub_rn(add_rn(p.rew[r], mul_rn(p.vtg_next[r], p.gamma)), V);
    const float d = sub_rn(V, add_rn(V, mul_rn(clamp_max(rho, 1.0f), td)));
    const float pg_w = mul_rn(mul_rn(minimum(rho, c), td), near ? 1.0f : 0.0f);
    if (lane == 0) {
      p.gV[r] = mul_rn(g_v, mul_rn(d, 2.0f));
      p.row_terms[r] = mul_rn(d, d);
      p.row_terms[p.nr + r] = mul_rn(pg_w, p.logp[r]);
      p.row_terms[3 * p.nr + r] = farf;
      p.row_terms[4 * p.nr + r] = rho;
      p.row_terms[5 * p.nr + r] = V;
    }
    const float gp = mul_rn(g_pg, pg_w);
    const float gk = JEFFREYS ? mul_rn(mul_rn(g_kl, farf), 0.5f) : mul_rn(g_kl, farf);
    auto f = [&](int k) {
      const long long e = (long long)r * p.A + k;
      const float m = p.mu[e], sg = p.sigma[e];
      const Element el = element<JEFFREYS>(p.a[e], m, sg, p.mu_b[e], p.sigma_b[e], gp, gk,
                                           p.lb, p.ub);
      p.gmu[e] = el.gmu;
      p.gsig[e] = el.gsig;
      sum_sigma = add_rn(sum_sigma, sg);
      sum_mu = add_rn(sum_mu, m);
      return Sum2{el.kl_fwd, el.kl_rev};
    };
    const Sum2 kl = group_part(p.act, r, G, lane, f);
    kl_fwd = kl.a;
    kl_rev = kl.b;
  }
  kl_fwd = group_sum<G>(kl_fwd);
  if (JEFFREYS) kl_rev = group_sum<G>(kl_rev);
  if (live && lane == 0) {
    p.row_terms[2 * p.nr + r] =
        mul_rn(farf, JEFFREYS ? mul_rn(add_rn(kl_fwd, kl_rev), 0.5f) : kl_fwd);
  }

  const float s[NSUM] = {sum_sigma, sum_mu};
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    const float v = group_sum<32>(s[q]);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float v = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) v = add_rn(v, warp_sums[w][threadIdx.x]);
    p.partials[blockIdx.x * NSUM + threadIdx.x] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  if (warp < ROW_TERMS) {
    const float* terms = p.row_terms + (long long)warp * p.nr;
    auto f = [terms](int k) { return Sum2{__ldcg(terms + k), 0.0f}; };
    const int lanes = min(p.rows.width, 32);
    // lanes past the order's width add zeros, which leave the tree's sum as it is
    const float v = group_sum<32>(l < lanes ? group_part(p.rows, 0, lanes, l, f).a : 0.0f);
    if (l == 0) totals[warp] = v;
  } else if (warp == ROW_TERMS && l < NSUM) {
    float v = 0.0f;
    for (int b = 0; b < (int)gridDim.x; ++b) v = add_rn(v, __ldcg(p.partials + b * NSUM + l));
    totals[ROW_TERMS + l] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* t = totals;
    const float v_loss = mul_rn(mul_rn(t[0], 0.5f), p.inv_n);
    const float pg_loss = mul_rn(-t[1], p.inv_n);
    const float kl_loss = mul_rn(t[2], p.inv_n);
    const float loss = add_rn(add_rn(mul_rn(v_loss, p.value_coef), mul_rn(beta, pg_loss)),
                           mul_rn(sub_rn(1.0f, beta), kl_loss));
    // rl/vracer.py's metric keys: loss, v_loss, pg_loss, kl_loss, frac_far,
    // mean_rho, mean_sigma, mean_mu, mean_V
    const float m[9] = {loss, v_loss, pg_loss, kl_loss, mul_rn(t[3], p.row_factor),
                        mul_rn(t[4], p.row_factor), mul_rn(t[6], p.elem_factor),
                        mul_rn(t[7], p.elem_factor), mul_rn(t[5], p.row_factor)};
    for (int q = 0; q < 9; ++q) p.metrics[q] = m[q];
    *p.ticket = 0;
  }
}

template <int G>
cudaError_t launch_rho(const RhoParams& p, int blocks, size_t smem, cudaStream_t stream) {
  vracer_rho_kernel<G><<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int G, bool JEFFREYS>
cudaError_t launch_loss(const LossParams& p, int blocks, cudaStream_t stream) {
  vracer_loss_kernel<G, JEFFREYS><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

int log2_lanes(int lanes) {
  switch (lanes) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    case 16: return 4;
    case 32: return 5;
    default: return -1;
  }
}

// an order's width: a power of two, a multiple of the group's lanes, at most
// ATen's 512
bool valid_order(int width, int lanes) {
  return width >= lanes && width <= 512 && (width & (width - 1)) == 0 && width % lanes == 0;
}

using RhoLaunch = cudaError_t (*)(const RhoParams&, int, size_t, cudaStream_t);
constexpr RhoLaunch kRho[] = {launch_rho<1>, launch_rho<2>, launch_rho<4>,
                              launch_rho<8>, launch_rho<16>, launch_rho<32>};
using LossLaunch = cudaError_t (*)(const LossParams&, int, cudaStream_t);
constexpr LossLaunch kLoss[2][6] = {
    {launch_loss<1, false>, launch_loss<2, false>, launch_loss<4, false>,
     launch_loss<8, false>, launch_loss<16, false>, launch_loss<32, false>},
    {launch_loss<1, true>, launch_loss<2, true>, launch_loss<4, true>,
     launch_loss<8, true>, launch_loss<16, true>, launch_loss<32, true>}};

}  // namespace

extern "C" int vracer_rho(
    const float* a, const float* mu, const float* sigma, const float* mu_b, const float* sigma_b,
    const float* rewards, const float* scale, const float* cutoff, const float* inv_cutoff,
    float* rho, unsigned char* off, float* logp, float* rew, int* ticket,
    int n, int na, int A, int lanes, int rows_per_block, int passes, int mac, int coop,
    int act_vec, int act_width, int agent_vec, int agent_width, float lb, float ub,
    float temper, float reward_floor, float scaled_floor, float coop_factor, void* stream) {
  const int lg = log2_lanes(lanes);
  if (n <= 0 || na <= 0 || A <= 0 || lg < 0 || rows_per_block <= 0 || passes <= 0 ||
      !valid_order(act_width, lanes) || !valid_order(agent_width, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const RhoParams p{a, mu, sigma, mu_b, sigma_b, rewards, scale, cutoff, inv_cutoff,
                    rho, logp, rew, off, ticket, n, na, A, rows_per_block, passes, mac, coop,
                    Order{A, act_vec, act_width}, Order{na, agent_vec, agent_width},
                    lb, ub, temper, reward_floor, scaled_floor, coop_factor};
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * sizeof(float) * (size_t)rows_per_block * na;
  return (int)kRho[lg](p, blocks, smem, (cudaStream_t)stream);
}

extern "C" int vracer_loss(
    const float* V, const float* mu, const float* sigma, const float* a, const float* mu_b,
    const float* sigma_b, const float* rho, const float* logp, const float* rew,
    const float* vtg_next, const float* cutoff, const float* beta, float* gV, float* gmu,
    float* gsig, float* row_terms, float* partials, float* metrics, int* ticket,
    int nr, int A, int lanes, int blocks, int jeffreys, int act_vec, int act_width, int rows_vec,
    int rows_width, float lb, float ub, float gamma, float value_coef, float inv_n,
    float row_factor, float elem_factor, void* stream) {
  const int lg = log2_lanes(lanes);
  if (nr <= 0 || A <= 0 || lg < 0 || blocks != (nr + THREADS / lanes - 1) / (THREADS / lanes) ||
      !valid_order(act_width, lanes) || !valid_order(rows_width, 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const LossParams p{V, mu, sigma, a, mu_b, sigma_b, rho, logp, rew, vtg_next, cutoff, beta,
                     gV, gmu, gsig, row_terms, partials, metrics, ticket, nr, A,
                     Order{A, act_vec, act_width}, Order{nr, rows_vec, rows_width},
                     lb, ub, gamma, value_coef, inv_n, row_factor, elem_factor};
  return (int)kLoss[jeffreys ? 1 : 0][lg](p, blocks, (cudaStream_t)stream);
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
