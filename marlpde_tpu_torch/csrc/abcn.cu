// Fused Burgers ABCN macro-step for a batch of LES environments, for sm_90a.
//
// Replaces the TPU kernel marlpde_tpu/ops/abcn_pallas.py:abcn_macro_step
// (pallas_call at :105, body _kernel at :33-79).  For each env the kernel runs
// all n_intermediate ABCN sub-steps of viscous Burgers (Burger.py:482-489):
//   q = u^2/2;  D = DFT(q);  Fn = i*k*D
//   v <- ((1-C) v - dt/2 (3 Fn - Fn_old) + dt af) / (1+C),  C = k^2 nu dt/2
//   u = Re IDFT(v);  ek += |v|^2/2 / N * dx
// with the action-forcing spectrum af held fixed, and returns the new state,
// the field before the last sub-step (u_prev) and the summed energy spectrum.
//
// What bounds it on the H100: at the flagship shape (B=1024 envs, N=32,
// 10 sub-steps) one call reads 7*B*N*4 + B*4 = 921,600 bytes and writes
// 7*B*N*4 = 917,504 bytes, 0.55 us at 3.35 TB/s; the radix-2 FFTs are about
// 25 MFLOP of float32, 0.37 us at 67 TFLOP/s (the TPU kernel's direct DFT
// would be 84 MFLOP, 1.25 us).  So the least time is the bytes', and what
// limits the kernel is latency: 10 sub-steps, each two transforms and an
// update that depend on one another, with only B*N/32 = 1024 warps to hide
// it; the first design's sub-step waited on 2*N dependent shared-memory sums
// and two block-wide barriers.
//
// Design: the chain of a sub-step is made short.  Lane j of an env's group
// of N lanes holds grid point j; q is transformed by a radix-2 FFT across the
// lanes (decimation in frequency, natural order in, bit-reversed out), so
// lane j then holds wavenumber rev[j] and does the ABCN update there, and
// the inverse (decimation in time, conjugate twiddles) brings u back in
// natural order.  A stage is one exchange with lane j ^ h, h = N/2 .. 1 (the
// inverse h = 1 .. N/2), and a complex multiply by the lane's twiddle.  The
// two h = N/2 stages exchange less: each lane keeps u at lane j ^ N/2 too,
// computed by the inverse's last stage from the values its exchange brings,
// so the forward's first stage exchanges nothing, and the inverse's last
// only the real part.
// For N <= 32 (the main path) an env is one group of N lanes of a warp, 32/N
// envs a warp, one warp a block, and an exchange is two warp shuffles: no
// shared memory and no barrier; a sub-step is 2*log2(N) - 1 shuffle stages
// (9 at N=32).  The spectral fields are loaded in natural order and moved to
// lane rev[j] by a shuffle, so no load waits on another.  For N > 32 an env
// is one block of N threads, the stages with h >= 32 exchange through shared
// memory, double-buffered, one block-wide barrier each, and the fields are
// gathered at rev[j].  N is a template argument, so every stage loop
// unrolls; the host function picks the instantiation.  A ragged last warp
// computes on zeros and masks its loads and stores, so every lane takes part
// in every shuffle.
//
// The twiddles and the bit-reversal map come from the wrapper
// (kernels/abcn.py:radix2_plan, _lane_tables): float32 tables rounded from
// float64 by numpy, read once into registers.  No fast-math intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float *u, *v_re, *v_im, *fn_re, *fn_im, *nu, *af_re, *af_im;
  const float* lanes;  // (2*log2N + 1, N): twiddle cos per stage, sin per stage, k[rev[j]]
  const int* rev;      // (N): the wavenumber lane j holds after the forward transform
  float *u_out, *uprev_out, *vre_out, *vim_out, *fre_out, *fim_out, *ek_out;
  int B, n_intermediate;
  float dt, dx;
};

template <int LOG2N>
__host__ __device__ constexpr int threads_per_block() {
  return (1 << LOG2N) > 32 ? (1 << LOG2N) : 32;
}

// The value (re, im) of lane j ^ h.  h < 32: warp shuffles inside the env's
// group of lanes.  h >= 32: through shared memory, double-buffered, so that
// one barrier an exchange suffices.  REAL_ONLY: only the real part is needed.
template <int THREADS, bool REAL_ONLY>
__device__ __forceinline__ float2 partner(float re, float im, int h, float2* buf, int& parity) {
  if (h < 32) {
    const float pr = __shfl_xor_sync(FULL, re, h);
    const float pi = REAL_ONLY ? 0.f : __shfl_xor_sync(FULL, im, h);
    return make_float2(pr, pi);
  }
  float2* b = buf + parity * THREADS;
  parity ^= 1;
  b[threadIdx.x] = make_float2(re, im);
  __syncthreads();
  return b[threadIdx.x ^ h];
}

// Forward DFT of the real field q across the env's lanes, decimation in
// frequency: natural order in, lane j holds wavenumber rev[j] out.  qh is q
// at lane j ^ N/2, which the caller has, so the first stage exchanges nothing.
template <int LOG2N>
__device__ __forceinline__ float2 forward_fft(float q, float qh, const float* tc,
                                              const float* ts, int j, float2* buf, int& parity) {
  float xr = q, xi = 0.f;
#pragma unroll
  for (int s = 0; s < LOG2N; ++s) {
    const int h = (1 << LOG2N) >> (s + 1);
    const float sg = (j & h) ? -1.f : 1.f;  // upper lane: partner - x; lower: x + partner
    float dr, di;
    if (s == 0) {
      dr = fmaf(sg, xr, qh);
      di = 0.f;
    } else {
      const float2 p = partner<threads_per_block<LOG2N>(), false>(xr, xi, h, buf, parity);
      dr = fmaf(sg, xr, p.x);
      di = fmaf(sg, xi, p.y);
    }
    xr = dr * tc[s] - di * ts[s];
    xi = dr * ts[s] + di * tc[s];
  }
  return make_float2(xr, xi);
}

// Inverse DFT (without the 1/N) of (xr, xi) held in bit-reversed order,
// decimation in time with the conjugate twiddles, natural order out: the real
// part at lane j and at lane j ^ N/2.  The last stage's exchange gives lane j
// both of its inputs, so it computes its partner's output too (the same
// operations on the same values: the same bits), and exchanges only the real
// part.
template <int LOG2N>
__device__ __forceinline__ float2 inverse_fft(float xr, float xi, const float* tc,
                                              const float* ts, int j, float2* buf, int& parity) {
  float xh = xr;
#pragma unroll
  for (int s = LOG2N - 1; s >= 0; --s) {
    const int h = (1 << LOG2N) >> (s + 1);
    const float sg = (j & h) ? -1.f : 1.f;  // upper lane: partner - y; lower: y + partner
    const float yr = xr * tc[s] + xi * ts[s];
    const float yi = xi * tc[s] - xr * ts[s];
    if (s == 0) {
      const float pr = partner<threads_per_block<LOG2N>(), true>(yr, yi, h, buf, parity).x;
      xr = fmaf(sg, yr, pr);
      xh = fmaf(-sg, pr, yr);
    } else {
      const float2 p = partner<threads_per_block<LOG2N>(), false>(yr, yi, h, buf, parity);
      xr = fmaf(sg, yr, p.x);
      xi = fmaf(sg, yi, p.y);
    }
  }
  return make_float2(xr, xh);
}

template <int LOG2N>
__global__ void __launch_bounds__(threads_per_block<LOG2N>())
abcn_macro_step_kernel(const Params p) {
  constexpr int N = 1 << LOG2N;
  constexpr int THREADS = threads_per_block<LOG2N>();
  constexpr int L = LOG2N > 0 ? LOG2N : 1;
  __shared__ float2 buf[N > 32 ? 2 * THREADS : 1];
  int parity = 0;

  const int j = threadIdx.x & (N - 1);
  const long long env = (long long)blockIdx.x * (THREADS / N) + (threadIdx.x >> LOG2N);
  const bool live = env < p.B;
  float tc[L], ts[L];
#pragma unroll
  for (int s = 0; s < LOG2N; ++s) {
    tc[s] = p.lanes[s * N + j];
    ts[s] = p.lanes[(LOG2N + s) * N + j];
  }
  const float k = p.lanes[2 * LOG2N * N + j];
  const int r = p.rev[j];
  const long long at = env * N + j;             // grid point j
  const long long ar = env * N + r;             // wavenumber rev[j]
  // Lane j works on wavenumber rev[j].  For N <= 32 the spectral fields are
  // loaded in natural order, so that no load waits for rev, and lane j takes
  // its values from lane rev[j] by a shuffle; for N > 32 they are gathered.
  const long long al = N <= 32 ? at : ar;
  float u = 0.f, uh = 0.f, v_re = 0.f, v_im = 0.f, fn_re = 0.f, fn_im = 0.f;
  float nu = 0.f, af_re = 0.f, af_im = 0.f;
  if (live) {
    u = p.u[at];
    uh = p.u[env * N + (j ^ (N >> 1))];
    v_re = p.v_re[al];
    v_im = p.v_im[al];
    fn_re = p.fn_re[al];
    fn_im = p.fn_im[al];
    af_re = p.af_re[al];
    af_im = p.af_im[al];
    nu = p.nu[env];
  }
  if constexpr (N <= 32) {
    v_re = __shfl_sync(FULL, v_re, r, N);
    v_im = __shfl_sync(FULL, v_im, r, N);
    fn_re = __shfl_sync(FULL, fn_re, r, N);
    fn_im = __shfl_sync(FULL, fn_im, r, N);
    af_re = __shfl_sync(FULL, af_re, r, N);
    af_im = __shfl_sync(FULL, af_im, r, N);
  }
  const float dt = p.dt;
  const float Cc = 0.5f * (k * k) * nu * dt;
  const float inv = 1.0f / (1.0f + Cc);
  const float half_dt = 0.5f * dt;
  const float fN = (float)N;
  float u_prev = u;
  float ek = 0.f;

  for (int step = 0; step < p.n_intermediate; ++step) {
    u_prev = u;
    const float2 d = forward_fft<LOG2N>(0.5f * u * u, 0.5f * uh * uh, tc, ts, j, buf, parity);
    const float new_fn_re = -k * d.y;
    const float new_fn_im = k * d.x;
    v_re = ((1.0f - Cc) * v_re - half_dt * (3.0f * new_fn_re - fn_re) + dt * af_re) * inv;
    v_im = ((1.0f - Cc) * v_im - half_dt * (3.0f * new_fn_im - fn_im) + dt * af_im) * inv;
    fn_re = new_fn_re;
    fn_im = new_fn_im;
    ek = ek + 0.5f * (v_re * v_re + v_im * v_im) / fN * p.dx;
    const float2 x = inverse_fft<LOG2N>(v_re, v_im, tc, ts, j, buf, parity);
    u = x.x / fN;
    uh = x.y / fN;
  }

  if (live) {
    p.u_out[at] = u;
    p.uprev_out[at] = u_prev;
    p.vre_out[ar] = v_re;
    p.vim_out[ar] = v_im;
    p.fre_out[ar] = fn_re;
    p.fim_out[ar] = fn_im;
    p.ek_out[ar] = ek;
  }
}

template <int LOG2N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int THREADS = threads_per_block<LOG2N>();
  constexpr int ENVS_PER_BLOCK = THREADS >> LOG2N;
  const int blocks = (p.B + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK;
  abcn_macro_step_kernel<LOG2N><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Params&, cudaStream_t);
constexpr Launch kLaunch[] = {launch<0>, launch<1>, launch<2>, launch<3>,
                              launch<4>, launch<5>, launch<6>, launch<7>,
                              launch<8>, launch<9>, launch<10>};

}  // namespace

extern "C" int abcn_macro_step(
    const float* u, const float* v_re, const float* v_im, const float* fn_re,
    const float* fn_im, const float* nu, const float* af_re, const float* af_im,
    const float* lanes, const int* rev, float* u_out, float* uprev_out, float* vre_out,
    float* vim_out, float* fre_out, float* fim_out, float* ek_out,
    int B, int N, int n_intermediate, float dt, float dx, void* stream) {
  if (B <= 0 || N <= 0 || N > 1024 || (N & (N - 1)) != 0 || n_intermediate < 0) {
    return (int)cudaErrorInvalidValue;
  }
  int log2N = 0;
  while ((1 << log2N) < N) ++log2N;
  const Params p{u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im, lanes, rev,
                 u_out, uprev_out, vre_out, vim_out, fre_out, fim_out, ek_out,
                 B, n_intermediate, dt, dx};
  return (int)kLaunch[log2N](p, (cudaStream_t)stream);
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
