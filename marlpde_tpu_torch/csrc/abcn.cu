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
// 10 sub-steps) one call reads 7*B*N + B floats (0.9 MB) and writes 7*B*N
// (0.9 MB); the O(N^2) DFT sums are 4*N^2*10*B = 42M fp32 FMAs.  Both are
// small for the card, so the limit is latency: 20 block-wide barriers per
// call and a chain of 10 dependent sub-steps, over only 128 blocks of 256
// threads.  The simple design keeps the state in registers and touches device
// memory once per macro-step, as the Pallas kernel kept it in VMEM.
//
// Design: thread j of an env owns grid point j and wavenumber j.  An env's
// N threads exchange q and v through shared memory; the DFT is the direct
// O(N^2) sum against one-period cos/sin tables of N entries, indexed by
// (n*j) mod N, in the sign convention of marlpde_tpu/ops/dft.py:23-27
// (angle = -2*pi*n*j/N).  Blocks hold 256/N envs (one env per block for
// N >= 256); a ragged last block is masked.  N is a power of two up to 1024.

#include <cuda_runtime.h>

namespace {

__global__ void abcn_macro_step_kernel(
    const float* __restrict__ u_in, const float* __restrict__ vre_in,
    const float* __restrict__ vim_in, const float* __restrict__ fre_in,
    const float* __restrict__ fim_in, const float* __restrict__ nu_in,
    const float* __restrict__ afre_in, const float* __restrict__ afim_in,
    const float* __restrict__ tables,  // (3, N): cos, sin of -2*pi*m/N; k_m
    float* __restrict__ u_out, float* __restrict__ uprev_out,
    float* __restrict__ vre_out, float* __restrict__ vim_out,
    float* __restrict__ fre_out, float* __restrict__ fim_out,
    float* __restrict__ ek_out,
    int B, int log2N, int n_intermediate, float dt, float dx) {
  extern __shared__ float smem[];
  const int N = 1 << log2N;
  const int mask = N - 1;
  const int envs_per_block = blockDim.x >> log2N;
  const int local_env = threadIdx.x >> log2N;
  const int j = threadIdx.x & mask;

  float* cos_t = smem;
  float* sin_t = smem + N;
  float* q_s = smem + 2 * N + local_env * 3 * N;
  float* vre_s = q_s + N;
  float* vim_s = vre_s + N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    cos_t[i] = tables[i];
    sin_t[i] = tables[N + i];
  }

  const long long env = (long long)blockIdx.x * envs_per_block + local_env;
  const bool live = env < B;
  const long long idx = env * N + j;
  float u = 0.f, v_re = 0.f, v_im = 0.f, fn_re = 0.f, fn_im = 0.f;
  float nu = 0.f, af_re = 0.f, af_im = 0.f;
  if (live) {
    u = u_in[idx];
    v_re = vre_in[idx];
    v_im = vim_in[idx];
    fn_re = fre_in[idx];
    fn_im = fim_in[idx];
    af_re = afre_in[idx];
    af_im = afim_in[idx];
    nu = nu_in[env];
  }
  const float k = tables[2 * N + j];
  const float Cc = 0.5f * (k * k) * nu * dt;
  const float inv = 1.0f / (1.0f + Cc);
  const float half_dt = 0.5f * dt;
  const float fN = (float)N;
  float u_prev = u;
  float ek = 0.f;
  __syncthreads();

  for (int s = 0; s < n_intermediate; ++s) {
    u_prev = u;
    q_s[j] = 0.5f * u * u;
    __syncthreads();
    float d_re = 0.f, d_im = 0.f;
    for (int n = 0; n < N; ++n) {
      const float q = q_s[n];
      const int m = (n * j) & mask;
      d_re = fmaf(q, cos_t[m], d_re);
      d_im = fmaf(q, sin_t[m], d_im);
    }
    const float new_fn_re = -k * d_im;
    const float new_fn_im = k * d_re;
    v_re = ((1.0f - Cc) * v_re - half_dt * (3.0f * new_fn_re - fn_re) + dt * af_re) * inv;
    v_im = ((1.0f - Cc) * v_im - half_dt * (3.0f * new_fn_im - fn_im) + dt * af_im) * inv;
    fn_re = new_fn_re;
    fn_im = new_fn_im;
    vre_s[j] = v_re;
    vim_s[j] = v_im;
    __syncthreads();
    // u = Re IDFT(v) = (sum_n v_re[n] cos + v_im[n] sin) / N
    float acc_c = 0.f, acc_s = 0.f;
    for (int n = 0; n < N; ++n) {
      const int m = (n * j) & mask;
      acc_c = fmaf(vre_s[n], cos_t[m], acc_c);
      acc_s = fmaf(vim_s[n], sin_t[m], acc_s);
    }
    u = (acc_c + acc_s) / fN;
    ek = ek + 0.5f * (v_re * v_re + v_im * v_im) / fN * dx;
  }

  if (live) {
    u_out[idx] = u;
    uprev_out[idx] = u_prev;
    vre_out[idx] = v_re;
    vim_out[idx] = v_im;
    fre_out[idx] = fn_re;
    fim_out[idx] = fn_im;
    ek_out[idx] = ek;
  }
}

}  // namespace

extern "C" int abcn_macro_step(
    const float* u, const float* v_re, const float* v_im, const float* fn_re,
    const float* fn_im, const float* nu, const float* af_re, const float* af_im,
    const float* tables, float* u_out, float* uprev_out, float* vre_out,
    float* vim_out, float* fre_out, float* fim_out, float* ek_out,
    int B, int N, int n_intermediate, float dt, float dx, void* stream) {
  if (B <= 0 || N <= 0 || N > 1024 || (N & (N - 1)) != 0 || n_intermediate < 0) {
    return (int)cudaErrorInvalidValue;
  }
  int log2N = 0;
  while ((1 << log2N) < N) ++log2N;
  const int threads = N >= 256 ? N : 256;
  const int envs_per_block = threads / N;
  const int blocks = (B + envs_per_block - 1) / envs_per_block;
  const size_t smem = (size_t)(2 * N + envs_per_block * 3 * N) * sizeof(float);
  abcn_macro_step_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      u, v_re, v_im, fn_re, fn_im, nu, af_re, af_im, tables, u_out, uprev_out,
      vre_out, vim_out, fre_out, fim_out, ek_out, B, log2N, n_intermediate, dt, dx);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
