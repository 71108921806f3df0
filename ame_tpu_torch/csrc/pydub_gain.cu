// Exact pydub attenuation recurrence: the three gain kernels of the compat
// compressor.
//
// Replaces the Pallas kernels of ame_tpu/ops/pydub_gain.py:
//   gain_p1      <- _p1_kernel  (pass 1, sequential walk, via _p1)
//   gain_p2      <- _p2_kernel  (pass 2, group re-run, via _p2)
//   gain_jacobi  <- _jac_kernel (Jacobi carry sweep, via _jac_call)
//
// The recurrence, per chain g and sample t, with m the detector's
// max-attenuation (m == 0 freezes the state exactly):
//
//   att' = att <= m ? min(att + m*ia, m) : max(att - m*ir, 0)
//
// Rounding is pinned: the products and sums are __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc cannot contract them into FMAs. The three kernels and
// the plain PyTorch walk therefore evaluate the identical f32 operations,
// and agree bit for bit; the Jacobi acceptance test (carries reproduced
// bit for bit) means what it means for the sequential walk.
//
// What bounds them, and what the design does about it:
//   gain_p1: one thread per chain walks the whole track in order — G
//     threads, N dependent steps each. It is latency-bound by design (the
//     fallback path); the 32 loads of the next group are independent of the
//     state, so they are issued before the current group's chain runs. It
//     zeroes the state at flagged group starts (resets may be null) and
//     writes the state before every 32-sample group: starts [G, ceil(N/32)].
//     The ragged last group needs no walk: its start state is all pass 2
//     reads.
//   gain_p2: one thread per (chain, 32-sample group) re-runs its group from
//     the pass-1 start state and writes att [G, N]. The TPU transposed
//     [512, 32] tiles on the MXU to put groups on lanes; here a thread is a
//     group and needs no transpose.
//   gain_jacobi: one thread per (chain, segment) walks its segment of
//     seg_len samples from its carry-in and writes its carry-out; the full
//     sweep also writes att. m arrives time-major [seg_len, G*S] (the host
//     transposes it once), so neighbouring threads read neighbouring
//     addresses at every step and the loads coalesce. The carry refresh,
//     identity bridging, bit-exact acceptance and stall rule stay on the
//     host (ops/pydub_gain.py), one synchronisation per sweep.
//
// Bytes are not the limit at these sizes: each kernel reads m once and
// writes its output once, but the walk is a chain of 5 dependent f32 ops
// per sample per thread. Shared-memory staging of m for gain_p1/gain_p2 and
// more segments per chain are left for later work.

#include <cuda_runtime.h>

#define GROUP 32

__device__ __forceinline__ float gain_update(float att, float m, float ia,
                                             float ir) {
  const float up = fminf(__fadd_rn(att, __fmul_rn(m, ia)), m);
  const float dn = fmaxf(__fsub_rn(att, __fmul_rn(m, ir)), 0.f);
  return att <= m ? up : dn;
}

__global__ void gain_p1(const float* __restrict__ m,
                        const float* __restrict__ resets,
                        const float* __restrict__ init,
                        float* __restrict__ starts, long long n, int G,
                        float ia, float ir) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const float* mg = m + (long long)g * n;
  const long long ng = (n + GROUP - 1) / GROUP;
  float* sg = starts + (long long)g * ng;
  const long long nfull = n / GROUP;  // groups of a full 32 samples
  float att = init[g];
  float v[GROUP];
  if (nfull > 0) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) v[j] = mg[j];
  }
  for (long long k = 0; k < nfull; ++k) {
    // the next group's loads go out before this group's chain runs
    float w[GROUP];
    const long long t1 = (k + 1 < nfull) ? (k + 1) * GROUP : k * GROUP;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) w[j] = mg[t1 + j];
    if (resets != nullptr && resets[k] != 0.f) att = 0.f;
    sg[k] = att;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) att = gain_update(att, v[j], ia, ir);
#pragma unroll
    for (int j = 0; j < GROUP; ++j) v[j] = w[j];
  }
  if (nfull < ng) {  // the ragged last group
    if (resets != nullptr && resets[nfull] != 0.f) att = 0.f;
    sg[nfull] = att;
  }
}

__global__ void gain_p2(const float* __restrict__ m,
                        const float* __restrict__ starts,
                        float* __restrict__ att_out, long long n, int G,
                        float ia, float ir) {
  const long long ng = (n + GROUP - 1) / GROUP;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (tid >= ng * G) return;
  const long long g = tid / ng, k = tid % ng;
  const float* mg = m + g * n;
  float* og = att_out + g * n;
  float att = starts[g * ng + k];
  const long long t0 = k * GROUP;
  if (t0 + GROUP <= n) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      att = gain_update(att, mg[t0 + j], ia, ir);
      og[t0 + j] = att;
    }
  } else {
    for (long long t = t0; t < n; ++t) {
      att = gain_update(att, mg[t], ia, ir);
      og[t] = att;
    }
  }
}

__global__ void gain_jacobi(const float* __restrict__ m_t,
                            const float* __restrict__ carry_in,
                            float* __restrict__ carry_out,
                            float* __restrict__ att_t, long long seg_len,
                            int lanes, float ia, float ir) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= lanes) return;
  float att = carry_in[s];
  // unrolled so that the loads of several steps, which do not depend on
  // the state, are in flight together
  if (att_t != nullptr) {
#pragma unroll 16
    for (long long t = 0; t < seg_len; ++t) {
      att = gain_update(att, m_t[t * lanes + s], ia, ir);
      att_t[t * lanes + s] = att;
    }
  } else {
#pragma unroll 16
    for (long long t = 0; t < seg_len; ++t)
      att = gain_update(att, m_t[t * lanes + s], ia, ir);
  }
  carry_out[s] = att;
}

// m [G, n] chain-major; resets [ceil(n/32)] or null; init [G];
// starts [G, ceil(n/32)].
extern "C" int gain_p1_f32(const float* m, const float* resets,
                           const float* init, float* starts, long long n,
                           int G, float ia, float ir, void* stream) {
  if (n < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  gain_p1<<<(G + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      m, resets, init, starts, n, G, ia, ir);
  return (int)cudaGetLastError();
}

// m [G, n]; starts [G, ceil(n/32)]; att [G, n].
extern "C" int gain_p2_f32(const float* m, const float* starts, float* att,
                           long long n, int G, float ia, float ir,
                           void* stream) {
  if (n < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long total = ((n + GROUP - 1) / GROUP) * G;
  gain_p2<<<(unsigned)((total + threads - 1) / threads), threads, 0,
            (cudaStream_t)stream>>>(m, starts, att, n, G, ia, ir);
  return (int)cudaGetLastError();
}

// m_t [seg_len, lanes] time-major (lane = g*S + s); carry_in, carry_out
// [lanes]; att_t [seg_len, lanes] or null (a carry sweep).
extern "C" int gain_jacobi_f32(const float* m_t, const float* carry_in,
                               float* carry_out, float* att_t,
                               long long seg_len, int lanes, float ia,
                               float ir, void* stream) {
  if (seg_len < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  gain_jacobi<<<(lanes + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(m_t, carry_in, carry_out, att_t,
                                        seg_len, lanes, ia, ir);
  return (int)cudaGetLastError();
}

extern "C" const char* pydub_gain_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
