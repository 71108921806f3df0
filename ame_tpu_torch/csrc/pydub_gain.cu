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
// What each does:
//   gain_jacobi: one thread per (chain, segment) walks its segment of
//     seg_len samples from its carry-in and writes its carry-out; the full
//     sweep also writes att. m arrives time-major [seg_len, G*S] (the host
//     transposes it once), so a row of 32 lanes is 128 contiguous bytes.
//     The carry refresh, identity bridging, bit-exact acceptance and stall
//     rule stay on the host (ops/pydub_gain.py), one synchronisation per
//     sweep.
//
// What bounds them on an H100:
//   gain_p1 is latency-bound by design (G threads, N dependent steps).
//   gain_p2 and gain_jacobi read m once and write their output once; the
//   walk is a chain of about three dependent f32 operations a step (add or
//   sub, min or max, select), ~25 us for gain_jacobi's 4096 steps, so once
//   the loads stream, bytes bound gain_jacobi: 0.030 ms a carry sweep and
//   0.060 ms a full sweep at [3, 2^23] (3.35 TB/s), and the per-lane
//   chain is the floor under the carry sweep. So every SM needs lanes and
//   the loads must run ahead of the walk: each warp of 32 lanes has its
//   own block (192 blocks at [3, 2^23]) and a ring of
//   STAGES shared-memory stages of [ROWS steps x 32 lanes] (JacRing), filled
//   by 16-byte cp.async copies STAGES-1 stages ahead of the walk, which
//   reads shared memory. The full sweep writes att over m in the stage and
//   stores the stage with 16-byte stores; the carry sweep writes
//   carry_out only. Rows past seg_len are zero-filled: m == 0 leaves the
//   state unchanged, so the walk needs no mask.
//
// gain_p1's 32 loads of the next group are independent of the state, so
// they are issued before the current group's chain runs. It zeroes the
// state at flagged group starts (resets may be null) and writes the state
// before every 32-sample group: starts [G, ceil(N/32)]; the ragged last
// group needs no walk, its start state is all pass 2 reads. gain_p2 runs
// one thread per (chain, 32-sample group) from the pass-1 start state and
// writes att [G, N]; the TPU transposed [512, 32] tiles on the MXU to put
// groups on lanes, here a thread is a group and needs no transpose.

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

#define JAC_LANES 32     // lanes (segments) per block: one warp

// Steps per stage and stages in the ring: the carry sweep walks 64-step
// stages (fewer waits per step), the full sweep, which also stores each
// stage, 32-step ones.
template <bool FULL>
struct JacRing {
  static constexpr int ROWS = FULL ? 32 : 64;
  static constexpr int STAGES = FULL ? 8 : 5;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Stage k of this block: rows t0 = k*JAC_ROWS.. of lanes l0..l0+31, into
// st [JAC_ROWS][JAC_LANES]; out-of-range rows and lanes are zero-filled.
template <int JAC_ROWS>
__device__ __forceinline__ void jac_load(float* st, const float* m_t,
                                         long long t0, long long seg_len,
                                         int l0, int lanes) {
#pragma unroll
  for (int i = 0; i < JAC_ROWS / 4; ++i) {   // 8 chunks of 16 bytes a row
    const int e = threadIdx.x + JAC_LANES * i, r = e >> 3, q = e & 7;
    const long long t = t0 + r;
    const int l = l0 + 4 * q;
    const bool v = t < seg_len && l < lanes;
    cp_async16(st + r * JAC_LANES + 4 * q, v ? m_t + t * lanes + l : m_t, v);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool FULL>
__global__ void __launch_bounds__(JAC_LANES)
    gain_jacobi(const float* __restrict__ m_t,
                const float* __restrict__ carry_in,
                float* __restrict__ carry_out, float* __restrict__ att_t,
                long long seg_len, int lanes, float ia, float ir) {
  constexpr int JAC_ROWS = JacRing<FULL>::ROWS;
  constexpr int JAC_STAGES = JacRing<FULL>::STAGES;
  __shared__ __align__(16) float ring[JAC_STAGES][JAC_ROWS * JAC_LANES];
  const int l0 = blockIdx.x * JAC_LANES, s = l0 + threadIdx.x;
  const long long nst = (seg_len + JAC_ROWS - 1) / JAC_ROWS;
  for (int k = 0; k < JAC_STAGES - 1; ++k) {
    if (k < nst) {
      jac_load<JAC_ROWS>(ring[k], m_t, (long long)k * JAC_ROWS, seg_len,
                         l0, lanes);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  float att = s < lanes ? carry_in[s] : 0.f;
  for (long long k = 0; k < nst; ++k) {
    // stage k has landed once at most JAC_STAGES-2 groups are pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(JAC_STAGES - 2)
                 : "memory");
    __syncthreads();              // all copies seen; stage k-1 is free
    const long long kn = k + JAC_STAGES - 1;
    if (kn < nst) {
      jac_load<JAC_ROWS>(ring[kn % JAC_STAGES], m_t, kn * JAC_ROWS,
                         seg_len, l0, lanes);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    float* st = ring[k % JAC_STAGES];
#pragma unroll
    for (int r = 0; r < JAC_ROWS; ++r) {
      att = gain_update(att, st[r * JAC_LANES + threadIdx.x], ia, ir);
      if (FULL) st[r * JAC_LANES + threadIdx.x] = att;
    }
    if (FULL) {
      __syncthreads();            // the stage holds att
      const long long t0 = k * JAC_ROWS;
#pragma unroll
      for (int i = 0; i < JAC_ROWS / 4; ++i) {
        const int e = threadIdx.x + JAC_LANES * i, r = e >> 3, q = e & 7;
        const int l = l0 + 4 * q;
        if (t0 + r < seg_len && l < lanes)
          *reinterpret_cast<float4*>(att_t + (t0 + r) * lanes + l) =
              *reinterpret_cast<const float4*>(st + r * JAC_LANES + 4 * q);
      }
    }
  }
  if (s < lanes) carry_out[s] = att;
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
// [lanes]; att_t [seg_len, lanes] or null (a carry sweep). The 16-byte
// copies need lanes % 4 == 0 and 16-byte aligned m_t and att_t.
extern "C" int gain_jacobi_f32(const float* m_t, const float* carry_in,
                               float* carry_out, float* att_t,
                               long long seg_len, int lanes, float ia,
                               float ir, void* stream) {
  if (seg_len < 1 || lanes < 1 || lanes % 4 != 0 || (size_t)m_t % 16 != 0 ||
      (size_t)att_t % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((lanes + JAC_LANES - 1) / JAC_LANES);
  cudaStream_t st = (cudaStream_t)stream;
  if (att_t)
    gain_jacobi<true><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir);
  else
    gain_jacobi<false><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir);
  return (int)cudaGetLastError();
}

extern "C" const char* pydub_gain_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
