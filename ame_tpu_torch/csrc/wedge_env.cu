// alimiter wedge envelope: one direction of the ffmpeg-contract limiter's
// gain-depth envelope as a three-phase (max, x) block scan.
//
// Replaces the Pallas kernel ame_tpu/ops/limiter.py::_wedge_env_kernel
// (driven by _wedge_env). For the P = 6 tangent pieces (a_p, rho_p) of
// limiter.py::_wedge_pieces it computes
//
//   s_p[i] = max(dep[i], rho_p * s_p[i-1]),   s_p[-1] = 0
//   env[i] = min_p a_p * s_p[i]
//
// in processing order i; with reverse = 1 the processing order runs from the
// last sample to the first (n = N-1-i), which is the anticipatory (attack)
// side. On the TPU the kernel walks [128, 512] tiles in order on one core
// and carries each piece's state in SMEM. On the card blocks run in parallel
// and in no order, so the carry is its own phase, as in cascade_scan.cu:
//
//   1. block_ends: one thread per block of tb samples runs all P pieces
//      from zero state and writes each piece's end value e[p, b];
//   2. block_carries: one thread per piece walks the blocks,
//      c[p, b+1] = max(e[p, b], rho_p^tb * c[p, b]), with rho_p^tb computed
//      on the host in float64 from the f32 rho_p the other phases use;
//   3. block_env: one thread per block re-runs all P pieces from its carries
//      and writes env = min_p a_p * s_p (dep is read once per pass, env
//      written once).
//
// (max, x) with rho > 0 is exact to re-associate up to the rounding of the
// decay powers, so the result equals the sequential walk to within a few
// f32 ulps of each decayed term.
//
// What bounds it: a dependence chain of one multiply and one max per piece
// per sample in each thread (P = 6 chains interleave), not bytes: dep is
// read twice and env written once, 12 bytes a sample. With tb = 1024 a
// 2^23-sample track gives 8192 threads. Coalesced shared-memory staging of
// dep and a parallel carry phase are left for later work. FMA contraction
// does not arise (no a*b+c form); the f32 products are the plain version's.
//
// Layouts: dep, env [n]; scratch e, carry [P, nb] (piece-major).

#include <cuda_runtime.h>

#define PIECES 6

struct Pieces {
  float a[PIECES];
  float rho[PIECES];
  float rho_tb[PIECES];
};

__device__ __forceinline__ long long pos(long long i, long long n,
                                         int reverse) {
  return reverse ? n - 1 - i : i;
}

__global__ void block_ends(const float* __restrict__ dep,
                           float* __restrict__ e, long long n, int tb,
                           long long nb_end, int reverse,
                           const __grid_constant__ Pieces pc) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb_end) return;
  float s[PIECES];
#pragma unroll
  for (int p = 0; p < PIECES; ++p) s[p] = 0.f;
  const long long i0 = b * tb, i1 = i0 + tb;  // never the ragged last block
  for (long long i = i0; i < i1; ++i) {
    const float d = dep[pos(i, n, reverse)];
#pragma unroll
    for (int p = 0; p < PIECES; ++p) s[p] = fmaxf(d, pc.rho[p] * s[p]);
  }
#pragma unroll
  for (int p = 0; p < PIECES; ++p) e[p * nb_end + b] = s[p];
}

__global__ void block_carries(const float* __restrict__ e,
                              float* __restrict__ carry, long long nb,
                              const __grid_constant__ Pieces pc) {
  const int p = threadIdx.x;
  if (p >= PIECES) return;
  const long long nb_end = nb - 1;
  const float r = pc.rho_tb[p];
  float c = 0.f;
  carry[p * nb] = 0.f;
#pragma unroll 8
  for (long long b = 0; b < nb_end; ++b) {
    c = fmaxf(e[p * nb_end + b], r * c);
    carry[p * nb + b + 1] = c;
  }
}

__global__ void block_env(const float* __restrict__ dep,
                          const float* __restrict__ carry,
                          float* __restrict__ env, long long n, int tb,
                          long long nb, int reverse,
                          const __grid_constant__ Pieces pc) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float s[PIECES];
#pragma unroll
  for (int p = 0; p < PIECES; ++p) s[p] = carry[p * nb + b];
  const long long i0 = b * tb;
  const long long i1 = (i0 + tb < n) ? i0 + tb : n;  // ragged last block
  for (long long i = i0; i < i1; ++i) {
    const long long k = pos(i, n, reverse);
    const float d = dep[k];
    float m = 0.f;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      s[p] = fmaxf(d, pc.rho[p] * s[p]);
      const float v = pc.a[p] * s[p];
      m = (p == 0) ? v : fminf(m, v);
    }
    env[k] = m;
  }
}

// host_params (float32): a[P], rho[P], rho^tb[P]. e holds at least
// P * max(nb - 1, 1) floats, carry P * nb. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for
// unsupported sizes.
extern "C" int wedge_env_f32(const float* dep, float* env, float* e,
                             float* carry, long long n, int tb, int np,
                             int reverse, const float* host_params,
                             void* stream) {
  if (np != PIECES || n < 1 || tb < 1) return (int)cudaErrorInvalidValue;
  Pieces pc;
  for (int p = 0; p < PIECES; ++p) {
    pc.a[p] = host_params[p];
    pc.rho[p] = host_params[PIECES + p];
    pc.rho_tb[p] = host_params[2 * PIECES + p];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const long long nb = (n + tb - 1) / tb;
  const long long nb_end = nb - 1;  // the last block's end value is unused
  if (nb_end > 0)
    block_ends<<<(unsigned)((nb_end + threads - 1) / threads), threads, 0,
                 s>>>(dep, e, n, tb, nb_end, reverse, pc);
  block_carries<<<1, 32, 0, s>>>(e, carry, nb, pc);
  block_env<<<(unsigned)((nb + threads - 1) / threads), threads, 0, s>>>(
      dep, carry, env, n, tb, nb, reverse, pc);
  return (int)cudaGetLastError();
}

extern "C" const char* wedge_env_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
