// Cascade IIR filter (k <= 8 biquad sections) as a three-phase block scan.
//
// Replaces the Pallas kernel ame_tpu/ops/pallas_scan.py::_kernel (driven by
// sosfilt_pallas). On the TPU that kernel walks time blocks in order on one
// core and carries the 2k filter state from one grid step to the next in
// VMEM. On the card blocks run in parallel and in no order, so the carry
// becomes its own phase:
//
//   1. block_end_states: one thread per (channel, time block of tb samples)
//      runs the cascade from zero state over its block and writes the block's
//      end state e_b [2k].
//   2. block_carries: one thread per channel walks the blocks,
//      c_{b+1} = A^tb · c_b + e_b, starting from zi. A^tb is computed on the
//      host in float64 in the same state basis the kernel carries, so no
//      f32 squaring chain can overflow (near-unit-circle poles, quirk Q14).
//      That basis is coupled for complex poles and triangular for real ones
//      (ops/cascade_scan.py::_kernel_sections): a companion block rounded to
//      f32 can move a pole next to z = 1 outside the unit circle.
//   3. block_outputs: each (channel, block) thread re-runs its block from c_b
//      and writes y; the thread of the last block also writes zf.
//
// What bounds it: a sequential dependence chain of about 3 FMAs per section
// per sample inside each thread (the recurrence), not bytes: x is read twice
// and y written once. The block split exposes nb*C independent chains; the
// carry phase is nb small mat-vecs per channel. Shared-memory staging,
// coalesced loads and wgmma chunk products are left for later work.
//
// Numerics: f32 throughout; nvcc contracts a*b+c into FMA (left on: the
// quality path needs no bit-exactness against XLA). The ragged last block is
// masked inside the kernels; there is no plain-PyTorch tail.
//
// The parameter block travels by value (__grid_constant__: readable in
// place, never copied to local memory).
//
// Layouts: x, y are [n, C] row-major (sample-major, as the public function);
// zi, zf are scipy layout [k, C, 2]; scratch e, cst are [nb, C, 2k].

#include <cuda_runtime.h>

#define MAX_SECTIONS 8
#define MAX_STATE (2 * MAX_SECTIONS)

struct Section {
  // y = b0*u + s1;  s1' = a11*s1 + a12*s2 + bb1*u;  s2' = a21*s1 + a22*s2 + bb2*u
  float b0, bb1, bb2, a11, a12, a21, a22;
};

struct Params {
  Section sec[MAX_SECTIONS];
  float AT[MAX_STATE * MAX_STATE];  // A^tb, row-major, stride MAX_STATE
  float Vi[MAX_SECTIONS][4];        // scipy zi -> internal, row-major 2x2
  float Vf[MAX_SECTIONS][4];        // internal -> scipy zf
};

template <int K>
__device__ __forceinline__ float cascade_step(const Params& p, float* s,
                                              float u) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const Section& q = p.sec[i];
    const float s1 = s[2 * i], s2 = s[2 * i + 1];
    const float y = q.b0 * u + s1;
    s[2 * i] = q.a11 * s1 + q.a12 * s2 + q.bb1 * u;
    s[2 * i + 1] = q.a21 * s1 + q.a22 * s2 + q.bb2 * u;
    u = y;
  }
  return u;
}

template <int K>
__global__ void block_end_states(const float* __restrict__ x,
                                 float* __restrict__ e, long long n, int C,
                                 int tb, long long nb_end,
                                 const __grid_constant__ Params p) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (tid >= nb_end * C) return;
  const int c = (int)(tid % C);
  const long long b = tid / C;
  float s[2 * K];
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) s[d] = 0.f;
  const long long t0 = b * tb;
  const long long t1 = (t0 + tb < n) ? t0 + tb : n;  // ragged last block
  for (long long t = t0; t < t1; ++t) cascade_step<K>(p, s, x[t * C + c]);
  float* out = e + (b * C + c) * (2 * K);
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) out[d] = s[d];
}

template <int K>
__global__ void block_carries(const float* __restrict__ e,
                              const float* __restrict__ zi,
                              float* __restrict__ cst, int C, long long nb,
                              const __grid_constant__ Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  constexpr int D = 2 * K;
  float s[D];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float z0 = zi ? zi[(i * C + c) * 2] : 0.f;
    const float z1 = zi ? zi[(i * C + c) * 2 + 1] : 0.f;
    s[2 * i] = p.Vi[i][0] * z0 + p.Vi[i][1] * z1;
    s[2 * i + 1] = p.Vi[i][2] * z0 + p.Vi[i][3] * z1;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) cst[c * D + d] = s[d];
  for (long long b = 0; b + 1 < nb; ++b) {
    const float* eb = e + (b * C + c) * D;
    float ns[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = eb[j];
#pragma unroll
      for (int m = 0; m < D; ++m) acc += p.AT[j * MAX_STATE + m] * s[m];
      ns[j] = acc;
    }
    float* out = cst + ((b + 1) * C + c) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s[d] = ns[d];
      out[d] = ns[d];
    }
  }
}

template <int K>
__global__ void block_outputs(const float* __restrict__ x,
                              const float* __restrict__ cst,
                              float* __restrict__ y, float* __restrict__ zf,
                              long long n, int C, int tb, long long nb,
                              const __grid_constant__ Params p) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (tid >= nb * C) return;
  const int c = (int)(tid % C);
  const long long b = tid / C;
  float s[2 * K];
  const float* cb = cst + (b * C + c) * (2 * K);
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) s[d] = cb[d];
  const long long t0 = b * tb;
  const long long t1 = (t0 + tb < n) ? t0 + tb : n;  // ragged last block
  for (long long t = t0; t < t1; ++t)
    y[t * C + c] = cascade_step<K>(p, s, x[t * C + c]);
  if (b == nb - 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float s1 = s[2 * i], s2 = s[2 * i + 1];
      zf[(i * C + c) * 2] = p.Vf[i][0] * s1 + p.Vf[i][1] * s2;
      zf[(i * C + c) * 2 + 1] = p.Vf[i][2] * s1 + p.Vf[i][3] * s2;
    }
  }
}

template <int K>
static void launch(const float* x, float* y, const float* zi, float* zf,
                   float* e, float* cst, long long n, int C, int tb,
                   const Params& p, cudaStream_t stream) {
  const int threads = 128;
  const long long nb = (n + tb - 1) / tb;
  const long long nb_end = nb - 1;  // the last block's end state is not needed
  if (nb_end > 0) {
    const long long grid = (nb_end * C + threads - 1) / threads;
    block_end_states<K><<<(unsigned)grid, threads, 0, stream>>>(
        x, e, n, C, tb, nb_end, p);
  }
  block_carries<K><<<(C + threads - 1) / threads, threads, 0, stream>>>(
      e, zi, cst, C, nb, p);
  const long long grid = (nb * C + threads - 1) / threads;
  block_outputs<K><<<(unsigned)grid, threads, 0, stream>>>(x, cst, y, zf, n,
                                                           C, tb, nb, p);
}

// host_params (float32): k rows of (b0, bb1, bb2, a11, a12, a21, a22), then
// A^tb as [2k, 2k] row-major, then Vi as [k, 2, 2], then Vf as [k, 2, 2].
// zi may be null (zero initial state). Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for unsupported sizes.
extern "C" int cascade_scan_f32(const float* x, float* y, const float* zi,
                                float* zf, float* e, float* cst, long long n,
                                int C, int k, int tb,
                                const float* host_params, void* stream) {
  if (k < 1 || k > MAX_SECTIONS || n < 1 || C < 1 || tb < 1)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const int D = 2 * k;
  const float* hp = host_params;
  for (int i = 0; i < k; ++i, hp += 7)
    p.sec[i] = Section{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6]};
  for (int j = 0; j < D; ++j)
    for (int m = 0; m < D; ++m) p.AT[j * MAX_STATE + m] = hp[j * D + m];
  hp += D * D;
  for (int i = 0; i < k; ++i)
    for (int q = 0; q < 4; ++q) p.Vi[i][q] = hp[i * 4 + q];
  hp += 4 * k;
  for (int i = 0; i < k; ++i)
    for (int q = 0; q < 4; ++q) p.Vf[i][q] = hp[i * 4 + q];
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 2: launch<2>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 3: launch<3>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 4: launch<4>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 5: launch<5>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 6: launch<6>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    case 7: launch<7>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
    default: launch<8>(x, y, zi, zf, e, cst, n, C, tb, p, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cascade_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
