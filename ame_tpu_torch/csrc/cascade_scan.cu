// Cascade IIR filter (k <= 8 biquad sections) as a block scan over short
// sub-blocks staged through shared memory.
//
// Replaces the Pallas kernel ame_tpu/ops/pallas_scan.py::_kernel (driven by
// sosfilt_pallas). On the TPU that kernel walks time blocks in order on one
// core and carries the 2k filter state from one grid step to the next in
// VMEM. On the card blocks run in parallel and in no order, so the carry is
// a scan of its own.
//
// What bounds it on an H100: bytes. x is [n, C] f32 in, y the same out
// (2^23 x 2 samples: 134 MB, 0.040 ms at 3.35 TB/s); the recurrence costs
// 7 f32 operations per section per sample, a few hundredths of a ms at the
// card's f32 rate, if enough independent chains keep every SM busy and
// the loads coalesce.
//
// The design, three launches on one stream:
//
//   1. cascade_ends: a thread block owns a tile of T = P*SUB samples x CB
//      channels. It copies the tile into shared memory with cp.async,
//      neighbouring threads on neighbouring addresses (x is sample-major,
//      so a tile is one contiguous span). Each thread then walks one
//      sub-block of SUB samples of one channel from zero state, out of
//      shared memory, into its end state e_j [2k]; P*CB threads, so
//      n*C/SUB chains in all (2^18 at 2^23 stereo). The shared layout pads
//      each sub-block row by one float (and each channel plane by 32/CB),
//      so the 32 threads of a warp read 32 banks. A Hillis-Steele scan over
//      the block's P sub-blocks, S_j = A^SUB S_{j-1} + e_j, uses the powers
//      A^(SUB*2^l); it writes the inclusive prefixes S [nb, C, 2k, P].
//   2. cascade_carries: one block per channel stages the tile totals
//      and one warp of it scans them: E_b = S_{b,P-1} (written compact by
//      phase 1), c_{b+1} = A^T c_b + E_b
//      from c_0 = zi, in chunks of 32*R tiles staged in shared memory: each
//      lane folds its R tiles from zero (A^T in registers), a shuffle scan
//      over the lanes with A^(T*R*2^m) (lane 0 seeded with A^(T*R) times
//      the chunk's carry-in) gives each lane its carry-in, and the lane
//      walks its R tiles again, writing the carry into every tile,
//      cst [nb, C, 2k]. At 2^23 stereo that is one chunk of 1024 tiles.
//   3. cascade_outputs: each tile is staged again; each thread starts from
//      S_{j-1} + A^(SUB*j) c_b (the bits of j select the powers), re-runs
//      its sub-block, writes y over x in shared memory, and the block
//      stores the tile with coalesced stores. The thread that holds the
//      last sample writes zf.
//
// x is read from device memory twice and y written once. The scans read
// their powers from shared memory 16 bytes at a time. The powers are
// built on the host in float64 from the f32-rounded section rows, in the
// basis the kernel carries (coupled for complex poles, triangular for real
// ones: ops/cascade_scan.py::_kernel_sections), rounded to f32 once, and
// kept on the device per cascade, so nothing is uploaded per call. The
// sections, Vi and Vf travel by value (__grid_constant__).
//
// Numerics: f32 CUDA-core arithmetic throughout; nvcc contracts a*b+c into
// FMA (left on: no bit-exactness is claimed for this kernel). Any n: the
// ragged edge is zero-filled on load, masked on store, and the last walk
// stops at sample n-1.
//
// Layouts: x, y are [n, C] row-major (sample-major, as the public function);
// zi, zf are scipy layout [k, C, 2].
//
// REVERSE (cascade_scan_reverse_f32): the same three launches on the
// sequence read backward. Virtual sample t is physical sample n-1-t: the
// tile copies read and write x and y at n-1-t, and everything between
// them (walks, scans, carries) is the forward code unchanged, so the
// recurrence starts from zi (zero for the adjoint) after the last sample
// and zf is the state after sample 0. This is the adjoint of a cascade
// (ops/scan_iir.py::SosfiltFn): the transpose of a causal LTI filter is
// the same filter run backward in time. The forward instantiation
// (REVERSE = false) compiles to the code it was before.

#include <cuda_runtime.h>

#define MAX_SECTIONS 8
#define SUB 64                 // samples per thread
#define MAX_THREADS 256        // threads per tile block (P * CB)
#define LOG_CARRY 9            // T-powers A^(T*2^l), l <= LOG_CARRY
#define CARRY_THREADS 256      // threads staging the carry scan's input

struct Section {
  // y = b0*u + s1;  s1' = a11*s1 + a12*s2 + bb1*u;  s2' = a21*s1 + a22*s2 + bb2*u
  float b0, bb1, bb2, a11, a12, a21, a22;
};

struct Params {
  Section sec[MAX_SECTIONS];
  float Vi[MAX_SECTIONS][4];  // scipy zi -> internal, row-major 2x2
  float Vf[MAX_SECTIONS][4];  // internal -> scipy zf
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

// out = M v, M row-major [D, D], read as plain loads (the parameter block
// or device memory, the same address for every lane)
template <int D>
__device__ __forceinline__ void matvec(const float* M, const float* v,
                                       float* out) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < D; ++m) a = fmaf(M[r * D + m], v[m], a);
    out[r] = a;
  }
}

// the same from shared memory, 16 (or 8) bytes a load: D is even, and a
// multiple of 4 when k is even
template <int D>
__device__ __forceinline__ void matvec_smem(const float* M, const float* v,
                                            float* out) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float a = 0.f;
    if constexpr (D % 4 == 0) {
#pragma unroll
      for (int m = 0; m < D; m += 4) {
        const float4 q = *reinterpret_cast<const float4*>(M + r * D + m);
        a = fmaf(q.x, v[m], a);
        a = fmaf(q.y, v[m + 1], a);
        a = fmaf(q.z, v[m + 2], a);
        a = fmaf(q.w, v[m + 3], a);
      }
    } else {
#pragma unroll
      for (int m = 0; m < D; m += 2) {
        const float2 q = *reinterpret_cast<const float2*>(M + r * D + m);
        a = fmaf(q.x, v[m], a);
        a = fmaf(q.y, v[m + 1], a);
      }
    }
    out[r] = a;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile geometry of one block: channels [c0, c0 + cb) of CB, P
// sub-blocks of SUB samples per channel from sample t0.
struct Tile {
  int P, CB, cb, c0, PS;
  long long t0;
};

__device__ __forceinline__ Tile tile_of(int C, int CB, int logP) {
  Tile g;
  g.P = 1 << logP;
  g.CB = CB;
  g.c0 = blockIdx.y * CB;
  g.cb = min(CB, C - g.c0);
  // one float of padding per sub-block row, 32/CB per channel plane
  g.PS = g.P * (SUB + 1) + (32 + CB - 1) / CB;
  g.t0 = (long long)blockIdx.x * g.P * SUB;
  return g;
}

// Element (sample tt of the tile, channel q) lives at
// tile[q*PS + (tt/SUB)*(SUB+1) + tt%SUB]. Thread tid copies channel
// tid % CB at samples tid/CB + i*P, i < SUB: consecutive threads take
// consecutive addresses of x.
// With REVERSE, tile sample tt is physical sample n-1-(t0+tt).
template <bool REVERSE>
__device__ __forceinline__ void tile_copy_in(float* tile, const float* x,
                                             long long n, int C,
                                             const Tile& g) {
  const int q = threadIdx.x % g.CB, tt0 = threadIdx.x / g.CB;
  float* dst = tile + q * g.PS + (tt0 / SUB) * (SUB + 1) + tt0 % SUB;
  const int dstep = (g.P / SUB) * (SUB + 1);
  const long long t = REVERSE ? n - 1 - (g.t0 + tt0) : g.t0 + tt0;
  const float* src = x + t * C + g.c0 + q;
  const long long sstep = REVERSE ? -(long long)g.P * C : (long long)g.P * C;
  const bool qv = q < g.cb;
#pragma unroll 8
  for (int i = 0; i < SUB; ++i) {
    const bool v = qv && g.t0 + tt0 + (long long)i * g.P < n;
    cp_async4(dst + i * dstep, v ? src + i * sstep : x, v);
  }
}

template <bool REVERSE>
__device__ __forceinline__ void tile_copy_out(float* y, const float* tile,
                                              long long n, int C,
                                              const Tile& g) {
  const int q = threadIdx.x % g.CB, tt0 = threadIdx.x / g.CB;
  if (q >= g.cb) return;
  const float* s = tile + q * g.PS + (tt0 / SUB) * (SUB + 1) + tt0 % SUB;
  const int sstep = (g.P / SUB) * (SUB + 1);
  const long long t = REVERSE ? n - 1 - (g.t0 + tt0) : g.t0 + tt0;
  float* dst = y + t * C + g.c0 + q;
  const long long dstep = REVERSE ? -(long long)g.P * C : (long long)g.P * C;
#pragma unroll 8
  for (int i = 0; i < SUB; ++i)
    if (g.t0 + tt0 + (long long)i * g.P < n) dst[i * dstep] = s[i * sstep];
}

template <int K, bool REVERSE>
__global__ void __launch_bounds__(MAX_THREADS)
    cascade_ends(const float* __restrict__ x, float* __restrict__ S,
                 float* __restrict__ E, const float* __restrict__ pw,
                 long long n, int C, int CB,
                 int logP, const __grid_constant__ Params p) {
  constexpr int D = 2 * K;
  extern __shared__ float sm[];
  const Tile g = tile_of(C, CB, logP);
  float* pws = sm;                       // A^(SUB*2^l), l < logP
  float* tile = sm + logP * D * D;
  tile_copy_in<REVERSE>(tile, x, n, C, g);
  for (int i = threadIdx.x; i < logP * D * D; i += blockDim.x) pws[i] = pw[i];
  cp_async_wait_all();
  __syncthreads();

  const int cc = threadIdx.x >> logP, j = threadIdx.x & (g.P - 1);
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  const float* row = tile + cc * g.PS + j * (SUB + 1);
#pragma unroll 8
  for (int i = 0; i < SUB; ++i) cascade_step<K>(p, s, row[i]);
  __syncthreads();                       // the tile becomes the exchange

  float* xb = tile + cc * D * g.P;       // [D][P] per channel
  for (int l = 0; l < logP; ++l) {
    const int off = 1 << l;
#pragma unroll
    for (int d = 0; d < D; ++d) xb[d * g.P + j] = s[d];
    __syncthreads();
    if (j >= off) {
      float o[D], t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = xb[d * g.P + j - off];
      matvec_smem<D>(pws + l * D * D, o, t);
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] += t[d];
    }
    __syncthreads();
  }
  if (cc < g.cb) {
    const long long bc = (long long)blockIdx.x * C + g.c0 + cc;
    float* out = S + bc * D * g.P + j;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d * g.P] = s[d];
    if (j == g.P - 1) {                  // the tile's total, compact
#pragma unroll
      for (int d = 0; d < D; ++d) E[bc * D + d] = s[d];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(CARRY_THREADS)
    cascade_carries(const float* __restrict__ E, const float* __restrict__ zi,
                    float* __restrict__ cst, const float* __restrict__ pw,
                    long long nb, int C, const __grid_constant__ Params p) {
  constexpr int D = 2 * K;
  constexpr int LOGR = D <= 8 ? 5 : 4;    // R tiles a lane, 32*R a chunk
  constexpr int R = 1 << LOGR, CH = 32 * R, LS = R * D + 1;
  __shared__ float es[32 * LS];            // the chunk's E, a padded row a lane
  __shared__ __align__(16) float pws[5 * D * D];   // A^(T*R*2^m), m < 5
  __shared__ __align__(16) float Ms[D <= 8 ? 1 : D * D];
  float Mr[D <= 8 ? D * D : 1];            // A^T: registers while they last
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 5 * D * D; i += CARRY_THREADS)
    pws[i] = pw[LOGR * D * D + i];
  if constexpr (D <= 8) {
    if (tid < 32) {
#pragma unroll
      for (int i = 0; i < D * D; ++i) Mr[i] = pw[i];
    }
  } else {
    for (int i = tid; i < D * D; i += CARRY_THREADS) Ms[i] = pw[i];
  }
  auto step = [&](const float* v, float* out) {   // out = A^T v
    if constexpr (D <= 8) matvec<D>(Mr, v, out);
    else matvec_smem<D>(Ms, v, out);
  };
  float cb[D], a[D], o[D], t[D];
#pragma unroll
  for (int i = 0; i < K; ++i) {           // c_0 = Vi zi
    const float z0 = zi ? zi[(i * C + c) * 2] : 0.f;
    const float z1 = zi ? zi[(i * C + c) * 2 + 1] : 0.f;
    cb[2 * i] = p.Vi[i][0] * z0 + p.Vi[i][1] * z1;
    cb[2 * i + 1] = p.Vi[i][2] * z0 + p.Vi[i][3] * z1;
  }
  for (long long base = 0; base < nb; base += CH) {
    // all threads stage the chunk's tile totals (lane l of warp 0 walks
    // tiles base + l*R + i); then warp 0 alone runs the scan
    __syncthreads();
#pragma unroll 8
    for (int e = tid; e < CH * D; e += CARRY_THREADS) {
      const int bl = e / D, d = e % D;
      const long long b = base + bl;
      es[(bl / R) * LS + (bl % R) * D + d] =
          b < nb ? E[(b * C + c) * D + d] : 0.f;
    }
    __syncthreads();
    if (tid >= 32) continue;
    const float* my = es + lane * LS;
#pragma unroll
    for (int d = 0; d < D; ++d) a[d] = 0.f;
    for (int i = 0; i < R; ++i) {         // the lane's R tiles from zero
      step(a, t);
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] = t[d] + my[i * D + d];
    }
    if (lane == 0) {                      // + A^(T*R) c_base
      matvec_smem<D>(pws, cb, t);
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] += t[d];
    }
    // inclusive scan over the lanes: a_l += A^(T*R*off) a_{l-off}
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int off = 1 << m;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = __shfl_up_sync(0xffffffffu, a[d], off);
      if (lane >= off) {
        matvec_smem<D>(pws + m * D * D, o, t);
#pragma unroll
        for (int d = 0; d < D; ++d) a[d] += t[d];
      }
    }
    // the carry into the lane's first tile, then its R tiles' carries
#pragma unroll
    for (int d = 0; d < D; ++d) {
      o[d] = __shfl_up_sync(0xffffffffu, a[d], 1);
      if (lane == 0) o[d] = cb[d];
    }
    for (int i = 0; i < R; ++i) {
      const long long b = base + (long long)lane * R + i;
      if (b < nb) {
#pragma unroll
        for (int d = 0; d < D; ++d) cst[(b * C + c) * D + d] = o[d];
      }
      step(o, t);
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = t[d] + my[i * D + d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) cb[d] = __shfl_sync(0xffffffffu, a[d], 31);
  }
}

template <int K, bool REVERSE>
__global__ void __launch_bounds__(MAX_THREADS)
    cascade_outputs(const float* __restrict__ x, const float* __restrict__ S,
                    const float* __restrict__ cst, float* __restrict__ y,
                    float* __restrict__ zf, const float* __restrict__ pw,
                    long long n, int C, int CB, int logP,
                    const __grid_constant__ Params p) {
  constexpr int D = 2 * K;
  extern __shared__ float sm[];
  const Tile g = tile_of(C, CB, logP);
  float* pws = sm;
  float* tile = sm + logP * D * D;
  tile_copy_in<REVERSE>(tile, x, n, C, g);
  for (int i = threadIdx.x; i < logP * D * D; i += blockDim.x) pws[i] = pw[i];
  __syncthreads();

  // the start state S_{j-1} + A^(SUB*j) c_b, while the tile arrives
  const int cc = threadIdx.x >> logP, j = threadIdx.x & (g.P - 1);
  const int c = g.c0 + (cc < g.cb ? cc : 0);
  const long long bc = (long long)blockIdx.x * C + c;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = cst[bc * D + d];
  for (int l = 0; l < logP; ++l) {
    float t[D];
    matvec_smem<D>(pws + l * D * D, s, t);
    const bool take = (j >> l) & 1;
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = take ? t[d] : s[d];
  }
  if (j > 0) {
    const float* e = S + bc * D * g.P + (j - 1);
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] += e[d * g.P];
  }
  cp_async_wait_all();
  __syncthreads();

  const long long t0 = g.t0 + (long long)j * SUB;
  float* row = tile + cc * g.PS + j * (SUB + 1);
  if (t0 + SUB <= n) {
#pragma unroll 8
    for (int i = 0; i < SUB; ++i) row[i] = cascade_step<K>(p, s, row[i]);
  } else {
    for (long long i = 0; t0 + i < n; ++i) row[i] = cascade_step<K>(p, s, row[i]);
  }
  if (cc < g.cb && t0 < n && t0 + SUB >= n) {   // holds sample n-1
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float s1 = s[2 * i], s2 = s[2 * i + 1];
      zf[(i * C + c) * 2] = p.Vf[i][0] * s1 + p.Vf[i][1] * s2;
      zf[(i * C + c) * 2 + 1] = p.Vf[i][2] * s1 + p.Vf[i][3] * s2;
    }
  }
  __syncthreads();
  tile_copy_out<REVERSE>(y, tile, n, C, g);
}

template <int K, bool REVERSE>
static int launch(const float* x, float* y, const float* zi, float* zf,
                  float* S, float* E, float* cst, const float* pw,
                  long long n, int C, int CB, int logP, const Params& p,
                  cudaStream_t stream) {
  constexpr int D = 2 * K;
  const int P = 1 << logP;
  const long long nb = (n + (long long)P * SUB - 1) / ((long long)P * SUB);
  const int groups = (C + CB - 1) / CB;
  const int PS = P * (SUB + 1) + (32 + CB - 1) / CB;
  const size_t smem = ((size_t)logP * D * D + (size_t)CB * PS) * sizeof(float);
  static size_t smem_set = 0;            // dynamic shared memory allowed
  if (smem > smem_set) {
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             cascade_ends<K, REVERSE>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             cascade_outputs<K, REVERSE>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)err;
    smem_set = smem;
  }
  const dim3 grid((unsigned)nb, (unsigned)groups);
  cascade_ends<K, REVERSE><<<grid, P * CB, smem, stream>>>(x, S, E, pw, n, C,
                                                           CB, logP, p);
  cascade_carries<K><<<C, CARRY_THREADS, 0, stream>>>(
      E, zi, cst, pw + logP * D * D, nb, C, p);
  cascade_outputs<K, REVERSE><<<grid, P * CB, smem, stream>>>(
      x, S, cst, y, zf, pw, n, C, CB, logP, p);
  return (int)cudaGetLastError();
}

// host_params (float32): k rows of (b0, bb1, bb2, a11, a12, a21, a22), then
// Vi as [k, 2, 2], then Vf as [k, 2, 2]. powers (device, float32): the
// logP powers A^(SUB*2^l), then the LOG_CARRY+1 powers A^(T*2^l),
// each [2k, 2k] row-major. Scratch (device): S [nb, C, 2k, 2^logP],
// E and cst [nb, C, 2k], nb = ceil(n / (SUB*2^logP)). The tile holds CB channels
// (CB <= 4, CB <= C) and 2^logP sub-blocks of each (SUB <= 2^logP,
// 2^logP * CB <= MAX_THREADS). zi may be null (zero initial state).
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for unsupported sizes.
template <bool REVERSE>
static int cascade_scan(const float* x, float* y, const float* zi, float* zf,
                        float* S, float* E, float* cst, const float* powers,
                        long long n, int C, int k, int CB, int logP,
                        const float* host_params, void* stream) {
  const int P = 1 << logP;
  if (k < 1 || k > MAX_SECTIONS || n < 1 || C < 1 || CB < 1 || CB > 4 ||
      CB > C || logP < 0 || logP > 8 || P < SUB || P * CB > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  const float* hp = host_params;
  for (int i = 0; i < k; ++i, hp += 7)
    p.sec[i] = Section{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6]};
  for (int i = 0; i < k; ++i)
    for (int q = 0; q < 4; ++q) p.Vi[i][q] = hp[i * 4 + q];
  hp += 4 * k;
  for (int i = 0; i < k; ++i)
    for (int q = 0; q < 4; ++q) p.Vf[i][q] = hp[i * 4 + q];
  cudaStream_t s = (cudaStream_t)stream;
#define CASCADE_LAUNCH(KK) \
  launch<KK, REVERSE>(x, y, zi, zf, S, E, cst, powers, n, C, CB, logP, p, s)
  switch (k) {
    case 1: return CASCADE_LAUNCH(1);
    case 2: return CASCADE_LAUNCH(2);
    case 3: return CASCADE_LAUNCH(3);
    case 4: return CASCADE_LAUNCH(4);
    case 5: return CASCADE_LAUNCH(5);
    case 6: return CASCADE_LAUNCH(6);
    case 7: return CASCADE_LAUNCH(7);
    default: return CASCADE_LAUNCH(8);
  }
#undef CASCADE_LAUNCH
}

extern "C" int cascade_scan_f32(const float* x, float* y, const float* zi,
                                float* zf, float* S, float* E, float* cst,
                                const float* powers, long long n, int C,
                                int k, int CB, int logP,
                                const float* host_params, void* stream) {
  return cascade_scan<false>(x, y, zi, zf, S, E, cst, powers, n, C, k, CB,
                             logP, host_params, stream);
}

// The same arguments; x is read and y written from sample n-1 down to 0,
// and zf is the state after sample 0.
extern "C" int cascade_scan_reverse_f32(const float* x, float* y,
                                        const float* zi, float* zf, float* S,
                                        float* E, float* cst,
                                        const float* powers, long long n,
                                        int C, int k, int CB, int logP,
                                        const float* host_params,
                                        void* stream) {
  return cascade_scan<true>(x, y, zi, zf, S, E, cst, powers, n, C, k, CB,
                            logP, host_params, stream);
}

extern "C" const char* cascade_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
