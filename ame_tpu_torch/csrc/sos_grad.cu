// Coefficient gradient of one biquad section: five lag correlations.
//
// For a section s = (b0, b1, b2, 1, a1, a2) of a cascade, with g the
// cotangent of its output, v its input filtered by 1/A(z) and w its output
// filtered by 1/A(z) (ops/scan_iir.py::SosfiltFn), all [n, C] f32:
//
//   out[j]     =  sum_{t, c} g[t, c] * v[t - j, c]    j = 0, 1, 2  (dL/db_j)
//   out[2 + j] = -sum_{t, c} g[t, c] * w[t - j, c]    j = 1, 2     (dL/da_j)
//
// with v[t] = w[t] = 0 for t < 0 (zero initial state). Each product is
// rounded in f32 (__fmul_rn: nothing contracts it into a double FMA) and
// the sums are doubles. The JAX package has no kernel here: its gradient
// is XLA autodiff through the tile-conv tables
// (ame_tpu/ops/tile_conv.py:246); this is part of the backward of K5
// (ame_tpu/ops/pallas_scan.py), run once a section of a fit's
// tensor-coefficient cascades.
//
// What bounds it on an H100: bytes. Three [n, C] f32 reads, 3*n*C*4 bytes
// (2^23 x 2: 201 MB, 0.060 ms at 3.35 TB/s), against 5 products, 5
// f32->f64 conversions and 5 double adds an element; the conversions
// (16 a clock an SM) are the busiest pipe, at about a third of the bytes'
// time.
//
// The design, and what each choice removed from the first version (which
// staged flat elements e = t*C + c of 2 048-element tiles through shared
// memory, one block a tile, then one block added the 8 192 partials):
//
//   * Rows, not flat elements. Lane l of a warp takes row r0 + 32 s + l at
//     step s, and adds its C columns in order. No division is left (the
//     first version divided a 64-bit e by C twice an element); addresses
//     advance by adding a row stride.
//   * The vector route, for the layout the backward passes: v and w the
//     column halves of one [n, 2C] tensor (w = v + C, one row stride,
//     rows 8C-byte aligned), C = 1 or 2. A lane reads a row's v|w with one
//     16-byte (C = 2) or 8-byte (C = 1) load and its g with one 8- or
//     4-byte load; lags 1 and 2 come from lanes l - 1 and l - 2 by
//     shuffles, lanes 0 and 1 taking them from the step before, which
//     lanes 30 and 31 hold in registers. This removed the shared-memory
//     stage, its barrier and its scalar loads. Every byte is read once
//     but the two halo rows at the start of a warp's range.
//   * The general route, for any other layout or 3 <= C <= 64: the same
//     rows, steps and order, with 4-byte loads of g, v and w and the lags
//     read from the rows before (L1 holds them). Both routes form the same
//     products from the same values and add them in the same order, so
//     their sums are equal bit for bit: the order depends on n and C only.
//   * A fixed, persistent partition. Each warp owns a contiguous run of
//     rows, a multiple of the step, sized from n alone so that the grid is
//     at most SG_BLOCKS blocks (four an SM of 132): one wave of warps that
//     each start SG_UNROLL steps of loads before their products, which
//     keeps the bytes in flight that the memory needs. This removed 8 192
//     blocks' launch and tail and the one-block pass over their partials.
//   * A short, deterministic finish: the block's five sums by a fixed
//     shuffle tree, one partial row a block (<= SG_BLOCKS), then a second
//     launch of five warps adds them in block order. Two launches on one
//     stream, no atomics and no state kept between calls, so a fit gets
//     the same gradient on every run and two streams may call at once.

#include <cuda_runtime.h>

#ifndef SG_UNROLL
#define SG_UNROLL 2      // warp steps whose loads are started together
#endif
#ifndef SG_BLOCKS
#define SG_BLOCKS 528    // the most blocks a call: 4 an SM of 132
#endif
#ifndef SG_MIN_BLOCKS
#define SG_MIN_BLOCKS 4  // blocks an SM the registers must allow
#endif
#define THREADS 256
#define WARPS (THREADS / 32)
#define STEP (32 * SG_UNROLL)         // rows a warp covers a loop turn
#define MAX_C 64
#define FULL 0xffffffffu

// Rows a warp owns for n rows: a multiple of STEP, at most SG_BLOCKS
// blocks in all.
static long long rows_per_warp(long long n) {
  const long long w = (n + SG_BLOCKS * WARPS - 1) / (SG_BLOCKS * WARPS);
  return (w + STEP - 1) / STEP * STEP;
}

__device__ __forceinline__ double warp_sum(double a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(FULL, a, off);
  return a;
}

// A row of the vector route: v|w (VW) and g (G) of C = 1 or 2 columns.
template <int C> struct Row;
template <> struct Row<1> { typedef float2 VW; typedef float G; };
template <> struct Row<2> { typedef float4 VW; typedef float2 G; };

__device__ __forceinline__ float vcol(float4 a, int c) { return c ? a.y : a.x; }
__device__ __forceinline__ float wcol(float4 a, int c) { return c ? a.w : a.z; }
__device__ __forceinline__ float vcol(float2 a, int) { return a.x; }
__device__ __forceinline__ float wcol(float2 a, int) { return a.y; }
__device__ __forceinline__ float gcol(float2 a, int c) { return c ? a.y : a.x; }
__device__ __forceinline__ float gcol(float a, int) { return a; }

__device__ __forceinline__ float4 shfl(float4 a, int src) {
  return make_float4(__shfl_sync(FULL, a.x, src), __shfl_sync(FULL, a.y, src),
                     __shfl_sync(FULL, a.z, src), __shfl_sync(FULL, a.w, src));
}
__device__ __forceinline__ float2 shfl(float2 a, int src) {
  return make_float2(__shfl_sync(FULL, a.x, src), __shfl_sync(FULL, a.y, src));
}
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

// One column's five products, added in the order both routes use.
__device__ __forceinline__ void add5(double* acc, float gc, float v0, float v1,
                                     float v2, float w1, float w2) {
  acc[0] += (double)__fmul_rn(gc, v0);
  acc[1] += (double)__fmul_rn(gc, v1);
  acc[2] += (double)__fmul_rn(gc, v2);
  acc[3] += (double)__fmul_rn(gc, w1);
  acc[4] += (double)__fmul_rn(gc, w2);
}

// The vector route over a warp's cnt rows from r0 (see the note above).
// v points at row 0 of the [n, 2C] v|w tensor, row strides in floats.
template <int C>
__device__ __forceinline__ void rows_vector(const float* g, const float* v,
                                            long long ldg, long long ldv,
                                            long long r0, int cnt, int lane,
                                            double* acc) {
  typedef typename Row<C>::VW VW;
  typedef typename Row<C>::G G;
  const long long sv = ldv / (2 * C), sg = ldg / C;    // strides in vectors
  const VW* pv = reinterpret_cast<const VW*>(v) + (r0 + lane) * sv;
  const G* pg = reinterpret_cast<const G*>(g) + (r0 + lane) * sg;
  // the halo: rows r0 - 2 and r0 - 1, held by lanes 30 and 31 as if they
  // were the step before the first
  VW prev;
  zero(prev);
  if (lane >= 30 && r0 + lane - 32 >= 0) prev = __ldg(pv - 32 * sv);
  for (int base = 0; base < cnt; base += STEP) {
    VW x[SG_UNROLL];
    G gg[SG_UNROLL];
#pragma unroll
    for (int u = 0; u < SG_UNROLL; ++u) {
      zero(x[u]);
      zero(gg[u]);
      if (base + 32 * u + lane < cnt) {
        x[u] = __ldg(pv + 32 * u * sv);
        gg[u] = __ldg(pg + 32 * u * sg);
      }
    }
#pragma unroll
    for (int u = 0; u < SG_UNROLL; ++u) {
      const VW before = u ? x[u - 1] : prev;
      const VW x1 = shfl(lane == 31 ? before : x[u], (lane + 31) & 31);
      const VW x2 = shfl(lane >= 30 ? before : x[u], (lane + 30) & 31);
#pragma unroll
      for (int c = 0; c < C; ++c)
        add5(acc, gcol(gg[u], c), vcol(x[u], c), vcol(x1, c), vcol(x2, c),
             wcol(x1, c), wcol(x2, c));
    }
    prev = x[SG_UNROLL - 1];
    pv += STEP * sv;
    pg += STEP * sg;
  }
}

// The general route: the same rows, steps and order with 4-byte loads; a
// lag row is read where it lies in [0, r0 + cnt), as the vector route's
// shuffles and halo give it.
template <int CT>
__device__ __forceinline__ void rows_general(const float* g, const float* v,
                                             const float* w, int C_rt,
                                             long long ldg, long long ldv,
                                             long long ldw, long long r0,
                                             int cnt, int lane, double* acc) {
  const int C = CT > 0 ? CT : C_rt;
  const float* pg = g + (r0 + lane) * ldg;
  const float* pv = v + (r0 + lane) * ldv;
  const float* pw = w + (r0 + lane) * ldw;
  const int first = r0 >= 2 ? -2 : (int)-r0;   // the first readable row - r0
  for (int base = 0; base < cnt; base += STEP) {
#pragma unroll
    for (int u = 0; u < SG_UNROLL; ++u) {
      const int rel = base + 32 * u + lane;
      const bool ok0 = rel < cnt;
      const bool ok1 = rel - 1 < cnt && rel - 1 >= first;
      const bool ok2 = rel - 2 < cnt && rel - 2 >= first;
      const float* qg = pg + 32 * u * ldg;
      const float* qv = pv + 32 * u * ldv;
      const float* qw = pw + 32 * u * ldw;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float gc = ok0 ? __ldg(qg + c) : 0.f;
        const float v0 = ok0 ? __ldg(qv + c) : 0.f;
        const float v1 = ok1 ? __ldg(qv + c - ldv) : 0.f;
        const float v2 = ok2 ? __ldg(qv + c - 2 * ldv) : 0.f;
        const float w1 = ok1 ? __ldg(qw + c - ldw) : 0.f;
        const float w2 = ok2 ? __ldg(qw + c - 2 * ldw) : 0.f;
        add5(acc, gc, v0, v1, v2, w1, w2);
      }
    }
    pg += STEP * ldg;
    pv += STEP * ldv;
    pw += STEP * ldw;
  }
}

// One partial row [5] a block: its warps' rows summed by a fixed tree.
template <int CT, bool VEC>
__global__ void __launch_bounds__(THREADS, SG_MIN_BLOCKS)
    sos_grad_partials(const float* __restrict__ g, const float* __restrict__ v,
                      const float* __restrict__ w, long long n, int C,
                      long long ldg, long long ldv, long long ldw,
                      long long rows, double* __restrict__ partials) {
  __shared__ double red[WARPS * 5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = ((long long)blockIdx.x * WARPS + warp) * rows;
  const long long left = n - r0;
  const int cnt = left <= 0 ? 0 : (int)(left < rows ? left : rows);
  double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if (cnt > 0) {
    if constexpr (VEC)
      rows_vector<CT>(g, v, ldg, ldv, r0, cnt, lane, acc);
    else
      rows_general<CT>(g, v, w, C, ldg, ldv, ldw, r0, cnt, lane, acc);
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) acc[q] = warp_sum(acc[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) red[warp * 5 + q] = acc[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      double a = lane < WARPS ? red[lane * 5 + q] : 0.0;
      a = warp_sum(a);
      if (lane == 0) partials[blockIdx.x * 5 + q] = a;
    }
  }
}

// Warp q adds column q of the partials: lane l takes blocks l, l + 32, ...
// in order, then the same shuffle tree.
__global__ void __launch_bounds__(160)
    sos_grad_final(const double* __restrict__ partials, int nblocks,
                   double* __restrict__ out) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  double a = 0.0;
  for (int b = lane; b < nblocks; b += 32) a += partials[b * 5 + q];
  a = warp_sum(a);
  if (lane == 0) out[q] = q < 3 ? a : -a;
}

// Number of partial rows (doubles x 5) the scratch must hold for n rows;
// it depends on n alone (C is kept for the interface).
extern "C" long long sos_grad_blocks(long long n, int C) {
  (void)C;
  const long long rows = rows_per_warp(n);
  return ((n + rows - 1) / rows + WARPS - 1) / WARPS;
}

// g, v, w: device f32 with row strides ldg, ldv, ldw (elements) and unit
// column stride; vector != 0 asks for the vector route, which needs
// C <= 2, w == v + C, ldv == ldw, v's rows 8C-byte aligned and g's rows
// 4C-byte aligned. scratch: device double [sos_grad_blocks(n, C), 5];
// out: device double [5]. Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for unsupported sizes or layouts.
extern "C" int sos_grad_f64(const float* g, const float* v, const float* w,
                            long long n, int C, long long ldg, long long ldv,
                            long long ldw, int vector, double* scratch,
                            double* out, void* stream) {
  if (n < 1 || C < 1 || C > MAX_C || ldg < C || ldv < C || ldw < C)
    return (int)cudaErrorInvalidValue;
  const long long rows = rows_per_warp(n);
  if (rows > 0x7fffffffLL - STEP) return (int)cudaErrorInvalidValue;
  if (vector) {
    const unsigned long long pv = (unsigned long long)v,
                             pg = (unsigned long long)g;
    if (C > 2 || w != v + C || ldv != ldw || pv % (8 * C) != 0
        || (4 * ldv) % (8 * C) != 0 || pg % (4 * C) != 0
        || (4 * ldg) % (4 * C) != 0)
      return (int)cudaErrorInvalidValue;
  }
  const int nblocks = (int)sos_grad_blocks(n, C);
  cudaStream_t s = (cudaStream_t)stream;
#define SG_LAUNCH(CT, VEC)                                                  \
  sos_grad_partials<CT, VEC><<<nblocks, THREADS, 0, s>>>(                   \
      g, v, w, n, C, ldg, ldv, ldw, rows, scratch)
  if (vector && C == 1) SG_LAUNCH(1, true);
  else if (vector) SG_LAUNCH(2, true);
  else if (C == 1) SG_LAUNCH(1, false);
  else if (C == 2) SG_LAUNCH(2, false);
  else SG_LAUNCH(0, false);
#undef SG_LAUNCH
  sos_grad_final<<<1, 160, 0, s>>>(scratch, nblocks, out);
  return (int)cudaGetLastError();
}

extern "C" const char* sos_grad_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
