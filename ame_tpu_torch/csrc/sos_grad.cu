// Coefficient gradient of one biquad section: five lag correlations.
//
// For a section s = (b0, b1, b2, 1, a1, a2) of a cascade, with g the
// cotangent of its output, v its input filtered by 1/A(z) and w its output
// filtered by 1/A(z) (ops/scan_iir.py::SosfiltFn), all [n, C] f32:
//
//   out[j]     =  sum_{t, c} g[t, c] * v[t - j, c]    j = 0, 1, 2  (dL/db_j)
//   out[2 + j] = -sum_{t, c} g[t, c] * w[t - j, c]    j = 1, 2     (dL/da_j)
//
// with v[t] = w[t] = 0 for t < 0 (zero initial state). The JAX package has
// no kernel here: its gradient is XLA autodiff through the tile-conv tables
// (ame_tpu/ops/tile_conv.py::_traced_tables); this is the backward of K5.
//
// What bounds it on an H100: bytes. Three [n, C] f32 reads (2^23 x 2:
// 201 MB, 0.060 ms at 3.35 TB/s) against 5 products and 5 double adds a
// sample.
//
// The design, two launches on one stream, no atomics, so a fit gets the
// same gradient on every run:
//
//   1. sos_grad_partials: block b owns the elements [b*TILE, (b+1)*TILE) of
//      the flattened [n*C] index e = t*C + c. It stages v and w for those
//      elements and a halo of the 2C elements before them (lags 1 and 2 of
//      the same channel) in shared memory, with neighbouring threads on
//      neighbouring elements. Each thread forms its products in f32 and
//      adds them in double; a warp-shuffle reduction, then one over the
//      warps in shared memory, gives the block's five partial sums, written
//      to scratch [nblocks, 5].
//   2. sos_grad_final: one block adds the partials in a fixed order (thread
//      i takes partials i, i + 256, ...; then the same two-level reduction)
//      and writes the five doubles.
//
// g, v, w may be column slices of wider tensors: each has its own row
// stride (ldg, ldv, ldw >= C), the column stride is 1.

#include <cuda_runtime.h>

#define THREADS 256
#define PER_THREAD 8
#define TILE (THREADS * PER_THREAD)   // elements a block
#define MAX_C 64                      // halo of 2*MAX_C elements

__device__ __forceinline__ double warp_sum(double a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

// The five sums of a block in acc[] reduced over its threads; thread 0
// holds the result.
__device__ __forceinline__ void block_sum5(double* acc, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 5; ++q) acc[q] = warp_sum(acc[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) red[warp * 5 + q] = acc[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q)
      acc[q] = lane < THREADS / 32 ? red[lane * 5 + q] : 0.0;
#pragma unroll
    for (int q = 0; q < 5; ++q) acc[q] = warp_sum(acc[q]);
  }
}

__global__ void __launch_bounds__(THREADS)
    sos_grad_partials(const float* __restrict__ g, const float* __restrict__ v,
                      const float* __restrict__ w, long long n, int C,
                      long long ldg, long long ldv, long long ldw,
                      double* __restrict__ partials) {
  __shared__ float vs[TILE + 2 * MAX_C];
  __shared__ float ws[TILE + 2 * MAX_C];
  __shared__ double red[THREADS / 32 * 5];
  const long long total = n * C;
  const long long e0 = (long long)blockIdx.x * TILE;
  const int halo = 2 * C;
  // stage v, w for elements e0 - halo .. e0 + TILE - 1 (zero outside)
  for (int i = threadIdx.x; i < TILE + halo; i += THREADS) {
    const long long e = e0 - halo + i;
    float a = 0.f, b = 0.f;
    if (e >= 0 && e < total) {
      const long long t = e / C;
      const int c = (int)(e - t * C);
      a = v[t * ldv + c];
      b = w[t * ldw + c];
    }
    vs[i] = a;
    ws[i] = b;
  }
  __syncthreads();
  double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = r * THREADS + threadIdx.x;   // element e0 + i
    const long long e = e0 + i;
    if (e < total) {
      const long long t = e / C;
      const int c = (int)(e - t * C);
      const float gv = g[t * ldg + c];
      const int h = halo + i;                  // e in the staged arrays
      acc[0] += (double)(gv * vs[h]);
      acc[1] += (double)(gv * vs[h - C]);
      acc[2] += (double)(gv * vs[h - 2 * C]);
      acc[3] += (double)(gv * ws[h - C]);
      acc[4] += (double)(gv * ws[h - 2 * C]);
    }
  }
  block_sum5(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 5; ++q) partials[blockIdx.x * 5 + q] = acc[q];
  }
}

__global__ void __launch_bounds__(THREADS)
    sos_grad_final(const double* __restrict__ partials, long long nblocks,
                   double* __restrict__ out) {
  __shared__ double red[THREADS / 32 * 5];
  double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long b = threadIdx.x; b < nblocks; b += THREADS) {
#pragma unroll
    for (int q = 0; q < 5; ++q) acc[q] += partials[b * 5 + q];
  }
  block_sum5(acc, red);
  if (threadIdx.x == 0) {
    out[0] = acc[0];
    out[1] = acc[1];
    out[2] = acc[2];
    out[3] = -acc[3];
    out[4] = -acc[4];
  }
}

// Number of partial rows (doubles x 5) the scratch must hold for n x C.
extern "C" long long sos_grad_blocks(long long n, int C) {
  return (n * C + TILE - 1) / TILE;
}

// g, v, w: device f32 with row strides ldg, ldv, ldw (elements) and unit
// column stride; scratch: device double [sos_grad_blocks(n, C), 5];
// out: device double [5]. Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for unsupported sizes.
extern "C" int sos_grad_f64(const float* g, const float* v, const float* w,
                            long long n, int C, long long ldg, long long ldv,
                            long long ldw, double* scratch, double* out,
                            void* stream) {
  if (n < 1 || C < 1 || C > MAX_C || ldg < C || ldv < C || ldw < C)
    return (int)cudaErrorInvalidValue;
  const long long nblocks = sos_grad_blocks(n, C);
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  sos_grad_partials<<<(unsigned)nblocks, THREADS, 0, s>>>(
      g, v, w, n, C, ldg, ldv, ldw, scratch);
  sos_grad_final<<<1, THREADS, 0, s>>>(scratch, nblocks, out);
  return (int)cudaGetLastError();
}

extern "C" const char* sos_grad_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
