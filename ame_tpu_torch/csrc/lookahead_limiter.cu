// Quality lookahead limiter: the whole gain path and its product in one
// kernel.
//
// Replaces no Pallas kernel: ame_tpu/ops/limiter.py::_limiter_jit is plain
// jnp, which XLA fuses on the TPU. The port ran it as plain PyTorch (about
// a hundred launches a track: pads, cats, two cummins, a banded einsum and
// a blocked Kogge-Stone release scan), the largest stage on the card; this
// kernel computes the same function from x [n, C] float32:
//
//   peak[i] = max_c |x[i, c]|
//   g_t[i]  = min(1, ceiling / max(peak[i], 1e-9))
//   g_a[i]  = min g_t[i .. min(i + w - 1, n - 1)]
//   g_r[i]  = mean g_a[max(0, i - w + 1) .. i]   (divided by the true count)
//   u[i]    = max(1 - g_r[i], rho * u[i - 1]),   u[-1] = 0
//   gain[i] = 1 - u[i],   y[i, c] = x[i, c] * gain[i]
//
// What bounds it on an H100: bytes. x is read once and y written once, 8·n·C
// bytes (16·n at C = 2: the cells' mean track of 9.70 M frames moves 155 MB,
// 46 us at 3.35 TB/s). A frame's gain depends on g_t over [i - w + 1,
// i + w - 1] and on every earlier frame through the release. The design
// touches x as few times as that allows, in one launch:
//
//   - A block takes the next tile of TILE = 4096 frames from an atomic
//     counter (so every tile before it has started), reads the tile and a
//     halo of w - 1 frames on each side (10.7 % more at w = 220, mostly L2
//     hits: the neighbours read the same halos), and builds in shared
//     memory g_t, then g_a by doubling (min over 2^j frames, log2 w passes,
//     exact in any order), then the prefix sums of g_a in float64 (a
//     window's sum is a difference of two, exact enough that the mean is
//     the correctly rounded float32 of the true mean up to ~1e-12), then
//     d = 1 - g_r.
//   - Each of 512 threads walks 8 frames of d from zero state; the chunk
//     ends are scanned in (max, x) at log depth (a shuffle scan in each
//     warp with rho^(8·2^l), the warps folded with rho^256), which gives
//     the tile's release from zero state.
//   - The tile's last value is its aggregate. The block publishes it and
//     looks back (decoupled look-back): warp 0 reads 32 predecessors'
//     status words at a time, folds their aggregates with rho^(TILE·d)
//     until it meets one that has published its inclusive state, and
//     publishes its own, max(aggregate, rho^TILE · carry). Every tile before
//     it has started, so the look-back waits only on running blocks and at
//     most 4 · SMs tiles are unfinished: the walk back is shorter than the
//     LOOKBACK rows of the power table.
//   - u[i] = max(u_tile[i], rho^(i + 1) · carry); the block writes y and,
//     if asked, the gain, re-reading its tile of x (from L2).
//
// Shared memory: two float buffers of the halo'd region and the float64
// sums, 70.8 KB a block at w = 220 (three blocks an SM), 164 KB at MAX_W.
//
// Status words: one 64-bit word a tile, (flag << 32) | float bits of the
// value, flag 1 = aggregate, 2 = inclusive; the word after the last tile
// holds the tile counter. lookahead_limiter_f32 zeroes them on the stream
// before the launch (a memset node under a graph capture).
//
// The decay powers are built on the host in float64 from the f32 rho the
// walks multiply by, rounded to f32 once and kept on the device per rho
// (ops/limiter.py::_limiter_power_table): rho^j at row j for j <= TILE,
// then rho^(TILE·d) at row TILE + 1 + d for d < LOOKBACK. (max, x) with
// rho > 0 re-associates up to the rounding of those powers, so u equals the
// sequential walk to within a few f32 ulps of each decayed term; no a*b+c
// form arises, so FMA contraction does not either.
//
// Layouts: x, y [n, C] contiguous, gain [n] (or null), status [tiles + 1]
// 64-bit words, powers [TILE + 1 + LOOKBACK].

#include <cuda_runtime.h>

#define TILE 4096          // frames a tile (a block)
#define THREADS 512        // threads a block
#define CHUNK (TILE / THREADS)   // frames a thread walks: 8
#define NW (THREADS / 32)  // warps a block
#define MAX_W 4096         // the largest attack window
#define LOOKBACK 2048      // rho^(TILE·d) rows, d < LOOKBACK
#define FULL 0xffffffffu
#define FLAG_A 1ull
#define FLAG_P 2ull
#define SPIN_LIMIT (1u << 22)   // polls (seconds): no look-back waits so long

// float buffers of the region: g_t over TILE + 2(w - 1) frames, or the
// padded tile (one float in 33 spare, so a thread's 8 frames sit on 8 banks)
__host__ __device__ __forceinline__ int region_floats(int w) {
  int g = TILE + 2 * (w - 1);
  const int padded = TILE + TILE / 32;
  if (g < padded) g = padded;
  return (g + 3) & ~3;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int w) {
  // two float buffers, then the float64 prefix sums over TILE + w - 1
  return 2 * sizeof(float) * (size_t)region_floats(w)
         + sizeof(double) * (size_t)(TILE + w - 1);
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <int CT>
__device__ __forceinline__ float frame_peak(const float* __restrict__ x,
                                            long long f, int c) {
  if (CT == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(x) + f);
    return fmaxf(fabsf(v.x), fabsf(v.y));
  }
  if (CT == 1) return fabsf(__ldg(x + f));
  const float* p = x + f * c;
  float m = fabsf(__ldg(p));
  for (int k = 1; k < c; ++k) m = fmaxf(m, fabsf(__ldg(p + k)));
  return m;
}

template <int CT>
__device__ __forceinline__ void frame_out(const float* __restrict__ x,
                                          float* __restrict__ y, long long f,
                                          int c, float g) {
  if (CT == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(x) + f);
    reinterpret_cast<float2*>(y)[f] = make_float2(v.x * g, v.y * g);
    return;
  }
  if (CT == 1) {
    y[f] = __ldg(x + f) * g;
    return;
  }
  for (int k = 0; k < c; ++k) y[f * c + k] = __ldg(x + f * c + k) * g;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag, float v) {
  atomicExch(p, (flag << 32) | __float_as_uint(v));
}

template <int CT>
__global__ void __launch_bounds__(THREADS)
    lookahead_limiter_kernel(const float* __restrict__ x,
                             float* __restrict__ y, float* __restrict__ gain,
                             unsigned long long* status,
                             const float* __restrict__ pw, long long n, int c,
                             int w, float ceiling, float rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long tile_s;
  __shared__ double wsum[NW];
  __shared__ float wtot[NW];
  __shared__ float agg_s, carry_s;

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (tid == 0)
    tile_s = atomicAdd(reinterpret_cast<unsigned long long*>(status + ntiles),
                       1ull);
  __syncthreads();
  const long long t = tile_s;
  const long long s = t * TILE;
  const long long r0 = s - (w - 1);        // the frame at region index 0
  const int G = TILE + 2 * (w - 1);        // g_t's frames
  const int R = TILE + w - 1;              // g_a's frames (the mean's window)
  const int GA = region_floats(w);
  float* src = reinterpret_cast<float*>(smem);
  float* dst = src + GA;
  double* P = reinterpret_cast<double*>(dst + GA);

  // 1. g_t over the region; frames past the end read 1, which leaves every
  //    clipped window's min unchanged (g_t <= 1)
#pragma unroll 4
  for (int r = tid; r < G; r += THREADS) {
    const long long f = r0 + r;
    float g = 1.f;
    if (f >= 0 && f < n)
      g = fminf(1.f, __fdiv_rn(ceiling, fmaxf(frame_peak<CT>(x, f, c),
                                              1e-9f)));
    src[r] = g;
  }
  __syncthreads();

  // 2. g_a: min over 2^j frames by doubling, valid for r < G - 2^j + 1,
  //    then two overlapping spans of the largest 2^j <= w
  int span = 1;
  while (2 * span <= w) {
    const int lim = G - 2 * span + 1;
    for (int r = tid; r < lim; r += THREADS)
      dst[r] = fminf(src[r], src[r + span]);
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
    span *= 2;
  }
  for (int r = tid; r < R; r += THREADS)
    dst[r] = fminf(src[r], src[r + w - span]);
  __syncthreads();
  const float* ga = dst;
  float* tb = src;                         // the padded tile from here on

  // 3. P[q] = sum of g_a over region [0, q] in float64 (frames < 0 add 0):
  //    warp wid owns rows of 32 in [q0, q1); its total first, then a shuffle
  //    scan of each row from the totals of the warps before it
  {
    const int rows = (R + 31) >> 5;
    const int rpw = (rows + NW - 1) / NW;
    const int q0 = min(R, wid * rpw * 32), q1 = min(R, q0 + rpw * 32);
    double acc = 0.0;
    for (int q = q0 + lane; q < q1; q += 32)
      acc += r0 + q >= 0 ? (double)ga[q] : 0.0;
    acc = warp_sum(acc);
    if (lane == 0) wsum[wid] = acc;
    __syncthreads();
    double carry = 0.0;
    for (int v = 0; v < wid; ++v) carry += wsum[v];
    for (int base = q0; base < q1; base += 32) {
      const int q = base + lane;
      double v = q < q1 && r0 + q >= 0 ? (double)ga[q] : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += o;
      }
      v += carry;
      if (q < q1) P[q] = v;
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();

  // 4. d[i] = 1 - g_r[s + i]: the window [s + i - w + 1, s + i] is region
  //    [i, i + w - 1], start-clipped by the zeros before frame 0
  for (int i = tid; i < TILE; i += THREADS) {
    const long long f = s + i;
    const double sum = P[i + w - 1] - (i > 0 ? P[i - 1] : 0.0);
    const int count = f + 1 < w ? (int)(f + 1) : w;
    tb[pad(i)] = 1.f - (float)(sum / (double)count);
  }
  __syncthreads();

  // 5. the release from zero state: each thread walks its 8 frames, then
  //    the chunk ends are scanned across the block
  float u[CHUNK];
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    e = fmaxf(tb[pad(CHUNK * tid + k)], __fmul_rn(rho, e));
    u[k] = e;
  }
  float v = e;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int off = 1 << l;
    const float o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = fmaxf(v, __fmul_rn(__ldg(pw + CHUNK * off), o));
  }
  if (lane == 31) wtot[wid] = v;
  __syncthreads();
  float cw = 0.f;                          // the state before this warp
  for (int k = 0; k < wid; ++k)
    cw = fmaxf(wtot[k], __fmul_rn(__ldg(pw + 32 * CHUNK), cw));
  v = fmaxf(v, __fmul_rn(__ldg(pw + CHUNK * (lane + 1)), cw));
  float cin = __shfl_up_sync(FULL, v, 1);  // the state before this thread
  if (lane == 0) cin = cw;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k)
    u[k] = fmaxf(u[k], __fmul_rn(__ldg(pw + k + 1), cin));

  // 6. publish the tile's aggregate, look back for its carry-in
  if (tid == THREADS - 1) {
    agg_s = u[CHUNK - 1];
    publish(status + t, t == 0 ? FLAG_P : FLAG_A, u[CHUNK - 1]);
  }
  __syncthreads();
  if (wid == 0) {
    float carry = 0.f;
    if (t > 0) {
      const float* pwt = pw + TILE + 1;    // rho^(TILE·d)
      long long j0 = t - 1;
      int d0 = 0;
      for (;;) {
        const long long j = j0 - lane;
        unsigned long long word = FLAG_P << 32;    // before tile 0: state 0
        if (j >= 0) {
          // every tile before this one has started, so each wait ends;
          // one that did not would trap (a fault the caller sees) rather
          // than hang the card
          for (unsigned spins = 0;; ++spins) {
            word = read_status(status + j);
            if ((word >> 32) != 0) break;
            if (spins > SPIN_LIMIT) __trap();
            __nanosleep(64);
          }
        }
        const unsigned done = __ballot_sync(FULL, (word >> 32) == FLAG_P);
        const int stop = done ? __ffs(done) - 1 : 31;
        float term = 0.f;
        if (j >= 0 && lane <= stop)
          term = __fmul_rn(__ldg(pwt + d0 + lane),
                           __uint_as_float((unsigned)word));
        carry = fmaxf(carry, warp_max(term));
        if (done) break;
        j0 -= 32;
        d0 += 32;
      }
      if (lane == 0)
        publish(status + t, FLAG_P,
                fmaxf(agg_s, __fmul_rn(__ldg(pw + TILE), carry)));
    }
    if (lane == 0) carry_s = carry;
  }
  __syncthreads();

  // 7. gain = 1 - max(u, rho^(i + 1) carry), then y = x * gain
  const float carry = carry_s;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const int i = CHUNK * tid + k;
    tb[pad(i)] = 1.f - fmaxf(u[k], __fmul_rn(__ldg(pw + i + 1), carry));
  }
  __syncthreads();
  const int nv = (int)(n - s < TILE ? n - s : TILE);
#pragma unroll 4
  for (int i = tid; i < nv; i += THREADS) {
    const float g = tb[pad(i)];
    frame_out<CT>(x, y, s + i, c, g);
    if (gain) gain[s + i] = g;
  }
}

template <int CT>
static int launch(const float* x, float* y, float* gain,
                  unsigned long long* status, const float* pw, long long n,
                  int c, int w, float ceiling, float rho, cudaStream_t st) {
  // always the largest size, so that concurrent callers never lower it
  cudaError_t err = cudaFuncSetAttribute(
      lookahead_limiter_kernel<CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_W));
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (n + TILE - 1) / TILE;
  lookahead_limiter_kernel<CT><<<(unsigned)ntiles, THREADS, smem_bytes(w),
                                 st>>>(x, y, gain, status, pw, n, c, w,
                                       ceiling, rho);
  return (int)cudaGetLastError();
}

// status (device): tiles + 1 64-bit words, zeroed here on the stream;
// powers (device): [TILE + 1 + LOOKBACK], ops/limiter.py::
// _limiter_power_table for rho. gain may be null. x must be 8-byte aligned
// at c = 2. Returns 0 on success, a CUDA error code otherwise, or
// cudaErrorInvalidValue for unsupported arguments.
extern "C" int lookahead_limiter_f32(const float* x, float* y, float* gain,
                                     unsigned long long* status,
                                     const float* powers, long long n, int c,
                                     int w, float ceiling, float rho,
                                     void* stream) {
  if (n < 1 || c < 1 || w < 1 || w > MAX_W || (c == 2 && (size_t)x % 8) ||
      (c == 2 && (size_t)y % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (size_t)(ntiles + 1), st);
  if (err != cudaSuccess) return (int)err;
  if (c == 2)
    return launch<2>(x, y, gain, status, powers, n, c, w, ceiling, rho, st);
  if (c == 1)
    return launch<1>(x, y, gain, status, powers, n, c, w, ceiling, rho, st);
  return launch<0>(x, y, gain, status, powers, n, c, w, ceiling, rho, st);
}

// the kernel's geometry, for the wrapper's checks
extern "C" int lookahead_limiter_tile(void) { return TILE; }
extern "C" int lookahead_limiter_max_w(void) { return MAX_W; }
extern "C" int lookahead_limiter_lookback(void) { return LOOKBACK; }

extern "C" const char* lookahead_limiter_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
