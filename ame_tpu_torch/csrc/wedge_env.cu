// alimiter wedge envelope: one direction of the ffmpeg-contract limiter's
// gain-depth envelope as a tiled (max, x) scan with parallel carries.
//
// Replaces the Pallas kernel ame_tpu/ops/limiter.py::_wedge_env_kernel
// (driven by _wedge_env). For the P = 6 tangent pieces (a_p, rho_p) of
// limiter.py::_wedge_pieces it computes
//
//   s_p[i] = max(dep[i], rho_p * s_p[i-1]),   s_p[-1] = 0
//   env[i] = min_p a_p * s_p[i]
//
// in processing order i; with REVERSE the processing order runs from the
// last sample to the first (the anticipatory, attack side). On the TPU the
// kernel walks [128, 512] tiles in order on one core and carries each
// piece's state in SMEM. On the card blocks run in parallel and in no
// order, so the carry is a scan of its own.
//
// What bounds it on an H100: bytes. dep is read and env written once per
// direction (2^23 samples: 67 MB, 0.020 ms at 3.35 TB/s); the walk costs
// 2 f32 operations per piece per sample, 4 in the output pass, which is a
// few microseconds at the card's f32 rate once every SM has enough
// independent chains and the loads coalesce. The design, after
// cascade_scan.cu, three launches on one stream:
//
//   1. wedge_ends: a block owns one tile of T = TP*SUB = 8192 samples
//      (32 KB), aligned in memory at a multiple of T. Its 256 threads load
//      the tile with 16-byte loads, neighbouring threads on neighbouring
//      addresses, into shared memory rows of SUB = 32 samples padded by one
//      float, so the 32 walkers of a warp read 32 banks. Each thread walks
//      one row from zero state for all 6 pieces (6 interleaved chains, the
//      state in registers): 2^18 chains at 2^23 samples. In REVERSE the
//      tile is the mirrored one in processing order and each row is walked
//      backwards out of shared memory; the global loads stay forward. The
//      row end values are scanned in (max, x) at log depth: a shuffle scan
//      inside each warp with rho^(SUB*2^l), then each warp folds the totals
//      of the warps before it (at most 7, with rho^(32*SUB)) and lane l
//      adds them with rho^(SUB*(l+1)). It writes the inclusive prefixes S
//      [nb, 6, TP] and the tile totals E [6, nb].
//   2. wedge_carries: one block of 1024 threads scans the tile totals,
//      c_{b+1} = max(E_b, rho^T c_b) from c_0 = 0, 1024 tiles a chunk: a
//      shuffle scan in each warp with rho^(T*2^l), a shuffle scan of the 32
//      warp totals in warp 0 with rho^(32*T*2^l), lane l adding the earlier
//      warps' prefix with rho^(T*(l+1)), and thread 0 folding in the
//      chunk's carry-in with rho^T. It writes every tile's carry C [6, nb].
//   3. wedge_out: each tile is loaded again; each thread starts from
//      max(S_{j-1}, rho^(SUB*j) c_b), re-walks its row, writes env =
//      min_p a_p * s_p over dep in shared memory, and the block stores the
//      tile with coalesced 16-byte stores.
//
// Tiles sit at multiples of T in memory in both directions, so every
// 16-byte access is aligned; samples past n read as 0. Forward, that
// padding ends the last tile, whose total no carry reads. In REVERSE it
// starts processing, where the state is 0 and max(0, rho * 0) keeps it 0
// exactly.
//
// The decay powers are built on the host in float64 from the f32 rho_p the
// walks multiply by, rounded to f32 once and kept on the device per piece
// set (ops/wedge_env.py::_power_table); every entry lies in [0, 1], and a
// power that underflows to 0 is exact under max. (max, x) with rho > 0 is
// exact to re-associate up to the rounding of those powers, so the result
// equals the sequential walk to within a few f32 ulps of each decayed
// term. FMA contraction does not arise (no a*b+c form).
//
// Layouts: dep, env [n]; power table [ROW_W + 5, PW] (a row holds one
// power of the 6 pieces, padded to PW floats); S [nb, 6, TP]; E, C [6, nb].

#include <cuda_runtime.h>

#define PIECES 6
#define PW 8                      // floats per power-table row
#define SUB 32                    // samples per walker thread
#define LOG_TP 8
#define TP (1 << LOG_TP)          // walker threads (rows) per tile
#define TILE (TP * SUB)           // samples per tile
#define RS (SUB + 1)              // padded shared row
#define CARRY_THREADS 1024        // tiles per chunk of the carry scan
// power-table rows: rho^(SUB*j) at row j (j <= TP), rho^(T*k) at ROW_T + k
// (k <= 32), rho^(32*T*2^l) at ROW_W + l (l < 5)
#define ROW_T (TP + 1)
#define ROW_W (ROW_T + 33)
#define FULL 0xffffffffu

struct Pieces {
  float a[PIECES];
  float rho[PIECES];
};

// row r of the power table (6 pieces), as two 16-byte loads
__device__ __forceinline__ void pw_row(const float* pw, int r, float* out) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(pw + r * PW));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(pw + r * PW + 4));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = lo.z;
  out[3] = lo.w;
  out[4] = hi.x;
  out[5] = hi.y;
}

// The tile at t0 in memory: TILE/4 float4s, VPT a thread; float4 e of the
// tile goes to row 4e/SUB, column 4e%SUB of the padded shared tile (a
// warp's 32 stores of one component hit 32 banks).
#define VPT (TILE / 4 / TP)

__device__ __forceinline__ void tile_fetch(float4* v, const float* dep,
                                           long long n, long long t0) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const long long g = t0 + 4LL * (threadIdx.x + i * TP);
    if (g + 4 <= n) {
      v[i] = __ldg(reinterpret_cast<const float4*>(dep + g));
    } else {
      v[i].x = g < n ? dep[g] : 0.f;
      v[i].y = g + 1 < n ? dep[g + 1] : 0.f;
      v[i].z = g + 2 < n ? dep[g + 2] : 0.f;
      v[i].w = 0.f;
    }
  }
}

__device__ __forceinline__ void tile_put(float* tile, const float4* v) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = 4 * (threadIdx.x + i * TP);
    float* d = tile + (e / SUB) * RS + e % SUB;
    d[0] = v[i].x;
    d[1] = v[i].y;
    d[2] = v[i].z;
    d[3] = v[i].w;
  }
}

// processing sub-block j of a tile is memory row j, or TP-1-j walked
// backwards in REVERSE; column i of the walk
template <bool REVERSE>
__device__ __forceinline__ float* walk_row(float* tile, int j) {
  return tile + (REVERSE ? TP - 1 - j : j) * RS;
}

template <bool REVERSE>
__device__ __forceinline__ int walk_col(int i) {
  return REVERSE ? SUB - 1 - i : i;
}

template <bool REVERSE>
__global__ void __launch_bounds__(TP)
    wedge_ends(const float* __restrict__ dep, float* __restrict__ S,
               float* __restrict__ E, const float* __restrict__ pw,
               long long n, long long nb, const __grid_constant__ Pieces pc) {
  __shared__ float tile[TP * RS];
  __shared__ float wt[TP / 32][PIECES];
  const long long mt = blockIdx.x;                 // tile in memory
  const long long b = REVERSE ? nb - 1 - mt : mt;  // tile in processing order
  {
    float4 v[VPT];
    tile_fetch(v, dep, n, mt * TILE);
    tile_put(tile, v);
  }
  __syncthreads();

  const int j = threadIdx.x, lane = j & 31, w = j >> 5;
  const float* row = walk_row<REVERSE>(tile, j);
  float s[PIECES];
#pragma unroll
  for (int p = 0; p < PIECES; ++p) s[p] = 0.f;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const float d = row[walk_col<REVERSE>(i)];
#pragma unroll
    for (int p = 0; p < PIECES; ++p) s[p] = fmaxf(d, pc.rho[p] * s[p]);
  }
  // inclusive scan over the warp's 32 rows: s_j = max(s_j, r^(SUB*off) s_{j-off})
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int off = 1 << l;
    float r[PIECES];
    pw_row(pw, off, r);
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      const float o = __shfl_up_sync(FULL, s[p], off);
      if (lane >= off) s[p] = fmaxf(s[p], r[p] * o);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int p = 0; p < PIECES; ++p) wt[w][p] = s[p];
  }
  __syncthreads();
  if (w > 0) {                       // + the warps before, r^(SUB*(lane+1)) c
    float r32[PIECES], rl[PIECES], c[PIECES];
    pw_row(pw, 32, r32);
    pw_row(pw, lane + 1, rl);
#pragma unroll
    for (int p = 0; p < PIECES; ++p) c[p] = 0.f;
    for (int v = 0; v < w; ++v) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) c[p] = fmaxf(wt[v][p], r32[p] * c[p]);
    }
#pragma unroll
    for (int p = 0; p < PIECES; ++p) s[p] = fmaxf(s[p], rl[p] * c[p]);
  }
#pragma unroll
  for (int p = 0; p < PIECES; ++p) S[(b * PIECES + p) * TP + j] = s[p];
  if (j == TP - 1) {
#pragma unroll
    for (int p = 0; p < PIECES; ++p) E[p * nb + b] = s[p];
  }
}

__global__ void __launch_bounds__(CARRY_THREADS)
    wedge_carries(const float* __restrict__ E, float* __restrict__ C,
                  const float* __restrict__ pw, long long nb) {
  __shared__ float wx[CARRY_THREADS / 32][PIECES];
  __shared__ float cin_s[PIECES];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  float rT[PIECES], rl[PIECES], cin[PIECES];
  pw_row(pw, ROW_T + 1, rT);
  pw_row(pw, ROW_T + lane + 1, rl);
#pragma unroll
  for (int p = 0; p < PIECES; ++p) cin[p] = 0.f;
  for (long long base = 0; base < nb; base += CARRY_THREADS) {
    const long long b = base + t;
    float v[PIECES];                 // the last tile's total carries nowhere
#pragma unroll
    for (int p = 0; p < PIECES; ++p) v[p] = b < nb - 1 ? E[p * nb + b] : 0.f;
    if (t == 0) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) v[p] = fmaxf(v[p], rT[p] * cin[p]);
    }
#pragma unroll
    for (int l = 0; l < 5; ++l) {    // in the warp, r^(T*2^l)
      const int off = 1 << l;
      float r[PIECES];
      pw_row(pw, ROW_T + off, r);
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        const float o = __shfl_up_sync(FULL, v[p], off);
        if (lane >= off) v[p] = fmaxf(v[p], r[p] * o);
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) wx[w][p] = v[p];
    }
    __syncthreads();
    if (w == 0) {                    // the warp totals, r^(32*T*2^l)
      float x[PIECES];
#pragma unroll
      for (int p = 0; p < PIECES; ++p) x[p] = wx[lane][p];
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        const int off = 1 << l;
        float r[PIECES];
        pw_row(pw, ROW_W + l, r);
#pragma unroll
        for (int p = 0; p < PIECES; ++p) {
          const float o = __shfl_up_sync(FULL, x[p], off);
          if (lane >= off) x[p] = fmaxf(x[p], r[p] * o);
        }
      }
#pragma unroll
      for (int p = 0; p < PIECES; ++p) wx[lane][p] = x[p];
    }
    __syncthreads();
    if (w > 0) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        v[p] = fmaxf(v[p], rl[p] * wx[w - 1][p]);
    }
    // v: the state at the end of tile b, the carry into tile b + 1
    if (b + 1 < nb) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) C[p * nb + b + 1] = v[p];
    }
    if (b == 0) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) C[p * nb] = 0.f;
    }
    if (t == CARRY_THREADS - 1) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p) cin_s[p] = v[p];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PIECES; ++p) cin[p] = cin_s[p];
  }
}

template <bool REVERSE>
__global__ void __launch_bounds__(TP)
    wedge_out(const float* __restrict__ dep, const float* __restrict__ S,
              const float* __restrict__ C, float* __restrict__ env,
              const float* __restrict__ pw, long long n, long long nb,
              const __grid_constant__ Pieces pc) {
  __shared__ float tile[TP * RS];
  const long long mt = blockIdx.x;
  const long long b = REVERSE ? nb - 1 - mt : mt;
  const long long t0 = mt * TILE;
  float4 v[VPT];
  tile_fetch(v, dep, n, t0);
  // the start state max(S_{j-1}, r^(SUB*j) c_b) while the tile arrives
  const int j = threadIdx.x;
  float s[PIECES], rj[PIECES];
  pw_row(pw, j, rj);
#pragma unroll
  for (int p = 0; p < PIECES; ++p) {
    const float prev = j > 0 ? S[(b * PIECES + p) * TP + j - 1] : 0.f;
    s[p] = fmaxf(prev, rj[p] * C[p * nb + b]);
  }
  tile_put(tile, v);
  __syncthreads();

  float* row = walk_row<REVERSE>(tile, j);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int k = walk_col<REVERSE>(i);
    const float d = row[k];
    float m = 0.f;
#pragma unroll
    for (int p = 0; p < PIECES; ++p) {
      s[p] = fmaxf(d, pc.rho[p] * s[p]);
      const float e = pc.a[p] * s[p];
      m = p == 0 ? e : fminf(m, e);
    }
    row[k] = m;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = 4 * (threadIdx.x + i * TP);
    const float* q = tile + (e / SUB) * RS + e % SUB;
    const long long g = t0 + e;
    if (g + 4 <= n) {
      *reinterpret_cast<float4*>(env + g) = make_float4(q[0], q[1], q[2], q[3]);
    } else {
      for (int c = 0; c < 3 && g + c < n; ++c) env[g + c] = q[c];
    }
  }
}

template <bool REVERSE>
static void launch(const float* dep, float* env, float* S, float* E,
                   float* C, const float* pw, long long n, long long nb,
                   const Pieces& pc, cudaStream_t s) {
  wedge_ends<REVERSE><<<(unsigned)nb, TP, 0, s>>>(dep, S, E, pw, n, nb, pc);
  wedge_carries<<<1, CARRY_THREADS, 0, s>>>(E, C, pw, nb);
  wedge_out<REVERSE><<<(unsigned)nb, TP, 0, s>>>(dep, S, C, env, pw, n, nb,
                                                 pc);
}

// host_params (float32): a[6], rho[6]. powers (device): [ROW_W + 5, PW], the
// table of ops/wedge_env.py::_power_table for (sub, logp) = (SUB, LOG_TP).
// Scratch (device): S [nb, 6, TP], E and C [6, nb], nb = ceil(n / TILE).
// dep and env must be 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for unsupported
// arguments.
extern "C" int wedge_env_f32(const float* dep, float* env, float* S, float* E,
                             float* C, const float* powers, long long n,
                             int np, int sub, int logp, int reverse,
                             const float* host_params, void* stream) {
  if (np != PIECES || sub != SUB || logp != LOG_TP || n < 1 ||
      (size_t)dep % 16 != 0 || (size_t)env % 16 != 0 ||
      (size_t)powers % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Pieces pc;
  for (int p = 0; p < PIECES; ++p) {
    pc.a[p] = host_params[p];
    pc.rho[p] = host_params[PIECES + p];
  }
  const long long nb = (n + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    launch<true>(dep, env, S, E, C, powers, n, nb, pc, s);
  else
    launch<false>(dep, env, S, E, C, powers, n, nb, pc, s);
  return (int)cudaGetLastError();
}

extern "C" const char* wedge_env_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
