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
//     sweep. Its reset route (template RESETS, the chunked compat path,
//     _jac_kernel with has_resets=True) also sets a lane's state to 0 at
//     every flagged 32-sample group start; the flags are one float a
//     group, [npad/32], shared by the chains (+1/32 of one chain's bytes;
//     a per-sample plane would add 1/G), and ride the ring with m. The
//     unchunked route is the RESETS=false instantiation, unchanged.
//
// What bounds them on an H100 (gain_p1 and gain_p2: below):
//   gain_jacobi reads m once and writes its output once; the
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
// gain_p1 walks each chain in order, zeroes the state at flagged group
// starts (resets may be null) and writes the state before every 32-sample
// group: starts [G, ceil(N/32)]; the ragged last group needs no walk, its
// start state is all pass 2 reads. The walk is serial by nature: pass 1
// runs exactly where the Jacobi relaxation has stalled, and the pinned
// rounding admits no other exact parallel form. So what bounds it on an
// H100 is the dependent chain of one step (add, min, predicated max: ~17
// cycles), N steps a chain, not its 0.031 ms of bytes at [3, 2^23];
// gain_floor below measures that chain alone. The design keeps everything
// but the chain off the walking thread: one block per chain; warp 1 (the
// producer) streams the chain's m and reset flags into a ring of
// P1_STAGES shared-memory stages of P1_STAGE samples with coalesced loads
// and signals each stage full on an mbarrier; thread 0 of warp 0 (the
// walker) loads each group's 32 values of m from the ring into registers
// one group ahead of the chain (two register sets, ping-pong), runs the
// chain, writes each group's start into the stage and signals the stage
// empty; the producer stores the starts of a freed stage with coalesced
// stores before it refills the stage. The walker's loop holds no global
// access; its products m*ia, m*ir (the same __fmul_rn as the other
// kernels) are off the chain. Samples past n are zero-filled and never
// walked. (Products formed by the producer and kept in the ring cost the
// walker 96 registers of prefetch instead of 32, and the compiler then
// delays the next group's loads until the chain needs them: slower.)
//
// gain_p2 re-runs every 32-sample group from its pass-1 start state and
// writes att [G, N]. The TPU transposed [512, 32] tiles on the MXU to put
// groups on lanes; here a thread walks a group, and shared memory does the
// transpose. It moves 2 * 4 * G * N bytes plus the starts, and the walks
// (32 steps, ~550 cycles a group, 2^18 groups a chain) hide behind the
// loads, so bytes bound it: 0.061 ms at [3, 2^23] (3.35 TB/s). What
// reaches that is the access pattern. A block owns a tile of P2_TG
// consecutive groups of one chain (grid: tiles x chains, so no thread
// divides an index); the tile's m arrives with coalesced cp.async copies
// into shared memory, thread r walks group r there from its start (one
// coalesced load of the starts), writes att over m in place, and the block
// stores the tile coalesced. Group r's row of 32 floats holds its 16-byte
// chunk c at chunk c ^ (r & 7) (p2_swz): the walker's 128-bit loads and
// stores then hit 8 different chunks in each quarter-warp phase, and the
// copies' and stores' rows stay conflict-free too (a [P2_TG][32] layout
// would put lane r's sample j of every group in one bank: 32-way
// conflicts). Rows of chain g start at float g * N, so 16-byte copies need
// N % 4 == 0 and aligned bases (VEC); any other input takes the 4-byte
// route of the same kernel (a warp still moves 128 contiguous bytes).
// Samples past N are zero-filled (the walk needs no mask: m == 0 leaves
// the state unchanged) and their stores are masked. One block a tile: the
// resident blocks of an SM overlap one tile's loads with another's walk.

#include <cuda_runtime.h>

#define GROUP 32

__device__ __forceinline__ float gain_update(float att, float m, float ia,
                                             float ir) {
  const float up = fminf(__fadd_rn(att, __fmul_rn(m, ia)), m);
  const float dn = fmaxf(__fsub_rn(att, __fmul_rn(m, ir)), 0.f);
  return att <= m ? up : dn;
}

#define P1_STAGE 1024                  // samples per ring stage
#define P1_STAGES 16                   // stages in the ring
#define P1_GPS (P1_STAGE / GROUP)      // groups per stage (one per lane)
#define P1_THREADS 64                  // warp 0 walks, warp 1 produces

struct P1Ring {
  float m[P1_STAGES][P1_STAGE];
  float reset[P1_STAGES][P1_GPS];
  float start[P1_STAGES][P1_GPS];
  unsigned long long full[P1_STAGES];   // mbarriers: producer -> walker
  unsigned long long empty[P1_STAGES];  // walker -> producer
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// group q's 32 values of m out of its stage, 16 bytes a load, and its
// reset flag
__device__ __forceinline__ float p1_fetch(const P1Ring& R, int q, float* v) {
  const int s = (q / P1_GPS) % P1_STAGES, o = q % P1_GPS;
#pragma unroll
  for (int j = 0; j < GROUP; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(&R.m[s][o * GROUP + j]);
    v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
  }
  return R.reset[s][o];
}

// The walker (thread 0). It waits for stage k + 1 before it walks stage k,
// so every group's body (the next group's m and flag out of the ring, its
// reset, its start, its 32 steps) is one block without a branch, which
// the compiler interleaves: the loads and the products m*ia, m*ir issue
// between the steps of the chain.
template <bool RESETS>
__device__ __forceinline__ void p1_walk(P1Ring& R, float att, int ng,
                                        int nfull, int nst, float ia,
                                        float ir) {
  float v0[GROUP], v1[GROUP];
  float f0 = 0.f, f1 = 0.f;
  mbar_wait(&R.full[0], 0);
  if (nfull > 0) f0 = p1_fetch(R, 0, v0);
  // group q from (v, f); the next group's into (vn, fn) (after the last
  // group, its own again: unused)
  auto group = [&](int q, const float* v, float f, float* vn, float& fn) {
    fn = p1_fetch(R, q + 1 < nfull ? q + 1 : q, vn);
    const int s = (q / P1_GPS) % P1_STAGES, o = q % P1_GPS;
    if (RESETS && f != 0.f) att = 0.f;
    R.start[s][o] = att;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) att = gain_update(att, v[j], ia, ir);
  };
  for (int k = 0; k < nst; ++k) {
    if (k + 1 < nst)
      mbar_wait(&R.full[(k + 1) % P1_STAGES], ((k + 1) / P1_STAGES) & 1);
    const int q1 = min((k + 1) * P1_GPS, nfull);
    for (int q = k * P1_GPS; q < q1; q += 2) {
      group(q, v0, f0, v1, f1);
      if (q + 1 < q1) group(q + 1, v1, f1, v0, f0);
    }
    if (nfull < ng && nfull / P1_GPS == k) {   // the ragged last group
      const int s = k % P1_STAGES, o = nfull % P1_GPS;
      if (RESETS && R.reset[s][o] != 0.f) att = 0.f;
      R.start[s][o] = att;
    }
    mbar_arrive(&R.empty[k % P1_STAGES]);
  }
}

__global__ void __launch_bounds__(P1_THREADS)
    gain_p1(const float* __restrict__ m, const float* __restrict__ resets,
            const float* __restrict__ init, float* __restrict__ starts,
            long long n, int G, float ia, float ir) {
  extern __shared__ __align__(16) unsigned char p1_smem[];
  P1Ring& R = *reinterpret_cast<P1Ring*>(p1_smem);
  const int g = blockIdx.x;
  const float* mg = m + (long long)g * n;
  const long long ng = (n + GROUP - 1) / GROUP;
  const long long nfull = n / GROUP;  // groups of a full 32 samples
  const long long nst = (ng + P1_GPS - 1) / P1_GPS;
  float* sg = starts + (long long)g * ng;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P1_STAGES; ++s) {
      mbar_init(&R.full[s], 32);   // every producer lane arrives
      mbar_init(&R.empty[s], 1);   // the walker arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // ---- producer: warp 1, a stage of P1_STAGE samples per round --------
    const int lane = threadIdx.x - 32;
    for (long long k = 0; k < nst; ++k) {
      const int s = (int)(k % P1_STAGES);
      const unsigned ph = (unsigned)((k / P1_STAGES) & 1);
      mbar_wait(&R.empty[s], ph ^ 1);        // the first round passes
      if (k >= P1_STAGES) {                  // the freed stage's starts
        const long long q = (k - P1_STAGES) * P1_GPS + lane;
        if (q < ng) sg[q] = R.start[s][lane];
      }
      const long long t0 = k * P1_STAGE;
      float v[P1_STAGE / 32];
#pragma unroll
      for (int i = 0; i < P1_STAGE / 32; ++i) {
        const long long t = t0 + lane + 32 * i;
        v[i] = t < n ? mg[t] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < P1_STAGE / 32; ++i) R.m[s][lane + 32 * i] = v[i];
      const long long q = k * P1_GPS + lane;
      R.reset[s][lane] = (resets != nullptr && q < ng) ? resets[q] : 0.f;
      mbar_arrive(&R.full[s]);
    }
    // the starts of the stages still in the ring, once the walker is done
    for (long long k = nst > P1_STAGES ? nst - P1_STAGES : 0; k < nst; ++k) {
      const int s = (int)(k % P1_STAGES);
      mbar_wait(&R.empty[s], (unsigned)((k / P1_STAGES) & 1));
      const long long q = k * P1_GPS + lane;
      if (q < ng) sg[q] = R.start[s][lane];
    }
  } else if (threadIdx.x == 0) {
    if (resets != nullptr)
      p1_walk<true>(R, init[g], (int)ng, (int)nfull, (int)nst, ia, ir);
    else
      p1_walk<false>(R, init[g], (int)ng, (int)nfull, (int)nst, ia, ir);
  }
}

// The floor under gain_p1: the same step, N steps a chain, over 32 values
// of m from the middle of the chain held in registers (their products are
// formed once, outside the loop), no memory traffic in the loop. One
// thread per chain; out [G] keeps the final states so the walk is not
// optimised away.
__global__ void gain_floor(const float* __restrict__ m, float* __restrict__ out,
                           long long n, float ia, float ir) {
  if (threadIdx.x != 0) return;
  const int g = blockIdx.x;
  const long long t0 = n / 2 / GROUP * GROUP;
  float v[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j)
    v[j] = t0 + j < n ? m[(long long)g * n + t0 + j] : 0.f;
  float att = 0.f;
  for (long long k = 0; k < n / GROUP; ++k) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) att = gain_update(att, v[j], ia, ir);
  }
  out[g] = att;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

#define P2_TG 128                    // groups a tile = threads a block
#define P2_TILE (P2_TG * GROUP)      // samples a tile (16 KB)

// where sample j of group r sits in a tile: chunk j/4 of the group's row
// at chunk (j/4) ^ (r & 7)
__device__ __forceinline__ int p2_swz(int r, int j) {
  return r * GROUP + ((((j >> 2) ^ r) & 7) << 2) + (j & 3);
}

// the tile at mt (its first sample; lim of its samples lie before n) into
// st, zero past lim: 16-byte copies (VEC), else 4-byte ones; a
// quarter-warp's 16-byte copies (or a warp's 4-byte ones) fill one group's
// row. Offsets are 32-bit from the tile's base, so the copies of a thread
// share one 64-bit address.
template <bool VEC>
__device__ __forceinline__ void p2_load(float* st, const float* mt, int lim) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < P2_TILE / 4 / P2_TG; ++i) {
      const int c = threadIdx.x + P2_TG * i;
      const bool v = 4 * c < lim;
      cp_async16(st + p2_swz(c >> 3, 4 * (c & 7)), mt + (v ? 4 * c : 0), v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P2_TILE / P2_TG; ++i) {
      const int e = threadIdx.x + P2_TG * i;
      const bool v = e < lim;
      cp_async4(st + p2_swz(e >> 5, e & 31), mt + (v ? e : 0), v);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the tile st (holding att) to ot, its first lim samples
template <bool VEC>
__device__ __forceinline__ void p2_store(const float* st, float* ot, int lim) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < P2_TILE / 4 / P2_TG; ++i) {
      const int c = threadIdx.x + P2_TG * i;
      if (4 * c < lim)
        *reinterpret_cast<float4*>(ot + 4 * c) =
            *reinterpret_cast<const float4*>(st + p2_swz(c >> 3, 4 * (c & 7)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < P2_TILE / P2_TG; ++i) {
      const int e = threadIdx.x + P2_TG * i;
      if (e < lim) ot[e] = st[p2_swz(e >> 5, e & 31)];
    }
  }
}

// thread r walks group r of the tile from att, writing att over m
__device__ __forceinline__ void p2_walk(float* st, float att, float ia,
                                        float ir) {
  const int r = threadIdx.x;
  float4 v[GROUP / 4];
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q)
    v[q] = *reinterpret_cast<const float4*>(st + p2_swz(r, 4 * q));
#pragma unroll
  for (int q = 0; q < GROUP / 4; ++q) {
    att = gain_update(att, v[q].x, ia, ir);
    v[q].x = att;
    att = gain_update(att, v[q].y, ia, ir);
    v[q].y = att;
    att = gain_update(att, v[q].z, ia, ir);
    v[q].z = att;
    att = gain_update(att, v[q].w, ia, ir);
    v[q].w = att;
    *reinterpret_cast<float4*>(st + p2_swz(r, 4 * q)) = v[q];
  }
}

// blockIdx.y: the chain; blockIdx.x: the tile
template <bool VEC>
__global__ void __launch_bounds__(P2_TG)
    gain_p2(const float* __restrict__ m, const float* __restrict__ starts,
            float* __restrict__ att_out, long long n, float ia, float ir) {
  __shared__ __align__(16) float st[P2_TILE];
  const long long ng = (n + GROUP - 1) / GROUP;
  const long long g = blockIdx.y, t0 = (long long)blockIdx.x * P2_TILE;
  const long long left = n - t0;
  const int lim = left < P2_TILE ? (int)left : P2_TILE;   // samples before n
  p2_load<VEC>(st, m + g * n + t0, lim);
  const long long q = (long long)blockIdx.x * P2_TG + threadIdx.x;
  const float a0 = q < ng ? starts[g * ng + q] : 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();         // the tile has landed
  p2_walk(st, a0, ia, ir);
  __syncthreads();         // the tile holds att
  p2_store<VEC>(st, att_out + g * n + t0, lim);
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

// The reset route (RESETS): flags [S * seg_len / 32], one 0/1 value for
// every 32-sample group of the padded chain, shared by the G chains. Lane l
// is segment s = l % S, whose row t is sample s * seg_len + t, so its group
// starts are the rows t = phi + 32 j with phi = -s * seg_len mod 32 (a
// segment need not start on a group: seg_len = npad / S is any multiple of
// 8). A stage starts on a multiple of 32 rows and holds ROWS / 32 of them;
// the lane's flags for those starts (consecutive in the array) arrive with
// the stage's m, one 4-byte cp.async each, zero past seg_len.
template <int JAC_ROWS>
__device__ __forceinline__ void jac_load_flags(float* fl,
                                               const float* resets,
                                               long long t0, long long q0,
                                               int phi, long long seg_len,
                                               bool lane_ok) {
#pragma unroll
  for (int j = 0; j < JAC_ROWS / GROUP; ++j) {
    const bool v = lane_ok && t0 + phi + GROUP * j < seg_len;
    cp_async4(fl + j * JAC_LANES + threadIdx.x,
              v ? resets + q0 + t0 / GROUP + j : resets, v);
  }
}

// One stage of rows st [JAC_ROWS][JAC_LANES] walked by this lane from att
// (att written over m when FULL). CHECK: the state is set to +0 before the
// update at row phi + 32 j where the lane's flag j in fl is set (the
// reference multiplies by 1 - r: the same value, att >= 0).
template <bool FULL, bool CHECK, int JAC_ROWS>
__device__ __forceinline__ float jac_walk(float* st, float att, float ia,
                                          float ir, int phi, const float* fl) {
#pragma unroll
  for (int r = 0; r < JAC_ROWS; ++r) {
    if (CHECK && (r & (GROUP - 1)) == phi &&
        fl[(r / GROUP) * JAC_LANES + threadIdx.x] != 0.f)
      att = 0.f;
    att = gain_update(att, st[r * JAC_LANES + threadIdx.x], ia, ir);
    if (FULL) st[r * JAC_LANES + threadIdx.x] = att;
  }
  return att;
}

template <bool FULL, bool RESETS>
__global__ void __launch_bounds__(JAC_LANES)
    gain_jacobi(const float* __restrict__ m_t,
                const float* __restrict__ carry_in,
                float* __restrict__ carry_out, float* __restrict__ att_t,
                long long seg_len, int lanes, float ia, float ir,
                const float* __restrict__ resets, int S) {
  constexpr int JAC_ROWS = JacRing<FULL>::ROWS;
  constexpr int JAC_STAGES = JacRing<FULL>::STAGES;
  static_assert(JAC_ROWS % GROUP == 0, "a stage holds whole groups");
  __shared__ __align__(16) float ring[JAC_STAGES][JAC_ROWS * JAC_LANES];
  // the flags of the lanes' group starts, a stage each (1 float unused
  // without resets)
  __shared__ float fring[RESETS ? JAC_STAGES : 1]
                        [RESETS ? JAC_ROWS / GROUP * JAC_LANES : 1];
  const int l0 = blockIdx.x * JAC_LANES, s = l0 + threadIdx.x;
  const long long nst = (seg_len + JAC_ROWS - 1) / JAC_ROWS;
  int phi = 0;
  long long q0 = 0;   // flag index of the lane's first group start
  if constexpr (RESETS) {
    const long long a = (long long)(s % S) * seg_len;
    phi = (int)((GROUP - a % GROUP) % GROUP);
    q0 = (a + phi) / GROUP;
  }
  for (int k = 0; k < JAC_STAGES - 1; ++k) {
    if (k < nst) {
      if constexpr (RESETS)
        jac_load_flags<JAC_ROWS>(fring[k], resets, (long long)k * JAC_ROWS,
                                 q0, phi, seg_len, s < lanes);
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
      if constexpr (RESETS)
        jac_load_flags<JAC_ROWS>(fring[kn % JAC_STAGES], resets,
                                 kn * JAC_ROWS, q0, phi, seg_len, s < lanes);
      jac_load<JAC_ROWS>(ring[kn % JAC_STAGES], m_t, kn * JAC_ROWS,
                         seg_len, l0, lanes);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    float* st = ring[k % JAC_STAGES];
    if constexpr (RESETS) {
      // a flagged group starts in this stage (rarely): the checked walk
      const float* fl = fring[k % JAC_STAGES];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < JAC_ROWS / GROUP; ++j)
        hit |= fl[j * JAC_LANES + threadIdx.x] != 0.f;
      if (hit)
        att = jac_walk<FULL, true, JAC_ROWS>(st, att, ia, ir, phi, fl);
      else
        att = jac_walk<FULL, false, JAC_ROWS>(st, att, ia, ir, 0, nullptr);
    } else {
      // the unchunked route keeps its own loop: jac_walk<FULL, false> here
      // builds the full sweep with 131 registers instead of 125 (sm_90a)
#pragma unroll
      for (int r = 0; r < JAC_ROWS; ++r) {
        att = gain_update(att, st[r * JAC_LANES + threadIdx.x], ia, ir);
        if (FULL) st[r * JAC_LANES + threadIdx.x] = att;
      }
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
// starts [G, ceil(n/32)]. stage, stages: the ring geometry the caller
// assumes (ops/pydub_gain.py::_p1_ring), checked against this build's.
extern "C" int gain_p1_f32(const float* m, const float* resets,
                           const float* init, float* starts, long long n,
                           int G, int stage, int stages, float ia, float ir,
                           void* stream) {
  if (n < 1 || n > (1LL << 35) || G < 1 || stage != P1_STAGE ||
      stages != P1_STAGES)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;        // dynamic shared memory allowed
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gain_p1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(P1Ring));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  gain_p1<<<G, P1_THREADS, sizeof(P1Ring), (cudaStream_t)stream>>>(
      m, resets, init, starts, n, G, ia, ir);
  return (int)cudaGetLastError();
}

// m [G, n]; out [G]: the state after n - n % 32 steps over 32 samples of
// the chain repeated (the timing floor of gain_p1, not a result).
extern "C" int gain_floor_f32(const float* m, float* out, long long n, int G,
                              float ia, float ir, void* stream) {
  if (n < 1 || G < 1) return (int)cudaErrorInvalidValue;
  gain_floor<<<G, 32, 0, (cudaStream_t)stream>>>(m, out, n, ia, ir);
  return (int)cudaGetLastError();
}

// m [G, n]; starts [G, ceil(n/32)]; att [G, n]. tile: the groups a tile the
// caller assumes (ops/pydub_gain.py::_p2_tile), checked against this
// build's. 16-byte copies where every row of m and att is 16-byte aligned,
// else the 4-byte route.
extern "C" int gain_p2_f32(const float* m, const float* starts, float* att,
                           long long n, int G, int tile, float ia, float ir,
                           void* stream) {
  if (n < 1 || n > (1LL << 35) || G < 1 || G > 65535 || tile != P2_TG)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = ((n + GROUP - 1) / GROUP + P2_TG - 1) / P2_TG;
  const dim3 grid((unsigned)ntiles, (unsigned)G);
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 == 0 && (size_t)m % 16 == 0 && (size_t)att % 16 == 0)
    gain_p2<true><<<grid, P2_TG, 0, st>>>(m, starts, att, n, ia, ir);
  else
    gain_p2<false><<<grid, P2_TG, 0, st>>>(m, starts, att, n, ia, ir);
  return (int)cudaGetLastError();
}

// m_t [seg_len, lanes] time-major (lane = g*S + s); carry_in, carry_out
// [lanes]; att_t [seg_len, lanes] or null (a carry sweep); resets
// [S * seg_len / 32] group flags shared by the lanes/S chains, or null (the
// unchunked route, compiled without them). The 16-byte copies need
// lanes % 4 == 0 and 16-byte aligned m_t and att_t.
extern "C" int gain_jacobi_f32(const float* m_t, const float* carry_in,
                               float* carry_out, float* att_t,
                               const float* resets, long long seg_len,
                               int lanes, int S, float ia, float ir,
                               void* stream) {
  if (seg_len < 1 || lanes < 1 || lanes % 4 != 0 || (size_t)m_t % 16 != 0 ||
      (size_t)att_t % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (resets && (S < 1 || lanes % S != 0 || (S * seg_len) % GROUP != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((lanes + JAC_LANES - 1) / JAC_LANES);
  cudaStream_t st = (cudaStream_t)stream;
  if (att_t && resets)
    gain_jacobi<true, true><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir, resets, S);
  else if (att_t)
    gain_jacobi<true, false><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir, resets, S);
  else if (resets)
    gain_jacobi<false, true><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir, resets, S);
  else
    gain_jacobi<false, false><<<grid, JAC_LANES, 0, st>>>(
        m_t, carry_in, carry_out, att_t, seg_len, lanes, ia, ir, resets, S);
  return (int)cudaGetLastError();
}

extern "C" const char* pydub_gain_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
