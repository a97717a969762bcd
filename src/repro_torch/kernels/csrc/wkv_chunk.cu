// Chunked RWKV6 WKV forward and its backward for Hopper (sm_90a), fp32
// arithmetic (the backward, `wkv_bwd_kernel`, is below the forward).
//
//   per (b, h), from a zero [K, K] state:
//     y_t   = r_t . (state + u (x) (k_t (x) v_t))
//     state <- e^{g_t} * state + k_t (x) v_t
//
//   r, k, v, g [BH, S, K] (fp32 or bf16, loaded to fp32), u [H, K], y [BH, S, K]
//   in the inputs' dtype, rounded once on the store.  g is clipped to
//   [g_min, 0] as it is loaded (g_min is -1.2 rounded to the inputs' dtype,
//   as the reference clips in it).  Optionally the final state [BH, K, K] in
//   fp32 (a prefill hands it to decode): each CTA writes its key rows by
//   value columns once, after its last tile, from the registers that carried
//   it; y's arithmetic is the same with or without it.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `wkv_chunk_pallas`
// (src/repro/kernels/wkv_chunk.py:26,67, pallas_call :83).  The TPU walks its
// grid in order and carries the [K, K] state across the chunk axis in VMEM
// scratch; blocks on this card run in no order, so each CTA walks S itself
// with its part of the state in registers.
//
// The tile.  The kernel walks S in tiles of its own kTile = 32 steps, whatever
// the caller's chunk: the chunk only regrouped the same sums, so it no longer
// changes the kernel's arithmetic, and any chunk the wrapper accepts runs the
// same code (a ragged last tile is masked: g = 0, r = k = v = 0 past S).  Per
// tile (L the inclusive cumulative decay of each key channel in log2 units,
// Lp the exclusive one, Le = L at the tile's last step):
//
//   1. L = scan of g over the tile's steps; q = r 2^{Lp}, ke = k 2^{-L}
//      (one exp2 per (t, i)); the bonus sum_i r u k per step
//   2. A[t, s] = q[t] . ke[s] for s < t, A[t, t] = the bonus, 0 above
//   3. y = q . state + A . v
//   4. state <- 2^{Le} (state + ke^T . v)
//
// This is the reference's factored form (q_eff k_eff^T), not pairwise
// decays 2^{Lp[t]-L[s]}, which cost one exp2 per (t, s, i).  The exponent
// margin: g >= -1.2 gives at most 1.2 log2(e) = 1.731 bits of decay a step,
// so within a tile |L| <= 32 * 1.731 = 55.4 bits
// (at 64 steps 110.8, still under fp32's 127; the reference overflows from
// 74 steps, its chunk).  So ke <= |k| 2^55.4, every product and sum of steps 2
// to 4 is finite for |k v| far past any real input, and 2^{Lp} r stays a
// normal number for |r| > 2^-70.  Each product q[t] ke[s] with s < t equals
// r k 2^{Lp[t]-L[s]} <= |r k| up to the rounding of two exp2; step 4's sum
// carries the state's rounding at the scale of 2^{Le} state + sum_t 2^{Le-L}
// k v, as the unfactored update does.
//
// The products.  Steps 2 to 4 are four small matrix products a tile
// ([32 x K] [K x 32], [32 x K] [K x VB], [32 x 32] [32 x VB], [K x 32]
// [32 x VB]), run on the tensor cores as mma.sync m16n8k8 in 3xTF32: each
// fp32 operand x is split into tf32 parts hi + lo (x - hi - lo within 2^-20
// of x), and a b is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32, in
// three accumulators (three independent chains of mma), which keeps the
// error near that of fp32 FFMA (a one-pass TF32 product, 2^-11 of each term,
// would not hold 1e-4 near zero).  A warp owns 16 rows of the state, in
// accumulator registers, across the whole walk; y's first half and A share
// the split fragments of q.
//
// The CTA.  The value columns are independent (y[:, j] and state[:, j] read
// only v[:, j]), so a CTA takes one (b, h) and VB = min(K, 32) value columns:
// B H K / VB CTAs, 320 at B 4, H 40, K 64, each recomputing steps 1 and 2 for
// its tile (2x on those, nothing more in DRAM bytes: the two CTAs of one
// (b, h) are adjacent in the grid and read r, k, g, v through L2 together).
// 128 threads, three CTAs an SM (__launch_bounds__(128, 3): <= 168 registers
// a thread; ptxas gives 155 at K = 64 in fp32, 152 in bf16, no spill), so
// all 320 CTAs of the main row run at once.  The tile's r, k, g and v arrive
// as four bulk copies of the TMA unit (8 KB each at K = 64, fp32) into one
// stage, completing on an mbarrier; the next tile's copies start as soon as
// step 1 has read the stage and land while this tile's products run.
// A copy a row (128 a tile), or cp.async of 16 bytes a thread, stalled the
// issuing warps on the H100: the copy's cost is its count of requests, not
// its bytes.  Step 1 writes q, ke and the CTA's v columns as fp32 into padded
// arrays whose strides make every fragment load of the products free of bank
// conflicts or at most 2-way.  Shared memory a CTA: 71,176 bytes at K = 64 in
// fp32, 54,792 in bf16 (`wkv_chunk_smem_bytes`).
//
// The shape: one pass.  The walk is paced by its arithmetic, not by its
// serial chain: at K = 16, with a tenth of the arithmetic a tile, a tile
// takes two fifths as long (`chip_smoke.py`'s wkv phase, `tile_us`).  The
// two-pass shape (a state pass writing each tile's starting state, then an
// output pass parallel over tiles) would add a 168 MB workspace and a second
// read of k, v, g, a DRAM floor of 0.45-0.5 ms at the main row, to shorten
// a chain that costs less.  A cluster of the two CTAs of a (b, h), each
// doing half of steps 1 and 2 and writing the results into both through
// distributed shared memory, was slower than the recomputation: its two
// cluster barriers a tile cost more than the halved work saves.
//
// Bound on this card: bytes (r, k, v, g read once and y written once: 0.250
// ms at B 4, H 40, S 4096, K 64 in fp32; the function's 5 K^2 + 4 K flops a
// step take 0.203 ms at the fp32 rate).  The kernel is bound by its rate of
// instructions, most of them the fragments' loads and splits around the
// mma.  Sums run in a fixed order and no float atomics are used, so two
// launches give bitwise equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_sm90.cuh"

namespace {

using sm90::bulk_load;
using sm90::fence_proxy_async;
using sm90::mbar_expect_tx;
using sm90::mbar_fence_init;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int kThreads = 128;  // four warps
constexpr int kCtasPerSm = 3;
constexpr int kTile = 32;      // steps a tile
constexpr int kCopier = 64;    // the thread that starts the copies: warp 2's first
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements as fp32 (16 bytes of fp32 or 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x for x in [-56, 56]: one MUFU op, relative error about 2^-22
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- 3xTF32 on mma.sync m16n8k8 ---------------------------------------------

// x = hi + lo exactly, hi = x cut to tf32's 10 mantissa bits (one LOP3, not
// cvt.rna.tf32.f32, which sm_90 runs as four instructions); the mma reads
// the top 19 bits of each operand, so lo loses under 2^-10 of itself, 2^-20
// of x
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's share of a 16 x 8 A (rows m, columns k) and of an 8 x 8 B (rows
// k, columns n), gid = lane / 4, tig = lane % 4: A (gid, tig), (gid + 8, tig),
// (gid, tig + 4), (gid + 8, tig + 4); B (tig, gid), (tig + 4, gid).  The
// accumulator holds (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig) and
// (gid + 8, 2 tig + 1).
struct FragA {
  Split x[4];
};
struct FragB {
  Split x[2];
};

// A at (m0, k0) of a matrix whose element (m, k) is p[m * ld + k]
__device__ __forceinline__ FragA frag_a_mk(const float* p, int ld, int m0, int k0,
                                           int gid, int tig) {
  const float* q = p + (m0 + gid) * ld + k0 + tig;
  return {{split(q[0]), split(q[8 * ld]), split(q[4]), split(q[8 * ld + 4])}};
}
// ... whose element (m, k) is p[k * ld + m]
__device__ __forceinline__ FragA frag_a_km(const float* p, int ld, int m0, int k0,
                                           int gid, int tig) {
  const float* q = p + (k0 + tig) * ld + m0 + gid;
  return {{split(q[0]), split(q[8]), split(q[4 * ld]), split(q[4 * ld + 8])}};
}
// B at (k0, n0) of a matrix whose element (k, n) is p[k * ld + n]
__device__ __forceinline__ FragB frag_b_kn(const float* p, int ld, int k0, int n0,
                                           int gid, int tig) {
  const float* q = p + (k0 + tig) * ld + n0 + gid;
  return {{split(q[0]), split(q[4 * ld])}};
}
// ... whose element (k, n) is p[n * ld + k]
__device__ __forceinline__ FragB frag_b_nk(const float* p, int ld, int k0, int n0,
                                           int gid, int tig) {
  const float* q = p + (n0 + gid) * ld + k0 + tig;
  return {{split(q[0]), split(q[4])}};
}

// a b to fp32 accuracy in three accumulators, three independent chains of
// mma: the two small products and the big one; `total` sums them, small first
struct Acc3 {
  float lo[4], mid[4], hi[4];
};
__device__ __forceinline__ void zero(Acc3& d) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d.lo[e] = d.mid[e] = d.hi[e] = 0.f;
}
__device__ __forceinline__ void mma3(Acc3& d, const FragA& a, const FragB& b) {
  mma_tf32(d.lo, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b.x[0].hi, b.x[1].hi);
  mma_tf32(d.mid, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].lo, b.x[1].lo);
  mma_tf32(d.hi, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].hi, b.x[1].hi);
}
__device__ __forceinline__ float total(const Acc3& d, int e) {
  return (d.lo[e] + d.mid[e]) + d.hi[e];
}

// The shared-memory layout (byte offsets) for input type T and key width K.
template <typename T, int K>
struct Layout {
  static constexpr int VB = K < 32 ? K : 32;  // value columns a CTA
  // row strides (floats): Q and KE [kTile][QS] are read with k along a row
  // (QS = 4 mod 8: conflict-free), V [kTile][VS] and the state St [K][VS]
  // with k down a column (VS = 8 mod 16), A [kTile][AS] with k along a row
  static constexpr int QS = K + 4;
  static constexpr int VS = VB + 8;
  static constexpr int AS = kTile + 4;
  // the stage: r, k, g, v [kTile][K] each, as the bulk copies bring them
  static constexpr int kArray = kTile * K * (int)sizeof(T);
  static constexpr int kQ = 4 * kArray;
  static constexpr int kKE = kQ + kTile * QS * 4;
  static constexpr int kV = kKE + kTile * QS * 4;
  static constexpr int kA = kV + kTile * VS * 4;
  static constexpr int kState = kA + kTile * AS * 4;
  static constexpr int kLe = kState + K * VS * 4;    // Le [K]
  static constexpr int kU = kLe + K * 4;             // U [K]
  static constexpr int kBonus = kU + K * 4;          // Bon [K / 16][kTile]
  static constexpr int kBar = kBonus + K / 16 * kTile * 4;  // the stage's mbarrier
  static constexpr int kBytes = kBar + 8;
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const T* __restrict__ u, T* __restrict__ y,
                 float* __restrict__ state, int H, int S, float g_min) {
  using Lay = Layout<T, K>;
  constexpr int VB = Lay::VB, QS = Lay::QS, VS = Lay::VS, AS = Lay::AS;
  constexpr int NT = VB / 8;   // n8 tiles of the state's columns
  constexpr int YN = VB / 16;  // n8 tiles of y a warp
  static_assert(K % 16 == 0 && K <= 64, "K in {16, 32, 64}");
  extern __shared__ __align__(16) unsigned char smem[];
  const T* raw = reinterpret_cast<const T*>(smem);  // r, k, g, v of the tile
  float* Q = reinterpret_cast<float*>(smem + Lay::kQ);
  float* KE = reinterpret_cast<float*>(smem + Lay::kKE);
  float* V = reinterpret_cast<float*>(smem + Lay::kV);
  float* As = reinterpret_cast<float*>(smem + Lay::kA);
  float* St = reinterpret_cast<float*>(smem + Lay::kState);
  float* Le = reinterpret_cast<float*>(smem + Lay::kLe);
  float* U = reinterpret_cast<float*>(smem + Lay::kU);
  float* Bon = reinterpret_cast<float*>(smem + Lay::kBonus);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lay::kBar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x / (K / VB), jv = blockIdx.x % (K / VB) * VB;
  const int h = bh % H;
  const long long base = (long long)bh * S * K;
  const int ntiles = (S + kTile - 1) / kTile;

  for (int i = tid; i < K; i += kThreads) U[i] = to_f(u[h * K + i]);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // tile c's rows of r, k, g and v (all K columns), four bulk copies
  auto load_tile = [&](int c) {
    const int t0 = c * kTile;
    const uint32_t bytes = min(kTile, S - t0) * K * (uint32_t)sizeof(T);
    mbar_expect_tx(bar, 4 * bytes);
    const T* const src[4] = {r, k, g, v};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      bulk_load(smem + a * Lay::kArray, src[a] + base + (long long)t0 * K, bytes, bar);
  };
  if (tid == kCopier) load_tile(0);

  // warp w owns state rows 16 w .. 16 w + 15 (where 16 w < K, every warp at
  // K = 64: known at compile time, so the shuffles below need no guard for
  // divergence), every column
  const bool s_owner = K == 64 || 16 * warp < K;
  float st[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
  // and y rows ym .. ym + 15, columns yn .. yn + 8 YN - 1; warps 0, 1, 3
  // also A's block of rows ym .. ym + 15 and columns an .. an + 15: (0, 0),
  // (1, 0), (1, 1); warp 2, which has none, starts the copies (kCopier)
  const int ym = 16 * (warp & 1), yn = (warp >> 1) * 8 * YN;
  const bool a_owner = warp != 2;
  const int an = warp == 3 ? 16 : 0;
  // step 1: warp w takes key channels 16 w .. 16 w + 15 (where 16 w < K); a
  // lane 4 channels i0 .. i0 + 3 of the 4 steps 4 seg .. 4 seg + 3
  const int seg = lane >> 2, i0 = 16 * warp + 4 * (lane & 3);
  const bool scanner = K == 64 || 16 * warp < K;

  for (int c = 0; c < ntiles; ++c) {
    const int t0 = c * kTile, rows = min(kTile, S - t0);
    mbar_wait(bar, c & 1);
    __syncthreads();  // tile c staged; every read of tile c - 1 done
    if (s_owner) {  // the state at the tile's start
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* p = St + (16 * warp + gid) * VS + 8 * n + 2 * tig;
        *reinterpret_cast<float2*>(p) = make_float2(st[n][0], st[n][1]);
        *reinterpret_cast<float2*>(p + 8 * VS) = make_float2(st[n][2], st[n][3]);
      }
    }
    // the CTA's v columns in fp32 (rows past S: 0)
    for (int idx = tid; idx < kTile * VB / 4; idx += kThreads) {
      const int row = idx / (VB / 4), c4 = idx % (VB / 4);
      *reinterpret_cast<float4*>(V + row * VS + 4 * c4) =
          row < rows ? load4(raw + 3 * kTile * K + row * K + jv + 4 * c4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // 1. the decay scan, q, ke, the bonus
    if (scanner) {
      float L[4][4];  // [step j][channel e]: in the thread's 4 steps, then whole
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * seg + j;
        const float4 g4 = t < rows ? load4(raw + 2 * kTile * K + t * K + i0)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        const float gl[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          L[j][e] = fminf(fmaxf(gl[e], g_min), 0.f) * kLog2e;
          if (j) L[j][e] += L[j - 1][e];
        }
      }
      // the segments' totals scanned across the 8 lanes of a channel group
      float ex[4], prev[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float incl = L[3][e];
#pragma unroll
        for (int d = 1; d < 8; d <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, incl, 4 * d);
          if (seg >= d) incl += o;
        }
        ex[e] = __shfl_up_sync(0xffffffffu, incl, 4);
        if (seg == 0) ex[e] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) L[j][e] += ex[e];
        // Lp of the segment's first step: L of the step before, as it was summed
        prev[e] = __shfl_up_sync(0xffffffffu, L[3][e], 4);
        if (seg == 0) prev[e] = 0.f;
      }
      if (seg == 7) {
#pragma unroll
        for (int e = 0; e < 4; ++e) Le[i0 + e] = L[3][e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * seg + j;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 r4 = t < rows ? load4(raw + t * K + i0) : zero;
        const float4 k4 = t < rows ? load4(raw + kTile * K + t * K + i0) : zero;
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
        float q[4], ke[4], bonus = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[e] = rr[e] * ex2(j ? L[j - 1][e] : prev[e]);
          ke[e] = kk[e] * ex2(-L[j][e]);
          bonus = fmaf(rr[e] * U[i0 + e], kk[e], bonus);
        }
        *reinterpret_cast<float4*>(Q + t * QS + i0) = make_float4(q[0], q[1], q[2], q[3]);
        *reinterpret_cast<float4*>(KE + t * QS + i0) = make_float4(ke[0], ke[1], ke[2], ke[3]);
        // the warp's 16 channels: the same sum on each of the 4 lanes
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
        if ((lane & 3) == 0) Bon[warp * kTile + t] = bonus;
      }
    }
    fence_proxy_async();  // the stage is read: the TMA may write it again
    __syncthreads();      // q, ke, v, Le and the bonus partials in place
    if (tid == kCopier && c + 1 < ntiles) load_tile(c + 1);

    // 3 (first half) and 2. y = q . state, and A = q . ke^T on the warp's
    // block, from the same fragments of q
    Acc3 acc[YN], w[2];
#pragma unroll
    for (int n = 0; n < YN; ++n) zero(acc[n]);
    zero(w[0]);
    zero(w[1]);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const FragA a = frag_a_mk(Q, QS, ym, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < YN; ++n) mma3(acc[n], a, frag_b_kn(St, VS, k0, yn + 8 * n, gid, tig));
      if (a_owner) {
#pragma unroll
        for (int n = 0; n < 2; ++n) mma3(w[n], a, frag_b_nk(KE, QS, k0, an + 8 * n, gid, tig));
      }
    }
    if (a_owner) {  // strictly past, the bonus on the diagonal, 0 above
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = ym + gid + 8 * half;
        float bonus = 0.f;
#pragma unroll
        for (int b = 0; b < K / 16; ++b) bonus += Bon[b * kTile + t];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = an + 8 * n + 2 * tig;
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float past = total(w[n], 2 * half + e);
            out[e] = s + e < t ? past : s + e == t ? bonus : 0.f;
          }
          *reinterpret_cast<float2*>(As + t * AS + s) = make_float2(out[0], out[1]);
        }
      }
    }
    // 4. state <- 2^{Le} (state + ke^T . v)
    if (s_owner) {
      Acc3 upd[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) zero(upd[n]);
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 8) {
        const FragA a = frag_a_km(KE, QS, 16 * warp, k0, gid, tig);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma3(upd[n], a, frag_b_kn(V, VS, k0, 8 * n, gid, tig));
      }
      const float d0 = ex2(Le[16 * warp + gid]), d1 = ex2(Le[16 * warp + gid + 8]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[n][e] = (((st[n][e] + upd[n].lo[e]) + upd[n].mid[e]) + upd[n].hi[e]) *
                     (e < 2 ? d0 : d1);
      }
    }
    __syncthreads();  // A in place

    // 3 (second half). y += A . v over the row block's own and earlier steps
    for (int k0 = 0; k0 < ym + 16; k0 += 8) {
      const FragA a = frag_a_mk(As, AS, ym, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < YN; ++n) mma3(acc[n], a, frag_b_kn(V, VS, k0, yn + 8 * n, gid, tig));
    }
#pragma unroll
    for (int n = 0; n < YN; ++n) {
      const int t = ym + gid, col = jv + yn + 8 * n + 2 * tig;
      if (t < rows)
        store2(y + base + (long long)(t0 + t) * K + col, total(acc[n], 0), total(acc[n], 1));
      if (t + 8 < rows)
        store2(y + base + (long long)(t0 + t + 8) * K + col, total(acc[n], 2),
               total(acc[n], 3));
    }
  }

  // the final state, where the caller asked for it: each state owner's 16
  // key rows of the CTA's VB value columns, once, after the last tile (st
  // already holds 2^{Le} (state + ke^T v), the state itself); [BH, K, K]
  // fp32, key rows by value columns, as the reference's scan carries it
  if (state != nullptr && s_owner) {
    float* out = state + (long long)bh * K * K + (16 * warp + gid) * K + jv + 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(st[n][0], st[n][1]);
      *reinterpret_cast<float2*>(out + 8 * K + 8 * n) = make_float2(st[n][2], st[n][3]);
    }
  }
}

template <typename T, int K>
cudaError_t prepare(void (**kernel)(const T*, const T*, const T*, const T*,
                                    const T*, T*, float*, int, int, float)) {
  *kernel = wkv_chunk_kernel<T, K>;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T, K>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* g, const void* u,
           void* y, void* state, int BH, int H, int S, float g_min,
           cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, float*, int, int,
                 float);
  const cudaError_t err = prepare<T, K>(&kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<BH * (K / Layout<T, K>::VB), kThreads, Layout<T, K>::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(y),
      static_cast<float*>(state), H, S, g_min);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int ctas_per_sm() {
  void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, float*, int, int,
                 float);
  cudaError_t err = prepare<T, K>(&kernel);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        Layout<T, K>::kBytes);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const void* g, const void* u,
             void* y, void* state, int BH, int H, int S, int K, float g_min,
             cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, g, u, y, state, BH, H, S, g_min, stream);
    case 32: return launch<T, 32>(r, k, v, g, u, y, state, BH, H, S, g_min, stream);
    case 64: return launch<T, 64>(r, k, v, g, u, y, state, BH, H, S, g_min, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_k(int K) {
  switch (K) {
    case 16: return ctas_per_sm<T, 16>();
    case 32: return ctas_per_sm<T, 32>();
    case 64: return ctas_per_sm<T, 64>();
    default: return -(int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward (fp32)
//
// The gradient of the recurrence above with respect to r, k, v, g (through
// the clip) and u, given dy [BH, S, K] and, optionally, the final state's
// cotangent dstate [BH, K, K].  With S_t the state before step t (the
// forward's zero state at t = 0) and G_t the cotangent of the state after
// step t (G_{S-1} = dstate, or 0), walking t down from S - 1:
//
//   dr_t[i] = sum_j dy_t[j] S_t[i, j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i, j] v_t[j] + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i, j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dg_t[i] = e^{g_t[i]} sum_j G_t[i, j] S_t[i, j]   (0 where g was clipped)
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = r_t dy_t^T + e^{g_t} o G_t
//
// The TPU kernel has no gradient rule; this replaces JAX's autodiff of the
// reference's `_chunked_linear_attention` (src/repro/models/ssm.py:29).
//
// What is hard.  dg needs every step's previous state, and the state may not
// be rebuilt backwards (e^{-g} (S_t - k v^T) grows by up to e^{1.2} a step
// and loses fp32 within tens of steps).  So one CTA a (b, h) first runs the
// recurrence forward, writing the state at each 32-step tile boundary to a
// workspace; then it walks the tiles backwards, recomputing each tile's 32
// states from its boundary into a second workspace (L2-resident: 512 KB a
// CTA at K = 64) and reading them back in reverse.  Every thread owns the
// same 4 x 4 block of the state, of its recomputation and of G throughout
// (key rows 4 ri.., value columns 4 cj..), so the workspaces are private to
// it and the walk needs no barrier a step.  dr, dk and dg sum over value
// columns: a fixed xor-shuffle tree across the K / 4 threads of a row block.
// dv sums over key rows, across warps: each step's partial of each row
// block goes to shared memory, and the tile's dv is summed from them in a
// fixed order after the tile.  du is this CTA's sum over t, written per
// (b, h) and summed over b by the caller.  No float atomics: two launches
// are bitwise equal.
//
// Bound on this card: bytes (r, k, v, g, dy read and dr, dk, dv, dg written
// once, 0.12 ms at B 1, H 40, S 4096, K 64; its ~12 K^2 flops a step take
// about as long at the fp32 rate).  This simple kernel is bound by its
// serial walk: one CTA a (b, h) (40 of 132 SMs busy at B 1), a few hundred
// instructions a step a thread.

constexpr int kBTile = 32;  // steps a tile of the backward walk

template <int K>
struct BLayout {
  static constexpr int NB = K / 4;  // 4 x 4 blocks along each side of the state
  static constexpr int kWork = NB * NB;  // threads that own a block
  static constexpr int kThreads = kWork < 32 ? 32 : kWork;
  // a tile's r, k, v, w = e^{clip g}, dy, the clip mask ([kBTile][K] each),
  // the dv partials [kBTile][NB][K], u [K], v . dy and sum r u k [kBTile]
  static constexpr int kVec = kBTile * K;
  static constexpr int kPart = kBTile * NB * K;
  static constexpr int kFloats = 6 * kVec + kPart + K + 2 * kBTile;
  static constexpr int kBytes = kFloats * 4;
};

template <int K>
__global__ void __launch_bounds__(BLayout<K>::kThreads)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ u, const float* __restrict__ dy,
               const float* __restrict__ dstate, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dg,
               float* __restrict__ du_part, float* __restrict__ ckpt,
               float* __restrict__ scratch, int H, int S, float g_min) {
  using Lay = BLayout<K>;
  constexpr int NB = Lay::NB, NT = Lay::kThreads, V = Lay::kVec;
  extern __shared__ __align__(16) float bsm[];
  float* Rs = bsm;
  float* Ks = Rs + V;
  float* Vs = Ks + V;
  float* Ws = Vs + V;
  float* DYs = Ws + V;
  float* Ms = DYs + V;
  float* Part = Ms + V;
  float* Us = Part + Lay::kPart;
  float* VDY = Us + K;
  float* BON = VDY + kBTile;

  const int tid = threadIdx.x, bh = blockIdx.x, h = bh % H;
  // threads past the K / 4 x K / 4 owners (K = 16) shadow thread 0 and
  // store nothing
  const bool owner = tid < Lay::kWork;
  const int w = owner ? tid : 0, ri = w / NB, cj = w % NB;
  const int i0 = 4 * ri, j0 = 4 * cj;
  const long long base = (long long)bh * S * K;
  const int ntiles = (S + kBTile - 1) / kBTile;
  float* my_ckpt = ckpt + ((long long)bh * ntiles * NT + tid) * 16;
  float* my_scr = scratch + ((long long)bh * kBTile * NT + tid) * 16;

  for (int i = tid; i < K; i += NT) Us[i] = u[h * K + i];

  // tile c's arrays; with `all`, r, dy and the mask too (steps past S: zeros
  // and w = 1)
  auto load_tile = [&](int c, bool all) {
    const int t0 = c * kBTile, rows = min(kBTile, S - t0);
    for (int idx = tid; idx < V / 4; idx += NT) {
      const int t = idx / (K / 4), c4 = (idx % (K / 4)) * 4, e = t * K + c4;
      const bool in = t < rows;
      const long long at = base + (long long)(t0 + t) * K + c4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 gg = in ? *reinterpret_cast<const float4*>(g + at) : zero;
      const float gl[4] = {gg.x, gg.y, gg.z, gg.w};
      float ww[4], mm[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ww[q] = in ? expf(fminf(fmaxf(gl[q], g_min), 0.f)) : 1.f;
        mm[q] = in && gl[q] >= g_min && gl[q] <= 0.f ? 1.f : 0.f;
      }
      *reinterpret_cast<float4*>(Ws + e) = make_float4(ww[0], ww[1], ww[2], ww[3]);
      *reinterpret_cast<float4*>(Ks + e) = in ? *reinterpret_cast<const float4*>(k + at) : zero;
      *reinterpret_cast<float4*>(Vs + e) = in ? *reinterpret_cast<const float4*>(v + at) : zero;
      if (all) {
        *reinterpret_cast<float4*>(Ms + e) = make_float4(mm[0], mm[1], mm[2], mm[3]);
        *reinterpret_cast<float4*>(Rs + e) =
            in ? *reinterpret_cast<const float4*>(r + at) : zero;
        *reinterpret_cast<float4*>(DYs + e) =
            in ? *reinterpret_cast<const float4*>(dy + at) : zero;
      }
    }
  };
  // one step of the recurrence on the thread's block, rounded as the plain
  // version rounds it: e^{g} * state, then + k v
  auto advance = [&](float (&st)[16], int t) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float wi = Ws[t * K + i0 + a], ki = Ks[t * K + i0 + a];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        st[4 * a + b] = __fadd_rn(__fmul_rn(wi, st[4 * a + b]), __fmul_rn(ki, Vs[t * K + j0 + b]));
    }
  };
  auto put16 = [](float* dst, const float (&x)[16]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  };
  auto get16 = [](float (&x)[16], const float* src) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 y = reinterpret_cast<const float4*>(src)[q];
      x[4 * q] = y.x;
      x[4 * q + 1] = y.y;
      x[4 * q + 2] = y.z;
      x[4 * q + 3] = y.w;
    }
  };

  // 1. forward: the state at each tile's start
  float st[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) st[e] = 0.f;
  for (int c = 0; c < ntiles; ++c) {
    put16(my_ckpt + (long long)c * NT * 16, st);
    if (c + 1 == ntiles) break;  // the last tile's end state is not needed
    __syncthreads();
    load_tile(c, false);
    __syncthreads();
    for (int t = 0; t < kBTile; ++t) advance(st, t);
  }

  // 2. backward, tile by tile from the last
  float G[16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      G[4 * a + b] = dstate != nullptr
                         ? dstate[(long long)bh * K * K + (i0 + a) * K + j0 + b]
                         : 0.f;
  float du_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = ntiles - 1; c >= 0; --c) {
    const int t0 = c * kBTile, rows = min(kBTile, S - t0);
    __syncthreads();  // every read of the last tile is done
    load_tile(c, true);
    __syncthreads();
    if (tid < kBTile) {  // per step: v . dy and the bonus sum r u k, in order
      float a = 0.f, b = 0.f;
      for (int i = 0; i < K; ++i) {
        a = fmaf(Vs[tid * K + i], DYs[tid * K + i], a);
        b = fmaf(Rs[tid * K + i] * Us[i], Ks[tid * K + i], b);
      }
      VDY[tid] = a;
      BON[tid] = b;
    }
    // the tile's states S_t, recomputed from its boundary
    get16(st, my_ckpt + (long long)c * NT * 16);
    for (int t = 0; t < rows; ++t) {
      put16(my_scr + (long long)t * NT * 16, st);
      advance(st, t);
    }
    __syncthreads();  // VDY, BON
    for (int t = rows - 1; t >= 0; --t) {
      float sp[16];
      get16(sp, my_scr + (long long)t * NT * 16);
      float pr[4], pk[4], pw[4], pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ki = Ks[t * K + i0 + a];
        float x = 0.f, y = 0.f, z = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int e = 4 * a + b;
          x = fmaf(DYs[t * K + j0 + b], sp[e], x);
          y = fmaf(G[e], Vs[t * K + j0 + b], y);
          z = fmaf(G[e], sp[e], z);
          pv[b] = fmaf(G[e], ki, pv[b]);
        }
        pr[a] = x;
        pk[a] = y;
        pw[a] = z;
      }
#pragma unroll
      for (int off = 1; off < NB; off <<= 1) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pr[a] += __shfl_xor_sync(0xffffffffu, pr[a], off);
          pk[a] += __shfl_xor_sync(0xffffffffu, pk[a], off);
          pw[a] += __shfl_xor_sync(0xffffffffu, pw[a], off);
        }
      }
      if (owner) {
        *reinterpret_cast<float4*>(Part + (t * NB + ri) * K + j0) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
      }
      if (owner && cj == 0) {
        float o_r[4], o_k[4], o_g[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int e = t * K + i0 + a;
          const float ui = Us[i0 + a], ki = Ks[e], rr = Rs[e];
          o_r[a] = pr[a] + ui * ki * VDY[t];
          o_k[a] = pk[a] + ui * rr * VDY[t];
          o_g[a] = Ms[e] * (Ws[e] * pw[a]);
          du_acc[a] = fmaf(rr * ki, VDY[t], du_acc[a]);
        }
        const long long at = base + (long long)(t0 + t) * K + i0;
        *reinterpret_cast<float4*>(dr + at) = make_float4(o_r[0], o_r[1], o_r[2], o_r[3]);
        *reinterpret_cast<float4*>(dk + at) = make_float4(o_k[0], o_k[1], o_k[2], o_k[3]);
        *reinterpret_cast<float4*>(dg + at) = make_float4(o_g[0], o_g[1], o_g[2], o_g[3]);
      }
      // G_{t-1} = r_t dy_t^T + e^{g_t} o G_t
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wi = Ws[t * K + i0 + a], rr = Rs[t * K + i0 + a];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          G[4 * a + b] = fmaf(wi, G[4 * a + b], rr * DYs[t * K + j0 + b]);
      }
    }
    __syncthreads();  // the tile's dv partials are in place
    for (int idx = tid; idx < rows * K; idx += NT) {
      const int t = idx / K, j = idx % K;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NB; ++q) acc += Part[(t * NB + q) * K + j];
      dv[base + (long long)(t0 + t) * K + j] = fmaf(BON[t], DYs[t * K + j], acc);
    }
  }
  if (owner && cj == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) du_part[(long long)bh * K + i0 + a] = du_acc[a];
  }
}

template <int K>
int launch_bwd(const float* r, const float* k, const float* v, const float* g,
               const float* u, const float* dy, const float* dstate, float* dr, float* dk,
               float* dv, float* dg, float* du_part, float* ckpt, float* scratch, int BH,
               int H, int S, float g_min, cudaStream_t stream) {
  using Lay = BLayout<K>;
  auto kernel = wkv_bwd_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<BH, Lay::kThreads, Lay::kBytes, stream>>>(r, k, v, g, u, dy, dstate, dr, dk, dv,
                                                      dg, du_part, ckpt, scratch, H, S,
                                                      g_min);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  BH, S >= 1, K in {16, 32, 64},
// 16-byte aligned contiguous tensors (the wrapper checks), bf16 = 1 for bf16
// inputs and output, 0 for fp32, g_min the decay's clip floor.  state, where
// not null, receives the final [BH, K, K] fp32 state (8-byte aligned); null
// writes nothing.  Returns cudaGetLastError() after the launch; 0 means it
// was accepted.
extern "C" int wkv_chunk_launch(const void* r, const void* k, const void* v,
                                const void* g, const void* u, void* y, void* state,
                                int BH, int H, int S, int K, int bf16, float g_min,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_k<__nv_bfloat16>(r, k, v, g, u, y, state, BH, H, S, K, g_min, s);
  return launch_k<float>(r, k, v, g, u, y, state, BH, H, S, K, g_min, s);
}

// CTAs of the kernel for key width K that fit on one SM (the occupancy
// calculator's answer), or minus a CUDA error code.
extern "C" int wkv_chunk_ctas_per_sm(int K, int bf16) {
  return bf16 ? occupancy_k<__nv_bfloat16>(K) : occupancy_k<float>(K);
}

// the bytes of shared memory a CTA takes
extern "C" int wkv_chunk_smem_bytes(int K, int bf16) {
  switch (K * 2 + (bf16 ? 1 : 0)) {
    case 32: return Layout<float, 16>::kBytes;
    case 33: return Layout<__nv_bfloat16, 16>::kBytes;
    case 64: return Layout<float, 32>::kBytes;
    case 65: return Layout<__nv_bfloat16, 32>::kBytes;
    case 128: return Layout<float, 64>::kBytes;
    case 129: return Layout<__nv_bfloat16, 64>::kBytes;
    default: return -1;
  }
}

// The backward (fp32 only): dr, dk, dv, dg [BH, S, K] and du_part [BH, K]
// (du of each (b, h), summed over b by the caller) from r, k, v, g, u and
// dy, and dstate [BH, K, K] (the final state's cotangent; null for none).
// ckpt and scratch are fp32 workspaces of `wkv_bwd_workspace_floats`
// floats each.  BH, S >= 1, K in {16, 32, 64}, 16-byte aligned contiguous
// tensors.  Returns cudaGetLastError() after the launch.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* g,
                              const void* u, const void* dy, const void* dstate, void* dr,
                              void* dk, void* dv, void* dg, void* du_part, void* ckpt,
                              void* scratch, int BH, int H, int S, int K, float g_min,
                              void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16:
      return launch_bwd<16>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(ckpt), m(scratch), BH, H, S, g_min, s);
    case 32:
      return launch_bwd<32>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(ckpt), m(scratch), BH, H, S, g_min, s);
    case 64:
      return launch_bwd<64>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(ckpt), m(scratch), BH, H, S, g_min, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The floats of the backward's two workspaces for one launch: the states at
// the tile boundaries, then the recomputed states of one tile, per (b, h).
extern "C" long long wkv_bwd_workspace_floats(int BH, int S, int K, int scratch) {
  const int threads = K == 16 ? BLayout<16>::kThreads
                      : K == 32 ? BLayout<32>::kThreads
                                : BLayout<64>::kThreads;
  const long long per = (long long)threads * 16;
  return scratch ? (long long)BH * kBTile * per
                 : (long long)BH * ((S + kBTile - 1) / kBTile) * per;
}

extern "C" const char* wkv_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
