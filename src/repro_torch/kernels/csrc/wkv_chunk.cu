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
// cotangent dstate [BH, K, K].  The TPU kernel has no gradient rule; this
// replaces JAX's autodiff of the reference's `_chunked_linear_attention`
// (src/repro/models/ssm.py:29), and like that autodiff it differentiates
// the tiled form: per 32-step tile, in the forward's notation (S0 the state
// before the tile, Gh = 2^{Le} G_end with G_end the cotangent of the state
// after it, A = strict-lower(q ke^T) + diag(bonus)),
//
//   dS0 = q^T dy + Gh                   (G_end of the tile before)
//   dA = strict-lower(dy v^T), dbon = rowsum(dy o v)
//   dq = dy S0^T + dA ke,  X = v Gh^T,  dke = dA^T q + X
//   dv = A^T dy + ke Gh
//   dr = dq o 2^{Lp} + u k dbon,  dk = dke o 2^{-L} + u r dbon
//   du = sum over tiles and b of colsum(r o k o dbon)
//   dg_t = dLe + sum_{t' > t} w_t' + b_t,  b = -ke o dke,  w = q o dq + b
//   dLe = rowsum(Gh o S0) + colsum(ke o X)     (the end decay's share)
//
// and dg is 0 where g was clipped and halved where g equals g_min or 0
// exactly (jnp.clip's gradient, whose max and min split a tie's cotangent
// evenly).  `ref.wkv_bwd_tiled_ref` is the same algebra in plain tensor
// ops, held to JAX in the tests.  dLe is the decay's derivative through
// the tile's end state, Gh o S_end summed over value columns, split as
// Gh o (S0 + ke^T v) so that the pass needs neither S_end nor another
// product.  Every exponent is the forward's: 2^{Lp} and 2^{-L} within one
// tile (55.4 bits at the clip floor), so every product stays finite.
//
// Three passes in two launches, each parallel enough to fill the card at
// rwkv6-3b's B 1 (40 heads):
//
//   1. states (`wkv_bwd_walk_kernel`, the first half of its grid): one CTA
//      a (b, h) and VB = min(K, 32) value columns walks the tiles forward
//      as the forward kernel does (its steps 1 and 4 in the same
//      arithmetic and order; its own code: the forward is untouched) and
//      writes each tile's S0 to a workspace [BH, ntiles, K, K];
//   2. cotangents (the same launch, the grid's second half): one CTA a
//      (b, h) and VB columns walks the tiles backwards from dstate (or 0):
//      Gh = 2^{Le} G is written for the tile, then G <- Gh + q^T dy on the
//      tensor cores.  128 threads, the stage's three arrays by TMA bulk
//      copies, the next tile's in flight during this one's product, as in
//      the forward; 38,664 bytes of shared memory, five CTAs an SM (all
//      640 of the main row at once);
//   3. gradients (`wkv_bwd_grad_kernel`): one CTA a (b, h, tile), 4 K
//      threads, holds all K value columns, so the sums over them stay in
//      the CTA (5,120 CTAs at B 1).  Its first half of warps loads r, k, g
//      by cp.async into padded rows and scans them in place (r -> q,
//      k -> ke, g -> L) while the second half's copies of v, dy, S0 and Gh
//      land (each half waits on a named barrier of its own), then forms
//      rowsum(dy o v) and rowsum(Gh o S0); then dA and A (three 16 x 16
//      blocks each), dq, dke and dv (a warp a 16 x 16 block of each, dv
//      straight out), and last an elementwise pass (a thread a key channel
//      and 8 steps) that forms dr, dk, the in-tile suffix sums of dg and
//      the tile's du partial.  108,672 bytes of shared memory, two CTAs an
//      SM (114 registers, no spill, at K = 64).
//
// Every product runs on the tensor cores in 3xTF32 as the forward's do (a
// one-pass TF32 product does not hold 1e-4).  The tile's du partials
// [BH, ntiles, K] are summed over b and the tiles by the caller in a fixed
// order; every other sum is formed in a fixed order inside one CTA, and no
// float atomics are used, so two launches are bitwise equal.
//
// What was tried (NVIDIA H100 80GB HBM3, 700 W, B 4, H 40, S 4096, K 64,
// fp32; B 1, rwkv6-3b's training batch, in brackets): the simple kernel
// before this one, one CTA a (b, h) walking single steps on SIMT FFMA
// twice (a forward walk to the tile boundaries, then each tile's 32 states
// recomputed into an L2 workspace and read back in reverse), took 17.8 ms
// (~8.0): 160 CTAs of 180 KB each (one an SM, two waves at B 4), ~2 us a
// step.  This shape's versions, timed with a gradient kernel whose warps
// stamp clock64() at each barrier (`scripts/wkv_bwd_stamps.py`): the first
// took 2.09 ms (0.58), a gradient CTA ~28,800 cycles, of them the copies
// 6,700, the row sums 5,900 (24 butterflies one after the other), the
// products 6,600 and the elementwise pass 7,700 (its global loads one step
// at a time); interleaving the butterflies and issuing every load of the
// elementwise pass at once, 1.74 ms (0.50), 23,300 cycles; each half of
// the CTA copying only what it reads first, 1.68 ms (0.50), 21,500 cycles,
// the copies and scan 9,100 of them and the products 7,300.  The walks
// take ~0.70 ms of it at B 4, near their DRAM floor; at B 1 a walk waits
// on each tile's copy (one stage: the next tile's copy overlaps only the
// product), and a second stage would cost the B 4 grid its single wave.
//
// Bound on this card: the function's operations (14 K^2 flops a step at
// the fp32 rate: 0.561 ms at the main row).  The design also writes and
// reads the two workspaces and reads k, g, v and r, g, dy once more in
// the walks: its DRAM floor is 1.153 ms at the main row (walks 0.501,
// gradients 0.653; `chip_smoke.py`'s `wkv_bwd_floor`).

// the scan of step 1 for a warp whose 16 key channels exist: lane (seg,
// c4) takes channels i0 .. i0 + 3 of steps 4 seg .. 4 seg + 3 of the tile's
// g (row stride ld, steps past `rows` read as 0); L[j][e] the inclusive
// cumulative clipped decay (log2) of step 4 seg + j, P[j][e] the exclusive
// one (the step before's L as summed, 0 at the tile's first step): the
// forward's arithmetic in its order
__device__ __forceinline__ void decay_scan(const float* gs, int ld, int rows, float g_min,
                                           int seg, int i0, float (&L)[4][4],
                                           float (&P)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = 4 * seg + j;
    const float4 g4 = t < rows ? load4(gs + t * ld + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float gl[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      L[j][e] = fminf(fmaxf(gl[e], g_min), 0.f) * kLog2e;
      if (j) L[j][e] += L[j - 1][e];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float incl = L[3][e];
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, 4 * d);
      if (seg >= d) incl += o;
    }
    float ex = __shfl_up_sync(0xffffffffu, incl, 4);
    if (seg == 0) ex = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) L[j][e] += ex;
    float prev = __shfl_up_sync(0xffffffffu, L[3][e], 4);
    if (seg == 0) prev = 0.f;
    P[0][e] = prev;
#pragma unroll
    for (int j = 1; j < 4; ++j) P[j][e] = L[j - 1][e];
  }
}

// a lane's share of x . y over a row of K floats (columns lane, lane + 32)
template <int K>
__device__ __forceinline__ float lane_dot(const float* x, const float* y, int lane) {
  float a = 0.f;
#pragma unroll
  for (int j = lane; j < K; j += 32) a = fmaf(x[j], y[j], a);
  return a;
}

// N sums over the warp at once (a butterfly each, interleaved): every lane
// ends with the totals, in a fixed order
template <int N>
__device__ __forceinline__ void warp_sums(float (&a)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < N; ++q) a[q] += __shfl_xor_sync(0xffffffffu, a[q], o);
  }
}

// 16 bytes from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of `threads` threads (whole warps) on id (1 to 15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- passes 1 and 2: the walks ----------------------------------------------

constexpr int kWalkCtasPerSm = 5;

template <int K>
struct WalkLayout {
  static constexpr int VB = K < 32 ? K : 32;  // value columns a CTA
  static constexpr int QS = K + 4;            // X [kTile][QS]: ke or q
  static constexpr int VS = VB + 8;           // W [kTile][VS]: v or dy columns
  // the stage: k, g, v (states) or r, g, dy (cotangents), [kTile][K] each
  static constexpr int kArray = kTile * K * 4;
  static constexpr int kX = 3 * kArray;
  static constexpr int kW = kX + kTile * QS * 4;
  static constexpr int kLe = kW + kTile * VS * 4;  // Le [K]
  static constexpr int kBar = kLe + K * 4;
  static constexpr int kBytes = kBar + 8;
};

template <int K>
__global__ void __launch_bounds__(kThreads, kWalkCtasPerSm)
wkv_bwd_walk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ dy, const float* __restrict__ dstate,
                    float* __restrict__ s0, float* __restrict__ gh, int BH, int S,
                    float g_min) {
  using Lay = WalkLayout<K>;
  constexpr int VB = Lay::VB, QS = Lay::QS, VS = Lay::VS, NT = VB / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* raw = reinterpret_cast<const float*>(smem);
  float* X = reinterpret_cast<float*>(smem + Lay::kX);
  float* W = reinterpret_cast<float*>(smem + Lay::kW);
  float* Le = reinterpret_cast<float*>(smem + Lay::kLe);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lay::kBar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // the grid's first half walks the states, its second the cotangents
  const bool cot = blockIdx.x >= BH * (K / VB);
  const int blk = blockIdx.x - (cot ? BH * (K / VB) : 0);
  const int bh = blk / (K / VB), jv = blk % (K / VB) * VB;
  const long long base = (long long)bh * S * K;
  const int ntiles = (S + kTile - 1) / kTile;
  const float* const src[3] = {cot ? r : k, g, cot ? dy : v};

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_tile = [&](int c) {
    const int t0 = c * kTile;
    const uint32_t bytes = min(kTile, S - t0) * K * 4u;
    mbar_expect_tx(bar, 3 * bytes);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      bulk_load(smem + a * Lay::kArray, src[a] + base + (long long)t0 * K, bytes, bar);
  };
  if (tid == kCopier) load_tile(cot ? ntiles - 1 : 0);

  // warp w owns rows 16 w .. 16 w + 15 of the state (or of G), every
  // column of the CTA's, as the forward's warps do
  const bool s_owner = K == 64 || 16 * warp < K;
  const int row = 16 * warp + gid;
  float st[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row + 8 * (e >> 1), j = jv + 8 * n + 2 * tig + (e & 1);
      st[n][e] = cot && dstate != nullptr && s_owner ? dstate[(long long)bh * K * K + i * K + j]
                                                     : 0.f;
    }
  }
  const int seg = lane >> 2, i0 = 16 * warp + 4 * (lane & 3);

  for (int it = 0; it < ntiles; ++it) {
    const int c = cot ? ntiles - 1 - it : it;
    const int rows = min(kTile, S - c * kTile);
    mbar_wait(bar, it & 1);
    __syncthreads();  // tile c staged; every read of the last tile done
    // the CTA's columns of v (dy), rows past S 0
    for (int idx = tid; idx < kTile * VB / 4; idx += kThreads) {
      const int t = idx / (VB / 4), c4 = idx % (VB / 4);
      *reinterpret_cast<float4*>(W + t * VS + 4 * c4) =
          t < rows ? load4(raw + 2 * kTile * K + t * K + jv + 4 * c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // 1. the scan; ke = k 2^{-L} (states) or q = r 2^{Lp} (cotangents)
    if (s_owner) {
      float L[4][4], P[4][4];
      decay_scan(raw + kTile * K, K, rows, g_min, seg, i0, L, P);
      if (seg == 7) {
#pragma unroll
        for (int e = 0; e < 4; ++e) Le[i0 + e] = L[3][e];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * seg + j;
        const float4 x4 = t < rows ? load4(raw + t * K + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float xx[4] = {x4.x, x4.y, x4.z, x4.w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = xx[e] * ex2(cot ? P[j][e] : -L[j][e]);
        *reinterpret_cast<float4*>(X + t * QS + i0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    fence_proxy_async();  // the stage is read: the TMA may write it again
    __syncthreads();      // X, W and Le in place
    if (tid == kCopier && it + 1 < ntiles) load_tile(cot ? c - 1 : c + 1);

    // 4. X^T W on the warp's rows; states: S0 out, then 2^{Le} (S0 + ke^T v);
    //    cotangents: Gh = 2^{Le} G out, then Gh + q^T dy
    if (s_owner) {
      Acc3 upd[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) zero(upd[n]);
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 8) {
        const FragA a = frag_a_km(X, QS, 16 * warp, k0, gid, tig);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma3(upd[n], a, frag_b_kn(W, VS, k0, 8 * n, gid, tig));
      }
      const float d0 = ex2(Le[row]), d1 = ex2(Le[row + 8]);
      float* out = (cot ? gh : s0) + ((long long)bh * ntiles + c) * K * K + row * K + jv +
                   2 * tig;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (cot) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] *= e < 2 ? d0 : d1;
        }
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(st[n][0], st[n][1]);
        *reinterpret_cast<float2*>(out + 8 * K + 8 * n) = make_float2(st[n][2], st[n][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sum = ((st[n][e] + upd[n].lo[e]) + upd[n].mid[e]) + upd[n].hi[e];
          st[n][e] = cot ? sum : sum * (e < 2 ? d0 : d1);
        }
      }
    }
  }
}

// ---- pass 3: the gradients of one tile ----------------------------------------

template <int K>
struct GradLayout {
  static constexpr int kThreads = 4 * K;  // 2 K / 16 warps: a 16 x 16 block each
  static constexpr int NW = kThreads / 32;
  static constexpr int QS = K + 4;        // [kTile][QS] and [K][QS] arrays
  static constexpr int AS = kTile + 4;    // dA, A [kTile][AS]
  static constexpr int kVec = kTile * QS;
  static constexpr int kMat = K * QS;
  // float offsets: r -> q, k -> ke, g -> L (in place), v, dy, dq, dke
  static constexpr int kQ = 0, kKE = kVec, kL = 2 * kVec, kV = 3 * kVec, kDY = 4 * kVec;
  static constexpr int kDQ = 5 * kVec, kDKE = 6 * kVec;
  static constexpr int kS0 = 7 * kVec, kGH = kS0 + kMat;
  static constexpr int kdA = kGH + kMat, kA = kdA + kTile * AS;
  static constexpr int kU = kA + kTile * AS;        // u [K]
  static constexpr int kBon = kU + K;               // bonus partials [K / 16][kTile]
  static constexpr int kDbon = kBon + K / 16 * kTile;  // rowsum(dy o v) [kTile]
  static constexpr int kDLe = kDbon + kTile;        // rowsum(Gh o S0) [K]
  static constexpr int kTP = kDLe + K;              // colsum(ke o X) a row block [2][K]
  static constexpr int kSeg = kTP + 2 * K;          // w summed a segment [4][K]
  static constexpr int kDu = kSeg + 4 * K;          // du a segment [4][K]
  static constexpr int kBytes = (kDu + 4 * K) * 4;
};

template <int K>
__global__ void __launch_bounds__(4 * K, 512 / (4 * K))
wkv_bwd_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ s0, const float* __restrict__ gh,
                    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dg, float* __restrict__ du_part, int H, int S,
                    float g_min) {
  using Lay = GradLayout<K>;
  constexpr int NT = Lay::kThreads, NW = Lay::NW, QS = Lay::QS, AS = Lay::AS;
  extern __shared__ __align__(16) float gsm[];
  float* Q = gsm + Lay::kQ;
  float* KE = gsm + Lay::kKE;
  float* Ls = gsm + Lay::kL;
  float* V = gsm + Lay::kV;
  float* DY = gsm + Lay::kDY;
  float* DQ = gsm + Lay::kDQ;
  float* DKE = gsm + Lay::kDKE;
  float* S0 = gsm + Lay::kS0;
  float* GH = gsm + Lay::kGH;
  float* dA = gsm + Lay::kdA;
  float* As = gsm + Lay::kA;
  float* U = gsm + Lay::kU;
  float* Bon = gsm + Lay::kBon;
  float* Dbon = gsm + Lay::kDbon;
  float* DLe = gsm + Lay::kDLe;
  float* TP = gsm + Lay::kTP;
  float* Seg = gsm + Lay::kSeg;
  float* Du = gsm + Lay::kDu;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / ntiles, c = blockIdx.x % ntiles, h = bh % H;
  const int t0 = c * kTile, rows = min(kTile, S - t0);
  const long long base = (long long)bh * S * K + (long long)t0 * K;
  const long long mat = ((long long)bh * ntiles + c) * K * K;

  // 0-1. The first K / 16 warps load the tile's r, k, g (rows past S
  //    zero-filled) and scan them in place (r -> q = r 2^{Lp}, k -> ke =
  //    k 2^{-L}, g -> L), with the bonus partials; the others load v, dy,
  //    then S0 and Gh, and form rowsum(dy o v) over the steps and
  //    rowsum(Gh o S0) over key rows.  Each half waits only for its own
  //    copies (a named barrier of its warps), so the scan runs while the
  //    other half's copies land.
  constexpr int NO = K / 16, HT = NT / 2;  // warps and threads a half
  auto load_rows = [&](int a, const float* src, int ht) {
    for (int idx = ht; idx < kTile * K / 4; idx += HT) {
      const int t = idx / (K / 4), c4 = idx % (K / 4) * 4;
      const bool ok = t < rows;
      cp_async_16(gsm + a * Lay::kVec + t * QS + c4,
                  src + base + (ok ? (long long)t * K + c4 : 0), ok);
    }
  };
  if (warp < NO) {
    load_rows(0, r, tid);
    load_rows(1, k, tid);
    load_rows(2, g, tid);
    cp_async_commit();
    for (int i = tid; i < K; i += HT) U[i] = u[h * K + i];
    cp_async_wait<0>();
    named_barrier(1, HT);
    const int seg = lane >> 2, i0 = 16 * warp + 4 * (lane & 3);
    float L[4][4], P[4][4];
    decay_scan(Ls, QS, kTile, g_min, seg, i0, L, P);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * seg + j, at = t * QS + i0;
      const float4 r4 = load4(Q + at), k4 = load4(KE + at);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w};
      float q[4], ke[4], bonus = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[e] = rr[e] * ex2(P[j][e]);
        ke[e] = kk[e] * ex2(-L[j][e]);
        bonus = fmaf(rr[e] * U[i0 + e], kk[e], bonus);
      }
      *reinterpret_cast<float4*>(Q + at) = make_float4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<float4*>(KE + at) = make_float4(ke[0], ke[1], ke[2], ke[3]);
      *reinterpret_cast<float4*>(Ls + at) = make_float4(L[j][0], L[j][1], L[j][2], L[j][3]);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
      if ((lane & 3) == 0) Bon[warp * kTile + t] = bonus;
    }
  } else {
    const int ht = tid - HT, ow = warp - NO;  // kTile / NO steps, 16 key rows a warp
    load_rows(3, v, ht);
    load_rows(4, dy, ht);
    cp_async_commit();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float* m = (a ? gh : s0) + mat;
      for (int idx = ht; idx < K * K / 4; idx += HT) {
        const int i = idx / (K / 4), c4 = idx % (K / 4) * 4;
        cp_async_16(gsm + Lay::kS0 + a * Lay::kMat + i * QS + c4, m + i * K + c4, true);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    named_barrier(2, HT);
    float a[kTile / NO], b[16];
#pragma unroll
    for (int q = 0; q < kTile / NO; ++q)
      a[q] = lane_dot<K>(DY + (ow + NO * q) * QS, V + (ow + NO * q) * QS, lane);
    warp_sums(a);
    cp_async_wait<0>();
    named_barrier(2, HT);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      b[q] = lane_dot<K>(GH + (ow + NO * q) * QS, S0 + (ow + NO * q) * QS, lane);
    warp_sums(b);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kTile / NO; ++q) Dbon[ow + NO * q] = a[q];
#pragma unroll
      for (int q = 0; q < 16; ++q) DLe[ow + NO * q] = b[q];
    }
  }
  __syncthreads();

  // 2. dA = strict-lower(dy v^T) and A = strict-lower(q ke^T) + diag(bonus),
  //    the three 16 x 16 blocks on or below the diagonal of each
  for (int job = warp; job < 6; job += NW) {
    const bool isA = job >= 3;
    const int blk = job % 3, mb = blk > 0, nb = blk > 1;
    const float* xa = isA ? Q : DY;
    const float* xb = isA ? KE : V;
    Acc3 w[2];
    zero(w[0]);
    zero(w[1]);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const FragA a = frag_a_mk(xa, QS, 16 * mb, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(w[n], a, frag_b_nk(xb, QS, k0, 16 * nb + 8 * n, gid, tig));
    }
    float* out = isA ? As : dA;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 16 * mb + gid + 8 * half;
      float bonus = 0.f;
      if (isA) {
#pragma unroll
        for (int b = 0; b < K / 16; ++b) bonus += Bon[b * kTile + t];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int s = 16 * nb + 8 * n + 2 * tig;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = s + e < t ? total(w[n], 2 * half + e) : s + e == t ? bonus : 0.f;
        *reinterpret_cast<float2*>(out + t * AS + s) = make_float2(o[0], o[1]);
      }
    }
  }
  __syncthreads();

  // 3. warp w: rows 16 mb .. (steps), columns n0 .. n0 + 15 of dq, dke, dv
  {
    const int mb = warp & 1, n0 = (warp >> 1) * 16, m0 = 16 * mb;
    Acc3 acc[2];
    auto store_smem = [&](float* dst) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* p = dst + (m0 + gid) * QS + n0 + 8 * n + 2 * tig;
        *reinterpret_cast<float2*>(p) = make_float2(total(acc[n], 0), total(acc[n], 1));
        *reinterpret_cast<float2*>(p + 8 * QS) = make_float2(total(acc[n], 2), total(acc[n], 3));
      }
    };
    // dq = dy S0^T + dA ke (dA is 0 past the row block's own steps)
    zero(acc[0]);
    zero(acc[1]);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const FragA a = frag_a_mk(DY, QS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_nk(S0, QS, k0, n0 + 8 * n, gid, tig));
    }
    for (int k0 = 0; k0 < m0 + 16; k0 += 8) {
      const FragA a = frag_a_mk(dA, AS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_kn(KE, QS, k0, n0 + 8 * n, gid, tig));
    }
    store_smem(DQ);
    // X = v Gh^T, its colsum(ke o X) over the row block, then dke = X + dA^T q
    zero(acc[0]);
    zero(acc[1]);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const FragA a = frag_a_mk(V, QS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_nk(GH, QS, k0, n0 + 8 * n, gid, tig));
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = n0 + 8 * n + 2 * tig + e;
        float p = KE[(m0 + gid) * QS + i] * total(acc[n], e);
        p = fmaf(KE[(m0 + gid + 8) * QS + i], total(acc[n], 2 + e), p);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (gid == 0) TP[mb * K + i] = p;
      }
    }
    for (int k0 = m0; k0 < kTile; k0 += 8) {  // dA[t, s] = 0 for t <= s
      const FragA a = frag_a_km(dA, AS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_kn(Q, QS, k0, n0 + 8 * n, gid, tig));
    }
    store_smem(DKE);
    // dv = A^T dy + ke Gh, straight out
    zero(acc[0]);
    zero(acc[1]);
    for (int k0 = m0; k0 < kTile; k0 += 8) {  // A[t, s] = 0 for t < s
      const FragA a = frag_a_km(As, AS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_kn(DY, QS, k0, n0 + 8 * n, gid, tig));
    }
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const FragA a = frag_a_mk(KE, QS, m0, k0, gid, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(acc[n], a, frag_b_kn(GH, QS, k0, n0 + 8 * n, gid, tig));
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int s = m0 + gid, col = n0 + 8 * n + 2 * tig;
      if (s < rows)
        store2(dv + base + (long long)s * K + col, total(acc[n], 0), total(acc[n], 1));
      if (s + 8 < rows)
        store2(dv + base + (long long)(s + 8) * K + col, total(acc[n], 2), total(acc[n], 3));
    }
  }
  __syncthreads();

  // 4. a thread a key channel i and the 8 steps of segment sg: dr, dk, the
  //    dg terms b = -ke dke and w = q dq + b, the du partial; then dg from
  //    the suffix sums of w, later segments' first, in a fixed order
  const int i = tid % K, sg = tid / K;  // 4 segments
  const float ui = U[i];
  // the segment's r, k, g from global memory (L2: this CTA just read them),
  // all requests in flight at once
  float rr[8], kk[8], gg[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = 8 * sg + j;
    const long long o = base + (long long)t * K + i;
    rr[j] = t < rows ? r[o] : 0.f;
    kk[j] = t < rows ? k[o] : 0.f;
    gg[j] = t < rows ? g[o] : 0.f;
  }
  float wt[8], bt[8], wsum = 0.f, du = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = 8 * sg + j, at = t * QS + i;
    const float dq = DQ[at], dke = DKE[at], db = Dbon[t];
    bt[j] = -KE[at] * dke;
    wt[j] = fmaf(Q[at], dq, bt[j]);
    wsum += wt[j];
    du = fmaf(rr[j] * kk[j], db, du);
    if (t < rows) {
      const long long o = base + (long long)t * K + i;
      dr[o] = fmaf(dq, ex2(t ? Ls[at - QS] : 0.f), ui * kk[j] * db);
      dk[o] = fmaf(dke, ex2(-Ls[at]), ui * rr[j] * db);
    }
  }
  Seg[sg * K + i] = wsum;
  Du[sg * K + i] = du;
  __syncthreads();
  float acc = (DLe[i] + TP[i]) + TP[K + i];
  for (int s = 3; s > sg; --s) acc += Seg[s * K + i];
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    const int t = 8 * sg + j;
    if (t < rows)
      dg[base + (long long)t * K + i] =
          (gg[j] > g_min && gg[j] < 0.f) ? acc + bt[j]
          : (gg[j] == g_min || gg[j] == 0.f) ? 0.5f * (acc + bt[j]) : 0.f;
    acc += wt[j];
  }
  if (sg == 0)
    du_part[((long long)bh * ntiles + c) * K + i] =
        ((Du[i] + Du[K + i]) + Du[2 * K + i]) + Du[3 * K + i];
}

template <typename Kernel>
int resources_of(Kernel kernel, int bytes, int threads, int* out) {
  cudaFuncAttributes attr;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = bytes;
  out[3] = n;
  return 0;
}

template <int K>
int launch_bwd(const float* r, const float* k, const float* v, const float* g,
               const float* u, const float* dy, const float* dstate, float* dr, float* dk,
               float* dv, float* dg, float* du_part, float* s0, float* gh, int BH, int H,
               int S, float g_min, cudaStream_t stream) {
  using WL = WalkLayout<K>;
  using GL = GradLayout<K>;
  auto walk = wkv_bwd_walk_kernel<K>;
  auto grad = wkv_bwd_grad_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, WL::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad, cudaFuncAttributeMaxDynamicSharedMemorySize, GL::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grad, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (S + kTile - 1) / kTile;
  walk<<<2 * BH * (K / WL::VB), kThreads, WL::kBytes, stream>>>(r, k, v, g, dy, dstate, s0,
                                                                  gh, BH, S, g_min);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad<<<BH * ntiles, GL::kThreads, GL::kBytes, stream>>>(r, k, v, g, u, dy, s0, gh, dr, dk,
                                                           dv, dg, du_part, H, S, g_min);
  return (int)cudaGetLastError();
}

template <int K>
int bwd_resources(int pass, int* out) {
  return pass ? resources_of(wkv_bwd_grad_kernel<K>, GradLayout<K>::kBytes,
                             GradLayout<K>::kThreads, out)
              : resources_of(wkv_bwd_walk_kernel<K>, WalkLayout<K>::kBytes, kThreads, out);
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

// The backward (fp32 only): dr, dk, dv, dg [BH, S, K] and du_part [BH,
// ntiles, K] (du of each (b, h) and 32-step tile, summed by the caller)
// from r, k, v, g, u and dy, and dstate [BH, K, K] (the final state's
// cotangent; null for none).  s0 and gh are fp32 workspaces of
// `wkv_bwd_workspace_floats` floats each (the tiles' states and scaled
// end cotangents).  Two kernels on `stream`: the walks, then the
// gradients.  BH, S >= 1, K in {16, 32, 64}, 16-byte aligned contiguous
// tensors.  Returns cudaGetLastError() after the launches.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v, const void* g,
                              const void* u, const void* dy, const void* dstate, void* dr,
                              void* dk, void* dv, void* dg, void* du_part, void* s0,
                              void* gh, int BH, int H, int S, int K, float g_min,
                              void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16:
      return launch_bwd<16>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(s0), m(gh), BH, H, S, g_min, s);
    case 32:
      return launch_bwd<32>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(s0), m(gh), BH, H, S, g_min, s);
    case 64:
      return launch_bwd<64>(f(r), f(k), f(v), f(g), f(u), f(dy), f(dstate), m(dr), m(dk),
                            m(dv), m(dg), m(du_part), m(s0), m(gh), BH, H, S, g_min, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The floats of one launch's buffers: which = 0 the states and 1 the scaled
// end cotangents (a [K, K] matrix a (b, h) and tile each), 2 the du
// partials (K a (b, h) and tile).
extern "C" long long wkv_bwd_workspace_floats(int BH, int S, int K, int which) {
  const long long tiles = (long long)BH * ((S + kTile - 1) / kTile);
  return which == 2 ? tiles * K : tiles * K * K;
}

// The backward kernel of pass (0: the walks, 1: the gradients) for key
// width K: out[0] registers a thread, out[1] local (spilled) bytes a
// thread, out[2] dynamic shared memory bytes a CTA, out[3] CTAs an SM (the
// occupancy calculator on the current device).  Returns a CUDA error code.
extern "C" int wkv_bwd_resources(int K, int pass, int* out) {
  switch (K) {
    case 16: return bwd_resources<16>(pass, out);
    case 32: return bwd_resources<32>(pass, out);
    case 64: return bwd_resources<64>(pass, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* wkv_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
