// Flash attention forward for Hopper (sm_90a), fp32 and bf16.
//
//   o[bh, q, :] = sum_k softmax_k(q[bh, q, :] . k[bh, k, :] * D^-1/2) v[bh, k, :]
//
//   q     [BH, S, D]   (the [B, H, S, D] tensor, contiguous)
//   k, v  [BH, T, D]   (T may differ from S)
//   o     [BH, S, D]   in q's dtype
//   lse   [BH, S]      fp32, optional: each row's log-sum-exp of the scaled
//                      scores, written beside o for the backward
//
// The backward (`flash_attention_bwd.cu`: `flash_bwd_dq_wgmma_kernel` and
// `flash_bwd_dkdv_wgmma_kernel` in bf16, `flash_bwd_dq_kernel` and
// `flash_bwd_dkdv_kernel` in fp32) takes q, k, v, o, dO and lse and writes
// dq, dk, dv.  The TMA tensor maps are `tensor_map.cuh`'s, shared with it.
//
// With `causal`, query q sees key k only if k <= q (absolute indices, the
// same mask for S != T).  Scores, the running max and the running sum are
// fp32; p is rounded to v's dtype before P.V, which accumulates in fp32; the
// output is acc / max(l, 1e-30).  Any S and T: ragged query rows are not
// stored and ragged keys are masked.  D is 32, 64 or 128.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:20,59).  That kernel keeps the whole
// [T, D] K and V panels of one (b, h) resident in VMEM and walks them in kv
// blocks; 227 KB of shared memory cannot hold them at T = 4096, so here K and
// V stream through a ring of shared-memory tiles under an fp32 online
// softmax, and the CTAs of the last (longest, when causal) query tiles are
// launched first.
//
// bf16 (bound by operations: 4*D flops per unmasked (q, k) pair against
// 989 TFLOP/s, which only `wgmma` reaches):
//   * one CTA per (b*h, 128-query tile): two warpgroups of 4 warps, each
//     warpgroup owning 64 query rows (16 a warp), both reading one K/V ring;
//   * Q, and K and V in tiles of 128 keys (64 at D = 128), arrive by TMA
//     (3-d tensor maps over [BH, rows, D], 128-byte swizzle, 64-byte at
//     D = 32, ragged rows zero-filled) into a 2-stage ring completing on
//     mbarriers; thread 0 refills a stage as soon as both warpgroups are
//     done with it, so the next tile is in flight while this one is
//     multiplied;
//   * S = Q.K^T is `wgmma.mma_async` m64nNk16 with Q and K read from shared
//     memory by descriptor; O += P.V takes P from registers as the A operand
//     (S's accumulator layout is P's A fragment layout, rounded to bf16) and
//     V from shared memory with the transpose flag, so V is read row-major
//     as it arrives;
//   * exp2 with scale*log2(e) folded into one FMA; the mask is applied only
//     by the warps whose rows cross the tile's diagonal or the ragged end of
//     the keys; a warpgroup skips the tiles wholly above its diagonal;
//   * two CTAs share an SM (81 KB of shared memory at D = 64, 97 KB at
//     D = 128; at most 128 registers a thread), so one warpgroup's softmax
//     overlaps the others' products, and each K/V tile read from L2 serves
//     128 query rows.
//
// fp32 (FFMA only, no TF32: the reference bound is 2e-5; bound by
// operations against 67 TFLOP/s):
//   * one CTA per (b*h, 64-query tile), 4 warps; each thread owns RQ query
//     rows in both products, so the softmax rescale stays in registers;
//   * Q is staged once, transposed ([D][query]); K and V tiles (64 keys,
//     32 at D = 128) are double-buffered by cp.async; p goes to a [key][query]
//     tile that only the threads of the same rows read;
//   * register blocking: a thread forms an RQ x 4 block of scores from
//     float4 reads of Q^T (a broadcast) and K, and an RQ x D/TK block of the
//     output from float4 reads of P^T (a broadcast) and V: 8-16 FMAs per
//     shared load; at D = 128 a CTA takes 107 KB, so two fit an SM.
//
// Each (query row, key) score and each row's sums are formed in a fixed
// order, so two launches give bitwise equal outputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper_sm90.cuh"
#include "tensor_map.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using sm90::smem_u32;

// 16 bytes from global to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16

constexpr int kBWG = 2;  // warpgroups per CTA, 64 query rows each
constexpr int kBQ = 64 * kBWG;
constexpr int kBThreads = 128 * kBWG;
constexpr int kBStages = 2;  // K/V tiles in the ring

template <int D>
struct BShape {
  static constexpr int BN = D == 128 ? 64 : 128;  // keys per tile
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle span, bytes
  static constexpr int kCols = SW / 2;            // bf16 columns of a swizzle block
  static constexpr int kBlocks = D / kCols;       // column blocks of a row
  static constexpr int kSwizzle = SW == 128 ? 1 : 2;  // descriptor code
  static constexpr int q_bytes = kBQ * D * 2;
  static constexpr int kv_bytes = BN * D * 2;      // one K or V tile
  // 1024 to align the ring to the swizzle atoms, the ring, Q, the barriers
  static constexpr int bytes = 1024 + q_bytes + kBStages * 2 * kv_bytes + 8 * (1 + kBStages);
};

// A tile of R rows sits in shared memory as kBlocks column blocks of
// [R][SW bytes], each written by one TMA box with the hardware's swizzle.
// Descriptor of k-step kk (16 columns) of such a tile read K-major (Q as A,
// K as B of S = Q.K^T): 8-row groups SW*8 bytes apart
template <int D, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int kk) {
  using B = BShape<D>;
  const int col = kk * 16;
  return sm90::make_desc(tile + (col / B::kCols) * R * B::SW + (col % B::kCols) * 2, 16,
                         8 * B::SW, B::kSwizzle);
}

// Descriptor of k-step j (16 keys) of a V tile read MN-major (B of P.V, the
// transpose flag): the next column block BN*SW bytes on, 8-key groups SW*8
// bytes apart
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int j) {
  using B = BShape<D>;
  return sm90::make_desc(tile + j * 16 * B::SW, B::BN * B::SW, 8 * B::SW, B::kSwizzle);
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 128) sm90::wgmma_ss_n128(d, a, b, accumulate);
  else sm90::wgmma_ss_n64(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (N == 128) sm90::wgmma_rs_n128(d, a, b);
  else if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, b);
  else sm90::wgmma_rs_n32(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kBThreads, 2)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                  float* __restrict__ lse, int BH, int S, int T_, float scale,
                  int n_qtiles) {
  using B = BShape<D>;
  constexpr int BN = B::BN;
  constexpr int NT = BN / 8;  // 8-key column groups of a score tile
  constexpr int ND = D / 8;   // 8-wide column groups of the output
  extern __shared__ unsigned char smem_raw[];
  // the ring (stage s: its K tile, then its V tile), Q, then the barriers of
  // Q and of each stage
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = ring + kBStages * 2 * B::kv_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Qs + B::q_bytes);

  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / BH);  // longest first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qtile * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;       // this thread's warpgroup
  const int gq0 = q0 + wg * 64;   // ... and its first row
  const int wq0 = q0 + warp * 16;  // this warp's first row
  const int row0 = wq0 + g, row1 = row0 + 8;
  const unsigned char* Qw = Qs + wg * 64 * B::SW;  // the warpgroup's Q rows
  const float sl2e = scale * kLog2e;

  int n_kt = (T_ + BN - 1) / BN;
  if (kCausal) n_kt = min(n_kt, (min(q0 + kBQ, S) - 1) / BN + 1);

  auto issue_kv = [&](int tile, int st) {
    unsigned char* ks = ring + 2 * st * B::kv_bytes;
    sm90::mbar_expect_tx(bars + 1 + st, 2 * B::kv_bytes);
#pragma unroll
    for (int b = 0; b < B::kBlocks; ++b) {
      sm90::tma_load_3d(ks + b * BN * B::SW, &tm_k, bars + 1 + st, b * B::kCols, tile * BN, bh);
      sm90::tma_load_3d(ks + B::kv_bytes + b * BN * B::SW, &tm_v, bars + 1 + st, b * B::kCols,
                        tile * BN, bh);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kBStages; ++i) sm90::mbar_init(bars + i, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bars, B::q_bytes);
#pragma unroll
    for (int b = 0; b < B::kBlocks; ++b)
      sm90::tma_load_3d(Qs + b * kBQ * B::SW, &tm_q, bars, b * B::kCols, q0, bh);
    for (int st = 0; st < kBStages && st < n_kt; ++st) issue_kv(st, st);
  }

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // m in log2 units
  float acc[D / 2];  // output rows row0 / row1, column group n: acc[4n .. 4n + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bars, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN, st = kt % kBStages;
    sm90::mbar_wait(bars + 1 + st, (kt / kBStages) & 1);
    const unsigned char* Ks = ring + 2 * st * B::kv_bytes;
    const unsigned char* Vs = Ks + B::kv_bytes;
    // a warpgroup whose rows all lie past S, or (causal) before the tile's
    // first key, only keeps the ring in step
    if (gq0 < S && !(kCausal && k0 > gq0 + 63)) {
      float s[BN / 2];  // scores: rows row0 / row1, key group j: s[4j .. 4j + 3]
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_qk<BN>(s, desc_kmajor<D, kBQ>(Qw, kk), desc_kmajor<D, BN>(Ks, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // mask only where this warp's rows cross the diagonal or the keys end
      if (k0 + BN > T_ || (kCausal && k0 + BN - 1 > wq0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + j * 8 + tig * 2 + (c & 1);
            const int row = c < 2 ? row0 : row1;
            if (key >= T_ || (kCausal && key > row)) s[4 * j + c] = -INFINITY;
          }
        }
      }
      // online softmax in log2 units
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * sl2e);
      const float mn1 = fmaxf(m1, quad_max(mx1) * sl2e);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2e, -mn0));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2e, -mn0));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2e, -mn1));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2e, -mn1));
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[4 * n] *= corr0;
        acc[4 * n + 1] *= corr0;
        acc[4 * n + 2] *= corr1;
        acc[4 * n + 3] *= corr1;
      }
      // the score accumulators of keys [16j, 16j + 16) are the A fragment of P
      // for that k-step; p rounds to bf16 here
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wgmma_pv<D>(acc, pa[j], desc_mnmajor<D>(Vs, j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && kt + kBStages < n_kt) issue_kv(kt + kBStages, st);
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  bf16* ob = o + (long long)bh * S * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + tig * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * D + c) =
          __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * D + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
  }
  // the rows' log-sum-exp of the scaled scores, natural units (a null
  // pointer writes nothing; o above is the same either way)
  if (lse != nullptr && tig == 0) {
    if (row0 < S) lse[(long long)bh * S + row0] = (m0 + log2f(d0)) * kLn2;
    if (row1 < S) lse[(long long)bh * S + row1] = (m1 + log2f(d1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fp32

constexpr int kFQ = 64;  // query rows per CTA
constexpr int kFThreads = 128;

template <int D>
struct FShape {
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per tile
  static constexpr int RQ = D == 128 ? 4 : 8;    // query rows per thread
  static constexpr int TK = kFThreads * RQ / kFQ;  // threads sharing those rows
  static constexpr int KT = BK / TK;             // keys per thread
  static constexpr int DC = D / TK;              // output columns per thread
  static constexpr int kRow = D + 4;             // K, V row stride, floats
  static constexpr int kQtRow = kFQ + 4;         // Q^T and P^T row stride
  static constexpr int stage = 2 * BK * kRow;    // K then V
  static constexpr int bytes = (2 * stage + D * kQtRow + BK * kQtRow) * 4;
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int first,
                                              int rows) {
  constexpr int BK = FShape<D>::BK, kRow = FShape<D>::kRow;
  for (int i = threadIdx.x; i < BK * (D / 4); i += kFThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = first + r < rows;
    cp_async_16(dst + r * kRow + c, src + (long long)(ok ? first + r : 0) * D + c, ok);
  }
}

__device__ __forceinline__ float group_max(float x, int width) {  // over `width` lanes
  for (int o = 1; o < width; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kFThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int S, int T_, float scale,
                 int n_qtiles) {
  using F = FShape<D>;
  constexpr int BK = F::BK, RQ = F::RQ, TK = F::TK, KT = F::KT, DC = F::DC;
  constexpr int kRow = F::kRow, kQtRow = F::kQtRow;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // stage s: K at s*stage, V after
  float* Qt = ring + 2 * F::stage;                   // [D][kQtRow]
  float* Pt = Qt + D * kQtRow;                       // [BK][kQtRow]

  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qtile * kFQ;
  const int tq = threadIdx.x / TK, tk = threadIdx.x % TK;
  const int r0 = tq * RQ;  // this thread's rows: q0 + r0 + i, i < RQ
  const float sl2e = scale * kLog2e;

  const float* qb = q + (long long)bh * S * D;
  const float* kb = k + (long long)bh * T_ * D;
  const float* vb = v + (long long)bh * T_ * D;

  int n_kt = (T_ + BK - 1) / BK;
  if (kCausal) n_kt = min(n_kt, (min(q0 + kFQ, S) - 1) / BK + 1);
  if (n_kt > 0) {
    load_tile_f32<D>(ring, kb, 0, T_);
    load_tile_f32<D>(ring + BK * kRow, vb, 0, T_);
  }
  cp_async_commit();
  // Q transposed, once: consecutive threads take consecutive rows
  for (int i = threadIdx.x; i < kFQ * (D / 4); i += kFThreads) {
    const int r = i % kFQ, c = (i / kFQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = __ldg(reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * D + c));
    Qt[(c + 0) * kQtRow + r] = x.x;
    Qt[(c + 1) * kQtRow + r] = x.y;
    Qt[(c + 2) * kQtRow + r] = x.z;
    Qt[(c + 3) * kQtRow + r] = x.w;
  }

  float m[RQ], l[RQ], acc[RQ][DC];  // m in log2 units
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q^T) visible; stage kt-1 and Pt free
    if (kt + 1 < n_kt) {
      float* ks = ring + ((kt + 1) & 1) * F::stage;
      load_tile_f32<D>(ks, kb, k0 + BK, T_);
      load_tile_f32<D>(ks + BK * kRow, vb, k0 + BK, T_);
    }
    cp_async_commit();
    const float* Ks = ring + (kt & 1) * F::stage;
    const float* Vs = Ks + BK * kRow;

    // scores of rows r0 + i and keys tk + TK * j
    float s[RQ][KT];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tk + TK * j) * kRow + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qv[RQ];
#pragma unroll
        for (int i = 0; i < RQ; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(Qt + (d + e) * kQtRow + r0 + i);
          qv[i] = x.x;
          qv[i + 1] = x.y;
          qv[i + 2] = x.z;
          qv[i + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const float kx = e == 0 ? kv[j].x : e == 1 ? kv[j].y : e == 2 ? kv[j].z : kv[j].w;
#pragma unroll
          for (int i = 0; i < RQ; ++i) s[i][j] = fmaf(qv[i], kx, s[i][j]);
        }
      }
    }

    if (k0 + BK > T_ || (kCausal && k0 + BK - 1 > q0 + r0)) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int key = k0 + tk + TK * j;
          if (key >= T_ || (kCausal && key > q0 + r0 + i)) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KT; ++j) mx = fmaxf(mx, s[i][j]);
      const float mn = fmaxf(m[i], group_max(mx, TK) * sl2e);
      const float corr = exp2f(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], sl2e, -mn));
        ps += s[i][j];
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    // p to P^T [key][row]: only the TK threads of these rows read it back
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int i = 0; i < RQ; i += 4)
        *reinterpret_cast<float4*>(Pt + (tk + TK * j) * kQtRow + r0 + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    __syncwarp();

    // acc[i][c] += sum over keys of p[row i][key] v[key][col c]; this
    // thread's columns: float4 chunks tk + TK * j (DC >= 4), else a float2
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(Pt + key * kQtRow + r0 + i);
        pv[i] = x.x;
        pv[i + 1] = x.y;
        pv[i + 2] = x.z;
        pv[i + 3] = x.w;
      }
      float vv[DC];
      if constexpr (DC >= 4) {
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              Vs + key * kRow + 4 * (tk + TK * (c / 4)));
          vv[c] = x.x;
          vv[c + 1] = x.y;
          vv[c + 2] = x.z;
          vv[c + 3] = x.w;
        }
      } else {
        const float2 x = *reinterpret_cast<const float2*>(Vs + key * kRow + DC * tk);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // Pt is rewritten by the next tile's scores
  }
  cp_async_wait<0>();

  float* ob = o + (long long)bh * S * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float tot = l[i];
    for (int off = 1; off < TK; off <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, off);
    const float den = fmaxf(tot, 1e-30f);
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    if (lse != nullptr && tk == 0) lse[(long long)bh * S + row] = (m[i] + log2f(den)) * kLn2;
    if constexpr (DC >= 4) {
#pragma unroll
      for (int c = 0; c < DC; c += 4)
        *reinterpret_cast<float4*>(ob + (long long)row * D + 4 * (tk + TK * (c / 4))) =
            make_float4(acc[i][c] / den, acc[i][c + 1] / den, acc[i][c + 2] / den,
                        acc[i][c + 3] / den);
    } else {
      *reinterpret_cast<float2*>(ob + (long long)row * D + DC * tk) =
          make_float2(acc[i][0] / den, acc[i][1] / den);
    }
  }
}

// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Lets `kernel` take `bytes` of dynamic shared memory on the current device,
// once per device and kernel (`set` is the kernel's own flags): the
// attribute stays with the function, so later calls pay no host call for it
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) set[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
           int T_, float scale, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  if constexpr (sizeof(T) == 2) {
    constexpr int bytes = BShape<D>::bytes;
    static_assert(BShape<D>::SW == sm90::swizzle_bytes(D), "the maps' swizzle is the tiles'");
    CUtensorMap tm_q, tm_k, tm_v;
    if (!sm90::tensor_map(&tm_q, q, BH, S, D, kBQ) ||  // no key: maps over q, never read
        !sm90::tensor_map(&tm_k, T_ > 0 ? k : q, BH, T_, D, BShape<D>::BN) ||
        !sm90::tensor_map(&tm_v, T_ > 0 ? v : q, BH, T_, D, BShape<D>::BN))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bf16_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, bytes, smem_set);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (S + kBQ - 1) / kBQ;
    kernel<<<(unsigned int)((long long)n_qtiles * BH), kBThreads, bytes, stream>>>(
        tm_q, tm_k, tm_v, static_cast<bf16*>(o), lse, BH, S, T_, scale, n_qtiles);
  } else {
    constexpr int bytes = FShape<D>::bytes;
    auto kernel = flash_f32_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, bytes, smem_set);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (S + kFQ - 1) / kFQ;
    kernel<<<(unsigned int)((long long)n_qtiles * BH), kFThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, BH, S, T_, scale,
        n_qtiles);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kCausal>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
             int S, int T_, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, kCausal>(q, k, v, o, lse, BH, S, T_, scale, stream);
    case 64: return launch<T, 64, kCausal>(q, k, v, o, lse, BH, S, T_, scale, stream);
    case 128: return launch<T, 128, kCausal>(q, k, v, o, lse, BH, S, T_, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  BH, S >= 1 (the wrapper
// returns early for an empty output), T >= 0 (no key gives 0 / 1e-30 = 0
// everywhere), D in {32, 64, 128}, bf16 = 1 for bf16
// inputs and output, 0 for fp32.  lse, where not null, receives each
// row's log-sum-exp of the scaled scores [BH, S] fp32 (natural units), the
// backward's input; null writes nothing.  Returns cudaGetLastError() after
// the launch; 0 means it was accepted.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int BH, int S, int T, int D,
                                      int bf16, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return causal ? launch_d<__nv_bfloat16, true>(q, k, v, o, l, BH, S, T, D, scale, s)
                  : launch_d<__nv_bfloat16, false>(q, k, v, o, l, BH, S, T, D, scale, s);
  return causal ? launch_d<float, true>(q, k, v, o, l, BH, S, T, D, scale, s)
                : launch_d<float, false>(q, k, v, o, l, BH, S, T, D, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
