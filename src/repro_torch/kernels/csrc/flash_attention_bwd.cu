// Flash attention backward for Hopper (sm_90a): the gradient of the forward
// in `flash_attention.cu`, bf16 and fp32, causal or not, D in {32, 64, 128}.
//
//   q, o, dO, dq  [BH, S, D]   k, v, dk, dv  [BH, T, D]   lse  [BH, S] fp32
//
// From q, k, v, o, dO and the forward's LSE (each row's log-sum-exp of the
// scaled scores): P = exp(s * scale - lse) is recomputed from q and k,
// dP = dO . V^T, delta = rowsum(dO o O), dS = P (dP - delta); dQ = scale
// dS . K, dK = scale dS^T . Q, dV = P^T . dO.  Two launches on one stream:
// the dQ pass, which also writes delta [BH, S] fp32, then the dK/dV pass,
// which reads it.  A source of its own, so nvcc builds it beside the
// forward's (`kernels/build.py` starts one compiler a source, all at once).
//
// Replaces JAX's autodiff of the reference's `chunked_attention`
// (src/repro/models/layers.py:167): the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:20) has no gradient rule.
//
// Bound by operations: five products of 2 D flops per unmasked (q, k) pair
// (S and dP recomputed, dQ, dK, dV), seven over the two passes (each pass
// recomputes S and dP), against 989 TFLOP/s in bf16, which only `wgmma`
// reaches; the bytes (each operand read once) are under a tenth of that at
// S = T = 4096.
//
// Why two passes: each pass owns its output rows (dQ the queries, dK/dV the
// keys), so every sum is formed in one place in a fixed order, with no float
// atomics, and two launches are bitwise equal.  One pass over key tiles would
// have to sum dQ across CTAs: by atomics (order-dependent bits) or through a
// per-key-tile dQ partial, 32 tiles x [B, H, S, D] fp32 = 2.1 GB at B 2, H
// 32, S 4096, D 64.  The price is S and dP formed twice.
//
// bf16 (tensor cores; every sum fp32; P rounded to bf16 before dV = P^T.dO,
// as the forward's P.V rounds it; dS rounded to bf16 before dQ and dK):
//   * a CTA owns 128 rows (queries in the dQ pass, keys in the dK/dV pass)
//     as two consumer warpgroups of 64; its own rows of two operands are
//     loaded once by TMA and stay resident, the other side streams in tiles
//     by TMA (3-d tensor maps over [BH, rows, D], 128-byte swizzle, 64-byte
//     at D = 32, ragged rows zero-filled; `tensor_map.cuh`'s maps, shared
//     with the forward) through a ring of stages completing on mbarriers,
//     so the next tiles are in flight while this one is multiplied;
//   * dK/dV pass (`flash_bwd_dkdv_wgmma_kernel`): K and V resident, Q and dO
//     stream in tiles of BQ queries (64; 32 at D = 128, for the registers).
//     S^T = K.Q^T and dP^T = V.dO^T are `wgmma` m64nBQk16 with both operands
//     read K-major from shared memory as they arrive; S^T, not S, so that its
//     accumulator layout (rows keys, columns queries) is the A fragment of
//     the next products: P^T and dS^T go from registers as A, and dO and Q
//     are read MN-major (the transpose flag), row-major as they arrive:
//     dV += P^T.dO and dK += dS^T.Q are `wgmma` m64nDk16.  dK and dV stay
//     in registers and are stored once (dK times scale).  Warp-specialised:
//     a third, producer warpgroup hands its registers to the consumers
//     (`setmaxnreg`: 40 and 232 a thread, from 168 at launch; dK, dV, S^T,
//     dP^T and the two fragments are 176 at D = 128), and its first warp
//     fills a 3-stage ring, each stage with its tile's lse (log2 units) and
//     delta beside Q and dO, as soon as all 8 consumer warps have released
//     the stage (`empty` barriers); the consumer warpgroups never wait for
//     each other, so one's exponentials overlap the other's products.  With
//     causal the walk starts at the first query tile that reaches the CTA's
//     first key, and a warpgroup skips the tiles wholly before its keys; key
//     tile 0 (the longest walk) launches first;
//   * dQ pass (`flash_bwd_dq_wgmma_kernel`): Q and dO resident, K and V
//     stream in tiles of 64 keys through a 2-stage ring that thread 0
//     refills once both warpgroups are done with a stage.  S = Q.K^T and
//     dP = dO.V^T by `wgmma` from shared memory; dQ += dS.K with dS from
//     registers and K read MN-major.  delta is formed first from O and dO
//     (a quarter row a lane, summed over the quad in a fixed order) and
//     written for the second pass.  At D <= 64 it is built for two CTAs an
//     SM (at most 128 registers a thread), which interleave their phases;
//     the query tiles of the longest walks launch first; a warpgroup skips
//     key tiles wholly above its diagonal;
//   * each tile's products are issued as three groups: S, then dP, then the
//     gradient products; P's exponentials run while dP is multiplied, and
//     (dK/dV) dS is formed while dV is;
//   * masks are applied only by the warps whose rows cross the diagonal or
//     the ragged end: P = dS = 0 for keys past T (dQ pass), for queries past
//     S (dK/dV pass: their lse and delta are not data) and above the
//     diagonal;
//   * resources on the H100 (ptxas, `flash_attention_bwd_resources`), D =
//     32 / 64 / 128: dQ 106 / 122 / 154 registers, 33.8 / 66.6 / 132.1 KB,
//     2 / 2 / 1 CTAs an SM; dK/dV 168 registers at launch, 43.6 / 84.5 /
//     116.5 KB, 1 CTA an SM; no spill.
//
// fp32 (SIMT, fp32 arithmetic; no TF32 under the fp32 bound of 1e-5 + 1e-4
// relative): one CTA of 256 threads owns 64 rows (queries for dQ, keys for
// dK/dV), walks the other side in tiles of 64 rows staged in shared memory
// (no double buffer), and each thread forms a 4 x 4 block of the tile's
// scores (rows tr + 16a, columns tc + 16b: conflict-free float4 reads) and
// a 4-row block of its outputs; dS stays fp32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper_sm90.cuh"
#include "tensor_map.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

using sm90::smem_u32;

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by TMA

constexpr int kWThreads = 256;  // two warpgroups, 64 of the CTA's rows each
constexpr int kWRows = 128;     // rows a CTA owns: queries (dQ), keys (dK/dV)
constexpr int kWStages = 2;     // streamed tiles in the dQ pass's ring
constexpr int kPStages = 3;     // ... and in the dK/dV pass's
// dK/dV: the two consumer warpgroups and a producer warpgroup, whose
// registers a thread move from the producer to the consumers once the CTA
// starts (128 (40 + 2 x 232) <= 65,536; 168 each at launch)
constexpr int kPThreads = kWThreads + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
struct WShape {
  static constexpr int SW = D >= 64 ? 128 : 64;       // swizzle span, bytes
  static constexpr int kCols = SW / 2;                // bf16 columns of a swizzle block
  static constexpr int kBlocks = D / kCols;           // column blocks of a row
  static constexpr int kSwizzle = SW == 128 ? 1 : 2;  // descriptor code
  static constexpr int BN = 64;                       // keys a tile (dQ pass)
  static constexpr int BQ = D == 128 ? 32 : 64;       // queries a tile (dK/dV pass)
  static constexpr int own_bytes = kWRows * D * 2;    // one resident operand
  static constexpr int dq_stage = 2 * BN * D * 2;     // a K and a V tile
  static constexpr int dkdv_stage = 2 * BQ * D * 2;   // a Q and a dO tile
  // 1024 to align the tiles to the swizzle atoms, the ring, the two resident
  // operands, the barriers (the resident pair's, then each stage's: dQ one,
  // dK/dV full and empty), and in the dK/dV pass each stage's lse and delta
  static constexpr int dq_bytes = 1024 + kWStages * dq_stage + 2 * own_bytes + 8 * (1 + kWStages);
  static constexpr int dkdv_bytes = 1024 + kPStages * dkdv_stage + 2 * own_bytes +
                                    8 * (1 + 2 * kPStages) + kPStages * 2 * BQ * 4;
  // CTAs an SM the dQ pass is built for: two (at most 128 registers a
  // thread) where their shared memory fits, so that one CTA's exponentials
  // overlap the other's products
  static constexpr int dq_ctas = D <= 64 ? 2 : 1;
};

// A tile of R rows sits in shared memory as kBlocks column blocks of
// [R][SW bytes], each written by one TMA box with the hardware's swizzle.
// Descriptor of k-step kk (16 columns of D) of such a tile read K-major (A
// or B of a product over D): 8-row groups SW * 8 bytes apart
template <int D, int R>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int kk) {
  using W = WShape<D>;
  const int col = kk * 16;
  return sm90::make_desc(tile + (col / W::kCols) * R * W::SW + (col % W::kCols) * 2, 16,
                         8 * W::SW, W::kSwizzle);
}

// Descriptor of k-step j (rows [16j, 16j + 16)) of such a tile read MN-major
// (B of a product over its rows, the transpose flag): the next column block
// R * SW bytes on, 8-row groups SW * 8 bytes apart
template <int D, int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int j) {
  using W = WShape<D>;
  return sm90::make_desc(tile + j * 16 * W::SW, R * W::SW, 8 * W::SW, W::kSwizzle);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 128) sm90::wgmma_ss_n128(d, a, b, accumulate);
  else if constexpr (N == 64) sm90::wgmma_ss_n64(d, a, b, accumulate);
  else sm90::wgmma_ss_n32(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (N == 128) sm90::wgmma_rs_n128(d, a, b);
  else if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, b);
  else sm90::wgmma_rs_n32(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// An m64nN fp32 accumulator x (rows r0 / r0 + 8, column group j: x[4j ..
// 4j + 3]) rounded to bf16 as the A fragments of a product over its columns:
// k-step j (columns [16j, 16j + 16)) is a[4j .. 4j + 3]
template <int N>
__device__ __forceinline__ void to_fragments(uint32_t (&a)[N / 4], const float (&x)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[4 * j] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[4 * j + 1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[4 * j + 2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[4 * j + 3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

__device__ __forceinline__ float quad_sum(float x) {  // over the 4 lanes of a row
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// lane tig's quarter of rowsum(dO o O) of the row at `off`: columns
// [tig D/4, (tig + 1) D/4) in order, 16-byte loads
template <int D>
__device__ __forceinline__ float delta_quarter(const bf16* o, const bf16* dout, long long off,
                                               int tig) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    const long long at = off + tig * (D / 4) + 8 * c;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(o + at));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(dout + at));
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
  return acc;
}

// one thread's 2 rows of a [rows, D] bf16 output from an m64nD accumulator
// (column group n: acc[4n .. 4n + 3]), times mul, rows past `rows` not stored
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2], float mul,
                                          int row0, int rows, int tig) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (row0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row0 * D + c) =
          __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (row1 < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row1 * D + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWThreads, WShape<D>::dq_ctas)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, bf16* __restrict__ dq,
                          float* __restrict__ delta, int BH, int S, int T_, float scale,
                          int n_qtiles) {
  using W = WShape<D>;
  constexpr int BN = W::BN;
  extern __shared__ unsigned char smem_raw[];
  // the ring (stage s: its K tile, then its V tile), Q, dO, then the
  // barriers of Q and dO and of each stage
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = ring + kWStages * W::dq_stage;
  unsigned char* dOs = Qs + W::own_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + W::own_bytes);

  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / BH);  // longest first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qtile * kWRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;        // this thread's warpgroup
  const int gq0 = q0 + wg * 64;    // ... and its first row
  const int wq0 = q0 + warp * 16;  // this warp's first row
  const int row0 = wq0 + g, row1 = row0 + 8;
  const unsigned char* Qw = Qs + wg * 64 * W::SW;  // the warpgroup's rows
  const unsigned char* dOw = dOs + wg * 64 * W::SW;
  const float sl2e = scale * kLog2e;

  int n_kt = (T_ + BN - 1) / BN;
  if (kCausal) n_kt = min(n_kt, (min(q0 + kWRows, S) - 1) / BN + 1);

  auto issue_kv = [&](int tile, int st) {
    unsigned char* ks = ring + st * W::dq_stage;
    sm90::mbar_expect_tx(bars + 1 + st, W::dq_stage);
#pragma unroll
    for (int b = 0; b < W::kBlocks; ++b) {
      sm90::tma_load_3d(ks + b * BN * W::SW, &tm_k, bars + 1 + st, b * W::kCols, tile * BN, bh);
      sm90::tma_load_3d(ks + W::dq_stage / 2 + b * BN * W::SW, &tm_v, bars + 1 + st,
                        b * W::kCols, tile * BN, bh);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kWStages; ++i) sm90::mbar_init(bars + i, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bars, 2 * W::own_bytes);
#pragma unroll
    for (int b = 0; b < W::kBlocks; ++b) {
      sm90::tma_load_3d(Qs + b * kWRows * W::SW, &tm_q, bars, b * W::kCols, q0, bh);
      sm90::tma_load_3d(dOs + b * kWRows * W::SW, &tm_do, bars, b * W::kCols, q0, bh);
    }
    for (int st = 0; st < kWStages && st < n_kt; ++st) issue_kv(st, st);
  }

  // while the tiles arrive: delta of rows row0 / row1 (written for the
  // dK/dV pass) and their lse in log2 units, 0 past S
  const long long qoff = (long long)bh * S * D;
  float dl0 = row0 < S ? delta_quarter<D>(o, dout, qoff + (long long)row0 * D, tig) : 0.f;
  float dl1 = row1 < S ? delta_quarter<D>(o, dout, qoff + (long long)row1 * D, tig) : 0.f;
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (tig == 0) {
    if (row0 < S) delta[(long long)bh * S + row0] = dl0;
    if (row1 < S) delta[(long long)bh * S + row1] = dl1;
  }
  const float l20 = row0 < S ? lse[(long long)bh * S + row0] * kLog2e : 0.f;
  const float l21 = row1 < S ? lse[(long long)bh * S + row1] * kLog2e : 0.f;

  float acc[D / 2];  // dQ rows row0 / row1, column group n: acc[4n .. 4n + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bars, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN, st = kt % kWStages;
    sm90::mbar_wait(bars + 1 + st, (kt / kWStages) & 1);
    const unsigned char* Ks = ring + st * W::dq_stage;
    const unsigned char* Vs = Ks + W::dq_stage / 2;
    // a warpgroup whose rows all lie past S, or (causal) before the tile's
    // first key, only keeps the ring in step
    if (gq0 < S && !(kCausal && k0 > gq0 + 63)) {
      float s[BN / 2], dp[BN / 2];  // rows row0 / row1, key group j: [4j .. 4j + 3]
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(s, desc_kmajor<D, kWRows>(Qw, kk), desc_kmajor<D, BN>(Ks, kk), kk > 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(dp, desc_kmajor<D, kWRows>(dOw, kk), desc_kmajor<D, BN>(Vs, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S is in; dP is still being multiplied
      sm90::fence_regs(s);
      // P = exp(s scale - lse), 0 past the keys and (causal) above the
      // diagonal: masked only where this warp's rows cross either
      if (k0 + BN > T_ || (kCausal && k0 + BN - 1 > wq0)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + j * 8 + tig * 2 + (c & 1);
            if (key >= T_ || (kCausal && key > (c < 2 ? row0 : row1))) s[4 * j + c] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2e, -l20));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2e, -l20));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2e, -l21));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2e, -l21));
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {  // dS = P (dP - delta), in place
        s[4 * j] *= dp[4 * j] - dl0;
        s[4 * j + 1] *= dp[4 * j + 1] - dl0;
        s[4 * j + 2] *= dp[4 * j + 2] - dl1;
        s[4 * j + 3] *= dp[4 * j + 3] - dl1;
      }
      uint32_t da[BN / 4];
      to_fragments<BN>(da, s);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wgmma_rs<D>(acc, da + 4 * j, desc_mnmajor<D, BN>(Ks, j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && kt + kWStages < n_kt) issue_kv(kt + kWStages, st);
  }
  store_acc<D>(dq + qoff, acc, scale, row0, S, tig);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kPThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int S,
                            int T_, float scale) {
  using W = WShape<D>;
  constexpr int BQ = W::BQ;
  extern __shared__ unsigned char smem_raw[];
  // the ring (stage s: its Q tile, then its dO tile), K, V, the barriers (K
  // and V's, each stage's full, each stage's empty), then each stage's lse
  // (log2 units) and delta
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = ring + kPStages * W::dkdv_stage;
  unsigned char* Vs = Ks + W::own_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + W::own_bytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kPStages;
  float* stats = reinterpret_cast<float*>(empty + kPStages);  // [kPStages][2][BQ]

  const int k0 = (int)(blockIdx.x / BH) * kWRows;  // key tile 0, the longest, first
  const int bh = (int)(blockIdx.x % BH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the query tiles walked: with causal, from the first that reaches key k0
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = kCausal ? min(k0 / BQ, n_qt) : 0;
  const int n = n_qt - qt0;

  if (tid == 0) {
    sm90::mbar_init(bars, 1);
#pragma unroll
    for (int i = 0; i < kPStages; ++i) {
      sm90::mbar_init(full + i, 1);      // the producer's arrival, then the bytes
      sm90::mbar_init(empty + i, 8);     // one arrival a consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWThreads / 32) {
    // the producer warpgroup gives up its registers; its first warp loads K
    // and V once, then each query tile's Q and dO into the ring as soon as
    // its stage is empty, with the tile's lse and delta
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (warp != kWThreads / 32 || n == 0) return;
    if (lane == 0) {
      sm90::mbar_expect_tx(bars, 2 * W::own_bytes);
#pragma unroll
      for (int b = 0; b < W::kBlocks; ++b) {
        sm90::tma_load_3d(Ks + b * kWRows * W::SW, &tm_k, bars, b * W::kCols, k0, bh);
        sm90::tma_load_3d(Vs + b * kWRows * W::SW, &tm_v, bars, b * W::kCols, k0, bh);
      }
    }
    const float* lse_bh = lse + (long long)bh * S;
    const float* delta_bh = delta + (long long)bh * S;
    for (int i = 0; i < n; ++i) {
      const int st = i % kPStages, q0 = (qt0 + i) * BQ;
      if (i >= kPStages) sm90::mbar_wait(empty + st, (i / kPStages - 1) & 1);
      float* sp = stats + st * 2 * BQ;
#pragma unroll
      for (int e = lane; e < BQ; e += 32) {  // 0 past S: their P and dS are 0
        const bool in = q0 + e < S;
        sp[e] = in ? lse_bh[q0 + e] * kLog2e : 0.f;
        sp[BQ + e] = in ? delta_bh[q0 + e] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        unsigned char* qs = ring + st * W::dkdv_stage;
        sm90::mbar_expect_tx(full + st, W::dkdv_stage);  // releases the stats too
#pragma unroll
        for (int b = 0; b < W::kBlocks; ++b) {
          sm90::tma_load_3d(qs + b * BQ * W::SW, &tm_q, full + st, b * W::kCols, q0, bh);
          sm90::tma_load_3d(qs + W::dkdv_stage / 2 + b * BQ * W::SW, &tm_do, full + st,
                            b * W::kCols, q0, bh);
        }
      }
    }
    return;
  }

  // the two consumer warpgroups, each at its own pace
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;
  const int gk0 = k0 + wg * 64;    // the warpgroup's first key
  const int wk0 = k0 + warp * 16;  // the warp's
  const int key0 = wk0 + g, key1 = key0 + 8;
  const unsigned char* Kw = Ks + wg * 64 * W::SW;
  const unsigned char* Vw = Vs + wg * 64 * W::SW;
  const float sl2e = scale * kLog2e;

  float adk[D / 2], adv[D / 2];  // rows key0 / key1, column group n: [4n .. 4n + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  if (n > 0) sm90::mbar_wait(bars, 0);

  for (int i = 0; i < n; ++i) {
    const int q0 = (qt0 + i) * BQ, st = i % kPStages;
    sm90::mbar_wait(full + st, (i / kPStages) & 1);
    const unsigned char* Qt = ring + st * W::dkdv_stage;
    const unsigned char* dOt = Qt + W::dkdv_stage / 2;
    const float* l2s = stats + st * 2 * BQ;
    const float* dls = l2s + BQ;
    // a warpgroup whose keys all lie after the tile's last query (causal)
    // only hands the stage back
    if (!(kCausal && q0 + BQ - 1 < gk0)) {
      float s[BQ / 2], dp[BQ / 2];  // S^T, dP^T: rows key0 / key1, query group j
#pragma unroll
      for (int c = 0; c < BQ / 2; ++c) s[c] = dp[c] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, desc_kmajor<D, kWRows>(Kw, kk), desc_kmajor<D, BQ>(Qt, kk), kk > 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, desc_kmajor<D, kWRows>(Vw, kk), desc_kmajor<D, BQ>(dOt, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S^T is in; dP^T is still being multiplied
      sm90::fence_regs(s);
      // P^T = exp(s scale - lse), 0 for queries past S (their lse and delta
      // are not data) and (causal) where the key comes after the query:
      // masked only where this warp's keys cross the diagonal or the tile
      // crosses S
      if (q0 + BQ > S || (kCausal && q0 < wk0 + 15)) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = q0 + j * 8 + tig * 2 + (c & 1);
            if (q >= S || (kCausal && (c < 2 ? key0 : key1) > q)) s[4 * j + c] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(l2s + j * 8 + tig * 2);
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2e, -l2.x));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2e, -l2.y));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2e, -l2.x));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2e, -l2.y));
      }
      uint32_t pa[BQ / 4];
      to_fragments<BQ>(pa, s);  // P^T rounded to bf16, as the forward's P
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        wgmma_rs<D>(adv, pa + 4 * j, desc_mnmajor<D, BQ>(dOt, j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dP^T is in; dV is still being multiplied
      sm90::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {  // dS^T = P^T (dP^T - delta), in place
        const float2 dl = *reinterpret_cast<const float2*>(dls + j * 8 + tig * 2);
        s[4 * j] *= dp[4 * j] - dl.x;
        s[4 * j + 1] *= dp[4 * j + 1] - dl.y;
        s[4 * j + 2] *= dp[4 * j + 2] - dl.x;
        s[4 * j + 3] *= dp[4 * j + 3] - dl.y;
      }
      uint32_t da[BQ / 4];
      to_fragments<BQ>(da, s);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        wgmma_rs<D>(adk, da + 4 * j, desc_mnmajor<D, BQ>(Qt, j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(adv);
      sm90::fence_regs(adk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
    }
    __syncwarp();  // this warp is done with the stage: its products are in
    if (lane == 0) sm90::mbar_arrive(empty + st);
  }
  const long long koff = (long long)bh * T_ * D;
  store_acc<D>(dk + koff, adk, scale, key0, T_, tig);
  store_acc<D>(dv + koff, adv, 1.f, key0, T_, tig);
}

// ---------------------------------------------------------------------------
// fp32: SIMT (see the head comment)

constexpr int kGThreads = 256;
constexpr int kG = 64;  // rows a CTA owns, and rows a tile of the other side

template <int D>
struct GShape {
  static constexpr int kRow = D + 4;    // fp32 stride of an operand tile
  static constexpr int kPRow = kG + 4;  // stride of a [64][64] score tile
  static constexpr int tile = kG * kRow;
  static constexpr int CW = D / 16;  // output columns a thread
  static constexpr int dq_bytes = (4 * tile + kG * kPRow + 2 * kG) * 4;
  static constexpr int dkdv_bytes = (4 * tile + 2 * kG * kPRow + 2 * kG) * 4;
};

// rows [first, first + 64) of a [rows, D] tensor into a [64][kRow] fp32
// tile, zeros past `rows`
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int first, int rows) {
  for (int i = threadIdx.x; i < kG * (D / 4); i += kGThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < rows)
      x = *reinterpret_cast<const float4*>(src + (long long)(first + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * GShape<D>::kRow + c) = x;
  }
}

// s[a][b] = X[tr + 16 a] . Y[tc + 16 b] over D
template <int D>
__device__ __forceinline__ void dots(float (&s)[4][4], const float* X, const float* Y, int tr,
                                     int tc) {
  constexpr int R = GShape<D>::kRow;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = *reinterpret_cast<const float4*>(X + (tr + 16 * a) * R + d);
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = *reinterpret_cast<const float4*>(Y + (tc + 16 * b) * R + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float t = s[a][b];
        t = fmaf(x[a].x, y[b].x, t);
        t = fmaf(x[a].y, y[b].y, t);
        t = fmaf(x[a].z, y[b].z, t);
        s[a][b] = fmaf(x[a].w, y[b].w, t);
      }
  }
}

// the thread's output columns of one tile row: D >= 64, float4 chunks at
// 64 c + 4 tc; D = 32, the float2 at 2 tc
template <int D>
__device__ __forceinline__ void row_cols(float (&out)[GShape<D>::CW], const float* row, int tc) {
  if constexpr (D >= 64) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(row + 64 * c + 4 * tc);
      out[4 * c] = x.x;
      out[4 * c + 1] = x.y;
      out[4 * c + 2] = x.z;
      out[4 * c + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * tc);
    out[0] = x.x;
    out[1] = x.y;
  }
}
template <int D>
__device__ __forceinline__ int col_of(int tc, int i) {
  return D >= 64 ? 64 * (i / 4) + 4 * tc + (i % 4) : 2 * tc + i;
}

// the thread's 4 rows of outputs, times `mul`, at rows first + tr + 16 a < rows
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][GShape<D>::CW],
                                           float mul, int first, int rows, int tr, int tc) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = first + tr + 16 * a;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < GShape<D>::CW; i += 2)
      *reinterpret_cast<float2*>(dst + (long long)row * D + col_of<D>(tc, i)) =
          make_float2(acc[a][i] * mul, acc[a][i + 1] * mul);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kGThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, int BH, int S, int T_, float scale,
                    int n_qtiles) {
  using G = GShape<D>;
  constexpr int R = G::kRow, PR = G::kPRow, CW = G::CW;
  extern __shared__ __align__(16) float gsm[];
  float* Qs = gsm;
  float* dOs = Qs + G::tile;
  float* Ks = dOs + G::tile;
  float* Vs = Ks + G::tile;
  float* dSs = Vs + G::tile;   // [query][key]
  float* L2 = dSs + kG * PR;   // the rows' LSE in log2 units
  float* Dl = L2 + kG;         // the rows' delta

  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / BH);  // longest first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qtile * kG;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const float sl2e = scale * kLog2e;
  const long long qoff = (long long)bh * S * D, koff = (long long)bh * T_ * D;

  load_rows<D>(Qs, q + qoff, q0, S);
  load_rows<D>(dOs, dout + qoff, q0, S);
  {  // delta = rowsum(dO o O): 4 threads a row, then a fixed shuffle tree
    const int r = tid / 4, part = tid % 4;
    float acc = 0.f;
    if (q0 + r < S) {
      const float* orow = o + qoff + (long long)(q0 + r) * D;
      const float* drow = dout + qoff + (long long)(q0 + r) * D;
      for (int c = part * (D / 4); c < (part + 1) * (D / 4); c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const bool in = q0 + r < S;
      Dl[r] = acc;
      L2[r] = in ? lse[(long long)bh * S + q0 + r] * kLog2e : 0.f;
      if (in) delta[(long long)bh * S + q0 + r] = acc;
    }
  }

  float acc[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[a][i] = 0.f;
  int n_kt = (T_ + kG - 1) / kG;
  if (kCausal) n_kt = min(n_kt, (min(q0 + kG, S) - 1) / kG + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kG;
    __syncthreads();  // the last tile's reads are done (and Q, dO, delta staged)
    load_rows<D>(Ks, k + koff, k0, T_);
    load_rows<D>(Vs, v + koff, k0, T_);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, tr, tc);
    dots<D>(dp, dOs, Vs, tr, tc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ra = tr + 16 * a, row = q0 + ra;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cb = tc + 16 * b, key = k0 + cb;
        const bool ok = row < S && key < T_ && (!kCausal || key <= row);
        const float p = ok ? exp2f(fmaf(s[a][b], sl2e, -L2[ra])) : 0.f;
        dSs[ra * PR + cb] = p * (dp[a][b] - Dl[ra]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kG; ++key) {
      float kc[CW];
      row_cols<D>(kc, Ks + key * R, tc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dSs[(tr + 16 * a) * PR + key];
#pragma unroll
        for (int i = 0; i < CW; ++i) acc[a][i] = fmaf(ds, kc[i], acc[a][i]);
      }
    }
  }
  store_rows<D>(dq + qoff, acc, scale, q0, S, tr, tc);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kGThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int BH, int S, int T_,
                      float scale) {
  using G = GShape<D>;
  constexpr int R = G::kRow, PR = G::kPRow, CW = G::CW;
  extern __shared__ __align__(16) float gsm[];
  float* Ks = gsm;
  float* Vs = Ks + G::tile;
  float* Qs = Vs + G::tile;
  float* dOs = Qs + G::tile;
  float* Ps = dOs + G::tile;  // [key][query]
  float* dSs = Ps + kG * PR;  // [key][query]
  float* L2 = dSs + kG * PR;
  float* Dl = L2 + kG;

  const int k0 = (int)(blockIdx.x / BH) * kG;
  const int bh = (int)(blockIdx.x % BH);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const float sl2e = scale * kLog2e;
  const long long qoff = (long long)bh * S * D, koff = (long long)bh * T_ * D;

  load_rows<D>(Ks, k + koff, k0, T_);
  load_rows<D>(Vs, v + koff, k0, T_);
  float adk[4][CW], adv[4][CW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < CW; ++i) adk[a][i] = adv[a][i] = 0.f;
  const int n_qt = (S + kG - 1) / kG;
  for (int qt = kCausal ? k0 / kG : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kG;
    __syncthreads();  // the last tile's reads are done
    load_rows<D>(Qs, q + qoff, q0, S);
    load_rows<D>(dOs, dout + qoff, q0, S);
    if (tid < kG) {
      const bool in = q0 + tid < S;
      L2[tid] = in ? lse[(long long)bh * S + q0 + tid] * kLog2e : 0.f;
      Dl[tid] = in ? delta[(long long)bh * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(s, Ks, Qs, tr, tc);
    dots<D>(dp, Vs, dOs, tr, tc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ra = tr + 16 * a, key = k0 + ra;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cb = tc + 16 * b, row = q0 + cb;
        const bool ok = row < S && key < T_ && (!kCausal || key <= row);
        const float p = ok ? exp2f(fmaf(s[a][b], sl2e, -L2[cb])) : 0.f;
        Ps[ra * PR + cb] = p;
        dSs[ra * PR + cb] = p * (dp[a][b] - Dl[cb]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kG; ++j) {
      float oc[CW], qc[CW];
      row_cols<D>(oc, dOs + j * R, tc);
      row_cols<D>(qc, Qs + j * R, tc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Ps[(tr + 16 * a) * PR + j], ds = dSs[(tr + 16 * a) * PR + j];
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          adv[a][i] = fmaf(p, oc[i], adv[a][i]);
          adk[a][i] = fmaf(ds, qc[i], adk[a][i]);
        }
      }
    }
  }
  store_rows<D>(dk + koff, adk, scale, k0, T_, tr, tc);
  store_rows<D>(dv + koff, adv, 1.f, k0, T_, tr, tc);
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

// One launch of a pass; the arguments a pass does not read are null
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void* dq;
  float* delta;
  void *dk, *dv;
  int BH, S, T;
  float scale;
  cudaStream_t stream;
};

template <int D, bool kCausal>
int launch_bf16(const Args& a, bool dkdv) {
  using W = WShape<D>;
  static_assert(W::SW == sm90::swizzle_bytes(D), "the maps' swizzle is the tiles'");
  static std::atomic<bool> dq_set[kMaxDevices], dkdv_set[kMaxDevices];
  // a side with no row maps over the other side's tensor, never read
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int q_box = dkdv ? W::BQ : kWRows, k_box = dkdv ? kWRows : W::BN;
  if (!sm90::tensor_map(&tm_q, a.S > 0 ? a.q : a.k, a.BH, a.S, D, q_box) ||
      !sm90::tensor_map(&tm_do, a.S > 0 ? a.dout : a.k, a.BH, a.S, D, q_box) ||
      !sm90::tensor_map(&tm_k, a.T > 0 ? a.k : a.q, a.BH, a.T, D, k_box) ||
      !sm90::tensor_map(&tm_v, a.T > 0 ? a.v : a.q, a.BH, a.T, D, k_box))
    return (int)cudaErrorInvalidValue;
  if (!dkdv) {
    auto kernel = flash_bwd_dq_wgmma_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, W::dq_bytes, dq_set);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (a.S + kWRows - 1) / kWRows;
    kernel<<<(unsigned int)((long long)n_qtiles * a.BH), kWThreads, W::dq_bytes, a.stream>>>(
        tm_q, tm_k, tm_v, tm_do, static_cast<const bf16*>(a.o),
        static_cast<const bf16*>(a.dout), a.lse, static_cast<bf16*>(a.dq), a.delta, a.BH, a.S,
        a.T, a.scale, n_qtiles);
  } else {
    auto kernel = flash_bwd_dkdv_wgmma_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, W::dkdv_bytes, dkdv_set);
    if (err != cudaSuccess) return (int)err;
    const int n_ktiles = (a.T + kWRows - 1) / kWRows;
    kernel<<<(unsigned int)((long long)n_ktiles * a.BH), kPThreads, W::dkdv_bytes, a.stream>>>(
        tm_k, tm_v, tm_q, tm_do, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.BH, a.S, a.T, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D, bool kCausal>
int launch_f32(const Args& a, bool dkdv) {
  static std::atomic<bool> dq_set[kMaxDevices], dkdv_set[kMaxDevices];
  using G = GShape<D>;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  if (!dkdv) {
    auto kernel = flash_bwd_dq_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, G::dq_bytes, dq_set);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (a.S + kG - 1) / kG;
    kernel<<<(unsigned int)((long long)n_qtiles * a.BH), kGThreads, G::dq_bytes, a.stream>>>(
        q, k, v, static_cast<const float*>(a.o), dout, a.lse, static_cast<float*>(a.dq),
        a.delta, a.BH, a.S, a.T, a.scale, n_qtiles);
  } else {
    auto kernel = flash_bwd_dkdv_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, G::dkdv_bytes, dkdv_set);
    if (err != cudaSuccess) return (int)err;
    const int n_ktiles = (a.T + kG - 1) / kG;
    kernel<<<(unsigned int)((long long)n_ktiles * a.BH), kGThreads, G::dkdv_bytes, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.BH, a.S, a.T, a.scale);
  }
  return (int)cudaGetLastError();
}

// f(D, causal) with both as compile-time constants (std::integral_constant)
template <typename F>
int with_shape(int D, int causal, F&& f) {
  using std::integral_constant;
  switch (D) {
    case 32:
      return causal ? f(integral_constant<int, 32>(), std::true_type())
                    : f(integral_constant<int, 32>(), std::false_type());
    case 64:
      return causal ? f(integral_constant<int, 64>(), std::true_type())
                    : f(integral_constant<int, 64>(), std::false_type());
    case 128:
      return causal ? f(integral_constant<int, 128>(), std::true_type())
                    : f(integral_constant<int, 128>(), std::false_type());
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_pass(const Args& a, int D, int is_bf16, int causal, bool dkdv) {
  return with_shape(D, causal, [&](auto d, auto c) {
    constexpr int kD = decltype(d)::value;
    constexpr bool kC = decltype(c)::value;
    return is_bf16 ? launch_bf16<kD, kC>(a, dkdv) : launch_f32<kD, kC>(a, dkdv);
  });
}

// registers, local (spilled) bytes a thread, dynamic shared memory and CTAs
// an SM of `kernel` on the current device
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

}  // namespace

// The backward's two passes, launched in this order on one stream: dQ
// (which also writes delta [BH, S] fp32, rowsum(dO o O)), then dK and dV
// (which read it).  q, o, dout, dq [BH, S, D]; k, v, dk, dv [BH, T, D];
// lse [BH, S] from the forward; BH >= 1, S >= 1 for the dQ pass, T >= 1
// for the dK/dV pass; D in {32, 64, 128}; bf16 = 1 for bf16 tensors (the
// wgmma kernels, 16-byte aligned), 0 for fp32 (the SIMT kernels); scale
// D^-1/2.  Returns cudaGetLastError() after the launch; 0 means it was
// accepted.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout,
                                             const void* lse, void* dq, void* delta, int BH,
                                             int S, int T, int D, int bf16, int causal,
                                             float scale, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq,
               static_cast<float*>(delta), nullptr, nullptr, BH, S, T, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_pass(a, D, bf16, causal, false);
}

extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv,
                                               int BH, int S, int T, int D, int bf16,
                                               int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse), nullptr,
               const_cast<float*>(static_cast<const float*>(delta)), dk, dv, BH, S, T, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_pass(a, D, bf16, causal, true);
}

// The kernel of one pass (dkdv 0: dQ, 1: dK/dV) for D, dtype and causal:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// dynamic shared memory bytes a CTA, out[3] CTAs an SM (the occupancy
// calculator on the current device).  Returns a CUDA error code, 0 on
// success.
extern "C" int flash_attention_bwd_resources(int D, int bf16, int causal, int dkdv, int* out) {
  return with_shape(D, causal, [&](auto d, auto c) {
    constexpr int kD = decltype(d)::value;
    constexpr bool kC = decltype(c)::value;
    if (bf16)
      return dkdv ? resources_of(flash_bwd_dkdv_wgmma_kernel<kD, kC>, WShape<kD>::dkdv_bytes,
                                 kPThreads, out)
                  : resources_of(flash_bwd_dq_wgmma_kernel<kD, kC>, WShape<kD>::dq_bytes,
                                 kWThreads, out);
    return dkdv ? resources_of(flash_bwd_dkdv_kernel<kD, kC>, GShape<kD>::dkdv_bytes,
                               kGThreads, out)
                : resources_of(flash_bwd_dq_kernel<kD, kC>, GShape<kD>::dq_bytes,
                               kGThreads, out);
  });
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
