// Flash attention forward for Hopper (sm_90a), fp32 and bf16.
//
//   o[bh, q, :] = sum_k softmax_k(q[bh, q, :] . k[bh, k, :] * D^-1/2) v[bh, k, :]
//
//   q     [BH, S, D]   (the [B, H, S, D] tensor, contiguous)
//   k, v  [BH, T, D]   (T may differ from S)
//   o     [BH, S, D]   in q's dtype
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
// V stream through shared memory in 64-key tiles:
//
//   * one CTA per (b*h, 64-query tile), 4 warps of 16 query rows each; the
//     CTAs of the last (longest, when causal) query tiles are launched first;
//   * bf16: the warp's Q rows sit in registers as mma A fragments;
//     S = Q.K^T and P.V are `mma.sync.aligned.m16n8k16` bf16 products with
//     fp32 accumulation.  K is staged row-major and V transposed ([D][key]),
//     each row padded by 16 bytes, so every B-fragment load is one 4-byte
//     word per lane with no bank conflict.  S's accumulator layout is the A
//     fragment layout of P, so p goes from registers to the second product
//     without shared memory;
//   * fp32: FFMA only (no TF32: the reference bound is 2e-5).  Q, K and V
//     tiles in shared memory; each lane computes the same accumulator entries
//     as in the bf16 layout, from float4 loads; p goes through a per-warp
//     [16][64] tile of shared memory into P.V;
//   * causal: the key tiles wholly above the diagonal are skipped, the others
//     masked per element.
//
// Bound on this card: operations for bf16 at S = T = 4096 (4*D flops per
// unmasked (q, k) pair against 989 TFLOP/s; q, k, v, o once against
// 3.35 TB/s), operations for fp32 (against 67 TFLOP/s).  This first version
// does not overlap the tile loads with the products (no cp.async, TMA or
// wgmma): that is later work.
//
// Each (query row, key) score and each row's sums are formed in a fixed
// order, so two launches give bitwise equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQTile = 64;  // query rows per CTA
constexpr int kKTile = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;   // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kKTile + 4;  // fp32 p tile row, floats

typedef __nv_bfloat16 bf16;

template <typename T, int D>
struct Layout;

template <int D>
struct Layout<bf16, D> {  // Ks [key][D + 8], Vt [D][key + 8], bf16
  static constexpr int kRow = D + 8;
  static constexpr int kVtRow = kKTile + 8;
  static constexpr int bytes = (kKTile * kRow + D * kVtRow) * 2;
};

template <int D>
struct Layout<float, D> {  // Qs, Ks, Vs [row][D + 4], Ps [warp][16][68], fp32
  static constexpr int kRow = D + 4;
  static constexpr int bytes = (3 * kQTile * kRow + kWarps * 16 * kPStride) * 4;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a . b over a 16 x 8 x 16 bf16 tile, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dot4(float acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [0, 64) of a [rows, D] panel from row `first` into shared memory with
// row stride `stride` elements, 16 bytes per load; rows past `rows` are 0
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src,
                                           int first, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kKTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (long long)(first + r) * D + c));
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int BH, int S,
                       int T_, float scale, int n_qtiles) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int NT = kKTile / 8;  // 8-key column tiles of a score tile
  constexpr int ND = D / 8;       // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / BH);  // longest first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qtile * kQTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const T* qb = q + (long long)bh * S * D;
  const T* kb = k + (long long)bh * T_ * D;
  const T* vb = v + (long long)bh * T_ * D;

  int n_kt = (T_ + kKTile - 1) / kKTile;
  if (kCausal) n_kt = min(n_kt, (min(q0 + kQTile, S) - 1) / kKTile + 1);

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // bf16: this warp's Q rows as A fragments; fp32: Q staged in shared memory
  uint32_t qa[kBf16 ? D / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      const uint32_t* r0p = reinterpret_cast<const uint32_t*>(qb + (long long)row0 * D + c);
      const uint32_t* r1p = reinterpret_cast<const uint32_t*>(qb + (long long)row1 * D + c);
      qa[kk][0] = row0 < S ? __ldg(r0p) : 0u;
      qa[kk][1] = row1 < S ? __ldg(r1p) : 0u;
      qa[kk][2] = row0 < S ? __ldg(r0p + 4) : 0u;
      qa[kk][3] = row1 < S ? __ldg(r1p + 4) : 0u;
    }
  } else {
    stage_rows<float, D>(reinterpret_cast<float*>(smem_raw), Layout<float, D>::kRow,
                         reinterpret_cast<const float*>(qb), q0, S);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKTile;
    __syncthreads();  // the previous tile's readers are done
    float s[NT][4];
    if constexpr (kBf16) {
      bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
      bf16* Vt = Ks + kKTile * Layout<bf16, D>::kRow;
      constexpr int kRow = Layout<bf16, D>::kRow, kVtRow = Layout<bf16, D>::kVtRow;
      stage_rows<bf16, D>(Ks, kRow, kb, k0, T_);
      for (int i = threadIdx.x; i < kKTile * (D / 8); i += kThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < T_)
          val = __ldg(reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * D + c));
        const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[(c + j) * kVtRow + r] = e[j];
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const bf16* kr = Ks + (nt * 8 + g) * kRow + tig * 2;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
          mma_bf16(s[nt], qa[kk], b0, b1);
        }
      }
    } else {
      constexpr int kRow = Layout<float, D>::kRow;
      float* Qs = reinterpret_cast<float*>(smem_raw);
      float* Ks = Qs + kQTile * kRow;
      float* Vs = Ks + kKTile * kRow;
      stage_rows<float, D>(Ks, kRow, reinterpret_cast<const float*>(kb), k0, T_);
      stage_rows<float, D>(Vs, kRow, reinterpret_cast<const float*>(vb), k0, T_);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const float* qr0 = Qs + (warp * 16 + g) * kRow;
      const float* qr1 = qr0 + 8 * kRow;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qr0 + d);
        const float4 a1 = *reinterpret_cast<const float4*>(qr1 + d);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 b = *reinterpret_cast<const float4*>(
                Ks + (nt * 8 + tig * 2 + e) * kRow + d);
            s[nt][e] = dot4(s[nt][e], a0, b);
            s[nt][2 + e] = dot4(s[nt][2 + e], a1, b);
          }
        }
      }
    }

    // scale, mask, online softmax (rows row0: entries 0-1, row1: 2-3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + nt * 8 + tig * 2 + (c & 1);
        const int row = c < 2 ? row0 : row1;
        const bool seen = key < T_ && (!kCausal || key <= row);
        s[nt][c] = seen ? s[nt][c] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    if constexpr (kBf16) {
      constexpr int kVtRow = Layout<bf16, D>::kVtRow;
      const bf16* Vt = reinterpret_cast<const bf16*>(smem_raw) + kKTile * Layout<bf16, D>::kRow;
#pragma unroll
      for (int j = 0; j < kKTile / 16; ++j) {
        // the score accumulators of key columns [16j, 16j + 16) are the A
        // fragment of P for that k-step; p rounds to bf16 here
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const bf16* vr = Vt + (n * 8 + g) * kVtRow + j * 16 + tig * 2;
          mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                   *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
    } else {
      constexpr int kRow = Layout<float, D>::kRow;
      const float* Vs = reinterpret_cast<const float*>(smem_raw) + 2 * kQTile * kRow;
      float* Ps = reinterpret_cast<float*>(smem_raw) + 3 * kQTile * kRow + warp * 16 * kPStride;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(Ps + g * kPStride + nt * 8 + tig * 2) =
            make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(Ps + (g + 8) * kPStride + nt * 8 + tig * 2) =
            make_float2(s[nt][2], s[nt][3]);
      }
      __syncwarp();
      for (int key = 0; key < kKTile; key += 4) {
        const float4 pa = *reinterpret_cast<const float4*>(Ps + g * kPStride + key);
        const float4 pb = *reinterpret_cast<const float4*>(Ps + (g + 8) * kPStride + key);
        const float p0[4] = {pa.x, pa.y, pa.z, pa.w}, p1[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const float2 vv = *reinterpret_cast<const float2*>(
                Vs + (key + e) * kRow + n * 8 + tig * 2);
            acc[n][0] = fmaf(p0[e], vv.x, acc[n][0]);
            acc[n][1] = fmaf(p0[e], vv.y, acc[n][1]);
            acc[n][2] = fmaf(p1[e], vv.x, acc[n][2]);
            acc[n][3] = fmaf(p1[e], vv.y, acc[n][3]);
          }
        }
      }
      __syncwarp();  // Ps is rewritten by the next tile
    }
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  T* ob = o + (long long)bh * S * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + tig * 2;
    if constexpr (kBf16) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * D + c) =
            __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * D + c) =
            __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
    } else {
      if (row0 < S)
        *reinterpret_cast<float2*>(ob + (long long)row0 * D + c) =
            make_float2(acc[n][0] / d0, acc[n][1] / d0);
      if (row1 < S)
        *reinterpret_cast<float2*>(ob + (long long)row1 * D + c) =
            make_float2(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

template <typename T, int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int T_, float scale, cudaStream_t stream) {
  const int bytes = Layout<T, D>::bytes;
  auto kernel = flash_attention_kernel<T, D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const unsigned int blocks = (unsigned int)((long long)n_qtiles * BH);
  kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH, S, T_, scale, n_qtiles);
  return (int)cudaGetLastError();
}

template <typename T, bool kCausal>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH, int S,
             int T_, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, kCausal>(q, k, v, o, BH, S, T_, scale, stream);
    case 64: return launch<T, 64, kCausal>(q, k, v, o, BH, S, T_, scale, stream);
    case 128: return launch<T, 128, kCausal>(q, k, v, o, BH, S, T_, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  BH, S >= 1 (the wrapper
// returns early for an empty output), T >= 0 (no key gives 0 / 1e-30 = 0
// everywhere), D in {32, 64, 128}, bf16 = 1 for bf16
// inputs and output, 0 for fp32.  Returns cudaGetLastError() after the
// launch; 0 means it was accepted.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int BH, int S, int T, int D, int bf16,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return causal ? launch_d<__nv_bfloat16, true>(q, k, v, o, BH, S, T, D, scale, s)
                  : launch_d<__nv_bfloat16, false>(q, k, v, o, BH, S, T, D, scale, s);
  return causal ? launch_d<float, true>(q, k, v, o, BH, S, T, D, scale, s)
                : launch_d<float, false>(q, k, v, o, BH, S, T, D, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
