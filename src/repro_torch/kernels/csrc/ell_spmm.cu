// ELLPACK SpMM (GNN neighbor aggregation), its transpose and the weight gradient
// of the attention-weighted form, for Hopper (sm_90a).
//
// Forward, `ell_spmm_launch`:
//
//   out[v, :] = sum_k mask[v, k] * H[ids[v, k], :]      (/ max(sum_k mask[v, k], 1))
//
//   ids  int32 [V, K]   neighbor row ids into H (slots with mask 0 are not read)
//   mask f32   [V, K]   0/1 structure, or edge weights (the GAT aggregation)
//   H    f32   [N, D]
//   out  f32   [V, D]
//
// Replaces the Pallas TPU kernel `_ell_spmm_kernel` / `ell_spmm_pallas`
// (src/repro/kernels/ell_spmm.py:26,38).  That kernel keeps a whole [N, 128]
// column panel of H resident in VMEM for each grid step; Hopper's 227 KB of
// shared memory cannot hold one, so the design here is a row gather instead:
//
//   * a block owns a tile of kWarps rows, one row per warp, and stages the
//     tile's ids and mask in shared memory kSlots slots at a time (the tile's
//     ids are contiguous in memory, so the staging loads coalesce);
//   * each warp walks its row's slots in increasing k and gathers the H row
//     of every slot whose mask is non-zero, 16 bytes per lane (float4) when
//     D % 4 == 0 and the pointers are 16-byte aligned, else 4 bytes per lane;
//     one warp covers 32 * kVecPerLane vectors of the row per pass over the
//     slots, and wider rows take further passes;
//   * the sum stays in registers and runs in a fixed k order, so the result
//     is deterministic: bitwise equal across launches.
//
// Row offsets are 64-bit: ids * D passes 2**31 on larger graphs.
//
// Bound on this card: bytes.  The function must read H's rows once, ids and
// mask once and write out once: N*D*4 + V*K*8 + V*D*4 bytes at 3.35 TB/s,
// against 2*nnz*D flops, far below the fp32 rate.  A gather that misses L2
// re-reads an H row for every edge that names it, so the time this kernel can
// reach sits between that bound and nnz*D*4 bytes over the same rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // rows per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = 64;        // slots of each row staged per pass
constexpr int kVecPerLane = 2;    // vectors of the row each lane sums per pass

__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }

__device__ __forceinline__ void fma_into(float4& acc, float m, const float4 h) {
  acc.x = fmaf(m, h.x, acc.x);
  acc.y = fmaf(m, h.y, acc.y);
  acc.z = fmaf(m, h.z, acc.z);
  acc.w = fmaf(m, h.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float m, const float h) { acc = fmaf(m, h, acc); }

__device__ __forceinline__ float4 divide(const float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}
__device__ __forceinline__ float divide(const float a, float d) { return a / d; }

template <typename T, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ ids, const float* __restrict__ mask,
                const T* __restrict__ H, T* __restrict__ out,
                long long V, int K, int DW /* row width in units of T */) {
  __shared__ int s_ids[kWarps * kSlots];
  __shared__ float s_mask[kWarps * kSlots];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kWarps;
  const long long left = V - row0;
  const int rows = left < kWarps ? (int)left : kWarps;
  const bool live = warp < rows;
  const int* my_ids = s_ids + warp * kSlots;
  const float* my_mask = s_mask + warp * kSlots;

  for (int c0 = 0; c0 < DW; c0 += 32 * kVecPerLane) {
    T acc[kVecPerLane];
#pragma unroll
    for (int r = 0; r < kVecPerLane; ++r) set_zero(acc[r]);
    float deg = 0.f;

    for (int k0 = 0; k0 < K; k0 += kSlots) {
      const int kt = (K - k0) < kSlots ? (K - k0) : kSlots;
      __syncthreads();  // every warp is done reading the previous stage
      for (int i = threadIdx.x; i < rows * kt; i += kThreads) {
        const int r = i / kt;
        const int j = i - r * kt;
        const long long src = (row0 + r) * (long long)K + k0 + j;
        s_ids[r * kSlots + j] = ids[src];
        s_mask[r * kSlots + j] = mask[src];
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int j = 0; j < kt; ++j) {
          const float m = my_mask[j];  // the same for the whole warp
          if (kNormalize) deg += m;
          if (m != 0.f) {
            const T* hrow = H + (long long)my_ids[j] * DW;
#pragma unroll
            for (int r = 0; r < kVecPerLane; ++r) {
              const int col = c0 + r * 32 + lane;
              if (col < DW) fma_into(acc[r], m, __ldg(hrow + col));
            }
          }
        }
      }
    }

    if (live) {
      T* orow = out + (row0 + warp) * (long long)DW;
      const float d = fmaxf(deg, 1.f);
#pragma unroll
      for (int r = 0; r < kVecPerLane; ++r) {
        const int col = c0 + r * 32 + lane;
        if (col < DW) orow[col] = kNormalize ? divide(acc[r], d) : acc[r];
      }
    }
  }
}

template <typename T>
void launch(const int* ids, const float* mask, const void* H, void* out,
            long long V, int K, int DW, bool normalize, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((V + kWarps - 1) / kWarps);
  if (normalize) {
    ell_spmm_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        ids, mask, static_cast<const T*>(H), static_cast<T*>(out), V, K, DW);
  } else {
    ell_spmm_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        ids, mask, static_cast<const T*>(H), static_cast<T*>(out), V, K, DW);
  }
}

// ---------------------------------------------------------------------------
// Backward, `ell_spmm_transpose_launch`: the gradient with respect to H.
//
//   dH[u, :] = sum over the slots s = v*K + k with ids[v, k] == u and
//              mask[v, k] != 0 of mask[v, k] * ct[v, :]
//
//   indptr int64 [N+1]  segment of row u: slots[indptr[u] : indptr[u+1]]
//   slots  int64 [nnz]  v*K + k of every slot with a non-zero mask, grouped by
//                       the row ids[v, k] it reads, increasing within a segment
//   mask   f32   [V, K]
//   ct     f32   [V, D] the cotangent of out (already divided by max(deg, 1)
//                       when the forward normalized: the wrapper does that)
//   dH     f32   [N, D]
//
// Replaces the gradient rule `_ell_spmm_bwd` (src/repro/kernels/ell_spmm.py:98),
// the custom_vjp around the Pallas call, where XLA scatter-adds
// mask[v,k] * ct[v] into dH[ids[v,k]].  A scatter on this card needs float
// atomics, whose order of arrival changes from run to run, and the JAX tiers
// assert bitwise determinism.  So the kernel reads a CSR transpose of the ELL
// table (`ell_transpose_plan`, built once per engine) and is a row gather again:
//
//   * one warp per row u of dH, kWarps rows per block; the warp stages its
//     segment 32 slots at a time (one per lane: v = slot / K and its mask) in
//     its own stretch of shared memory, then every lane walks the staged
//     slots in order and gathers ct[v] 16 bytes per lane (float4) when
//     D % 4 == 0 and the pointers are 16-byte aligned, else 4 bytes per lane;
//   * the sum stays in registers and runs in the plan's fixed slot order: no
//     atomics, bitwise equal across launches;
//   * every row is written: an empty segment (the zero pad row of a gather
//     table among them) gives zeros, so dH needs no clearing pass.
//
// Row offsets are 64-bit, as in the forward.
//
// Bound on this card: bytes.  The function must read every ct row that some
// slot names once, the plan (nnz * 8 + (N+1) * 8) and each slot's mask
// (nnz * 4), and write dH once (N * D * 4), against 2 * nnz * D flops.  Like
// the forward, a gather that misses L2 re-reads a ct row for every slot that
// names it (nnz * D * 4 bytes).

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmm_transpose_kernel(const long long* __restrict__ indptr,
                          const long long* __restrict__ slots,
                          const float* __restrict__ mask,
                          const T* __restrict__ ct, T* __restrict__ dH,
                          long long N, int K, int DW /* row width in units of T */) {
  __shared__ long long s_v[kWarps * 32];
  __shared__ float s_m[kWarps * 32];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= N) return;  // warps never synchronize across the block
  long long* my_v = s_v + warp * 32;
  float* my_m = s_m + warp * 32;
  const long long p0 = indptr[u];
  const long long p1 = indptr[u + 1];
  T* orow = dH + u * (long long)DW;

  for (int c0 = 0; c0 < DW; c0 += 32 * kVecPerLane) {
    T acc[kVecPerLane];
#pragma unroll
    for (int r = 0; r < kVecPerLane; ++r) set_zero(acc[r]);

    for (long long p = p0; p < p1; p += 32) {
      const int n = (p1 - p) < 32 ? (int)(p1 - p) : 32;
      __syncwarp();  // every lane is done reading the previous stage
      if (lane < n) {
        const long long s = slots[p + lane];
        my_v[lane] = s / K;
        my_m[lane] = mask[s];
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float m = my_m[j];  // the same for the whole warp
        const T* crow = ct + my_v[j] * (long long)DW;
#pragma unroll
        for (int r = 0; r < kVecPerLane; ++r) {
          const int col = c0 + r * 32 + lane;
          if (col < DW) fma_into(acc[r], m, __ldg(crow + col));
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kVecPerLane; ++r) {
      const int col = c0 + r * 32 + lane;
      if (col < DW) orow[col] = acc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient of the attention-weighted sum, `ell_attend_dw_launch`:
//
//   dw[v, k] = ct[v, :] . H[ids[v, k], :]      for every slot, masked or not
//
//   ids  int32 [V, K]   every id in [0, N) (a masked slot names a valid row:
//                       the zero pad row on the engine's layouts)
//   ct   f32   [V, D]   the cotangent of out = sum_k w[v, k] * H[ids[v, k]]
//   H    f32   [N, D]
//   dw   f32   [V, K]
//
// Replaces the dw half of the gradient rule `_ell_attend_bwd`
// (src/repro/kernels/ell_spmm.py:129, dw at :137), where XLA gathers
// H[ids] as a [V, K, D] block and reduces it against ct; `ell_attend`'s dH
// is the transpose kernel above with the weights in the mask lane.
//
//   * one warp per row v, kWarps rows per block.  Each slot takes a group of
//     G lanes, G a power of two sized to the row width W (in 16-byte float4
//     units when D % 4 == 0 and both pointers are 16-byte aligned, else in
//     4-byte floats): the largest G whose last pass over the row leaves at
//     most an eighth of the group's lanes idle (`pick_group`).  So a warp
//     covers 32 / G slots per step: at D = 64 (W = 16) a half-warp per
//     slot, at the odd fused widths 33, 65, 129, 257 (the 4-byte path)
//     groups of 4, 8, 16 and 32 lanes with 9 floats a lane;
//   * the warp loads its row's ids 32 at a time, coalesced (lane j holds
//     ids[v, k0 + j]), and hands each group its slot's id by shuffle, so no
//     gather waits on an id load; ct[v] is read once per row into registers
//     (U = 1, 2 or 9 units a lane, the units past the row's predicated off)
//     and serves every slot;
//   * the gathers of kSteps slot steps are issued together before any
//     product (kSteps * U >= 8 loads a lane where the row leaves room), so
//     8 or more independent loads of H are in flight per lane;
//   * each lane sums its units in increasing order and the group reduces in
//     a fixed xor butterfly, so dw is bitwise equal across launches; steps
//     past the row's last slot (K = 1, a row's tail) are not reduced.
//   Rows wider than 9 * 32 units take the general form: a full warp per
//   slot, a loop over the units, ct read from L1.
//
// Bound on this card: bytes.  The function must read every H row some slot
// names once, ct, ids once and write dw once, against 2*V*K*D flops.  Like
// the forward, a gather that misses L2 re-reads an H row for every slot that
// names it (V*K*D*4 bytes).

constexpr int kDwMaxUnits = 9;  // units a lane keeps in registers per slot
constexpr int kDwInFlight = 8;  // loads of H a lane issues together, at least

__device__ __forceinline__ float dot_into(float acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_into(float acc, const float a, const float b) {
  return fmaf(a, b, acc);
}

// G lanes per slot and U units per lane (U = 0: the general form, a loop
// over the units); kSteps slot steps of 32 / G slots each are in flight
template <typename T, int G, int U>
__global__ void __launch_bounds__(kThreads)
ell_attend_dw_kernel(const int* __restrict__ ids, const T* __restrict__ ct,
                     const T* __restrict__ H, float* __restrict__ dw,
                     long long V, int K, int DW /* row width in units of T */) {
  constexpr int kPerStep = 32 / G;  // slots a warp covers per step
  constexpr int kWant = (kDwInFlight + (U > 0 ? U : 1) - 1) / (U > 0 ? U : 1);
  constexpr int kSteps = kWant < G ? kWant : G;  // kSteps * kPerStep <= 32
  constexpr int kBatch = kSteps * kPerStep;  // slots per pass, divides 32
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G, col = lane % G;
  const long long v = (long long)blockIdx.x * kWarps + warp;
  if (v >= V) return;  // whole warps leave together: the shuffles stay full
  const T* crow = ct + v * (long long)DW;
  const int* my_ids = ids + v * (long long)K;
  float* my_dw = dw + v * (long long)K;

  T c[U > 0 ? U : 1];
  if constexpr (U > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = col + u * G;
      if (i < DW) c[u] = __ldg(crow + i); else set_zero(c[u]);
    }
  }
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int id_lane = k0 + lane < K ? __ldg(my_ids + k0 + lane) : 0;
    const int n = min(32, K - k0);
    for (int s0 = 0; s0 < n; s0 += kBatch) {
      float p[kSteps];
      if constexpr (U > 0) {
        T h[kSteps][U];
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          const int slot = s0 + r * kPerStep + sub;
          const int id = __shfl_sync(0xffffffffu, id_lane, slot);
          const T* hrow = H + (long long)id * DW;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = col + u * G;
            if (slot < n && i < DW) h[r][u] = __ldg(hrow + i); else set_zero(h[r][u]);
          }
        }
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          p[r] = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) p[r] = dot_into(p[r], c[u], h[r][u]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          const int slot = s0 + r * kPerStep + sub;
          const int id = __shfl_sync(0xffffffffu, id_lane, slot);
          const T* hrow = H + (long long)id * DW;
          p[r] = 0.f;
          if (slot < n)
            for (int i = col; i < DW; i += G) p[r] = dot_into(p[r], __ldg(crow + i), __ldg(hrow + i));
        }
      }
#pragma unroll
      for (int r = 0; r < kSteps; ++r) {
        // a step past the row's last slot: skipped by the whole warp
        if (kSteps > 1 && s0 + r * kPerStep >= n) break;
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
        const int slot = s0 + r * kPerStep + sub;
        if (col == 0 && slot < n) my_dw[k0 + slot] = p[r];
      }
    }
  }
}

// The group size for a row of W units: the largest power of two G <= 32
// with ceil(W / G) <= kDwMaxUnits whose last pass leaves at most an eighth
// of the G * ceil(W / G) lane-units idle, else the one that idles least;
// 0 when even G = 32 needs more than kDwMaxUnits units a lane
int pick_group(int W) {
  int best = 0, best_idle = 1 << 30;
  for (int G = 32; G >= 1; G >>= 1) {
    const int units = (W + G - 1) / G;
    if (units > kDwMaxUnits) break;
    const int idle = units * G - W;
    if (idle * 8 <= units * G) return G;
    if (idle < best_idle) best = G, best_idle = idle;
  }
  return best;
}

template <typename T, int G>
void launch_dw_g(const int* ids, const T* ct, const T* H, float* dw, long long V,
                 int K, int DW, cudaStream_t s) {
  const unsigned int blocks = (unsigned int)((V + kWarps - 1) / kWarps);
  const int units = (DW + G - 1) / G;
  if (units <= 1)
    ell_attend_dw_kernel<T, G, 1><<<blocks, kThreads, 0, s>>>(ids, ct, H, dw, V, K, DW);
  else if (units <= 2)
    ell_attend_dw_kernel<T, G, 2><<<blocks, kThreads, 0, s>>>(ids, ct, H, dw, V, K, DW);
  else  // 3-9 units: the lanes past the row's units are predicated off
    ell_attend_dw_kernel<T, G, kDwMaxUnits><<<blocks, kThreads, 0, s>>>(ids, ct, H, dw, V, K, DW);
}

template <typename T>
void launch_dw(const int* ids, const T* ct, const T* H, float* dw, long long V, int K,
               int DW, cudaStream_t s) {
  switch (pick_group(DW)) {
    case 1: return launch_dw_g<T, 1>(ids, ct, H, dw, V, K, DW, s);
    case 2: return launch_dw_g<T, 2>(ids, ct, H, dw, V, K, DW, s);
    case 4: return launch_dw_g<T, 4>(ids, ct, H, dw, V, K, DW, s);
    case 8: return launch_dw_g<T, 8>(ids, ct, H, dw, V, K, DW, s);
    case 16: return launch_dw_g<T, 16>(ids, ct, H, dw, V, K, DW, s);
    case 32: return launch_dw_g<T, 32>(ids, ct, H, dw, V, K, DW, s);
    default: {
      const unsigned int blocks = (unsigned int)((V + kWarps - 1) / kWarps);
      ell_attend_dw_kernel<T, 32, 0><<<blocks, kThreads, 0, s>>>(ids, ct, H, dw, V, K, DW);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  V >= 1 and D >= 1: the wrapper
// returns early for empty shapes.  Returns cudaGetLastError() after the
// launch; 0 means it was accepted.
extern "C" int ell_spmm_launch(const void* ids, const void* mask, const void* H, void* out,
                               long long V, int K, int D, int normalize, void* stream) {
  const bool vec4 = (D % 4 == 0) && ((uintptr_t)H % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int* ids_i = static_cast<const int*>(ids);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<float4>(ids_i, mask_f, H, out, V, K, D / 4, normalize != 0, s);
  } else {
    launch<float>(ids_i, mask_f, H, out, V, K, D, normalize != 0, s);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the transpose.  N >= 1 and D >= 1: the wrapper
// returns early for empty shapes.  Returns cudaGetLastError() after the launch.
extern "C" int ell_spmm_transpose_launch(const void* indptr, const void* slots,
                                         const void* mask, const void* ct, void* dH,
                                         long long N, int K, int D, void* stream) {
  const bool vec4 = (D % 4 == 0) && ((uintptr_t)ct % 16 == 0) && ((uintptr_t)dH % 16 == 0);
  const long long* indptr_i = static_cast<const long long*>(indptr);
  const long long* slots_i = static_cast<const long long*>(slots);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)((N + kWarps - 1) / kWarps);
  if (vec4) {
    ell_spmm_transpose_kernel<float4><<<blocks, kThreads, 0, s>>>(
        indptr_i, slots_i, mask_f, static_cast<const float4*>(ct),
        static_cast<float4*>(dH), N, K, D / 4);
  } else {
    ell_spmm_transpose_kernel<float><<<blocks, kThreads, 0, s>>>(
        indptr_i, slots_i, mask_f, static_cast<const float*>(ct),
        static_cast<float*>(dH), N, K, D);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the weight gradient.  V >= 1 and K >= 1: the wrapper
// returns early for empty shapes.  Returns cudaGetLastError() after the launch.
extern "C" int ell_attend_dw_launch(const void* ids, const void* ct, const void* H,
                                    void* dw, long long V, int K, int D, void* stream) {
  const bool vec4 = (D % 4 == 0) && ((uintptr_t)ct % 16 == 0) && ((uintptr_t)H % 16 == 0);
  const int* ids_i = static_cast<const int*>(ids);
  float* dw_f = static_cast<float*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    launch_dw<float4>(ids_i, static_cast<const float4*>(ct), static_cast<const float4*>(H),
                      dw_f, V, K, D / 4, s);
  else
    launch_dw<float>(ids_i, static_cast<const float*>(ct), static_cast<const float*>(H),
                     dw_f, V, K, D, s);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
