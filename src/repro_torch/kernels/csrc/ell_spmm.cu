// ELLPACK SpMM (GNN neighbor aggregation) for Hopper (sm_90a).
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

extern "C" const char* ell_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
