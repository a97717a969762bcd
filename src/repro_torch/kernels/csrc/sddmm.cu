// GAT edge logits over an ELL table (SDDMM) and the per-slot scalar transpose
// that its gradient needs, for Hopper (sm_90a).
//
// Forward, `sddmm_launch`:
//
//   e[v, k] = LeakyReLU(a_dst . Hw[v, :] + a_src . Hw[ids[v, k], :], slope)
//             for every slot with mask[v, k] > 0, and -1e30 for the others
//
//   ids   int32 [V, K]   neighbor row ids into Hw (masked slots are not read)
//   mask  f32   [V, K]
//   Hw    f32   [N, D]   N >= V: row v of the table is destination row v
//   a_src, a_dst f32 [D]
//   e     f32   [V, K]
//
// Replaces the Pallas TPU kernel `_sddmm_kernel` / `sddmm_pallas`
// (src/repro/kernels/sddmm.py:16,35).  That kernel keeps all of Hw resident
// for each row block and recomputes both products Hw . a for all N rows in
// every block of the grid.  Here the work splits into two passes:
//
//   * `sddmm_row_dots_kernel`: one warp per row n of Hw reads the row once
//     and takes both dots, s_src[n] = a_src . Hw[n] and (for n < V)
//     s_dst[n] = a_dst . Hw[n]; 16 bytes per lane (float4) when D % 4 == 0
//     and the pointers are 16-byte aligned, else 4 bytes per lane; each lane
//     sums its columns in increasing order and the warp reduces in a fixed
//     butterfly, so the result is bitwise equal across launches;
//   * `sddmm_slot_kernel`: one thread per slot, coalesced over the [V, K]
//     arrays, gathers the 4-byte s_src[ids[v, k]] (s_src is N * 4 bytes:
//     4 MiB at 2**20 rows, resident in the 50 MB L2) and applies the
//     LeakyReLU and the mask.
//
// Bound on this card: bytes.  The function must read Hw once (N*D*4), ids
// and mask once and write e once (V*K*12 bytes together), against about
// 4*N*D + 3*V*K flops.
//
// Transpose, `ell_slot_transpose_launch`:
//
//   g[u] = sum over the slots s = v*K + k with ids[v, k] == u and
//          mask[v, k] != 0 of dz[v, k]
//
//   indptr int64 [N+1], slots int64 [nnz]: the CSR transpose plan of the ELL
//          table (`ell_transpose_plan` in ell_spmm.py: unmasked slots grouped
//          by the row they read, increasing within a segment)
//   dz     f32   [V, K]
//   g      f32   [N]
//
// Replaces the scatter-add of the SDDMM gradient rule `_sddmm_bwd`
// (src/repro/kernels/sddmm.py:100, scatter at :109), where XLA adds dz into
// g_src[ids].  A scatter on this card needs float atomics, whose order changes
// from run to run; here each row's segment is summed in the plan's increasing
// slot order, so the result is bitwise deterministic.  The engine also uses it
// as the gradient of the gather s_col[ids] of the fused attention column.
//
// Bound on this card: bytes.  The plan (nnz*8 + (N+1)*8), dz at the listed
// slots (nnz*4) and g (N*4), against nnz adds.  dz is read at random: each
// read fetches a 32-byte sector for its 4 bytes.  At the gcn-paper layout
// (nnz 16.8 M, N 2**20) that is 134 MB of slots, 8 MB of indptr, 537 MB of
// dz sectors and 4 MB of g, about 0.68 GB or 0.2 ms at 3.35 TB/s.
//
// The design (one thread per row walking its segment took a chain of ~16
// dependent loads a row, and neighbouring threads read segments ~128 bytes
// apart, 32 sectors a warp load):
//
//   * a warp owns a tile of 32 consecutive rows, lane r row u0 + r.  Their
//     segments form one contiguous stretch of the plan;
//   * the warp reads the stretch in chunks of kStage entries, lanes on
//     neighbouring entries (coalesced 8-byte loads of slots); each lane
//     issues its kStage / 32 gathers dz[slots[p]] together and stages the
//     values in the warp's stretch of shared memory;
//   * each lane then sums its row's part of the chunk in the plan's order,
//     reading kSumUnroll staged values ahead of its adds, and carries the sum
//     across chunks (a hub row's segment may span many; the next chunk's
//     slots load while one is summed): the same additions in the same order
//     as a serial walk, so the same bits.  80 registers (nvcc -Xptxas -v,
//     sm_90a), 16 KB of shared memory a block, no spill.
//     An empty segment, the pad row's among them, writes 0, so g needs no
//     clearing pass.  No atomics, no block-wide barrier.
//
// What holds it: the random reads of dz.  At the gcn-paper layout dz is
// 160 MB, over three times the L2, and each of its sectors holds about 3.4
// listed slots, each read at another time, so most reads go to device
// memory: chip_smoke.py times the kernel at the layout beside the same
// reads folded into 32 MB of dz (`dz_in_l2_device_ms`) and one
// torch.index_select of dz at the plan's slots (`gather_device_ms`).
// Passes over bands of dz small enough for the L2, one launch a band, were
// slower: each pass re-reads the plan's bounds and carries the sums through
// memory.
//
// Offsets are 64-bit throughout: V*K and N*D pass 2**31 on larger graphs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block in the row-dot pass, one per warp
constexpr int kThreads = 256;

// sum over the warp in a fixed butterfly order; every lane ends with the
// same value (a + b == b + a in IEEE arithmetic)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot_into(float acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot_into(float acc, const float a, const float b) {
  return fmaf(a, b, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_row_dots_kernel(const T* __restrict__ Hw, const T* __restrict__ a_src,
                      const T* __restrict__ a_dst, float* __restrict__ s_src,
                      float* __restrict__ s_dst, long long N, long long V,
                      int DW /* row width in units of T */) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + warp;
  if (n >= N) return;  // whole warps leave together: the shuffles stay full
  const T* row = Hw + n * (long long)DW;
  float ps = 0.f, pd = 0.f;
  for (int c = lane; c < DW; c += 32) {
    const T h = __ldg(row + c);
    ps = dot_into(ps, h, __ldg(a_src + c));
    pd = dot_into(pd, h, __ldg(a_dst + c));
  }
  ps = warp_sum(ps);
  pd = warp_sum(pd);
  if (lane == 0) {
    s_src[n] = ps;
    if (n < V) s_dst[n] = pd;
  }
}

__global__ void __launch_bounds__(kThreads)
sddmm_slot_kernel(const int* __restrict__ ids, const float* __restrict__ mask,
                  const float* __restrict__ s_src, const float* __restrict__ s_dst,
                  float* __restrict__ e, long long V, int K, float slope) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= V * (long long)K) return;
  float out = -1e30f;
  if (mask[i] > 0.f) {
    const float z = __ldg(s_dst + i / K) + __ldg(s_src + ids[i]);
    out = z > 0.f ? z : slope * z;
  }
  e[i] = out;
}

constexpr int kStage = 512;  // plan entries a warp stages per chunk
constexpr int kPerLane = kStage / 32;
constexpr int kSumUnroll = 16;  // staged values a lane reads ahead of its adds

// the slots of the chunk starting at c (lane j holds entries c + j, c + 32 + j, ...)
__device__ __forceinline__ void load_slots(long long (&s)[kPerLane],
                                           const long long* __restrict__ slots,
                                           long long c, long long p1, int lane) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const long long p = c + j * 32 + lane;
    s[j] = p < p1 ? __ldg(slots + p) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
ell_slot_transpose_kernel(const long long* __restrict__ indptr,
                          const long long* __restrict__ slots,
                          const float* __restrict__ dz, float* __restrict__ g,
                          long long N) {
  __shared__ float s_val[kWarps][kStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long u0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (u0 >= N) return;  // whole warps leave together: the shuffles stay full
  const long long u = u0 + lane;
  // this lane's segment [a, b) (empty past the last row) and the tile's
  // stretch [p0, p1)
  const long long a = __ldg(indptr + (u < N ? u : N));
  const long long b = __ldg(indptr + (u < N ? u + 1 : N));
  const long long p0 = __shfl_sync(0xffffffffu, a, 0);
  const long long p1 = __shfl_sync(0xffffffffu, b, 31);
  float* val = s_val[warp];
  float acc = 0.f;
  long long s[kPerLane];
  load_slots(s, slots, p0, p1, lane);
  for (long long c0 = p0; c0 < p1; c0 += kStage) {
    float x[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) x[j] = c0 + j * 32 + lane < p1 ? __ldg(dz + s[j]) : 0.f;
    __syncwarp();  // every lane is done summing the previous chunk
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) val[j * 32 + lane] = x[j];
    __syncwarp();
    // the next chunk's slots (a long segment's) load while this one is summed
    load_slots(s, slots, c0 + kStage, p1, lane);
    // this lane's part of the chunk, [lo, hi) (empty when its segment ends
    // before the chunk or starts after it), added in the plan's order
    const long long lo = (a > c0 ? a : c0) - c0;
    const long long hi = (b < c0 + kStage ? b : c0 + kStage) - c0;
    int i = (int)lo;
    if (i + kSumUnroll <= hi) {  // blocks of kSumUnroll, the next one read during the adds
      float y[kSumUnroll];
#pragma unroll
      for (int j = 0; j < kSumUnroll; ++j) y[j] = val[i + j];
      for (i += kSumUnroll; i + kSumUnroll <= hi; i += kSumUnroll) {
        float z[kSumUnroll];
#pragma unroll
        for (int j = 0; j < kSumUnroll; ++j) z[j] = val[i + j];
#pragma unroll
        for (int j = 0; j < kSumUnroll; ++j) acc += y[j];
#pragma unroll
        for (int j = 0; j < kSumUnroll; ++j) y[j] = z[j];
      }
#pragma unroll
      for (int j = 0; j < kSumUnroll; ++j) acc += y[j];
    }
    for (; i < hi; ++i) acc += val[i];
  }
  if (u < N) g[u] = acc;
}

}  // namespace

// Plain C entry point of the forward (loaded with ctypes).  V >= 1, K >= 1,
// N >= V: the wrapper checks and returns early for empty shapes.  s_src [N]
// and s_dst [V] are scratch the wrapper allocates.  Returns
// cudaGetLastError() after the launches; 0 means both were accepted.
extern "C" int sddmm_launch(const void* ids, const void* mask, const void* Hw,
                            const void* a_src, const void* a_dst, void* s_src,
                            void* s_dst, void* e, long long N, long long V, int K,
                            int D, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (D % 4 == 0) && ((uintptr_t)Hw % 16 == 0) &&
                    ((uintptr_t)a_src % 16 == 0) && ((uintptr_t)a_dst % 16 == 0);
  const unsigned int row_blocks = (unsigned int)((N + kWarps - 1) / kWarps);
  float* ss = static_cast<float*>(s_src);
  float* sd = static_cast<float*>(s_dst);
  if (vec4) {
    sddmm_row_dots_kernel<float4><<<row_blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(Hw), static_cast<const float4*>(a_src),
        static_cast<const float4*>(a_dst), ss, sd, N, V, D / 4);
  } else {
    sddmm_row_dots_kernel<float><<<row_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(Hw), static_cast<const float*>(a_src),
        static_cast<const float*>(a_dst), ss, sd, N, V, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long slots = V * (long long)K;
  const unsigned int slot_blocks = (unsigned int)((slots + kThreads - 1) / kThreads);
  sddmm_slot_kernel<<<slot_blocks, kThreads, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(mask), ss, sd,
      static_cast<float*>(e), V, K, slope);
  return (int)cudaGetLastError();
}

// Plain C entry point of the transpose.  N >= 1: the wrapper returns early
// for an empty table.  Returns cudaGetLastError() after the launch.
extern "C" int ell_slot_transpose_launch(const void* indptr, const void* slots,
                                         const void* dz, void* g, long long N,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)kWarps * 32;  // a warp's tile of 32 rows
  const unsigned int blocks = (unsigned int)((N + rows - 1) / rows);
  ell_slot_transpose_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const long long*>(indptr), static_cast<const long long*>(slots),
      static_cast<const float*>(dz), static_cast<float*>(g), N);
  return (int)cudaGetLastError();
}

extern "C" const char* sddmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
