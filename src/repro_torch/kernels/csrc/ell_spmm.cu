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
// shared memory cannot hold one, so the design here is a row gather.  (A
// panel in the 50 MB L2 holds 8 floats of 2**20 rows: D = 256 would re-read
// ids and mask 32 times, 10.2 GB, and gather 32-byte sectors from the L2.)
//
// Bound on this card: bytes.  The function must read H's rows once, ids and
// mask once and write out once: N*D*4 + V*K*8 + V*D*4 bytes at 3.35 TB/s,
// against 2*nnz*D flops, far below the fp32 rate.  A gather that misses L2
// re-reads an H row for every edge that names it; the L2 (50 MB) holds about
// 5 % of a 2**20 x 256 table.  So at the gcn-paper layout (16,777,199 edges,
// D = 256) the gather alone is 17.18 GB, with ids and mask (0.32 GB) and out
// (1.07 GB) 18.57 GB: 5.54 ms at 3.35 TB/s.  At the odd fused widths a row
// spans 33-34 sectors of 32 bytes, not 32 (about 5.8 ms at D = 257).
//
// The design sizes the lanes to the row, as the dw kernel below does.  Its
// row gather, `gather_row`, serves the transpose below too: the two differ
// only in where lane j finds its entry (the ELL row here, the CSR segment
// of the plan there).
//
//   * one warp per row v, kWarps rows per block.  Each slot takes a group of
//     G lanes and each lane keeps U units of the row in registers (units of
//     16 bytes, float4, when D % 4 == 0 and both pointers are 16-byte
//     aligned, else 4-byte floats); G and U come from `pick_group`, so one
//     pass covers the row wherever U <= kMaxUnits: D = 257 one pass of 9
//     floats a lane (a warp-wide loop of 64 floats a pass would take 5
//     passes and re-read ids and mask in each), D = 129, 65 and 33 groups
//     of 16, 8 and 4 lanes, D = 64 (16 float4) two slots a step, D = 128
//     and 256 a warp of 1 and 2 float4 a lane.  32 / G slots are in flight
//     a step;
//   * the warp loads the row's ids and mask 32 at a time, coalesced (lane j
//     holds slot k0 + j), and hands each group its slot's id and weight by
//     shuffle: no block-wide staging, no __syncthreads; the degree is summed
//     from the same loads;
//   * the gathers of kSteps slot steps are issued before any FMA: at least
//     kInFlight independent loads of H a lane on the 16-byte path, twice as
//     many on the 4-byte path (D = 257 two steps of 9 floats a lane); a
//     masked slot's loads are predicated off (its weight, 0, adds nothing),
//     not branched around;
//   * each lane sums its group's slots in increasing k, and the groups
//     combine in a fixed xor butterfly at the row's end, so the result is
//     bitwise equal across launches;
//   * rows wider than kMaxUnits * 32 units take the general form: G = 32,
//     U = kMaxUnits, one pass over the slots per 288 units of the row.
//
// Registers (nvcc -Xptxas -v, sm_90a) of the instantiations the GNN paths
// launch, as <unit, G, U>: <float4, 32, 2> (D = 256) 40, <float4, 32, 1>
// (D = 128) and <float4, 16, 1> (D = 64) 32, <float, 32, 9> (D = 257),
// <float, 16, 9> (D = 129), <float, 8, 9> (D = 65) and <float, 4, 9>
// (D = 33) 58 each; none of the 26 instantiations spills.
//
// Row offsets are 64-bit: ids * D passes 2**31 on larger graphs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;         // rows per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxUnits = 9;      // units of a row a lane keeps in registers per slot
constexpr int kInFlight = 8;      // loads of H a lane issues together, at least
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }

__device__ __forceinline__ void fma_into(float4& acc, float m, const float4 h) {
  acc.x = fmaf(m, h.x, acc.x);
  acc.y = fmaf(m, h.y, acc.y);
  acc.z = fmaf(m, h.z, acc.z);
  acc.w = fmaf(m, h.w, acc.w);
}
__device__ __forceinline__ void fma_into(float& acc, float m, const float h) { acc = fmaf(m, h, acc); }

// acc += the same units of the lane `o` apart
__device__ __forceinline__ void add_xor(float4& acc, int o) {
  acc.x += __shfl_xor_sync(kFull, acc.x, o);
  acc.y += __shfl_xor_sync(kFull, acc.y, o);
  acc.z += __shfl_xor_sync(kFull, acc.z, o);
  acc.w += __shfl_xor_sync(kFull, acc.w, o);
}
__device__ __forceinline__ void add_xor(float& acc, int o) { acc += __shfl_xor_sync(kFull, acc, o); }

__device__ __forceinline__ float4 divide(const float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}
__device__ __forceinline__ float divide(const float a, float d) { return a / d; }

// slot steps a lane keeps in flight with U units a slot: enough for
// `loads` loads, and at most G, so that a pass of kSteps * 32 / G slots
// divides 32
__host__ __device__ constexpr int steps_in_flight(int G, int U, int loads) {
  return (loads + U - 1) / U < G ? (loads + U - 1) / U : G;
}

// The group size for a row of W units: the largest power of two G <= 32
// with ceil(W / G) <= kMaxUnits whose last pass leaves at most an eighth
// of the G * ceil(W / G) lane-units idle, else the one that idles least;
// 0 when even G = 32 needs more than kMaxUnits units a lane
int pick_group(int W) {
  int best = 0, best_idle = 1 << 30;
  for (int G = 32; G >= 1; G >>= 1) {
    const int units = (W + G - 1) / G;
    if (units > kMaxUnits) break;
    const int idle = units * G - W;
    if (idle * 8 <= units * G) return G;
    if (idle < best_idle) best = G, best_idle = idle;
  }
  return best;
}

template <int N>
using Int = std::integral_constant<int, N>;

template <int G, typename F>
void with_units(int W, F&& f) {
  const int units = (W + G - 1) / G;
  if (units <= 1) return f(Int<G>{}, Int<1>{});
  // two units a lane only with a whole warp a slot: for G < 32, twice the
  // group with one unit a lane idles the same lanes and pick_group takes it
  if constexpr (G == 32) {
    if (units <= 2) return f(Int<G>{}, Int<2>{});
  }
  // 3-9 units: the lanes past the row's units are predicated off
  f(Int<G>{}, Int<kMaxUnits>{});
}

// Calls f(Int<G>, Int<U>) with the lane group of a row of W units: G from
// pick_group, U the tier of {1, 2 (G = 32 only), kMaxUnits} that covers
// ceil(W / G); for rows past kMaxUnits * 32 units, f(Int<32>, Int<0>): the
// general form.  So 13 lane groups a unit type, and the general form
template <typename F>
void with_lane_group(int W, F&& f) {
  switch (pick_group(W)) {
    case 1: return with_units<1>(W, f);
    case 2: return with_units<2>(W, f);
    case 4: return with_units<4>(W, f);
    case 8: return with_units<8>(W, f);
    case 16: return with_units<16>(W, f);
    case 32: return with_units<32>(W, f);
    default: return f(Int<32>{}, Int<0>{});
  }
}

// Where lane j of a warp finds the j-th entry of its output row: the row of
// the gathered table and the entry's weight.  The forward walks the ELL row
// v (ids[v, :], mask[v, :]); the transpose the CSR segment of row u of dH.
// An entry at or past `count` reads nothing and has weight 0.
// kGateOnWeight: an entry's gathers wait for its weight and skip weight 0.
// That pays on the ELL row, where most slots past a row's degree are
// masked; a plan lists only weighted slots, and its weights are a load
// that depends on the slot's, so the transpose gathers every listed entry
// at once and skips weight 0 at the FMA.
struct EllRow {
  using Id = int;
  static constexpr bool kGateOnWeight = true;
  const int* ids;
  const float* mask;
  int count;
  __device__ __forceinline__ void load(int j, Id& id, float& m) const {
    const bool in = j < count;
    id = in ? __ldg(ids + j) : 0;
    m = in ? __ldg(mask + j) : 0.f;
  }
};

// A slot s = v*K + k is read whole and divided in 64 bits, so a table may
// hold 2**31 slots or more; the row v < V and the segment's length are kept
// in 32 bits (the wrapper holds V and the plan's length below 2**31): in
// 64 bits they ran slower at the narrow 4-byte widths (more registers, two
// shuffles an entry), where the divide itself cost nothing.  The plan
// and the weights are read once: streaming loads (evict first), so that
// they do not push the gathered rows of ct out of the L2.  The loads are
// predicated, not branched around
struct CsrSegment {
  using Id = int;
  static constexpr bool kGateOnWeight = false;
  const long long* slots;
  const float* mask;
  int count;
  int K;
  __device__ __forceinline__ void load(int j, Id& v, float& m) const {
    const bool in = j < count;
    const long long s = in ? __ldcs(slots + j) : 0;
    v = (int)(s / K);
    m = in ? __ldcs(mask + s) : 0.f;
  }
};

// The row gather the forward and the transpose share: one warp writes
//   orow[:] = sum over the entries e of weight(e) * rows[row(e), :]
// (/ max(sum of the weights, 1) when `normalize`), with G lanes an entry and
// U units a lane; the row in passes of G * U units (one pass unless the
// row is wider: the general form).  The entries are loaded 32 at a time
template <typename T, int G, int U, typename Entries>
__device__ __forceinline__ void gather_row(const Entries& e, const T* __restrict__ rows,
                                           T* __restrict__ orow, int DW, bool normalize) {
  using Index = decltype(e.count);
  constexpr int kPerStep = 32 / G;  // entries a warp covers per step
  // kInFlight loads of 16 bytes, twice as many of 4 bytes: one entry step of
  // 9 floats a lane is 36 bytes in flight, too few to cover the gather's
  // latency
  constexpr int kSteps = steps_in_flight(G, U, sizeof(T) == 16 ? kInFlight : 2 * kInFlight);
  constexpr int kBatch = kSteps * kPerStep;  // entries per pass, divides 32
  const int lane = threadIdx.x & 31;
  const int sub = lane / G, col = lane % G;

  for (int c0 = 0; c0 < DW; c0 += G * U) {
    T acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) set_zero(acc[u]);
    float deg = 0.f;  // this lane's entries' weights
    for (Index j0 = 0; j0 < e.count; j0 += 32) {
      typename Entries::Id id_lane;
      float m_lane;
      e.load(j0 + lane, id_lane, m_lane);
      deg += m_lane;
      const int n = e.count - j0 < 32 ? (int)(e.count - j0) : 32;
      for (int s0 = 0; s0 < n; s0 += kBatch) {
        float m[kSteps];
        T h[kSteps][U];
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          const int j = s0 + r * kPerStep + sub;  // < 32; past the end: weight 0
          const auto id = __shfl_sync(kFull, id_lane, j);
          if (Entries::kGateOnWeight) m[r] = __shfl_sync(kFull, m_lane, j);
          const bool live = Entries::kGateOnWeight ? m[r] != 0.f : j < n;
          const T* hrow = rows + (long long)id * DW + c0 + col;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (live && c0 + col + u * G < DW) h[r][u] = __ldg(hrow + u * G);
            else set_zero(h[r][u]);
          }
        }
        // the weights, once the gathers are in flight
        if (!Entries::kGateOnWeight) {
#pragma unroll
          for (int r = 0; r < kSteps; ++r) m[r] = __shfl_sync(kFull, m_lane, s0 + r * kPerStep + sub);
        }
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          // weight 0 adds nothing, whatever the row holds
          if (Entries::kGateOnWeight || m[r] != 0.f) {
#pragma unroll
            for (int u = 0; u < U; ++u) fma_into(acc[u], m[r], h[r][u]);
          }
        }
      }
    }
    // group `sub` holds the sum of entries sub, sub + 32/G, ...: combine the
    // groups in a fixed butterfly; every group ends with the row's sum
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) add_xor(acc[u], o);
    }
    float d = 1.f;
    if (normalize) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) deg += __shfl_xor_sync(kFull, deg, o);
      d = fmaxf(deg, 1.f);
    }
    if (sub == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = c0 + col + u * G;
        if (i < DW) orow[i] = normalize ? divide(acc[u], d) : acc[u];
      }
    }
  }
}

// Calls f(Int<G>, Int<U>) with the gather's lane group for a row of W
// units: `with_lane_group`'s, the general form as <32, kMaxUnits>
template <typename F>
void with_gather_group(int W, F&& f) {
  with_lane_group(W, [&](auto g, auto u) {
    f(g, Int<(decltype(u)::value > 0 ? decltype(u)::value : kMaxUnits)>{});
  });
}

template <typename T, int G, int U>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int* __restrict__ ids, const float* __restrict__ mask,
                const T* __restrict__ H, T* __restrict__ out,
                long long V, int K, int DW /* row width in units of T */,
                bool normalize) {
  const long long v = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= V) return;  // whole warps leave together: the shuffles stay full
  gather_row<T, G, U>(EllRow{ids + v * K, mask + v * K, K}, H, out + v * DW, DW, normalize);
}

template <typename T>
void launch(const int* ids, const float* mask, const void* H, void* out,
            long long V, int K, int DW, bool normalize, cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((V + kWarps - 1) / kWarps);
  with_gather_group(DW, [&](auto g, auto u) {
    ell_spmm_kernel<T, decltype(g)::value, decltype(u)::value><<<blocks, kThreads, 0, stream>>>(
        ids, mask, static_cast<const T*>(H), static_cast<T*>(out), V, K, DW, normalize);
  });
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
// mask[v,k] * ct[v] into dH[ids[v,k]]; it serves `ell_attend`'s dH too, the
// weights in the mask lane.  A scatter on this card needs float atomics,
// whose order of arrival changes from run to run, and the JAX tiers assert
// bitwise determinism.  So the kernel reads a CSR transpose of the ELL table
// (`ell_transpose_plan`, built once per engine) and is a row gather again.
//
// Bound on this card: bytes.  The function must read every ct row some slot
// names once, the plan (nnz * 8 + (N+1) * 8) and each listed slot's mask
// (nnz * 4), and write dH once (N * D * 4), against 2 * nnz * D flops.  Like
// the forward, a gather that misses L2 re-reads a ct row for every slot that
// names it, and a slot's mask is one 32-byte sector of its own.  At the
// gcn-paper layout (16,777,199 listed slots, N = 2**20 + 1) that no-reuse
// floor at 3.35 TB/s is 5.65 ms at D = 256 (float4), 5.81 at 257, 3.09 at
// 129, 2.93 at 128, 1.73 at 65, 1.57 at 64 and 1.05 at 33.  The masks are
// read at random, and random sectors move far below that rate: one
// index_select of the weights at the plan's slots costs about three times
// the floor's 0.16 ms for them (chip_smoke.py, `weights_gather_device_ms`),
// and the kernel runs most of that over the forward kernel over the same
// entries as an ELL table (`transposed_ell_forward_device_ms`).
//
// The design is the forward's, through the same `gather_row`:
//
//   * one warp per row u of dH, kWarps rows per block; each plan entry takes
//     a lane group of G lanes with U units of the row a lane (16-byte float4
//     units when D % 4 == 0 and ct, dH are 16-byte aligned, else 4-byte
//     floats), G and U from `with_lane_group`, so one pass covers the row
//     wherever U <= kMaxUnits: D = 257 one pass of 9 floats a lane (a
//     warp-wide loop of 2 units a lane took 5 passes, each re-reading the
//     segment's plan entries and masks), D = 129, 65 and 33 groups of 16, 8
//     and 4 lanes, D = 64 two entries a step, D = 128 and 256 a whole warp;
//   * the row's bounds come from one load and a shuffle, so the compiler
//     knows the segment's length is the warp's own (see the kernel);
//   * the warp loads its segment 32 entries at a time, coalesced: lane j
//     holds slots[p0 + j], its source row v = slot / K (a 64-bit divide
//     into a 32-bit row) and its weight mask[slot]; each group takes its
//     entry's v by shuffle and issues its gathers, and takes the weight only
//     then: the weight is a load behind the slot's, and the gathers do not
//     wait for it.  No shared-memory stage, no __syncwarp;
//   * the gathers of kSteps entry steps are issued before any FMA, twice as
//     many steps on the 4-byte path; an entry past the segment's end is
//     predicated off, one of weight 0 adds nothing; a hub segment loops over
//     its 32-entry loads;
//   * each lane sums its group's entries in increasing plan order and the
//     groups combine in a fixed xor butterfly: bitwise equal across
//     launches (and equal to the forward run over the same entries as an
//     ELL table, not to a serial walk over the segment);
//   * every row is written: an empty segment (the zero pad row of a gather
//     table among them) gives zeros, so dH needs no clearing pass.
//
// Registers (nvcc -Xptxas -v, sm_90a) of the instantiations the GNN paths
// launch, as <unit, G, U>: <float4, 32, 2> (D = 256) 62, <float4, 32, 1>
// (D = 128) and <float4, 16, 1> (D = 64) 32, <float, 32, 9> (D = 257),
// <float, 16, 9> (D = 129), <float, 8, 9> (D = 65) and <float, 4, 9>
// (D = 33) 48 each; none of the 26 instantiations spills.

template <typename T, int G, int U>
__global__ void __launch_bounds__(kThreads)
ell_spmm_transpose_kernel(const long long* __restrict__ indptr,
                          const long long* __restrict__ slots,
                          const float* __restrict__ mask,
                          const T* __restrict__ ct, T* __restrict__ dH,
                          long long N, int K, int DW /* row width in units of T */) {
  const long long u = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= N) return;  // whole warps leave together: the shuffles stay full
  const int lane = threadIdx.x & 31;
  // the row's two bounds in one load (lane 0 indptr[u], lane 1 indptr[u + 1])
  // handed out by shuffle: the compiler then knows the segment's length is
  // the warp's own, and the loops over it need no divergence checks around
  // their shuffles (with each lane loading indptr[u] itself, nvcc wraps
  // every shuffle in a BRA.DIV test beside a WARPSYNC copy of the loop, and
  // the 4-byte path runs far slower)
  const long long bound = __ldg(indptr + u + (lane & 1));
  const long long p0 = __shfl_sync(kFull, bound, 0);
  gather_row<T, G, U>(CsrSegment{slots + p0, mask, (int)(__shfl_sync(kFull, bound, 1) - p0), K},
                      ct, dH + u * DW, DW, false);
}

template <typename T>
void launch_transpose(const long long* indptr, const long long* slots, const float* mask,
                      const void* ct, void* dH, long long N, int K, int DW, cudaStream_t s) {
  const unsigned int blocks = (unsigned int)((N + kWarps - 1) / kWarps);
  with_gather_group(DW, [&](auto g, auto u) {
    ell_spmm_transpose_kernel<T, decltype(g)::value, decltype(u)::value><<<blocks, kThreads, 0, s>>>(
        indptr, slots, mask, static_cast<const T*>(ct), static_cast<T*>(dH), N, K, DW);
  });
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
  constexpr int kSteps = steps_in_flight(G, U > 0 ? U : 1, kInFlight);
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

template <typename T>
void launch_dw(const int* ids, const T* ct, const T* H, float* dw, long long V, int K,
               int DW, cudaStream_t s) {
  const unsigned int blocks = (unsigned int)((V + kWarps - 1) / kWarps);
  with_lane_group(DW, [&](auto g, auto u) {
    ell_attend_dw_kernel<T, decltype(g)::value, decltype(u)::value>
        <<<blocks, kThreads, 0, s>>>(ids, ct, H, dw, V, K, DW);
  });
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
// returns early for empty shapes; ct's rows and the plan's slots number
// fewer than 2**31 (the kernel's 32-bit rows and segment lengths).  Returns
// cudaGetLastError() after the launch.
extern "C" int ell_spmm_transpose_launch(const void* indptr, const void* slots,
                                         const void* mask, const void* ct, void* dH,
                                         long long N, int K, int D, void* stream) {
  const bool vec4 = (D % 4 == 0) && ((uintptr_t)ct % 16 == 0) && ((uintptr_t)dH % 16 == 0);
  const long long* indptr_i = static_cast<const long long*>(indptr);
  const long long* slots_i = static_cast<const long long*>(slots);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) launch_transpose<float4>(indptr_i, slots_i, mask_f, ct, dH, N, K, D / 4, s);
  else launch_transpose<float>(indptr_i, slots_i, mask_f, ct, dH, N, K, D, s);
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
