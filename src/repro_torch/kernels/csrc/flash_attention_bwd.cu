// Flash attention backward for Hopper (sm_90a): the gradient of the forward
// in `flash_attention.cu`, fp32 and bf16, causal or not, D in {32, 64, 128}.
//
//   q, o, dO, dq  [BH, S, D]   k, v, dk, dv  [BH, T, D]   lse  [BH, S] fp32
//
// lse is each row's log-sum-exp of the scaled scores, which the forward
// writes beside o; delta [BH, S] fp32 is written by the first pass and read
// by the second.  A source of its own, so nvcc builds it beside the
// forward's (`kernels/build.py` starts one compiler a source, all at once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// dQ, then dK and dV (SIMT, fp32 arithmetic; bf16 or fp32 in and out)
//
// From q, k, v, o, dO and the forward's LSE: P = exp(s * scale - lse) is
// recomputed from q and k, dP = dO . V^T, delta = rowsum(dO o O) (once a
// row, by the dQ pass, which writes it for the dK/dV pass), dS = P (dP -
// delta); dQ = scale dS . K, dK = scale dS^T . Q, dV = P^T . dO (P rounded to
// bf16 first for bf16 inputs, as the forward's P.V rounds it).  Every sum is
// formed by one thread or a fixed shuffle tree: no float atomics, so two
// launches are bitwise equal.
//
// The TPU kernel has no gradient rule; these replace JAX's autodiff of the
// reference's `chunked_attention` (src/repro/models/layers.py:167).  Bound
// by operations on this card: five products of 2 D flops per unmasked (q,
// k) pair (two recomputed, three gradients), 989 TFLOP/s in bf16.  These
// are simple SIMT kernels that reach neither: one CTA of 256 threads owns
// 64 rows (queries for dQ, keys for dK/dV), walks the other side in tiles
// of 64 rows staged as fp32 in shared memory (no double buffer), and each
// thread forms a 4 x 4 block of the tile's scores (rows tr + 16a, columns
// tc + 16b: conflict-free float4 reads) and a 4-row block of its outputs.

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

__device__ __forceinline__ float4 load4g(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4g(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store2g(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2g(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rows [first, first + 64) of a [rows, D] tensor into a [64][kRow] fp32
// tile, zeros past `rows`
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int first, int rows) {
  for (int i = threadIdx.x; i < kG * (D / 4); i += kGThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < rows) x = load4g(src + (long long)(first + r) * D + c);
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
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][GShape<D>::CW],
                                           float mul, int first, int rows, int tr, int tc) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = first + tr + 16 * a;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < GShape<D>::CW; i += 2)
      store2g(dst + (long long)row * D + col_of<D>(tc, i), acc[a][i] * mul,
              acc[a][i + 1] * mul);
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kGThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
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
      const T* orow = o + qoff + (long long)(q0 + r) * D;
      const T* drow = dout + qoff + (long long)(q0 + r) * D;
      for (int c = part * (D / 4); c < (part + 1) * (D / 4); c += 4) {
        const float4 x = load4g(orow + c), y = load4g(drow + c);
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

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kGThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int T_,
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
        Ps[ra * PR + cb] = round_as(p, q);
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
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, float* delta, void* dk, void* dv, int BH, int S,
               int T_, float scale, bool dkdv, cudaStream_t stream) {
  static std::atomic<bool> dq_set[kMaxDevices], dkdv_set[kMaxDevices];
  using G = GShape<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (!dkdv) {
    auto kernel = flash_bwd_dq_kernel<T, D, kCausal>;
    cudaError_t err = allow_smem(kernel, G::dq_bytes, dq_set);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (S + kG - 1) / kG;
    kernel<<<(unsigned int)((long long)n_qtiles * BH), kGThreads, G::dq_bytes, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, BH, S, T_,
        scale, n_qtiles);
  } else {
    auto kernel = flash_bwd_dkdv_kernel<T, D, kCausal>;
    cudaError_t err = allow_smem(kernel, G::dkdv_bytes, dkdv_set);
    if (err != cudaSuccess) return (int)err;
    const int n_ktiles = (T_ + kG - 1) / kG;
    kernel<<<(unsigned int)((long long)n_ktiles * BH), kGThreads, G::dkdv_bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), BH, S, T_,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kCausal>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, float* delta, void* dk,
                 void* dv, int BH, int S, int T_, int D, float scale, bool dkdv,
                 cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_bwd<T, 32, kCausal>(q, k, v, o, dout, lse, dq, delta, dk, dv, BH, S, T_,
                                        scale, dkdv, stream);
    case 64:
      return launch_bwd<T, 64, kCausal>(q, k, v, o, dout, lse, dq, delta, dk, dv, BH, S, T_,
                                        scale, dkdv, stream);
    case 128:
      return launch_bwd<T, 128, kCausal>(q, k, v, o, dout, lse, dq, delta, dk, dv, BH, S,
                                         T_, scale, dkdv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bwd_any(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* delta, void* dk,
                   void* dv, int BH, int S, int T, int D, int is_bf16, int causal,
                   float scale, bool dkdv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16)
    return causal ? launch_bwd_d<bf16, true>(q, k, v, o, dout, l, dq, dl, dk, dv, BH, S, T, D,
                                             scale, dkdv, s)
                  : launch_bwd_d<bf16, false>(q, k, v, o, dout, l, dq, dl, dk, dv, BH, S, T,
                                              D, scale, dkdv, s);
  return causal ? launch_bwd_d<float, true>(q, k, v, o, dout, l, dq, dl, dk, dv, BH, S, T, D,
                                            scale, dkdv, s)
                : launch_bwd_d<float, false>(q, k, v, o, dout, l, dq, dl, dk, dv, BH, S, T, D,
                                             scale, dkdv, s);
}

}  // namespace

// The backward's two passes, launched in this order on one stream: dQ
// (which also writes delta [BH, S] fp32, rowsum(dO o O)), then dK and dV
// (which read it).  q, o, dout, dq [BH, S, D]; k, v, dk, dv [BH, T, D];
// lse [BH, S] from the forward; BH, S, T >= 1; the rest as the forward's.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout,
                                             const void* lse, void* dq, void* delta, int BH,
                                             int S, int T, int D, int bf16, int causal,
                                             float scale, void* stream) {
  return launch_bwd_any(q, k, v, o, dout, lse, dq, delta, nullptr, nullptr, BH, S, T, D,
                        bf16, causal, scale, false, stream);
}

extern "C" int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv,
                                               int BH, int S, int T, int D, int bf16,
                                               int causal, float scale, void* stream) {
  return launch_bwd_any(q, k, v, nullptr, dout, lse, nullptr, const_cast<void*>(delta), dk,
                        dv, BH, S, T, D, bf16, causal, scale, true, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
