// Causal / non-causal GQA flash attention, forward (sm_90a).
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_padded
// (the Pallas TPU kernel, body _flash_kernel), which every prefill of the
// model serving path runs through gqa.apply.
//
// What it computes, for q (B, Hq, S, Dk), k (B, Hkv, S, Dk),
// v (B, Hkv, S, Dv), with KV head h / (Hq / Hkv):
//   s = (q . k) * scale in float32; causal: s = -1e30 where row < col;
//   o = softmax(s) . v by the online softmax (running max m, denominator
//   l and weighted sum in float32), divided by safe_l = (l > 0 ? l : 1),
//   cast to q's dtype.
// Inputs are float32, float16 or bfloat16, converted to float32 on load,
// as the TPU kernel does with .astype(jnp.float32).  Keys at index >= S
// are masked (their weight is exactly 0) and rows at index >= S are not
// written, so any S is taken without host-side padding.  The reference's
// ops.attention pads S and, without causal masking, lets the padded keys
// into the softmax; this kernel computes the unpadded function.
//
// Bound: operations.  At the serving shape (S=2048, Hq=16, D=128) a
// launch does 4 * S^2 * D * Hq / 2 = 17.2 GFLOP against 25 MB of q, k, v
// and o: 17 us at the bf16 tensor-core rate, 7.5 us of bytes.
// Design: this first version runs on the CUDA cores in float32 (no
// mma/wgmma, no TMA), so it sits far above that bound; what it does
// right is the structure.  One block per (64-row q tile, head, batch);
// the TPU's sequential KV grid axis becomes a loop inside the block over
// 64-key tiles, which stops at the causal diagonal (the reference's
// block skip).  The q tile and each K/V tile are staged in shared memory
// as float32 (rows padded by one word so the column-wise reads of K hit
// distinct banks); a 16 x 16 thread grid gives each thread 4 query rows
// x 4 key columns of the score tile, and the same 4 rows x Dv/16 columns
// of the output, so the row rescale by alpha stays in registers.  The
// row max and sum are reduced across the 16 lanes that share a row with
// warp shuffles.  Nothing of size S x S exists.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kLanes = 16;     // threads along a row (and along columns)
constexpr int kThreads = kLanes * kLanes;
constexpr int kRows = kBQ / kLanes;  // query rows per thread
constexpr int kCols = kBK / kLanes;  // score columns per thread
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;    // finite, as the reference's mask

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // (B, Hq, S, Dv), contiguous
  int B, Hq, Hkv, S, Dk, Dv;
  long long qs[3], ks[3], vs[3];  // element strides of (B, H, S); D is 1
  float scale;
  int causal;
};

// NJ: output columns per thread, 16 * NJ >= Dv.
template <int NJ>
__host__ __device__ constexpr int v_stride() { return kLanes * NJ; }

template <int NJ>
size_t smem_bytes(int Dk) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (Dk + 1) +
                          static_cast<size_t>(kBK) * v_stride<NJ>() +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.S, Dk = p.Dk, Dv = p.Dv;
  const int ks = Dk + 1;              // padded row stride of sQ and sK
  constexpr int vs = v_stride<NJ>();  // row stride of sV
  constexpr int ps = kBK + 1;         // padded row stride of sP
  float* sQ = smem;
  float* sK = sQ + kBQ * ks;
  float* sV = sK + kBK * ks;
  float* sP = sV + kBK * vs;

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;  // score column / output column lane
  const int ty = tid / kLanes;  // owns query rows ty * kRows + i
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  for (int i = tid; i < kBQ * Dk; i += kThreads) {
    const int r = i / Dk, d = i - r * Dk;
    const int row = q0 + r;
    sQ[r * ks + d] = row < S ? to_f(q[row * p.qs[2] + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int tiles = (S + kBK - 1) / kBK;
  const int n_tiles = p.causal ? min(tiles, (q0 + kBQ - 1) / kBK + 1) : tiles;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's P.V is done with sK, sV, sP
    for (int i = tid; i < kBK * Dk; i += kThreads) {
      const int c = i / Dk, d = i - c * Dk;
      const int key = k0 + c;
      sK[c * ks + d] = key < S ? to_f(k[key * p.ks[2] + d]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int c = i / Dv, d = i - c * Dv;
      const int key = k0 + c;
      sV[c * vs + d] = key < S ? to_f(v[key * p.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(ty * kRows + i) * ks + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = sK[(tx + kLanes * j) * ks + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int row = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kLanes * j;
        float x = s[i][j] * p.scale;
        if (col >= S || (p.causal && row < col)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + kLanes * j;
        const float pj = (k0 + c < S) ? expf(s[i][j] - m_new) : 0.f;
        sP[r * ps + c] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kmax = min(kBK, S - k0);
    for (int c = 0; c < kmax; ++c) {
      float pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(ty * kRows + i) * ps + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * vs + tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(p.o) + (static_cast<long long>(b) * p.Hq + h) *
                                    static_cast<long long>(S) * Dv;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + kLanes * j;
      if (d < Dv)
        o[static_cast<long long>(row) * Dv + d] = from_f<T>(acc[i][j] / safe_l);
    }
  }
}

template <typename T, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<NJ>(p.Dk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dv(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 16) return launch<T, 1>(p, stream);
  if (p.Dv <= 32) return launch<T, 2>(p, stream);
  if (p.Dv <= 64) return launch<T, 4>(p, stream);
  if (p.Dv <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

// Plain C entry for ctypes.  dtype: 0 float32, 1 float16, 2 bfloat16 (q,
// k, v and o share it).  Strides are in elements for the (B, H, S) axes;
// the D axis must be contiguous.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take; a refused launch never runs, so the caller must check.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int S, int Dk, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Dk <= 0 || Dk > kMaxD || Dv <= 0 ||
      Dv > kMaxD || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Hq, Hkv, S, Dk, Dv,
           {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dv<float>(p, st);
    case 1: return launch_dv<__half>(p, st);
    case 2: return launch_dv<__nv_bfloat16>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
