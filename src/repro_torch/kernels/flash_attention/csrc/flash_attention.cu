// Causal / non-causal GQA flash attention, forward, on the CUDA cores
// (sm_90a): the port's route for float32 and for every input the Hopper
// kernel (flash_wgmma.cu) does not take.
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_padded
// (the Pallas TPU kernel, body _flash_kernel).
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
// Bound: operations.  The products stay in full float32 on the CUDA cores
// (no TF32, which keeps about three decimal digits: the port holds float32
// attention at atol 2e-5), so the rate is the H100's float32 rate outside
// the tensor cores, 67 TFLOP/s.  At the float32 forward's shape (q (1, 16,
// 2079, 128), k, v (1, 8, 2079, 128), causal) a launch needs
// 2 * S(S+1)/2 * (Dk + Dv) * Hq = 17.7 GFLOP, 0.264 ms, against 51 MB of
// q, k, v and o, 0.015 ms at 3.35 TB/s.
//
// Two bodies, one contract; kernel.takes_regtile (Python) picks one.
//
// flash_attention_regtile_launch, the register-tiled body (float32, Dk and
// Dv up to 128, 16-byte aligned rows).  What held the basic body back was
// not the FMAs: scalar shared-memory reads (about 2-2.7 FFMA a word read),
// staging through registers with nothing to overlap it, and one 64-row
// block a head.  The design:
//   * One block per (128 packed query rows, KV head, batch): the
//     G = Hq / Hkv query heads of the KV head, 128 / G rows of each, so
//     that each K/V tile staged in shared memory serves the whole group.
//     The causal stop is the block's last query row; a per-row mask does
//     the rest.  Blocks are numbered longest first (the last q tile of
//     every head, then the one before, ...), so that under causal masking
//     the longest blocks start first and the tail is the short ones.
//   * 8 warps; a warp owns 16 packed rows and all 64 keys of a tile, so
//     the row max and sum stay in the warp (shuffles over the 16 lanes of
//     a row) and P passes through the warp's own rows of shared memory (a
//     __syncwarp, no block barrier).  The softmax takes each step for the
//     lane's 8 rows at once, so that the rows' shuffle chains overlap.
//   * Register tiles.  Lane (r, c) = (lane / 16, lane % 16) holds S at
//     rows 2i + r (i < 8) x keys c + 16j (j < 4), and O at rows 2i + r x
//     the 16-byte column chunks c + 16u (u < Dv / 64).  Every operand is a
//     16-byte read: per four d of Q.K^T, 8 float4 of Q (two addresses a
//     warp instruction) and 4 of K for 128 FFMA; per four keys of P.V,
//     8 float4 of P and 8 of V for 256 FFMA.  Row strides are padded
//     (Dk + 4 for Q and K, 80 for P) so that the addresses of one
//     instruction fall in distinct banks.
//   * Asynchronous copies (cp.async, 16 bytes, zero-filled past S): K is
//     double-buffered and V single-buffered.  K's tile t + 2 is issued as
//     soon as Q.K^T of tile t is done with its buffer, V's tile t + 1 as
//     soon as P.V of tile t is done; two block barriers a tile.  At
//     Dk = Dv = 128: Q 67.6 KB, K 2 x 33.8 KB, V 32.8 KB, P 41 KB = 209 KB,
//     one block of 8 warps per SM.  Dk of 128 and 64 is a compile-time
//     constant (the d loop unrolls); other head dims read it.
//   * The arithmetic is the basic body's: the same fmaf chain over d for a
//     score, the same 64-key tiles, the same per-lane-then-shuffle order
//     for l, the keys in order in P.V, expf (no fast-math exponent).
// On an H100 it runs at about half the float32 rate at the float32
// forward's shape; PERF.md has the measurements and what holds it there.
//
// flash_attention_basic_launch, the basic body (the first design; any
// input dtype, Dk and Dv up to 256).  One block per (64-row q tile, head,
// batch); the TPU's sequential KV grid axis becomes a loop inside the
// block over 64-key tiles, which stops at the causal diagonal.  The q tile
// and each K/V tile are staged in shared memory as float32 by scalar loads
// (rows padded by one word so the column-wise reads of K hit distinct
// banks); a 16 x 16 thread grid gives each thread 4 query rows x 4 key
// columns of the score tile, and the same 4 rows x Dv/16 columns of the
// output.  Its scalar shared-memory reads (2-2.7 FFMA a word), its staging
// without overlap and its one block of 64 rows a head set its pace.
// Nothing of size S x S exists in either body.

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

// ---------------------------------------------------------------------------
// The register-tiled body (float32)
// ---------------------------------------------------------------------------

namespace rt {

constexpr int kRows = 128;                 // packed query rows per block
constexpr int kKeys = 64;                  // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kRows / kWarps;  // 16 rows a warp
constexpr int kTM = kWarpRows / 2;         // 8 rows a lane
constexpr int kTN = kKeys / kLanes;        // 4 keys a lane
constexpr int kPs = kKeys + 16;            // row stride of sP, in floats
constexpr int kMaxD = 128;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copy of rows [row0, row0 + n) of a (rows, D) float32 matrix
// (row stride `stride` elements) into shared memory at row stride `ss`;
// rows at index >= S are zero-filled and read nothing.
__device__ __forceinline__ void stage_rows(float* dst, int ss,
                                           const float* src, long long stride,
                                           int row0, int n, int S, int D) {
  const int chunks = D >> 2;
  for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
    const int r = i / chunks, ch = i - r * chunks;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * ss + 4 * ch, src + (ok ? row * stride + 4 * ch : 0),
               ok);
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Q, two K tiles, one V tile and P.
size_t smem_bytes(int Dk, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kRows + 2 * kKeys) * (Dk + 4) +
          static_cast<size_t>(kKeys) * Dv + static_cast<size_t>(kRows) * kPs);
}

// DK: Dk fixed at compile time (0: read from p).  NCH: 16-byte output
// column chunks a lane holds, 64 * NCH >= Dv.
template <int DK, int NCH>
__global__ void __launch_bounds__(kThreads, 1)
flash_regtile_kernel(const Params p) {
  extern __shared__ float4 rt_smem[];
  float* smem = reinterpret_cast<float*>(rt_smem);
  const int S = p.S, Dv = p.Dv;
  const int Dk = DK ? DK : p.Dk;
  const int G = p.Hq / p.Hkv;
  const int QR = kRows / G;  // q rows of each head in a block
  const int nq = (S + QR - 1) / QR;
  const int heads = p.Hkv * p.B;
  // Longest first: blocks 0.. take the last q tile of every (KV head,
  // batch), the next ones the tile before, and so on.
  const int wave = blockIdx.x / heads;
  const int hb = blockIdx.x - wave * heads;
  const int hk = hb % p.Hkv, b = hb / p.Hkv;
  const int q0 = (nq - 1 - wave) * QR;

  const int qs = Dk + 4;  // padded row stride of sQ and sK
  float* sQ = smem;
  float* sK = sQ + kRows * qs;
  float* sV = sK + 2 * kKeys * qs;
  float* sP = sV + kKeys * Dv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane / kLanes, c = lane % kLanes;
  const float* qb = static_cast<const float*>(p.q) + b * p.qs[0] +
                    static_cast<long long>(hk) * G * p.qs[1];
  const float* kb = static_cast<const float*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const float* vb = static_cast<const float*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const int tiles = (S + kKeys - 1) / kKeys;
  const int q_last = min(q0 + QR, S) - 1;
  const int n_tiles = p.causal ? min(tiles, q_last / kKeys + 1) : tiles;

  // Packed row pr = g * QR + i is q row q0 + i of head hk * G + g.
  {
    const int chunks = Dk >> 2;
    for (int i = tid; i < kRows * chunks; i += kThreads) {
      const int pr = i / chunks, ch = i - pr * chunks;
      const int g = pr / QR, row = q0 + pr - g * QR;
      const bool ok = g < G && row < S;
      cp_async16(sQ + pr * qs + 4 * ch,
                 qb + (ok ? g * p.qs[1] + row * p.qs[2] + 4 * ch : 0), ok);
    }
  }
  stage_rows(sK, qs, kb, p.ks[2], 0, kKeys, S, Dk);
  cp_async_commit();
  stage_rows(sV, Dv, vb, p.vs[2], 0, kKeys, S, Dv);
  cp_async_commit();
  if (n_tiles > 1) stage_rows(sK + kKeys * qs, qs, kb, p.ks[2], kKeys, kKeys, S, Dk);
  cp_async_commit();

  // This lane's rows are the packed rows pr0 + 2 i; qrow is the q row.
  const int pr0 = warp * kWarpRows + r;
  int qrow[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) qrow[i] = q0 + (pr0 + 2 * i) % QR;
  // Output column chunks; a chunk past Dv reads a valid one and is not
  // written.
  int vcol[NCH];
#pragma unroll
  for (int u = 0; u < NCH; ++u) vcol[u] = 4 * min(c + kLanes * u, Dv / 4 - 1);
  float m[kTM], l[kTM], acc[kTM][4 * NCH];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NCH; ++j) acc[i][j] = 0.f;
  }
  const float* qw = sQ + pr0 * qs;  // row i at + 2 i qs
  float* pw = sP + pr0 * kPs;       // row i at + 2 i kPs

  cp_async_wait<2>();  // Q and K's first tile
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    const float* kt = sK + (t & 1) * kKeys * qs + c * qs;  // key c + 16 j
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    // S = Q.K^T, the fmaf chain over d in order (as the basic body's).
#pragma unroll 8
    for (int d = 0; d < Dk; d += 4) {
      float4 kv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + kLanes * j * qs + d);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + 2 * i * qs + d);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    // The online softmax, each step over the lane's 8 rows at once (the
    // rows' shuffle chains are independent; one row at a time would wait
    // on each chain's latency).  Masks only on a tile that reaches past S
    // or the causal diagonal.
    const bool edge = k0 + kKeys > S || (p.causal && k0 + kKeys - 1 > q0);
    float mx[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = k0 + c + kLanes * j;
        float x = s[i][j] * p.scale;
        if (edge && (col >= S || (p.causal && qrow[i] < col))) x = kNegInf;
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float alpha[kTM], rs[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = k0 + c + kLanes * j;
        const float pj = (!edge || col < S) ? expf(s[i][j] - m_new) : 0.f;
        pw[2 * i * kPs + c + kLanes * j] = pj;
        rs[i] += pj;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int j = 0; j < 4 * NCH; ++j) acc[i][j] *= alpha[i];
    }
    __syncwarp();

    cp_async_wait<0>();  // V's tile t and K's tile t + 1
    __syncthreads();     // ... visible to all; K's tile t is free
    if (t + 2 < n_tiles)
      stage_rows(sK + (t & 1) * kKeys * qs, qs, kb, p.ks[2], k0 + 2 * kKeys,
                 kKeys, S, Dk);
    cp_async_commit();

    // P.V, the keys in order; past S both P and V are 0, so the loop runs
    // the whole tile.
#pragma unroll 4
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(pw + 2 * i * kPs + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sV + (kk + e) * Dv;
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + vcol[u]);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float pe = lane_of(pv[i], e);
            acc[i][4 * u + 0] = fmaf(pe, vv.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(pe, vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pe, vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pe, vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V's tile t
    if (t + 1 < n_tiles)
      stage_rows(sV, Dv, vb, p.vs[2], k0 + kKeys, kKeys, S, Dv);
    cp_async_commit();
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int pr = pr0 + 2 * i;
    const int g = pr / QR, row = q0 + pr - g * QR;
    if (g >= G || row >= S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* orow = o + ((static_cast<long long>(b) * p.Hq + hk * G + g) * S +
                       row) * static_cast<long long>(Dv);
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      if (c + kLanes * u >= Dv / 4) continue;
      const float4 w = {acc[i][4 * u] / safe_l, acc[i][4 * u + 1] / safe_l,
                        acc[i][4 * u + 2] / safe_l, acc[i][4 * u + 3] / safe_l};
      *reinterpret_cast<float4*>(orow + vcol[u]) = w;
    }
  }
}

template <int DK, int NCH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_regtile_kernel<DK, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int QR = kRows / (p.Hq / p.Hkv);
  const long long blocks =
      static_cast<long long>((p.S + QR - 1) / QR) * p.Hkv * p.B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_regtile_kernel<DK, NCH>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The serving head dims get Dk at compile time; the rest read it.
int launch_dims(const Params& p, cudaStream_t stream) {
  if (p.Dk == 128 && p.Dv == 128) return launch<128, 2>(p, stream);
  if (p.Dk == 64 && p.Dv == 64) return launch<64, 1>(p, stream);
  return p.Dv <= 64 ? launch<0, 1>(p, stream) : launch<0, 2>(p, stream);
}

}  // namespace rt

}  // namespace

// Plain C entries for ctypes, one a body, with one signature.  dtype: 0
// float32, 1 float16, 2 bfloat16 (q, k, v and o share it).  Strides are in
// elements for the (B, H, S) axes; the D axis must be contiguous.  Each
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for inputs its body does not take; a refused
// launch never runs, so the caller must check.

// The basic body: any dtype, Hq a multiple of Hkv, Dk and Dv up to 256.
extern "C" int flash_attention_basic_launch(
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

// The register-tiled body: float32 only, Hq / Hkv <= 128, Dk and Dv
// multiples of 4 up to 128, q, k, v and o 16-byte aligned with every
// stride a multiple of 4 elements (its copies are 16 bytes wide).
extern "C" int flash_attention_regtile_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int S, int Dk, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh | vss;
  if (dtype != 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > rt::kRows ||
      Dk <= 0 || Dk > rt::kMaxD || Dk % 4 || Dv <= 0 || Dv > rt::kMaxD ||
      Dv % 4 || (ptrs & 15) || (strides & 3) || strides < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Hq, Hkv, S, Dk, Dv,
           {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rt::launch_dims(p, st);
}

// Dynamic shared memory of one register-tiled block at (Dk, Dv), in bytes.
extern "C" long long flash_attention_regtile_smem(int Dk, int Dv) {
  return static_cast<long long>(rt::smem_bytes(Dk, Dv));
}
