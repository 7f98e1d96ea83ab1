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
// Two bodies, one contract; kernel.takes_regtile (Python) picks one.  Both
// are built on the same design; the basic body widens it to every input.
//
// flash_attention_regtile_launch, the register-tiled body (float32, Dk and
// Dv up to 128, 16-byte aligned rows).  What held the kernel's first design
// back was not the FMAs: scalar shared-memory reads (about 2-2.7 FFMA a
// word read), staging through registers with nothing to overlap it, and
// one 64-row block a head.  The design:
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
//   * The arithmetic is that of ref.chunked_attention: the fmaf chain over
//     d in order for a score, 64-key tiles, the per-lane-then-shuffle
//     order for l, the keys in order in P.V, expf (no fast-math exponent).
// On an H100 it runs at about half the float32 rate at the float32
// forward's shape; PERF.md has the measurements and what holds it there.
//
// flash_attention_basic_launch, the basic body: the rest of the contract
// (float32 at Dk or Dv above 128, float16 / bfloat16 at any head dim,
// rows that are not 16-byte aligned, more than 128 query heads a KV head;
// Dk and Dv multiples of 8 up to 256).  It replaced the first design (one
// 64-row block a query head, scalar shared-memory reads, staging through
// registers with a division per element and nothing overlapping it, 64
// accumulators a thread at Dv above 128), which ran at 10-16% of the
// bound.  It is the register-tiled design widened (namespace basic):
//   * Rows a block by the head dims (rows_for): 128 packed rows (a lane
//     holds 8) up to Dk, Dv = 128, and for float32 up to Dk = 192 at
//     Dv <= 128 (MLA's prefill); 64 (a lane holds 4, a warp 8) above, so
//     that the O accumulator stays at 4 x Dv / 16 <= 64 registers a lane
//     at Dv = 256 beside a 16-bit tile loaded ahead.  The packed rows are
//     G_b = min(G, rows) heads of the KV head's group, rows / G_b q rows of
//     each; where G exceeds a block's rows, the group is split over
//     ceil(G / rows) blocks.  Blocks are numbered longest first, as in the
//     register-tiled body.
//   * K double-buffered where that fits the 227 KB a block may hold, else
//     single-buffered: K's next tile is then issued once every warp is
//     past Q.K^T and lands during P.V (at float32 (192, 128), 128 rows:
//     Q 100 KB, K 50 KB, V 33 KB, P 41 KB = 219 KB; at (256, 256), 64
//     rows: Q 67 KB, K 67 KB, V 66 KB, P 20 KB = 214 KB).  On an H100 128
//     rows with one K buffer beat 64 rows with two at (192, 128).
//   * Staging by the rows' alignment, chosen per tensor: float32 rows
//     16-byte aligned by cp.async (16 bytes, zero-filled past S); 16-bit
//     rows 16-byte aligned by 16-byte loads of the next tile into registers
//     while the current one computes (K's before Q.K^T, V's before P.V),
//     converted to float32 as they are stored; other rows an element at a
//     time, between the same barriers (correct, not fast).
//   * The register tiles, padded strides, softmax and arithmetic of the
//     register-tiled body (whose copy helpers it calls); MLA's float32
//     (192, 128) and Gemma 2's 16-bit (256, 256) get Dk at compile time.
// On an H100 it runs at 40-49% of the bound at the float32 forward's, the
// MLA prefill's and Gemma 2 9B's shapes; PERF.md has the measurements.
// Nothing of size S x S exists in either body.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLanes = 16;           // lanes along a packed row
constexpr float kNegInf = -1e30f;    // finite, as the reference's mask

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ---------------------------------------------------------------------------
// The basic body (any dtype, Dk and Dv up to 256, any alignment and group)
// ---------------------------------------------------------------------------

namespace basic {

constexpr int kKeys = 64;               // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTN = kKeys / kLanes;     // 4 keys a lane
constexpr int kPs = kKeys + 16;         // row stride of sP, in floats
constexpr int kMaxD = 256;
constexpr int kRows = 128;              // packed rows a block up to kNarrowD
constexpr int kWideRows = 64;           // ... and above it
constexpr int kNarrowD = 128;
constexpr int kWideDk = 192;            // float32: kRows up to (192, 128)
constexpr size_t kSmemMax = 232448;     // the most a block may opt in to

// kRows up to Dk, Dv = kNarrowD; float32 also up to Dk = kWideDk at
// Dv <= kNarrowD, where Q, one K tile, V and P still fit (219 KB at
// (192, 128)); kWideRows above.
int rows_for(int Dk, int Dv, bool f32) {
  if (Dv > kNarrowD) return kWideRows;
  return Dk <= kNarrowD || (f32 && Dk <= kWideDk) ? kRows : kWideRows;
}

// Q, kbuf K tiles, one V tile and P, for `rows` packed rows.
size_t smem_bytes(int rows, int Dk, int Dv, int kbuf) {
  return sizeof(float) *
         (static_cast<size_t>(rows + kbuf * kKeys) * (Dk + 4) +
          static_cast<size_t>(kKeys) * Dv + static_cast<size_t>(rows) * kPs);
}

// K is double-buffered where that fits, else single-buffered.
int kbuf_for(int rows, int Dk, int Dv) {
  return smem_bytes(rows, Dk, Dv, 2) <= kSmemMax ? 2 : 1;
}

template <typename T> __device__ __forceinline__ float2 pair_to_f(uint32_t w);
template <> __device__ __forceinline__ float2 pair_to_f<__half>(uint32_t w) {
  __half2 h;
  memcpy(&h, &w, sizeof(h));
  return __half22float2(h);
}
template <>
__device__ __forceinline__ float2 pair_to_f<__nv_bfloat16>(uint32_t w) {
  __nv_bfloat162 h;
  memcpy(&h, &w, sizeof(h));
  return __bfloat1622float2(h);
}

// Eight 16-bit elements (one 16-byte word) to float32 at dst (16-byte
// aligned).
template <typename T>
__device__ __forceinline__ void put8(float* dst, const uint4& w) {
  const float2 a = pair_to_f<T>(w.x), b = pair_to_f<T>(w.y),
               c = pair_to_f<T>(w.z), d = pair_to_f<T>(w.w);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Four outputs, rounded to nearest in T.
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__half* dst, float a, float b, float c,
                                       float d) {
  const __half2 lo = __floats2half2_rn(a, b), hi = __floats2half2_rn(c, d);
  uint2 w;
  memcpy(&w.x, &lo, 4);
  memcpy(&w.y, &hi, 4);
  *reinterpret_cast<uint2*>(dst) = w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b),
                       hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  memcpy(&w.x, &lo, 4);
  memcpy(&w.y, &hi, 4);
  *reinterpret_cast<uint2*>(dst) = w;
}

// Rows [row0, row0 + n) of a (S, D) matrix at row stride `stride`; a row
// at index >= S reads as zeros (null).
template <typename T>
struct Rows {
  const T* base;
  long long stride;
  int row0, S;
  __device__ __forceinline__ const T* operator()(int r) const {
    const int row = row0 + r;
    return row < S ? base + row * stride : nullptr;
  }
};

// Stage n rows of D elements into shared memory as float32 (row stride
// ss); row r's source is src(r), or zeros where that is null.  vec (the
// rows are 16-byte aligned): float32 by cp.async (the caller commits and
// waits; `base` is a valid address for the zero-filled copies), 16-bit by
// 16-byte loads converted as they are stored.  Otherwise an element at a
// time.
template <typename T, typename Src>
__device__ __forceinline__ void stage(float* dst, int ss, int n, int D,
                                      bool vec, const T* base, Src src) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const int chunks = D >> 2;
      for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
        const int r = i / chunks, ch = i - r * chunks;
        const T* s = src(r);
        rt::cp_async16(dst + r * ss + 4 * ch, s ? s + 4 * ch : base,
                       s != nullptr);
      }
    } else {
      const int chunks = D >> 3;
      for (int i = threadIdx.x; i < n * chunks; i += kThreads) {
        const int r = i / chunks, ch = i - r * chunks;
        const T* s = src(r);
        const uint4 w = s ? __ldg(reinterpret_cast<const uint4*>(s + 8 * ch))
                          : make_uint4(0, 0, 0, 0);
        put8<T>(dst + r * ss + 8 * ch, w);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const T* s = src(r);
      dst[r * ss + d] = s ? to_f(s[d]) : 0.f;
    }
  }
}

// A K or V tile of 16-bit inputs (kKeys rows of D elements, 16-byte
// aligned) held in registers between its loads and its stores: NPRE
// 16-byte words a thread.
template <typename T, int NPRE>
struct Prefetch {
  uint4 w[NPRE];

  __device__ __forceinline__ void load(const Rows<T>& rows, int D) {
    const int chunks = D >> 3;
#pragma unroll
    for (int u = 0; u < NPRE; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / chunks, ch = i - r * chunks;
      if (r < kKeys) {
        const T* s = rows(r);
        w[u] = s ? __ldg(reinterpret_cast<const uint4*>(s + 8 * ch))
                 : make_uint4(0, 0, 0, 0);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ss, int D) const {
    const int chunks = D >> 3;
#pragma unroll
    for (int u = 0; u < NPRE; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / chunks, ch = i - r * chunks;
      if (r < kKeys) put8<T>(dst + r * ss + 8 * ch, w[u]);
    }
  }
};

// Stage a K or V tile: from the registers `pre` loaded (16-bit, aligned),
// else as stage() does.
template <typename T, int NPRE>
__device__ __forceinline__ void stage_tile(float* dst, int ss, int D,
                                           bool vec,
                                           const Prefetch<T, NPRE>& pre,
                                           const Rows<T>& rows) {
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      pre.store(dst, ss, D);
      return;
    }
  }
  stage<T>(dst, ss, kKeys, D, vec, rows.base, rows);
}

// R: packed query rows a block (rows_for).  NCH: 16-byte output column
// chunks a lane holds, 64 * NCH >= Dv.  DK: Dk fixed at compile time (0:
// read from p).  kbuf: K tiles in shared memory (1 or 2).  vec: bit 0, 1,
// 2 set where q, k, v rows are 16-byte aligned.
template <typename T, int R, int NCH, int DK>
__global__ void __launch_bounds__(kThreads, 1)
flash_basic_kernel(const Params p, const int kbuf, const int vec) {
  constexpr int kWarpRows = R / kWarps;  // 16 or 8 packed rows a warp
  constexpr int kTM = kWarpRows / 2;     // 8 or 4 rows a lane
  // 16-byte words a thread of a 16-bit K or V tile (64 x D / 8 words;
  // 16-bit inputs take kRows only up to kNarrowD).
  constexpr int kPre =
      (kKeys * (R == kRows ? kNarrowD : kMaxD) / 8 + kThreads - 1) / kThreads;
  extern __shared__ float4 basic_smem[];
  float* smem = reinterpret_cast<float*>(basic_smem);
  const int S = p.S, Dv = p.Dv;
  const int Dk = DK ? DK : p.Dk;
  const int G = p.Hq / p.Hkv;
  const int GB = min(G, R);            // query heads a block
  const int QR = R / GB;               // q rows of each in a block
  const int n_hg = (G + GB - 1) / GB;  // blocks a q tile of one KV head
  const int nq = (S + QR - 1) / QR;
  const int heads = n_hg * p.Hkv * p.B;
  // Longest first: blocks 0.. take the last q tile of every (head group,
  // KV head, batch), the next ones the tile before, and so on.
  const int wave = blockIdx.x / heads;
  const int hb = blockIdx.x - wave * heads;
  const int hg = hb % n_hg, hk = (hb / n_hg) % p.Hkv, b = hb / (n_hg * p.Hkv);
  const int q0 = (nq - 1 - wave) * QR;
  const int g0 = hg * GB;  // the block's first head within the group

  const int ks = Dk + 4;  // padded row stride of sQ and sK
  float* sQ = smem;
  float* sK = sQ + R * ks;
  float* sV = sK + kbuf * kKeys * ks;
  float* sP = sV + kKeys * Dv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane / kLanes, c = lane % kLanes;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] +
                static_cast<long long>(hk * G + g0) * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const bool qvec = vec & 1, kvec = vec & 2, vvec = vec & 4;
  const int tiles = (S + kKeys - 1) / kKeys;
  const int q_last = min(q0 + QR, S) - 1;
  const int n_tiles = p.causal ? min(tiles, q_last / kKeys + 1) : tiles;

  // Packed row pr = gl * QR + i is q row q0 + i of head hk * G + g0 + gl.
  const long long qsh = p.qs[1], qss = p.qs[2];
  const auto q_src = [=](int pr) -> const T* {
    const int gl = pr / QR, row = q0 + pr - gl * QR;
    return gl < GB && g0 + gl < G && row < S ? qb + gl * qsh + row * qss
                                             : nullptr;
  };
  stage<T>(sQ, ks, R, Dk, qvec, qb, q_src);
  stage<T>(sK, ks, kKeys, Dk, kvec, kb, Rows<T>{kb, p.ks[2], 0, S});
  rt::cp_async_commit();
  stage<T>(sV, Dv, kKeys, Dv, vvec, vb, Rows<T>{vb, p.vs[2], 0, S});
  rt::cp_async_commit();
  if (kbuf == 2) {
    if (n_tiles > 1)
      stage<T>(sK + kKeys * ks, ks, kKeys, Dk, kvec, kb,
               Rows<T>{kb, p.ks[2], kKeys, S});
    rt::cp_async_commit();
    rt::cp_async_wait<2>();  // Q and K's first tile
  } else {
    rt::cp_async_wait<1>();
  }

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
  const float* qw = sQ + pr0 * ks;  // row i at + 2 i ks
  float* pw = sP + pr0 * kPs;       // row i at + 2 i kPs
  Prefetch<T, kPre> kpre, vpre;     // 16-bit aligned K / V: the next tile
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    // The K tile staged in this iteration, into the buffer Q.K^T reads.
    const int tk = t + kbuf;
    float* kbuf_t = sK + (kbuf == 2 ? (t & 1) : 0) * kKeys * ks;
    const Rows<T> k_rows{kb, p.ks[2], tk * kKeys, S};
    if constexpr (sizeof(T) == 2) {
      if (kvec && tk < n_tiles) kpre.load(k_rows, Dk);
    }
    const float* kt = kbuf_t + c * ks;  // key c + 16 j at + 16 j ks
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    // S = Q.K^T, the fmaf chain over d in order.
#pragma unroll 4
    for (int d = 0; d < Dk; d += 4) {
      float4 kv[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + kLanes * j * ks + d);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + 2 * i * ks + d);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    // The online softmax, each step over the lane's rows at once.  Masks
    // only on a tile that reaches past S or the causal diagonal.
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

    // K's buffer is free once every warp is past Q.K^T: stage tile tk
    // there.  Double-buffered, V's tile t and K's tile t + 1 have landed
    // too; single-buffered, wait for V's tile t after the issue.
    if (kbuf == 2) rt::cp_async_wait<0>();
    __syncthreads();
    if (tk < n_tiles) stage_tile<T, kPre>(kbuf_t, ks, Dk, kvec, kpre, k_rows);
    rt::cp_async_commit();
    if (kbuf == 1) {
      rt::cp_async_wait<1>();
      __syncthreads();
    }
    const Rows<T> v_rows{vb, p.vs[2], k0 + kKeys, S};
    if constexpr (sizeof(T) == 2) {
      if (vvec && t + 1 < n_tiles) vpre.load(v_rows, Dv);
    }

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
            const float pe = rt::lane_of(pv[i], e);
            acc[i][4 * u + 0] = fmaf(pe, vv.x, acc[i][4 * u + 0]);
            acc[i][4 * u + 1] = fmaf(pe, vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pe, vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pe, vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V's tile t
    if (t + 1 < n_tiles) stage_tile<T, kPre>(sV, Dv, Dv, vvec, vpre, v_rows);
    rt::cp_async_commit();
    if (kbuf == 1) {  // K's tile t + 1, before its Q.K^T
      rt::cp_async_wait<1>();
      __syncthreads();
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int pr = pr0 + 2 * i;
    const int gl = pr / QR, row = q0 + pr - gl * QR;
    if (gl >= GB || g0 + gl >= G || row >= S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + ((static_cast<long long>(b) * p.Hq + hk * G + g0 + gl) * S +
                   row) * static_cast<long long>(Dv);
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      if (c + kLanes * u >= Dv / 4) continue;
      store4(orow + vcol[u], acc[i][4 * u] / safe_l,
             acc[i][4 * u + 1] / safe_l, acc[i][4 * u + 2] / safe_l,
             acc[i][4 * u + 3] / safe_l);
    }
  }
}

// Rows of a (B, H, S, D) tensor that 16-byte copies can address: a 16-byte
// aligned base and (B, H, S) strides in multiples of 16 bytes.
template <typename T>
bool aligned16(const void* ptr, const long long* strides) {
  const long long n = 16 / sizeof(T);
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 &&
         strides[0] % n == 0 && strides[1] % n == 0 && strides[2] % n == 0;
}

template <typename T, int R, int NCH, int DK = 0>
int launch(const Params& p, cudaStream_t stream) {
  const int kbuf = kbuf_for(R, p.Dk, p.Dv);
  const size_t smem = smem_bytes(R, p.Dk, p.Dv, kbuf);
  cudaError_t err = cudaFuncSetAttribute(
      flash_basic_kernel<T, R, NCH, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (aligned16<T>(p.q, p.qs) ? 1 : 0) |
                  (aligned16<T>(p.k, p.ks) ? 2 : 0) |
                  (aligned16<T>(p.v, p.vs) ? 4 : 0);
  const int G = p.Hq / p.Hkv;
  const int GB = G < R ? G : R;
  const int QR = R / GB;
  const long long blocks = static_cast<long long>((p.S + QR - 1) / QR) *
                           ((G + GB - 1) / GB) * p.Hkv * p.B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_basic_kernel<T, R, NCH, DK>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p, kbuf, vec);
  return static_cast<int>(cudaGetLastError());
}

// MLA's float32 (192, 128) and Gemma 2's 16-bit (256, 256) get Dk at
// compile time; the rest read it.
template <typename T>
int launch_dims(const Params& p, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  if (rows_for(p.Dk, p.Dv, f32) == kRows) {
    if constexpr (f32) {
      if (p.Dk == 192 && p.Dv == 128) return launch<T, kRows, 2, 192>(p, stream);
    }
    return p.Dv <= 64 ? launch<T, kRows, 1>(p, stream)
                      : launch<T, kRows, 2>(p, stream);
  }
  if constexpr (!f32) {
    if (p.Dk == 256 && p.Dv == 256) return launch<T, kWideRows, 4, 256>(p, stream);
  }
  return p.Dv <= 128 ? launch<T, kWideRows, 2>(p, stream)
                     : launch<T, kWideRows, 4>(p, stream);
}

}  // namespace basic

}  // namespace

// Plain C entries for ctypes, one a body, with one signature.  dtype: 0
// float32, 1 float16, 2 bfloat16 (q, k, v and o share it).  Strides are in
// elements for the (B, H, S) axes; the D axis must be contiguous.  Each
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for inputs its body does not take; a refused
// launch never runs, so the caller must check.

// The basic body: any dtype, Hq a multiple of Hkv, Dk and Dv multiples of
// 8 up to 256, o 16-byte aligned (the wrapper's contiguous output).
extern "C" int flash_attention_basic_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int S, int Dk, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Dk <= 0 || Dk > basic::kMaxD || Dk % 8 ||
      Dv <= 0 || Dv > basic::kMaxD || Dv % 8 || Hq > 65535 || B > 65535 ||
      (reinterpret_cast<uintptr_t>(o) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, B, Hq, Hkv, S, Dk, Dv,
           {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return basic::launch_dims<float>(p, st);
    case 1: return basic::launch_dims<__half>(p, st);
    case 2: return basic::launch_dims<__nv_bfloat16>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one basic block at (Dk, Dv) for float32 (f32
// 1) or 16-bit inputs, in bytes, and its packed rows: (rows << 32) | bytes.
extern "C" long long flash_attention_basic_smem(int Dk, int Dv, int f32) {
  const int rows = basic::rows_for(Dk, Dv, f32 != 0);
  return (static_cast<long long>(rows) << 32) |
         static_cast<long long>(
             basic::smem_bytes(rows, Dk, Dv, basic::kbuf_for(rows, Dk, Dv)));
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
