// Causal / non-causal GQA flash attention forward on Hopper tensor cores
// (sm_90a): bfloat16 or float16 inputs, head dims (Dk, Dv) of (64, 64),
// (128, 128) and (192, 128).
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_padded
// (the Pallas TPU kernel, body _flash_kernel) for the inputs above; every
// prefill of the model serving path runs through it via gqa.apply.
// float32 and the other head dims stay on csrc/flash_attention.cu.
//
// What it computes, for q (B, Hq, S, Dk), k (B, Hkv, S, Dk),
// v (B, Hkv, S, Dv), with KV head h / (Hq / Hkv):
//   s = (q . k) * scale in float32 (a bf16 x bf16 product is exact in
//   float32, so s differs from the float32 reference in summation order
//   only); causal: s = -1e30 where row < col; keys >= S: s = -1e30;
//   the online softmax over 128-key tiles in order, with float32 running
//   max m, denominator l and accumulator:
//     m_new = max(m, rowmax(s)), p = exp(s - m_new),
//     l = l * exp(m - m_new) + sum(p)            (the unrounded p),
//     acc = acc * exp(m - m_new) + round(p) . v  (p rounded to q's dtype);
//   o = acc / safe_l (safe_l = l > 0 ? l : 1), rounded once to q's dtype;
//   rows >= S are not written.
// The one departure from the float32 reference is the rounding of p to
// q's dtype before P.V, the rule of ref.chunked_attention(p_dtype=...)
// (whose chunk is this kernel's key tile, ref.KEY_TILE = kBK).  p in
// [0, 1] rounded to bf16 is off by at most 2^-9 of
// itself, so |o - o_exact| <= 2^-9 * max|v| plus the final rounding.
//
// Bound: operations.  At the serving shape (S=2048, Hq=16, D=128, causal)
// a launch does 2 * S(S+1)/2 * (Dk + Dv) * Hq = 17.2 GFLOP: 17.4 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 25 MB of q, k, v and o
// (7.5 us at 3.35 TB/s).
//
// Design, for that bound:
//   * Both products on the tensor cores through wgmma.mma_async: S = Q.K^T
//     with Q and K from shared memory (K-major), O += P.V with P from
//     registers (the S accumulator's fragment maps onto wgmma's A fragment
//     per k16 slice, so P never touches shared memory) and V from shared
//     memory (MN-major: Dv contiguous, the transpose bit of 16-bit types).
//   * K/V come through TMA (cp.async.bulk.tensor, 4-D maps with byte
//     strides, so the (B, S, H, D) views the model passes need no copy)
//     into a ring guarded by full/empty mbarriers (three stages up to
//     Dk = 128, two at Dk = 192), in 128-byte swizzled 64-column blocks
//     that the wgmma descriptors name.  TMA's out-of-bounds zero fill
//     covers the ragged last tile; those keys are masked before the row
//     max.
//   * Warp specialisation: 384 threads; warpgroup 0 is the producer (one
//     thread issues every TMA) and gives up registers (setmaxnreg 24);
//     warpgroups 1 and 2 each own 64 query rows of the 128-row q tile and
//     ask for 240 registers each for their 64 + Dv/2 float32 accumulators.
//   * The softmax works on the raw scores and folds the scale into one
//     FFMA per element ahead of exp2.
//   * Causal work: K/V tiles above the diagonal are never loaded, only
//     tiles that cross the diagonal or the ragged edge pay for the mask,
//     the heaviest q tiles (the last rows) are scheduled first, and the q
//     heads of one KV group are adjacent blocks, so they share K/V in L2.
// Tried on one H100 and left out, both slower than this loop: issuing
// tile t's Q.K^T before tile t-1's P.V (FA3's intra-warpgroup overlap),
// which spills because ptxas holds the consumers to the 168 registers of
// the launch bound, and turns between the two consumer warpgroups on
// named barriers (ping-pong).  Not done yet: a persistent scheduler, a
// TMA store of O.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 128;      // query rows per block: 2 consumer warpgroups x 64
constexpr int kBK = 128;      // keys per K/V tile (N of Q.K^T, K of P.V)
constexpr int kThreads = 384; // producer warpgroup + 2 consumer warpgroups
constexpr int kColBytes = 128;  // one swizzled column block: 64 16-bit values
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;  // finite, as the reference's mask
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;  // (B, Hq, S, Dv), contiguous
  int B, Hq, Hkv, S;
  float scale;
  int causal;
};

// Shared memory: Q (Dk/64 column blocks of 128 rows), then the K and V
// stages (Dk/64 and Dv/64 column blocks of 128 keys), then the mbarriers.
// Every block starts on a 1024-byte boundary (the 128-byte swizzle's atom).
// Three stages fit up to Dk = 128 (225 KB), two at Dk = 192 (209 KB).
template <int DK, int DV>
struct Layout {
  static constexpr int kStages = DK <= 128 ? 3 : 2;  // K/V ring depth
  static constexpr int kQ = kBQ * DK * 2;
  static constexpr int kK = kBK * DK * 2;
  static constexpr int kV = kBK * DV * 2;
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kK;
  static constexpr int kBarOff = kVOff + kStages * kV;
  static constexpr int kBytes = kBarOff + 128 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` has completed.  A wait that
// lasts kWaitLimitNs (a copy or an arrival that never comes; a real wait
// takes microseconds) traps, so a fault in the ring ends the launch with
// an error instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 20000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > kWaitLimitNs) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
#define FA_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// S (64 x 128, float32) = A (64 x 16, smem, K-major) . B (16 x 128, smem,
// K-major); scale_d = 0 overwrites d.
#define FA_SS_N128(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               FA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                     \
               : FA_D64                                                      \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    FA_SS_N128("f16");
  } else {
    FA_SS_N128("bf16");
  }
}

// O (64 x N, float32) += A (64 x 16, registers) . B (16 x N, smem,
// MN-major: the transpose bit).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "P.V takes Dv of 64 or 128");
  if constexpr (N == 128) {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " FA_R64
                   ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                   : FA_D64
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_R64
                   ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                   : FA_D64
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " FA_R32
                   ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                   : FA_D32
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
                   ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                   : FA_D32
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values rounded to nearest (even) into one 32-bit register,
// the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  using L = Layout<DK, DV>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + L::kKOff;
  const uint32_t sV = base + L::kVOff;
  const uint32_t bar_q = base + L::kBarOff;
  auto full_k = [&](int s) { return bar_q + 8u + 8u * s; };
  auto full_v = [&](int s) { return bar_q + 8u + 8u * (kStages + s); };
  auto empty_bar = [&](int s) { return bar_q + 8u + 8u * (2 * kStages + s); };

  // Block order: q tile slowest, heaviest (last) tile first; within a q
  // tile, batch then head, so the q heads of one KV group are adjacent.
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int bh = p.B * p.Hq;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;
  const int rem = static_cast<int>(blockIdx.x) % bh;
  const int b = rem / p.Hq;
  const int h = rem % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * kBQ;
  const int n_kt_all = (p.S + kBK - 1) / kBK;
  const int n_kt =
      p.causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1) : n_kt_all;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_bar(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQ);
#pragma unroll
      for (int c = 0; c < DK / 64; ++c)
        tma_load_4d(sQ + c * kBQ * kColBytes, &tm_q, bar_q, 64 * c, q0, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(empty_bar(s), ph ^ 1);
        mbar_expect_tx(full_k(s), L::kK);
#pragma unroll
        for (int c = 0; c < DK / 64; ++c)
          tma_load_4d(sK + s * L::kK + c * kBK * kColBytes, &tm_k, full_k(s),
                      64 * c, t * kBK, hk, b);
        mbar_expect_tx(full_v(s), L::kV);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load_4d(sV + s * L::kV + c * kBK * kColBytes, &tm_v, full_v(s),
                      64 * c, t * kBK, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each -----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32;
    const int lane = t128 % 32;
    // This thread's accumulator rows (r0, r0 + 8) and column pair offset.
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const int cpair = 2 * (lane % 4);
    const float sl2 = p.scale * kLog2e;  // softmax in base 2

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t q_wg = sQ + cw * 64 * kColBytes;
    mbar_wait(bar_q, 0);

    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = t * kBK;
      float sc[kBK / 2];

      // S = Q . K^T over Dk in k16 slices: slice kk sits in column block
      // kk / 4 at byte offset 32 * (kk % 4) of each swizzled 128-byte row.
      mbar_wait(full_k(s), ph);
      const uint32_t k_st = sK + s * L::kK;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint64_t da =
            desc_sw128(q_wg + (kk / 4) * kBQ * kColBytes + (kk % 4) * 32, 16,
                       1024);
        const uint64_t db =
            desc_sw128(k_st + (kk / 4) * kBK * kColBytes + (kk % 4) * 32, 16,
                       1024);
        wgmma_ss_n128<T>(sc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // Mask, then the row max over the 4 lanes of a row (of the raw
      // scores: scale > 0, so the max commutes with the scaling).
      const bool masked = k0 + kBK > p.S ||
                          (p.causal && k0 + kBK - 1 > q0 + 64 * cw);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + cpair + (i % 2);
        const int row = r0 + ((i / 2) % 2) * 8;
        if (masked && (col >= p.S || (p.causal && row < col))) sc[i] = kNegInf;
        if ((i / 2) % 2)
          mx1 = fmaxf(mx1, sc[i]);
        else
          mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = ex2((m0 - mn0) * sl2), al1 = ex2((m1 - mn1) * sl2);
      const float b0 = -mn0 * sl2, b1 = -mn1 * sl2;
      m0 = mn0;
      m1 = mn1;

      // p = exp(scale (s - m)), one FFMA into exp2; l sums the unrounded
      // p; P.V takes p rounded to T,
      // packed straight into wgmma's A fragment: slice ks holds columns
      // 16 ks .. 16 ks + 15, registers 8 ks .. 8 ks + 7 of the S fragment.
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float e = ex2(fmaf(sc[i], sl2, (i / 2) % 2 ? b1 : b0));
        sc[i] = e;
        if ((i / 2) % 2)
          rs1 += e;
        else
          rs0 += e;
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[ks][r] = pack2<T>(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= (i / 2) % 2 ? al1 : al0;

      // O += P . V over the tile's keys in k16 slices: 16 keys of every
      // column block are two 1024-byte swizzle atoms (SBO); the next 64
      // output columns sit one column block (128 keys x 128 bytes) on (LBO).
      mbar_wait(full_v(s), ph);
      const uint32_t v_st = sV + s * L::kV;
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t db =
            desc_sw128(v_st + ks * 16 * kColBytes, kBK * kColBytes, 1024);
        wgmma_rs<T, DV>(o, pa[ks], db);
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_bar(s));
    }

    // The row sums over the 4 lanes of a row, then o / safe_l, rows < S.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float sl0 = l0 > 0.f ? l0 : 1.f, sl1 = l1 > 0.f ? l1 : 1.f;
    T* out = static_cast<T*>(p.o) +
             (static_cast<long long>(b) * p.Hq + h) * static_cast<long long>(p.S) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + cpair;
      if (r0 < p.S)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r0) * DV + col) =
            pack2<T>(o[4 * j] / sl0, o[4 * j + 1] / sl0);
      if (r0 + 8 < p.S)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r0 + 8) * DV + col) =
            pack2<T>(o[4 * j + 2] / sl1, o[4 * j + 3] / sl1);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 4-D map (D, S, H, B) with element strides of the (S, H, B) axes, read
// in boxes of 64 columns x `rows` rows with the 128-byte swizzle;
// out-of-bounds rows read as zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            int d, int S, int H, int B, long long ss, long long sh,
            long long sb, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DK, int DV>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<DK, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((p.S + kBQ - 1) / kBQ) * p.Hq * p.B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_wgmma_kernel<T, DK, DV>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(q, k, v, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dims(const CUtensorMap& q, const CUtensorMap& k,
                const CUtensorMap& v, const Params& p, int Dk, int Dv,
                cudaStream_t stream) {
  if (Dk == 128 && Dv == 128) return launch<T, 128, 128>(q, k, v, p, stream);
  if (Dk == 64 && Dv == 64) return launch<T, 64, 64>(q, k, v, p, stream);
  if (Dk == 192 && Dv == 128) return launch<T, 192, 128>(q, k, v, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes.  dtype: 1 float16, 2 bfloat16 (q, k, v and o
// share it).  (Dk, Dv) one of (64, 64), (128, 128), (192, 128).  Strides
// are in elements for the (B, H, S) axes; the D axis is contiguous, every
// pointer 16-byte aligned and every stride a multiple of 8 elements (TMA's
// rules).  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for inputs the kernel does not take or a tensor
// map the driver refuses; a refused launch never runs.
extern "C" int flash_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int S, int Dk, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type = dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, type, q, Dk, S, Hq, B, qss, qsh, qsb, kBQ) ||
      !encode(&tk, type, k, Dk, S, Hkv, B, kss, ksh, ksb, kBK) ||
      !encode(&tv, type, v, Dv, S, Hkv, B, vss, vsh, vsb, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o, B, Hq, Hkv, S, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dims<__half>(tq, tk, tv, p, Dk, Dv, st)
                    : launch_dims<__nv_bfloat16>(tq, tk, tv, p, Dk, Dv, st);
}
