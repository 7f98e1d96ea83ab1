// Fused kNN radius + ball/tie counts for a batch of padded samples (sm_90a).
//
// Replaces: repro/kernels/knn_stats/kernel.py::radius_counts_padded (the
// Pallas TPU kernel, bodies _radius_counts_kernel_1 and
// _radius_counts_kernel), which serves every KSG-family estimator.
//
// What it computes, per sample b and row i of a padded sample (x, y, mask):
//   * the radius: the t-th smallest selected distance (0-based, duplicates
//     counted, +inf when fewer than t+1 are selectable).  Joint mode
//     selects max(|dx|, |dy|) over valid j != i and takes t = k-1; class
//     mode selects |dy| over valid j != i with x_j == x_i and takes the
//     DC-KSG lane t = clip(min(kk, n_x-1)-1, 0, kb-1), n_x = cnt + mask_i;
//   * cnt: the number of same-class neighbours (class mode, else 0);
//   * five counts at that radius over valid j != i: |dx| < r, |dy| < r,
//     dx == 0, dy == 0, dx == dy == 0 (only |dy| < r when which == y).
//   An invalid row gets radius +inf and zero counts.  The TPU kernel's
//   (P, 128) lane-packed output was a VMEM tiling artifact; here each
//   statistic is its own (B, P) array.
//
// NaN: a NaN distance is never selected (the tiled body's insertion test
// d < buf[W-1] is false for it, the staged body's min/max network drops
// it, and the joint distance propagates NaN from either marginal, as
// jnp.maximum does), and every count condition is false
// for NaN (the tie count tests dx <= 0 && dy <= 0, which equals
// max(dx, dy) <= 0 without fmaxf's NaN dropping).  ref.py follows the
// same rule.  Parity with the JAX package is claimed for finite inputs.
//
// Bound: ALU work; the bytes, B*P*(9 in + 28 out), are small beside it.
// The direct algorithm (the tiled body) pays, per valid pair (i, j != i),
// a distance, the compare against the running order statistic and the
// count compares and adds: 16 operations in joint mode with all five
// counts (chip_smoke.py's RC_OPS).  Once a sample is sorted by x, the
// function needs per pair only the y counts (4 to 6 operations); the rest
// is the sort, the band or class run that selection visits, and binary
// searches a row (chip_smoke.py's RC_NEED_*, the bound it reports).
//
// Two bodies, picked by kernel.py::takes_staged (a plain Python rule):
//
// radius_counts_launch, the staged body: P <= 1024 and a buffer of at
// most 16 lanes (k, or kb in class mode, <= 16); the main path's P = 256,
// k = 3.  One warp per sample, no block-wide barrier; a block holds as
// many samples as fit 48 KB of shared memory (7 at P = 256).
//   * Staging loads 4 chunks of 32 columns at once and compacts the valid
//     columns, in order, with warp ballots, so nothing later visits an
//     invalid column or tests the mask.  Compacting is exact: the
//     selected multiset and the counts do not depend on column order.
//   * The columns are sorted by x (the class code in class mode) by value:
//     64-bit words (order key of x, column), -0 folded onto +0, NaN last.
//     Up to 256 columns the warp sorts in registers (a bitonic network,
//     8 words a lane, lanes exchanged by shuffles); above, the same
//     network in shared memory.  Rows are then taken in sorted order.
//   * Sweep 1, joint mode: from the row's sorted position outward, right
//     then left, while |dx| < the current W-th smallest distance; since
//     |fl(xi - x_j)| does not decrease along either side and d >= |dx|,
//     no column further out can be selected, so a row visits a band of
//     its nearest columns in x.  Class mode: the row's run of equal
//     codes (run starts kept in a bitmap; a NaN code is a run of none), R
//     rows in lockstep.  Neither visits the row's own column.  The buffer
//     holds W = 3, 8 or 16 lanes (the least >= k, or kb in class mode);
//     its update is branch-free, b[s] = max(b[s-1], min(b[s], d)), NaN-safe
//     (fminf/fmaxf drop a NaN d); the joint distance is one max.NaN.f32;
//     the lane read is a chain of selp (an indexed read would put the
//     buffer in local memory).
//   * Sweep 2, y part: every valid column for R rows a lane (R = 4, 2, 1
//     at W = 3, 8, 16; one shared load feeds R pairs; the last 96 rows
//     go in groups of 64 and 32), the row's own column included and its
//     contribution taken out with the same expressions (its dy is +0 or
//     NaN); each count is a compare and a predicated float add (the add
//     runs on the FMA pipe; exact below 2^24).  The x part: the columns
//     with |fl(xi - x_j)| < r, and those with fl(xi - x_j) == 0, are
//     ranges of the sorted order (fl(xi - x_j) does not increase along
//     it), found by binary search; j_eq walks the second range.
//   * Outputs go to shared memory (r as float, cnt and counts as uint16,
//     over the dead staging arrays) and leave in one coalesced pass;
//     stores through the compaction's permutation were, measured on the
//     card, the largest cost outside the sweeps.  A minimum of one
//     block an SM in the launch bounds lifts the 64-register cap ptxas
//     chose without it (class mode spilled; shared memory, not
//     registers, limits residency at P = 256).
//   Tried on the card and left out: a branch on d < b[W-1] before the
//   network (slower), R = 2 or 1 rows a lane, one block-wide slot per
//   sample with a block-wide sort (barrier-bound), joint rows in
//   lockstep, nearest-first and flattened per-lane selection loops (all
//   slower; the selection is bound by its dependency chain and by the
//   slowest lane of the warp).
//
// radius_counts_tiled_launch, the tiled body (P > 1024 or a buffer wider
// than 16, up to kb = 128): the first port's design.  One block per (sample,
// 128-row tile), one thread per row, the sample's x, y and mask staged in
// 1024-column tiles, an explicit j != i test and a mask test per pair,
// the W-lane buffer (W = 4..128 >= need) updated on d < buf[W-1].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// ---------------------------------------------------------------------------
// The staged body
// ---------------------------------------------------------------------------
namespace staged {

constexpr int kMaxWarps = 8;          // samples (warps) per block, at most
constexpr int kBlockBytes = 48 << 10;  // shared memory a block takes, at most
constexpr int kPrefetch = 4;          // 32-column chunks loaded per step
constexpr int kMaxP = 1024;  // kernel.py: STAGED_MAX_P
constexpr int kMaxW = 16;    // kernel.py: STAGED_MAX_W

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of one warp's arrays in dynamic shared memory (NP: P
// rounded up to a power of two, at least 32, the sort's length).  The
// staged (x, y) and columns are dead once their sorted copies exist, so
// the output arrays take their place; the sorted (x, y) takes the key
// array's.
struct Layout {
  size_t xy, idx, out_r, out_c, key, sidx, flags, valid, total;
};

__host__ __device__ inline Layout layout(int P, int NP) {
  const size_t p = static_cast<size_t>(P), words = (p + 31) / 32;
  Layout L{};
  L.xy = 0;
  L.idx = align16(8 * p);
  L.out_r = 0;
  L.out_c = align16(4 * p);
  size_t o = align16(L.out_c + 12 * p);
  L.key = o;   o = align16(o + 8 * static_cast<size_t>(NP));
  L.sidx = o;  o = align16(o + 2 * p);
  L.flags = o; o = align16(o + 4 * words);
  L.valid = o; o = align16(o + 4 * words);
  L.total = o;
  return L;
}

// A float's order as an unsigned key: -0 folded onto +0, every NaN the
// largest key (and never equal to a number's).
__device__ __forceinline__ uint32_t code_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  if (v == 0.f) return 0x80000000u;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// [lo, hi): the run of sorted position s, from the run-start bitmap over
// the n sorted columns (position 0 always starts a run).
__device__ __forceinline__ void run_bounds(const uint32_t* flags, int s, int n,
                                           int& lo, int& hi) {
  int e = s >> 5;
  uint32_t m = flags[e] & (0xFFFFFFFFu >> (31 - (s & 31)));
  while (m == 0) m = flags[--e];
  lo = e * 32 + 31 - __clz(m);
  e = s >> 5;
  m = flags[e] & (0xFFFFFFFEu << (s & 31));
  const int words = (n + 31) >> 5;
  while (m == 0 && ++e < words) m = flags[e];
  hi = m ? e * 32 + __ffs(m) - 1 : n;
}

// Sorted insertion of d into b[0..W): the W smallest values seen so far.
// Branch-free; fminf/fmaxf drop a NaN d, which leaves b as it was.
template <int W>
__device__ __forceinline__ void insert(float (&b)[W], float d) {
#pragma unroll
  for (int s = W - 1; s > 0; --s) b[s] = fmaxf(b[s - 1], fminf(b[s], d));
  b[0] = fminf(b[0], d);
}

// b[t] for a run-time t < W, as a chain of selp: opaque to the compiler,
// which would otherwise turn the chain into an indexed load and keep b in
// local memory.
template <int W>
__device__ __forceinline__ float lane_of(const float (&b)[W], int t) {
  float r = b[0];
#pragma unroll
  for (int s = 1; s < W; ++s) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %2, %3;\n\t"
        "selp.f32 %0, %1, %0, p;\n\t}"
        : "+f"(r) : "f"(b[s]), "r"(t), "r"(s));
  }
  return r;
}

// acc += 1 where d < r, as a compare and a predicated float add (the add
// runs on the FMA pipe; counts stay exact below 2^24).
__device__ __forceinline__ void count_lt(float& acc, float d, float r) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, %2;\n\t"
      "@p add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(acc) : "f"(d), "f"(r));
}

// One warp sorts N = 32 * E distinct 64-bit keys held in registers (lane l
// holds elements l * E .. l * E + E - 1): a bitonic network whose strides
// below E exchange registers and whose strides from E up exchange lanes.
template <int E>
__device__ __forceinline__ void warp_sort(uint64_t (&v)[E], int lane) {
  for (int size = 2; size <= 32 * E; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const int lj = stride / E;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const uint64_t o = __shfl_xor_sync(0xFFFFFFFFu, v[i], lj);
          const bool up = ((lane * E + i) & size) == 0;
          v[i] = ((lower == up) == (o < v[i])) ? o : v[i];
        }
      } else {
#pragma unroll
        for (int sj = 1; sj < E; sj <<= 1) {
          if (sj != stride) continue;
#pragma unroll
          for (int i = 0; i < E; ++i) {
            if (i & sj) continue;
            const uint64_t a = v[i], c = v[i | sj];
            const bool swap = (a > c) == (((lane * E + i) & size) == 0);
            v[i] = swap ? c : a;
            v[i | sj] = swap ? a : c;
          }
        }
      }
    }
  }
}

// The (code key, column) words of the n staged columns, sorted, into key.
template <int E>
__device__ __forceinline__ void sort_keys(const float2* xy, uint64_t* key,
                                          int n, int lane) {
  uint64_t v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = lane * E + i;
    v[i] = e < n ? (static_cast<uint64_t>(code_key(xy[e].x)) << 32) |
                       static_cast<uint32_t>(e)
                 : ~0ull;
  }
  warp_sort<E>(v, lane);
#pragma unroll
  for (int i = 0; i < E; ++i) key[lane * E + i] = v[i];
}

// acc += 1 where d <= 0.
__device__ __forceinline__ void count_le0(float& acc, float d) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, 0f00000000;\n\t"
      "@p add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(acc) : "f"(d));
}

// Over the sorted, non-NaN x of [0, nn), fl(xi - x_j) does not increase
// with j (rounding is monotone; -0 and +0 give the same difference).
// The first j at which it is < v, and the first at which it is <= v.
__device__ __forceinline__ int first_lt(const float2* xy, int nn, float xi,
                                        float v) {
  int lo = 0, hi = nn;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xi - xy[mid].x < v) hi = mid; else lo = mid + 1;
  }
  return lo;
}
__device__ __forceinline__ int first_le(const float2* xy, int nn, float xi,
                                        float v) {
  int lo = 0, hi = nn;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xi - xy[mid].x <= v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// One sample's arrays in shared memory, sorted by x (the class code in
// class mode): n valid columns, the first nn with a number for x.
struct Sample {
  const float2* xy;      // (x, y) in sorted order
  const uint16_t* idx;   // their column in the padded sample
  const uint32_t* flags; // class mode: run starts (a bit per position)
  float* out_r;          // the sample's radii, by padded column
  uint16_t* out_c;       // its cnt and 5 counts, 6 planes of P
  int P, n, nn;
};

// The joint sweep 1 of the row at sorted position s: outward from s,
// right then left, while |dx| < b[W-1].  Exact: along either side
// |fl(xi - x_j)| does not decrease, and d >= |dx|, so once |dx| >=
// b[W-1] no column further out can enter the W smallest (a tie with
// b[W-1] leaves its values as they are); a NaN x_j (sorted last) or a
// NaN / infinite xi ends the side at once, and no d there is selectable.
template <int W>
__device__ __forceinline__ void joint_select(const float2* xy, int n, int s,
                                             float xi, float yi,
                                             float (&b)[W]) {
  for (int j = s + 1; j < n; ++j) {
    const float2 c = xy[j];
    const float dx = fabsf(xi - c.x);
    if (!(dx < b[W - 1])) break;
    insert<W>(b, max_nan(dx, fabsf(yi - c.y)));
  }
  for (int j = s - 1; j >= 0; --j) {
    const float2 c = xy[j];
    const float dx = fabsf(xi - c.x);
    if (!(dx < b[W - 1])) break;
    insert<W>(b, max_nan(dx, fabsf(yi - c.y)));
  }
}

// The class sweep 1 of R rows: each row's run of equal codes [lo, hi)
// but its own position, the R rows in lockstep so that their insertions
// overlap.
template <int W, int R>
__device__ __forceinline__ void class_select(const float2* xy,
                                             const int (&s)[R],
                                             const int (&lo)[R],
                                             const int (&hi)[R],
                                             const float (&yi)[R],
                                             float (&b)[R][W]) {
  int len = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) len = max(len, hi[q] - lo[q]);
  for (int i = 0; i < len; ++i) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int j = lo[q] + i;
      if (j < hi[q] && j != s[q]) insert<W>(b[q], fabsf(yi[q] - xy[j].y));
    }
  }
}

// Both sweeps for the R rows s0 + lane + 32 q (q < R) of one group, in
// sorted order, into the sample's output arrays in shared memory.
template <int W, int R, bool JOINT, bool ALL>
__device__ __forceinline__ void sweep_rows(const Sample& S, int s0, int lane,
                                           int k, int kb, int kk) {
  const int n = S.n;
  int sq[R];
  float xi[R], yi[R];
  bool act[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    sq[q] = s0 + lane + 32 * q;
    act[q] = sq[q] < n;
    const float2 v = act[q] ? S.xy[sq[q]] : make_float2(NAN, NAN);
    xi[q] = v.x;
    yi[q] = v.y;
  }

  // Sweep 1: the W smallest selected distances over j != i.
  float buf[R][W];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int u = 0; u < W; ++u) buf[q][u] = INFINITY;
  float r[R];
  int cnt[R];
  if (JOINT) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (act[q]) joint_select<W>(S.xy, n, sq[q], xi[q], yi[q], buf[q]);
      cnt[q] = 0;
      r[q] = lane_of<W>(buf[q], k - 1);
    }
  } else {
    // The row's run; a NaN code equals nothing (an empty run).
    int lo[R], hi[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      lo[q] = hi[q] = sq[q];
      if (act[q] && xi[q] == xi[q]) run_bounds(S.flags, sq[q], n, lo[q], hi[q]);
      cnt[q] = hi[q] > lo[q] ? hi[q] - lo[q] - 1 : 0;
    }
    class_select<W, R>(S.xy, sq, lo, hi, yi, buf);
#pragma unroll
    for (int q = 0; q < R; ++q)
      r[q] = lane_of<W>(buf[q], max(min(min(kk, cnt[q]) - 1, kb - 1), 0));
  }

  // Sweep 2, the y part: every valid column, the self pair included,
  // then taken out.
  float y_lt[R], y_eq[R];
#pragma unroll
  for (int q = 0; q < R; ++q) y_lt[q] = y_eq[q] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float yj = S.xy[j].y;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float dy = fabsf(yi[q] - yj);
      count_lt(y_lt[q], dy, r[q]);
      if (ALL) count_le0(y_eq[q], dy);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (!act[q]) continue;
    const float dys = fabsf(yi[q] - yi[q]);
    y_lt[q] -= dys < r[q];
    y_eq[q] -= dys <= 0.f;
    // Sweep 2, the x part (which == all): the columns with |fl(xi - x_j)|
    // < r and those with fl(xi - x_j) == 0 are ranges of the sorted
    // order; j_eq walks the second.  A NaN or infinite xi meets no
    // condition.
    int x_lt = 0, x_eq = 0, j_eq = 0;
    if (ALL && fabsf(xi[q]) < INFINITY) {
      const int a = first_lt(S.xy, S.nn, xi[q], r[q]);
      const int b = first_le(S.xy, S.nn, xi[q], -r[q]);
      const int a0 = first_le(S.xy, S.nn, xi[q], 0.f);
      const int b0 = first_lt(S.xy, S.nn, xi[q], 0.f);
      x_lt = max(b - a, 0) - (0.f < r[q] ? 1 : 0);
      x_eq = b0 - a0 - 1;
      for (int j = a0; j < b0; ++j) j_eq += fabsf(yi[q] - S.xy[j].y) <= 0.f;
      j_eq -= dys <= 0.f;
    }
    const int o = S.idx[sq[q]];
    S.out_r[o] = r[q];
    S.out_c[o] = static_cast<uint16_t>(cnt[q]);
    S.out_c[S.P + o] = static_cast<uint16_t>(x_lt);
    S.out_c[2 * S.P + o] = static_cast<uint16_t>(y_lt[q]);
    S.out_c[3 * S.P + o] = static_cast<uint16_t>(x_eq);
    S.out_c[4 * S.P + o] = static_cast<uint16_t>(ALL ? y_eq[q] : 0.f);
    S.out_c[5 * S.P + o] = static_cast<uint16_t>(j_eq);
  }
}

// One warp per sample; no block-wide barrier anywhere.
template <int W, int R, bool JOINT, bool ALL>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
radius_counts_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const unsigned char* __restrict__ mask, int B, int P,
                     int NP, int k, int kb, int kk, float* __restrict__ r_out,
                     int* __restrict__ cnt_out, int* __restrict__ counts_out,
                     size_t plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(P, NP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const size_t row0 = static_cast<size_t>(b) * P;
  unsigned char* base = smem + warp * L.total;
  float2* xy = reinterpret_cast<float2*>(base + L.xy);
  uint16_t* idx = reinterpret_cast<uint16_t*>(base + L.idx);
  uint64_t* key = reinterpret_cast<uint64_t*>(base + L.key);
  float2* sxy = reinterpret_cast<float2*>(base + L.key);  // over key, below
  uint16_t* sidx = reinterpret_cast<uint16_t*>(base + L.sidx);
  uint32_t* flags = reinterpret_cast<uint32_t*>(base + L.flags);
  float* out_r = reinterpret_cast<float*>(base + L.out_r);
  uint16_t* out_c = reinterpret_cast<uint16_t*>(base + L.out_c);
  uint32_t* valid = reinterpret_cast<uint32_t*>(base + L.valid);
  const uint32_t below = (1u << lane) - 1u;

  // Stage: the valid columns, compacted in order, and a bit per column.
  int n = 0, nan_x = 0;
  for (int c0 = 0; c0 < P; c0 += 32 * kPrefetch) {
    float xv[kPrefetch], yv[kPrefetch];
    bool mv[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int j = c0 + 32 * u + lane;
      const bool in = j < P;
      mv[u] = in && mask[row0 + j];
      xv[u] = in ? x[row0 + j] : 0.f;
      yv[u] = in ? y[row0 + j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int j = c0 + 32 * u + lane;
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, mv[u]);
      if (mv[u]) {
        const int p = n + __popc(bal & below);
        xy[p] = make_float2(xv[u], yv[u]);
        idx[p] = static_cast<uint16_t>(j);
      }
      if (lane == 0 && j < P) valid[j >> 5] = bal;
      n += __popc(bal);
      nan_x += __popc(__ballot_sync(0xFFFFFFFFu, mv[u] && xv[u] != xv[u]));
    }
  }
  __syncwarp();

  // Sort the columns by x (by value: -0 and +0 equal, NaN last).
  int N = 32;
  while (N < n) N <<= 1;
  if (n == 0) {
  } else if (N == 32) {
    sort_keys<1>(xy, key, n, lane);
  } else if (N == 64) {
    sort_keys<2>(xy, key, n, lane);
  } else if (N == 128) {
    sort_keys<4>(xy, key, n, lane);
  } else if (N == 256) {
    sort_keys<8>(xy, key, n, lane);
  } else {
    // Larger samples: the same network over shared memory.
    for (int p = lane; p < N; p += 32) {
      key[p] = p < n ? (static_cast<uint64_t>(code_key(xy[p].x)) << 32) |
                           static_cast<uint32_t>(p)
                     : ~0ull;
    }
    __syncwarp();
    for (int size = 2; size <= N; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < (N >> 1); t += 32) {
          const int a = 2 * t - (t & (stride - 1));
          const int c = a + stride;
          const uint64_t ka = key[a], kc = key[c];
          if ((ka > kc) == ((a & size) == 0)) {
            key[a] = kc;
            key[c] = ka;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncwarp();
  if (!JOINT) {
    // Class runs: a run starts where the code key changes, and at every
    // NaN code.
    for (int p = lane; p < 32 * ((n + 31) >> 5); p += 32) {
      bool f = false;
      if (p < n) {
        const uint32_t h = static_cast<uint32_t>(key[p] >> 32);
        f = p == 0 || h == 0xFFFFFFFFu ||
            h != static_cast<uint32_t>(key[p - 1] >> 32);
      }
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, f);
      if (lane == 0) flags[p >> 5] = bal;
    }
    __syncwarp();
  }
  // The sorted copies: sxy[p] over key[p], which only this lane reads.
  for (int p = lane; p < n; p += 32) {
    const uint32_t src = static_cast<uint32_t>(key[p]);
    const float2 v = xy[src];
    sidx[p] = idx[src];
    sxy[p] = v;
  }
  __syncwarp();

  const Sample S{sxy, sidx, flags, out_r, out_c, P, n, n - nan_x};
  // Groups of 32 * R rows while more than 96 remain, then of 64 and of 32,
  // so that at most 31 row slots of the sample go unused.
  int s0 = 0;
  for (; n - s0 > 96; s0 += 32 * R) sweep_rows<W, R, JOINT, ALL>(S, s0, lane, k, kb, kk);
  for (; n - s0 > 32; s0 += 64) sweep_rows<W, 2, JOINT, ALL>(S, s0, lane, k, kb, kk);
  if (s0 < n) sweep_rows<W, 1, JOINT, ALL>(S, s0, lane, k, kb, kk);

  // The sample's outputs, coalesced; an invalid row's are +inf and 0.
  __syncwarp();
  for (int j = lane; j < P; j += 32) {
    const size_t o = row0 + j;
    const bool v = (valid[j >> 5] >> lane) & 1u;
    r_out[o] = v ? out_r[j] : INFINITY;
    cnt_out[o] = v ? out_c[j] : 0;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      counts_out[c * plane + o] = v ? out_c[(c + 1) * P + j] : 0;
  }
}

template <int W, int R, bool JOINT, bool ALL>
int launch(const float* x, const float* y, const unsigned char* mask, int B,
           int P, int k, int kb, int kk, float* r, int* cnt, int* counts,
           cudaStream_t stream) {
  int NP = 32;
  while (NP < P) NP <<= 1;
  const size_t per_warp = layout(P, NP).total;
  // As many samples a block as fit 48 KB (no opt-in needed), 8 at most:
  // 7 at P = 256, 3 at P = 512, 1 at P = 1024.
  const size_t fit = kBlockBytes / per_warp;
  const int warps = fit < 1 ? 1 : fit > kMaxWarps ? kMaxWarps : static_cast<int>(fit);
  const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
  radius_counts_kernel<W, R, JOINT, ALL>
      <<<grid, 32 * warps, per_warp * warps, stream>>>(
          x, y, mask, B, P, NP, k, kb, kk, r, cnt, counts,
          static_cast<size_t>(B) * static_cast<size_t>(P));
  return static_cast<int>(cudaGetLastError());
}

template <bool JOINT, bool ALL>
int dispatch(int need, const float* x, const float* y,
             const unsigned char* mask, int B, int P, int k, int kb, int kk,
             float* r, int* cnt, int* counts, cudaStream_t stream) {
  if (need <= 3)
    return launch<3, 4, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 8)
    return launch<8, 2, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= kMaxW)
    return launch<16, 1, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace staged

// ---------------------------------------------------------------------------
// The tiled body
// ---------------------------------------------------------------------------
namespace tiled {

constexpr int kRows = 128;      // threads (rows) per block
constexpr int kColTile = 1024;  // columns staged in shared memory per step

__device__ __forceinline__ void stage(const float* __restrict__ xs,
                                      const float* __restrict__ ys,
                                      const unsigned char* __restrict__ ms,
                                      int c0, int n, float* sx, float* sy,
                                      unsigned char* sm) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = xs[c0 + j];
    sy[j] = ys[c0 + j];
    sm[j] = ms[c0 + j];
  }
}

template <int W, bool JOINT, bool ALL>
__global__ void __launch_bounds__(kRows)
radius_counts_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const unsigned char* __restrict__ mask, int P, int k,
                     int kb, int kk, float* __restrict__ r_out,
                     int* __restrict__ cnt_out, int* __restrict__ counts_out,
                     size_t plane) {
  extern __shared__ unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + kColTile;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sy + kColTile);

  const size_t base = static_cast<size_t>(blockIdx.x) * P;
  const float* xs = x + base;
  const float* ys = y + base;
  const unsigned char* ms = mask + base;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const bool row = i < P;
  const float xi = row ? xs[i] : 0.f;
  const float yi = row ? ys[i] : 0.f;
  const bool mi = row && ms[i] != 0;

  float buf[W];
#pragma unroll
  for (int s = 0; s < W; ++s) buf[s] = INFINITY;
  int cnt = 0;

  // Sweep 1: the W smallest selected distances, duplicates counted.
  for (int c0 = 0; c0 < P; c0 += kColTile) {
    const int n = min(kColTile, P - c0);
    __syncthreads();
    stage(xs, ys, ms, c0, n, sx, sy, sm);
    __syncthreads();
    if (mi) {
      for (int jj = 0; jj < n; ++jj) {
        const int j = c0 + jj;
        if (!sm[jj] || j == i) continue;
        const float dy = fabsf(yi - sy[jj]);
        float d;
        if (JOINT) {
          d = max_nan(fabsf(xi - sx[jj]), dy);
        } else {
          if (!(xi == sx[jj])) continue;
          ++cnt;
          d = dy;
        }
        if (d < buf[W - 1]) {
          float v = d;
#pragma unroll
          for (int s = 0; s < W; ++s) {
            const float lo = fminf(buf[s], v);
            v = fmaxf(buf[s], v);
            buf[s] = lo;
          }
        }
      }
    }
  }

  int t;
  if (JOINT) {
    t = k - 1;
  } else {
    const int n_x = cnt + (mi ? 1 : 0);
    t = min(min(kk, n_x - 1) - 1, kb - 1);
    t = max(t, 0);
  }
  float r = INFINITY;
#pragma unroll
  for (int s = 0; s < W; ++s) {
    if (s == t) r = buf[s];
  }

  // Sweep 2: ball and tie counts at the radius.
  int x_lt = 0, y_lt = 0, x_eq = 0, y_eq = 0, j_eq = 0;
  for (int c0 = 0; c0 < P; c0 += kColTile) {
    const int n = min(kColTile, P - c0);
    __syncthreads();
    stage(xs, ys, ms, c0, n, sx, sy, sm);
    __syncthreads();
    if (mi) {
      for (int jj = 0; jj < n; ++jj) {
        const int j = c0 + jj;
        if (!sm[jj] || j == i) continue;
        const float dy = fabsf(yi - sy[jj]);
        y_lt += dy < r;
        if (ALL) {
          const float dx = fabsf(xi - sx[jj]);
          x_lt += dx < r;
          x_eq += dx <= 0.f;
          y_eq += dy <= 0.f;
          j_eq += (dx <= 0.f) && (dy <= 0.f);
        }
      }
    }
  }

  if (row) {
    const size_t o = base + i;
    r_out[o] = r;
    cnt_out[o] = cnt;
    counts_out[o] = x_lt;
    counts_out[plane + o] = y_lt;
    counts_out[2 * plane + o] = x_eq;
    counts_out[3 * plane + o] = y_eq;
    counts_out[4 * plane + o] = j_eq;
  }
}

template <int W, bool JOINT, bool ALL>
int launch(const float* x, const float* y, const unsigned char* mask, int B,
           int P, int k, int kb, int kk, float* r, int* cnt, int* counts,
           cudaStream_t stream) {
  const dim3 grid(B, (P + kRows - 1) / kRows);
  const size_t shmem = kColTile * (2 * sizeof(float) + 1);
  radius_counts_kernel<W, JOINT, ALL><<<grid, kRows, shmem, stream>>>(
      x, y, mask, P, k, kb, kk, r, cnt, counts,
      static_cast<size_t>(B) * static_cast<size_t>(P));
  return static_cast<int>(cudaGetLastError());
}

template <bool JOINT, bool ALL>
int dispatch(int need, const float* x, const float* y,
             const unsigned char* mask, int B, int P, int k, int kb, int kk,
             float* r, int* cnt, int* counts, cudaStream_t stream) {
  if (need <= 4)
    return launch<4, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 8)
    return launch<8, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 16)
    return launch<16, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 32)
    return launch<32, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 64)
    return launch<64, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  if (need <= 128)
    return launch<128, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tiled

using DispatchFn = int (*)(int, const float*, const float*,
                           const unsigned char*, int, int, int, int, int,
                           float*, int*, int*, cudaStream_t);

int run(const DispatchFn (&fns)[2][2], const float* x, const float* y,
        const unsigned char* mask, int B, int P, int k, int kb, int kk,
        int joint, int all, float* r, int* cnt, int* counts, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const int need = joint ? k : kb;
  return fns[joint ? 1 : 0][all ? 1 : 0](need, x, y, mask, B, P, k, kb, kk, r,
                                         cnt, counts,
                                         static_cast<cudaStream_t>(stream));
}

constexpr DispatchFn kStaged[2][2] = {
    {staged::dispatch<false, false>, staged::dispatch<false, true>},
    {staged::dispatch<true, false>, staged::dispatch<true, true>}};
constexpr DispatchFn kTiled[2][2] = {
    {tiled::dispatch<false, false>, tiled::dispatch<false, true>},
    {tiled::dispatch<true, false>, tiled::dispatch<true, true>}};

}  // namespace

// Plain C entries for ctypes, one per body, with one signature.  x, y:
// float32 (B, P); mask: bool (B, P); r: float32 (B, P); cnt: int32 (B, P);
// counts: int32 (5, B, P).  joint selects the mode, all the count set.
// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for parameters outside the body's range; a
// refused launch never runs, so the caller must check it.
extern "C" int radius_counts_launch(const float* x, const float* y,
                                    const unsigned char* mask, int B, int P,
                                    int k, int kb, int kk, int joint, int all,
                                    float* r, int* cnt, int* counts,
                                    void* stream) {
  if (P > staged::kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  return run(kStaged, x, y, mask, B, P, k, kb, kk, joint, all, r, cnt, counts,
             stream);
}

extern "C" int radius_counts_tiled_launch(const float* x, const float* y,
                                          const unsigned char* mask, int B,
                                          int P, int k, int kb, int kk,
                                          int joint, int all, float* r,
                                          int* cnt, int* counts,
                                          void* stream) {
  return run(kTiled, x, y, mask, B, P, k, kb, kk, joint, all, r, cnt, counts,
             stream);
}
