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
// NaN: a NaN distance is never selected (the min/max networks drop it,
// the tiled body's batches make it +inf and its event walk never
// completes it, and the joint distance propagates NaN from either
// marginal, as jnp.maximum does), and every count condition is false
// for NaN (the tie count tests dx <= 0 && dy <= 0, which equals
// max(dx, dy) <= 0 without fmaxf's NaN dropping).  ref.py follows the
// same rule.  Parity with the JAX package is claimed for finite inputs.
//
// Bound: ALU work; the bytes, B*P*(9 in + 28 out), are small beside it.
// The direct algorithm (the first port's design) pays, per valid pair (i,
// j != i), a distance, the compare against the running order statistic and
// the count compares and adds: 16 operations in joint mode with all five
// counts (chip_smoke.py's RC_OPS).  Once a sample is sorted by x, the
// function needs per pair only the y counts (4 to 6 operations); the rest
// is the sort, the band or class run that selection visits, and binary
// searches a row (RC_NEED_*).  Sorted by y as well, the y counts are
// binary searches too: the need is two sorts, the band or run and the
// searches (RC_ROUTE_*); chip_smoke.py reports the lesser of the two.
//
// Two bodies, picked by kernel.py::takes_staged (a plain Python rule):
//
// radius_counts_launch, the staged body: P <= 1024 and a buffer of at
// most 16 lanes (k, or kb in class mode, <= 16); the main path's P = 256,
// k = 3.  One warp per sample, no block-wide barrier; a block holds as
// many samples as fit 48 KB of shared memory (7 at P = 256), and at most
// the launch's rung of samples (1, 2, 4 or 8; 8 unless the autotuner
// picks another: one warp a sample, so no rung changes an output bit).
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
// radius_counts_tiled_launch, the tiled body: every other call (P > 1024,
// or a buffer wider than 16 lanes up to K_MAX = 128); one Python call, one
// to four CUDA launches.  It sorts each sample twice and never sweeps all
// pairs:
//   * The orders.  The valid columns, by value keys (code_key: -0 folded
//     onto +0, NaN last): the y order by (code_key(y), column) and the x
//     order by (code_key(x), code_key(y), column).  Both keys are
//     distinct, so each order is one permutation however it is computed.
//     P <= 256: one warp a sample, both sorts in registers
//     (staged::warp_sort), the x order keyed by (code_key(x), position in
//     the y order), and the rows in the same launch; longer samples, in
//     device scratch: launch 1 sorts chunks of 1024 columns by (key,
//     column) pairs in shared memory; past 1024, launch 2 counts for every
//     entry the pairs below it in each other chunk (one block a chunk
//     pair, the other chunk in shared memory, integer atomic adds, so the
//     sum is order-free); launch 3 writes each entry to its place; the
//     rows (launch 4) read both orders, staged in shared memory (opted in
//     past 48 KB) in joint mode when they fit 200 KB.
//   * Joint selection, k <= 64: the staged body's band walk along the x
//     order with a W-lane register buffer (W = 4, 8, 16, 32, 64 >= k): exact
//     because |fl(xi - xj)| does not decrease along either side and the
//     joint distance is at least |dx|, so once |dx| >= b[W-1] nothing
//     further out enters the W smallest.  Up to 8 lanes a candidate at a
//     time (the min/max network); 16, 32 and 64 lanes in batches of G = 8,
//     16, 32 from each side in turn: the batch (a NaN distance made +inf, never
//     selected either) sorted by a register network, then min(b[W-G+u],
//     c[G-1-u]) beside b's first W - G is the W smallest of both as a
//     bitonic sequence, put in order by log2(W) stages.  A batch may reach
//     past the band; candidates there leave the W smallest as they are.
//     The buffer stays in registers (ptxas: no spill, 64-72 registers a
//     thread at W = 32, 121-125 at W = 64; a 128-lane buffer with a batch
//     of 32 took 192 in the warp kernel and spilled in the block kernels,
//     and was slower than the walk below; the first port's W = 128 buffer,
//     inserted one candidate at a time, took 158 without a spill).
//   * Joint selection, k > 64: no buffer.  Four streams walk outward from
//     the row, left and right along the x order (values |dx|) and along the
//     y order (values |dy|), each step taking the stream whose next value
//     is least.  An entry meets its two values in increasing order and
//     completes at the larger, max(|dx|, |dy|) (in the x stream when |dy|
//     <= |dx|, else in the y stream), so completions come in increasing
//     joint distance and the k-th is the radius; one with a NaN distance
//     never completes.
//   * Class selection: the row's run of equal codes is sorted by y, so
//     two streams outward from the row, merged for t + 1 steps, give the
//     t-th smallest |dy| for any kb.
//   * A row with a non-finite x or y has radius +inf in joint mode (every
//     distance it has is +inf or NaN); in class mode a non-finite y does.
//   * The counts are ranges of one order, found by binary search: over
//     ascending values fl(vi - vj) does not increase, and a NaN vj (sorted
//     last) meets both predicates !(f > t) and !(f >= t), so each is
//     monotone; |dy| < r and dy == 0 over the y order, |dx| < r and dx ==
//     0 over the x order (as the staged body), and j_eq inside the x-tie
//     range, which is one value and so sorted by y.  A non-finite xi (or
//     yi) meets no x (or y) condition.  The self pair is taken out.
//   With the same expressions as ref.py (fabsf(xi - xj), the joint
//   distance one max.NaN.f32) every split of rows across threads, warps
//   and blocks gives the same bits: selection is order-free, the counts
//   are integer sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sorted_orders.cuh"

namespace {

// ---------------------------------------------------------------------------
// The staged body
// ---------------------------------------------------------------------------
namespace staged {

constexpr int kMaxWarps = 8;          // samples (warps) per block, at most
// The rungs of a launch's cap on samples a block (kernel.py: STAGED_WARPS).
constexpr int kWarpRungs[] = {1, 2, 4, 8};
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

// code_key, insert and warp_sort are the sorted route's (sorted_orders.cuh).
using orders::code_key;
using orders::insert;
using orders::warp_sort;

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
           int max_warps, cudaStream_t stream) {
  int NP = 32;
  while (NP < P) NP <<= 1;
  const size_t per_warp = layout(P, NP).total;
  // As many samples a block as fit 48 KB (no opt-in needed), max_warps at
  // most: at the default 8, 7 at P = 256, 3 at P = 512, 1 at P = 1024.
  const size_t fit = kBlockBytes / per_warp;
  const int warps = fit < 1 ? 1 : fit > static_cast<size_t>(max_warps)
                                      ? max_warps : static_cast<int>(fit);
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
             float* r, int* cnt, int* counts, int rung, cudaStream_t stream) {
  if (need <= 3)
    return launch<3, 4, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, rung, stream);
  if (need <= 8)
    return launch<8, 2, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, rung, stream);
  if (need <= kMaxW)
    return launch<16, 1, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, rung, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace staged

// ---------------------------------------------------------------------------
// The tiled body
// ---------------------------------------------------------------------------
namespace tiled {

using orders::kChunk;
using orders::kWarpE;
using orders::kWarpP;
using orders::Scratch;

constexpr int kRowThreads = 64;     // a row block's threads, at least
constexpr int kRowMaxThreads = 256;  // and at most (a 64-lane buffer needs
                                     // more than 64 registers a thread)
constexpr size_t kStageBytes = 200 << 10;  // a staged sample's orders, at most

// ---- One row's statistics from its sample's two sorted orders ----------

// Joint selection along the x band with W >= k lanes (orders::band_walk):
// the (t + 1)-th smallest joint distance.
template <int W, bool RUNS>
__device__ __forceinline__ float band_radius(const float2* X, int nnx, int s,
                                             float xi, float yi, int t) {
  float b[W];
  orders::band_walk<W, RUNS>(X, nnx, s, xi, yi, b);
  return staged::lane_of<W>(b, t);
}

// Joint selection for any t, with no buffer (orders::event_walk): the
// (t + 1)-th completion is the radius, +inf if the streams run out first.
__device__ __forceinline__ float event_radius(const float2* X, const float2* Yo,
                                              int nnx, int nny, int s, int q,
                                              float xi, float yi, int t) {
  float r = INFINITY;
  orders::event_walk(X, Yo, nnx, nny, s, q, xi, yi, t + 1,
                     [&](int g, float d) { if (g == t) r = d; });
  return r;
}

// Class selection for any t (orders::class_walk): the t-th smallest |dy|
// over the row's run [lo, hi) but its own position s.
__device__ __forceinline__ float class_radius(const float2* X, int lo, int hi,
                                              int s, float yi, int t) {
  float r = INFINITY;
  orders::class_walk(X, lo, hi, s, yi, t + 1,
                     [&](int g, float d) { if (g == t) r = d; });
  return r;
}

// One row's outputs: the radius, cnt, and x_lt, y_lt, x_eq, y_eq, j_eq.
struct Stats {
  float r = INFINITY;  // also an invalid row's, with zero counts
  int cnt = 0, c[5] = {0, 0, 0, 0, 0};
};

// The outputs (plane: B * P, the counts' plane stride).
struct Out {
  float* r;
  int* cnt;
  int* counts;
  size_t plane;
  __device__ __forceinline__ void put(size_t o, const Stats& v) const {
    r[o] = v.r;
    cnt[o] = v.cnt;
#pragma unroll
    for (int u = 0; u < 5; ++u) counts[u * plane + o] = v.c[u];
  }
};

// The valid row at x position s and y position q of a sample whose x
// order X holds nnx entries with a number for x, and whose y order Yo
// nny with a number for y (NaN last in each).  W: the joint band
// buffer's lanes, 0 for the buffer-free event walk.  RUNS: the band walk
// leaves a spent x-tie run (orders::band_walk; the row kernel's, whose
// long samples have long runs).
template <int W, bool JOINT, bool ALL, bool RUNS>
__device__ __forceinline__ Stats row(const float2* X, const float2* Yo, int nnx,
                                     int nny, int s, int q, int k, int kb,
                                     int kk) {
  const float2 me = X[s];
  const float xi = me.x, yi = me.y;
  const bool fx = fabsf(xi) < INFINITY, fy = fabsf(yi) < INFINITY;
  Stats v;  // r = +inf: also every non-finite row's, all its d inf or NaN
  if (JOINT) {
    if (fx && fy) {
      if constexpr (W > 0) v.r = band_radius<W, RUNS>(X, nnx, s, xi, yi, k - 1);
      else v.r = event_radius(X, Yo, nnx, nny, s, q, xi, yi, k - 1);
    }
  } else if (xi == xi) {
    int run, end;
    orders::class_run(X, nnx, s, xi, run, end);
    v.cnt = end - run - 1;
    const int t = max(min(min(kk, v.cnt) - 1, kb - 1), 0);
    if (fy) v.r = class_radius(X, run, end, s, yi, t);
  }
  orders::count_ranges<ALL>(X, Yo, nnx, nny, xi, yi, v.r, v.c);
  return v;
}

// ---- P <= kWarpP: one warp a sample, the sorts in registers ------------

constexpr int kWarpSamples = 4;   // samples (warps) a block

// One sample's shared memory in the warp kernel (7.5 KB): the staged
// columns and the y order's columns are dead once both orders are built,
// and the outputs take their place (counts of at most 255 others fit a
// byte).
struct WarpSample {
  float2 xo[kWarpP];       // the x order
  float2 yo[kWarpP];       // the y order
  union {
    struct {
      float2 v[kWarpP];        // (x, y) by column
      uint16_t ycol[kWarpP];   // the y order's columns
    } in;
    struct {
      float r[kWarpP];         // the outputs by column
      uint8_t c[6][kWarpP];    // cnt and the five counts
    } out;
  };
  uint16_t xcol[kWarpP];   // the x order's columns
  uint16_t pos_y[kWarpP];  // a column's y position
};

// The sample's two orders (orders::warp_orders); then its rows in x order,
// lane l taking x positions l, l + 32, ..., so that a warp's rows are
// neighbours in x; their outputs leave through shared memory, coalesced.
template <int W, bool JOINT, bool ALL>
__global__ void __launch_bounds__(32 * kWarpSamples)
radius_counts_warp(const float* __restrict__ x, const float* __restrict__ y,
                   const unsigned char* __restrict__ mask, int B, int P,
                   int k, int kb, int kk, Out out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpSamples + warp;
  if (b >= B) return;  // no block-wide barrier below
  WarpSample& S = reinterpret_cast<WarpSample*>(smem)[warp];
  const size_t row0 = static_cast<size_t>(b) * P;

  int nan_x, nan_y;
  const int n = orders::warp_orders<true, true>(
      x, y, mask, row0, P, lane,
      {S.xo, S.yo, S.in.v, S.in.ycol, S.xcol, S.pos_y}, nan_x, nan_y);
  for (int s = lane; s < n; s += 32) {
    const int e = S.xcol[s];
    const Stats v = row<W, JOINT, ALL, false>(S.xo, S.yo, n - nan_x, n - nan_y, s,
                                       S.pos_y[e], k, kb, kk);
    S.out.r[e] = v.r;
    S.out.c[0][e] = static_cast<uint8_t>(v.cnt);
#pragma unroll
    for (int u = 0; u < 5; ++u) S.out.c[u + 1][e] = static_cast<uint8_t>(v.c[u]);
  }
  __syncwarp();
  for (int e = lane; e < P; e += 32) {
    const size_t o = row0 + e;
    Stats v;
    if (mask[o]) {
      v.r = S.out.r[e];
      v.cnt = S.out.c[0][e];
#pragma unroll
      for (int u = 0; u < 5; ++u) v.c[u] = S.out.c[u + 1][e];
    }
    out.put(o, v);
  }
}

// ---- P > kWarpP: the orders in scratch (orders::launch_orders), then the
// rows ---------------------------------------------------------------------

// Launch 4: one thread a column.  With stage set the block first copies
// its sample's two orders into shared memory (16 P bytes); otherwise
// they are read through L1 and L2.
template <int W, bool JOINT, bool ALL>
__global__ void __launch_bounds__(kRowMaxThreads)
radius_counts_rows(const unsigned char* __restrict__ mask, int P, int k,
                   int kb, int kk, int stage, Out out, Scratch S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int b = blockIdx.x / per;
  const int j = (blockIdx.x % per) * blockDim.x + threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * P, o = row0 + j;
  int n, nan_x, nan_y;
  orders::sample_stats(S, b, P, n, nan_x, nan_y);
  const float2* X = S.xo + row0;
  const float2* Yo = S.yo + row0;
  if (stage) {
    float2* sx = reinterpret_cast<float2*>(smem);
    float2* sy = sx + P;
    orders::stage_orders(X, Yo, n, sx, sy);
    X = sx;
    Yo = sy;
  }
  if (j >= P) return;
  out.put(o, mask[o] ? row<W, JOINT, ALL, true>(X, Yo, n - nan_x, n - nan_y,
                                          S.pos_x[o], S.pos_y[o], k, kb, kk)
                     : Stats());
}

template <int W, bool JOINT, bool ALL>
int launch(const float* x, const float* y, const unsigned char* mask, int B,
           int P, int k, int kb, int kk, const Out& out, void* scratch,
           cudaStream_t stream) {
  if (P <= kWarpP) {
    const unsigned grid = static_cast<unsigned>((B + kWarpSamples - 1) / kWarpSamples);
    radius_counts_warp<W, JOINT, ALL>
        <<<grid, 32 * kWarpSamples, kWarpSamples * sizeof(WarpSample), stream>>>(
            x, y, mask, B, P, k, kb, kk, out);
    return static_cast<int>(cudaGetLastError());
  }
  Scratch S;
  orders::carve(static_cast<unsigned char*>(scratch), B, P, &S);
  int err = orders::launch_orders<true, true>(x, y, mask, B, P, S, stream);
  if (err) return err;
  // In joint mode a sample that fits a block's shared memory is staged
  // there (the band walks dwell on it); the rows are then spread so that
  // about one block an SM covers the batch.
  const size_t bytes = 16 * static_cast<size_t>(P);
  const int stage = JOINT && bytes <= kStageBytes;
  int threads = kRowThreads;
  if (stage) {
    static bool opted = false;  // once, so never while a graph is captured
    if (!opted) {
      err = static_cast<int>(cudaFuncSetAttribute(
          radius_counts_rows<W, JOINT, ALL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kStageBytes)));
      if (err) return err;
      opted = true;
    }
    threads = orders::spread_threads(B, P, kRowThreads, kRowMaxThreads);
  }
  const unsigned rows = (P + threads - 1) / threads;
  radius_counts_rows<W, JOINT, ALL>
      <<<static_cast<unsigned>(B) * rows, threads, stage ? bytes : 0, stream>>>(
          mask, P, k, kb, kk, stage, out, S);
  return static_cast<int>(cudaGetLastError());
}

// The joint band buffer's width for need = k: 4, 8, 16, 32 or 64 lanes,
// and past 64 the buffer-free walk (0); class mode needs no buffer.
template <bool JOINT, bool ALL>
int dispatch(int need, const float* x, const float* y,
             const unsigned char* mask, int B, int P, int k, int kb, int kk,
             float* r, int* cnt, int* counts, void* scratch,
             cudaStream_t stream) {
  const Out out{r, cnt, counts, static_cast<size_t>(B) * static_cast<size_t>(P)};
  if constexpr (JOINT) {
    if (need <= 4)
      return launch<4, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
    if (need <= 8)
      return launch<8, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
    if (need <= 16)
      return launch<16, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
    if (need <= 32)
      return launch<32, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
    if (need <= 64)
      return launch<64, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
  }
  return launch<0, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, out, scratch, stream);
}

}  // namespace tiled

// A body's dispatch on (mode, count set): (need, x, y, mask, B, P, k, kb,
// kk, r, cnt, counts, the staged body's cap on samples a block or the
// tiled body's scratch, stream).
using StagedFn = int (*)(int, const float*, const float*,
                         const unsigned char*, int, int, int, int, int,
                         float*, int*, int*, int, cudaStream_t);
using TiledFn = int (*)(int, const float*, const float*,
                        const unsigned char*, int, int, int, int, int,
                        float*, int*, int*, void*, cudaStream_t);

constexpr StagedFn kStaged[2][2] = {
    {staged::dispatch<false, false>, staged::dispatch<false, true>},
    {staged::dispatch<true, false>, staged::dispatch<true, true>}};
constexpr TiledFn kTiled[2][2] = {
    {tiled::dispatch<false, false>, tiled::dispatch<false, true>},
    {tiled::dispatch<true, false>, tiled::dispatch<true, true>}};

}  // namespace

// Plain C entries for ctypes, one per body.  x, y: float32 (B, P); mask:
// bool (B, P); r: float32 (B, P); cnt: int32 (B, P); counts: int32
// (5, B, P).  joint selects the mode, all the count set.  The staged
// entry takes one more int, max_warps, its cap on samples a block: off
// staged::kWarpRungs the launch is refused (no clamp).  The tiled entry
// takes a device scratch buffer of radius_counts_tiled_scratch(B, P)
// bytes.  Each returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for parameters outside the body's
// range; a refused launch never runs, so the caller must check it.
extern "C" int radius_counts_launch(const float* x, const float* y,
                                    const unsigned char* mask, int B, int P,
                                    int k, int kb, int kk, int joint, int all,
                                    float* r, int* cnt, int* counts,
                                    int max_warps, void* stream) {
  bool on_ladder = false;
  for (int w : staged::kWarpRungs) on_ladder |= w == max_warps;
  if (P > staged::kMaxP || !on_ladder)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || P <= 0) return 0;
  return kStaged[joint ? 1 : 0][all ? 1 : 0](
      joint ? k : kb, x, y, mask, B, P, k, kb, kk, r, cnt, counts, max_warps,
      static_cast<cudaStream_t>(stream));
}

extern "C" long long radius_counts_tiled_scratch(int B, int P) {
  if (B <= 0 || P <= orders::kWarpP) return 0;
  return static_cast<long long>(orders::carve(nullptr, B, P, nullptr));
}

extern "C" int radius_counts_tiled_launch(const float* x, const float* y,
                                          const unsigned char* mask, int B,
                                          int P, int k, int kb, int kk,
                                          int joint, int all, float* r,
                                          int* cnt, int* counts,
                                          void* scratch, void* stream) {
  if (k < 1 || kb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || P <= 0) return 0;
  return kTiled[joint ? 1 : 0][all ? 1 : 0](
      joint ? k : kb, x, y, mask, B, P, k, kb, kk, r, cnt, counts, scratch,
      static_cast<cudaStream_t>(stream));
}
