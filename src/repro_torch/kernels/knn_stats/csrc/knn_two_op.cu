// The two-op kNN API for a batch of padded samples (sm_90a): the k smallest
// selected distances per row, and the ball/tie counts at a given radius.
//
// Replaces: repro/kernels/knn_stats/kernel.py::knn_smallest_padded (body
// _knn_kernel with _merge_k_smallest and _tile_distances) and
// ::ball_counts_padded (bodies _counts_kernel and _counts_kernel_y), the
// Pallas TPU kernels behind knn_smallest, ball_counts and knn_with_counts.
// knn_with_counts composes them, and radius_counts.cu's fused kernel is
// bit-equal to that composition.
//
// What they compute, per sample b and row i of a padded sample (x, y, mask):
//   knn_smallest: the kb smallest selected distances, ascending, duplicates
//     kept, +inf beyond the selectable ones.  Joint mode selects
//     max(|dx|, |dy|) over valid j != i; class mode selects |dy| over valid
//     j != i with x_j == x_i (exact float equality of the class codes) and
//     also returns that same-class count (0 in joint mode).
//   ball_counts: at a per-row radius r, over valid j != i: |dx| < r,
//     |dy| < r, dx == 0, dy == 0, dx == dy == 0.  The y variant computes
//     |dy| < r only, writes zeros to the other four, and never reads x.
//   An invalid row gets +inf distances and zero counts.  The TPU kernels'
//   (P, 128) lane-packed outputs were a VMEM tiling artifact; here knn is
//   (B, P, kb) and each count its own (B, P) plane.
//
// NaN: as in radius_counts.cu and ref.py, a NaN distance is never selected
// (it counts as +inf) and fails every count condition.
//
// Bound: ALU work.  The direct algorithm (one row a thread over every
// valid column) pays, per valid pair (i, j != i), a distance evaluation
// and the compare against the running W-th smallest (knn_smallest), or the
// distance halves and the count compares and adds (ball_counts):
// chip_smoke.py's KNN_OPS and BC_OPS.  Once
// a sample is sorted, knn_smallest needs per row only the band of columns
// its selection can reach (joint) or kb steps of its class run (class), and
// ball_counts needs no pair at all: every count is a range of a sorted
// order.  What is left is the sort, those steps and a few binary searches a
// row (chip_smoke.py's KNN_NEED_* and BC_NEED_*, the bound it reports).  The
// bytes are B*P*(9 + 4*kb + 4) and B*P*(13 + 20) (9 + 20 for y).
//
// Two bodies per op, picked by kernel.py::takes_staged_two_op (a plain
// Python rule):
//
// knn_smallest_launch / ball_counts_launch, the staged bodies: P <= 1024
// (and kb <= 16 for knn_smallest); the main path's P = 256, kb = 3.  One
// warp per sample, no block-wide barrier; a block holds as many samples as
// fit 48 KB of shared memory (6 at P = 256 for knn_smallest, 8 for
// ball_counts), one above that, and at most the launch's rung of samples
// (1, 2, 4 or 8; 8 unless the autotuner picks another: one warp a sample,
// so no rung changes an output bit).
//   * Staging compacts the valid columns, in column order, with warp
//     ballots (4 chunks of 32 columns loaded at once), straight into sort
//     keys: nothing later visits an invalid column or tests the mask.
//   * Keys are values: code_key maps a float to an unsigned order key, -0
//     folded onto +0, every NaN the largest.  knn_smallest and ball_counts
//     (which == all) sort the 64-bit word (key of x, key of y): the order
//     by x, ties in x by y (the order by (code, y) in class mode).
//     ball_counts also sorts the 32-bit key of y alone.  Up to 256 columns
//     a warp sorts in registers (a bitonic network, 8 words a lane, lanes
//     exchanged by shuffles); above, the same network in shared memory.
//     The sorted keys are decoded back to values (key_value), exact but
//     for -0 -> +0, which changes no |difference| and no comparison.
//   * knn_smallest takes rows in sorted order, so neighbouring lanes read
//     neighbouring columns.  Joint mode walks outward from the row's
//     position, right then left, while |dx| < the current W-th smallest
//     (W = 3, 8 or 16, the least >= kb; the branch-free buffer update and
//     the stop of radius_counts.cu's staged body; 4 columns loaded at a
//     time): |fl(xi - x_j)| does not decrease along either side and
//     d >= |dx|.  Class mode finds the
//     row's run of equal codes by binary search (a NaN code is a run of
//     none; cnt is the run's length less one) and merges the run outward
//     from the row: along either side |fl(yi - y_j)| does not decrease
//     (a NaN distance counts as +inf, and past a side's first NaN every
//     distance is +inf or NaN, also in a tie cluster of +-inf around the
//     row), so kb steps of a two-pointer merge give the kb smallest,
//     ascending (once both sides reach +inf, every later step gives +inf).
//     Each row's kb lanes go to shared memory by sorted position.
//     Equal keys are equal values, whose rows have equal outputs, so each
//     column then finds its sorted position by binary search on its key
//     (4 columns a lane in lockstep), and the sample's (P, kb) block leaves
//     in one coalesced pass.
//   * ball_counts takes rows in column order, each from device memory.
//     Over the sorted non-NaN values fl(vi - v_j) does not increase, so
//     for a finite vi, #|dv| < r is the first column where dv <= -r less
//     the first where dv < r, and #dv == 0 the first where dv < 0 less the
//     first where dv <= 0: binary searches on the predicate itself, never
//     on vi +- r, branch-free over the sorted values padded with +inf
//     (vi - inf = -inf keeps every predicate monotone), all of a row's (4
//     on y, 4 on x) in lockstep, so that their loads overlap.  Measured on
//     the card, they are bound by integer issue, not by shared-memory bank
//     conflicts (a skewed layout changed nothing).  The row's own column lies in
//     both ranges (its dv is +0), and is taken out as radius_counts does
//     (|0| < r holds iff r > 0).  dv == 0 <=> v_j == vi holds with gradual
//     underflow only: the build uses no --use_fast_math or -ftz=true.
//     j_eq is the run of the row's own (x, y) key in the order by (x, y),
//     searched within its x-tie range.  A non-finite vi meets no condition
//     (inf - inf is NaN, inf - finite is inf).
//
// knn_smallest_tiled_launch / ball_counts_tiled_launch, the tiled bodies:
// every other call (P > 1024, or kb > 16 for knn_smallest; any P and kb up
// to K_MAX = 128 through the entries).  They read everything off the sorted
// orders that radius_counts.cu's tiled body builds (sorted_orders.cuh), and
// never sweep all pairs.  One Python call, one or more CUDA launches:
//   * The orders (orders::warp_orders, orders::launch_orders).
//     knn_smallest up to P = 256: one warp a sample, both sorts in
//     registers, the rows in the same launch (4 samples a block).  Longer
//     samples, and ball_counts at every P: chunks of 1024 columns sorted
//     in shared memory, merged by rank, placed in device scratch (one
//     chunk is placed by its sort); then one thread a column, blocks
//     spread so that about one block an SM covers the batch, the orders
//     read through L1 and L2.  The scratch is 40 bytes a column; the
//     batch goes through these launches in slices of as many samples as
//     keep it within kScratchCap (1 GiB; one sample at least), so
//     *_tiled_scratch(B, P) gives at most that.  Each body builds only
//     the orders it reads: knn_smallest the x order (the joint band
//     walk's alone by (code_key(x), column) at P <= 256), and the y order
//     for class runs at P <= 256 and for the four-stream walk;
//     ball_counts the y order, and the x order for which == all (with
//     which == y it never reads x: the wrapper passes a null x).
//   * knn_smallest, joint mode, kb <= 64: the band walk along the x order
//     (orders::band_walk) with a W-lane register buffer, W = 4, 8, 16, 32
//     or 64 >= kb (batches of W / 2, at most 32, from 16 lanes up); its
//     first kb lanes, ascending, are the output.  kb > 64: the four-stream
//     walk (orders::event_walk), no buffer: its first kb completions, in
//     order, are the kb lanes; an entry with a NaN distance never
//     completes, and a lane left unfilled is +inf.  A row with a
//     non-finite x or y selects +inf only (every distance it has is +inf
//     or NaN).
//   * knn_smallest, class mode: the row's run of equal codes by binary
//     search in the x order (orders::class_run; a NaN code is a run of
//     none), cnt its length less one; the run is sorted by y, so kb steps
//     of the two-pointer merge outward from the row (orders::class_walk, a
//     NaN |dy| ending its side, as the staged body's class_select counts
//     it +inf) give the kb smallest |dy| ascending, +inf beyond, for any
//     kb.  A row with a non-finite y selects +inf only.
//   * ball_counts: every count a range found by binary search on the
//     predicate itself (orders::count_ranges), the row's own column taken
//     out, as the staged body does: |dy| < r and dy == 0 over the y order,
//     |dx| < r and dx == 0 over the x order, j_eq inside the x-tie range.
//     The radius is the caller's: r <= 0 and NaN give empty ranges, +inf
//     every finite neighbour.
//   * The output.  knn_smallest's (B, P, kb) block is most of its bytes.
//     A row's kb lanes go to a per-warp tile in shared memory (32 rows,
//     stride kb | 1, odd, so the lanes' writes miss each other's banks),
//     and leave coalesced: in the warp kernel (rows in x order, so that a
//     warp's rows are neighbours in x and walk alike) one warp a row; in
//     the row kernel (one thread a column) a warp's 32 rows leave as one
//     contiguous run.  cnt and the five count planes leave by column.
// With the expressions of ref.py every split of rows across threads, warps
// and blocks gives the same bits: selection is order-free, the counts are
// integer sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sorted_orders.cuh"

namespace {

// ---------------------------------------------------------------------------
// The staged bodies
// ---------------------------------------------------------------------------
namespace staged {

constexpr int kMaxWarps = 8;           // samples (warps) per block, at most
// The rungs of a launch's cap on samples a block (kernel.py: STAGED_WARPS).
constexpr int kWarpRungs[] = {1, 2, 4, 8};
constexpr int kBlockBytes = 48 << 10;  // shared memory a block takes (beyond
                                       // it: one sample a block, opted in)
constexpr int kPrefetch = 4;           // 32-column chunks loaded per step
constexpr int kMaxP = 1024;            // kernel.py: TWO_OP_STAGED_MAX_P
constexpr int kMaxKb = 16;             // kernel.py: TWO_OP_STAGED_MAX_KB
constexpr int kGroup = 4;              // columns a lane searches in lockstep
constexpr uint16_t kNone = 0xFFFFu;    // an invalid column's sorted position

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// A float's order as an unsigned key: -0 folded onto +0, every NaN the
// largest key (and never equal to a number's).
__device__ __forceinline__ uint32_t code_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  if (v == 0.f) return 0x80000000u;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The value of a key: exact, but -0 comes back as +0 and NaN as one NaN.
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ uint64_t pair_key(float a, float b) {
  return (static_cast<uint64_t>(code_key(a)) << 32) | code_key(b);
}

// The highest power of two <= n (0 for n = 0): the first step of the
// branch-free binary searches below.
__device__ __forceinline__ int top_step(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// The first position in [lo, hi) of the sorted key whose key is >= v.
template <typename T>
__device__ __forceinline__ int first_ge(const T* key, int lo, int hi, T v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] >= v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// One step of branch-free binary searches in lockstep over the sorted,
// non-NaN values v[0, nn), along which fl(vi - v_j) does not increase
// (rounding is monotone; -0 and +0 give the same difference); v holds +inf
// from nn on, up to twice the search length.  at[k] counts the leading
// values at which predicate k fails: fl(vi - v_j) < r, <= -r and, with EQ,
// <= 0 and < 0.  Run with step from the highest power of two <= nn down to
// 1, at[k] ends at the first value at which predicate k holds, for a finite
// vi: there vi - inf = -inf, so the padding keeps each predicate monotone,
// or the predicate holds nowhere and at[k] ends at nn or past it (clamp to
// nn).  The searches share no dependency, so their loads overlap.
template <bool EQ>
__device__ __forceinline__ void search_step(const float* v, int step,
                                            float vi, float r, int (&at)[4]) {
  const float* w = v + step - 1;
  if (!(vi - w[at[0]] < r)) at[0] += step;
  if (!(vi - w[at[1]] <= -r)) at[1] += step;
  if (EQ) {
    if (!(vi - w[at[2]] <= 0.f)) at[2] += step;
    if (!(vi - w[at[3]] < 0.f)) at[3] += step;
  }
}

// Staging sources: a column's sort key, and where it is stored.  PairKeys:
// the (x, y) word (and, with ylo, its y half beside it); YKeys: y's key.
struct PairKeys {
  using Key = uint64_t;
  const float* x;
  const float* y;
  uint64_t* key;
  uint32_t* ylo;  // null: not kept
  __device__ __forceinline__ Key make(int j) const { return pair_key(x[j], y[j]); }
  __device__ __forceinline__ void store(int p, Key k) const {
    key[p] = k;
    if (ylo != nullptr) ylo[p] = static_cast<uint32_t>(k);
  }
};

struct YKeys {
  using Key = uint32_t;
  const float* y;
  uint32_t* key;
  __device__ __forceinline__ Key make(int j) const { return code_key(y[j]); }
  __device__ __forceinline__ void store(int p, Key k) const { key[p] = k; }
};

// Staging: the valid columns of one sample, compacted in column order with
// ballots.  src.make(j) is column j's key (loaded before the ballots, so the
// loads of kPrefetch chunks are in flight together), src.store(p, key) puts
// it at compacted position p.  Returns the number of valid columns.
template <typename Src>
__device__ __forceinline__ int compact(const unsigned char* __restrict__ m,
                                       int P, int lane, const Src& src) {
  const uint32_t below = (1u << lane) - 1u;
  int n = 0;
  for (int c0 = 0; c0 < P; c0 += 32 * kPrefetch) {
    typename Src::Key kv[kPrefetch];
    bool mv[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int j = c0 + 32 * u + lane;
      const bool in = j < P;
      mv[u] = in && m[j];
      kv[u] = in ? src.make(j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, mv[u]);
      if (mv[u]) src.store(n + __popc(bal & below), kv[u]);
      n += __popc(bal);
    }
  }
  return n;
}

// One warp sorts N = 32 * E keys held in registers (lane l holds elements
// l * E .. l * E + E - 1): a bitonic network whose strides below E exchange
// registers and whose strides from E up exchange lanes.
template <typename T, int E>
__device__ __forceinline__ void warp_sort(T (&v)[E], int lane) {
  for (int size = 2; size <= 32 * E; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const int lj = stride / E;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const T o = __shfl_xor_sync(0xFFFFFFFFu, v[i], lj);
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
            const T a = v[i], c = v[i | sj];
            const bool swap = (a > c) == (((lane * E + i) & size) == 0);
            v[i] = swap ? c : a;
            v[i | sj] = swap ? a : c;
          }
        }
      }
    }
  }
}

template <typename T, int E>
__device__ __forceinline__ void sort_in_registers(T* key, int n, int lane) {
  T v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = lane * E + i;
    v[i] = e < n ? key[e] : static_cast<T>(~static_cast<T>(0));
  }
  warp_sort<T, E>(v, lane);
#pragma unroll
  for (int i = 0; i < E; ++i) key[lane * E + i] = v[i];
}

// Sorts key[0, n) in place (key has room for n rounded up to a power of two,
// at least 32; the padding, the largest key, stays beyond n).
template <typename T>
__device__ __forceinline__ void sort_keys(T* key, int n, int lane) {
  int N = 32;
  while (N < n) N <<= 1;
  __syncwarp();
  if (n <= 1) {
  } else if (N == 32) {
    sort_in_registers<T, 1>(key, n, lane);
  } else if (N == 64) {
    sort_in_registers<T, 2>(key, n, lane);
  } else if (N == 128) {
    sort_in_registers<T, 4>(key, n, lane);
  } else if (N == 256) {
    sort_in_registers<T, 8>(key, n, lane);
  } else {
    // Larger samples: the same network over shared memory.
    for (int p = n + lane; p < N; p += 32) key[p] = static_cast<T>(~static_cast<T>(0));
    __syncwarp();
    for (int size = 2; size <= N; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < (N >> 1); t += 32) {
          const int a = 2 * t - (t & (stride - 1));
          const int c = a + stride;
          const T ka = key[a], kc = key[c];
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
}

// Sorted insertion of d into b[0..W): the W smallest values seen so far.
// Branch-free; fminf/fmaxf drop a NaN d, which leaves b as it was.
template <int W>
__device__ __forceinline__ void insert(float (&b)[W], float d) {
#pragma unroll
  for (int s = W - 1; s > 0; --s) b[s] = fmaxf(b[s - 1], fminf(b[s], d));
  b[0] = fminf(b[0], d);
}

// Joint selection of the row at sorted position s: outward from s, right
// then left, while |dx| < b[W-1].  Exact: along either side |fl(xi - x_j)|
// does not decrease, and d >= |dx|, so once |dx| >= b[W-1] no column further
// out can enter the W smallest (a tie with b[W-1] leaves its values as they
// are); a NaN x_j (sorted last) or a NaN / infinite xi ends the side at
// once, and no d there is selectable.  kWalk columns are loaded at a time
// (a NaN past either end stops the side) and taken one by one.
constexpr int kWalk = 4;

template <int W>
__device__ __forceinline__ void joint_select(const float2* xy, int n, int s,
                                             float xi, float yi,
                                             float (&b)[W]) {
  for (int dir = 1; dir >= -1; dir -= 2) {
    for (int j = s + dir;; j += dir * kWalk) {
      float2 c[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int q = j + dir * u;
        c[u] = q >= 0 && q < n ? xy[q] : make_float2(NAN, NAN);
      }
      bool go = true;
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const float dx = fabsf(xi - c[u].x);
        go = go && dx < b[W - 1];
        if (go) insert<W>(b, max_nan(dx, fabsf(yi - c[u].y)));
      }
      if (!go) break;
    }
  }
}

// |fl(yi - yj)|, a NaN counting as +inf (never selected).
__device__ __forceinline__ float class_distance(float yi, float yj) {
  const float d = fabsf(yi - yj);
  return d == d ? d : INFINITY;
}

// Class selection of the row at sorted position s (keys by (code, y)):
// its run of equal codes [lo, hi) by binary search, cnt = hi - lo - 1, and
// the kb smallest |dy| over the run but s, ascending, into dst by a
// two-pointer merge outward from s: each step reads the next distance of
// either side and takes the smaller.  A NaN code is a run of none.  (A
// form that carried each side's distance across steps and stopped a side
// at +inf skipped elements of a side on the card, built by nvcc 12.9,
// though its numpy replay was exact; the cause was not found.  This form
// is bit-equal to ref there.)
__device__ __forceinline__ int class_select(const uint64_t* key,
                                            const float2* xy, int n, int s,
                                            int kb, float* dst) {
  const uint64_t code = key[s] >> 32;
  if (code == 0xFFFFFFFFull) {
    for (int t = 0; t < kb; ++t) dst[t] = INFINITY;
    return 0;
  }
  const int lo = first_ge<uint64_t>(key, 0, s, code << 32);
  const int hi = first_ge<uint64_t>(key, s + 1, n, (code + 1) << 32);
  const float yi = xy[s].y;
  int l = s - 1, r = s + 1;
  for (int t = 0; t < kb; ++t) {
    const float dl = l >= lo ? class_distance(yi, xy[l].y) : INFINITY;
    const float dr = r < hi ? class_distance(yi, xy[r].y) : INFINITY;
    const bool left = dl <= dr;
    dst[t] = left ? dl : dr;
    l -= left ? 1 : 0;
    r += left ? 0 : 1;
  }
  return hi - lo - 1;
}

// Byte offsets of one warp's arrays in dynamic shared memory (NP: P rounded
// up to a power of two, at least 32, the sort's length).  The columns'
// sorted positions take the decoded values' place once the rows are done.
struct KnnLayout {
  size_t key, xy, out, cnt, total;
};

__host__ __device__ inline KnnLayout knn_layout(int P, int NP, int kb) {
  const size_t p = static_cast<size_t>(P);
  KnnLayout L{};
  L.key = 0;
  L.xy = align16(8 * static_cast<size_t>(NP));
  L.out = align16(L.xy + 8 * p);
  L.cnt = align16(L.out + 4 * p * static_cast<size_t>(kb));
  L.total = align16(L.cnt + 2 * p);
  return L;
}

// One warp per sample; no block-wide barrier anywhere.
template <int W, bool JOINT>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
knn_smallest_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const unsigned char* __restrict__ mask, int B, int P,
                    int NP, int kb, float* __restrict__ knn_out,
                    int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const KnnLayout L = knn_layout(P, NP, kb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const size_t row0 = static_cast<size_t>(b) * P;
  const float* xs = x + row0;
  const float* ys = y + row0;
  const unsigned char* ms = mask + row0;
  unsigned char* base = smem + warp * L.total;
  uint64_t* key = reinterpret_cast<uint64_t*>(base + L.key);
  float2* xy = reinterpret_cast<float2*>(base + L.xy);
  uint16_t* pos = reinterpret_cast<uint16_t*>(base + L.xy);  // over xy, below
  float* out = reinterpret_cast<float*>(base + L.out);
  uint16_t* cnt_s = reinterpret_cast<uint16_t*>(base + L.cnt);

  // Stage and sort by (x, y); decode the sorted values.
  const int n = compact(ms, P, lane, PairKeys{xs, ys, key, nullptr});
  sort_keys<uint64_t>(key, n, lane);
  for (int p = lane; p < n; p += 32) {
    const uint64_t k = key[p];
    xy[p] = make_float2(key_value(static_cast<uint32_t>(k >> 32)),
                        key_value(static_cast<uint32_t>(k)));
  }
  __syncwarp();

  // Rows in sorted order: kb lanes each, by sorted position.
  for (int s = lane; s < n; s += 32) {
    float* dst = out + s * kb;
    if (JOINT) {
      const float2 v = xy[s];
      float buf[W];
#pragma unroll
      for (int u = 0; u < W; ++u) buf[u] = INFINITY;
      joint_select<W>(xy, n, s, v.x, v.y, buf);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        if (u < kb) dst[u] = buf[u];
      }
    } else {
      cnt_s[s] = static_cast<uint16_t>(class_select(key, xy, n, s, kb, dst));
    }
  }
  __syncwarp();

  // Each column's sorted position (the first of its key: equal keys have
  // equal outputs), kGroup columns a lane in lockstep, then the sample's
  // (P, kb) block, coalesced.
  const int top = top_step(n);
  for (int j0 = lane; j0 < P; j0 += 32 * kGroup) {
    uint64_t k[kGroup];
    int q[kGroup];
    bool v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < P && ms[j];
      k[u] = v[u] ? pair_key(xs[j], ys[j]) : 0;
      q[u] = 0;
    }
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int p = q[u] + step;
        if (p <= n && key[p - 1] < k[u]) q[u] = p;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + 32 * u;
      if (j >= P) continue;
      pos[j] = v[u] ? static_cast<uint16_t>(q[u]) : kNone;
      cnt_out[row0 + j] = (!JOINT && v[u]) ? cnt_s[q[u]] : 0;
    }
  }
  __syncwarp();
  // Element e = lane + 32 i of the block is lane t of column j; 32 = dj kb +
  // dt steps both without a division.
  float* g = knn_out + row0 * static_cast<size_t>(kb);
  const int dj = 32 / kb, dt = 32 - dj * kb;
  int j = lane / kb, t = lane - j * kb;
  for (int e = lane; e < P * kb; e += 32) {
    const int q = pos[j];
    g[e] = q == kNone ? INFINITY : out[q * kb + t];
    j += dj;
    t += dt;
    if (t >= kb) {
      t -= kb;
      ++j;
    }
  }
}

// Byte offsets of one warp's arrays: the 64-bit (x, y) keys (which == all),
// the 32-bit y keys (decoded in place to the sorted y), the sorted x; each
// sorted value array holds 2 NP floats, +inf past the values, for the
// searches.
struct BallLayout {
  size_t kxy, ky, xs, total;
};

template <bool ALL>
__host__ __device__ inline BallLayout ball_layout(int NP) {
  const size_t np = static_cast<size_t>(NP);
  BallLayout L{};
  L.kxy = 0;
  L.ky = ALL ? align16(8 * np) : 0;
  L.xs = align16(L.ky + 8 * np);
  L.total = ALL ? align16(L.xs + 8 * np) : L.xs;
  return L;
}

template <bool ALL>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
ball_counts_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ r_in, int B, int P, int NP,
                   int* __restrict__ counts_out, size_t plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BallLayout L = ball_layout<ALL>(NP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const size_t row0 = static_cast<size_t>(b) * P;
  const float* ys = y + row0;
  const unsigned char* ms = mask + row0;
  unsigned char* base = smem + warp * L.total;
  uint64_t* kxy = reinterpret_cast<uint64_t*>(base + L.kxy);
  uint32_t* ky = reinterpret_cast<uint32_t*>(base + L.ky);
  float* sy = reinterpret_cast<float*>(ky);  // decoded in place, below
  float* sx = reinterpret_cast<float*>(base + L.xs);

  // Stage; sort y (and (x, y)); count the non-NaN values; decode.
  int n;
  if (ALL) {
    n = compact(ms, P, lane, PairKeys{x + row0, ys, kxy, ky});
    sort_keys<uint64_t>(kxy, n, lane);
  } else {
    n = compact(ms, P, lane, YKeys{ys, ky});
  }
  sort_keys<uint32_t>(ky, n, lane);
  const int nny = first_ge<uint32_t>(ky, 0, n, 0xFFFFFFFFu);
  const int nnx = ALL ? first_ge<uint64_t>(kxy, 0, n, 0xFFFFFFFF00000000ull) : 0;
  __syncwarp();
  for (int p = lane; p < 2 * NP; p += 32) {
    sy[p] = p < nny ? key_value(ky[p]) : INFINITY;
    if (ALL) sx[p] = p < nnx ? key_value(static_cast<uint32_t>(kxy[p] >> 32)) : INFINITY;
  }
  __syncwarp();

  // Rows in column order: the y (and x) searches in lockstep.
  const int ty = top_step(nny), tx = top_step(nnx);
  for (int j = lane; j < P; j += 32) {
    const size_t o = row0 + j;
    int x_lt = 0, y_lt = 0, x_eq = 0, y_eq = 0, j_eq = 0;
    if (ms[j]) {
      const float yi = ys[j], r = r_in[o];
      const float xi = ALL ? x[o] : 0.f;
      int ya[4] = {0, 0, 0, 0}, xa[4] = {0, 0, 0, 0};
      for (int step = max(ty, tx); step > 0; step >>= 1) {
        if (step <= ty) search_step<ALL>(sy, step, yi, r, ya);
        if (ALL && step <= tx) search_step<true>(sx, step, xi, r, xa);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ya[k] = min(ya[k], nny);
        xa[k] = min(xa[k], nnx);
      }
      // The row's own column lies in both ranges of a finite value (its
      // difference is +0): |0| < r holds iff r > 0.
      const int self = 0.f < r ? 1 : 0;
      const bool fy = fabsf(yi) < INFINITY, fx = ALL && fabsf(xi) < INFINITY;
      if (fy) {
        y_lt = max(ya[1] - ya[0], 0) - self;
        if (ALL) y_eq = ya[3] - ya[2] - 1;
      }
      if (fx) {
        x_lt = max(xa[1] - xa[0], 0) - self;
        x_eq = xa[3] - xa[2] - 1;
        if (fy) {
          // The x-tie range [xa[2], xa[3]) holds the columns whose x key is
          // xi's; within it, the (x, y) keys equal to the row's.
          const uint64_t k = pair_key(xi, yi);
          j_eq = first_ge<uint64_t>(kxy, xa[2], xa[3], k + 1) -
                 first_ge<uint64_t>(kxy, xa[2], xa[3], k) - 1;
        }
      }
    }
    counts_out[o] = x_lt;
    counts_out[plane + o] = y_lt;
    counts_out[2 * plane + o] = x_eq;
    counts_out[3 * plane + o] = y_eq;
    counts_out[4 * plane + o] = j_eq;
  }
}

inline int pow2_at_least_32(int P) {
  int NP = 32;
  while (NP < P) NP <<= 1;
  return NP;
}

// As many samples (warps) a block as fit kBlockBytes, max_warps at most;
// one when a sample needs more, with the kernel opted in to that much.
template <typename Kernel>
int block_warps(Kernel* kernel, size_t per_warp, int max_warps, int& warps) {
  const size_t fit = kBlockBytes / per_warp;
  warps = fit < 1 ? 1 : fit > static_cast<size_t>(max_warps)
                            ? max_warps : static_cast<int>(fit);
  if (per_warp * warps <= static_cast<size_t>(kBlockBytes)) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(per_warp * warps)));
}

template <int W, bool JOINT>
int launch_knn(const float* x, const float* y, const unsigned char* mask,
               int B, int P, int kb, float* knn, int* cnt, int max_warps,
               cudaStream_t stream) {
  const int NP = pow2_at_least_32(P);
  const size_t per_warp = knn_layout(P, NP, kb).total;
  int warps;
  const int err = block_warps(knn_smallest_kernel<W, JOINT>, per_warp,
                              max_warps, warps);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
  knn_smallest_kernel<W, JOINT><<<grid, 32 * warps, per_warp * warps, stream>>>(
      x, y, mask, B, P, NP, kb, knn, cnt);
  return static_cast<int>(cudaGetLastError());
}

int knn(const float* x, const float* y, const unsigned char* mask, int B,
        int P, int kb, int joint, float* out, int* cnt, int w, cudaStream_t s) {
  if (!joint) return launch_knn<1, false>(x, y, mask, B, P, kb, out, cnt, w, s);
  if (kb <= 3) return launch_knn<3, true>(x, y, mask, B, P, kb, out, cnt, w, s);
  if (kb <= 8) return launch_knn<8, true>(x, y, mask, B, P, kb, out, cnt, w, s);
  return launch_knn<16, true>(x, y, mask, B, P, kb, out, cnt, w, s);
}

template <bool ALL>
int ball(const float* x, const float* y, const unsigned char* mask,
         const float* r, int B, int P, int* counts, int max_warps,
         cudaStream_t stream) {
  const int NP = pow2_at_least_32(P);
  const size_t per_warp = ball_layout<ALL>(NP).total;
  int warps;
  const int err = block_warps(ball_counts_kernel<ALL>, per_warp, max_warps,
                              warps);
  if (err != 0) return err;
  const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
  ball_counts_kernel<ALL><<<grid, 32 * warps, per_warp * warps, stream>>>(
      x, y, mask, r, B, P, NP, counts,
      static_cast<size_t>(B) * static_cast<size_t>(P));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace staged

// ---------------------------------------------------------------------------
// The tiled bodies
// ---------------------------------------------------------------------------
namespace tiled {

using orders::kWarpP;
using orders::Scratch;

constexpr int kMaxKb = 128;          // kernel.py: K_MAX (ops.py)
constexpr int kWarpSamples = 4;      // samples (warps) a block, P <= kWarpP
constexpr int kRowThreads = 64;      // a row block's threads, at least
constexpr int kRowMaxThreads = 256;  // and at most
constexpr size_t kMaxShared = 227 << 10;   // a block's shared memory, at most
// A call's scratch, at most: the batch goes through the orders and rows
// launches in slices of as many samples as fit it (at least one).
constexpr size_t kScratchCap = size_t{1} << 30;

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// A row's kb lanes in a warp's output tile: row l at l * stride, stride
// odd, so 32 lanes writing lane u of their rows hit 32 banks.
__host__ __device__ inline int tile_stride(int kb) { return kb | 1; }
__host__ __device__ inline size_t tile_bytes(int kb) {
  return 32 * 4 * static_cast<size_t>(tile_stride(kb));
}

// knn_smallest of the valid row at x position s and y position q: its kb
// smallest selected distances, ascending, +inf beyond, into dst; returns
// its same-class count (0 in joint mode).  W: the joint band buffer's
// lanes, 0 for the buffer-free event walk.  RUNS: the band walk leaves a
// spent x-tie run (orders::band_walk; the row kernel's: its x ties are
// sorted by y, and long samples have long runs).
template <int W, bool JOINT, bool RUNS>
__device__ __forceinline__ int knn_row(const float2* X, const float2* Yo,
                                       int nnx, int nny, int s, int q, int kb,
                                       float* dst) {
  const float2 me = X[s];
  const float xi = me.x, yi = me.y;
  const bool fy = fabsf(yi) < INFINITY;
  int filled = 0, cnt = 0;
  if (JOINT) {
    if (fabsf(xi) < INFINITY && fy) {
      if constexpr (W > 0) {
        float b[W];
        orders::band_walk<W, RUNS>(X, nnx, s, xi, yi, b);
#pragma unroll
        for (int u = 0; u < W; ++u) {
          if (u < kb) dst[u] = b[u];
        }
        filled = kb;
      } else {
        filled = orders::event_walk(X, Yo, nnx, nny, s, q, xi, yi, kb,
                                    [&](int g, float d) { dst[g] = d; });
      }
    }
  } else if (xi == xi) {
    int run, end;
    orders::class_run(X, nnx, s, xi, run, end);
    cnt = end - run - 1;
    if (fy) {
      filled = orders::class_walk(X, run, end, s, yi, kb,
                                  [&](int g, float d) { dst[g] = d; });
    }
  }
  for (int u = filled; u < kb; ++u) dst[u] = INFINITY;
  return cnt;
}

// ---- P <= kWarpP: one warp a sample ------------------------------------

// One sample's shared memory in the warp kernels: its orders
// (orders::WarpOrders' arrays), then for knn_smallest the columns' cnt
// (at most 255 others fit a byte) and the warp's output tile.
struct WarpSample {
  float2 xo[kWarpP];
  float2 yo[kWarpP];
  float2 v[kWarpP];
  uint16_t ycol[kWarpP];
  uint16_t xcol[kWarpP];
  uint16_t pos_y[kWarpP];
  __device__ orders::WarpOrders arrays() {
    return {xo, yo, v, ycol, xcol, pos_y};
  }
};

__host__ __device__ inline size_t knn_warp_bytes(int kb) {
  return align16(sizeof(WarpSample) + kWarpP + tile_bytes(kb));
}

// Rows in x order, lane l taking x positions l, l + 32, ...: each round's
// rows go to the warp's tile and leave one warp a row (kb lanes,
// contiguous in the output), the invalid columns' rows (+inf) after.
// The joint band walk reads the x order alone, which one sort by
// (code_key(x), column) gives; class runs and the four-stream walk read
// both orders.
template <int W, bool JOINT>
__global__ void __launch_bounds__(32 * kWarpSamples)
knn_smallest_warp(const float* __restrict__ x, const float* __restrict__ y,
                  const unsigned char* __restrict__ mask, int B, int P,
                  int kb, float* __restrict__ knn_out,
                  int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpSamples + warp;
  if (b >= B) return;  // no block-wide barrier below
  constexpr bool YO = !(JOINT && W > 0);  // the y order is read
  unsigned char* base = smem + warp * knn_warp_bytes(kb);
  WarpSample& S = *reinterpret_cast<WarpSample*>(base);
  uint8_t* cnt = base + sizeof(WarpSample);
  float* out = reinterpret_cast<float*>(base + sizeof(WarpSample) + kWarpP);
  const int stride = tile_stride(kb);
  const size_t row0 = static_cast<size_t>(b) * P;
  float* g = knn_out + row0 * static_cast<size_t>(kb);

  int nan_x, nan_y;
  const int n = orders::warp_orders<true, YO>(x, y, mask, row0, P, lane,
                                              S.arrays(), nan_x, nan_y);
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    int e = 0;
    if (s < n) {
      e = S.xcol[s];
      cnt[e] = static_cast<uint8_t>(knn_row<W, JOINT, false>(
          S.xo, S.yo, n - nan_x, n - nan_y, s, YO ? S.pos_y[e] : 0, kb,
          out + lane * stride));
    }
    __syncwarp();
    const int rows = min(32, n - s0);
    for (int r = 0; r < rows; ++r) {
      const size_t at = static_cast<size_t>(__shfl_sync(0xFFFFFFFFu, e, r)) * kb;
      for (int u = lane; u < kb; u += 32) g[at + u] = out[r * stride + u];
    }
    __syncwarp();
  }
  __syncwarp();
  for (int e0 = 0; e0 < P; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < P, valid = in && mask[row0 + e];
    if (in) cnt_out[row0 + e] = valid ? cnt[e] : 0;
    for (uint32_t gap = __ballot_sync(0xFFFFFFFFu, in && !valid); gap;
         gap &= gap - 1) {
      const size_t at = static_cast<size_t>(e0 + __ffs(gap) - 1) * kb;
      for (int u = lane; u < kb; u += 32) g[at + u] = INFINITY;
    }
  }
}

// ---- The orders in scratch, then one thread a column ------------------

// knn_smallest's rows, the orders read through L1 and L2 (staging a long
// sample's orders in every block cost more than it saved at B = 1).  Each
// warp's 32 rows are 32 neighbouring columns, so their kb lanes leave the
// tile as one contiguous run of the output.
template <int W, bool JOINT>
__global__ void __launch_bounds__(kRowMaxThreads)
knn_smallest_rows(const unsigned char* __restrict__ mask, int P, int kb,
                  float* __restrict__ knn_out, int* __restrict__ cnt_out,
                  Scratch S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int b = blockIdx.x / per;
  const int j = (blockIdx.x % per) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(b) * P;
  int n, nan_x, nan_y;
  orders::sample_stats(S, b, P, n, nan_x, nan_y);
  const float2* X = S.xo + row0;
  const float2* Yo = S.yo + row0;
  const int stride = tile_stride(kb);
  float* tile = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 32 * stride;
  if (j < P) {
    const size_t o = row0 + j;
    float* dst = tile + lane * stride;
    int c = 0;
    if (mask[o]) {
      c = knn_row<W, JOINT, true>(X, Yo, n - nan_x, n - nan_y, S.pos_x[o],
                            S.pos_y[o], kb, dst);
    } else {
      for (int u = 0; u < kb; ++u) dst[u] = INFINITY;
    }
    cnt_out[o] = c;
  }
  __syncwarp();
  const int j0 = j - lane, rows = min(32, P - j0);
  if (rows <= 0) return;
  float* g = knn_out + (row0 + j0) * static_cast<size_t>(kb);
  // Element e = lane + 32 i of the run is lane u of row r; 32 = dr kb + du
  // steps both without a division.
  const int dr = 32 / kb, du = 32 - dr * kb;
  int r = lane / kb, u = lane - r * kb;
  for (int e = lane; e < rows * kb; e += 32) {
    g[e] = tile[r * stride + u];
    r += dr;
    u += du;
    if (u >= kb) {
      u -= kb;
      ++r;
    }
  }
}

// ball_counts' rows, their orders read through L1 and L2.
template <bool ALL>
__global__ void __launch_bounds__(kRowMaxThreads)
ball_counts_rows(const float* __restrict__ x, const float* __restrict__ y,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ r_in, int P,
                 int* __restrict__ counts_out, size_t plane, Scratch S) {
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int b = blockIdx.x / per;
  const int j = (blockIdx.x % per) * blockDim.x + threadIdx.x;
  if (j >= P) return;
  const size_t row0 = static_cast<size_t>(b) * P, o = row0 + j;
  int n, nan_x, nan_y;
  orders::sample_stats(S, b, P, n, nan_x, nan_y);
  int c[5] = {0, 0, 0, 0, 0};
  if (mask[o]) {
    orders::count_ranges<ALL>(S.xo + row0, S.yo + row0, n - nan_x, n - nan_y,
                              ALL ? x[o] : 0.f, y[o], r_in[o], c);
  }
#pragma unroll
  for (int u = 0; u < 5; ++u) counts_out[u * plane + o] = c[u];
}

// Opts kernel in to kMaxShared bytes of dynamic shared memory, once (so
// never while a graph is captured).
template <typename Kernel>
int opt_in(Kernel* kernel, bool& done) {
  if (done) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxShared)));
  done = err == 0;
  return err;
}

// Samples a slice of the batch takes through the orders and rows
// launches: as many as keep the scratch within kScratchCap, at least one
// (carve of n samples is at most n times carve of one).  Samples are
// independent, so no slicing changes an output bit.
inline int slice_samples(int B, int P) {
  const size_t one = orders::carve(nullptr, 1, P, nullptr);
  return static_cast<int>(std::min<size_t>(B, std::max<size_t>(1, kScratchCap / one)));
}

// The scratch of a call that goes through the orders.
inline long long slice_scratch(int B, int P) {
  return static_cast<long long>(orders::carve(nullptr, slice_samples(B, P), P, nullptr));
}

// f(o, nb, S) for each slice of the batch: samples b0 .. b0 + nb - 1,
// o = b0 * P their first column, S their orders carved from scratch.
// Returns the first error.
template <typename F>
int by_slices(int B, int P, void* scratch, F f) {
  const int per = slice_samples(B, P);
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = std::min(per, B - b0);
    Scratch S;
    orders::carve(static_cast<unsigned char*>(scratch), nb, P, &S);
    const int err = f(static_cast<size_t>(b0) * P, nb, S);
    if (err) return err;
  }
  return 0;
}

template <int W, bool JOINT>
int launch_knn(const float* x, const float* y, const unsigned char* mask,
               int B, int P, int kb, float* knn, int* cnt, void* scratch,
               cudaStream_t stream) {
  if (P <= kWarpP) {
    static bool opted = false;
    int err = opt_in(knn_smallest_warp<W, JOINT>, opted);
    if (err) return err;
    const unsigned grid = static_cast<unsigned>((B + kWarpSamples - 1) / kWarpSamples);
    knn_smallest_warp<W, JOINT>
        <<<grid, 32 * kWarpSamples, kWarpSamples * knn_warp_bytes(kb), stream>>>(
            x, y, mask, B, P, kb, knn, cnt);
    return static_cast<int>(cudaGetLastError());
  }
  static bool opted = false;
  if (const int refused = opt_in(knn_smallest_rows<W, JOINT>, opted)) return refused;
  return by_slices(B, P, scratch, [&](size_t o, int nb, const Scratch& S) {
    // The y order only for the four-stream walk.
    const int err = orders::launch_orders<true, JOINT && W == 0>(
        x + o, y + o, mask + o, nb, P, S, stream);
    if (err) return err;
    // The rows spread so that about one block an SM covers the slice (a
    // block's tiles take at most 8 x 16.5 KB).
    const int threads = orders::spread_threads(nb, P, kRowThreads, kRowMaxThreads);
    const unsigned rows = (P + threads - 1) / threads;
    knn_smallest_rows<W, JOINT>
        <<<static_cast<unsigned>(nb) * rows, threads,
           threads / 32 * tile_bytes(kb), stream>>>(
            mask + o, P, kb, knn + o * kb, cnt + o, S);
    return static_cast<int>(cudaGetLastError());
  });
}

// The joint band buffer's width: 4, 8, 16, 32 or 64 lanes >= kb, and past
// 64 the buffer-free walk (0); class mode needs no buffer.
int knn(const float* x, const float* y, const unsigned char* mask, int B,
        int P, int kb, int joint, float* out, int* cnt, void* scratch,
        cudaStream_t s) {
  if (!joint) return launch_knn<0, false>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  if (kb <= 4) return launch_knn<4, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  if (kb <= 8) return launch_knn<8, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  if (kb <= 16) return launch_knn<16, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  if (kb <= 32) return launch_knn<32, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  if (kb <= 64) return launch_knn<64, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
  return launch_knn<0, true>(x, y, mask, B, P, kb, out, cnt, scratch, s);
}

// Every P through the orders in scratch (up to kChunk columns a sample
// is one chunk, sorted and placed by one launch).  Without ALL x is null
// and never offset or read.
template <bool ALL>
int ball(const float* x, const float* y, const unsigned char* mask,
         const float* r, int B, int P, int* counts, void* scratch,
         cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(B) * static_cast<size_t>(P);
  return by_slices(B, P, scratch, [&](size_t o, int nb, const Scratch& S) {
    const float* xs = ALL ? x + o : nullptr;
    const int err = orders::launch_orders<ALL, true>(xs, y + o, mask + o, nb,
                                                     P, S, stream);
    if (err) return err;
    const int threads = orders::spread_threads(nb, P, kRowThreads, kRowMaxThreads);
    const unsigned rows = (P + threads - 1) / threads;
    ball_counts_rows<ALL><<<static_cast<unsigned>(nb) * rows, threads, 0, stream>>>(
        xs, y + o, mask + o, r + o, P, counts + o, plane, S);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace tiled

template <int N>
bool on_ladder(int rung, const int (&rungs)[N]) {
  for (int v : rungs)
    if (v == rung) return true;
  return false;
}

}  // namespace

// Plain C entries for ctypes, two per op (the staged body, then the tiled
// one).  The staged entries take rung, their cap on samples a block: off
// its ladder the launch is refused (no clamp).  The tiled entries take a
// device scratch buffer of the bytes their *_tiled_scratch(B, P) gives
// (none, a null pointer, when that is 0).  Each returns cudaGetLastError()
// after its launches (0 on success), or cudaErrorInvalidValue for
// parameters outside the body's range; a refused launch never runs, so the
// caller must check it.
//
// x, y: float32 (B, P); mask: bool (B, P); knn: float32 (B, P, kb); cnt:
// int32 (B, P).  joint selects the mode.  Staged: P <= 1024, 1 <= kb <= 16.
extern "C" int knn_smallest_launch(const float* x, const float* y,
                                   const unsigned char* mask, int B, int P,
                                   int kb, int joint, float* knn, int* cnt,
                                   int rung, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (kb < 1 || kb > staged::kMaxKb || P > staged::kMaxP ||
      !on_ladder(rung, staged::kWarpRungs))
    return static_cast<int>(cudaErrorInvalidValue);
  return staged::knn(x, y, mask, B, P, kb, joint, knn, cnt, rung,
                     static_cast<cudaStream_t>(stream));
}

// The tiled knn_smallest's scratch: the orders of samples longer than 256
// columns, 40 bytes a column of a slice (tiled::kScratchCap).
extern "C" long long knn_smallest_tiled_scratch(int B, int P) {
  if (B <= 0 || P <= orders::kWarpP) return 0;
  return tiled::slice_scratch(B, P);
}

// Tiled: any P, 1 <= kb <= 128.
extern "C" int knn_smallest_tiled_launch(const float* x, const float* y,
                                         const unsigned char* mask, int B,
                                         int P, int kb, int joint, float* knn,
                                         int* cnt, void* scratch,
                                         void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (kb < 1 || kb > tiled::kMaxKb)
    return static_cast<int>(cudaErrorInvalidValue);
  return tiled::knn(x, y, mask, B, P, kb, joint, knn, cnt, scratch,
                    static_cast<cudaStream_t>(stream));
}

// x: float32 (B, P), or null when all is 0 (never read then); y, r:
// float32 (B, P); mask: bool (B, P); counts: int32 (5, B, P).  Staged:
// P <= 1024.
extern "C" int ball_counts_launch(const float* x, const float* y,
                                  const unsigned char* mask, const float* r,
                                  int B, int P, int all, int* counts,
                                  int rung, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (P > staged::kMaxP || !on_ladder(rung, staged::kWarpRungs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return all ? staged::ball<true>(x, y, mask, r, B, P, counts, rung, s)
             : staged::ball<false>(x, y, mask, r, B, P, counts, rung, s);
}

// The tiled ball_counts' scratch: the orders of every sample, as for
// knn_smallest.
extern "C" long long ball_counts_tiled_scratch(int B, int P) {
  if (B <= 0 || P <= 0) return 0;
  return tiled::slice_scratch(B, P);
}

// Tiled: any P.
extern "C" int ball_counts_tiled_launch(const float* x, const float* y,
                                        const unsigned char* mask,
                                        const float* r, int B, int P, int all,
                                        int* counts, void* scratch,
                                        void* stream) {
  if (B <= 0 || P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return all ? tiled::ball<true>(x, y, mask, r, B, P, counts, scratch, s)
             : tiled::ball<false>(x, y, mask, r, B, P, counts, scratch, s);
}
