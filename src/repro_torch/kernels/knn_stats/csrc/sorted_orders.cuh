// The sorted route shared by the tiled bodies of radius_counts.cu and
// knn_two_op.cu (sm_90a): each sample's valid columns in two orders, and
// one row's selections and counts read off them.
//
// Included at file scope, after <cuda_runtime.h>, <math.h> and <stdint.h>;
// everything lands in the including file's anonymous namespace, so each
// library keeps its own copy and no symbol is exported.
//
// The orders.  The valid columns by value keys (code_key: -0 folded onto
// +0, NaN last): the y order by (code_key(y), column) and the x order by
// (code_key(x), code_key(y), column).  Both keys are distinct, so each
// order is one permutation however it is computed.  A body builds only
// the orders it reads (XO, YO).
//   * P <= kWarpP (warp_orders): one warp a sample sorts in registers
//     (warp_sort, 8 keys a lane): the y order, then the x order keyed by
//     (code_key(x), position in the y order).  An x order alone is one
//     sort by (code_key(x), column): its ties in x are by column, not y,
//     which gives band_walk the same buffer (below) but not a class run
//     sorted by y.
//   * Longer samples (launch_orders), in device scratch (Scratch, carve):
//     launch 1 sorts chunks of kChunk columns by (key, column) pairs in
//     shared memory, over the least power of two of slots that holds the
//     chunk's last valid column (a chunk with none sorts nothing); a
//     sample of one chunk is then in order, and launch 1 writes its orders
//     and positions itself.  Past one chunk, launch 2 counts for every
//     entry the pairs below it in each other chunk (one block a chunk
//     pair, integer atomic adds, so the sum is order-free); launch 3
//     writes each entry to its place and each column's positions.
//
// One row, from the orders (a row's x is xi, its y yi):
//   * band_walk: the W smallest joint distances max(|dx|, |dy|) over the
//     band |dx| < b[W-1] along the x order, outward from the row.  Exact
//     because |fl(xi - xj)| does not decrease along either side and the
//     joint distance is at least |dx|, so once |dx| >= b[W-1] nothing
//     further out enters the W smallest.  Up to 8 lanes one candidate at a
//     time (insert, which drops a NaN); wider buffers in batches of G = W /
//     2 (at most 32) from each side in turn: the batch (a NaN distance made
//     +inf, never selected either) sorted by a register network, then
//     min(b[W-G+u], c[G-1-u]) beside b's first W - G is the W smallest of
//     both as a bitonic sequence, put in order by log2(W) stages.  A batch
//     may reach past the band; candidates there leave the W smallest as
//     they are.  In the row kernels, up to 8 lanes, the walk loads kWalk
//     candidates at a time (the same candidates, inserted in the same
//     order).  Any order of
//     the x ties gives the same buffer: along a side |dx| does not
//     decrease, a candidate with |dx| >= b[W-1] cannot enter, and the
//     buffer is the W smallest of what it was given.  Where the ties are
//     sorted by y (RUNS, which the row kernels of long samples ask for),
//     the walk leaves the row's own tie run as soon as its |dy| reaches
//     b[W-1] (run_spent): along the run |dy| does not decrease away from
//     the row, and it is the joint distance there, so nothing further in
//     the run can enter.
//   * event_walk: no buffer.  Four streams walk outward from the row, left
//     and right along the x order (values |dx|) and along the y order
//     (values |dy|), each step taking the stream whose next value is
//     least.  An entry meets its two values in increasing order and
//     completes at the larger, max(|dx|, |dy|) (in the x stream when |dy|
//     <= |dx|, else in the y stream), so completions come in increasing
//     joint distance; one with a NaN distance never completes.
//   * class_run / class_walk: the row's run of equal codes in the x order
//     (a NaN code is a run of none) is sorted by y, so two streams outward
//     from the row, merged, give its |dy| in increasing order (a NaN |dy|,
//     a NaN y sorted last in the run, ends its side).
//   * count_ranges: every count is a range of one order, found by binary
//     search (first): over ascending values fl(vi - vj) does not increase,
//     and a NaN vj (sorted last) meets both predicates !(f > t) and !(f >=
//     t), so each is monotone; |dy| < r and dy == 0 over the y order, |dx|
//     < r and dx == 0 over the x order, j_eq inside the x-tie range, which
//     is one value and so sorted by y.  A non-finite xi (or yi) meets no x
//     (or y) condition.  The self pair is taken out.
// With the expressions of ref.py (fabsf(xi - xj), the joint distance one
// max.NaN.f32) every split of rows across threads, warps and blocks gives
// the same bits.

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

namespace orders {

constexpr int kChunk = 1024;   // columns a block sorts (kernel.py: TILED_CHUNK)
constexpr int kPlaceThreads = 256;
constexpr int kSortThreads = 256;  // a chunk sort's threads: a slot pair a
                                   // thread a stage up to 512 slots
constexpr int kWarpP = 256;    // warp_orders' samples, at most
constexpr int kWarpE = kWarpP / 32;  // sort keys a lane holds
constexpr int kSMs = 132;      // an H100's SMs: B = 1 spreads over them
constexpr uint32_t kDone = 0xFFFFFFFFu;  // an exhausted stream's head

// A float's order as an unsigned key: -0 folded onto +0, every NaN the
// largest key (and never equal to a number's).
__device__ __forceinline__ uint32_t code_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  if (v == 0.f) return 0x80000000u;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Sorted insertion of d into b[0..W): the W smallest values seen so far.
// Branch-free; fminf/fmaxf drop a NaN d, which leaves b as it was.
template <int W>
__device__ __forceinline__ void insert(float (&b)[W], float d) {
#pragma unroll
  for (int s = W - 1; s > 0; --s) b[s] = fmaxf(b[s - 1], fminf(b[s], d));
  b[0] = fminf(b[0], d);
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

// ---- One row from its sample's two sorted orders -----------------------

__device__ __forceinline__ void order2(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

template <int G>
__device__ __forceinline__ void sort_regs(float (&v)[G]) {
#pragma unroll
  for (int size = 2; size <= G; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) order2(v[i], v[j]); else order2(v[j], v[i]);
        }
      }
    }
  }
}

// The W smallest of a sorted buffer b and a batch c (sorted here), in b.
template <int W, int G>
__device__ __forceinline__ void merge_batch(float (&b)[W], float (&c)[G]) {
  sort_regs<G>(c);
#pragma unroll
  for (int u = 0; u < G; ++u) b[W - G + u] = fminf(b[W - G + u], c[G - 1 - u]);
#pragma unroll
  for (int stride = W >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int j = i ^ stride;
      if (j > i) order2(b[i], b[j]);
    }
  }
}

constexpr int kWalk = 4;  // candidates a row kernel's narrow band walk loads
                          // at a time (from global memory)

// The first x position past the row's own x-tie run (x == xi) from j on
// side dir: right, the first q >= j with X[q].x > xi (nnx if none); left,
// the last q <= j with X[q].x < xi (-1 if none).
__device__ __forceinline__ int past_run(const float2* X, int nnx, int j,
                                        int dir, float xi) {
  if (dir > 0) {
    int lo = j, hi = nnx;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (X[mid].x > xi) hi = mid; else lo = mid + 1;
    }
    return lo;
  }
  int lo = 0, hi = j + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (X[mid].x < xi) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// Whether the rest of the row's own x-tie run past entry e (on the side
// the walk is on) cannot enter the buffer: e ties xi, and its |dy| is not
// below b[W-1].  The run is sorted by y, so |dy| does not decrease along
// it away from the row, and its joint distance there is |dy|.
__device__ __forceinline__ bool run_spent(float2 e, float xi, float yi,
                                          float worst) {
  return e.x == xi && !(fabsf(yi - e.y) < worst);
}

// The W smallest joint distances of the row at x position s, ascending and
// +inf beyond the selectable ones, into b: the band walk along the x order
// X (nnx entries with a number for x).  RUNS (the row kernels: X in global
// memory, long samples, x ties sorted by y): up to 8 lanes kWalk
// candidates are loaded at a time, and the walk leaves the row's own tie
// run once run_spent; the warp kernels (X in shared memory) take one
// candidate at a time.
template <int W, bool RUNS>
__device__ __forceinline__ void band_walk(const float2* X, int nnx, int s,
                                          float xi, float yi, float (&b)[W]) {
#pragma unroll
  for (int u = 0; u < W; ++u) b[u] = INFINITY;
  if constexpr (W <= 8) {
    constexpr int K = RUNS ? kWalk : 1;
    // Right, then left; past either end a NaN candidate stops the side.
    for (int dir = 1; dir >= -1; dir -= 2) {
      for (int j = s + dir;; j += dir * K) {
        float2 c[K];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int q = j + dir * u;
          c[u] = q >= 0 && q < nnx ? X[q] : make_float2(NAN, NAN);
        }
        bool go = true;
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const float dx = fabsf(xi - c[u].x);
          go = go && dx < b[W - 1];
          if (go) insert<W>(b, max_nan(dx, fabsf(yi - c[u].y)));
        }
        if (!go) break;
        if (RUNS && run_spent(c[K - 1], xi, yi, b[W - 1]))
          j = past_run(X, nnx, j + dir * K, dir, xi) - dir * K;
      }
    }
  } else {
    constexpr int G = W < 64 ? W / 2 : 32;
    int jr = s + 1, jl = s - 1;
    bool right = jr < nnx, left = jl >= 0;
    while (right || left) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int j0 = side ? jl : jr, step = side ? -1 : 1;
        bool& live = side ? left : right;
        if (live && !(fabsf(xi - X[j0].x) < b[W - 1])) live = false;
        if (!live) continue;
        float c[G];
        float2 tail = make_float2(NAN, NAN);  // the batch's last entry
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const int j = j0 + step * u;
          float d = INFINITY;
          if (side ? j >= 0 : j < nnx) {
            const float2 e = X[j];
            d = max_nan(fabsf(xi - e.x), fabsf(yi - e.y));
            d = d == d ? d : INFINITY;
            if (u == G - 1) tail = e;
          }
          c[u] = d;
        }
        merge_batch<W, G>(b, c);
        const bool spent = RUNS && run_spent(tail, xi, yi, b[W - 1]);
        if (side) {
          jl -= G;
          if (spent) jl = past_run(X, nnx, jl, -1, xi);
          left = jl >= 0;
        } else {
          jr += G;
          if (spent) jr = past_run(X, nnx, jr, 1, xi);
          right = jr < nnx;
        }
      }
    }
  }
}

// The head of an x stream (X) or a y stream at entry e: the event's value
// (|dx| for an x stream, |dy| for a y stream) shifted up one bit, and the
// low bit set where the entry's joint distance is that value.
template <bool X>
__device__ __forceinline__ uint32_t head(float2 e, float xi, float yi) {
  const float ax = fabsf(xi - e.x), ay = fabsf(yi - e.y);
  const bool done = X ? ay <= ax : ax < ay;
  return (__float_as_uint(X ? ax : ay) << 1) | (done ? 1u : 0u);
}

// The four-stream walk of the row at x position s and y position q (the
// orders X and Yo hold nnx and nny entries with a number for x, for y):
// sink(g, d) for the first `count` completions in order, d the g-th
// smallest joint distance.  Returns how many there were (fewer when the
// streams run out).
template <typename Sink>
__device__ __forceinline__ int event_walk(const float2* X, const float2* Yo,
                                          int nnx, int nny, int s, int q,
                                          float xi, float yi, int count,
                                          Sink&& sink) {
  int p0 = s - 1, p1 = s + 1, p2 = q - 1, p3 = q + 1;
  uint32_t h0 = p0 >= 0 ? head<true>(X[p0], xi, yi) : kDone;
  uint32_t h1 = p1 < nnx ? head<true>(X[p1], xi, yi) : kDone;
  uint32_t h2 = p2 >= 0 ? head<false>(Yo[p2], xi, yi) : kDone;
  uint32_t h3 = p3 < nny ? head<false>(Yo[p3], xi, yi) : kDone;
  int got = 0;
  for (;;) {
    const uint32_t m = min(min(h0, h1), min(h2, h3));
    if (m == kDone) return got;
    if (m & 1u) {
      sink(got, __uint_as_float(m >> 1));
      if (++got == count) return got;
    }
    // Advance the first stream at m, without a divergent branch.
    const int id = h0 == m ? 0 : h1 == m ? 1 : h2 == m ? 2 : 3;
    const bool right = id & 1;
    int p = id == 0 ? p0 : id == 1 ? p1 : id == 2 ? p2 : p3;
    p += right ? 1 : -1;
    const bool in = right ? p < (id < 2 ? nnx : nny) : p >= 0;
    const float2 e = (id < 2 ? X : Yo)[in ? p : 0];
    const uint32_t h = !in ? kDone : id < 2 ? head<true>(e, xi, yi)
                                            : head<false>(e, xi, yi);
    p0 = id == 0 ? p : p0;
    p1 = id == 1 ? p : p1;
    p2 = id == 2 ? p : p2;
    p3 = id == 3 ? p : p3;
    h0 = id == 0 ? h : h0;
    h1 = id == 1 ? h : h1;
    h2 = id == 2 ? h : h2;
    h3 = id == 3 ? h : h3;
  }
}

// The run [lo, hi) of the row at x position s whose code xi is a number:
// x ascends through it, -0 == +0.
__device__ __forceinline__ void class_run(const float2* X, int nnx, int s,
                                          float xi, int& run, int& end) {
  int lo = 0, hi = s;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (X[mid].x < xi) lo = mid + 1; else hi = mid;
  }
  run = lo;
  lo = s + 1;
  hi = nnx;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (X[mid].x <= xi) lo = mid + 1; else hi = mid;
  }
  end = lo;
}

// |dy| as a key, a NaN one (a NaN y, sorted last in its run) exhausted.
__device__ __forceinline__ uint32_t dy_key(float yi, float yj) {
  const float d = fabsf(yi - yj);
  return d == d ? __float_as_uint(d) : kDone;
}

// Class selection: sink(g, d) for the first `count` |dy| over the row's
// run [lo, hi) but its own position s, in increasing order (the run sorted
// by y, so two streams outward from s).  Returns how many there were.
template <typename Sink>
__device__ __forceinline__ int class_walk(const float2* X, int lo, int hi,
                                          int s, float yi, int count,
                                          Sink&& sink) {
  int p0 = s - 1, p1 = s + 1;
  uint32_t h0 = p0 >= lo ? dy_key(yi, X[p0].y) : kDone;
  uint32_t h1 = p1 < hi ? dy_key(yi, X[p1].y) : kDone;
  for (int got = 0;; ++got) {
    const uint32_t m = min(h0, h1);
    if (m == kDone) return got;
    sink(got, __uint_as_float(m));
    if (got + 1 == count) return count;
    const bool left = h0 == m;
    const int p = left ? --p0 : ++p1;
    const bool in = left ? p >= lo : p < hi;
    const uint32_t h = in ? dy_key(yi, X[p].y) : kDone;
    h0 = left ? h : h0;
    h1 = left ? h1 : h;
  }
}

// The first position in [lo, hi) of a sorted order where !(v_i - v_j > t)
// (LE) or !(v_i - v_j >= t) (LT), v the x (Y = false) or y (Y = true) of
// an entry.  Along ascending values fl(v_i - v_j) does not increase, and a
// NaN v_j (sorted last) meets both predicates, so each is monotone.
template <bool Y, bool LE>
__device__ __forceinline__ int first(const float2* s, int lo, int hi,
                                     float vi, float t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float2 e = s[mid];
    const float f = vi - (Y ? e.y : e.x);
    if (LE ? !(f > t) : !(f >= t)) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// x_lt, y_lt, x_eq, y_eq, j_eq of a valid row at radius r: ranges of the
// sorted orders, the self pair taken out (ALL: all five; else y_lt only,
// and X is never read).
template <bool ALL>
__device__ __forceinline__ void count_ranges(const float2* X, const float2* Yo,
                                             int nnx, int nny, float xi,
                                             float yi, float r, int (&c)[5]) {
  const bool fx = fabsf(xi) < INFINITY, fy = fabsf(yi) < INFINITY;
  const int self = 0.f < r ? 1 : 0;
  c[0] = c[1] = c[2] = c[3] = c[4] = 0;
  if (fy) {
    c[1] = max(first<true, true>(Yo, 0, nny, yi, -r)
               - first<true, false>(Yo, 0, nny, yi, r), 0) - self;
    if (ALL) {
      c[3] = first<true, false>(Yo, 0, nny, yi, 0.f)
             - first<true, true>(Yo, 0, nny, yi, 0.f) - 1;
    }
  }
  if (ALL && fx) {
    const int a0 = first<false, true>(X, 0, nnx, xi, 0.f);
    const int b0 = first<false, false>(X, 0, nnx, xi, 0.f);
    c[0] = max(first<false, true>(X, 0, nnx, xi, -r)
               - first<false, false>(X, 0, nnx, xi, r), 0) - self;
    c[2] = b0 - a0 - 1;
    // The x ties are one value, sorted by y within it.
    if (fy) {
      c[4] = first<true, false>(X, a0, b0, yi, 0.f)
             - first<true, true>(X, a0, b0, yi, 0.f) - 1;
    }
  }
}

// ---- P <= kWarpP: one warp a sample, the sorts in registers ------------

// One sample's orders in shared memory (the arrays warp_orders fills).
// The staged columns (v) and the y order's columns (ycol) are dead once
// both orders exist; a kernel may put its outputs over them.
struct WarpOrders {
  float2* xo;        // the x order
  float2* yo;        // the y order
  float2* v;         // (x, y) by column
  uint16_t* ycol;    // the y order's columns
  uint16_t* xcol;    // the x order's columns
  uint16_t* pos_y;   // a column's y position
};

// The sample's valid columns in the orders XO, YO asks for: with YO by
// (code_key(y), column), then (XO) by (code_key(x), y position); with XO
// alone by (code_key(x), column); each by warp_sort over kWarpP register
// keys (padding ~0 sorts last).  Without XO x is never read (v holds (0,
// y)).  Returns the number of valid columns; nan_x, nan_y: how many of
// them have a NaN x (XO), a NaN y (YO).
template <bool XO, bool YO>
__device__ __forceinline__ int warp_orders(const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const unsigned char* __restrict__ mask,
                                           size_t row0, int P, int lane,
                                           const WarpOrders& S, int& nan_x,
                                           int& nan_y) {
  static_assert(XO || YO, "an order to build");
  uint64_t key[kWarpE];
  int n = 0;
  nan_x = nan_y = 0;
#pragma unroll
  for (int i = 0; i < kWarpE; ++i) {
    const int e = lane * kWarpE + i;
    bool valid = false;
    float xv = 0.f, yv = 0.f;
    if (e < P) {
      if (XO) xv = x[row0 + e];
      yv = y[row0 + e];
      valid = mask[row0 + e] != 0;
      S.v[e] = make_float2(xv, yv);
    }
    key[i] = valid ? (static_cast<uint64_t>(code_key(YO ? yv : xv)) << 32) | e
                   : ~0ull;
    n += __popc(__ballot_sync(0xFFFFFFFFu, valid));
    if (XO) nan_x += __popc(__ballot_sync(0xFFFFFFFFu, valid && xv != xv));
    if (YO) nan_y += __popc(__ballot_sync(0xFFFFFFFFu, valid && yv != yv));
  }
  __syncwarp();
  warp_sort<kWarpE>(key, lane);
#pragma unroll
  for (int i = 0; i < kWarpE; ++i) {
    const int q = lane * kWarpE + i;
    if (q < n) {
      const int e = static_cast<int>(static_cast<uint32_t>(key[i]));
      if (YO) {
        S.yo[q] = S.v[e];
        S.ycol[q] = static_cast<uint16_t>(e);
        S.pos_y[e] = static_cast<uint16_t>(q);
      } else {
        S.xo[q] = S.v[e];
        S.xcol[q] = static_cast<uint16_t>(e);
      }
    }
  }
  __syncwarp();
  if constexpr (XO && YO) {
#pragma unroll
    for (int i = 0; i < kWarpE; ++i) {
      const int q = lane * kWarpE + i;
      key[i] = q < n ? (static_cast<uint64_t>(code_key(S.yo[q].x)) << 32) | q
                     : ~0ull;
    }
    warp_sort<kWarpE>(key, lane);
#pragma unroll
    for (int i = 0; i < kWarpE; ++i) {
      const int s = lane * kWarpE + i;
      if (s < n) {
        const int q = static_cast<int>(static_cast<uint32_t>(key[i]));
        S.xo[s] = S.yo[q];
        S.xcol[s] = S.ycol[q];
      }
    }
    __syncwarp();
  }
  return n;
}

// ---- P > kWarpP: the sort in chunks, merged ------------------------------

// Scratch, carved by the wrapper's one allocation (the entries'
// *_tiled_scratch give its size): per sample both sorted orders as (x, y),
// each column's position in them, per chunk (valid, NaN x, NaN y) counts,
// and the chunks' sorted (key, column) pairs.  The orders lie over the
// keys: launch 2 is the last to read a key, and launch 3 writes the
// orders reading only columns and places.
struct Scratch {
  float2* xo;      // (B, P): valid columns by (x, y, column), over key[0]
  float2* yo;      // (B, P): valid columns by (y, column), over key[1]
  int* pos_x;      // (B, P): a column's position in xo
  int* pos_y;      // (B, P): its position in yo
  int* stats;      // (B, chunks, 3)
  uint64_t* key;   // (2, B, P): chunk keys (x order, y order)
  uint32_t* col;   // (2, B, P): their columns
  int* at;         // (2, B, P): their places in the sample's orders
};

inline size_t align256(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

__host__ __device__ inline int chunks_of(int P) { return (P + kChunk - 1) / kChunk; }

// The scratch's layout from base (nullptr: only its size).
inline size_t carve(unsigned char* base, int B, int P, Scratch* s) {
  const size_t bp = static_cast<size_t>(B) * static_cast<size_t>(P);
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + o : nullptr;
    o = align256(o + bytes);
    return p;
  };
  Scratch t;
  t.pos_x = reinterpret_cast<int*>(take(4 * bp));
  t.pos_y = reinterpret_cast<int*>(take(4 * bp));
  t.stats = reinterpret_cast<int*>(take(12 * static_cast<size_t>(B) * chunks_of(P)));
  t.key = reinterpret_cast<uint64_t*>(take(16 * bp));
  t.col = reinterpret_cast<uint32_t*>(take(8 * bp));
  t.at = reinterpret_cast<int*>(take(8 * bp));
  t.xo = reinterpret_cast<float2*>(t.key);
  t.yo = reinterpret_cast<float2*>(t.key ? t.key + bp : nullptr);
  if (s) *s = t;
  return o;
}

// A sample's (valid, NaN x, NaN y) column counts, summed over its chunks.
__device__ __forceinline__ void sample_stats(const Scratch& S, int b, int P,
                                             int& n, int& nan_x, int& nan_y) {
  const int nc = chunks_of(P);
  const int* st = S.stats + 3 * static_cast<size_t>(b) * nc;
  n = nan_x = nan_y = 0;
  for (int c = 0; c < nc; ++c) {
    n += st[3 * c];
    nan_x += st[3 * c + 1];
    nan_y += st[3 * c + 2];
  }
}

// (key, column) pairs in lexicographic order; padding is (~0, ~0).
__device__ __forceinline__ bool pair_less(uint64_t ka, uint32_t ca,
                                          uint64_t kb, uint32_t cb) {
  return ka < kb || (ka == kb && ca < cb);
}

__device__ __forceinline__ void exchange(uint64_t* k, uint32_t* c, int a,
                                         int d, bool up) {
  const uint64_t ka = k[a], kd = k[d];
  const uint32_t ca = c[a], cd = c[d];
  if (pair_less(kd, cd, ka, ca) == up) {  // a above d while ascending
    k[a] = kd;
    k[d] = ka;
    c[a] = cd;
    c[d] = ca;
  }
}

// Launch 1: one block a (sample, chunk of kChunk columns) sorts the
// chunk's valid columns in shared memory, as (key, column) pairs: by
// (code_key(x), code_key(y)) (XO) and by code_key(y) (YO), the column
// breaking ties, so the merged orders are the ones warp_orders builds.
// The bitonic network spans the least power of two of slots that holds
// the chunk's last valid column (the slots past it hold padding, which
// sorts last anyway).  A sample of one chunk is placed here (launch 3's
// writes, from the sorted pairs in shared memory).  Without XO x is never
// read.
template <bool XO, bool YO>
__global__ void __launch_bounds__(kSortThreads)
orders_sort(const float* __restrict__ x, const float* __restrict__ y,
            const unsigned char* __restrict__ mask, int B, int P, Scratch S) {
  constexpr int N = kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tally[4];  // valid, NaN x, NaN y; the last valid slot
  uint64_t* kx = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ky = kx + N;
  uint32_t* cx = reinterpret_cast<uint32_t*>(ky + N);
  uint32_t* cy = cx + N;
  const int nc = chunks_of(P);
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int c0 = c * N, len = min(N, P - c0);
  const size_t row0 = static_cast<size_t>(b) * P;

  if (threadIdx.x < 4) tally[threadIdx.x] = threadIdx.x < 3 ? 0 : -1;
  __syncthreads();
  // Every slot's loads first (in flight together), then its keys.
  constexpr int kPer = N / kSortThreads;
  float xs[kPer], ys[kPer];
  bool ms[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kSortThreads;
    const bool in = e < len;
    xs[i] = XO && in ? x[row0 + c0 + e] : 0.f;
    ys[i] = in ? y[row0 + c0 + e] : 0.f;
    ms[i] = in && mask[row0 + c0 + e] != 0;
  }
  int nv = 0, nan_x = 0, nan_y = 0, last = -1;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kSortThreads;
    const uint32_t j = static_cast<uint32_t>(c0 + e);
    const bool valid = ms[i];
    const float xv = xs[i], yv = ys[i];
    const uint64_t hx = code_key(xv), hy = code_key(yv);
    if (XO) {
      kx[e] = valid ? (hx << 32) | hy : ~0ull;
      cx[e] = valid ? j : ~0u;
    }
    if (YO) {
      ky[e] = valid ? (hy << 32) | j : ~0ull;
      cy[e] = valid ? j : ~0u;
    }
    nv += valid;
    nan_x += XO && valid && xv != xv;
    nan_y += YO && valid && yv != yv;
    last = valid ? e : last;
  }
  nv = __reduce_add_sync(0xFFFFFFFFu, nv);
  nan_x = __reduce_add_sync(0xFFFFFFFFu, nan_x);
  nan_y = __reduce_add_sync(0xFFFFFFFFu, nan_y);
  last = __reduce_max_sync(0xFFFFFFFFu, last);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&tally[0], nv);
    atomicAdd(&tally[1], nan_x);
    atomicAdd(&tally[2], nan_y);
    atomicMax(&tally[3], last);
  }
  __syncthreads();
  nv = tally[0];
  int span = 1;
  while (span <= tally[3]) span <<= 1;
  // Slot pairs t, t + blockDim.x, ...: for strides below 32 a warp's pairs
  // stay in its own 64-slot blocks, so a warp barrier orders them.
  for (int size = 2; size <= span; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) __syncthreads(); else __syncwarp();
      for (int t = threadIdx.x; 2 * t < span; t += blockDim.x) {
        const int a = 2 * t - (t & (stride - 1));
        const bool up = (a & size) == 0;
        if (XO) exchange(kx, cx, a, a + stride, up);
        if (YO) exchange(ky, cy, a, a + stride, up);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* st = S.stats + 3 * (static_cast<size_t>(b) * nc + c);
    st[0] = nv;
    st[1] = tally[1];
    st[2] = tally[2];
  }
  if (nc == 1) {
    for (int e = threadIdx.x; e < nv; e += blockDim.x) {
      if (XO) {
        const uint32_t j = cx[e];
        S.xo[row0 + e] = make_float2(x[row0 + j], y[row0 + j]);
        S.pos_x[row0 + j] = e;
      }
      if (YO) {
        const uint32_t j = cy[e];
        S.yo[row0 + e] = make_float2(XO ? x[row0 + j] : 0.f, y[row0 + j]);
        S.pos_y[row0 + j] = e;
      }
    }
    return;
  }
  const size_t bp = static_cast<size_t>(B) * P;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const size_t o = row0 + c0 + e;
    if (XO) {
      S.key[o] = kx[e];
      S.col[o] = cx[e];
      S.at[o] = e;  // its place in the chunk; launch 2 adds the rest
    }
    if (YO) {
      S.key[bp + o] = ky[e];
      S.col[bp + o] = cy[e];
      S.at[bp + o] = e;
    }
  }
}

// Launch 2: an entry's place in its sample's order is its place in its
// chunk plus, in every other chunk, the number of entries below it.  One
// block a (sample, chunk c, chunk d != c) (no block for d == c) holds
// chunk d's sorted pairs in
// shared memory and adds to each of chunk c's entries the count below it
// in d (a binary search); the pairs are distinct, so the places are a
// permutation, and integer adds in any order give the same places.
template <bool XO, bool YO>
__global__ void __launch_bounds__(kPlaceThreads)
orders_rank(int B, int P, Scratch S) {
  constexpr int o0 = XO ? 0 : 1, o1 = YO ? 2 : 1;  // the orders built
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t (*sk)[kChunk] = reinterpret_cast<uint64_t (*)[kChunk]>(smem);
  uint32_t (*sc)[kChunk] = reinterpret_cast<uint32_t (*)[kChunk]>(sk + 2);
  const int nc = chunks_of(P);
  const int pairs = nc * (nc - 1);
  const int b = blockIdx.x / pairs, c = blockIdx.x % pairs / (nc - 1);
  const int k = blockIdx.x % (nc - 1), d = k < c ? k : k + 1;
  const int* st = S.stats + 3 * static_cast<size_t>(b) * nc;
  const int nv_c = st[3 * c], nv_d = st[3 * d];
  if (nv_c == 0 || nv_d == 0) return;
  const size_t row0 = static_cast<size_t>(b) * P;
  const size_t bp = static_cast<size_t>(B) * P;
  for (int e = threadIdx.x; e < nv_d; e += blockDim.x) {
#pragma unroll
    for (int o = o0; o < o1; ++o) {
      const size_t g = o * bp + row0 + static_cast<size_t>(d) * kChunk + e;
      sk[o][e] = S.key[g];
      sc[o][e] = S.col[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nv_c; e += blockDim.x) {
#pragma unroll
    for (int o = o0; o < o1; ++o) {
      const size_t g = o * bp + row0 + static_cast<size_t>(c) * kChunk + e;
      const uint64_t k = S.key[g];
      const uint32_t j = S.col[g];
      int lo = 0, hi = nv_d;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pair_less(sk[o][mid], sc[o][mid], k, j)) lo = mid + 1; else hi = mid;
      }
      if (lo) atomicAdd(S.at + g, lo);
    }
  }
}

// Launch 3: each entry to its place: the orders' (x, y) and each
// column's positions (without XO the y order holds (0, y)).  One block a
// (sample, chunk), over the chunk's valid entries.
template <bool XO, bool YO>
__global__ void __launch_bounds__(kPlaceThreads)
orders_place(const float* __restrict__ x, const float* __restrict__ y,
             int B, int P, Scratch S) {
  const int nc = chunks_of(P);
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int nv = S.stats[3 * (static_cast<size_t>(b) * nc + c)];
  const size_t row0 = static_cast<size_t>(b) * P;
  const size_t bp = static_cast<size_t>(B) * P;
  for (int e = threadIdx.x; e < nv; e += blockDim.x) {
    const size_t g = row0 + static_cast<size_t>(c) * kChunk + e;
    if (XO) {
      const uint32_t jx = S.col[g];
      const int ax = S.at[g];
      S.xo[row0 + ax] = make_float2(x[row0 + jx], y[row0 + jx]);
      S.pos_x[row0 + jx] = ax;
    }
    if (YO) {
      const uint32_t jy = S.col[bp + g];
      const int ay = S.at[bp + g];
      S.yo[row0 + ay] = make_float2(XO ? x[row0 + jy] : 0.f, y[row0 + jy]);
      S.pos_y[row0 + jy] = ay;
    }
  }
}

// Launches 1-3 on the batch (launch 1 alone for samples of one chunk):
// the orders XO, YO of every sample into S.  Returns cudaGetLastError()
// of the first launch that failed, else 0.
template <bool XO, bool YO>
inline int launch_orders(const float* x, const float* y,
                         const unsigned char* mask, int B, int P,
                         const Scratch& S, cudaStream_t stream) {
  const unsigned nc = static_cast<unsigned>(chunks_of(P));
  orders_sort<XO, YO><<<static_cast<unsigned>(B) * nc, kSortThreads, 24 * kChunk,
                    stream>>>(x, y, mask, B, P, S);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (nc == 1) return 0;
  orders_rank<XO, YO><<<static_cast<unsigned>(B) * nc * (nc - 1), kPlaceThreads,
                    24 * kChunk, stream>>>(B, P, S);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  orders_place<XO, YO><<<static_cast<unsigned>(B) * nc, kPlaceThreads, 0,
                     stream>>>(x, y, B, P, S);
  return static_cast<int>(cudaGetLastError());
}

// Threads of a row block (one thread a column) that spread B samples of P
// columns over about one block an SM: a multiple of 32 in [lo, hi].
inline int spread_threads(int B, int P, int lo, int hi) {
  const long long want = (static_cast<long long>(B) * P + kSMs - 1) / kSMs;
  return static_cast<int>(min(static_cast<long long>(hi),
                              max(static_cast<long long>(lo),
                                  (want + 31) / 32 * 32)));
}

// Copies a sample's two orders (n entries each) into shared memory, the
// block's threads together, kU loads in flight a thread.
__device__ __forceinline__ void stage_orders(const float2* X, const float2* Yo,
                                             int n, float2* sx, float2* sy) {
  constexpr int kU = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += kU * blockDim.x) {
    float2 a[kU], c[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) {
        a[u] = X[e];
        c[u] = Yo[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) {
        sx[e] = a[u];
        sy[e] = c[u];
      }
    }
  }
  __syncthreads();
}

}  // namespace orders

}  // namespace
