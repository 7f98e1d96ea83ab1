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
// (d < buf[W-1] is false for it) and fails every count condition.
//
// Bound: ALU work.  Per valid pair (i, j != i) knn_smallest needs one
// distance evaluation and the compare against the running W-th smallest;
// ball_counts the distance halves and the count compares and adds.  The
// bytes are B*P*(9 + 4*kb + 4) and B*P*(13 + 20): small beside P^2 pairs.
// Design: radius_counts.cu's, split in two.  One block per (sample,
// 128-row tile), one thread per row; the sample's columns are staged in
// shared memory, so every pair reads shared memory only.  knn_smallest
// keeps a sorted register buffer of the W smallest distances (W = the
// smallest of 4..128 that is >= kb), updated by a branch-free min/max
// bubble only when a distance beats the current W-th, and writes its kb
// lanes at the end: each thread writes kb consecutive floats, so a warp's
// stores are strided by kb (coalescing them is later work).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // threads (rows) per block
constexpr int kColTile = 2048;  // columns staged in shared memory per step

template <int W, bool JOINT>
__global__ void __launch_bounds__(kRows)
knn_smallest_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const unsigned char* __restrict__ mask, int P, int kb,
                    float* __restrict__ knn_out, int* __restrict__ cnt_out) {
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

  for (int c0 = 0; c0 < P; c0 += kColTile) {
    const int n = min(kColTile, P - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      sx[j] = xs[c0 + j];
      sy[j] = ys[c0 + j];
      sm[j] = ms[c0 + j];
    }
    __syncthreads();
    if (mi) {
      for (int jj = 0; jj < n; ++jj) {
        if (!sm[jj] || c0 + jj == i) continue;
        const float dy = fabsf(yi - sy[jj]);
        float d;
        if (JOINT) {
          const float dx = fabsf(xi - sx[jj]);
          d = (isnan(dx) || isnan(dy)) ? NAN : fmaxf(dx, dy);
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

  if (row) {
    float* out = knn_out + (base + i) * static_cast<size_t>(kb);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s < kb) out[s] = buf[s];
    }
    cnt_out[base + i] = cnt;
  }
}

template <bool ALL>
__global__ void __launch_bounds__(kRows)
ball_counts_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ r_in, int P,
                   int* __restrict__ counts_out, size_t plane) {
  extern __shared__ unsigned char smem[];
  float* sy = reinterpret_cast<float*>(smem);
  float* sx = sy + kColTile;  // staged only when ALL
  unsigned char* sm = reinterpret_cast<unsigned char*>(sx + kColTile);

  const size_t base = static_cast<size_t>(blockIdx.x) * P;
  const float* ys = y + base;
  const unsigned char* ms = mask + base;
  const int i = blockIdx.y * kRows + threadIdx.x;
  const bool row = i < P;
  const float yi = row ? ys[i] : 0.f;
  const float xi = (ALL && row) ? x[base + i] : 0.f;
  const bool mi = row && ms[i] != 0;
  const float r = row ? r_in[base + i] : 0.f;

  int x_lt = 0, y_lt = 0, x_eq = 0, y_eq = 0, j_eq = 0;
  for (int c0 = 0; c0 < P; c0 += kColTile) {
    const int n = min(kColTile, P - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      sy[j] = ys[c0 + j];
      sm[j] = ms[c0 + j];
      if (ALL) sx[j] = x[base + c0 + j];
    }
    __syncthreads();
    if (mi) {
      for (int jj = 0; jj < n; ++jj) {
        if (!sm[jj] || c0 + jj == i) continue;
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
    counts_out[o] = x_lt;
    counts_out[plane + o] = y_lt;
    counts_out[2 * plane + o] = x_eq;
    counts_out[3 * plane + o] = y_eq;
    counts_out[4 * plane + o] = j_eq;
  }
}

constexpr size_t kShmem = kColTile * (2 * sizeof(float) + 1);

template <int W, bool JOINT>
void launch_knn(const float* x, const float* y, const unsigned char* mask,
                int B, int P, int kb, float* knn, int* cnt,
                cudaStream_t stream) {
  const dim3 grid(B, (P + kRows - 1) / kRows);
  knn_smallest_kernel<W, JOINT><<<grid, kRows, kShmem, stream>>>(
      x, y, mask, P, kb, knn, cnt);
}

template <bool JOINT>
int dispatch_width(const float* x, const float* y, const unsigned char* mask,
                   int B, int P, int kb, float* knn, int* cnt,
                   cudaStream_t s) {
  if (kb <= 4) {
    launch_knn<4, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else if (kb <= 8) {
    launch_knn<8, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else if (kb <= 16) {
    launch_knn<16, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else if (kb <= 32) {
    launch_knn<32, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else if (kb <= 64) {
    launch_knn<64, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else if (kb <= 128) {
    launch_knn<128, JOINT>(x, y, mask, B, P, kb, knn, cnt, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes.  Returns cudaGetLastError() after the launch
// (0 on success); a refused launch never runs, so the caller must check it.
//
// x, y: float32 (B, P); mask: bool (B, P); knn: float32 (B, P, kb); cnt:
// int32 (B, P).  joint selects the mode; 1 <= kb <= 128.
extern "C" int knn_smallest_launch(const float* x, const float* y,
                                   const unsigned char* mask, int B, int P,
                                   int kb, int joint, float* knn, int* cnt,
                                   void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (kb < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return joint ? dispatch_width<true>(x, y, mask, B, P, kb, knn, cnt, s)
               : dispatch_width<false>(x, y, mask, B, P, kb, knn, cnt, s);
}

// x: float32 (B, P), or null when all is 0 (never read then); y, r:
// float32 (B, P); mask: bool (B, P); counts: int32 (5, B, P).
extern "C" int ball_counts_launch(const float* x, const float* y,
                                  const unsigned char* mask, const float* r,
                                  int B, int P, int all, int* counts,
                                  void* stream) {
  if (B <= 0 || P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, (P + kRows - 1) / kRows);
  const size_t plane = static_cast<size_t>(B) * static_cast<size_t>(P);
  if (all) {
    ball_counts_kernel<true><<<grid, kRows, kShmem, s>>>(x, y, mask, r, P,
                                                         counts, plane);
  } else {
    ball_counts_kernel<false><<<grid, kRows, kShmem, s>>>(x, y, mask, r, P,
                                                          counts, plane);
  }
  return static_cast<int>(cudaGetLastError());
}
