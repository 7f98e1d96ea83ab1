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
// NaN: a NaN distance is never selected (the insertion test d < buf[W-1]
// is false for it, and the joint distance propagates NaN from either
// marginal, as jnp.maximum does), and every count condition is false
// for NaN (the tie count tests dx <= 0 && dy <= 0, which equals
// max(dx, dy) <= 0 without fmaxf's NaN dropping).  ref.py follows the
// same rule.  Parity with the JAX package is claimed for finite inputs.
//
// Bound: ALU work.  The function needs, per valid pair (i, j != i), one
// distance evaluation, the compare against the running order statistic
// and the count compares and adds: 16 operations in joint mode with all
// five counts (10 float, 6 integer), at most P^2 pairs per sample, while
// the bytes are B*P*(9 in + 28 out) -- negligible.  This design
// evaluates each distance twice (one sweep to select, one to count).
// Design: one block per (sample, 128-row tile), one thread per row.  The
// sample's x, y and mask are staged in shared memory in column tiles, so
// every pair reads shared memory only and the distance arithmetic is the
// whole cost.  Each thread keeps a sorted buffer of the W smallest
// distances (W = the smallest of 4..128 that is >= the order statistic
// needed), updated by a branch-free min/max bubble only when a distance
// beats the current W-th; at k = 3 the buffer lives in registers.  A
// second sweep over the same column tiles counts at the radius.  Warp-
// cooperative selection and several samples per block are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // threads (rows) per block
constexpr int kColTile = 2048;  // columns staged in shared memory per step

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
void launch(const float* x, const float* y, const unsigned char* mask, int B,
            int P, int k, int kb, int kk, float* r, int* cnt, int* counts,
            cudaStream_t stream) {
  const dim3 grid(B, (P + kRows - 1) / kRows);
  const size_t shmem = kColTile * (2 * sizeof(float) + 1);
  radius_counts_kernel<W, JOINT, ALL><<<grid, kRows, shmem, stream>>>(
      x, y, mask, P, k, kb, kk, r, cnt, counts,
      static_cast<size_t>(B) * static_cast<size_t>(P));
}

template <bool JOINT, bool ALL>
int dispatch_width(int need, const float* x, const float* y,
                   const unsigned char* mask, int B, int P, int k, int kb,
                   int kk, float* r, int* cnt, int* counts,
                   cudaStream_t stream) {
  if (need <= 4) {
    launch<4, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else if (need <= 8) {
    launch<8, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else if (need <= 16) {
    launch<16, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else if (need <= 32) {
    launch<32, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else if (need <= 64) {
    launch<64, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else if (need <= 128) {
    launch<128, JOINT, ALL>(x, y, mask, B, P, k, kb, kk, r, cnt, counts, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  x, y: float32 (B, P); mask: bool (B, P);
// r: float32 (B, P); cnt: int32 (B, P); counts: int32 (5, B, P).  joint
// selects the mode, all the count set.  Returns cudaGetLastError() after
// the launch (0 on success); a refused launch never runs, so the caller
// must check it.
extern "C" int radius_counts_launch(const float* x, const float* y,
                                    const unsigned char* mask, int B, int P,
                                    int k, int kb, int kk, int joint, int all,
                                    float* r, int* cnt, int* counts,
                                    void* stream) {
  if (B <= 0 || P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = joint ? k : kb;
  if (joint) {
    return all ? dispatch_width<true, true>(need, x, y, mask, B, P, k, kb, kk,
                                            r, cnt, counts, s)
               : dispatch_width<true, false>(need, x, y, mask, B, P, k, kb, kk,
                                             r, cnt, counts, s);
  }
  return all ? dispatch_width<false, true>(need, x, y, mask, B, P, k, kb, kk,
                                           r, cnt, counts, s)
             : dispatch_width<false, false>(need, x, y, mask, B, P, k, kb, kk,
                                            r, cnt, counts, s);
}
