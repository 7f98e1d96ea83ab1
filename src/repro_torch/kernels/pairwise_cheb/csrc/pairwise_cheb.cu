// Pairwise Chebyshev matrices for a batch of padded samples (sm_90a).
//
// Replaces: repro/kernels/pairwise_cheb/kernel.py::pairwise_cheb_padded
// (the Pallas TPU kernel, body _cheb_kernel), which serves every
// estimator's impl="materialized" path: the service's non-finite-lane
// fence recomputes a demoted lane through it.
//
// What it computes, per sample b of a padded batch (x, y, mask), (B, P):
//   DX[b, i, j] = |x_i - x_j|,  DY[b, i, j] = |y_i - y_j|,
//   DJ[b, i, j] = max(DX, DY) with DJ[b, i, i] = +inf,
// and +inf in all three wherever row i or column j is invalid.  The max
// propagates NaN (a NaN in either marginal gives NaN), as jnp.maximum
// and torch.maximum do; CUDA's fmaxf would drop it, so it is written out.
// inf - inf gives NaN, as on the reference side.
//
// Bound: bytes.  The function reads 9 bytes per row (x, y float32, mask
// u8) and writes 12 bytes per (i, j) pair (three float32 matrices); at
// P=256 a 2048-sample chunk writes 1.61 GB, 0.48 ms at 3.35 TB/s.  The
// arithmetic (two subtractions, two abs, a max, a few selects per pair)
// is far below the store rate.
// Design: the TPU kernel tiled one sample's (n, n) output into (bm, bn)
// VMEM blocks on a sequential grid.  Here B rides grid x (B exceeds
// grid y's 65535 limit), and each block covers a 32 x 32 tile of one
// sample: 32 threads along j, so every store of a warp is one coalesced
// 128-byte line per matrix, and rows of threads that step through the
// tile's 32 rows: the launch's rung of them (4, 8, 16 or 32; 8 unless the
// autotuner picks another: each element is computed alone, so no rung
// changes an output bit).  A thread keeps its column's x_j, y_j and mask in
// registers; the row values are one broadcast load per warp.  Nothing
// is staged in shared memory: each input is read once per tile from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // rows and columns of one output tile
constexpr int kMaxRowStep = 32;  // thread rows per block, at most
// The rungs of a launch's thread rows per block (kernel.py: ROW_STEPS).
constexpr int kRowSteps[] = {4, 8, 16, 32};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__global__ void __launch_bounds__(kTile * kMaxRowStep)
pairwise_cheb_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const unsigned char* __restrict__ mask, int P,
                     float* __restrict__ dx_out, float* __restrict__ dy_out,
                     float* __restrict__ dj_out) {
  const size_t b = blockIdx.x;
  const int j = blockIdx.z * kTile + threadIdx.x;
  if (j >= P) return;
  const float* xs = x + b * P;
  const float* ys = y + b * P;
  const unsigned char* ms = mask + b * P;
  const float xj = xs[j];
  const float yj = ys[j];
  const bool mj = ms[j] != 0;
  const size_t base = b * static_cast<size_t>(P) * P;
  const int i_end = min(P, static_cast<int>(blockIdx.y + 1) * kTile);
  for (int i = blockIdx.y * kTile + threadIdx.y; i < i_end; i += blockDim.y) {
    const bool valid = mj && ms[i] != 0;
    const float dx = valid ? fabsf(xs[i] - xj) : INFINITY;
    const float dy = valid ? fabsf(ys[i] - yj) : INFINITY;
    const float dj = (i == j) ? INFINITY : max_nan(dx, dy);
    const size_t o = base + static_cast<size_t>(i) * P + j;
    dx_out[o] = dx;
    dy_out[o] = dy;
    dj_out[o] = dj;
  }
}

}  // namespace

// Plain C entry for ctypes.  x, y: float32 (B, P); mask: bool (B, P);
// dx, dy, dj: float32 (B, P, P); row_step: thread rows per block, one of
// kRowSteps (off it the launch is refused: no clamp).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a row_step off the ladder; a refused launch
// never runs, so the caller must check it.
extern "C" int pairwise_cheb_launch(const float* x, const float* y,
                                    const unsigned char* mask, int B, int P,
                                    float* dx, float* dy, float* dj,
                                    int row_step, void* stream) {
  bool on_ladder = false;
  for (int v : kRowSteps) on_ladder |= v == row_step;
  if (!on_ladder) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || P <= 0) return 0;
  const int tiles = (P + kTile - 1) / kTile;
  const dim3 grid(B, tiles, tiles);
  const dim3 block(kTile, row_step);
  pairwise_cheb_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, mask, P, dx, dy, dj);
  return static_cast<int>(cudaGetLastError());
}
