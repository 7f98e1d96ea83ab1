// Fused MurmurHash3 (x86, 32-bit) + Fibonacci hashing of key words (sm_90a).
//
// Replaces: repro/kernels/murmur3/kernel.py::murmur3_fib_2d (the Pallas TPU
// kernel, body _murmur_fib_kernel), behind repro.kernels.murmur3.ops.hash_keys.
//
// What it computes, per element i: h = MurmurHash3_x86_32 of the one
// 4-byte little-endian word keys[i] with seed seeds[i] (or one scalar
// seed), followed by its fmix finalizer; then, when fib is set, the
// Fibonacci multiply h * 0x9E3779B9 mod 2^32.  The port carries uint32
// words as int64, zero-extended, so the kernel reads and writes int64 and
// works on the low 32 bits in uint32 registers, where multiplies wrap.
//
// Bound: bytes.  Per element it reads 8 bytes of key (and 8 of seed when
// seeds are per element) and writes 8 bytes of hash, against about 20
// integer operations: at 3.35 TB/s and 16.75 T int32 instructions/s the
// bytes take several times longer.
// Design: the TPU kernel hashed (256, 128) VMEM tiles of a padded key
// array.  Here one thread hashes one element per step of a grid-stride
// loop, so any n runs with no padding, and neighbouring threads read and
// write neighbouring words (coalesced).  The seed mode and the Fibonacci
// step are template parameters, so the loop has no branches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM; the loop strides

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

template <bool PER_ELEMENT_SEED, bool FIB>
__global__ void __launch_bounds__(kThreads)
murmur3_fib_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ seeds, uint32_t seed,
                   int64_t n, int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t k = static_cast<uint32_t>(keys[i]);
    uint32_t h = PER_ELEMENT_SEED ? static_cast<uint32_t>(seeds[i]) : seed;

    k *= 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;

    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;

    h ^= 4u;  // length in bytes
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    if (FIB) h *= 0x9E3779B9u;
    out[i] = static_cast<int64_t>(h);  // zero-extended
  }
}

template <bool PER_ELEMENT_SEED, bool FIB>
void launch(const int64_t* keys, const int64_t* seeds, uint32_t seed,
            int64_t n, int64_t* out, cudaStream_t stream) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  murmur3_fib_kernel<PER_ELEMENT_SEED, FIB>
      <<<blocks, kThreads, 0, stream>>>(keys, seeds, seed, n, out);
}

}  // namespace

// Plain C entry for ctypes.  keys: int64 (n,) holding uint32 words;
// seeds: int64 (n,), or null to use the scalar seed for every key; out:
// int64 (n,).  fib selects the Fibonacci step.  Returns
// cudaGetLastError() after the launch (0 on success); a refused launch
// never runs, so the caller must check it.
extern "C" int murmur3_fib_launch(const int64_t* keys, const int64_t* seeds,
                                  uint32_t seed, int64_t n, int fib,
                                  int64_t* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seeds != nullptr) {
    if (fib) launch<true, true>(keys, seeds, seed, n, out, s);
    else launch<true, false>(keys, seeds, seed, n, out, s);
  } else {
    if (fib) launch<false, true>(keys, seeds, seed, n, out, s);
    else launch<false, false>(keys, seeds, seed, n, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
