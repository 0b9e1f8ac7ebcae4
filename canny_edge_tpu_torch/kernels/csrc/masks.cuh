// Shared by the hysteresis kernels K2, K3 and K4 (hysteresis_packed.cu,
// hysteresis_dilate.cu, hysteresis_banded.cu): the bit operations of the
// floods and, for K3 and K4, the threshold-and-pack pass that turns an NMS
// map into packed masks and the unpack pass that turns a packed edge mask
// into int16 {0, 255}.
//
// Packed layout: (H, ceil(W/32)) uint32, bit b of word j is column 32j + b;
// the bits past W are 0, so they are never weak and never join an edge.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace masks {

constexpr int PACK_THREADS = 256;    // 8 words a block, one warp a word
constexpr int UNPACK_THREADS = 256;

// weak = nm >= lo, seed = nm >= hi, compared signed; one warp per word
template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const T* __restrict__ nm, int H, int W, int lo, int hi,
            uint32_t* __restrict__ weak, uint32_t* __restrict__ seed) {
  const int wd = (W + 31) / 32;
  const long long word =
      (long long)blockIdx.x * (PACK_THREADS / 32) + threadIdx.x / 32;
  if (word >= (long long)H * wd) return;     // the same for the whole warp
  const int r = (int)(word / wd);
  const int c = (int)(word % wd) * 32 + (threadIdx.x & 31);
  const int v = c < W ? (int)nm[(size_t)r * W + c] : INT_MIN;
  const uint32_t bw = __ballot_sync(0xffffffffu, c < W && v >= lo);
  const uint32_t bs = __ballot_sync(0xffffffffu, c < W && v >= hi);
  if ((threadIdx.x & 31) == 0) {
    weak[word] = bw;
    seed[word] = bs;
  }
}

__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_kernel(const uint32_t* __restrict__ e, int H, int W,
              int16_t* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * UNPACK_THREADS + threadIdx.x;
  if (i >= (size_t)H * W) return;
  const int r = (int)(i / W), c = (int)(i % W);
  const uint32_t word = e[(size_t)r * ((W + 31) / 32) + c / 32];
  out[i] = ((word >> (c & 31)) & 1u) ? 255 : 0;
}

// nm: int16 (nm_bytes 2) or int32 (4), (H, W) row-major
inline cudaError_t launch_pack(const void* nm, int nm_bytes, int H, int W,
                               int lo, int hi, void* weak, void* seed,
                               cudaStream_t stream) {
  if (H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const long long words = (long long)H * ((W + 31) / 32);
  constexpr int per_block = PACK_THREADS / 32;
  const unsigned blocks = (unsigned)((words + per_block - 1) / per_block);
  if (nm_bytes == 2)
    pack_kernel<int16_t><<<blocks, PACK_THREADS, 0, stream>>>(
        (const int16_t*)nm, H, W, lo, hi, (uint32_t*)weak, (uint32_t*)seed);
  else if (nm_bytes == 4)
    pack_kernel<int32_t><<<blocks, PACK_THREADS, 0, stream>>>(
        (const int32_t*)nm, H, W, lo, hi, (uint32_t*)weak, (uint32_t*)seed);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

inline cudaError_t launch_unpack(const void* e, int H, int W, void* out,
                                 cudaStream_t stream) {
  if (H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const size_t n = (size_t)H * W;
  unpack_kernel<<<(unsigned)((n + UNPACK_THREADS - 1) / UNPACK_THREADS),
                  UNPACK_THREADS, 0, stream>>>((const uint32_t*)e, H, W,
                                               (int16_t*)out);
  return cudaGetLastError();
}

// the largest dynamic shared memory a block of this device may opt in to
inline int smem_optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// one row of packed words dilated by one column each way (8-neighbourhood
// row term): l, m, r are the words left of, at and right of the column
__device__ __forceinline__ uint32_t hrow(uint32_t l, uint32_t m, uint32_t r) {
  return m | (m << 1) | (l >> 31) | (m >> 1) | (r << 31);
}

// x_b = x_b | (w_b & x_{b-1}) with x_{-1} = carry: seeds x spread toward
// higher bits through the weak bits w.  The sum (w|x) + x + carry generates a
// carry at every seed and propagates it through weak bits, so the carry into
// bit b is x_{b-1}; carry becomes the carry out of bit 31.
__device__ __forceinline__ uint32_t run_fill(uint32_t w, uint32_t x,
                                             uint32_t& carry) {
  const uint32_t a = w | x;
  const uint64_t sum = (uint64_t)a + x + carry;
  const uint32_t cvec = (uint32_t)sum ^ a ^ x;
  carry = (uint32_t)(sum >> 32);
  return x | (w & cvec);
}

// the same toward lower bits (carry in at bit 31, out of bit 0)
__device__ __forceinline__ uint32_t run_fill_down(uint32_t w, uint32_t x,
                                                  uint32_t& carry) {
  return __brev(run_fill(__brev(w), __brev(x), carry));
}

}  // namespace masks
