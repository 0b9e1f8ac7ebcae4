// The CUDA subset the port's kernels use, emulated on the CPU: each thread
// of a block is a fiber (ucontext) that runs until it reaches a barrier.
// Included first in a kernel source that tools/cuda_emu.py has rewritten
// (launches, inline asm and the dynamic shared memory replaced).
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3_ { unsigned x, y, z; };
extern uint3_ threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
// each operation rounded on its own, as with --fmad=false on the card
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __int_as_float(int a) { float f; memcpy(&f, &a, 4); return f; }
inline int __float_as_int(float a) { int i; memcpy(&i, &a, 4); return i; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) { memcpy(d, s, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

void __syncthreads();
unsigned __ballot_sync(unsigned mask, bool pred);
void emu_bar_sync(int id, int n);
void emu_bar_arrive(int id, int n);

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorLaunchOutOfResources = 701 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin,
                      cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes { size_t sharedSizeBytes; int numRegs; };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int d) {
  return d == 0 ? cudaSuccess : cudaErrorInvalidDevice;
}
extern int emu_error;
inline cudaError_t cudaGetLastError() { int e = emu_error; emu_error = 0; return e; }
int emu_attr(cudaDeviceAttr a);
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = emu_attr(a);
  return cudaSuccess;
}
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  a->sharedSizeBytes = 0;
  a->numRegs = 64;
  return cudaSuccess;
}
int emu_blocks_per_sm();
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = emu_blocks_per_sm();
  return cudaSuccess;
}

extern unsigned char emu_smem[];
void emu_run(dim3 grid, int threads, size_t smem, std::function<void()> body);
template <class K, class... A>
void emu_launch(dim3 g, dim3 t, size_t s, cudaStream_t, K k, A... a) {
  emu_run(g, (int)t.x, s, [=]() { k(a...); });
}
