// K1: the Canny front end on Hopper -- uint8 image -> NMS magnitude, or the
// bit-packed weak/strong hysteresis masks.
//
// Replaces the Pallas front-end kernels of canny_edge_tpu/kernels/frontend.py
// (the element-indexed `kern` with its border strips, and `_frontend_kernel`)
// and the fused threshold/pack tail of ops/window.py:frontend_nm_static,
// which on the TPU ran in XLA.  Plain version: ops/window.py:frontend_nm.
//
// Design: one block per 32x64 output tile.  The uint8 tile and its halo
// (r = c + 2 texels, c = window / 2) go to shared memory; the x-pass, the
// y-pass, the Sobel magnitude and the NMS each run over shared memory with a
// __syncthreads() between them, so no intermediate touches device memory.
// Borders are resolved per pixel from global coordinates (no maskless
// interior / border strip split).  In packed mode each warp covers 32
// adjacent output columns starting at a multiple of 32, so one
// __ballot_sync is exactly one packed word.
//
// Bound: at 1080p the kernel reads 2.07 MB and writes 0.52 MB (packed) --
// under 1 us of HBM time -- while the 11-tap separable blur, Sobel and NMS
// cost ~100 float/int operations per pixel, so arithmetic (and the halo
// recomputation, ~1.5x at window 11) bounds it.
//
// Exactness: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, and the build passes --fmad=false), taps accumulate in
// ascending order, the renormalization divide is __fdiv_rn, and the back
// half is integer arithmetic.  The result is bit-identical to the plain
// version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 64;
constexpr int THREADS = 256;
constexpr int MAX_WINDOW = 31;
constexpr int NMS_OOB = -32768;

struct Layout {
  int r, in_h, in_w, t_w, sm_h, mag_h, mag_w;
  __host__ __device__ explicit Layout(int window) {
    r = window / 2 + 2;
    in_h = TILE_H + 2 * r;
    in_w = TILE_W + 2 * r;
    t_w = TILE_W + 4;        // x-pass / sm columns: [col0 - 2, col0 + 66)
    sm_h = TILE_H + 4;       // sm rows: [row0 - 2, row0 + 34)
    mag_h = TILE_H + 2;      // mag rows: [row0 - 1, row0 + 33)
    mag_w = TILE_W + 2;
  }
  __host__ __device__ size_t bytes() const {
    size_t floats = MAX_WINDOW + t_w + sm_h + (size_t)in_h * t_w
                    + (size_t)sm_h * t_w;
    return floats * 4 + (size_t)mag_h * mag_w * 4 + (size_t)in_h * in_w;
  }
};

__device__ __forceinline__ int isqrt_exact(int n) {
  int k = (int)__fsqrt_rn((float)n);
  if ((k + 1) * (k + 1) <= n) k += 1;
  if (k * k > n) k -= 1;
  return k;
}

__global__ void __launch_bounds__(THREADS)
frontend_kernel(const uint8_t* __restrict__ img, int H, int W,
                const float* __restrict__ taps, int window, int packed,
                int mn, int mx, int16_t* __restrict__ nm_out,
                uint32_t* __restrict__ weak, uint32_t* __restrict__ strong) {
  extern __shared__ float smem[];
  const Layout L(window);
  const int c = window / 2;
  const int r = L.r;
  const int row0 = blockIdx.y * TILE_H;
  const int col0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.x;

  float* k = smem;
  float* cnt_x = k + MAX_WINDOW;
  float* cnt_y = cnt_x + L.t_w;
  float* tmp = cnt_y + L.sm_h;
  float* sm = tmp + L.in_h * L.t_w;
  int* mag = reinterpret_cast<int*>(sm + L.sm_h * L.t_w);
  uint8_t* in = reinterpret_cast<uint8_t*>(mag + L.mag_h * L.mag_w);

  // ---- load taps and the zero-padded uint8 tile with its halo ----
  if (tid < window) k[tid] = taps[tid];
  for (int i = tid; i < L.in_h * L.in_w; i += THREADS) {
    const int gr = row0 - r + i / L.in_w;
    const int gc = col0 - r + i % L.in_w;
    in[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? img[(size_t)gr * W + gc]
                                                      : 0;
  }
  __syncthreads();

  // ---- renormalization divisors: tap-order f32 sums of in-image weights ----
  for (int j = tid; j < L.t_w + L.sm_h; j += THREADS) {
    const bool is_x = j < L.t_w;
    const int g = is_x ? col0 - 2 + j : row0 - 2 + (j - L.t_w);
    const int n = is_x ? W : H;
    float s = 0.0f;
    for (int t = 0; t < window; ++t) {
      const int q = g + t - c;
      if (q >= 0 && q < n) s = __fadd_rn(s, k[t]);
    }
    (is_x ? cnt_x[j] : cnt_y[j - L.t_w]) = s;
  }
  __syncthreads();

  // ---- blur x-pass: rows [row0 - r, row0 + 32 + r), cols [col0-2, col0+66) ----
  for (int i = tid; i < L.in_h * L.t_w; i += THREADS) {
    const int y = i / L.t_w, x = i % L.t_w;
    const int gr = row0 - r + y, gc = col0 - 2 + x;
    float v = 0.0f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      const uint8_t* src = in + y * L.in_w + x;   // tap t reads col x + t
      float acc = 0.0f;
      for (int t = 0; t < window; ++t)
        acc = __fadd_rn(acc, __fmul_rn((float)src[t], k[t]));
      v = __fdiv_rn(acc, cnt_x[x]);
    }
    tmp[i] = v;
  }
  __syncthreads();

  // ---- blur y-pass + floor: rows [row0 - 2, row0 + 34) ----
  for (int i = tid; i < L.sm_h * L.t_w; i += THREADS) {
    const int y = i / L.t_w, x = i % L.t_w;
    const int gr = row0 - 2 + y, gc = col0 - 2 + x;
    float v = 0.0f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      const float* src = tmp + y * L.t_w + x;     // tap t reads row y + t
      float acc = 0.0f;
      for (int t = 0; t < window; ++t)
        acc = __fadd_rn(acc, __fmul_rn(src[t * L.t_w], k[t]));
      v = floorf(__fdiv_rn(acc, cnt_y[y]));
    }
    sm[i] = v;
  }
  __syncthreads();

  // Sobel with the reference border rules at global (gr, gc), in the image
  auto S = [&](int R, int C) {
    return (int)sm[(R - row0 + 2) * L.t_w + (C - col0 + 2)];
  };
  auto grad = [&](int gr, int gc, int& gx, int& gy) {
    const int cl = max(gc - 1, 0), cr = min(gc + 1, W - 1);
    const int ru = max(gr - 1, 0), rd = min(gr + 1, H - 1);
    gx = 2 * (S(gr, cr) - S(gr, cl));
    if (gr + 1 < H) gx += S(gr + 1, cr) - S(gr + 1, cl);
    if (gr - 1 >= 0) gx += S(gr - 1, cr) - S(gr - 1, cl);
    gy = 2 * (S(rd, gc) - S(ru, gc));
    if (gc + 1 < W) gy += S(rd, gc + 1) - S(ru, gc + 1);
    if (gc - 1 >= 0) gy += S(rd, gc - 1) - S(ru, gc - 1);
  };

  // ---- magnitude on [row0-1, row0+33) x [col0-1, col0+65); off-image = OOB ----
  for (int i = tid; i < L.mag_h * L.mag_w; i += THREADS) {
    const int gr = row0 - 1 + i / L.mag_w, gc = col0 - 1 + i % L.mag_w;
    int m = NMS_OOB;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      int gx, gy;
      grad(gr, gc, gx, gy);
      m = isqrt_exact(gx * gx + gy * gy);
    }
    mag[i] = m;
  }
  __syncthreads();

  // ---- NMS + output: warp w takes 32-column half-rows w, w+8, ... ----
  const int lane = tid & 31, warp = tid >> 5;
  const int wd = (W + 31) / 32;
  for (int q = warp; q < TILE_H * (TILE_W / 32); q += THREADS / 32) {
    const int y = q / (TILE_W / 32);
    const int x = (q % (TILE_W / 32)) * 32 + lane;
    const int gr = row0 + y, gc = col0 + x;
    const bool inside = gr < H && gc < W;
    int val = 0;
    if (inside) {
      int gx, gy;
      grad(gr, gc, gx, gy);
      auto nb = [&](int dr, int dc) {
        return mag[(y + 1 + dr) * L.mag_w + (x + 1 + dc)];
      };
      const int m0 = nb(0, 0);
      const int ax = abs(gx), ay = abs(gy);
      const int diff2 = (ax - ay) * (ax - ay);
      const bool low = ax > ay && 2 * ay * ay < diff2;
      const bool high = ay > ax && diff2 > 2 * ax * ax;
      const int sp = gx * gy;
      int thr;
      if (high) thr = max(nb(-1, 0), nb(1, 0));
      else if (low || sp == 0) thr = max(nb(0, -1), nb(0, 1));
      else if (sp > 0) thr = max(nb(-1, 1), nb(1, -1));
      else thr = max(nb(-1, -1), nb(1, 1));
      val = m0 > thr ? m0 : 0;
    }
    if (packed) {
      const unsigned bw = __ballot_sync(0xffffffffu, inside && val >= mn);
      const unsigned bs = __ballot_sync(0xffffffffu, inside && val >= mx);
      const int word = (col0 + (x - lane)) / 32;
      if (lane == 0 && gr < H && word < wd) {
        weak[(size_t)gr * wd + word] = bw;
        strong[(size_t)gr * wd + word] = bs;
      }
    } else if (inside) {
      nm_out[(size_t)gr * W + gc] = (int16_t)val;
    }
  }
}

}  // namespace

extern "C" {

int canny_frontend_max_window() { return MAX_WINDOW; }

// img: uint8 (H, W); taps: float32 (window); packed == 0 -> nm_out int16
// (H, W); packed != 0 -> weak/strong uint32 (H, ceil(W/32)).  Launches on
// `stream` and returns cudaGetLastError().
int canny_frontend(const void* img, int H, int W, const void* taps, int window,
                   int packed, int mn, int mx, void* nm_out, void* weak,
                   void* strong, void* stream) {
  if (H <= 0 || W <= 0 || window < 1 || window > MAX_WINDOW || window % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const Layout L(window);
  const size_t smem = L.bytes();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  frontend_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, H, W, (const float*)taps, window, packed, mn, mx,
      (int16_t*)nm_out, (uint32_t*)weak, (uint32_t*)strong);
  return (int)cudaGetLastError();
}

}  // extern "C"
