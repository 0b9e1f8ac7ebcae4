// K1: the Canny front end on Hopper -- uint8 image -> NMS magnitude, or the
// bit-packed weak/strong hysteresis masks.
//
// Replaces the Pallas front-end kernels of canny_edge_tpu/kernels/frontend.py
// (the element-indexed `kern` with its border strips, and `_frontend_kernel`)
// and the fused threshold/pack tail of ops/window.py:frontend_nm_static,
// which on the TPU ran in XLA.  Plain versions: ops/window.py:frontend_nm
// (a whole image) and ops/window.py:frontend_block (block mode).
//
// Bound: at 1080p the kernel reads 2.07 MB and writes 0.52 MB (packed), under
// 1 us of HBM time, while the separable blur, Sobel, integer square root and
// NMS cost ~(4 * window + 45) float/int operations a pixel, none of which may
// be fused into an FMA: the rate at which an SM dispatches instructions
// bounds it, so the design is about few instructions per pixel.
//
// Design: one block of 256 threads per 64x64 output tile, every stage in
// shared memory, no intermediate in device memory.
//   load    the uint8 tile with its halo (window/2 + 2 texels), zero filled
//           off the image; 16-byte cp.async where the row address allows
//           (W a multiple of 16, chunk inside the image), else byte loads;
//   x-pass  the window is a template parameter (3..15; one generic
//           instantiation takes any other odd window, its halo, shared tile
//           and divisor buffer sized from the window at launch, up to what
//           a block's shared memory holds).  A thread loads its row segment
//           as 32-bit words,
//           converts each byte once and emits 8 adjacent outputs from a
//           register window, taps in registers, fully unrolled;
//   y-pass  a thread emits 4 outputs down a column from window + 3 floats
//           in registers; the floored blur stays a float;
//   Sobel   a thread emits 4 adjacent pixels from a 3x6 register patch, in
//           float arithmetic that is exact on these small integers (the
//           float pipe has twice the integer pipe's rate): the exact
//           integer magnitude with the 2-bit NMS direction in one int16, so
//           the direction is decided once;
//   NMS     a warp walks 16 rows of one 32-column word: one compare
//           against the two neighbours the direction names (their offset
//           from a 4-entry table), one compare per threshold; the columns
//           start at a multiple of 32, so one __ballot_sync is one packed
//           word.
// A 64x64 tile recomputes 1.36x (x-pass) and 1.20x (y-pass) at window 11.
// The renormalization divisors (the float32 tap-order sums of the in-image
// weights) are built once per block per axis; off-image texels are zeros and
// add +0.0, so the passes carry no border predicate.  Tiles whose Sobel
// neighbourhood lies inside the image (a block-uniform test) skip the
// clamp/drop border rules of the gradient; the others keep them per pixel.
//
// Block mode: the input may be a window of a larger image, a block of
// (OH, OW) output pixels with a margin of `halo` texels around it, whose
// output pixel (0, 0) is pixel (row0, col0) of an (H, W) image.  Loads,
// divisors, the Sobel border rules, NMS's off-image neighbours and the
// masks all read global coordinates; window texels past the image are read
// as 0 and output pixels past it are 0 in the map and clear in the masks.
// The whole image is the case halo = 0, (row0, col0) = (0, 0), (OH, OW) =
// (H, W): one kernel body for both.
//
// Exactness: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, and the build passes --fmad=false), taps accumulate in
// ascending order, the renormalization divide is __fdiv_rn, and the back
// half computes on integers (held in floats only where every result is an
// integer below 2^24, so nothing rounds).  The result is bit-identical to
// the plain version.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "masks.cuh"

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 64;
constexpr int THREADS = 256;
constexpr int XR = 8;                // x-pass outputs a thread
constexpr int YR = 4;                // y-pass outputs a thread
constexpr int XW = TILE_W + 8;       // x-pass columns [col0 - 4, col0 + 68)
constexpr int SM_H = TILE_H + 4;     // blurred rows [row0 - 2, row0 + 66)
constexpr int MAG_H = TILE_H + 2;    // magnitude rows [row0 - 1, row0 + 65)
constexpr int MAG_W = TILE_W + 4;    // magnitude cols [col0 - 3, col0 + 65)
constexpr int MAG_OOB = -4;          // off-image magnitude: -1 with direction 0

static_assert(XW % XR == 0 && SM_H % YR == 0 && MAG_W % 4 == 0, "geometry");

// The shared-memory layout of a window: its half-width c, the input tile with
// its halo, the x-pass buffer (the magnitudes reuse it), the blurred tile and
// the divisors and taps.
struct Geo {
  int c, org, in_w, in_h, in_bytes, tmp_bytes, sm_bytes, bytes;
};

__host__ __device__ constexpr Geo geo_of(int window) {
  const int c = window / 2;
  // the shared tile starts `org` columns left of the output tile: a multiple
  // of 16, so a 16-byte chunk of the tile is a 16-byte chunk of the image row
  const int org = 4 + c <= 16 ? 16 : (4 + c + 15) / 16 * 16;
  const int in_w = (org + TILE_W + 4 + c + 15) / 16 * 16;
  const int in_h = SM_H + 2 * c;
  const int in_bytes = in_h * in_w;
  const int tmp_bytes = in_h * XW * 4;
  const int sm_bytes = SM_H * XW * 4;
  const int cnt_bytes = (XW + SM_H + window + 3) / 4 * 16;
  return Geo{c, org, in_w, in_h, in_bytes, tmp_bytes, sm_bytes,
             in_bytes + tmp_bytes + sm_bytes + cnt_bytes};
}

static_assert(geo_of(3).tmp_bytes >= MAG_H * MAG_W * 2,
              "magnitudes fit the x-pass buffer");
static_assert(geo_of(3).in_bytes % 16 == 0 && geo_of(3).tmp_bytes % 16 == 0 &&
              geo_of(3).sm_bytes % 16 == 0, "16-byte aligned sections");

constexpr float TWO23 = 8388608.0f;

// magnitude and NMS direction of one gradient in one int16: 4 * magnitude +
// direction; direction 0 compares up/down, 1 left/right, 2 the
// (-1,+1)/(+1,-1) diagonal, 3 the (-1,-1)/(+1,+1) diagonal.
// The gradients are integers below 2^11 held in floats, so every product and
// sum here is an integer below 2^24 and exact: the float pipe (twice the
// integer pipe's rate on this card) does integer arithmetic.  The root is
// the approximate instruction made exact: rounded to an integer by adding
// and subtracting 2^23, then stepped down or up where its square misses.
__device__ __forceinline__ int mag_dir(float gx, float gy) {
  const float n = gx * gx + gy * gy;
  float k;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(k) : "f"(n));
  k = __fadd_rn(__fadd_rn(k, TWO23), -TWO23);
  if (k * k > n) k -= 1.0f;
  if ((k + 1.0f) * (k + 1.0f) <= n) k += 1.0f;
  const float ax = fabsf(gx), ay = fabsf(gy);
  const float diff2 = (ax - ay) * (ax - ay);
  const bool low = ax > ay && 2.0f * ay * ay < diff2;
  const bool high = ay > ax && diff2 > 2.0f * ax * ax;
  const float sp = gx * gy;
  const int dir = high ? 0 : (low || sp == 0.0f) ? 1 : sp > 0.0f ? 2 : 3;
  // the low mantissa bits of k + 2^23 are the integer k
  const int m = __float_as_int(__fadd_rn(k, TWO23)) & 0x7fffff;
  return (m << 2) | dir;
}

// Where the kernel reads and writes: the input window (sh, sw) whose texel
// (halo, halo) is output pixel (0, 0), the (oh, ow) output block, and the
// block's place (row0, col0) in the (H, W) image.
struct Frame {
  const uint8_t* src;
  int sh, sw, halo, oh, ow, row0, col0, H, W;
};

template <int WINDOW>
__global__ void __launch_bounds__(THREADS, 4)
frontend_kernel(Frame f, const float* __restrict__ taps, int window_rt,
                int packed, int mn, int mx, int vec_ok,
                int16_t* __restrict__ nm_out, uint32_t* __restrict__ weak,
                uint32_t* __restrict__ strong) {
  const int window = WINDOW > 0 ? WINDOW : window_rt;
  const Geo G = geo_of(window);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* in = smem_raw;
  float* tmp = reinterpret_cast<float*>(smem_raw + G.in_bytes);
  int16_t* mag = reinterpret_cast<int16_t*>(tmp);
  float* sm = reinterpret_cast<float*>(smem_raw + G.in_bytes + G.tmp_bytes);
  float* cnt_x = reinterpret_cast<float*>(smem_raw + G.in_bytes + G.tmp_bytes
                                          + G.sm_bytes);
  float* cnt_y = cnt_x + XW;           // contiguous with cnt_x
  float* k_s = cnt_y + SM_H;           // the generic window's taps

  const int H = f.H, W = f.W;
  const int c = G.c;
  const int in_h = G.in_h;             // rows [row0 - 2 - c, row0 + 66 + c)
  const int xoff = G.org - 4 - c;      // tile column of x-pass output 0, tap 0
  // the tile's first output pixel, in the block and in the image
  const int ty0 = blockIdx.y * TILE_H, tx0 = blockIdx.x * TILE_W;
  const int row0 = f.row0 + ty0, col0 = f.col0 + tx0;
  const int tid = threadIdx.x;

  float k[WINDOW > 0 ? WINDOW : 1];
  if constexpr (WINDOW > 0) {
#pragma unroll
    for (int t = 0; t < WINDOW; ++t) k[t] = __ldg(taps + t);
  } else {
    k[0] = 0.0f;
    for (int t = tid; t < window; t += THREADS) k_s[t] = taps[t];
  }

  // ---- load: the zero-padded uint8 tile with its halo, 16 bytes a thread;
  //      a texel is read where it lies in the window and in the image ----
  {
    const int ch = G.in_w / 16;
    // window row / column of shared row 0 / column 0
    const int wr0 = ty0 - 2 - c + f.halo, wc0 = tx0 - G.org + f.halo;
    for (int i = tid; i < in_h * ch; i += THREADS) {
      const int y = i / ch, q = i % ch;
      const int wr = wr0 + y, wc = wc0 + 16 * q;
      const int gr = row0 - 2 - c + y, gc = col0 - G.org + 16 * q;
      uint8_t* dst = in + y * G.in_w + 16 * q;
      const bool row_in = wr >= 0 && wr < f.sh && gr >= 0 && gr < H;
      if (vec_ok && row_in && wc >= 0 && wc + 16 <= f.sw && gc >= 0
          && gc + 16 <= W) {
        __pipeline_memcpy_async(dst, f.src + (size_t)wr * f.sw + wc, 16);
      } else {
        uint32_t wds[4] = {0u, 0u, 0u, 0u};
        if (row_in) {
          const uint8_t* src = f.src + (size_t)wr * f.sw;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int cc = wc + b, gcc = gc + b;
            if (cc >= 0 && cc < f.sw && gcc >= 0 && gcc < W)
              wds[b >> 2] |= (uint32_t)src[cc] << (8 * (b & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(wds[0], wds[1], wds[2], wds[3]);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  // ---- renormalization divisors: tap-order f32 sums of in-image weights;
  //      1 off the image, where the quotient is never read ----
  for (int j = tid; j < XW + SM_H; j += THREADS) {
    const bool is_x = j < XW;
    const int g = is_x ? col0 - 4 + j : row0 - 2 + (j - XW);
    const int n = is_x ? W : H;
    float s = 1.0f;
    if (g >= 0 && g < n) {
      s = 0.0f;
      if constexpr (WINDOW > 0) {
#pragma unroll
        for (int t = 0; t < WINDOW; ++t) {
          const int q = g + t - c;
          if (q >= 0 && q < n) s = __fadd_rn(s, k[t]);
        }
      } else {
        for (int t = 0; t < window; ++t) {
          const int q = g + t - c;
          if (q >= 0 && q < n) s = __fadd_rn(s, k_s[t]);
        }
      }
    }
    cnt_x[j] = s;
  }
  __syncthreads();

  // ---- blur x-pass: rows [row0-2-c, row0+66+c), cols [col0-4, col0+68) ----
  for (int i = tid; i < in_h * (XW / XR); i += THREADS) {
    const int y = i / (XW / XR), g = i % (XW / XR);
    float acc[XR];
#pragma unroll
    for (int j = 0; j < XR; ++j) acc[j] = 0.0f;
    if constexpr (WINDOW > 0) {
      constexpr Geo GC = geo_of(WINDOW);
      constexpr int XOFF = GC.org - 4 - WINDOW / 2;
      constexpr int S = XOFF & 3;              // first byte within its word
      constexpr int NV = XR + WINDOW - 1;
      constexpr int NW = (S + NV + 3) / 4;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(in)
                            + y * (GC.in_w / 4) + (XOFF >> 2) + g * (XR / 4);
      uint32_t wv[NW];
#pragma unroll
      for (int m = 0; m < NW; ++m) wv[m] = src[m];
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        v[j] = (float)((wv[(S + j) >> 2] >> (8 * ((S + j) & 3))) & 0xffu);
#pragma unroll
      for (int t = 0; t < WINDOW; ++t)
#pragma unroll
        for (int j = 0; j < XR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j + t], k[t]));
    } else {
      const uint8_t* src = in + y * G.in_w + xoff + g * XR;
      for (int t = 0; t < window; ++t) {
        const float kt = k_s[t];
#pragma unroll
        for (int j = 0; j < XR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn((float)src[j + t], kt));
      }
    }
    // two 16-byte loads of the divisors, two 16-byte stores of the quotients
    static_assert(XR == 8, "the x-pass moves its outputs as two float4");
    const float4* cn = reinterpret_cast<const float4*>(cnt_x + g * XR);
    float4* dst = reinterpret_cast<float4*>(tmp + y * XW + g * XR);
    const float4 c0 = cn[0], c1 = cn[1];
    dst[0] = make_float4(__fdiv_rn(acc[0], c0.x), __fdiv_rn(acc[1], c0.y),
                         __fdiv_rn(acc[2], c0.z), __fdiv_rn(acc[3], c0.w));
    dst[1] = make_float4(__fdiv_rn(acc[4], c1.x), __fdiv_rn(acc[5], c1.y),
                         __fdiv_rn(acc[6], c1.z), __fdiv_rn(acc[7], c1.w));
  }
  __syncthreads();

  // ---- blur y-pass + floor: rows [row0-2, row0+66), the same columns ----
  for (int i = tid; i < (SM_H / YR) * XW; i += THREADS) {
    const int s = i / XW, x = i % XW;
    const float* src = tmp + s * YR * XW + x;   // output j, tap t: row j + t
    float acc[YR];
#pragma unroll
    for (int j = 0; j < YR; ++j) acc[j] = 0.0f;
    if constexpr (WINDOW > 0) {
      constexpr int NV = YR + WINDOW - 1;
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = src[j * XW];
#pragma unroll
      for (int t = 0; t < WINDOW; ++t)
#pragma unroll
        for (int j = 0; j < YR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j + t], k[t]));
    } else {
      for (int t = 0; t < window; ++t) {
        const float kt = k_s[t];
#pragma unroll
        for (int j = 0; j < YR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(src[(j + t) * XW], kt));
      }
    }
#pragma unroll
    for (int j = 0; j < YR; ++j) {
      sm[(s * YR + j) * XW + x] = floorf(__fdiv_rn(acc[j], cnt_y[s * YR + j]));
    }
  }
  __syncthreads();

  // ---- Sobel, magnitude and direction on [row0-1, row0+65) x
  //      [col0-3, col0+65), four adjacent pixels a thread ----
  const bool interior = row0 >= 2 && row0 + TILE_H + 2 <= H && col0 >= 4
                        && col0 + TILE_W + 2 <= W;
  auto mag_stage = [&](auto inside_tag) {
    constexpr bool INSIDE = decltype(inside_tag)::value;
    for (int i = tid; i < MAG_H * (MAG_W / 4); i += THREADS) {
      const int y = i / (MAG_W / 4), g = i % (MAG_W / 4);
      // pixel (y, 4g + j) is blurred row y + 1, column 4g + j + 1: the patch
      // is blurred rows y..y+2, columns 4g..4g+5
      float s[3][6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* row = sm + (y + a) * XW + 4 * g;      // 16-byte aligned
        const float4 q4 = *reinterpret_cast<const float4*>(row);
        const float2 q2 = *reinterpret_cast<const float2*>(row + 4);
        s[a][0] = q4.x; s[a][1] = q4.y; s[a][2] = q4.z; s[a][3] = q4.w;
        s[a][4] = q2.x; s[a][5] = q2.y;
      }
      int v[4];
      const int gr = row0 - 1 + y;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float gx, gy;
        if constexpr (INSIDE) {
          gx = (s[0][j + 2] - s[0][j]) + 2.0f * (s[1][j + 2] - s[1][j])
               + (s[2][j + 2] - s[2][j]);
          gy = (s[2][j] + 2.0f * s[2][j + 1] + s[2][j + 2])
               - (s[0][j] + 2.0f * s[0][j + 1] + s[0][j + 2]);
          v[j] = mag_dir(gx, gy);
        } else {
          // the reference border rules: gx takes clamped columns and drops
          // off-image row terms, gy clamped rows and drops column terms
          const int gc = col0 - 3 + 4 * g + j;
          v[j] = MAG_OOB;
          if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
            const bool up = gr > 0, dn = gr + 1 < H, lf = gc > 0, rt = gc + 1 < W;
            const float l0 = lf ? s[0][j] : s[0][j + 1], r0 = rt ? s[0][j + 2] : s[0][j + 1];
            const float l1 = lf ? s[1][j] : s[1][j + 1], r1 = rt ? s[1][j + 2] : s[1][j + 1];
            const float l2 = lf ? s[2][j] : s[2][j + 1], r2 = rt ? s[2][j + 2] : s[2][j + 1];
            gx = 2.0f * (r1 - l1) + (dn ? r2 - l2 : 0.0f) + (up ? r0 - l0 : 0.0f);
            const float ul = up ? s[0][j] : s[1][j], dl = dn ? s[2][j] : s[1][j];
            const float um = up ? s[0][j + 1] : s[1][j + 1];
            const float dm = dn ? s[2][j + 1] : s[1][j + 1];
            const float ur = up ? s[0][j + 2] : s[1][j + 2];
            const float dr = dn ? s[2][j + 2] : s[1][j + 2];
            gy = 2.0f * (dm - um) + (rt ? dr - ur : 0.0f) + (lf ? dl - ul : 0.0f);
            v[j] = mag_dir(gx, gy);
          }
        }
      }
      const uint32_t lo = (uint32_t)(uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16);
      const uint32_t hi = (uint32_t)(uint16_t)v[2] | ((uint32_t)(uint16_t)v[3] << 16);
      *reinterpret_cast<uint2*>(mag + y * MAG_W + 4 * g) = make_uint2(lo, hi);
    }
  };
  if (interior) mag_stage(std::true_type{});
  else mag_stage(std::false_type{});
  __syncthreads();

  // ---- NMS + output: warp w walks 16 rows of one 32-column word of the
  //      block; pixels past the image are 0 and clear ----
  {
    constexpr int ROWS = TILE_H / (THREADS / 64);
    const int lane = tid & 31, warp = tid >> 5;
    const int wd = (f.ow + 31) / 32;
    const int x = (warp & 1) * 32 + lane;
    const int y0 = (warp >> 1) * ROWS;
    const int lc = tx0 + x;                            // column in the block
    const int word = (tx0 >> 5) + (warp & 1);
    const bool col_out = lc < f.ow;
    const bool col_in = col_out && col0 + x < W;
    const int rows = min(ROWS, f.oh - (ty0 + y0));     // warp-uniform
    const int img_rows = H - (row0 + y0);              // rows in the image
    const int mn4 = 4 * mn, mx4 = 4 * mx;
    const bool writer = lane == 0 && word < wd;
    const int16_t* p = mag + (y0 + 1) * MAG_W + x + 3;
    // the four neighbour offsets by direction, one byte each
    constexpr uint32_t OFFS = (uint32_t)MAG_W | (1u << 8)
                              | ((uint32_t)(MAG_W - 1) << 16)
                              | ((uint32_t)(MAG_W + 1) << 24);
    const size_t o = packed ? (size_t)(ty0 + y0) * wd + word
                            : (size_t)(ty0 + y0) * f.ow + lc;
    uint32_t* wp = weak + o;
    uint32_t* sp = strong + o;
    int16_t* np = nm_out + o;
#pragma unroll 4
    for (int y = 0; y < rows; ++y, p += MAG_W) {
      const int v0 = p[0];
      const int off = (int)((OFFS >> (8 * (v0 & 3))) & 0xffu);
      // with v = 4 m + d and d < 4: m0 > m  <=>  4 m0 > v.  Off-image
      // neighbours read -4 and never suppress; ties suppress; an off-image
      // pixel reads -4 itself and is never kept
      const bool keep = (v0 & ~3) > max((int)p[-off], (int)p[off]);
      // the kept value, 4 m0 + d, or 0: m0 >= t  <=>  4 m0 + d >= 4 t
      const int vk = keep ? v0 : 0;
      if (packed) {
        const bool in = col_in && y < img_rows;
        const unsigned bw = __ballot_sync(0xffffffffu, in && vk >= mn4);
        const unsigned bs = __ballot_sync(0xffffffffu, in && vk >= mx4);
        if (writer) {
          *wp = bw;
          *sp = bs;
        }
        wp += wd;
        sp += wd;
      } else {
        if (col_out) *np = (int16_t)(vk >> 2);
        np += f.ow;
      }
    }
  }
}

// the shared memory a block of this window needs
int smem_bytes(int window) { return geo_of(window).bytes; }

template <int WINDOW>
cudaError_t launch(const Frame& f, const float* taps, int window, int packed,
                   int mn, int mx, int16_t* nm_out, uint32_t* weak,
                   uint32_t* strong, cudaStream_t stream) {
  const int bytes = smem_bytes(window);
  if (bytes > 48 * 1024) {
    // once per device and instantiation, and always to the device's limit
    // (one value a kernel, whatever the window): windows may alternate
    static bool opted_in[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    const int limit = masks::smem_optin_limit();
    if (bytes > limit) return cudaErrorInvalidValue;
    if (!opted_in[dev]) {
      e = cudaFuncSetAttribute(frontend_kernel<WINDOW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
      if (e != cudaSuccess) return e;
      opted_in[dev] = true;
    }
  }
  // 16-byte loads: every window row and the tile's first column start on a
  // 16-byte boundary
  const int vec_ok = f.sw % 16 == 0 && f.halo % 16 == 0
                     && reinterpret_cast<uintptr_t>(f.src) % 16 == 0;
  const dim3 grid((f.ow + TILE_W - 1) / TILE_W, (f.oh + TILE_H - 1) / TILE_H);
  frontend_kernel<WINDOW><<<grid, THREADS, bytes, stream>>>(
      f, taps, window, packed, mn, mx, vec_ok, nm_out, weak, strong);
  return cudaGetLastError();
}

int run(const Frame& f, const void* taps, int window, int packed, int mn,
        int mx, void* nm_out, void* weak, void* strong, void* stream) {
  if (f.oh <= 0 || f.ow <= 0 || f.H <= 0 || f.W <= 0 || f.halo < 0
      || f.sh != f.oh + 2 * f.halo || f.sw != f.ow + 2 * f.halo
      || window < 1 || window % 2 == 0)
    return (int)cudaErrorInvalidValue;
#define CANNY_FRONTEND_LAUNCH(WIN)                                            \
  return (int)launch<WIN>(f, (const float*)taps, window, packed, mn, mx,      \
                          (int16_t*)nm_out, (uint32_t*)weak,                  \
                          (uint32_t*)strong, (cudaStream_t)stream)
  switch (window) {
    case 3: CANNY_FRONTEND_LAUNCH(3);
    case 5: CANNY_FRONTEND_LAUNCH(5);
    case 7: CANNY_FRONTEND_LAUNCH(7);
    case 9: CANNY_FRONTEND_LAUNCH(9);
    case 11: CANNY_FRONTEND_LAUNCH(11);
    case 13: CANNY_FRONTEND_LAUNCH(13);
    case 15: CANNY_FRONTEND_LAUNCH(15);
    default: CANNY_FRONTEND_LAUNCH(0);
  }
#undef CANNY_FRONTEND_LAUNCH
}

}  // namespace

extern "C" {

// The largest odd window whose tile fits a block's shared memory on the
// current device (0 if the device cannot be asked).
int canny_frontend_max_window() {
  const int limit = masks::smem_optin_limit();
  int w = 1;
  while (smem_bytes(w + 2) <= limit) w += 2;
  return w < 3 ? 0 : w;
}

// img: uint8 (H, W); taps: float32 (window); packed == 0 -> nm_out int16
// (H, W); packed != 0 -> weak/strong uint32 (H, ceil(W/32)).  Launches on
// `stream` and returns cudaGetLastError().  Windows 3..15 run their own
// unrolled instantiation, every other odd window the generic one.
int canny_frontend(const void* img, int H, int W, const void* taps, int window,
                   int packed, int mn, int mx, void* nm_out, void* weak,
                   void* strong, void* stream) {
  const Frame f{(const uint8_t*)img, H, W, 0, H, W, 0, 0, H, W};
  return run(f, taps, window, packed, mn, mx, nm_out, weak, strong, stream);
}

// Block mode: window uint8 (oh + 2 halo, ow + 2 halo), its texel (halo, halo)
// pixel (row0, col0) of an (H, W) image, zero or not past the image (never
// read there); outputs as canny_frontend's for the (oh, ow) block: nm_out
// int16 (oh, ow) or weak/strong uint32 (oh, ceil(ow/32)).  halo must cover
// the front end's reach (window / 2 + 2) wherever the block does not meet
// the image border.
int canny_frontend_block(const void* window_u8, int oh, int ow, int halo,
                         int row0, int col0, int H, int W, const void* taps,
                         int window, int packed, int mn, int mx, void* nm_out,
                         void* weak, void* strong, void* stream) {
  const Frame f{(const uint8_t*)window_u8, oh + 2 * halo, ow + 2 * halo, halo,
                oh, ow, row0, col0, H, W};
  return run(f, taps, window, packed, mn, mx, nm_out, weak, strong, stream);
}

}  // extern "C"
