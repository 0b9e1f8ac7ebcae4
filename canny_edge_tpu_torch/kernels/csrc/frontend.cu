// K1: the Canny front end on Hopper -- uint8 image -> NMS magnitude, or the
// bit-packed weak/strong hysteresis masks; uint16 image -> the masks.
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
// Three paths, chosen by the window alone; all give the same bits:
//   tile     windows 3..103 (sigma <= 17; the headline sigma 1.4 is 11):
//            one block of 256 threads a 64x64 output tile, every stage in
//            shared memory, the window a template parameter (this section);
//            its x-pass runs over 68 + 2c rows for 64 outputs, which the
//            ring path's costs overtake past 103 taps on the H100;
//   ring     windows from 105 taps up to what its shared memory holds (613
//            on the H100): a block streams a 64-column strip of a run of
//            rows through a ring of x-pass rows, so that a strip's x-pass
//            rows are computed once a run, not once a 64-row tile (the
//            section "Wide windows" below);
//   scratch  any wider window (canny_frontend_large, the last section): the
//            blur through device memory, then the same back half on tiles.
// canny_run_plan (the last entry) runs one request of the fused pipeline
// from a launch plan: K1 on the tile or ring path, then K2 behind it.
// The tile path:
//   load    the uint8 tile with its halo (window/2 + 2 texels), zero filled
//           off the image; 16-byte cp.async where the row address allows
//           (W a multiple of 16, chunk inside the image), else byte loads;
//   x-pass  a thread loads its row segment as 32-bit words,
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
// Batch: a (B, H, W) batch is one launch, blockIdx.z the frame (B <= 65535,
// the grid's z limit); the counterpart of jax.vmap over the Pallas kernel
// (canny_edge_tpu/kernels/fused.py:47), which gives its grid a batch axis.
// Frame z reads src + z H W and writes its own (H, W) map or (H, ceil(W/32))
// masks.  Frame z starts on a 16-byte boundary only when H W % 16 == 0, so
// each block decides the 16-byte loads from its own frame's address.
//
// Exactness: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, and the build passes --fmad=false), taps accumulate in
// ascending order, the renormalization divide is __fdiv_rn, and the back
// half computes on integers (held in floats only where every result is an
// integer below 2^24, so nothing rounds).  The result is bit-identical to
// the plain version.
//
// uint16 frames: each kernel that reads pixels is overloaded on Frame16
// (canny_frontend, canny_frontend_large and a plan with isz 2), a separate
// instantiation beside the uint8 one, into the packed masks only.
// A uint16 frame's blur reaches 65535 and its gradients 262,140, still
// exact in floats; where gx^2 + gy^2 passes 2^24 the magnitude and the
// direction are worked out in FP64 (mag_dir_wide), and the magnitudes are
// int32 in shared memory.  The tile path's uint16 input shares the blurred
// tile's bytes (geo_of), so its 11-tap block fits 4 an SM as the uint8 one
// does; a row of 8-byte alignment (W a multiple of 4) takes a 16-byte chunk
// in two 8-byte copies.

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
constexpr int TILE_MAX = 103;        // the tile path's widest window

static_assert(XW % XR == 0 && SM_H % YR == 0 && MAG_W % 4 == 0, "geometry");

// The tile path's shared-memory layout of a window on pixels of `isz`
// bytes: its half-width c, the input tile with its halo, the x-pass buffer
// (the magnitudes reuse it), the blurred tile and the divisors (and room
// for the taps), at byte offsets in_off, tmp_off, sm_off and cnt_off.  A
// 2-byte tile shares its bytes with the blurred tile, which is written only
// once the x-pass has read the input: its 11-tap block then fits 4 an SM.
struct Geo {
  int c, org, in_w, in_h, in_bytes, tmp_bytes, sm_bytes, bytes, in_off,
      tmp_off, sm_off, cnt_off;
};

__host__ __device__ constexpr Geo geo_of(int window, int isz = 1) {
  const int c = window / 2;
  // the shared tile starts `org` columns left of the output tile: a multiple
  // of 16, so a 16-byte chunk of the tile is a 16-byte chunk of the image row
  const int org = 4 + c <= 16 ? 16 : (4 + c + 15) / 16 * 16;
  const int in_w = (org + TILE_W + 4 + c + 15) / 16 * 16;
  const int in_h = SM_H + 2 * c;
  const int in_bytes = in_h * in_w * isz;
  const int tmp_bytes = in_h * XW * 4;
  const int sm_bytes = SM_H * XW * 4;
  const int cnt_bytes = (XW + SM_H + window + 3) / 4 * 16;
  if (isz == 1)
    return Geo{c, org, in_w, in_h, in_bytes, tmp_bytes, sm_bytes,
               in_bytes + tmp_bytes + sm_bytes + cnt_bytes, 0, in_bytes,
               in_bytes + tmp_bytes, in_bytes + tmp_bytes + sm_bytes};
  const int shared = in_bytes > sm_bytes ? in_bytes : sm_bytes;
  return Geo{c, org, in_w, in_h, in_bytes, tmp_bytes, sm_bytes,
             tmp_bytes + shared + cnt_bytes, tmp_bytes, 0, tmp_bytes,
             tmp_bytes + shared};
}

static_assert(geo_of(3).tmp_bytes >= MAG_H * MAG_W * 4,
              "magnitudes fit the x-pass buffer, as int16 and as int32");
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

// mag_dir for the gradients of a uint16 frame, integers up to 262,140 held
// in floats (exact: the blur's levels and their Sobel sums stay below
// 2^24).  Where gx^2 + gy^2 stays below 2^24, mag_dir is exact as it is:
// every square and sum is then an integer below 2^24, and the rounded sum
// reaches 2^24 only where the exact one does.  Above, the squares and the
// angle predicates are exact in FP64 (below 2^39), the root is the
// correctly rounded one stepped to the integer root, and 4 * magnitude +
// direction fits an int.
__device__ __forceinline__ int mag_dir_wide(float gx, float gy) {
  if (gx * gx + gy * gy < 16777216.0f) return mag_dir(gx, gy);
  const double x = gx, y = gy;
  const double n = x * x + y * y;
  double k = floor(sqrt(n));
  if (k * k > n) k -= 1.0;
  if ((k + 1.0) * (k + 1.0) <= n) k += 1.0;
  const double ax = fabs(x), ay = fabs(y);
  const double diff2 = (ax - ay) * (ax - ay);
  const bool low = ax > ay && 2.0 * ay * ay < diff2;
  const bool high = ay > ax && diff2 > 2.0 * ax * ax;
  const double sp = x * y;
  const int dir = high ? 0 : (low || sp == 0.0) ? 1 : sp > 0.0 ? 2 : 3;
  return ((int)k << 2) | dir;
}

// the magnitude and direction of one gradient as a magnitude of type M
template <typename M>
__device__ __forceinline__ int mag_dir_of(float gx, float gy) {
  if constexpr (sizeof(M) == 2) return mag_dir(gx, gy);
  else return mag_dir_wide(gx, gy);
}

// Where the kernel reads and writes: the input window (sh, sw) whose texel
// (halo, halo) is output pixel (0, 0), the (oh, ow) output block, the
// block's place (row0, col0) in the (H, W) image, and the number of frames
// B (windows sh x sw apart in src, outputs one map or mask pair apart).
// Frame has uint8 pixels, Frame16 uint16 ones: each kernel that reads the
// input is one name overloaded on the two, so the uint8 kernels keep their
// names and their code, and a uint16 kernel is an instantiation of its own.
template <typename T>
struct FrameOf {
  const T* src;
  int sh, sw, halo, oh, ow, row0, col0, H, W, B;
};
struct Frame : FrameOf<uint8_t> {};
struct Frame16 : FrameOf<uint16_t> {};

// a frame's pixel type, and the type of its magnitudes in shared memory:
// int16 for uint8 frames (4 m + d below 2^13), int32 for uint16 ones (the
// magnitude reaches 370,727)
template <typename F>
using PixelOf = std::remove_const_t<std::remove_pointer_t<decltype(F::src)>>;
template <typename F>
using MagOf = std::conditional_t<sizeof(PixelOf<F>) == 1, int16_t, int32_t>;

// bar.sync / bar.arrive on named barrier `id` (1..15) of `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" : : "r"(id), "r"(n) : "memory");
}

// The back half of a TH x 64 tile whose first output pixel is (ty0, tx0)
// of frame z's output block: Sobel, magnitude and direction, NMS and the
// output, from the floored blur `sm` (rows [row0-2, row0+TH+2) x columns
// [col0-4, col0+68) of the image, XW floats a row) in shared memory; `mag`
// is shared scratch of (TH + 2) x MAG_W magnitudes (MagOf<F>).  A group of
// THREADS threads (`tid` its thread) calls it after a barrier that
// publishes `sm`; the group's barrier is __syncthreads (BAR 0) or named
// barrier BAR of THREADS threads.
// In NMS a warp takes TH / 4 rows of one 32-column word.
template <int TH = TILE_H, int BAR = 0, typename F>
__device__ __forceinline__ void back_half(const F& f, const float* sm,
                                          MagOf<F>* mag, int z, int ty0,
                                          int tx0, int tid, int packed,
                                          int mn, int mx,
                                          int16_t* __restrict__ nm_out,
                                          uint32_t* __restrict__ weak,
                                          uint32_t* __restrict__ strong) {
  static_assert(TH % 4 == 0, "back-half geometry");
  using M = MagOf<F>;
  constexpr int MH = TH + 2;           // magnitude rows [row0-1, row0+TH+1)
  const int H = f.H, W = f.W;
  const int row0 = f.row0 + ty0, col0 = f.col0 + tx0;

  // ---- Sobel, magnitude and direction on [row0-1, row0+TH+1) x
  //      [col0-3, col0+65), four adjacent pixels a thread ----
  const bool interior = row0 >= 2 && row0 + TH + 2 <= H && col0 >= 4
                        && col0 + TILE_W + 2 <= W;
  auto mag_stage = [&](auto inside_tag) {
    constexpr bool INSIDE = decltype(inside_tag)::value;
    for (int i = tid; i < MH * (MAG_W / 4); i += THREADS) {
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
          v[j] = mag_dir_of<M>(gx, gy);
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
            v[j] = mag_dir_of<M>(gx, gy);
          }
        }
      }
      if constexpr (sizeof(M) == 2) {
        const uint32_t lo = (uint32_t)(uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16);
        const uint32_t hi = (uint32_t)(uint16_t)v[2] | ((uint32_t)(uint16_t)v[3] << 16);
        *reinterpret_cast<uint2*>(mag + y * MAG_W + 4 * g) = make_uint2(lo, hi);
      } else {
        *reinterpret_cast<uint4*>(mag + y * MAG_W + 4 * g) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  if (interior) mag_stage(std::true_type{});
  else mag_stage(std::false_type{});
  if constexpr (BAR == 0) __syncthreads();
  else bar_sync(BAR, THREADS);

  // ---- NMS + output: warp w walks TH / 4 rows of one 32-column word of
  //      the block; pixels past the image are 0 and clear ----
  {
    constexpr int ROWS = TH / (THREADS / 64);
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
    const M* p = mag + (y0 + 1) * MAG_W + x + 3;
    // the four neighbour offsets by direction, one byte each
    constexpr uint32_t OFFS = (uint32_t)MAG_W | (1u << 8)
                              | ((uint32_t)(MAG_W - 1) << 16)
                              | ((uint32_t)(MAG_W + 1) << 24);
    const size_t o = packed
        ? ((size_t)z * f.oh + ty0 + y0) * wd + word
        : ((size_t)z * f.oh + ty0 + y0) * f.ow + lc;
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

// The tile path's block on frame f (Frame or Frame16): the body of both
// frontend_kernel overloads.  vec_ok: the rows start on 16 bytes where the
// frame does (for a uint16 frame 2, or 1 where they start on 8 bytes).
template <int WINDOW, typename F>
__device__ __forceinline__ void tile_block(
    const F& f, const float* __restrict__ taps, int packed, int mn, int mx,
    int vec_ok, int16_t* __restrict__ nm_out, uint32_t* __restrict__ weak,
    uint32_t* __restrict__ strong) {
  static_assert(WINDOW >= 3 && WINDOW <= TILE_MAX && WINDOW % 2 == 1,
                "the tile path's windows");
  using T = PixelOf<F>;
  constexpr int PPW = 4 / sizeof(T);  // pixels a 32-bit word
  constexpr int PPC = 16 / sizeof(T); // pixels a 16-byte chunk
  constexpr Geo G = geo_of(WINDOW, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* in = reinterpret_cast<T*>(smem_raw + G.in_off);
  float* tmp = reinterpret_cast<float*>(smem_raw + G.tmp_off);
  MagOf<F>* mag = reinterpret_cast<MagOf<F>*>(tmp);
  float* sm = reinterpret_cast<float*>(smem_raw + G.sm_off);
  float* cnt_x = reinterpret_cast<float*>(smem_raw + G.cnt_off);
  float* cnt_y = cnt_x + XW;           // contiguous with cnt_x

  const int H = f.H, W = f.W;
  const int c = G.c;
  const int in_h = G.in_h;             // rows [row0 - 2 - c, row0 + 66 + c)
  // the tile's first output pixel, in the block and in the image
  const int ty0 = blockIdx.y * TILE_H, tx0 = blockIdx.x * TILE_W;
  const int row0 = f.row0 + ty0, col0 = f.col0 + tx0;
  const int tid = threadIdx.x;
  // this block's frame of a batch: its window, and 16-byte loads only if it
  // starts on a 16-byte boundary (the rows are then too: vec_ok); a uint16
  // frame whose rows start on 8 bytes takes a chunk in two 8-byte loads
  const T* fsrc = f.src + (size_t)blockIdx.z * f.sh * f.sw;
  const bool vec = (sizeof(T) == 1 ? vec_ok : vec_ok == 2)
                   && (reinterpret_cast<uintptr_t>(fsrc) & 15u) == 0;
  const bool vec8 = sizeof(T) == 2 && vec_ok >= 1
                    && (reinterpret_cast<uintptr_t>(fsrc) & 7u) == 0;

  float k[WINDOW];
#pragma unroll
  for (int t = 0; t < WINDOW; ++t) k[t] = __ldg(taps + t);

  // ---- load: the zero-padded tile with its halo, 16 bytes a thread; a
  //      texel is read where it lies in the window and in the image ----
  {
    const int ch = G.in_w / PPC;
    // window row / column of shared row 0 / column 0
    const int wr0 = ty0 - 2 - c + f.halo, wc0 = tx0 - G.org + f.halo;
    for (int i = tid; i < in_h * ch; i += THREADS) {
      const int y = i / ch, q = i % ch;
      const int wr = wr0 + y, wc = wc0 + PPC * q;
      const int gr = row0 - 2 - c + y, gc = col0 - G.org + PPC * q;
      T* dst = in + y * G.in_w + PPC * q;
      const bool row_in = wr >= 0 && wr < f.sh && gr >= 0 && gr < H;
      if (vec && row_in && wc >= 0 && wc + PPC <= f.sw && gc >= 0
          && gc + PPC <= W) {
        __pipeline_memcpy_async(dst, fsrc + (size_t)wr * f.sw + wc, 16);
      } else if (sizeof(T) == 2 && vec8 && row_in && wc >= 0
                 && wc + PPC <= f.sw && gc >= 0 && gc + PPC <= W) {
        const T* src = fsrc + (size_t)wr * f.sw + wc;
        __pipeline_memcpy_async(dst, src, 8);
        __pipeline_memcpy_async(dst + PPC / 2, src + PPC / 2, 8);
      } else {
        uint32_t wds[4] = {0u, 0u, 0u, 0u};
        if (row_in) {
          const T* src = fsrc + (size_t)wr * f.sw;
#pragma unroll
          for (int b = 0; b < PPC; ++b) {
            const int cc = wc + b, gcc = gc + b;
            if (cc >= 0 && cc < f.sw && gcc >= 0 && gcc < W)
              wds[b / PPW] |= (uint32_t)src[cc] << (8 * sizeof(T) * (b % PPW));
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
#pragma unroll
      for (int t = 0; t < WINDOW; ++t) {
        const int q = g + t - c;
        if (q >= 0 && q < n) s = __fadd_rn(s, k[t]);
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
    {
      constexpr int XOFF = G.org - 4 - WINDOW / 2;
      constexpr int S = XOFF % PPW;            // first pixel within its word
      constexpr int NV = XR + WINDOW - 1;
      constexpr int NW = (S + NV + PPW - 1) / PPW;
      constexpr uint32_t MASK = sizeof(T) == 1 ? 0xffu : 0xffffu;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(in)
                            + y * (G.in_w / PPW) + XOFF / PPW + g * (XR / PPW);
      uint32_t wv[NW];
#pragma unroll
      for (int m = 0; m < NW; ++m) wv[m] = src[m];
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        v[j] = (float)((wv[(S + j) / PPW] >> (8 * sizeof(T) * ((S + j) % PPW)))
                       & MASK);
#pragma unroll
      for (int t = 0; t < WINDOW; ++t)
#pragma unroll
        for (int j = 0; j < XR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j + t], k[t]));
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
    {
      constexpr int NV = YR + WINDOW - 1;
      float v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = src[j * XW];
#pragma unroll
      for (int t = 0; t < WINDOW; ++t)
#pragma unroll
        for (int j = 0; j < YR; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j + t], k[t]));
    }
#pragma unroll
    for (int j = 0; j < YR; ++j) {
      sm[(s * YR + j) * XW + x] = floorf(__fdiv_rn(acc[j], cnt_y[s * YR + j]));
    }
  }
  __syncthreads();

  back_half(f, sm, mag, blockIdx.z, ty0, tx0, tid, packed, mn, mx, nm_out,
            weak, strong);
}

template <int WINDOW>
__global__ void __launch_bounds__(THREADS, 4)
frontend_kernel(Frame f, const float* __restrict__ taps, int packed, int mn,
                int mx, int vec_ok, int16_t* __restrict__ nm_out,
                uint32_t* __restrict__ weak, uint32_t* __restrict__ strong) {
  tile_block<WINDOW>(f, taps, packed, mn, mx, vec_ok, nm_out, weak, strong);
}

template <int WINDOW>
__global__ void __launch_bounds__(THREADS, 4)
frontend_kernel(Frame16 f, const float* __restrict__ taps, int packed, int mn,
                int mx, int vec_ok, int16_t* __restrict__ nm_out,
                uint32_t* __restrict__ weak, uint32_t* __restrict__ strong) {
  tile_block<WINDOW>(f, taps, packed, mn, mx, vec_ok, nm_out, weak, strong);
}

// the shared memory a block of this window needs, on pixels of `isz` bytes
int smem_bytes(int window, int isz = 1) { return geo_of(window, isz).bytes; }

template <int WINDOW, typename F>
cudaError_t launch(const F& f, const float* taps, int packed, int mn,
                   int mx, int16_t* nm_out, uint32_t* weak, uint32_t* strong,
                   cudaStream_t stream) {
  constexpr int isz = sizeof(PixelOf<F>);
  void (*kern)(F, const float*, int, int, int, int, int16_t*, uint32_t*,
               uint32_t*) = frontend_kernel<WINDOW>;
  const int bytes = smem_bytes(WINDOW, isz);
  if (bytes > 48 * 1024) {
    // once per device and instantiation, and always to the device's limit
    static bool opted_in[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    const int limit = masks::smem_optin_limit();
    if (bytes > limit) return cudaErrorInvalidValue;
    if (!opted_in[dev]) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
      if (e != cudaSuccess) return e;
      opted_in[dev] = true;
    }
  }
  // 16-byte loads: every window row and the tile's first column start on a
  // 16-byte boundary if the frame does (each block tests its frame); for a
  // uint16 frame 2 there, 1 where they start on 8 bytes
  const int ppc = 16 / isz;
  const int vec_ok = isz == 1 ? f.sw % 16 == 0 && f.halo % 16 == 0
      : f.sw % ppc == 0 && f.halo % ppc == 0 ? 2
      : f.sw % (ppc / 2) == 0 && f.halo % (ppc / 2) == 0 ? 1 : 0;
  const dim3 grid((f.ow + TILE_W - 1) / TILE_W, (f.oh + TILE_H - 1) / TILE_H,
                  f.B);
  kern<<<grid, THREADS, bytes, stream>>>(f, taps, packed, mn, mx, vec_ok,
                                         nm_out, weak, strong);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Wide windows: a column strip through a ring of x-pass rows
// ---------------------------------------------------------------------------
//
// The tile path's 64x64 tile runs its x-pass over 68 + 2c rows for 64
// outputs (at 263 taps, 330), and its shared memory grows with (68 + 2c)
// rows of input and x-pass, one block an SM.  The ring path streams a strip
// of 64 output columns (the tile's 72 x-pass columns) down its output rows,
// in steps of RTH = 32 rows, and splits a block's 16 warps in two groups
// that work at once, handing rows over through a ring:
//   x-pass warps (8)  fetch the next 32 input rows of the strip (72 + 2c
//           texels each, zero off the image) in 16-byte loads into
//           registers, run the x-pass of the current 32 rows out of a
//           staging buffer (warp g columns [9g, 9g + 9), lane i row i, 9
//           outputs a thread from register windows of texels, 8 taps at a
//           time, the next 8 texels and taps loaded while the 8 before
//           run), store the fetched rows as 32-bit words into the staging
//           buffer, and write the 32 quotients into the ring;
//   ring    the last 32 + 2c x-pass rows (73 floats a row), plus 8 rows past
//           its end that mirror its first 8, so that 8 rows from any slot
//           are contiguous;
//   y-pass warps (8)  take a step's blurred rows [ty0 - 2, ty0 + 34): 8
//           rows of one of the first 64 columns a thread and one row of the
//           last 8, loaded as the x-pass's are; the first 4 rows come from
//           the step before (or, on a segment's first step, from its
//           prologue); then back_half on the 32 x 64 tile (the tile path's
//           Sobel, NMS and output, at a tile height of 32, on the group's
//           own barrier).
// Two named barriers hand over: "rows written" (the x-pass warps arrive
// after writing a step's rows, the y-pass warps wait before reading them)
// and "rows released" (the y-pass warps arrive once a step's y-pass has
// read the ring, the x-pass warps wait before overwriting its oldest 32
// rows), so the x-pass of step k + 1 runs beside the y-pass and back half
// of step k.
//
// A launch's work is one sequence of steps: frame by frame, strip by strip
// within a frame, and down each strip (a column of the sequence).  A block
// walks one contiguous span of it (Spans); the part of a span in one column
// is a segment.  A segment starts as a column does: the x-pass warps
// compute the strip's column divisors and a prologue of 4 + 2c x-pass rows
// (those of the segment's first 4 blurred rows) alone, the y-pass warps the
// divisors of its rows RDIV rows at a time (refilled every RDIV / RTH
// steps), and every x-pass row after the prologue is computed once.  From
// one segment to the next the hand-over goes on: the x-pass warps fetch the
// next segment's first input rows during the last step, and compute its
// prologue's first rows while the y-pass warps read that step, writing them
// once "rows released" says it is read (the prologue takes ring slots the
// step holds).  The taps and `full` are built once a block.  A position
// whose window lies in the image takes the full tap-order sum, summed once;
// only the rows and columns within c of the image's border sum their own.
// The arithmetic is the tile path's: taps ascending (__fmul_rn, __fadd_rn),
// __fdiv_rn, floorf on the y-pass.
//
// The spans (ring_launch_of): equal runs down each column, the run count
// chosen by the card's waves; or, where it is modelled faster, as many
// spans of near-equal length as the card holds blocks at once, which cross
// strips and frames, so that no slot stands idle for a second wave.

constexpr int RT = 512;                // ring path threads: 16 warps
constexpr int RG = 256;                // of which x-pass, and y-pass
constexpr int RXR = 9;                 // x-pass outputs a thread
constexpr int RTH = 32;                // output rows a step, and input rows
constexpr int RSM_H = RTH + 4;         // blurred rows a step
constexpr int RS = XW + 1;             // ring row stride, in floats
constexpr int RMIR = 8;                // rows past the ring that mirror it
constexpr int RDIV = 512;              // row divisors a block holds at once
constexpr int RB = 6;                  // 16-byte input chunks a thread holds

// named barriers (0 is __syncthreads): among the x-pass warps, among the
// y-pass warps, "rows written" (the x-pass warps arrive, the y-pass warps
// wait) and "rows released" (the y-pass warps arrive, the x-pass warps wait)
constexpr int BAR_X = 1, BAR_Y = 2, BAR_FULL = 3, BAR_EMPTY = 4;

static_assert(RXR * (RG / 32) == XW, "a warp an x-pass group, a lane a row");
static_assert(TILE_W * (RTH / 8) == RG && (XW - TILE_W) * RTH == RG,
              "a thread 8 y-pass rows of a column and one of the last 8");

// The ring path's shared-memory layout of a window on pixels of `isz`
// bytes (byte offsets): taps, column and row divisors, the blurred rows,
// the magnitudes (int16, or int32 for 2-byte pixels), the ring and the
// staging rows of sw bytes (an odd number of words: distinct banks).
struct RingGeo {
  int c, ring, sw, k_off, cx_off, sm_off, mag_off, ring_off, st_off, bytes;
};

__host__ __device__ constexpr RingGeo ring_geo(int window, int isz = 1) {
  const int c = window / 2;
  const int ring = RTH + 2 * c;
  // x-pass column x at tap t reads staging texel xoff + x + t, xoff < 4 / isz
  const int sw = ((isz * (75 + 2 * c) + 3) / 4 | 1) * 4;
  const int k_off = 0;
  const int cx_off = k_off + (window + 3) / 4 * 16;
  const int sm_off = cx_off + (XW + RDIV + 4) * 4;
  const int mag_off = sm_off + RSM_H * XW * 4;
  const int ring_off = mag_off + (RTH + 2) * MAG_W * 2 * isz;
  const int st_off = ring_off + ((ring + RMIR) * RS * 4 + 15) / 16 * 16;
  return RingGeo{c, ring, sw, k_off, cx_off, sm_off, mag_off, ring_off,
                 st_off, st_off + RTH * sw + 16 * isz};
}

static_assert(RDIV % RTH == 0, "a refill of the row divisors a whole step's");
static_assert((XW + RDIV + 4) % 4 == 0 && (RSM_H * XW) % 4 == 0
              && ((RTH + 2) * MAG_W * 2) % 16 == 0, "16-byte aligned sections");

// acc[j] += value(o + u + j) * k[u] for u < 8 ascending, j < N <= 9, from
// two 8-value register windows lo (values o..o+7) and hi (o+8..o+15) and
// the 8 taps in two float4.
template <int N>
__device__ __forceinline__ void taps8(float (&acc)[N], const float (&lo)[8],
                                      const float (&hi)[8], float4 k0,
                                      float4 k1) {
  static_assert(N >= 1 && N <= 9, "values o + u + j stay below o + 16");
  const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] = __fadd_rn(acc[j],
                         __fmul_rn(u + j < 8 ? lo[u + j] : hi[u + j - 8], kk[u]));
}

__device__ __forceinline__ float4 taps4(const float* k) {
  return *reinterpret_cast<const float4*>(k);
}

// acc[j] = sum over t ascending of value(j + t) * k_s[t], j < N, where
// load(o, d) sets d[u] = value(o + u) for u < 8 and load(o) is value(o) (o
// below window + 16; values past window + 8 are loaded and never used).
// 24 taps a step in three 8-tap halves over three rotating 8-value windows,
// each half's values and taps loaded a half ahead so that shared memory's
// latency hides under the half before; then 8 at a time, then tap by tap.
template <int N, typename Load>
__device__ __forceinline__ void sweep_taps(float (&acc)[N], const float* k_s,
                                           int window, const Load& load) {
  float va[8], vb[8], vc[8];
  load(0, va);
  load(8, vb);
  float4 ka0 = taps4(k_s), ka1 = taps4(k_s + 4);
  int t0 = 0;
  for (; t0 + 24 <= window; t0 += 24) {
    load(t0 + 16, vc);
    const float4 kb0 = taps4(k_s + t0 + 8), kb1 = taps4(k_s + t0 + 12);
    taps8(acc, va, vb, ka0, ka1);
    load(t0 + 24, va);
    const float4 kc0 = taps4(k_s + t0 + 16), kc1 = taps4(k_s + t0 + 20);
    taps8(acc, vb, vc, kb0, kb1);
    load(t0 + 32, vb);
    ka0 = taps4(k_s + t0 + 24);
    ka1 = taps4(k_s + t0 + 28);
    taps8(acc, vc, va, kc0, kc1);
  }
  if (t0 + 8 <= window) {
    load(t0 + 16, vc);
    taps8(acc, va, vb, ka0, ka1);
    if (t0 + 16 <= window) {
      taps8(acc, vb, vc, taps4(k_s + t0 + 8), taps4(k_s + t0 + 12));
      t0 += 8;
    }
    t0 += 8;
  }
  for (; t0 < window; ++t0) {
    float d[8];
    load(t0, d);
    const float kt = k_s[t0];
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(j < 8 ? d[j] : load(t0 + j), kt));
  }
}

// the x-pass's values: texels of one staging row, from a thread's first
template <typename T>
struct TexelLoad {
  const T* p;
  __device__ __forceinline__ float operator()(int o) const {
    return (float)p[o];
  }
  __device__ __forceinline__ void operator()(int o, float (&d)[8]) const {
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = (float)p[o + u];
  }
};

// the y-pass's values: one column of the ring from the x-pass row in slot s
struct RingLoad {
  const float* col;
  int s, ring;
  __device__ __forceinline__ const float* row(int o) const {
    int so = s + o;
    if (so >= ring) so -= ring;            // o < ring: one wrap at most
    return col + so * RS;
  }
  __device__ __forceinline__ float operator()(int o) const { return *row(o); }
  __device__ __forceinline__ void operator()(int o, float (&d)[8]) const {
    const float* q = row(o);
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = q[u * RS];
  }
};

// The spans of a ring launch's blocks.  The launch's work is T = B strips
// steps steps, in the order frame, strip, step (a column: `steps` steps of
// RTH rows, the last rounded up).  With run > 0 the grid is (strips, runs,
// B) and block (x, y, z) takes steps [y run, (y + 1) run) of column (z, x),
// the last run fewer: equal runs, each within one column.  With run 0 the
// grid is (blocks) and block i takes steps [i T / blocks, (i + 1) T /
// blocks): spans of near-equal length that may cross strips and frames.
// Indices over the sequence are 64-bit (65535 frames x strips x steps pass
// 2^31).
struct Spans {
  int strips, steps, run, blocks;
};

// block (bx, by, bz)'s span [*begin, *end) of the sequence, on B frames
__host__ __device__ inline void span_of(const Spans& sp, int B, int bx,
                                        int by, int bz, long long* begin,
                                        long long* end) {
  if (sp.run > 0) {
    const long long col = (long long)bz * sp.strips + bx;
    const long long b = col * sp.steps + (long long)by * sp.run;
    const long long e = (col + 1) * sp.steps;
    *begin = b;
    *end = b + sp.run < e ? b + sp.run : e;
  } else {
    // i T / blocks without the product i T: q = T / blocks, r = T % blocks
    const long long total = (long long)B * sp.strips * sp.steps;
    const long long q = total / sp.blocks, r = total % sp.blocks;
    *begin = bx * q + bx * r / sp.blocks;
    *end = (bx + 1) * q + (bx + 1) * r / sp.blocks;
  }
}

// the segments of a span [b, e): the columns it meets
__host__ __device__ inline int segments_of(const Spans& sp, long long b,
                                           long long e) {
  return (int)((e - 1) / sp.steps - b / sp.steps + 1);
}

// A warp group's walk over its block's span, a segment at a time: the
// segment's frame z, its strip's first output column tx0, its first step
// k0 and its steps, and the steps of the span after it.  A walk starts at
// the span's first segment (walk_of) and goes on to the next column's
// first steps (next): the next strip, or the next frame's first.
struct Walk {
  int z, tx0, k0, steps, rest;

  __device__ void next(const Spans& sp) {
    tx0 += TILE_W;
    if (tx0 == sp.strips * TILE_W) {
      tx0 = 0;
      ++z;
    }
    k0 = 0;
    steps = rest < sp.steps ? rest : sp.steps;
    rest -= steps;
  }
};

__device__ inline Walk walk_of(const Spans& sp, int B) {
  long long b, e;
  span_of(sp, B, blockIdx.x, blockIdx.y, blockIdx.z, &b, &e);
  const long long col = b / sp.steps;
  const int k0 = (int)(b - col * sp.steps);
  const int steps = e - b < sp.steps - k0 ? (int)(e - b) : sp.steps - k0;
  return Walk{(int)(col / sp.strips), (int)(col % sp.strips) * TILE_W, k0,
              steps, (int)(e - b - steps)};
}

// The ring path's block on frame f (Frame or Frame16): the body of both
// frontend_ring_kernel overloads.  vec_ok: the frame's rows start on 4
// bytes where the frame does.
template <typename F>
__device__ __forceinline__ void ring_block(
    const F& f, const float* __restrict__ taps, int window, Spans sp,
    int packed, int mn, int mx, int vec_ok, int16_t* __restrict__ nm_out,
    uint32_t* __restrict__ weak, uint32_t* __restrict__ strong) {
  using T = PixelOf<F>;
  constexpr int PPW = 4 / sizeof(T);  // pixels a 32-bit word
  constexpr int PPC = 16 / sizeof(T); // pixels a 16-byte chunk
  const RingGeo G = ring_geo(window, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw + G.k_off);
  float* cnt_x = reinterpret_cast<float*>(smem_raw + G.cx_off);
  float* cnt_y = cnt_x + XW;           // contiguous with cnt_x
  float* sm = reinterpret_cast<float*>(smem_raw + G.sm_off);
  MagOf<F>* mag = reinterpret_cast<MagOf<F>*>(smem_raw + G.mag_off);
  float* ring = reinterpret_cast<float*>(smem_raw + G.ring_off);
  uint8_t* st = smem_raw + G.st_off;

  const int H = f.H, W = f.W, c = G.c, RING = G.ring, SW = G.sw;
  const int tid = threadIdx.x;
  const bool xw = tid < RG;            // an x-pass warp, else a y-pass warp
  const int gt = xw ? tid : tid - RG;  // the thread in its group
  const int lane = gt & 31, warp = gt >> 5;
  const int P = 4 + 2 * c;             // x-pass rows of blurred rows 0..3
  // x-pass row j of a segment is image row rr0 - 2 - c + j, where rr0 is the
  // image row of its first output row; blurred row b, image row rr0 - 2 +
  // b, takes x-pass rows [b, b + 2c].  A strip's staging texel 0 is window
  // column ws0 = (tx0 - 4 - c + halo) & ~(PPW - 1) and x-pass column x at
  // tap t reads texel xoff + x + t; chunk m of a staging row covers window
  // columns [cs0 + PPC m, + PPC), cs0 = ws0 & ~(PPC - 1).  tx0 is a
  // multiple of 64, so xoff, ws0 - cs0 and the chunks a row are those of
  // every strip.
  const int wc4 = 4 + c - f.halo;      // tx0 - ws0 - xoff
  const int xoff = -wc4 & (PPW - 1);
  // ws0 - cs0, in bytes
  const int lead = (-wc4 & (PPC - 1) & ~(PPW - 1)) * (int)sizeof(T);
  const int nch = (lead + SW + 15) >> 4;         // chunks a staging row

  // where a segment's input rows come from (worked out once a segment):
  // its frame's window, the image row of its x-pass row 0, the window column
  // of chunk 0, and the loads its frame's alignment allows.  A chunk is one
  // 16-byte load where it lies in the window and the image and the rows
  // start on 16 bytes, else a word at a time (4 bytes, or bytes), zero off
  // the image.
  struct Src {
    const T* p;
    int r0, cs0;
    bool vec, vec16;
  };
  auto src_of = [&](const Walk& w) {
    const T* p = f.src + (size_t)w.z * f.sh * f.sw;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    return Src{p, f.row0 + RTH * w.k0 - 2 - c, w.tx0 + (-wc4 & ~(PPC - 1)),
               vec_ok && (a & 3u) == 0,
               vec_ok && (a & 15u) == 0 && f.sw % PPC == 0};
  };
  auto word_at = [&](const Src& s, const T* src, int wc, int gc) {
    if (s.vec && wc >= 0 && wc + PPW <= f.sw && gc >= 0 && gc + PPW <= W)
      return *reinterpret_cast<const uint32_t*>(src + wc);
    uint32_t w = 0u;
#pragma unroll
    for (int b = 0; b < PPW; ++b)
      if (wc + b >= 0 && wc + b < f.sw && gc + b >= 0 && gc + b < W)
        w |= (uint32_t)src[wc + b] << (8 * sizeof(T) * b);
    return w;
  };
  // chunk e % nch of input row j0 + e / nch
  auto chunk_at = [&](const Src& s, int j0, int e) {
    const int i = e / nch, m = e - i * nch;
    const int gr = s.r0 + j0 + i, wr = gr - f.row0 + f.halo;
    if (gr < 0 || gr >= H || wr < 0 || wr >= f.sh)
      return make_uint4(0u, 0u, 0u, 0u);
    const T* src = s.p + (size_t)wr * f.sw;
    const int wc = s.cs0 + PPC * m, gc = wc - f.halo + f.col0;
    if (s.vec16 && wc >= 0 && wc + PPC <= f.sw && gc >= 0 && gc + PPC <= W)
      return __ldg(reinterpret_cast<const uint4*>(src + wc));
    return make_uint4(word_at(s, src, wc, gc),
                      word_at(s, src, wc + PPW, gc + PPW),
                      word_at(s, src, wc + 2 * PPW, gc + 2 * PPW),
                      word_at(s, src, wc + 3 * PPW, gc + 3 * PPW));
  };
  auto put = [&](int e, uint4 v) {         // its words into staging
    const int i = e / nch, m = e - i * nch;
    const int q0 = (16 * m - lead) >> 2;
    uint32_t* dst = reinterpret_cast<uint32_t*>(st + i * SW) + q0;
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (q0 + k >= 0 && q0 + k < SW / 4) dst[k] = wd[k];
  };
  // input rows [j0, j0 + n) for staging rows 0..n-1: every x-pass thread
  // fetches up to RB chunks into registers before the x-pass of the rows
  // before them, so that the loads' latency hides under it, and stores
  // them as 32-bit words after it
  auto fetch = [&](const Src& s, int j0, int n, uint4 (&v)[RB]) {
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int e = gt + b * RG;
      v[b] = e < n * nch ? chunk_at(s, j0, e) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](const Src& s, int j0, int n, const uint4 (&v)[RB]) {
#pragma unroll
    for (int b = 0; b < RB; ++b)
      if (gt + b * RG < n * nch) put(gt + b * RG, v[b]);
    // chunks past what the registers hold, read now
    for (int e = gt + RB * RG; e < n * nch; e += RG)
      put(e, chunk_at(s, j0, e));
  };

  // an x-pass thread's 9 outputs of staging row `lane` (x-pass row j0 +
  // lane), and their quotients into its ring slot and the slot's mirror
  auto xcompute = [&](int n, float (&acc)[RXR]) {
#pragma unroll
    for (int j = 0; j < RXR; ++j) acc[j] = 0.0f;
    if (lane < n)
      sweep_taps(acc, k_s, window,
                 TexelLoad<T>{reinterpret_cast<const T*>(st + lane * SW)
                              + xoff + RXR * warp});
  };
  auto xwrite = [&](int j0, int n, const float (&acc)[RXR]) {
    if (lane >= n) return;
    const int s = (j0 + lane) % RING;
    float q[RXR];
#pragma unroll
    for (int j = 0; j < RXR; ++j)
      q[j] = __fdiv_rn(acc[j], cnt_x[RXR * warp + j]);
    float* dst = ring + s * RS + RXR * warp;
#pragma unroll
    for (int j = 0; j < RXR; ++j) dst[j] = q[j];
    if (s < RMIR) {
      dst += RING * RS;
#pragma unroll
      for (int j = 0; j < RXR; ++j) dst[j] = q[j];
    }
  };

  // ---- the taps, and the first segment's first input rows into
  //      registers ----
  uint4 next[RB];
  Walk sg = walk_of(sp, f.B);
  for (int t = tid; t < window; t += RT) k_s[t] = taps[t];
  Src rows = src_of(sg);
  if (xw) fetch(rows, 0, min(RTH, P), next);
  __syncthreads();
  // tap-order f32 sums of the in-image weights, 1 off the image: where the
  // whole window lies in the image the sum is `full`, the sum of every tap;
  // only the others sum their own, over the taps that land in the image
  float full = 0.0f;
  for (int t = 0; t < window; ++t) full = __fadd_rn(full, k_s[t]);
  auto divisor = [&](int g, int n) {
    if (g < 0 || g >= n) return 1.0f;
    if (g - c >= 0 && g + c < n) return full;
    float sum = 0.0f;
    for (int t = max(0, c - g), t1 = min(window, n + c - g); t < t1; ++t)
      sum = __fadd_rn(sum, k_s[t]);
    return sum;
  };

  if (xw) {
    // ---- x-pass warps: a segment's prologue rows [0, P), then a step's
    //      32 ----
    float acc[RXR];
    store(rows, 0, min(RTH, P), next);
    for (bool more = true; more;) {
      more = sg.rest > 0;
      // the strip's XW column divisors (the last quotients of the segment
      // before were written before the group's last barrier)
      for (int d = gt; d < XW; d += RG)
        cnt_x[d] = divisor(f.col0 + sg.tx0 - 4 + d, W);
      bar_sync(BAR_X, RG);             // staging holds rows 0..; divisors
      for (int j0 = 0; j0 < P;) {
        const int n = min(RTH, P - j0);
        // the rows after these: the rest of the prologue, or step 0's
        const int j1 = j0 + n, n1 = j1 < P ? min(RTH, P - j1) : RTH;
        fetch(rows, j1, n1, next);
        xcompute(n, acc);
        bar_sync(BAR_X, RG);           // every x-pass thread read staging
        store(rows, j1, n1, next);
        // the segment before's last step holds every slot until it is read
        // (before the first segment, the y-pass warps' first arrival)
        if (j0 == 0) bar_sync(BAR_EMPTY, RT);
        xwrite(j0, n, acc);
        bar_sync(BAR_X, RG);           // staging holds rows j1..
        j0 = j1;
      }
      bar_arrive(BAR_FULL, RT);        // the prologue's rows are written
      for (int k = 0;; ++k) {
        // the rows after step k's: step k + 1's, or after the last step the
        // next segment's first (the walk goes on to it here), or none
        const bool last = k + 1 == sg.steps;
        if (last && more) {
          sg.next(sp);
          rows = src_of(sg);
        }
        const int j1 = last ? 0 : P + RTH * (k + 1);
        const int n1 = !last ? RTH : more ? min(RTH, P) : 0;
        fetch(rows, j1, n1, next);
        xcompute(RTH, acc);
        bar_sync(BAR_X, RG);
        store(rows, j1, n1, next);
        bar_sync(BAR_EMPTY, RT);       // the rows these overwrite are read
        xwrite(P + RTH * k, RTH, acc);
        bar_arrive(BAR_FULL, RT);      // step k's rows are written
        bar_sync(BAR_X, RG);
        if (last) break;
      }
    }
  } else {
    // ---- y-pass warps: a segment's blurred rows 0..3, then a step's 32
    //      and the back half on them ----
    // 8 rows (yq) of column yx < 64, and row yr of column yt >= 64
    const int yx = gt % TILE_W, yq = gt / TILE_W;
    const int yt = TILE_W + (gt & 7), yr = gt >> 3;
    bar_arrive(BAR_EMPTY, RT);         // no segment before the first
    for (;; sg.next(sp)) {
      // blurred rows 0..3 and those of the first RDIV / RTH steps (the last
      // step's were read before the back half's first barrier)
      for (int d = gt, nd = 4 + min(sg.steps * RTH, RDIV); d < nd; d += RG)
        cnt_y[d] = divisor(f.row0 + RTH * sg.k0 - 2 + d, H);
      bar_sync(BAR_Y, RG);
      bar_sync(BAR_FULL, RT);          // the prologue's rows are written
      for (int i = gt; i < 4 * XW; i += RG) {    // 4 rows x 72 columns
        const int x = i % XW, b = i / XW;
        const float* col = ring + x;
        float acc = 0.0f;
        for (int t = 0; t < window; ++t)
          acc = __fadd_rn(acc, __fmul_rn(col[(b + t) * RS], k_s[t]));
        sm[b * XW + x] = floorf(__fdiv_rn(acc, cnt_y[b]));
      }
      bar_arrive(BAR_EMPTY, RT);       // x-pass rows 0..3 are read
      for (int k = 0; k < sg.steps; ++k) {
        // the divisor of blurred row b >= 4 lies at 4 + (b - 4) % RDIV:
        // every RDIV / RTH steps the next steps' rows take the slots of the
        // last ones' (read before the back half's barrier of step k - 1)
        const int bd = 4 + (RTH * k) % RDIV;
        if (k > 0 && bd == 4) {
          for (int i = gt; i < min(RDIV, RTH * (sg.steps - k)); i += RG)
            cnt_y[4 + i] = divisor(f.row0 + RTH * (sg.k0 + k) + 2 + i, H);
          bar_sync(BAR_Y, RG);
        }
        bar_sync(BAR_FULL, RT);        // step k's rows are written
        // blurred rows b = 4 + 32k + ... take x-pass rows b .. b + 2c
        const int b0 = 4 + RTH * k;
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
        sweep_taps(acc, k_s, window,
                   RingLoad{ring + yx, (b0 + 8 * yq) % RING, RING});
        float one[1] = {0.0f};
        sweep_taps(one, k_s, window,
                   RingLoad{ring + yt, (b0 + yr) % RING, RING});
        // step k's rows are read: the x-pass warps overwrite them with the
        // next step's, or the next segment's prologue
        if (k + 1 < sg.steps || sg.rest > 0) bar_arrive(BAR_EMPTY, RT);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sm[(4 + 8 * yq + j) * XW + yx] =
              floorf(__fdiv_rn(acc[j], cnt_y[bd + 8 * yq + j]));
        sm[(4 + yr) * XW + yt] = floorf(__fdiv_rn(one[0], cnt_y[bd + yr]));
        bar_sync(BAR_Y, RG);
        back_half<RTH, BAR_Y>(f, sm, mag, sg.z, RTH * (sg.k0 + k), sg.tx0,
                              gt, packed, mn, mx, nm_out, weak, strong);
        bar_sync(BAR_Y, RG);
        // blurred rows 32..35 are the next step's 0..3 (the next step's
        // "rows written" barrier orders the copy before its y-pass)
        for (int i = gt; i < 4 * XW; i += RG) sm[i] = sm[RTH * XW + i];
      }
      if (sg.rest == 0) break;
    }
  }
}

__global__ void __launch_bounds__(RT, 1)
frontend_ring_kernel(Frame f, const float* __restrict__ taps, int window,
                     Spans sp, int packed, int mn, int mx, int vec_ok,
                     int16_t* __restrict__ nm_out,
                     uint32_t* __restrict__ weak,
                     uint32_t* __restrict__ strong) {
  ring_block(f, taps, window, sp, packed, mn, mx, vec_ok, nm_out, weak,
             strong);
}

__global__ void __launch_bounds__(RT, 1)
frontend_ring_kernel(Frame16 f, const float* __restrict__ taps, int window,
                     Spans sp, int packed, int mn, int mx, int vec_ok,
                     int16_t* __restrict__ nm_out,
                     uint32_t* __restrict__ weak,
                     uint32_t* __restrict__ strong) {
  ring_block(f, taps, window, sp, packed, mn, mx, vec_ok, nm_out, weak,
             strong);
}

// the ring path's shared memory at this window, on pixels of `isz` bytes
int ring_smem_bytes(int window, int isz = 1) {
  return ring_geo(window, isz).bytes;
}

// The ring path's launch on B outputs of (oh, ow) at `window` taps on the
// current device, worked out in one place for the launch and for
// canny_frontend_ring_geometry / canny_frontend_ring_spans.  A segment
// costs its prologue of P = 4 + 2c x-pass rows and RTH rows a step; a
// prologue row costs w (RING_W10 / 10) of a step row (the x-pass warps run
// it alone).  Two ways to cut the launch's columns (strips x frames) of
// `steps` steps, and the one of least modelled time:
//   runs   each column in equal runs of r steps, ceil(steps / r) of them,
//          one block a run (grid (strips, runs, B)): ceil(blocks / slots)
//          waves of the card's co-resident blocks, each as long as a block,
//          w P + RTH r; r the cheapest (on equal costs the longer);
//   spans  the whole sequence in min(slots, steps columns) spans of
//          near-equal length, one block each (grid (blocks)), which cross
//          columns: one wave, as long as its costliest block, w P (its
//          segments) + RTH (its steps).
// On equal costs the spans: fewer blocks for the same time.  So a batch
// that overfills the card's slots spreads its steps over every slot, a
// single frame keeps short runs that fill the card once.  segments,
// xpass_rows and out_rows are summed over the grid; steps is the longest
// block's.  Pricing the spans takes microseconds of host time, so a host
// thread keeps its last RING_MEMO launches: a caller asks for the same
// shapes call after call.
struct RingLaunch {
  int slots, strips, runs;
  Spans sp;
  long long segments, steps, blocks, xpass_rows, out_rows;
};

// w in tenths: an x-pass warp's cycles a prologue row against a step row's
// (tools/k1_phases.py on the H100: 0.59-0.65 on 8 1080p frames at 121
// taps, 0.60-0.61 on one, 0.66-0.68 on one at 263)
constexpr long long RING_W10 = 6;
constexpr int RING_MEMO = 8;

cudaError_t ring_launch_of(int B, int oh, int ow, int window,
                           RingLaunch* g, int isz = 1) {
  struct Memo {
    int dev, B, oh, ow, window, isz;
    RingLaunch g;
  };
  static thread_local Memo memo[RING_MEMO];
  static thread_local int kept = 0, oldest = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < kept; ++i) {
    const Memo& m = memo[i];
    if (m.dev == dev && m.B == B && m.oh == oh && m.ow == ow
        && m.window == window && m.isz == isz) {
      *g = m.g;
      return cudaSuccess;
    }
  }
  // the blocks the card holds at once (which also sets the kernel's shared
  // memory attribute to the device's limit)
  void (*k8)(Frame, const float*, int, Spans, int, int, int, int, int16_t*,
             uint32_t*, uint32_t*) = frontend_ring_kernel;
  void (*k16)(Frame16, const float*, int, Spans, int, int, int, int,
              int16_t*, uint32_t*, uint32_t*) = frontend_ring_kernel;
  int slots = 0;
  e = masks::coop_blocks(isz == 1 ? (const void*)k8 : (const void*)k16, RT,
                         ring_smem_bytes(window, isz), 8, &slots);
  if (e != cudaSuccess) return e;
  const int strips = (ow + TILE_W - 1) / TILE_W, steps = (oh + RTH - 1) / RTH;
  const long long columns = (long long)strips * B, P = 4 + 2 * (window / 2);
  const long long total = columns * steps;
  // runs: n runs asked, runs of r steps, ceil(steps / r) <= n of them (at
  // most 65535, the grid's y)
  int r = steps;
  long long best = -1;
  for (int n = 1, most = min(steps, 65535); n <= most; ++n) {
    const int rn = (steps + n - 1) / n, m = (steps + rn - 1) / rn;
    const long long cost =
        (columns * m + slots - 1) / slots * (RING_W10 * P + 10LL * RTH * rn);
    if (best < 0 || cost < best) {
      best = cost;
      r = rn;
    }
  }
  // spans: one a slot, at most one a step; the costliest block's time
  const int n = (int)(total < slots ? total : slots);
  const Spans sp{strips, steps, 0, n};
  long long worst = 0, segments = 0, longest = 0;
  for (int i = 0; i < n; ++i) {
    long long b, e;
    span_of(sp, B, i, 0, 0, &b, &e);
    const int k = segments_of(sp, b, e);
    const long long cost = RING_W10 * P * k + 10LL * RTH * (e - b);
    worst = cost > worst ? cost : worst;
    segments += k;
    longest = e - b > longest ? e - b : longest;
  }
  const int runs = (steps + r - 1) / r;
  if (worst <= best)
    *g = RingLaunch{slots, strips, 1, sp, segments, longest, n, 0, 0};
  else
    *g = RingLaunch{slots, strips, runs, Spans{strips, steps, r, 0},
                    columns * runs, r, columns * runs, 0, 0};
  // every segment x-passes its prologue and its steps' rows
  g->xpass_rows = g->segments * P + RTH * total;
  g->out_rows = columns * oh;
  memo[oldest] = Memo{dev, B, oh, ow, window, isz, *g};
  kept = kept < RING_MEMO ? kept + 1 : kept;
  oldest = (oldest + 1) % RING_MEMO;
  return cudaSuccess;
}

template <typename F>
cudaError_t launch_ring(const F& f, const float* taps, int window,
                        int packed, int mn, int mx, int16_t* nm_out,
                        uint32_t* weak, uint32_t* strong,
                        cudaStream_t stream) {
  constexpr int isz = sizeof(PixelOf<F>);
  RingLaunch g;
  const cudaError_t e = ring_launch_of(f.B, f.oh, f.ow, window, &g, isz);
  if (e != cudaSuccess) return e;
  const dim3 grid = g.sp.run > 0 ? dim3(g.strips, g.runs, f.B)
                                 : dim3((unsigned)g.blocks, 1, 1);
  frontend_ring_kernel<<<grid, RT, ring_smem_bytes(window, isz), stream>>>(
      f, taps, window, g.sp, packed, mn, mx, f.sw % (4 / isz) == 0, nm_out,
      weak, strong);
  return cudaGetLastError();
}

template <typename F>
bool valid(const F& f, int window) {
  return !(f.oh <= 0 || f.ow <= 0 || f.H <= 0 || f.W <= 0 || f.halo < 0
           || f.B < 1 || f.B > 65535
           || f.sh != f.oh + 2 * f.halo || f.sw != f.ow + 2 * f.halo
           || window < 1 || window % 2 == 0);
}

// the tile instantiation of `window` (odd, 3..TILE_MAX), found from W up
template <int W, typename F>
cudaError_t launch_tile(int window, const F& f, const float* taps,
                        int packed, int mn, int mx, int16_t* nm_out,
                        uint32_t* weak, uint32_t* strong, cudaStream_t stream) {
  if constexpr (W > TILE_MAX) {
    return cudaErrorInvalidValue;
  } else {
    if (window == W)
      return launch<W>(f, taps, packed, mn, mx, nm_out, weak, strong, stream);
    return launch_tile<W + 2>(window, f, taps, packed, mn, mx, nm_out, weak,
                              strong, stream);
  }
}

// windows 3..TILE_MAX take their tile instantiation, every wider one the
// ring (cudaErrorInvalidValue past what its shared memory holds); a uint16
// frame only into the packed masks (its magnitudes pass an int16 map)
template <typename F>
int run(const F& f, const void* taps, int window, int packed, int mn,
        int mx, void* nm_out, void* weak, void* strong, void* stream) {
  if (!valid(f, window) || (sizeof(PixelOf<F>) == 2 && !packed))
    return (int)cudaErrorInvalidValue;
  const float* t = (const float*)taps;
  int16_t* nm = (int16_t*)nm_out;
  uint32_t *wk = (uint32_t*)weak, *sg = (uint32_t*)strong;
  cudaStream_t st = (cudaStream_t)stream;
  if (window <= TILE_MAX)
    return (int)launch_tile<3>(window, f, t, packed, mn, mx, nm, wk, sg, st);
  return (int)launch_ring(f, t, window, packed, mn, mx, nm, wk, sg, st);
}

// ---------------------------------------------------------------------------
// Windows past the ring's shared memory: the blur through device memory
// ---------------------------------------------------------------------------
//
// Output (oh, ow) at image pixel (row0, col0) needs the floored blur of rows
// [row0-2, row0+oh+2) and columns [col0-2, col0+ow+2): NY x NX floats.  Three
// kernels write it to scratch and a fourth reads tiles of it:
//   divisors  cnt_x (NX) and cnt_y (NY), the tap-order sums of the tile path;
//   x-pass    the renormalized row blur of rows [row0-2-c, row0+oh+2+c) (NT
//             rows) over the NX columns, one output a thread; a chunk of TCH
//             taps and the texels it reaches are staged in shared memory, the
//             chunks in ascending order, so any window sums in tap order;
//   y-pass    the floored column blur, YQ outputs a thread down a column from
//             a rolling window of YQ rows in registers;
//   tail      frontend_tail_kernel: a tile's slice of the blur into shared
//             memory (zero past the scratch, where nothing is read), then the
//             back half as above.
// The arithmetic is the tile path's (ascending taps, __fmul_rn / __fadd_rn,
// __fdiv_rn, floorf), so both give the same bits.  Off-image texels are 0 in
// the x-pass as in the tile's load.  Scratch, in floats: cnt_x | cnt_y
// (padded to 4) | tmp, B x NT x NX | blur, B x NY x NX.

constexpr int LX = 256;    // x-pass threads and outputs a block
constexpr int TCH = 256;   // x-pass taps a chunk
constexpr int LY = 128;    // y-pass threads a block, a column each
constexpr int YQ = 4;      // y-pass outputs a thread

struct Large {
  int nx, ny, nt;
  size_t tmp, blur, total;   // offsets and size of the scratch, in floats
};

__host__ __device__ inline Large large_of(int B, int oh, int ow, int window) {
  Large L;
  L.nx = ow + 4;
  L.ny = oh + 4;
  L.nt = oh + 4 + 2 * (window / 2);
  L.tmp = ((size_t)L.nx + L.ny + 3) / 4 * 4;
  L.blur = L.tmp + (size_t)B * L.nt * L.nx;
  L.total = L.blur + (size_t)B * L.ny * L.nx;
  return L;
}

__global__ void large_divisors(Frame f, const float* __restrict__ taps,
                               int window, float* __restrict__ cnt) {
  const Large L = large_of(1, f.oh, f.ow, window);
  const int c = window / 2;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < L.nx + L.ny;
       j += gridDim.x * blockDim.x) {
    const bool is_x = j < L.nx;
    const int g = is_x ? f.col0 - 2 + j : f.row0 - 2 + (j - L.nx);
    const int n = is_x ? f.W : f.H;
    float s = 1.0f;
    if (g >= 0 && g < n) {
      s = 0.0f;
      for (int t = 0; t < window; ++t) {
        const int q = g + t - c;
        if (q >= 0 && q < n) s = __fadd_rn(s, taps[t]);
      }
    }
    cnt[j] = s;
  }
}

// the x-pass's block on frame f (Frame or Frame16): the body of both
// large_xpass overloads
template <typename F>
__device__ __forceinline__ void xpass_block(const F& f,
                                            const float* __restrict__ taps,
                                            int window,
                                            const float* __restrict__ cnt_x,
                                            float* __restrict__ tmp) {
  __shared__ float tex[LX + TCH];      // texels of outputs x0.. at taps t0..
  __shared__ float k_s[TCH];
  using T = PixelOf<F>;
  const Large L = large_of(1, f.oh, f.ow, window);
  const int c = window / 2, tid = threadIdx.x;
  const int x0 = blockIdx.x * LX, x = x0 + tid;
  const T* fsrc = f.src + (size_t)blockIdx.z * f.sh * f.sw;
  float* ftmp = tmp + (size_t)blockIdx.z * L.nt * L.nx;
  const float cx = x < L.nx ? cnt_x[x] : 1.0f;
  for (int i = blockIdx.y; i < L.nt; i += gridDim.y) {
    // image row gr, window row wr; output x is image column col0 - 2 + x
    const int gr = f.row0 - 2 - c + i, wr = gr - f.row0 + f.halo;
    const bool row_in = gr >= 0 && gr < f.H && wr >= 0 && wr < f.sh;
    const T* src = fsrc + (size_t)(row_in ? wr : 0) * f.sw;
    float acc = 0.0f;
    for (int t0 = 0; t0 < window; t0 += TCH) {
      const int n = min(TCH, window - t0);
      __syncthreads();                 // the chunk before has been read
      for (int q = tid; q < LX + TCH; q += LX) {
        const int gc = f.col0 - 2 - c + x0 + t0 + q;
        const int wc = gc - f.col0 + f.halo;
        tex[q] = row_in && gc >= 0 && gc < f.W && wc >= 0 && wc < f.sw
                     ? (float)src[wc] : 0.0f;
      }
      for (int q = tid; q < n; q += LX) k_s[q] = taps[t0 + q];
      __syncthreads();
      for (int t = 0; t < n; ++t)
        acc = __fadd_rn(acc, __fmul_rn(tex[tid + t], k_s[t]));
    }
    if (x < L.nx) ftmp[(size_t)i * L.nx + x] = __fdiv_rn(acc, cx);
  }
}

__global__ void __launch_bounds__(LX)
large_xpass(Frame f, const float* __restrict__ taps, int window,
            const float* __restrict__ cnt_x, float* __restrict__ tmp) {
  xpass_block(f, taps, window, cnt_x, tmp);
}

__global__ void __launch_bounds__(LX)
large_xpass(Frame16 f, const float* __restrict__ taps, int window,
            const float* __restrict__ cnt_x, float* __restrict__ tmp) {
  xpass_block(f, taps, window, cnt_x, tmp);
}

__global__ void __launch_bounds__(LY)
large_ypass(Frame f, const float* __restrict__ taps, int window,
            const float* __restrict__ cnt_y, const float* __restrict__ tmp,
            float* __restrict__ blur) {
  const Large L = large_of(1, f.oh, f.ow, window);
  const int x = blockIdx.x * LY + threadIdx.x;
  if (x >= L.nx) return;               // no barrier below
  const float* ftmp = tmp + (size_t)blockIdx.z * L.nt * L.nx + x;
  float* fblur = blur + (size_t)blockIdx.z * L.ny * L.nx + x;
  for (int j0 = blockIdx.y * YQ; j0 < L.ny; j0 += gridDim.y * YQ) {
    // output j0 + q takes tmp row j0 + q + t at tap t: v[q] holds it
    float acc[YQ], v[YQ];
#pragma unroll
    for (int q = 0; q < YQ; ++q) {
      acc[q] = 0.0f;
      v[q] = j0 + q < L.nt ? ftmp[(size_t)(j0 + q) * L.nx] : 0.0f;
    }
    for (int t = 0; t < window; ++t) {
      const float kt = __ldg(taps + t);
#pragma unroll
      for (int q = 0; q < YQ; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(v[q], kt));
#pragma unroll
      for (int q = 0; q + 1 < YQ; ++q) v[q] = v[q + 1];
      const int r = j0 + YQ + t;
      v[YQ - 1] = r < L.nt ? ftmp[(size_t)r * L.nx] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < YQ; ++q)
      if (j0 + q < L.ny)
        fblur[(size_t)(j0 + q) * L.nx] =
            floorf(__fdiv_rn(acc[q], cnt_y[j0 + q]));
  }
}

// the tail's block on frame f (Frame or Frame16): the body of both
// frontend_tail_kernel overloads
template <typename F>
__device__ __forceinline__ void tail_block(const F& f,
                                           const float* __restrict__ blur,
                                           int packed, int mn, int mx,
                                           int16_t* __restrict__ nm_out,
                                           uint32_t* __restrict__ weak,
                                           uint32_t* __restrict__ strong) {
  __shared__ __align__(16) float sm[SM_H * XW];
  __shared__ __align__(16) MagOf<F> mag[MAG_H * MAG_W];
  const int nx = f.ow + 4, ny = f.oh + 4;
  const float* fb = blur + (size_t)blockIdx.z * ny * nx;
  // shared row y, column x: blur row ty0 + y, column tx0 - 2 + x
  const int ty0 = blockIdx.y * TILE_H, tx0 = blockIdx.x * TILE_W;
  for (int i = threadIdx.x; i < SM_H * XW; i += THREADS) {
    const int by = ty0 + i / XW, bx = tx0 - 2 + i % XW;
    sm[i] = by < ny && bx >= 0 && bx < nx ? fb[(size_t)by * nx + bx] : 0.0f;
  }
  __syncthreads();
  back_half(f, sm, mag, blockIdx.z, ty0, tx0, (int)threadIdx.x, packed, mn,
            mx, nm_out, weak, strong);
}

__global__ void __launch_bounds__(THREADS, 4)
frontend_tail_kernel(Frame f, const float* __restrict__ blur, int packed,
                     int mn, int mx, int16_t* __restrict__ nm_out,
                     uint32_t* __restrict__ weak,
                     uint32_t* __restrict__ strong) {
  tail_block(f, blur, packed, mn, mx, nm_out, weak, strong);
}

__global__ void __launch_bounds__(THREADS, 4)
frontend_tail_kernel(Frame16 f, const float* __restrict__ blur, int packed,
                     int mn, int mx, int16_t* __restrict__ nm_out,
                     uint32_t* __restrict__ weak,
                     uint32_t* __restrict__ strong) {
  tail_block(f, blur, packed, mn, mx, nm_out, weak, strong);
}

// the geometry of a frame, as the kernels that read no pixel take it
inline const Frame& shape_of(const Frame& f) { return f; }
inline Frame shape_of(const Frame16& f) {
  Frame g;
  g.src = nullptr;
  g.sh = f.sh, g.sw = f.sw, g.halo = f.halo, g.oh = f.oh, g.ow = f.ow;
  g.row0 = f.row0, g.col0 = f.col0, g.H = f.H, g.W = f.W, g.B = f.B;
  return g;
}

template <typename F>
int run_large(const F& f, const float* taps, int window, int packed,
              int mn, int mx, void* nm_out, void* weak, void* strong,
              float* scratch, unsigned long long scratch_floats,
              cudaStream_t stream) {
  const Large L = large_of(f.B, f.oh, f.ow, window);
  if (scratch == nullptr || scratch_floats < L.total
      || (sizeof(PixelOf<F>) == 2 && !packed))
    return (int)cudaErrorInvalidValue;
  float* cnt = scratch;
  float* tmp = scratch + L.tmp;
  float* blur = scratch + L.blur;
  large_divisors<<<(L.nx + L.ny + 255) / 256, 256, 0, stream>>>(
      shape_of(f), taps, window, cnt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  large_xpass<<<dim3((L.nx + LX - 1) / LX, min(L.nt, 65535), f.B), LX, 0,
                stream>>>(f, taps, window, cnt, tmp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  large_ypass<<<dim3((L.nx + LY - 1) / LY, min((L.ny + YQ - 1) / YQ, 65535),
                     f.B), LY, 0, stream>>>(shape_of(f), taps, window,
                                            cnt + L.nx, tmp, blur);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid((f.ow + TILE_W - 1) / TILE_W, (f.oh + TILE_H - 1) / TILE_H,
                  f.B);
  frontend_tail_kernel<<<grid, THREADS, 0, stream>>>(
      f, blur, packed, mn, mx, (int16_t*)nm_out, (uint32_t*)weak,
      (uint32_t*)strong);
  return (int)cudaGetLastError();
}

// `img` as the frame of `isz` bytes a pixel (Frame for 1, Frame16 for 2)
// it is, handed to `fn`; cudaErrorInvalidValue for another size
template <typename Fn>
int on_frame(const void* img, int isz, int sh, int sw, int halo, int oh,
             int ow, int row0, int col0, int H, int W, int B, Fn fn) {
  if (isz == 1)
    return fn(Frame{(const uint8_t*)img, sh, sw, halo, oh, ow, row0, col0, H,
                    W, B});
  if (isz == 2)
    return fn(Frame16{(const uint16_t*)img, sh, sw, halo, oh, ow, row0, col0,
                      H, W, B});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of a block of canny_frontend and canny_frontend_block at
// `window` taps (odd, >= 3) on pixels of `isz` bytes, on the path the
// window takes: the tile path's up to TILE_MAX, the ring path's above.
int canny_frontend_smem_bytes(int window, int isz) {
  return window <= TILE_MAX ? smem_bytes(window, isz)
                            : ring_smem_bytes(window, isz);
}

// The largest odd window that canny_frontend and canny_frontend_block take
// on the current device for pixels of `isz` bytes (0 if the device cannot
// be asked): 3..103 on the tile path, from 105 on the ring path up to what
// a block's shared memory holds (a uint16 frame's ring input and
// magnitudes take twice the bytes).  A wider window takes
// canny_frontend_large.
int canny_frontend_max_window(int isz) {
  const int limit = masks::smem_optin_limit();
  int w = 1;
  while (canny_frontend_smem_bytes(w + 2, isz) <= limit) w += 2;
  return w < 3 ? 0 : w;
}

// The ring path's launch on B outputs of (oh, ow) at `window` taps (odd,
// past TILE_MAX) on the current device, for pixels of `isz` bytes, as
// canny_frontend and canny_frontend_block launch it (ring_launch_of):
// geo[0..6] = the card's co-resident blocks, strips, segments, the steps
// of the longest block, blocks, x-pass rows and output rows (segments and
// rows summed over the blocks).  Returns cudaErrorInvalidValue for another
// window or an empty batch, and past what the ring's shared memory holds.
int canny_frontend_ring_geometry(int B, int oh, int ow, int window,
                                 long long* geo, int isz) {
  if (B < 1 || B > 65535 || oh < 1 || ow < 1 || window <= TILE_MAX
      || window % 2 == 0 || (isz != 1 && isz != 2))
    return (int)cudaErrorInvalidValue;
  RingLaunch g;
  const cudaError_t e = ring_launch_of(B, oh, ow, window, &g, isz);
  if (e != cudaSuccess) return (int)e;
  const long long v[7] = {g.slots, g.strips, g.segments, g.steps, g.blocks,
                          g.xpass_rows, g.out_rows};
  for (int i = 0; i < 7; ++i) geo[i] = v[i];
  return 0;
}

// The spans of a uint8 frame's launch's blocks (Spans), as its blocks walk
// them:
// span[2 i] and span[2 i + 1] are the first step of block i's span and the
// step past its last, in the launch's sequence of steps (frame, strip, step
// of ceil(oh / 32)), for the blocks in the grid's order (x, then y, then
// z); at most n blocks are written.  Returns as
// canny_frontend_ring_geometry.
int canny_frontend_ring_spans(int B, int oh, int ow, int window,
                              long long* span, long long n) {
  if (B < 1 || B > 65535 || oh < 1 || ow < 1 || window <= TILE_MAX
      || window % 2 == 0)
    return (int)cudaErrorInvalidValue;
  RingLaunch g;
  const cudaError_t e = ring_launch_of(B, oh, ow, window, &g);
  if (e != cudaSuccess) return (int)e;
  const int gx = g.sp.run > 0 ? g.strips : (int)g.blocks;
  const int gy = g.sp.run > 0 ? g.runs : 1, gz = g.sp.run > 0 ? B : 1;
  long long i = 0;
  for (int z = 0; z < gz; ++z)
    for (int y = 0; y < gy; ++y)
      for (int x = 0; x < gx && i < n; ++x, ++i)
        span_of(g.sp, B, x, y, z, span + 2 * i, span + 2 * i + 1);
  return 0;
}

// img: (B, H, W) of `isz` bytes a pixel (1: uint8, 2: uint16), 1 <= B <=
// 65535; taps: float32 (window); packed == 0 -> nm_out int16 (B, H, W);
// packed != 0 -> weak/strong uint32 (B, H, ceil(W/32)).  A uint16 frame
// goes into the packed masks only (its magnitudes pass an int16 map).  One
// launch on `stream` for the batch; returns cudaGetLastError().  Windows
// 3..103 run their own unrolled instantiation, wider ones the ring path, up
// to canny_frontend_max_window(isz).
int canny_frontend(const void* img, int isz, int B, int H, int W,
                   const void* taps, int window, int packed, int mn, int mx,
                   void* nm_out, void* weak, void* strong, void* stream) {
  return on_frame(img, isz, H, W, 0, H, W, 0, 0, H, W, B, [&](auto f) {
    return run(f, taps, window, packed, mn, mx, nm_out, weak, strong, stream);
  });
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
                oh, ow, row0, col0, H, W, 1};
  return run(f, taps, window, packed, mn, mx, nm_out, weak, strong, stream);
}

// Any odd window, the blur through device memory (see run_large): img is
// (B, oh + 2 halo, ow + 2 halo) of `isz` bytes a pixel (uint16 into the
// packed masks only), its texel (halo, halo) pixel (row0, col0) of an (H,
// W) image (the whole image: halo 0, (0, 0), (H, W) = (oh, ow)); outputs as
// canny_frontend_block's, a frame apart for a batch.  scratch:
// scratch_floats float32, at least (ow + 4 + oh + 4, rounded up to a
// multiple of 4) + B (ow + 4) (2 oh + 8 + 2 (window / 2)); fewer is
// refused.  Four launches on `stream`; returns cudaGetLastError().
int canny_frontend_large(const void* img, int isz, int B, int halo, int oh,
                         int ow, int row0, int col0, int H, int W,
                         const void* taps, int window, int packed, int mn,
                         int mx, void* nm_out, void* weak, void* strong,
                         void* scratch, unsigned long long scratch_floats,
                         void* stream) {
  return on_frame(img, isz, oh + 2 * halo, ow + 2 * halo, halo, oh, ow, row0,
                  col0, H, W, B, [&](auto f) {
    if (!valid(f, window)) return (int)cudaErrorInvalidValue;
    return run_large(f, (const float*)taps, window, packed, mn, mx, nm_out,
                     weak, strong, (float*)scratch, scratch_floats,
                     (cudaStream_t)stream);
  });
}

// K2's C entry, canny_hysteresis_packed (csrc/hysteresis_packed.cu, its own
// library), as a launch plan holds it.
typedef int (*FloodEntry)(void* weak, void* strong, const void* nm,
                          int nm_bytes, int lo, int hi, void* edges,
                          void* out16, int B, int H, int W, int strict,
                          int quirk_row, int quirk_word, void* scratch,
                          void* total_steps, unsigned long long token,
                          void* stream);

// A launch plan of the fused pipeline (kernels/plan.py:Args, field for
// field): everything a request on a whole (B, H, W) batch needs but its
// input, its output and its token; isz: its input's bytes a pixel (1:
// uint8, 2: uint16).
struct Plan {
  const void* taps;     // float32 (window), 3 <= window <= max window
  void* weak;           // K1's masks, K2's inputs: uint32 (B, H, ceil(W/32))
  void* strong;
  void* edges;          // K2's packed edges where the output is int16 (B,
                        // H, W); null: the output is the packed edges
  void* scratch;        // K2's control words
  void* total_steps;    // the card's u64 step word
  void* stream;
  FloodEntry flood;
  int device, B, H, W, window, mn, mx, strict, isz;
};

// One request of a plan: K1 from `img` ((B, H, W) of the plan's isz bytes
// a pixel) into the plan's masks with its bounds, then K2
// (strict at pixel (0, 0), a fresh `token`) into `out`, both on the plan's
// stream, with the plan's device current for the call.  Returns 0, K1's error, or minus K2's error.
int canny_run_plan(const void* plan, const void* img, void* out,
                   unsigned long long token) {
  const Plan& p = *(const Plan*)plan;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != p.device) e = cudaSetDevice(p.device);
  if (e != cudaSuccess) return (int)e;
  int err = on_frame(img, p.isz, p.H, p.W, 0, p.H, p.W, 0, 0, p.H, p.W, p.B,
                     [&](auto f) {
    return run(f, p.taps, p.window, 1, p.mn, p.mx, nullptr, p.weak, p.strong,
               p.stream);
  });
  if (err == 0)
    err = -p.flood(p.weak, p.strong, nullptr, 0, 0, 0,
                   p.edges ? p.edges : out, p.edges ? out : nullptr, p.B,
                   p.H, p.W, p.strict, 0, 0, p.scratch, p.total_steps, token,
                   p.stream);
  if (dev != p.device) cudaSetDevice(dev);
  return err;
}

}  // extern "C"
