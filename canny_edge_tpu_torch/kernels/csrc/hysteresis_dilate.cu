// K3: the tiled-dilation hysteresis engine on Hopper.
//
// Replaces the Pallas kernel _hyst_kernel of
// canny_edge_tpu/kernels/hysteresis.py and the sweeps around it (_sweep,
// hysteresis_pallas): hysteresis_impl="dilate".  Plain version:
// canny_edge_tpu_torch/ops/dilate.py.
//
// The image is cut into (th, tw) tiles.  A sweep is one launch, one block per
// tile: the block reads the tile with a 1-pixel halo (the window) from the
// pre-sweep packed edge mask into shared memory, bit-packed, floods the
// window to its local fixed point and writes the tile's interior to the
// other buffer of a pair.  Reading one buffer and writing the other gives
// every tile the pre-sweep state, as on the TPU, so each sweep's result, and
// the sweep count, equal the plain version's.
//
// The local fixed point is the set of window pixels that are weak and
// 8-connected inside the window to an edge pixel; it is unique, so the
// block may reach it in any order.  One local round is
//   rows     one thread per window row: carry-add flood along the row's
//            words, toward higher then lower columns;
//   columns  one thread per window word column: a pass down the rows, each
//            word gaining the weak bits next to the row above (straight and
//            diagonal), then a pass up from the row below;
// and rounds repeat until one changes nothing (__syncthreads_or, so every
// thread takes the same exit).  A column thread may read a neighbouring
// column's word before or after that column's thread updates it; words only
// gain bits that are weak and connected, and a round that changed nothing
// read a stable window, so either value is safe.
//
// Tile columns need not fall on word boundaries: the window's words are
// read with a funnel shift, and a tile writes a global word it shares with a
// neighbouring tile with atomicOr of its own bits.  The write buffer holds
// the state of two sweeps ago, a subset of the new state, so OR-ing the new
// bits in gives the new state.
//
// Bound: the function reads nm (2 B/px) and writes int16 (2 B/px); a sweep
// moves two packed masks (1/16 B/px).  Its cost is sweeps (tile crossings of
// the longest chain) times local rounds (bends inside a tile), each a few
// hundred dependent shared-memory steps.  The host drives the sweeps and
// reads the changed flags in batches of 2, 4, 8, ... sweeps (one host sync
// a batch); a sweep run after the fixed point changes nothing.

#include "masks.cuh"

namespace {

constexpr int THREADS = 256;

using masks::hrow;
using masks::run_fill;
using masks::run_fill_down;

// 32 bits of global row gr starting at global column g (g >= -1); zero
// outside the image
__device__ __forceinline__ uint32_t window_word(const uint32_t* m, int H,
                                                int wd, int gr, int g) {
  if (gr < 0 || gr >= H) return 0u;
  const int gw = (g + 32) / 32 - 1;            // floor(g / 32) for g >= -32
  const int off = g - 32 * gw;
  const uint32_t* row = m + (size_t)gr * wd;
  const uint32_t lo = (gw >= 0 && gw < wd) ? row[gw] : 0u;
  const uint32_t hi = (gw + 1 < wd) ? row[gw + 1] : 0u;
  return __funnelshift_r(lo, hi, off);
}

__global__ void __launch_bounds__(THREADS)
sweep_kernel(const uint32_t* __restrict__ weak, const uint32_t* __restrict__ ein,
             uint32_t* __restrict__ eout, int H, int W, int th, int tw,
             int* __restrict__ changed) {
  extern __shared__ uint32_t smem[];
  const int wd = (W + 31) / 32;
  const int R = th + 2, nw = (tw + 2 + 31) / 32, n = R * nw;
  uint32_t* w_s = smem;           // window weak, R x nw words
  uint32_t* e_s = smem + n;       // window edges
  uint32_t* o_s = smem + 2 * n;   // window edges before the sweep
  const int r0 = blockIdx.y * th, c0 = blockIdx.x * tw;
  const int tid = threadIdx.x;
  // bit b of window word k is global column c0 - 1 + 32k + b; the bits past
  // the window's tw + 2 columns are cleared
  const int tail = tw + 2 - 32 * (nw - 1);
  const uint32_t tail_mask = tail == 32 ? 0xffffffffu : (1u << tail) - 1u;

  for (int i = tid; i < n; i += THREADS) {
    const int y = i / nw, k = i % nw;
    const int gr = r0 - 1 + y, g = c0 - 1 + 32 * k;
    const uint32_t keep = k == nw - 1 ? tail_mask : 0xffffffffu;
    w_s[i] = window_word(weak, H, wd, gr, g) & keep;
    const uint32_t e = window_word(ein, H, wd, gr, g) & keep & w_s[i];
    e_s[i] = e;
    o_s[i] = e;
  }
  __syncthreads();

  for (;;) {
    bool mod = false;
    for (int y = tid; y < R; y += THREADS) {
      uint32_t* er = e_s + y * nw;
      const uint32_t* wr = w_s + y * nw;
      uint32_t carry = 0;
      for (int k = 0; k < nw; ++k) {
        const uint32_t v = run_fill(wr[k], er[k], carry);
        if (v != er[k]) { er[k] = v; mod = true; }
      }
      carry = 0;
      for (int k = nw - 1; k >= 0; --k) {
        const uint32_t v = run_fill_down(wr[k], er[k], carry);
        if (v != er[k]) { er[k] = v; mod = true; }
      }
    }
    __syncthreads();
    for (int k = tid; k < nw; k += THREADS) {
      for (int y = 1; y < R; ++y) {
        const uint32_t* up = e_s + (y - 1) * nw;
        const uint32_t h = hrow(k > 0 ? up[k - 1] : 0u, up[k],
                                k + 1 < nw ? up[k + 1] : 0u);
        const uint32_t old = e_s[y * nw + k];
        const uint32_t v = old | (w_s[y * nw + k] & h);
        if (v != old) { e_s[y * nw + k] = v; mod = true; }
      }
      for (int y = R - 2; y >= 0; --y) {
        const uint32_t* dn = e_s + (y + 1) * nw;
        const uint32_t h = hrow(k > 0 ? dn[k - 1] : 0u, dn[k],
                                k + 1 < nw ? dn[k + 1] : 0u);
        const uint32_t old = e_s[y * nw + k];
        const uint32_t v = old | (w_s[y * nw + k] & h);
        if (v != old) { e_s[y * nw + k] = v; mod = true; }
      }
    }
    if (!__syncthreads_or(mod)) break;
  }

  // the interior: tile rows r0..r0+th-1 and columns c0..c0+tw-1 in the image
  const int cend = min(c0 + tw, W);
  const int gw0 = c0 / 32, ngw = (cend - 1) / 32 - gw0 + 1;
  bool diff = false;
  for (int i = tid; i < th * ngw; i += THREADS) {
    const int y = 1 + i / ngw, gw = gw0 + i % ngw;
    const int gr = r0 + y - 1;
    if (gr >= H) continue;
    // global column 32 gw is window column wc (-30 <= wc <= 1)
    const int wc = 32 * gw - c0 + 1;
    const int k = (wc + 32) / 32 - 1, off = wc - 32 * k;
    const uint32_t* er = e_s + y * nw;
    const uint32_t* orow = o_s + y * nw;
    const bool has_lo = k >= 0, has_hi = k + 1 < nw;
    const uint32_t v = __funnelshift_r(has_lo ? er[k] : 0u,
                                       has_hi ? er[k + 1] : 0u, off);
    const uint32_t ov = __funnelshift_r(has_lo ? orow[k] : 0u,
                                        has_hi ? orow[k + 1] : 0u, off);
    const int a = max(c0, 32 * gw) - 32 * gw, b = min(cend, 32 * gw + 32) - 32 * gw;
    const uint32_t own = (b - a == 32) ? 0xffffffffu : (((1u << (b - a)) - 1u) << a);
    diff |= ((v ^ ov) & own) != 0u;
    uint32_t* dst = eout + (size_t)gr * wd + gw;
    if (own == 0xffffffffu)
      *dst = v;
    else
      atomicOr(dst, v & own);
  }
  if (__syncthreads_or(diff) && tid == 0) *changed = 1;
}

size_t smem_bytes(int th, int tw) {
  return (size_t)3 * (th + 2) * ((tw + 2 + 31) / 32) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Dynamic shared memory one sweep block needs for a (th, tw) tile, and the
// most this device gives a block (-1 if it cannot be read).
int canny_dilate_smem_bytes(int th, int tw) {
  const size_t b = smem_bytes(th, tw);
  return b > INT_MAX ? INT_MAX : (int)b;
}
int canny_dilate_smem_limit() { return masks::smem_optin_limit(); }

// weak = nm >= lo and seed = nm >= hi into packed (H, ceil(W/32)) uint32.
int canny_dilate_pack(const void* nm, int nm_bytes, int H, int W, int lo,
                      int hi, void* weak, void* seed, void* stream) {
  return (int)masks::launch_pack(nm, nm_bytes, H, W, lo, hi, weak, seed,
                                 (cudaStream_t)stream);
}

// One sweep: ein -> eout (packed edges; eout must hold a subset of the
// result, e.g. the state of the sweep before ein's); *changed is set to 1 if
// a tile's interior changed.  Launches on `stream`; returns
// cudaGetLastError().
int canny_dilate_sweep(const void* weak, const void* ein, void* eout, int H,
                       int W, int th, int tw, void* changed, void* stream) {
  if (H <= 0 || W <= 0 || th <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(th, tw);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th);
  sweep_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)weak, (const uint32_t*)ein, (uint32_t*)eout, H, W, th,
      tw, (int*)changed);
  return (int)cudaGetLastError();
}

// packed edges -> int16 {0, 255} (H, W)
int canny_dilate_unpack(const void* e, int H, int W, void* out, void* stream) {
  return (int)masks::launch_unpack(e, H, W, out, (cudaStream_t)stream);
}

}  // extern "C"
