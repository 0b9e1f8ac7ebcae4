// K3: the tiled-dilation hysteresis engine on Hopper, one launch a call.
//
// Replaces the Pallas kernel _hyst_kernel of
// canny_edge_tpu/kernels/hysteresis.py and the sweeps around it (_sweep,
// hysteresis_pallas, with the threshold compares before them and the int16
// select after): hysteresis_impl="dilate".  Plain versions:
// canny_edge_tpu_torch/ops/dilate.py (the function) and ops/dilate_tiles.py
// (this kernel's dirty-tile rule, sweep for sweep).
//
// What it computes.  The image is cut into (th, tw) tiles.  A sweep floods
// every tile's window (the tile with a 1-pixel halo, read from the pre-sweep
// packed edge mask) to its local fixed point, the window's weak pixels
// 8-connected inside the window to an edge pixel, and keeps the tile's
// interior.  Reading one buffer of a pair and writing the other gives every
// tile the pre-sweep state, as on the TPU, so each sweep's result, and the
// sweep count, equal the plain version's.  Sweeps 0 and 1 always run; sweeps
// go on until one changes nothing.
//
// Bound: the function reads nm (2 B/px) and writes int16 (2 B/px), 2.5 us of
// HBM time at 1080p.  What it costs on this card is latency: the launches
// and host syncs around the sweeps, and inside a tile the dependent steps
// of its flood.  The design:
//   one launch   a cooperative persistent kernel: pack (every thread of the
//             grid, 16-byte loads), grid sync, the sweeps with one grid sync
//             each, unpack (16-byte stores), the sweep count.  Blocks stride
//             over the tiles, whose number is the caller's.  The "a tile
//             changed" word and the per-tile flags hold a token (launch
//             sequence number + sweep), double buffered: nothing is cleared
//             and nothing comes back to the host inside a call.
//   every thread floods   the window lies in shared memory, bit-packed, and
//             is cut into sub-tiles of 8 rows x 32 words.  A warp takes a
//             sub-tile into registers (lane = word) and floods it to its own
//             fixed point as K2 floods a tile: dilation (neighbour words by
//             shuffles, neighbour rows in registers, the rows above and
//             below and the words beside it read once from shared memory),
//             a flood along each row (carry-add inside a word, the carries
//             between words scanned on the warp's ballots) and down and up
//             each column, until a dilation changes nothing.  Changed rows go
//             back to shared memory; the block repeats such rounds until no
//             sub-tile changed (__syncthreads_or).  A warp may read a
//             neighbour's row before or after that warp's write of the same
//             round: words only gain bits that are weak and connected, and a
//             round that changed nothing read a stable window.  The flood
//             of a sub-tile is K2's own (masks.cuh: tile_halo, tile_flood).
//   dirty tiles   a tile's output in sweep i equals its output in sweep i-1
//             when no pixel of its window changed in sweep i-1, and the
//             write buffer (the state of two sweeps ago) already holds it
//             when the tile's own interior did not change in sweep i-1.  So
//             from sweep 2 on a tile runs only if it or one of its 8
//             neighbours changed in the sweep before.  Every intermediate
//             state stays the plain version's.
//
// Tile columns need not fall on word boundaries: the window's words are
// read with a funnel shift, and a tile writes a global word it shares with a
// neighbouring tile with atomicOr of its own bits.  The write buffer holds
// the state of two sweeps ago (zeros before sweep 1), a subset of the new
// state, so OR-ing the new bits in gives the new state.
//
// Shared memory: three masks of (th + 2) x ceil((tw + 2) / 32) words (weak,
// edges, edges before the sweep).  A tile that does not fit is refused by
// the wrapper.

#include <cooperative_groups.h>

#include "masks.cuh"

namespace cg = cooperative_groups;

namespace {

using masks::pack_any;
using masks::unpack_phase;

typedef unsigned long long u64;

constexpr uint32_t FULL = 0xffffffffu;
constexpr int THREADS = 576;         // 18 warps: the default window has 17 sub-tiles
constexpr int WARPS = THREADS / 32;
constexpr int SR = masks::TILE_ROWS; // rows of a sub-tile, in registers

struct Args {
  const void* nm;      // int16 / int32 NMS map (H, W)
  int nm_bytes, lo, hi;
  uint32_t* weak;      // scratch, (H, ceil(W/32)) words each
  uint32_t* e0;
  uint32_t* e1;
  int16_t* out;        // int16 {0, 255} (H, W)
  int H, W, th, tw;
  u64* flags;          // 2 x ntiles "changed in that sweep" tokens
  u64* any;            // 2 "a tile changed" tokens
  int* stats;          // sweeps, tile floods run, local rounds summed
  u64 token;           // launch sequence number << 32
};

// 32 bits of global row gr starting at global column g (g >= -1); zero
// outside the image
__device__ __forceinline__ uint32_t window_word(const uint32_t* m, int H,
                                                int wd, int gr, int g) {
  if (gr < 0 || gr >= H) return 0u;
  const int gw = (g + 32) / 32 - 1;            // floor(g / 32) for g >= -32
  const int off = g - 32 * gw;
  const uint32_t* row = m + (size_t)gr * wd;
  const uint32_t lo = (gw >= 0 && gw < wd) ? __ldcg(row + gw) : 0u;
  const uint32_t hi = (gw + 1 < wd) ? __ldcg(row + gw + 1) : 0u;
  return __funnelshift_r(lo, hi, off);
}

// Flood the window e_s (R x nw words, weak mask w_s) to its fixed point, all
// warps of the block together.  Returns the number of block-wide rounds.
__device__ int flood_window(const uint32_t* w_s, uint32_t* e_s, int R, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsx = (nw + 31) / 32, nsub = nsx * ((R + SR - 1) / SR);
  auto LD = [&](const uint32_t* m, int y, int k) -> uint32_t {
    return (y >= 0 && y < R && k >= 0 && k < nw) ? m[y * nw + k] : 0u;
  };
  int rounds = 0;
  for (;;) {
    uint32_t moved = 0u;
    for (int st = warp; st < nsub; st += WARPS) {
      const int y0 = (st / nsx) * SR, k0 = (st % nsx) * 32, k = k0 + lane;
      uint32_t w[SR], e[SR], o[SR], hx[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        w[r] = LD(w_s, y0 + r, k);
        e[r] = o[r] = LD(e_s, y0 + r, k);
      }
      // the fixed surroundings: the rows above and below, and the word
      // columns left and right (lane L holds row y0 - 1 + L)
      const uint32_t top = LD(e_s, y0 - 1, k), bot = LD(e_s, y0 + SR, k);
      const uint32_t lcol = lane < SR + 2 ? LD(e_s, y0 - 1 + lane, k0 - 1) : 0u;
      const uint32_t rcol = lane < SR + 2 ? LD(e_s, y0 - 1 + lane, k0 + 32) : 0u;
      uint32_t htop, hbot;
      masks::tile_halo(top, bot, lcol, rcol, lane, htop, hbot, hx);
      masks::tile_flood(w, e, htop, hbot, hx, lane,
                        [](int, uint32_t d, uint32_t, uint32_t, uint32_t) {
                          return d;
                        });
#pragma unroll
      for (int r = 0; r < SR; ++r)
        if (e[r] != o[r]) {               // only words inside the window differ
          e_s[(y0 + r) * nw + k] = e[r];
          moved = 1u;
        }
    }
    ++rounds;
    if (!__syncthreads_or(moved)) break;
  }
  return rounds;
}

__global__ void __launch_bounds__(THREADS, 1) dilate_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, W = a.W, th = a.th, tw = a.tw, wd = (W + 31) / 32;
  const int R = th + 2, nw = (tw + 2 + 31) / 32, n = R * nw;
  uint32_t* w_s = smem;           // window weak, R x nw words
  uint32_t* e_s = smem + n;       // window edges
  uint32_t* o_s = smem + 2 * n;   // window edges before the sweep
  const int ntx = (W + tw - 1) / tw, nty = (H + th - 1) / th;
  const int ntiles = ntx * nty;
  const int tid = threadIdx.x;
  const size_t gtid = (size_t)blockIdx.x * THREADS + tid;
  const size_t nthreads = (size_t)gridDim.x * THREADS;
  // bit b of window word k is global column c0 - 1 + 32k + b; the bits past
  // the window's tw + 2 columns are cleared
  const int tail = tw + 2 - 32 * (nw - 1);
  const uint32_t tail_mask = tail == 32 ? FULL : (1u << tail) - 1u;

  if (gtid == 0) a.stats[1] = a.stats[2] = 0;
  pack_any(a.nm, a.nm_bytes, H, W, a.lo, a.hi, a.weak, a.e0, gtid, nthreads);
  for (size_t i = gtid; i < (size_t)H * wd; i += nthreads) a.e1[i] = 0u;
  grid.sync();

  int sweep = 0;
  for (;;) {
    const u64 tok = a.token + (u64)sweep + 1;
    const uint32_t* ein = (sweep & 1) ? a.e1 : a.e0;
    uint32_t* eout = (sweep & 1) ? a.e0 : a.e1;
    const u64* fl_before = a.flags + (size_t)((sweep + 1) & 1) * ntiles;
    u64* fl_now = a.flags + (size_t)(sweep & 1) * ntiles;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int ty = t / ntx, tx = t % ntx;
      if (sweep >= 2) {                 // the same answer in every thread
        bool dirty = false;
        for (int y = max(ty - 1, 0); y <= min(ty + 1, nty - 1); ++y)
          for (int x = max(tx - 1, 0); x <= min(tx + 1, ntx - 1); ++x)
            dirty |= __ldcg(fl_before + y * ntx + x) == tok - 1;
        if (!dirty) continue;
      }
      const int r0 = ty * th, c0 = tx * tw;
      __syncthreads();                  // the tile before has left the window
      for (int i = tid; i < n; i += THREADS) {
        const int y = i / nw, k = i % nw;
        const int gr = r0 - 1 + y, g = c0 - 1 + 32 * k;
        const uint32_t keep = k == nw - 1 ? tail_mask : FULL;
        w_s[i] = window_word(a.weak, H, wd, gr, g) & keep;
        const uint32_t e = window_word(ein, H, wd, gr, g) & keep & w_s[i];
        e_s[i] = e;
        o_s[i] = e;
      }
      __syncthreads();
      const int rounds = flood_window(w_s, e_s, R, nw);

      // the interior: tile rows r0..r0+th-1, columns c0..c0+tw-1 in the image
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
        const int lo = max(c0, 32 * gw) - 32 * gw;
        const int hi = min(cend, 32 * gw + 32) - 32 * gw;
        const uint32_t own = (hi - lo == 32) ? FULL : (((1u << (hi - lo)) - 1u) << lo);
        diff |= ((v ^ ov) & own) != 0u;
        uint32_t* dst = eout + (size_t)gr * wd + gw;
        if (own == FULL)
          *dst = v;
        else
          atomicOr(dst, v & own);
      }
      const bool changed = __syncthreads_or(diff);
      if (tid == 0) {
        atomicAdd(a.stats + 1, 1);
        atomicAdd(a.stats + 2, rounds);
        if (changed) {
          fl_now[t] = tok;
          a.any[sweep & 1] = tok;
        }
      }
    }
    grid.sync();
    const bool changed = *(volatile u64*)(a.any + (sweep & 1)) == tok;
    ++sweep;
    if (sweep >= 2 && !changed) break;  // sweep 1 always runs, as on the TPU
  }
  if (gtid == 0) a.stats[0] = sweep;
  unpack_phase((sweep & 1) ? a.e1 : a.e0, H, W, a.out, gtid, nthreads);
}

size_t smem_bytes(int th, int tw) {
  return (size_t)3 * (th + 2) * ((tw + 2 + 31) / 32) * sizeof(uint32_t);
}

int tiles_of(int H, int W, int th, int tw) {
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs for a (th, tw) tile, the most this
// device gives a block (-1 if it cannot be read), and the number of 64-bit
// control words of a call's scratch.
int canny_dilate_smem_bytes(int th, int tw) {
  const size_t b = smem_bytes(th, tw);
  return b > INT_MAX ? INT_MAX : (int)b;
}
int canny_dilate_smem_limit() { return masks::smem_optin_limit(); }
int canny_dilate_scratch_words(int H, int W, int th, int tw) {
  return 2 * tiles_of(H, W, th, tw) + 4;
}

// The whole engine, one cooperative launch on `stream`: nm (int16 for
// nm_bytes 2, int32 for 4; H x W) -> out (int16 {0, 255}, H x W) with weak =
// nm >= lo, seeds = nm >= hi.  weak, e0 and e1 are (H, ceil(W/32)) uint32
// scratch.  ctl: canny_dilate_scratch_words() 64-bit words, zeroed once by
// the caller: 2 x tiles flags, two "a tile changed" tokens, then three ints
// the call leaves behind: sweeps, tile floods run, block-wide flood rounds
// summed.  token: launch sequence number << 32, never reused.  Returns
// cudaGetLastError().
int canny_dilate(const void* nm, int nm_bytes, int lo, int hi, void* weak,
                 void* e0, void* e1, void* out, int H, int W, int th, int tw,
                 void* ctl, unsigned long long token, void* stream) {
  if (H <= 0 || W <= 0 || th <= 0 || tw <= 0
      || (nm_bytes != 2 && nm_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(th, tw);
  const int ntiles = tiles_of(H, W, th, tw);
  const long long nwords = (long long)H * ((W + 31) / 32);

  Args a;
  a.nm = nm;
  a.nm_bytes = nm_bytes;
  a.lo = lo;
  a.hi = hi;
  a.weak = (uint32_t*)weak;
  a.e0 = (uint32_t*)e0;
  a.e1 = (uint32_t*)e1;
  a.out = (int16_t*)out;
  a.H = H;
  a.W = W;
  a.th = th;
  a.tw = tw;
  a.flags = (u64*)ctl;
  a.any = a.flags + 2 * (size_t)ntiles;
  a.stats = (int*)(a.any + 2);
  a.token = token;

  int cap = 0;
  cudaError_t e = masks::coop_blocks((const void*)dilate_kernel, THREADS, bytes,
                                     1, &cap);
  if (e != cudaSuccess) return (int)e;
  // a block a tile, and a thread a word for the two ends
  long long want = ntiles;
  if ((nwords + THREADS - 1) / THREADS > want)
    want = (nwords + THREADS - 1) / THREADS;
  const int grid = (int)(want < cap ? want : cap);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)dilate_kernel, dim3(grid),
                                  dim3(THREADS), args, bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
