// K4: the banded raster-scan hysteresis engine on Hopper, one launch a call.
//
// Replaces the Pallas kernel _band_kernel of
// canny_edge_tpu/kernels/hysteresis_v2.py and the sweeps around it
// (hysteresis_banded, with its needs_more test, the threshold compares before
// it and the int16 select after it): hysteresis_impl="banded".  Plain
// versions: canny_edge_tpu_torch/ops/banded.py (the function) and
// ops/banded_skip.py (this kernel's step-skipping rule, round for round).
//
// What it computes.  The image is cut into full-width bands of band_h rows.
// A sweep gives every band its rows with a 1-row halo above and below from
// the pre-sweep packed edge mask and runs the TPU kernel's recurrence:
//   forward   rows 1..band_h+1: the row gains the weak bits next to the row
//             above (straight and diagonal), then floods its weak runs;
//   backward  rows band_h..1, from the row below;
//   pending   would one dilation step add a pixel to the band's interior?
//             If so, another forward and backward round.
// The interior goes to the other buffer of a pair, so every band reads the
// pre-sweep state and each sweep equals the plain version's.  Sweep 0 always
// runs; sweeps go on while one dilation step of the new mask would add a
// pixel anywhere (needs_more).
//
// Bound: the function reads nm (2 B/px) and writes int16 (2 B/px), 2.5 us of
// HBM time at 1080p.  What it costs on this card is latency: 2 band_h + 1
// dependent row steps a round, each some 140 instructions of which one warp
// dispatches one every two cycles (tools/k4_phases.py: 23 of a call's 35 us
// at 1080p), and the launches, host syncs and grid-wide waits around the
// sweeps.  The design cuts the cost of a step, the number of
// steps that do anything, and everything around the sweeps:
//   one launch   a cooperative persistent kernel: pack (every thread of the
//             grid, 16-byte loads), grid sync, then per sweep the bands, a
//             grid sync, needs_more, a grid sync, and at the end the unpack
//             (16-byte stores) and the sweep count.  The "needs more" word
//             holds a token (launch sequence number + sweep), double
//             buffered, so nothing is cleared and nothing comes back to the
//             host inside a call.
//   a band a warp   where a row fits a warp (W <= 8192): lane j keeps WPL
//             consecutive words of the row (WPL 1, 2, 4, 8).  The row
//             flood is a carry-add inside each word; the carries between
//             lanes come from three ballots of the lanes' summaries
//             (generate: a run from a seed reaches the lane's edge;
//             propagate: the lane is all weak) and one compare a direction;
//             the carry into a word fills its weak run from that end, which
//             depends on the weak word alone.  A step has no barrier and,
//             in round 1, no vote: the neighbour row
//             is the row the warp has just computed, still in registers; the
//             rows rest in shared memory that only this warp reads, each
//             lane its own words, loaded a step ahead.  The bands of a block
//             are loaded and stored by all its threads (two block barriers a
//             band, none a step), and bands go to warp 0 of every block
//             first, so 17 bands run on 17 SMs.  Rows in registers instead
//             ((band_h + 2) x WPL x 2 = 264 at 1080p) do not fit a thread.
//   skipped steps   after round 1 a row is closed under its own flood and
//             holds the growth from its neighbour as that was when the step
//             last ran, so step(r, nb) is run only if row nb changed since:
//             in the pass before, or in this pass (one bit a row and pass).
//             The state after every round is the plain version's.  Against
//             every step in every round (tools/k4_skip.py) the rule takes
//             3-19% off sparse chains of 3-15 rounds a band at 1920 to 3840
//             columns, adds 3-10% at 1000 columns (one word a lane, where a
//             step costs little more than the vote that skipping needs), and
//             costs ~1% where every band needs one round, as on frames.
//   wide rows   W > 8192 keeps a block a band, a thread a word, with a
//             second scan level over the warps' summaries (W <= 32768);
//             above that a thread takes several consecutive words of a row
//             and floods them serially on either side of the same scan
//             (band_wide_kernel), its band in shared memory where it fits,
//             else in device memory: any width.
//   needs_more   a band that has settled has no growth inside; only its
//             first and last row can gain from the neighbour band's new
//             rows, so the test reads 2 rows a band.
//
// Shared memory: two masks of (band_h + 2) x ceil(W/32) words a band (127 KB
// for band_h 64 at W = 7680) and two flag bits a row.  Up to 32768 columns a
// band that does not fit is refused by the wrapper (which first halves a
// default band); above, a band that does not fit runs from device memory.
//
// Batch: B frames of (H, W) are one launch, the counterpart of jax.vmap over
// the Pallas sweeps (canny_edge_tpu/kernels/fused.py:47).  The bands are
// indexed by (frame, band), every frame cut alike; a band's halo rows are
// its own frame's (zero past the frame), so no band spans two frames, and
// the skipped steps and the rounds are a band's own.  A sweep runs every
// band of every frame and needs_more reads every frame's band borders: a
// frame that has converged is swept again and stays as it is (its state is
// the fixed point: a round changes nothing and its borders grow nothing),
// so each frame ends as it would alone, and the launch sweeps as often as
// its slowest frame needs.  Pack and unpack see the batch as one (B H, W)
// image.

#include <cooperative_groups.h>
#include <type_traits>

#include "masks.cuh"

namespace cg = cooperative_groups;

namespace {

using masks::hrow;
using masks::pack_any;
using masks::run_fill;
using masks::run_fill_down;
using masks::unpack_phase;

typedef unsigned long long u64;

constexpr uint32_t FULL = 0xffffffffu;
constexpr int WARP_THREADS = 512;            // band-a-warp kernel
constexpr int MAX_SLOTS = WARP_THREADS / 32; // bands a block holds at once
constexpr int BLOCK_THREADS = 1024;          // band-a-block kernel: W <= 32768
constexpr int MAX_WPL = 8;

struct Args {
  const void* nm;      // int16 / int32 NMS map (H, W)
  int nm_bytes, lo, hi;
  uint32_t* weak;      // scratch, (H, ceil(W/32)) words each
  uint32_t* e0;
  uint32_t* e1;
  int16_t* out;        // int16 {0, 255} (H, W)
  int B, H, W, band_h, slots;
  uint32_t* rows;      // band_wide_kernel<false>: 2 rows of words a block
  u64* more;           // 2 "needs more" tokens
  int* stats;          // sweeps, most rounds of a band, rounds summed, bands run
  u64 token;           // launch sequence number << 32
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void count_rounds(int* stats, int rounds) {
  atomicMax(stats + 1, rounds);
  atomicAdd(stats + 2, rounds);
  atomicAdd(stats + 3, 1);
}

// one dilation step of the new mask e: does it add a pixel to the first or
// the last row of a band of any frame?  (No other row can gain: its band has
// settled.)
__device__ void border_growth(const Args& a, const uint32_t* e, u64* more,
                              u64 tok, size_t gtid, size_t nthreads) {
  const int H = a.H, wd = (a.W + 31) / 32, nb = cdiv(H, a.band_h);
  const size_t n = (size_t)2 * a.B * nb * wd;
  for (size_t i = gtid; i < n; i += nthreads) {
    const int k = (int)(i / wd), j = (int)(i % wd);
    const int fr = (k >> 1) / nb, b = (k >> 1) % nb;     // frame, band
    const int r = (k & 1) ? min(H, (b + 1) * a.band_h) - 1 : b * a.band_h;
    const uint32_t* fe = e + (size_t)fr * H * wd;
    uint32_t h = 0u;
    for (int rr = max(r - 1, 0); rr <= min(r + 1, H - 1); ++rr) {
      const uint32_t* row = fe + (size_t)rr * wd;
      h |= hrow(j > 0 ? __ldcg(row + j - 1) : 0u, __ldcg(row + j),
                j + 1 < wd ? __ldcg(row + j + 1) : 0u);
    }
    const size_t at = ((size_t)fr * H + r) * wd + j;
    if (__ldcg(a.weak + at) & h & ~__ldcg(e + at)) *more = tok;
  }
}

// The call: pack, the sweeps with their stop test, unpack.  `sweep(ein,
// eout)` runs every band of this block once, from ein into eout.
template <class Sweep>
__device__ void run_call(const Args& a, Sweep sweep) {
  cg::grid_group grid = cg::this_grid();
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  if (gtid == 0) a.stats[1] = a.stats[2] = a.stats[3] = 0;
  pack_any(a.nm, a.nm_bytes, a.B * a.H, a.W, a.lo, a.hi, a.weak, a.e0, gtid,
           nthreads);
  grid.sync();
  int s = 0;
  for (;;) {
    const uint32_t* ein = (s & 1) ? a.e1 : a.e0;
    uint32_t* eout = (s & 1) ? a.e0 : a.e1;
    sweep(ein, eout);
    grid.sync();
    const u64 tok = a.token + (u64)s + 1;
    border_growth(a, eout, a.more + (s & 1), tok, gtid, nthreads);
    grid.sync();
    const bool more = *(volatile u64*)(a.more + (s & 1)) == tok;
    ++s;
    if (!more) break;
  }
  if (gtid == 0) a.stats[0] = s;
  unpack_phase((s & 1) ? a.e1 : a.e0, a.B * a.H, a.W, a.out, gtid,
               nthreads);
}

// ---------------------------------------------------------------------------
// a band a warp
// ---------------------------------------------------------------------------

// the rounds of one band held in this warp's shared memory: E and Wk are
// (band_h + 2) x wd words, FF / FB the "row changed in the last forward /
// backward pass" bits.  Returns the number of rounds.
template <int WPL>
__device__ int band_rounds(uint32_t* E, const uint32_t* Wk, uint32_t* FF,
                           uint32_t* FB, int wd, int band_h) {
  const int lane = threadIdx.x & 31, j0 = lane * WPL;
  const uint32_t lt = (1u << lane) - 1u, gt = ~lt << 1;   // lanes below, above

  auto load = [&](const uint32_t* m, int r, uint32_t (&x)[WPL]) {
#pragma unroll
    for (int q = 0; q < WPL; ++q)
      x[q] = j0 + q < wd ? m[r * wd + j0 + q] : 0u;
  };
  // a row dilated by one column each way
  auto hrow_vec = [&](const uint32_t (&x)[WPL], uint32_t (&h)[WPL]) {
    uint32_t l = __shfl_up_sync(FULL, x[WPL - 1], 1);
    uint32_t r = __shfl_down_sync(FULL, x[0], 1);
    if (lane == 0) l = 0u;
    if (lane == 31) r = 0u;
#pragma unroll
    for (int q = 0; q < WPL; ++q)
      h[q] = hrow(q > 0 ? x[q - 1] : l, x[q], q + 1 < WPL ? x[q + 1] : r);
  };
  // cur = hflood(e | grow(prev) & w, w); returns the bits in which this
  // lane's words of cur differ from e
  auto step = [&](const uint32_t (&prev)[WPL], const uint32_t (&e)[WPL],
                  const uint32_t (&w)[WPL], uint32_t (&cur)[WPL]) -> uint32_t {
    uint32_t g[WPL], up[WPL], dn[WPL], gu[WPL], gd[WPL];
    hrow_vec(prev, g);
    uint32_t lane_gu = 0u, lane_p = 1u;
#pragma unroll
    for (int q = 0; q < WPL; ++q) {
      const uint32_t s = e[q] | (g[q] & w[q]);
      uint32_t c = 0u;
      up[q] = run_fill(w[q], s, c);
      gu[q] = c;                         // a run from a seed reaches bit 31
      c = 0u;
      dn[q] = run_fill_down(w[q], s, c);
      gd[q] = c;                         // ... reaches bit 0
      const uint32_t p = w[q] == FULL;
      lane_gu = gu[q] | (p & lane_gu);
      lane_p &= p;
    }
    uint32_t lane_gd = 0u;
#pragma unroll
    for (int q = WPL - 1; q >= 0; --q)
      lane_gd = gd[q] | ((uint32_t)(w[q] == FULL) & lane_gd);
    const uint32_t bu = __ballot_sync(FULL, lane_gu);
    const uint32_t bd = __ballot_sync(FULL, lane_gd);
    const uint32_t bp = __ballot_sync(FULL, lane_p);
    // A carry enters this lane from below if, among the lanes below, the
    // highest that generates one lies above the highest that stops one
    // (neither generates nor propagates); from above, the lowest that
    // generates lies below the lowest that stops (x & -x, less one, so that
    // "none" compares as the largest).
    const uint32_t gb = bu & lt, kb = ~(bp | bu) & lt;
    const uint32_t ga = bd & gt, ka = ~(bp | bd) & gt;
    uint32_t c = gb > kb ? 1u : 0u;
    uint32_t diff = 0u;
#pragma unroll
    for (int q = 0; q < WPL; ++q) {      // a carry in fills the run at bit 0
      if (c) up[q] |= w[q] & (w[q] ^ (w[q] + 1u));
      c = gu[q] | ((uint32_t)(w[q] == FULL) & c);
    }
    c = (ga & (0u - ga)) - 1u < (ka & (0u - ka)) - 1u ? 1u : 0u;
#pragma unroll
    for (int q = WPL - 1; q >= 0; --q) { // ... the run at bit 31
      if (c) {
        const uint32_t rv = __brev(w[q]);
        dn[q] |= __brev(rv & (rv ^ (rv + 1u)));
      }
      c = gd[q] | ((uint32_t)(w[q] == FULL) & c);
      cur[q] = up[q] | dn[q];
      diff |= cur[q] ^ e[q];
    }
    return diff;
  };
  // one pass: rows 1..band_h+1 downward or band_h..1 upward.  With `all`
  // every step runs (round 1); else step(r, nb) runs only if row nb changed
  // in the pass before (`fin`) or in this one.
  auto pass = [&](auto all, bool forward) {
    constexpr bool ALL = decltype(all)::value;
    const int start = forward ? 1 : band_h, end = forward ? band_h + 1 : 1;
    const int d = forward ? 1 : -1;
    const uint32_t* fin = forward ? FB : FF;
    uint32_t* fout = forward ? FF : FB;
    uint32_t prev[WPL], e[WPL], w[WPL];
    load(E, start - d, prev);
    load(E, start, e);
    load(Wk, start, w);
    bool chg_prev = false;
    uint32_t acc = 0u;                   // this lane's rows that changed
    for (int r = start;; r += d) {
      const bool last = r == end;
      uint32_t en[WPL], wn[WPL];         // the next row, a step ahead
      if (!last) {
        load(E, r + d, en);
        load(Wk, r + d, wn);
      }
      bool run = ALL;
      if (!ALL) run = chg_prev || ((fin[(r - d) >> 5] >> ((r - d) & 31)) & 1u);
      bool chg = false;
      if (run) {
        uint32_t cur[WPL];
        const uint32_t diff = step(prev, e, w, cur);
        // round 1 runs the next step whatever this one did, so its rows'
        // bits are gathered over the lanes 32 rows at a time
        if (ALL) acc |= (diff != 0u ? 1u : 0u) << (r & 31);
        else chg = __any_sync(FULL, diff != 0u);
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
          if (cur[q] != e[q]) E[r * wd + j0 + q] = cur[q];
          prev[q] = cur[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < WPL; ++q) prev[q] = e[q];
      }
      if (chg) acc |= 1u << (r & 31);
      if (last || ((r + d) >> 5) != (r >> 5)) {
        if (ALL) acc = __reduce_or_sync(FULL, acc);
        fout[r >> 5] = acc;              // every lane writes the same word
        acc = 0u;
      }
      chg_prev = chg;
      if (last) break;
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        e[q] = en[q];
        w[q] = wn[q];
      }
    }
    __syncwarp();
  };
  // would one dilation step add a pixel to rows 1..band_h?
  auto pending = [&]() -> bool {
    uint32_t x[WPL], hm[WPL], hc[WPL], hn[WPL], e[WPL], w[WPL];
    load(E, 0, x);
    hrow_vec(x, hm);
    load(E, 1, e);
    hrow_vec(e, hc);
    uint32_t pend = 0u;
#pragma unroll 4
    for (int r = 1; r <= band_h; ++r) {
      load(E, r + 1, x);
      hrow_vec(x, hn);
      load(Wk, r, w);
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        pend |= w[q] & (hm[q] | hc[q] | hn[q]) & ~e[q];
        hm[q] = hc[q];
        hc[q] = hn[q];
        e[q] = x[q];
      }
    }
    return __any_sync(FULL, pend != 0u);
  };

  int rounds = 0;
  for (;;) {
    if (rounds == 0) {
      pass(std::true_type{}, true);
      pass(std::true_type{}, false);
    } else {
      pass(std::false_type{}, true);
      pass(std::false_type{}, false);
    }
    ++rounds;
    if (!pending()) break;
  }
  return rounds;
}

template <int WPL>
__global__ void __launch_bounds__(WARP_THREADS, 1) band_warp_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int H = a.H, wd = (a.W + 31) / 32, band_h = a.band_h;
  const int R = band_h + 2, nbf = cdiv(H, band_h), nfw = (R + 31) / 32;
  const int nb = a.B * nbf;            // bands of all frames
  const int slot_words = 2 * R * wd + 2 * nfw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = a.slots * gridDim.x;

  run_call(a, [&](const uint32_t* ein, uint32_t* eout) {
    // slot s of this block takes bands base + s * gridDim.x + blockIdx.x:
    // warp 0 of every block before warp 1 of any
    for (int base = 0; base < nb; base += stride) {
      if (base > 0) __syncthreads();     // the stores of the bands before
      for (int s = 0; s < a.slots; ++s) {
        const int b = base + s * gridDim.x + blockIdx.x;
        if (b >= nb) break;
        uint32_t* E = smem + (size_t)s * slot_words;
        uint32_t* Wk = E + R * wd;
        const size_t f0 = (size_t)(b / nbf) * H * wd;   // its frame's words
        const int top = (b % nbf) * band_h - 1;  // frame row of band row 0
        // the band's R rows are one run of R * wd words in device memory
        // (but for the rows off the frame); four loads a mask in flight
        const long long g0 = (long long)top * wd, gend = (long long)H * wd;
#pragma unroll 4
        for (int i = threadIdx.x; i < R * wd; i += WARP_THREADS) {
          const long long g = g0 + i;
          const bool in = g >= 0 && g < gend;
          E[i] = in ? __ldcg(ein + f0 + g) : 0u;
          Wk[i] = in ? __ldcg(a.weak + f0 + g) : 0u;
        }
      }
      __syncthreads();
      const int mine = base + warp * gridDim.x + blockIdx.x;
      if (warp < a.slots && mine < nb) {
        uint32_t* E = smem + (size_t)warp * slot_words;
        uint32_t* Wk = E + R * wd;
        uint32_t* FF = Wk + R * wd;
        const int rounds = band_rounds<WPL>(E, Wk, FF, FF + nfw, wd, band_h);
        if (lane == 0) count_rounds(a.stats, rounds);
      }
      __syncthreads();
      for (int s = 0; s < a.slots; ++s) {
        const int b = base + s * gridDim.x + blockIdx.x;
        if (b >= nb) break;
        const uint32_t* E = smem + (size_t)s * slot_words;
        uint32_t* fout = eout + (size_t)(b / nbf) * H * wd;
        const int top = (b % nbf) * band_h - 1;
        for (int y = 1 + warp; y <= band_h && top + y < H;
             y += WARP_THREADS / 32)
          for (int k = lane; k < wd; k += 32)
            fout[(size_t)(top + y) * wd + k] = E[y * wd + k];
      }
    }
  });
}

// ---------------------------------------------------------------------------
// a band a block: rows wider than a warp's 8 words a lane
// ---------------------------------------------------------------------------

// The carries across a block whose threads hold consecutive pieces of a row,
// thread k above thread k - 1: from each thread's summary (gen_up: a carry
// leaves its top with none coming in; gen_dn: one leaves its bottom; prop: a
// carry crosses it), the carry into its bottom (in_up) and into its top
// (in_dn).  Every thread of the block must call it.
__device__ __forceinline__ void block_carries(uint32_t gen_up, uint32_t gen_dn,
                                              bool prop, uint32_t* sg_up,
                                              uint32_t* sg_dn, uint32_t* sp,
                                              uint32_t& in_up,
                                              uint32_t& in_dn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t gu = __ballot_sync(FULL, gen_up);
  const uint32_t gd = __ballot_sync(FULL, gen_dn);
  const uint32_t pp = __ballot_sync(FULL, prop);
  // the warp's own summary: a carry out of lane 31 (up) or lane 0 (down)
  // with no carry in, and whether a carry crosses the whole warp
  uint32_t cu = 0, cd = 0;
  run_fill(pp, gu, cu);
  run_fill(__brev(pp), __brev(gd), cd);
  if (lane == 0) {
    sg_up[warp] = cu;
    sg_dn[warp] = cd;
    sp[warp] = pp == FULL;
  }
  __syncthreads();
  const bool mine = lane < nwarps;
  const uint32_t wgu = __ballot_sync(FULL, mine && sg_up[lane]);
  const uint32_t wgd = __ballot_sync(FULL, mine && sg_dn[lane]);
  const uint32_t wp = __ballot_sync(FULL, mine && sp[lane]);
  // carries between warps: bit k of xu = carry out of warp k (upward);
  // bit 31-k of xd = carry out of warp k (downward)
  uint32_t z = 0;
  const uint32_t xu = run_fill(wp, wgu, z);
  z = 0;
  const uint32_t xd = run_fill(__brev(wp), __brev(wgd), z);
  const uint32_t win_up = warp == 0 ? 0u : (xu >> (warp - 1)) & 1u;
  const uint32_t win_dn = warp == 31 ? 0u : (xd >> (30 - warp)) & 1u;
  // carries between the warp's lanes, with the warp's carry in
  z = win_up;
  const uint32_t lu = run_fill(pp, gu, z);
  z = win_dn;
  const uint32_t ld = run_fill(__brev(pp), __brev(gd), z);
  in_up = lane == 0 ? win_up : (lu >> (lane - 1)) & 1u;
  in_dn = lane == 31 ? win_dn : (ld >> (30 - lane)) & 1u;
}

// flood the seeds s along the weak runs w of a row held one word per thread
// (word j = threadIdx.x); every thread of the block must call it
__device__ __forceinline__ uint32_t hflood_row(uint32_t s, uint32_t w,
                                               uint32_t* sg_up, uint32_t* sg_dn,
                                               uint32_t* sp) {
  uint32_t c = 0;
  run_fill(w, s, c);
  const uint32_t gen_up = c;               // a run from a seed reaches bit 31
  c = 0;
  run_fill_down(w, s, c);
  const uint32_t gen_dn = c;               // ... reaches bit 0
  uint32_t in_up, in_dn;
  block_carries(gen_up, gen_dn, w == FULL, sg_up, sg_dn, sp, in_up, in_dn);
  c = in_up;
  const uint32_t up = run_fill(w, s, c);
  c = in_dn;
  const uint32_t dn = run_fill_down(w, s, c);
  return up | dn;
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1) band_block_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t sg_up[32], sg_dn[32], sp[32];   // static_bytes()
  const int H = a.H, wd = (a.W + 31) / 32, band_h = a.band_h;
  const int R = band_h + 2, nbf = cdiv(H, band_h);
  const int nb = a.B * nbf;       // bands of all frames
  uint32_t* E = smem;             // band edges, R x wd words
  uint32_t* Wk = smem + R * wd;   // band weak
  const int j = threadIdx.x;
  const bool col = j < wd;

  auto step = [&](int r, int nbr) {
    uint32_t s = 0, w = 0;
    if (col) {
      const uint32_t* n = E + nbr * wd;
      const uint32_t grow = hrow(j > 0 ? n[j - 1] : 0u, n[j],
                                 j + 1 < wd ? n[j + 1] : 0u);
      w = Wk[r * wd + j];
      s = E[r * wd + j] | (grow & w);
    }
    const uint32_t cur = hflood_row(s, w, sg_up, sg_dn, sp);
    if (col) E[r * wd + j] = cur;
    __syncthreads();
  };

  run_call(a, [&](const uint32_t* ein, uint32_t* eout) {
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      const size_t f0 = (size_t)(b / nbf) * H * wd;   // its frame's words
      const int top = (b % nbf) * band_h - 1;  // frame row of band row 0
      __syncthreads();                  // the stores of the band before
      for (int i = j; i < R * wd; i += BLOCK_THREADS) {
        const int gr = top + i / wd;
        const bool in = gr >= 0 && gr < H;
        const size_t g = f0 + (size_t)gr * wd + i % wd;
        E[i] = in ? __ldcg(ein + g) : 0u;
        Wk[i] = in ? __ldcg(a.weak + g) : 0u;
      }
      __syncthreads();
      int rounds = 0;
      for (;;) {
        for (int r = 1; r <= band_h + 1; ++r) step(r, r - 1);
        for (int r = band_h; r >= 1; --r) step(r, r + 1);
        ++rounds;
        bool pending = false;
        if (col) {
          for (int r = 1; r <= band_h && !pending; ++r) {
            uint32_t h = 0;
            for (int dr = -1; dr <= 1; ++dr) {
              const uint32_t* n = E + (r + dr) * wd;
              h |= hrow(j > 0 ? n[j - 1] : 0u, n[j],
                        j + 1 < wd ? n[j + 1] : 0u);
            }
            pending = (Wk[r * wd + j] & h & ~E[r * wd + j]) != 0u;
          }
        }
        if (!__syncthreads_or(pending)) break;
      }
      if (j == 0) count_rounds(a.stats, rounds);
      if (col)
        for (int r = 1; r <= band_h && top + r < H; ++r)
          eout[f0 + (size_t)(top + r) * wd + j] = E[r * wd + j];
    }
  });
}

// ---------------------------------------------------------------------------
// a band a block, several words a thread: rows wider than 32768 columns
// ---------------------------------------------------------------------------

// Thread k holds words [k wpt, (k + 1) wpt) of a row, wpt = ceil(wd / 1024).
// A row step floods a thread's words serially (the carries out of its top
// and bottom with none coming in, and whether a carry crosses all of them),
// takes the carries across the block from block_carries, and floods its
// words again with the carry that comes in.  The seeds of the step wait in
// a row S between the two floods.  Band rows: with SMEM, the band's two
// masks and S in shared memory, loaded and stored as the block-wide path
// does; without, in device memory: the interior rows are the output
// buffer's own rows (copied from the input buffer when the band starts),
// the top halo row the input buffer's (never written), the bottom halo row
// and S two rows of a.rows for this block, the weak rows the packed weak
// mask's, every read through L2 (__ldcg: the buffers swap each sweep).
// Rows past the frame read as 0 and their steps are skipped: nothing there
// is weak, so a step leaves them 0.  Every step runs, as in the block-wide
// path; the rounds, sweeps and results are the plain version's.
template <bool SMEM>
__global__ void __launch_bounds__(BLOCK_THREADS, 1) band_wide_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t sg_up[32], sg_dn[32], sp[32];   // static_bytes()
  const int H = a.H, wd = (a.W + 31) / 32, band_h = a.band_h;
  const int R = band_h + 2, nbf = cdiv(H, band_h);
  const int nb = a.B * nbf;       // bands of all frames
  const int wpt = cdiv(wd, BLOCK_THREADS);
  const int j0 = min((int)threadIdx.x * wpt, wd), j1 = min(j0 + wpt, wd);
  uint32_t* S = SMEM ? smem + 2 * R * wd
                     : a.rows + (size_t)blockIdx.x * 2 * wd;
  uint32_t* halo_row = S + wd;    // without SMEM: the bottom halo row
  auto get = [](const uint32_t* p) -> uint32_t {
    if constexpr (SMEM) return *p;
    else return __ldcg(p);
  };

  run_call(a, [&](const uint32_t* ein, uint32_t* eout) {
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      const size_t f0 = (size_t)(b / nbf) * H * wd;   // its frame's words
      const int top = (b % nbf) * band_h - 1;  // frame row of band row 0
      auto in_frame = [&](int r) { return top + r >= 0 && top + r < H; };
      auto frame_row = [&](const uint32_t* m, int r) {
        return m + f0 + (size_t)(top + r) * wd;
      };
      // band row r of the edges and of the weak mask; null past the frame
      auto erow = [&](int r) -> uint32_t* {
        if (!in_frame(r)) return nullptr;
        if constexpr (SMEM) return smem + (size_t)r * wd;
        if (r == 0) return const_cast<uint32_t*>(frame_row(ein, 0));
        if (r == R - 1) return halo_row;
        return const_cast<uint32_t*>(frame_row(eout, r));
      };
      auto wrow = [&](int r) -> const uint32_t* {
        if (!in_frame(r)) return nullptr;
        if constexpr (SMEM) return smem + (size_t)(R + r) * wd;
        return frame_row(a.weak, r);
      };
      __syncthreads();                  // the band before is done
      if constexpr (SMEM) {
        for (int r = 0; r < R; ++r) {
          const bool in = in_frame(r);
          for (int k = threadIdx.x; k < wd; k += BLOCK_THREADS) {
            smem[(size_t)r * wd + k] = in ? __ldcg(frame_row(ein, r) + k) : 0u;
            smem[(size_t)(R + r) * wd + k] =
                in ? __ldcg(frame_row(a.weak, r) + k) : 0u;
          }
        }
      } else {
        for (int r = 1; r < R && in_frame(r); ++r) {
          uint32_t* dst = erow(r);
          for (int k = threadIdx.x; k < wd; k += BLOCK_THREADS)
            dst[k] = __ldcg(frame_row(ein, r) + k);
        }
      }
      __syncthreads();

      // row r grows from row nbr, then floods its weak runs
      auto step = [&](int r, int nbr) {
        uint32_t* E = erow(r);
        if (E == nullptr) return;       // past the frame (block-uniform)
        const uint32_t* Wr = wrow(r);
        const uint32_t* N = erow(nbr);
        uint32_t cu = 0, cd = 0;
        bool prop = j0 < j1;            // a carry crosses all its words
        for (int j = j0; j < j1; ++j) {
          const uint32_t w = get(Wr + j);
          uint32_t sd = get(E + j);
          if (N != nullptr)
            sd |= hrow(j > 0 ? get(N + j - 1) : 0u, get(N + j),
                       j + 1 < wd ? get(N + j + 1) : 0u) & w;
          S[j] = sd;
          run_fill(w, sd, cu);
          prop = prop && w == FULL;
        }
        for (int j = j1 - 1; j >= j0; --j) run_fill_down(get(Wr + j), S[j], cd);
        uint32_t in_up, in_dn;
        block_carries(cu, cd, prop, sg_up, sg_dn, sp, in_up, in_dn);
        uint32_t c = in_up;
        for (int j = j0; j < j1; ++j) E[j] = run_fill(get(Wr + j), S[j], c);
        c = in_dn;
        for (int j = j1 - 1; j >= j0; --j)
          E[j] = get(E + j) | run_fill_down(get(Wr + j), S[j], c);
        __syncthreads();
      };

      int rounds = 0;
      for (;;) {
        for (int r = 1; r <= band_h + 1; ++r) step(r, r - 1);
        for (int r = band_h; r >= 1; --r) step(r, r + 1);
        ++rounds;
        bool pending = false;
        for (int r = 1; r <= band_h && in_frame(r) && !pending; ++r) {
          const uint32_t* E = erow(r);
          const uint32_t* Wr = wrow(r);
          for (int j = j0; j < j1 && !pending; ++j) {
            uint32_t h = 0;
            for (int dr = -1; dr <= 1; ++dr) {
              const uint32_t* n = erow(r + dr);
              if (n != nullptr)
                h |= hrow(j > 0 ? get(n + j - 1) : 0u, get(n + j),
                          j + 1 < wd ? get(n + j + 1) : 0u);
            }
            pending = (get(Wr + j) & h & ~get(E + j)) != 0u;
          }
        }
        if (!__syncthreads_or(pending)) break;
      }
      if (threadIdx.x == 0) count_rounds(a.stats, rounds);
      if constexpr (SMEM) {
        for (int r = 1; r <= band_h && top + r < H; ++r)
          for (int k = threadIdx.x; k < wd; k += BLOCK_THREADS)
            eout[f0 + (size_t)(top + r) * wd + k] = smem[(size_t)r * wd + k];
      }
    }
  });
}

// dynamic shared memory of one band of the warp and block-wide kernels
size_t band_bytes(int band_h, int W) {
  const size_t R = (size_t)band_h + 2, wd = (W + 31) / 32;
  return (2 * R * wd + 2 * ((R + 31) / 32)) * sizeof(uint32_t);
}

// ... of band_wide_kernel<true>: the two masks and the seed row
size_t wide_bytes(int band_h, int W) {
  const size_t R = (size_t)band_h + 2, wd = (W + 31) / 32;
  return (2 * R * wd + wd) * sizeof(uint32_t);
}

// static shared memory of the kernel that takes rows of this width
size_t static_bytes(int W) {
  return (W + 31) / 32 <= 32 * MAX_WPL ? 0 : 3 * 32 * sizeof(uint32_t);
}

// the dynamic and static shared memory one band of this width needs
size_t smem_need(int band_h, int W) {
  return ((W + 31) / 32 <= BLOCK_THREADS ? band_bytes(band_h, W)
                                         : wide_bytes(band_h, W))
         + static_bytes(W);
}

int sm_count(cudaError_t* err) {
  static int sms[64];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 0 || dev >= 64) { *err = cudaErrorInvalidDevice; return 0; }
  if (sms[dev] == 0)
    *err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev);
  return sms[dev];
}

// The launch of a call: the kernel of the width, its threads, dynamic shared
// memory and bands a block, the grid, and the words of a.rows it needs (0
// but for band_wide_kernel<false>).
struct Plan {
  const void* kernel;
  int threads, slots, grid;
  size_t smem;
  long long row_words;
};

cudaError_t plan_of(int B, int H, int W, int band_h, Plan* p) {
  const int wd = (W + 31) / 32;
  if (B <= 0 || H <= 0 || W <= 0 || band_h <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const int sms = sm_count(&e);
  if (e != cudaSuccess) return e;
  const int limit = masks::smem_optin_limit();
  if (limit < 0) return cudaErrorInvalidValue;
  const bool fits = smem_need(band_h, W) <= (size_t)limit;
  const long long nbl = (long long)B * ((H + band_h - 1) / band_h);
  if (nbl > INT_MAX) return cudaErrorInvalidValue;
  const int nb = (int)nbl;             // bands of all frames
  const long long nwords = (long long)B * H * wd;
  p->slots = 1;
  p->row_words = 0;
  if (wd <= 32 * MAX_WPL) {
    if (!fits) return cudaErrorInvalidValue;
    const size_t per_band = band_bytes(band_h, W);
    p->kernel = wd <= 32   ? (const void*)band_warp_kernel<1>
                : wd <= 64 ? (const void*)band_warp_kernel<2>
                : wd <= 128 ? (const void*)band_warp_kernel<4>
                            : (const void*)band_warp_kernel<8>;
    p->threads = WARP_THREADS;
    // more bands than blocks: a block holds several, as far as they fit
    int slots = (nb + sms - 1) / sms;
    const int fit = (int)((size_t)limit / per_band);
    if (slots > fit) slots = fit;
    if (slots > MAX_SLOTS) slots = MAX_SLOTS;
    p->slots = slots;
    p->smem = per_band * slots;
  } else if (wd <= BLOCK_THREADS) {
    if (!fits) return cudaErrorInvalidValue;
    p->kernel = (const void*)band_block_kernel;
    p->threads = BLOCK_THREADS;
    p->smem = band_bytes(band_h, W);
  } else {
    p->kernel = fits ? (const void*)band_wide_kernel<true>
                     : (const void*)band_wide_kernel<false>;
    p->threads = BLOCK_THREADS;
    p->smem = fits ? wide_bytes(band_h, W) : 0;
  }
  int cap = 0;
  e = masks::coop_blocks(p->kernel, p->threads, p->smem, 1, &cap);
  if (e != cudaSuccess) return e;
  // a band a warp slot or a block, and a thread a word for the two ends
  long long want = (nb + p->slots - 1) / p->slots;
  if ((nwords + p->threads - 1) / p->threads > want)
    want = (nwords + p->threads - 1) / p->threads;
  p->grid = (int)(want < cap ? want : cap);
  if (wd > BLOCK_THREADS && !fits) p->row_words = 2LL * p->grid * wd;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory one band needs on the path of its width, the most this
// device gives a block (-1 if it cannot be read), and the number of 64-bit
// control words of a call's scratch.  Up to 32768 columns a band must fit;
// above, one that does not runs from device memory.
int canny_banded_smem_bytes(int band_h, int W) {
  const size_t b = smem_need(band_h, W);
  return b > INT_MAX ? INT_MAX : (int)b;
}
int canny_banded_smem_limit() { return masks::smem_optin_limit(); }
int canny_banded_scratch_words() { return 4; }

// The uint32 words of device memory a call on B frames of (H, W) at band_h
// needs for its band rows (`rows` of canny_banded): 0 where the band fits
// shared memory; -1 if the call cannot be planned.
int canny_banded_row_words(int B, int H, int W, int band_h) {
  Plan p;
  if (plan_of(B, H, W, band_h, &p) != cudaSuccess || p.row_words > INT_MAX)
    return -1;
  return (int)p.row_words;
}

// The whole engine for B frames (B = 1: one image), one cooperative launch
// on `stream`: nm (int16 for nm_bytes 2, int32 for 4; B x H x W) -> out
// (int16 {0, 255}, B x H x W) with weak = nm >= lo, seeds = nm >= hi.  weak,
// e0 and e1 are (B, H, ceil(W/32)) uint32 scratch; rows holds row_words
// words, at least canny_banded_row_words(B, H, W, band_h) (null where that
// is 0).  ctl: canny_banded_scratch_words() 64-bit words, zeroed once by the
// caller: two "needs more" tokens, then four ints the call leaves behind:
// sweeps (the most of any frame), the most rounds of a band, the rounds of
// all bands summed, the bands run.  token: launch sequence number << 32,
// never reused.  Returns cudaGetLastError().
int canny_banded(const void* nm, int nm_bytes, int lo, int hi, void* weak,
                 void* e0, void* e1, void* out, int B, int H, int W,
                 int band_h, void* rows, int row_words, void* ctl,
                 unsigned long long token, void* stream) {
  if (nm_bytes != 2 && nm_bytes != 4) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan_of(B, H, W, band_h, &p);
  if (e != cudaSuccess) return (int)e;
  if (p.row_words > 0 && (rows == nullptr || row_words < p.row_words))
    return (int)cudaErrorInvalidValue;

  Args a;
  a.nm = nm;
  a.nm_bytes = nm_bytes;
  a.lo = lo;
  a.hi = hi;
  a.weak = (uint32_t*)weak;
  a.e0 = (uint32_t*)e0;
  a.e1 = (uint32_t*)e1;
  a.out = (int16_t*)out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.band_h = band_h;
  a.slots = p.slots;
  a.rows = (uint32_t*)rows;
  a.more = (u64*)ctl;
  a.stats = (int*)(a.more + 2);
  a.token = token;

  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(p.kernel, dim3(p.grid), dim3(p.threads),
                                  args, p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
