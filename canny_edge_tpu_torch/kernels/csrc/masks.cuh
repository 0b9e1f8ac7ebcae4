// Shared by the hysteresis kernels K2, K3 and K4 (hysteresis_packed.cu,
// hysteresis_dilate.cu, hysteresis_banded.cu): the bit operations of the
// floods; the two ends that every one of them runs inside its own
// cooperative kernel, by all threads of the grid (the threshold-and-pack
// phase that turns an NMS map into packed masks with 16-byte loads, and the
// unpack phase that turns a packed edge mask into int16 {0, 255} with
// 16-byte stores); and the flood of a tile of 8 rows x 32 words in one
// warp's registers, which K2 runs on its tiles and K3 on the sub-tiles of
// its window.
//
// Packed layout: (H, ceil(W/32)) uint32, bit b of word j is column 32j + b;
// the bits past W are 0, so they are never weak and never join an edge.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace masks {

// the largest dynamic shared memory a block of this device may opt in to
inline int smem_optin_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// The grid of a cooperative kernel must be co-resident: the number of blocks
// of `threads` threads and `smem` bytes of dynamic shared memory that the
// current device holds at once, at most `max_per_sm` a SM.  The answer is
// kept per kernel, device and footprint, so a repeated call costs a table
// lookup.  The shared memory a kernel may ask for is one value per kernel
// and device, not per footprint: every new footprint sets it to the most the
// device allows, never to less, so footprints may alternate freely.
inline cudaError_t coop_blocks(const void* kernel, int threads, size_t smem,
                               int max_per_sm, int* blocks) {
  struct Entry { const void* kernel; int dev; size_t smem; int blocks; };
  constexpr int N = 16;
  static Entry table[N];
  static int used = 0, next = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used; ++i)
    if (table[i].kernel == kernel && table[i].dev == dev
        && table[i].smem == smem) {
      *blocks = table[i].blocks;
      return cudaSuccess;
    }
  // (the limit holds for the kernel's static shared memory too)
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const int limit = smem_optin_limit() - (int)attr.sharedSizeBytes;
  if (limit < 0 || smem > (size_t)limit) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           limit);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = sms * (per_sm < max_per_sm ? per_sm : max_per_sm);
  table[next] = Entry{kernel, dev, smem, *blocks};
  next = (next + 1) % N;
  if (used < N) ++used;
  return cudaSuccess;
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

// two int16 values in one 32-bit word -> their two bits of `v >= t`
__device__ __forceinline__ uint32_t ge2(uint32_t x, int t) {
  const int a = (int)(x << 16) >> 16, b = (int)x >> 16;   // sign extended
  return (a >= t ? 1u : 0u) | (b >= t ? 2u : 0u);
}

// 16 bytes of NMS values -> their threshold bits, value i at bit `at + i`
__device__ __forceinline__ void threshold16(const int16_t*, uint4 raw, int at,
                                            int lo, int hi, uint32_t& bw,
                                            uint32_t& bs) {
  bw |= (ge2(raw.x, lo) | (ge2(raw.y, lo) << 2) | (ge2(raw.z, lo) << 4)
         | (ge2(raw.w, lo) << 6)) << at;
  bs |= (ge2(raw.x, hi) | (ge2(raw.y, hi) << 2) | (ge2(raw.z, hi) << 4)
         | (ge2(raw.w, hi) << 6)) << at;
}

__device__ __forceinline__ void threshold16(const int32_t*, uint4 raw, int at,
                                            int lo, int hi, uint32_t& bw,
                                            uint32_t& bs) {
  const int q[4] = {(int)raw.x, (int)raw.y, (int)raw.z, (int)raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bw |= (uint32_t)(q[i] >= lo) << (at + i);
    bs |= (uint32_t)(q[i] >= hi) << (at + i);
  }
}

// weak = nm >= lo, strong = nm >= hi (signed); thread `gtid` of `nthreads`
// packs words gtid, gtid + nthreads, ...: a whole word whose 32 values start
// on a 16-byte boundary is read in 16-byte loads, any other value by value
template <typename T>
__device__ void pack_phase(const T* __restrict__ nm, int H, int W, int lo,
                           int hi, uint32_t* weak, uint32_t* strong,
                           size_t gtid, size_t nthreads) {
  constexpr int PER = 16 / (int)sizeof(T);      // values in 16 bytes
  const int wd = (W + 31) / 32;
  const size_t nwords = (size_t)H * wd;
  for (size_t word = gtid; word < nwords; word += nthreads) {
    const size_t r = word / wd;
    const int c0 = (int)(word % wd) * 32;
    const T* p = nm + r * W + c0;
    uint32_t bw = 0u, bs = 0u;
    if (c0 + 32 <= W && (reinterpret_cast<uintptr_t>(p) & 15u) == 0u) {
      uint4 raw[32 / PER];
#pragma unroll
      for (int q = 0; q < 32 / PER; ++q)
        raw[q] = __ldg(reinterpret_cast<const uint4*>(p) + q);
#pragma unroll
      for (int q = 0; q < 32 / PER; ++q)
        threshold16(p, raw[q], q * PER, lo, hi, bw, bs);
    } else {
#pragma unroll
      for (int b = 0; b < 32; ++b) {      // no early exit: loads in flight
        const int x = c0 + b < W ? (int)p[b] : INT_MIN;
        bw |= (c0 + b < W && x >= lo ? 1u : 0u) << b;
        bs |= (c0 + b < W && x >= hi ? 1u : 0u) << b;
      }
    }
    weak[word] = bw;
    strong[word] = bs;
  }
}

__device__ __forceinline__ void pack_any(const void* nm, int nm_bytes, int H,
                                         int W, int lo, int hi, uint32_t* weak,
                                         uint32_t* strong, size_t gtid,
                                         size_t nthreads) {
  if (nm_bytes == 2)
    pack_phase((const int16_t*)nm, H, W, lo, hi, weak, strong, gtid, nthreads);
  else
    pack_phase((const int32_t*)nm, H, W, lo, hi, weak, strong, gtid, nthreads);
}

// two mask bits -> two int16 {0, 255} in one 32-bit word
__device__ __forceinline__ uint32_t expand2(uint32_t b) {
  return ((b & 1u) ? 0x000000ffu : 0u) | ((b & 2u) ? 0x00ff0000u : 0u);
}

// packed edges -> int16 {0, 255}; thread `gtid` of `nthreads` writes the
// 16-byte chunks gtid, gtid + nthreads, ... of the flat (H * W) output
__device__ void unpack_phase(const uint32_t* e, int H, int W, int16_t* out,
                             size_t gtid, size_t nthreads) {
  const int wd = (W + 31) / 32;
  const size_t n = (size_t)H * W, nch = n / 8;
  uint4* out4 = reinterpret_cast<uint4*>(out);
  if (W % 8 == 0) {
    const size_t cpr = W / 8;       // a chunk is one byte of one word
    for (size_t k = gtid; k < nch; k += nthreads) {
      const size_t r = k / cpr;
      const int q = (int)(k % cpr);
      const uint32_t b = (__ldcg(e + r * wd + (q >> 2)) >> (8 * (q & 3))) & 0xffu;
      out4[k] = make_uint4(expand2(b), expand2(b >> 2), expand2(b >> 4),
                           expand2(b >> 6));
    }
  } else {                          // a chunk may straddle rows and words
    for (size_t k = gtid; k < nch; k += nthreads) {
      size_t r = (8 * k) / W;
      int c = (int)((8 * k) % W);
      uint32_t b = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        b |= ((__ldcg(e + r * wd + (c >> 5)) >> (c & 31)) & 1u) << i;
        if (++c == W) { c = 0; ++r; }
      }
      out4[k] = make_uint4(expand2(b), expand2(b >> 2), expand2(b >> 4),
                           expand2(b >> 6));
    }
  }
  for (size_t i = 8 * nch + gtid; i < n; i += nthreads) {   // fewer than 8
    const size_t r = i / W;
    const int c = (int)(i % W);
    out[i] = ((__ldcg(e + r * wd + (c >> 5)) >> (c & 31)) & 1u) ? 255 : 0;
  }
}

// ---------------------------------------------------------------------------
// The flood of a tile of 8 rows x 32 words that one warp holds in registers,
// lane j word j of every row: K2's tiles and the sub-tiles of K3's window.
// ---------------------------------------------------------------------------

constexpr int TILE_ROWS = 8;
constexpr uint32_t ALL_LANES = 0xffffffffu;

// a row of the tile dilated by one column each way; `extra` carries the bits
// that enter from the words left and right of the tile
__device__ __forceinline__ uint32_t tile_hrow(uint32_t x, uint32_t extra,
                                              int lane) {
  uint32_t l = __shfl_up_sync(ALL_LANES, x, 1);
  uint32_t rr = __shfl_down_sync(ALL_LANES, x, 1);
  if (lane == 0) l = 0u;
  if (lane == 31) rr = 0u;
  return hrow(l, x, rr) | extra;
}

// The fixed surroundings of a tile as its dilation needs them.  top / bot:
// this lane's word of the rows above and below; lcol / rcol: the word
// columns left and right of the tile, lane L holding the row one above the
// tile plus L (lanes past TILE_ROWS + 1 hold 0).  Gives the two halo rows
// dilated by one column each way and, per row, the bits that enter lanes 0
// and 31 from the sides.
__device__ __forceinline__ void tile_halo(uint32_t top, uint32_t bot,
                                          uint32_t lcol, uint32_t rcol,
                                          int lane, uint32_t& htop,
                                          uint32_t& hbot,
                                          uint32_t (&hx)[TILE_ROWS]) {
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    const uint32_t lw = __shfl_sync(ALL_LANES, lcol, r + 1);
    const uint32_t rw = __shfl_sync(ALL_LANES, rcol, r + 1);
    hx[r] = (lane == 0 ? lw >> 31 : 0u) | (lane == 31 ? rw << 31 : 0u);
  }
  // a halo row dilated by one column each way; `at` is its lane in lcol
  auto halo_row = [&](uint32_t m, int at) -> uint32_t {
    uint32_t l = __shfl_up_sync(ALL_LANES, m, 1);
    uint32_t rr = __shfl_down_sync(ALL_LANES, m, 1);
    const uint32_t lc = __shfl_sync(ALL_LANES, lcol, at);
    const uint32_t rc = __shfl_sync(ALL_LANES, rcol, at);
    if (lane == 0) l = lc;
    if (lane == 31) rr = rc;
    return hrow(l, m, rr);
  };
  htop = halo_row(top, 0);
  hbot = halo_row(bot, TILE_ROWS + 1);
}

// Flood the tile e (weak mask w) to its fixed point inside the fixed
// surroundings of tile_halo: a dilation, a flood along each row (a carry-add
// inside each word, the carries between the 32 words scanned by the same
// carry-add on the warp's ballots) and a flood down and up each column of
// registers, until a dilation changes nothing.  The first dilation gives
// w & dilate8(e), so e may start as seeds that are not weak.  `fix(r, d,
// p, q, wr)` may correct row r of a dilation d, given that row (p) and the
// next (q; 0 past the tile's last row, whose next row the caller holds)
// before it and the row's weak word wr.
template <class Fix>
__device__ __forceinline__ void tile_flood(const uint32_t (&w)[TILE_ROWS],
                                           uint32_t (&e)[TILE_ROWS],
                                           uint32_t htop, uint32_t hbot,
                                           const uint32_t (&hx)[TILE_ROWS],
                                           int lane, Fix fix) {
  constexpr int R = TILE_ROWS;
  for (;;) {
    uint32_t chg = 0u;
    // dilation (Jacobi: every row term is taken before its row changes)
    uint32_t hm = htop, hc = tile_hrow(e[0], hx[0], lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t hn = hbot;
      if (r + 1 < R) hn = tile_hrow(e[r + 1], hx[r + 1], lane);
      uint32_t d = w[r] & (hm | hc | hn);
      d = fix(r, d, e[r], r + 1 < R ? e[r + 1] : 0u, w[r]);
      chg |= d ^ e[r];
      e[r] = d;
      hm = hc;
      hc = hn;
    }
    // a dilation that changes nothing is the fixed-point test: the floods
    // below only add weak pixels next to an edge, which the dilation would
    // have added too
    if (!__any_sync(ALL_LANES, chg != 0u)) break;
    // flood along each row of the tile, both directions
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t s = e[r], ww = w[r];
      uint32_t c = 0u;
      const uint32_t up = run_fill(ww, s, c);       // seeds toward bit 31
      const uint32_t gu = __ballot_sync(ALL_LANES, c != 0u);   // reaches bit 31
      c = 0u;
      const uint32_t dn = run_fill_down(ww, s, c);  // seeds toward bit 0
      const uint32_t gd = __ballot_sync(ALL_LANES, c != 0u);   // reaches bit 0
      const uint32_t pp = __ballot_sync(ALL_LANES, ww == ALL_LANES);
      // bit k of lu: a carry leaves lane k upward; bit 31-k of ld: downward
      uint32_t z = 0u;
      const uint32_t lu = run_fill(pp, gu, z);
      z = 0u;
      const uint32_t ld = run_fill(__brev(pp), __brev(gd), z);
      // a carry that enters the word fills its weak run from that end
      uint32_t n = up | dn;
      if (lane > 0 && ((lu >> (lane - 1)) & 1u)) n |= ww & (ww ^ (ww + 1u));
      if (lane < 31 && ((ld >> (30 - lane)) & 1u)) {
        const uint32_t rv = __brev(ww);
        n |= __brev(rv & (rv ^ (rv + 1u)));
      }
      e[r] = n;
    }
    // flood along each column of the tile, down then up
    uint32_t c = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) c = e[r] |= w[r] & c;
    c = 0u;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) c = e[r] |= w[r] & c;
  }
}

}  // namespace masks
