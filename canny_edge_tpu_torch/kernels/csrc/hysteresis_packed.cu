// K2: the bit-packed hysteresis flood on Hopper, with its two ends.
//
// Replaces the Pallas kernels _hyst_packed_kernel_t / _hyst_packed_kernel of
// canny_edge_tpu/kernels/hysteresis_packed.py (one VMEM-resident program that
// floods the whole image's packed masks to their fixed point) and the
// threshold/pack and unpack passes around them, which on the TPU ran in XLA.
// Plain versions: ops/packed.py:hysteresis_packed_masks (the fixed point) and
// ops/packed_tiles.py (this kernel's tile schedule, step for step).
//
// Bound: the function moves three packed masks (0.78 MB at 1080p), or an
// int16 NMS map in and an int16 edge map out (8.3 MB, 2.5 us of HBM time); a
// flood needs a few hundred bit operations a word.  Neither is what it
// costs: a 1080p mask (259 KB) does not fit one block's shared memory, so
// the flood is tiles that exchange borders, and its time is the launch, one
// grid-wide barrier per exchange and the latency of the dependent bit
// operations inside a tile.  The design keeps all three small.
//
// Design: one cooperative persistent kernel.
//   pack     (NMS-map input) weak = nm >= lo, strong = nm >= hi, one word a
//            thread from 16-byte loads, by every thread of the grid (a
//            ragged or unaligned word value by value); grid sync.
//   step     a tile is 8 rows x 32 words (8 x 1024 pixels), owned by one
//            warp and held in registers: lane j keeps word j of every row.
//            The warp floods its tile to the local fixed point with no
//            shared memory and no block barrier: a dilation (neighbour words
//            by warp shuffles, neighbour rows in registers, the fixed halo
//            of the adjacent tiles read once; every load of a tile is
//            started before the first use, the two side columns one row a
//            lane, so a tile waits one memory round trip, not one per row),
//            a flood along each row (a
//            carry-add inside each word, the carries between the 32 words
//            scanned by the same carry-add on the warp's ballots) and a
//            flood down and up each column of registers, until a dilation
//            changes nothing (__any_sync; masks.cuh: tile_halo, tile_flood,
//            shared with K3's sub-tiles).  Changed words go back to device
//            memory.  Step 0 starts from the strong mask itself, so the
//            first dilation is the plain flood's prologue
//            weak & dilate8(strong) and needs no pass of its own.
//   flags    a tile that changed a word on its border marks the adjacent
//            tiles dirty for the next step; a step floods only dirty tiles
//            (all of them in step 0), so a converged tile costs one flag
//            read and the last step of a call costs no flood at all.  The
//            flags and the "anything marked" word hold a token (launch
//            sequence number and step), double buffered, so nothing is
//            ever cleared.  Grid sync; stop when nothing was marked.
//   unpack   (int16 output) the converged words, still in L2, become int16
//            {0, 255} with 16-byte stores (8 pixels a thread; a ragged W
//            takes a per-pixel path for the same 16-byte chunks).
// Both ends were also measured as kernels of their own around the flood,
// and the tile at 16 rows: neither was faster, so neither is kept.
//
// The result is the least fixed point above weak & dilate8(strong): the
// weak pixels 8-connected to a strong one.  Any order of adding weak pixels
// next to an edge reaches it, so it equals the plain version's rounds bit
// for bit; only the number of steps depends on the schedule.  Strict mode:
// pixel (0, 1) may not be promoted from (1, 0); only dilations move
// diagonally, so only they carry the fix.  The image's pixel (0, 0) lies at
// (quirk_row, quirk_word) of the masks, so the fix may fall in any tile: at
// (1, 1) on a block extended by a halo of one row and one word (the
// distributed flood of parallel/sharded.py); the caller decides whether the
// image has a pixel (0, 1) at all.  Reads of words that other blocks
// write use __ldcg (L2, not the incoherent L1).  A tile may or may not see a
// neighbour's writes of the same step: words only gain bits, and the
// neighbour marks the tile dirty for the next step either way.
//
// Batch: B frames of (H, W) are one launch, the counterpart of jax.vmap over
// the Pallas flood (canny_edge_tpu/kernels/hysteresis_packed.py:348), which
// gives its grid a batch axis.  The tile space is B x ntiles: tile t is tile
// t % ntiles of frame t / ntiles, its words and flags those of its frame, so
// a tile reads and marks tiles of its own frame only and the strict fix
// falls at (quirk_row, quirk_word) of every frame.  Each frame converges on
// its own: a converged frame's tiles are not dirty and cost a flag read a
// step; the launch ends when no frame marked a tile.  The pack and unpack
// see the batch as one (B H, W) image: frames lie back to back in the
// (B, H, W) map and the (B, H, ceil(W/32)) masks alike, and a chunk that
// crosses a frame's end is one that crosses a row's (the ragged path).

#include <cooperative_groups.h>

#include "masks.cuh"

namespace cg = cooperative_groups;

namespace {

using masks::pack_any;
using masks::unpack_phase;

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_WORDS = 32;       // one word a lane
constexpr int R = masks::TILE_ROWS;   // rows of a tile, in registers
constexpr uint32_t FULL = 0xffffffffu;

struct Args {
  uint32_t* weak;      // packed inputs, or the scratch the pack phase fills
  uint32_t* strong;
  const void* nm;      // NMS-map input, or null
  int nm_bytes, lo, hi;
  uint32_t* edges;     // packed edges: the output, or scratch before out16
  int16_t* out16;      // int16 {0, 255} output, or null
  int B, H, W, quirk_row, quirk_word;
  u64* flags;          // 2 x B x ntiles dirty tokens
  u64* any;            // 2 "anything marked" tokens
  int* steps;          // the number of steps run
  u64* total_steps;    // the card's running sum of every launch's steps
  u64 token;           // launch sequence number << 32
};

// the strict-reference value of bit 1 (pixel (0, 1)) of the image's first
// word after a dilation of `prev` (p0: that word, p1: the word below it):
// kept, or promoted from (0,0), (0,2), (1,1), (1,2) only
__device__ __forceinline__ uint32_t strict_fix(uint32_t d, uint32_t p0,
                                               uint32_t p1, uint32_t w0) {
  const uint32_t allowed = (p0 & 1u) | ((p0 >> 2) & 1u) | ((p1 >> 1) & 1u)
                           | ((p1 >> 2) & 1u);
  const uint32_t val = ((p0 >> 1) & 1u) | (((w0 >> 1) & 1u) & allowed);
  return (d & ~2u) | (val << 1);
}

// STRICT: the strict fix is compiled in (component mode pays nothing for it)
template <bool STRICT>
__global__ void __launch_bounds__(THREADS, 1) flood_kernel(Args a) {
  static_assert(R + 2 <= 32, "one lane per row of the side columns");
  cg::grid_group grid = cg::this_grid();
  const int H = a.H, W = a.W, wd = (W + 31) / 32;
  const int ntx = (wd + TILE_WORDS - 1) / TILE_WORDS, nty = (H + R - 1) / R;
  const int ntiles = ntx * nty, btiles = a.B * ntiles;
  const size_t fwords = (size_t)H * wd;     // a frame's words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = WARPS * gridDim.x;
  // the tile, row and lane of the strict fix
  const int qtile = (a.quirk_row / R) * ntx + a.quirk_word / TILE_WORDS;
  const int qrow = a.quirk_row % R, qlane = a.quirk_word % TILE_WORDS;

  if (a.nm != nullptr) {
    pack_any(a.nm, a.nm_bytes, a.B * H, W, a.lo, a.hi, a.weak, a.strong,
             (size_t)blockIdx.x * THREADS + threadIdx.x,
             (size_t)gridDim.x * THREADS);
    grid.sync();
  }

  auto LD = [&](const uint32_t* p, int r, int j) -> uint32_t {
    return (r >= 0 && r < H && j >= 0 && j < wd)
               ? __ldcg(p + (size_t)r * wd + j) : 0u;
  };
  const int gwarp = warp * gridDim.x + blockIdx.x;   // tiles spread over blocks
  int step = 0;
  for (;;) {
    const u64 tok = a.token + (u64)step;
    const u64* fl_cur = a.flags + (size_t)(step & 1) * btiles;
    u64* fl_nxt = a.flags + (size_t)((step + 1) & 1) * btiles;
    for (int ft = gwarp; ft < btiles; ft += nwarps) {
      if (step > 0 && __ldcg(fl_cur + ft) != tok) continue;   // not dirty
      // tile t of frame fr: its frame's words and flags
      const int fr = ft / ntiles, t = ft % ntiles;
      const uint32_t* weak = a.weak + fr * fwords;
      uint32_t* edges = a.edges + fr * fwords;
      u64* fl_frame = fl_nxt + (size_t)fr * ntiles;
      const int ty = t / ntx, tx = t % ntx;
      const int r0 = ty * R, j = tx * TILE_WORDS + lane;
      // step 0 floods from the strong mask (own words and halo): its first
      // dilation is weak & dilate8(strong); later steps read the edges
      const uint32_t* hp = step == 0 ? a.strong + fr * fwords : edges;
      // every load first and none behind a branch, so that all are in
      // flight together: own words, the rows above and below, and the word
      // columns left and right of the tile (lane L holds row r0 - 1 + L)
      uint32_t w[R], e[R], o[R], hx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = LD(weak, r0 + r, j);
        e[r] = LD(hp, r0 + r, j);
      }
      const int j0 = tx * TILE_WORDS;
      const uint32_t top = LD(hp, r0 - 1, j), bot = LD(hp, r0 + R, j);
      const uint32_t lcol = lane < R + 2 ? LD(hp, r0 - 1 + lane, j0 - 1) : 0u;
      const uint32_t rcol = lane < R + 2
                                ? LD(hp, r0 - 1 + lane, j0 + TILE_WORDS) : 0u;
#pragma unroll
      for (int r = 0; r < R; ++r)
        o[r] = step == 0 ? (e[r] & w[r]) : e[r];   // what the neighbours assume
      uint32_t htop, hbot;
      masks::tile_halo(top, bot, lcol, rcol, lane, htop, hbot, hx);
      const bool fix = STRICT && t == qtile && lane == qlane;
      masks::tile_flood(w, e, htop, hbot, hx, lane,
                        [&](int r, uint32_t d, uint32_t p, uint32_t q,
                            uint32_t wr) {
                          // the row below the tile's last is the halo's
                          return fix && r == qrow
                                     ? strict_fix(d, p, r + 1 < R ? q : bot, wr)
                                     : d;
                        });

      uint32_t diff = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t df = e[r] ^ o[r];
        diff |= df;
        if (j < wd && r0 + r < H && (step == 0 || df != 0u))
          edges[(size_t)(r0 + r) * wd + j] = e[r];
      }
      const uint32_t bt = __ballot_sync(FULL, e[0] != o[0]);
      const uint32_t bb = __ballot_sync(FULL, e[R - 1] != o[R - 1]);
      const uint32_t ba = __ballot_sync(FULL, diff != 0u);
      if (lane == 0) {
        bool marked = false;
        auto mark = [&](int y, int x) {
          if (y >= 0 && y < nty && x >= 0 && x < ntx) {
            fl_frame[y * ntx + x] = tok + 1;
            marked = true;
          }
        };
        if (bt) { mark(ty - 1, tx - 1); mark(ty - 1, tx); mark(ty - 1, tx + 1); }
        if (bb) { mark(ty + 1, tx - 1); mark(ty + 1, tx); mark(ty + 1, tx + 1); }
        if (ba & 1u) mark(ty, tx - 1);
        if (ba >> 31) mark(ty, tx + 1);
        if (marked) a.any[step & 1] = tok + 1;
      }
    }
    grid.sync();
    const u64 nxt = *(volatile u64*)&a.any[step & 1];
    ++step;
    if (nxt != tok + 1) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.steps = step;
    atomicAdd(a.total_steps, (u64)step);
  }
  if (a.out16 != nullptr)
    unpack_phase(a.edges, a.B * H, W, a.out16,
                 (size_t)blockIdx.x * THREADS + threadIdx.x,
                 (size_t)gridDim.x * THREADS);
}

int tiles_of(int H, int W) {
  const int wd = (W + 31) / 32;
  return ((wd + TILE_WORDS - 1) / TILE_WORDS) * ((H + R - 1) / R);
}

// co-resident blocks of the flood kernel, queried once per device
template <bool STRICT>
int grid_cap(cudaError_t* err) {
  static int cap[64];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 0 || dev >= 64) { *err = cudaErrorInvalidDevice; return 0; }
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flood_kernel<STRICT>, THREADS, 0);
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) { *err = cudaErrorLaunchOutOfResources; return 0; }
    cap[dev] = sms * (per_sm < 2 ? per_sm : 2);
  }
  return cap[dev];
}

}  // namespace

extern "C" {

// u64 words of scratch a call on B frames needs: 2 x B x tiles flags, 2
// "any" words, 1 for the step count.  The caller zeroes them once and passes
// a token (launch sequence number << 32) that it never reuses.
int canny_hysteresis_packed_scratch_words(int B, int H, int W) {
  return 2 * B * tiles_of(H, W) + 3;
}

// The flood of B frames (B = 1: one image).  Input: nm != null -> an int16
// (nm_bytes 2) or int32 (4) NMS map (B, H, W) with thresholds lo / hi, and
// weak / strong are (B, H, ceil(W/32)) uint32 scratch the pack fills; nm ==
// null -> weak / strong are the packed inputs.  Output: out16 != null ->
// int16 {0, 255} (B, H, W), and edges is (B, H, ceil(W/32)) uint32 scratch;
// out16 == null -> edges is the packed output.  strict != 0: the
// strict-reference fix of each frame's pixel (0, 1), with its pixel (0, 0)
// at row quirk_row, word quirk_word of the frame's masks.  The step count
// (the most any frame needed) lands in the last scratch word (as an int),
// and is added to *total_steps, a u64 word of the device that every launch
// adds to (launches on other streams too, hence an atomic add).
// One launch on `stream`; returns cudaGetLastError().
int canny_hysteresis_packed(void* weak, void* strong, const void* nm,
                            int nm_bytes, int lo, int hi, void* edges,
                            void* out16, int B, int H, int W, int strict,
                            int quirk_row, int quirk_word, void* scratch,
                            void* total_steps, unsigned long long token,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || total_steps == nullptr
      || (nm != nullptr && nm_bytes != 2 && nm_bytes != 4)
      || (strict && (quirk_row < 0 || quirk_row >= H || quirk_word < 0
                     || quirk_word >= (W + 31) / 32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  const int cap = strict ? grid_cap<true>(&e) : grid_cap<false>(&e);
  if (e != cudaSuccess) return (int)e;
  const int wd = (W + 31) / 32;
  const long long nwords = (long long)B * H * wd;
  const long long ntiles = (long long)B * tiles_of(H, W);
  if (ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool ends = nm != nullptr || out16 != nullptr;

  Args a;
  a.weak = (uint32_t*)weak;
  a.strong = (uint32_t*)strong;
  a.nm = nm;
  a.nm_bytes = nm_bytes;
  a.lo = lo;
  a.hi = hi;
  a.edges = (uint32_t*)edges;
  a.out16 = (int16_t*)out16;
  a.B = B;
  a.H = H;
  a.W = W;
  a.quirk_row = quirk_row;
  a.quirk_word = quirk_word;
  a.flags = (u64*)scratch;
  a.any = a.flags + 2 * (size_t)ntiles;
  a.steps = (int*)(a.any + 2);
  a.total_steps = (u64*)total_steps;
  a.token = token;
  // one warp a tile; with a pack or an unpack to do, also a thread a word
  long long want = ntiles;
  if (ends && (nwords + THREADS - 1) / THREADS > want)
    want = (nwords + THREADS - 1) / THREADS;
  const int grid = (int)(want < cap ? want : cap);
  void* args[] = {&a};
  const void* kernel = strict ? (const void*)flood_kernel<true>
                              : (const void*)flood_kernel<false>;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                  dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
