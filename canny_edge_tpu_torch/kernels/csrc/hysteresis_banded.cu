// K4: the banded raster-scan hysteresis engine on Hopper.
//
// Replaces the Pallas kernel _band_kernel of
// canny_edge_tpu/kernels/hysteresis_v2.py and the sweeps around it
// (hysteresis_banded): hysteresis_impl="banded".  Plain version:
// canny_edge_tpu_torch/ops/banded.py.
//
// The image is cut into full-width bands of band_h rows.  A sweep is one
// launch, one block per band: the block reads its band with a 1-row halo
// above and below from the pre-sweep packed edge mask into shared memory,
// bit-packed, one thread per 32-column word, and runs the TPU kernel's
// recurrence row by row:
//   forward   rows 1..band_h+1: the row gains the weak bits next to the row
//             above (straight and diagonal), then floods its weak runs;
//   backward  rows band_h..1, from the row below;
//   pending   one dilation step over the band: would it add a pixel to the
//             interior?  If so (__syncthreads_or: every thread takes the
//             same exit), another forward and backward round.
// The band's interior goes to the other buffer of a pair, so every band
// reads the pre-sweep state and each sweep equals the plain version's.  A
// second launch tests the whole new mask for one more dilation step
// (needs_more); the host stops at the first sweep after which it finds none.
//
// The row flood (the TPU's _hflood or-scan over lanes) crosses words: each
// word floods its own runs with a carry-add (masks::run_fill), then a carry
// goes from word to word where a run reaches the word's edge.  The carries
// are a scan over the words with "generate" (a run from a seed reaches the
// edge) and "propagate" (the word is all weak); the same carry-add does that
// scan on the warp's ballots, and once more on the warps' summaries.
//
// Shared memory: two masks of (band_h + 2) x ceil(W/32) words (127 KB for
// band_h 64 at W = 7680).  A band that does not fit is refused by the
// wrapper.  Bound: the function reads nm (2 B/px) and writes int16
// (2 B/px); its cost is sweeps x rounds x 2 band_h dependent row steps,
// each a few barriers, over only ceil(H / band_h) blocks.

#include "masks.cuh"

namespace {

using masks::hrow;
using masks::run_fill;
using masks::run_fill_down;

constexpr int MAX_THREADS = 1024;   // one thread per word: W <= 32768

// flood the seeds s along the weak runs w of a row held one word per thread
// (word j = threadIdx.x); every thread of the block must call it
__device__ __forceinline__ uint32_t hflood_row(uint32_t s, uint32_t w,
                                               uint32_t* sg_up, uint32_t* sg_dn,
                                               uint32_t* sp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t full = 0xffffffffu;
  uint32_t c = 0;
  run_fill(w, s, c);
  const uint32_t gen_up = c;               // a run from a seed reaches bit 31
  c = 0;
  run_fill_down(w, s, c);
  const uint32_t gen_dn = c;               // ... reaches bit 0
  const uint32_t gu = __ballot_sync(full, gen_up);
  const uint32_t gd = __ballot_sync(full, gen_dn);
  const uint32_t pp = __ballot_sync(full, w == full);
  // the warp's own summary: a carry out of lane 31 (up) or lane 0 (down)
  // with no carry in, and whether a carry crosses the whole warp
  uint32_t cu = 0, cd = 0;
  run_fill(pp, gu, cu);
  run_fill(__brev(pp), __brev(gd), cd);
  if (lane == 0) {
    sg_up[warp] = cu;
    sg_dn[warp] = cd;
    sp[warp] = pp == full;
  }
  __syncthreads();
  const bool mine = lane < nwarps;
  const uint32_t wgu = __ballot_sync(full, mine && sg_up[lane]);
  const uint32_t wgd = __ballot_sync(full, mine && sg_dn[lane]);
  const uint32_t wp = __ballot_sync(full, mine && sp[lane]);
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
  const uint32_t in_up = lane == 0 ? win_up : (lu >> (lane - 1)) & 1u;
  const uint32_t in_dn = lane == 31 ? win_dn : (ld >> (30 - lane)) & 1u;
  c = in_up;
  const uint32_t up = run_fill(w, s, c);
  c = in_dn;
  const uint32_t dn = run_fill_down(w, s, c);
  return up | dn;
}

__global__ void __launch_bounds__(MAX_THREADS)
band_kernel(const uint32_t* __restrict__ weak, const uint32_t* __restrict__ ein,
            uint32_t* __restrict__ eout, int H, int W, int band_h) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t sg_up[32], sg_dn[32], sp[32];
  const int wd = (W + 31) / 32, R = band_h + 2;
  uint32_t* E = smem;             // band edges, R x wd words
  uint32_t* Wk = smem + R * wd;   // band weak
  const int j = threadIdx.x;
  const bool col = j < wd;
  const int top = blockIdx.x * band_h - 1;   // global row of band row 0

  for (int i = j; i < R * wd; i += blockDim.x) {
    const int gr = top + i / wd;
    const bool in = gr >= 0 && gr < H;
    const size_t g = (size_t)gr * wd + i % wd;
    E[i] = in ? ein[g] : 0u;
    Wk[i] = in ? weak[g] : 0u;
  }
  __syncthreads();

  auto step = [&](int r, int nb) {
    uint32_t s = 0, w = 0;
    if (col) {
      const uint32_t* n = E + nb * wd;
      const uint32_t grow = hrow(j > 0 ? n[j - 1] : 0u, n[j],
                                 j + 1 < wd ? n[j + 1] : 0u);
      w = Wk[r * wd + j];
      s = E[r * wd + j] | (grow & w);
    }
    const uint32_t cur = hflood_row(s, w, sg_up, sg_dn, sp);
    if (col) E[r * wd + j] = cur;
    __syncthreads();
  };

  for (;;) {
    for (int r = 1; r <= band_h + 1; ++r) step(r, r - 1);
    for (int r = band_h; r >= 1; --r) step(r, r + 1);
    bool pending = false;
    if (col) {
      for (int r = 1; r <= band_h && !pending; ++r) {
        uint32_t h = 0;
        for (int dr = -1; dr <= 1; ++dr) {
          const uint32_t* n = E + (r + dr) * wd;
          h |= hrow(j > 0 ? n[j - 1] : 0u, n[j], j + 1 < wd ? n[j + 1] : 0u);
        }
        pending = (Wk[r * wd + j] & h & ~E[r * wd + j]) != 0u;
      }
    }
    if (!__syncthreads_or(pending)) break;
  }

  if (col)
    for (int r = 1; r <= band_h && top + r < H; ++r)
      eout[(size_t)(top + r) * wd + j] = E[r * wd + j];
}

// *flag = 1 if one dilation step of e (masked by weak) adds a pixel
__global__ void needs_more_kernel(const uint32_t* __restrict__ weak,
                                  const uint32_t* __restrict__ e, int H, int wd,
                                  int* __restrict__ flag) {
  const size_t n = (size_t)H * wd;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / wd), j = (int)(i % wd);
    uint32_t h = 0;
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = r + dr;
      if (rr < 0 || rr >= H) continue;
      const uint32_t* row = e + (size_t)rr * wd;
      h |= hrow(j > 0 ? row[j - 1] : 0u, row[j], j + 1 < wd ? row[j + 1] : 0u);
    }
    if (weak[i] & h & ~e[i]) *flag = 1;
  }
}

size_t smem_bytes(int band_h, int W) {
  return (size_t)2 * (band_h + 2) * ((W + 31) / 32) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Dynamic shared memory one band block needs, the most this device gives a
// block (-1 if it cannot be read), and the widest image a block covers.
int canny_banded_smem_bytes(int band_h, int W) {
  const size_t b = smem_bytes(band_h, W);
  return b > INT_MAX ? INT_MAX : (int)b;
}
int canny_banded_smem_limit() { return masks::smem_optin_limit(); }
int canny_banded_max_width() { return 32 * MAX_THREADS; }

// weak = nm >= lo and seed = nm >= hi into packed (H, ceil(W/32)) uint32.
int canny_banded_pack(const void* nm, int nm_bytes, int H, int W, int lo,
                      int hi, void* weak, void* seed, void* stream) {
  return (int)masks::launch_pack(nm, nm_bytes, H, W, lo, hi, weak, seed,
                                 (cudaStream_t)stream);
}

// One sweep, ein -> eout (packed edges, every row written), then the
// needs_more test of eout into *flag (which the caller zeroes).  Launches on
// `stream`; returns cudaGetLastError().
int canny_banded_sweep(const void* weak, const void* ein, void* eout, int H,
                       int W, int band_h, void* flag, void* stream) {
  const int wd = (W + 31) / 32;
  if (H <= 0 || W <= 0 || band_h <= 0 || wd > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(band_h, W);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 32 * ((wd + 31) / 32);
  const int nb = (H + band_h - 1) / band_h;
  band_kernel<<<nb, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)weak, (const uint32_t*)ein, (uint32_t*)eout, H, W,
      band_h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)H * wd;
  const unsigned blocks = (unsigned)(n < (size_t)132 * 64 * 256
                                         ? (n + 255) / 256 : (size_t)132 * 64);
  needs_more_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)weak, (const uint32_t*)eout, H, wd, (int*)flag);
  return (int)cudaGetLastError();
}

// packed edges -> int16 {0, 255} (H, W)
int canny_banded_unpack(const void* e, int H, int W, void* out, void* stream) {
  return (int)masks::launch_unpack(e, H, W, out, (cudaStream_t)stream);
}

}  // extern "C"
