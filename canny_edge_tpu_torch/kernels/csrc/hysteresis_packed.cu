// K2: the bit-packed hysteresis flood on Hopper.
//
// Replaces the Pallas kernels _hyst_packed_kernel_t / _hyst_packed_kernel of
// canny_edge_tpu/kernels/hysteresis_packed.py (one VMEM-resident program that
// floods the whole image's packed masks to their fixed point).  Plain
// version: ops/packed.py:hysteresis_packed_masks.
//
// The TPU design keeps the whole image on one core.  An H100 block has at
// most 227 KB of shared memory, less than one 1080p mask (259 KB), so the
// flood here is one cooperative persistent kernel over 32-row x 8-word tiles
// (32 x 256 pixels):
//
//   prologue  e = weak & dilate8(strong)   (with the strict fix), grid sync;
//   step      every tile loads its words plus a one-word / one-row halo into
//             shared memory and floods to local convergence: a dilation,
//             then a carry-add flood along each tile row and a scan along
//             each tile word column, repeated until nothing changes; changed
//             words go back to device memory and raise a flag; grid sync;
//   repeat    until a step in which no tile changed.
//
// The result is the least fixed point above the prologue's mask: the weak
// pixels 8-connected to a strong one.  Any order of adding weak pixels next
// to an edge reaches it, so it equals the plain version's rounds bit for bit.
// Strict mode: pixel (0, 1) may not be promoted from (1, 0); only dilations
// move diagonally, so only they carry the fix.
//
// Bound: the kernel moves ~3 packed masks (0.78 MB at 1080p, 0.23 us of HBM
// time); its cost is the number of steps (tile crossings along the longest
// edge chain) times a grid sync and a pass over the tiles, all L2 resident.
// Reads of words that other blocks write use __ldcg (L2, not the incoherent
// L1).  Races between a block's writes and a neighbour's halo reads are
// benign: words only gain bits, and a step that changes nothing saw a stable
// snapshot.

#include <cooperative_groups.h>

#include "masks.cuh"

namespace cg = cooperative_groups;

namespace {

using masks::hrow;
using masks::run_fill;
using masks::run_fill_down;

constexpr int TH = 32;             // tile rows
constexpr int TW = 8;              // tile words
constexpr int THREADS = TH * TW;   // one thread per tile word

struct Mask {
  const uint32_t* p;
  int H, wd;
  __device__ uint32_t operator()(int r, int j) const {
    return (r >= 0 && r < H && j >= 0 && j < wd) ? __ldcg(p + (size_t)r * wd + j)
                                                 : 0u;
  }
};

// the strict-reference value of bit 1 (pixel (0, 1)) of word (0, 0) after a
// dilation of `prev`: kept, or promoted from (0,0), (0,2), (1,1), (1,2) only
__device__ __forceinline__ uint32_t strict_fix(uint32_t d, uint32_t p0,
                                               uint32_t p1, uint32_t w0) {
  const uint32_t allowed = (p0 & 1u) | ((p0 >> 2) & 1u) | ((p1 >> 1) & 1u)
                           | ((p1 >> 2) & 1u);
  const uint32_t val = ((p0 >> 1) & 1u) | (((w0 >> 1) & 1u) & allowed);
  return (d & ~2u) | (val << 1);
}

__global__ void __launch_bounds__(THREADS)
flood_kernel(const uint32_t* __restrict__ weak, const uint32_t* strong,
             uint32_t* out, int H, int W, int strict, int* ctl) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t e_s[TH + 2][TW + 2];
  __shared__ uint32_t w_s[TH + 2][TW + 2];
  const int wd = (W + 31) / 32;
  const int ntx = (wd + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int ntiles = ntx * nty;
  const int tid = threadIdx.x, ly = tid / TW, lx = tid % TW;
  strict = strict && H >= 2 && W >= 2;
  const Mask S{strong, H, wd}, Wk{weak, H, wd}, E{out, H, wd};

  // ---- prologue: out = weak & dilate8(strong), the plain flood's first step
  const size_t n = (size_t)H * wd;
  for (size_t i = (size_t)blockIdx.x * THREADS + tid; i < n;
       i += (size_t)gridDim.x * THREADS) {
    const int rr = (int)(i / wd), j = (int)(i % wd);
    uint32_t h = 0;
    for (int dr = -1; dr <= 1; ++dr)
      h |= hrow(S(rr + dr, j - 1), S(rr + dr, j), S(rr + dr, j + 1));
    uint32_t d = Wk(rr, j) & h;
    if (strict && i == 0) d = strict_fix(d, S(0, 0), S(1, 0), Wk(0, 0));
    out[i] = d;
  }
  if (blockIdx.x == 0 && tid == 0) ctl[0] = ctl[1] = ctl[2] = 0;
  grid.sync();

  int step = 0;
  for (;;) {
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int r0 = (tile / ntx) * TH, j0 = (tile % ntx) * TW;
      for (int i = tid; i < (TH + 2) * (TW + 2); i += THREADS) {
        const int y = i / (TW + 2), x = i % (TW + 2);
        e_s[y][x] = E(r0 - 1 + y, j0 - 1 + x);
        w_s[y][x] = Wk(r0 - 1 + y, j0 - 1 + x);
      }
      __syncthreads();
      const int gr = r0 + ly, gj = j0 + lx;
      const bool mine = gr < H && gj < wd;
      const uint32_t orig = e_s[ly + 1][lx + 1];
      for (;;) {
        const uint32_t before = e_s[ly + 1][lx + 1];
        // dilation (Jacobi: all reads before any write)
        uint32_t d = before;
        if (mine) {
          uint32_t h = 0;
          for (int dy = 0; dy <= 2; ++dy)
            h |= hrow(e_s[ly + dy][lx], e_s[ly + dy][lx + 1],
                      e_s[ly + dy][lx + 2]);
          d |= w_s[ly + 1][lx + 1] & h;
          if (strict && gr == 0 && gj == 0)
            d = strict_fix(d, before, e_s[2][1], w_s[1][1]);
        }
        __syncthreads();
        e_s[ly + 1][lx + 1] = d;
        __syncthreads();
        // flood along each tile row, toward higher then lower columns
        if (tid < TH && r0 + tid < H) {
          const int nw = min(TW, wd - j0);
          uint32_t* er = &e_s[tid + 1][1];
          const uint32_t* wr = &w_s[tid + 1][1];
          uint32_t carry = 0;
          for (int x = 0; x < nw; ++x) er[x] = run_fill(wr[x], er[x], carry);
          carry = 0;
          for (int x = nw - 1; x >= 0; --x)
            er[x] = run_fill_down(wr[x], er[x], carry);
        }
        __syncthreads();
        // flood along each tile word column, down then up
        if (tid < TW && j0 + tid < wd) {
          const int nr = min(TH, H - r0);
          uint32_t carry = 0;
          for (int y = 1; y <= nr; ++y)
            carry = e_s[y][tid + 1] |= w_s[y][tid + 1] & carry;
          carry = 0;
          for (int y = nr; y >= 1; --y)
            carry = e_s[y][tid + 1] |= w_s[y][tid + 1] & carry;
        }
        __syncthreads();
        if (!__syncthreads_or(e_s[ly + 1][lx + 1] != before)) break;
      }
      const uint32_t now = e_s[ly + 1][lx + 1];
      const bool changed = mine && now != orig;
      if (changed) out[(size_t)gr * wd + gj] = now;
      if (__syncthreads_or(changed) && tid == 0) atomicOr(&ctl[step % 3], 1);
    }
    if (blockIdx.x == 0 && tid == 0) ctl[(step + 1) % 3] = 0;
    grid.sync();
    const int any = *(volatile int*)&ctl[step % 3];
    ++step;
    if (!any) break;
  }
  if (blockIdx.x == 0 && tid == 0) ctl[3] = step;
}

}  // namespace

extern "C" {

// weak, strong, out: uint32 (H, ceil(W/32)), row-major, device memory;
// ctl: int32[4] device scratch, ctl[3] receives the number of flood steps.
// Launches on `stream` and returns cudaGetLastError().
int canny_hysteresis_packed(const void* weak, const void* strong, void* out,
                            int H, int W, int strict, void* ctl, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int wd = (W + 31) / 32;
  const long ntiles = (long)((wd + TW - 1) / TW) * ((H + TH - 1) / TH);
  const int grid = (int)(ntiles < (long)per_sm * sms ? ntiles : (long)per_sm * sms);
  void* args[] = {(void*)&weak, (void*)&strong, &out, &H, &W, &strict, &ctl};
  e = cudaLaunchCooperativeKernel((const void*)flood_kernel, dim3(grid),
                                  dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
