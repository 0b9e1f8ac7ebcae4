// The scheduler of tools/cuda_emu/emu.h: a block's threads are fibers, run
// in turn until each reaches a barrier or ends; a barrier releases its
// fibers when every fiber it waits for has reached it.
#include "emu.h"

#include <cstdio>
#include <cstdlib>
#include <ucontext.h>
#include <vector>

uint3_ threadIdx, blockIdx;
dim3 blockDim, gridDim;
int emu_error = 0;
alignas(16) unsigned char emu_smem[232448 + 64];
// the card the emulation answers for: SMs, blocks an SM, opt-in shared memory;
// and the grid of the last launch
extern "C" {
int emu_sms = 4, emu_per_sm = 1, emu_optin = 232448;
unsigned emu_grid[3];
}
int emu_attr(cudaDeviceAttr a) {
  return a == cudaDevAttrMultiProcessorCount ? emu_sms : emu_optin;
}
int emu_blocks_per_sm() { return emu_per_sm; }

namespace {
enum State { READY, AT_SYNCTHREADS, AT_BALLOT, DONE, AT_NAMED };
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  State state;
  bool pred;
  unsigned value;   // the ballot's result, or the named barrier waited on
};
std::vector<Fiber> fibers;
ucontext_t scheduler;
int current = -1, named[16];
std::function<void()> body_fn;

void entry() {
  body_fn();
  fibers[current].state = DONE;
  swapcontext(&fibers[current].ctx, &scheduler);
}
void wait_as(State s) {
  fibers[current].state = s;
  swapcontext(&fibers[current].ctx, &scheduler);
}
void release_named(int id) {
  named[id] = 0;
  for (auto& f : fibers)
    if (f.state == AT_NAMED && (int)f.value == id) f.state = READY;
}
}  // namespace

void __syncthreads() { wait_as(AT_SYNCTHREADS); }

unsigned __ballot_sync(unsigned, bool pred) {
  fibers[current].pred = pred;
  wait_as(AT_BALLOT);
  return fibers[current].value;
}

void emu_bar_arrive(int id, int n) {
  if (++named[id] == n) release_named(id);
}

void emu_bar_sync(int id, int n) {
  if (++named[id] == n) {
    release_named(id);
    return;
  }
  fibers[current].value = id;
  wait_as(AT_NAMED);
}

void emu_run(dim3 grid, int threads, size_t smem, std::function<void()> body) {
  if (smem > (size_t)emu_optin) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  body_fn = body;
  gridDim = grid;
  emu_grid[0] = grid.x;
  emu_grid[1] = grid.y;
  emu_grid[2] = grid.z;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        memset(emu_smem, 0xA5, sizeof(emu_smem));    // garbage, as on a card
        for (int& c : named) c = 0;
        fibers.assign(threads, Fiber());
        for (int t = 0; t < threads; ++t) {
          Fiber& f = fibers[t];
          f.stack.resize(256 * 1024);
          f.state = READY;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.data();
          f.ctx.uc_stack.ss_size = f.stack.size();
          f.ctx.uc_link = nullptr;
          makecontext(&f.ctx, entry, 0);
        }
        for (;;) {
          bool progress = false;
          for (int t = 0; t < threads; ++t) {
            if (fibers[t].state != READY) continue;
            current = t;
            threadIdx = {(unsigned)t, 0, 0};
            swapcontext(&scheduler, &fibers[t].ctx);
            progress = true;
          }
          // a ballot completes when every live lane of its warp is at it
          for (int w = 0; w * 32 < threads; ++w) {
            bool all = true, any = false;
            unsigned bits = 0;
            for (int l = 0; l < 32 && w * 32 + l < threads; ++l) {
              const Fiber& f = fibers[w * 32 + l];
              if (f.state == DONE) continue;
              if (f.state != AT_BALLOT) { all = false; break; }
              any = true;
              if (f.pred) bits |= 1u << l;
            }
            if (!all || !any) continue;
            for (int l = 0; l < 32 && w * 32 + l < threads; ++l) {
              Fiber& f = fibers[w * 32 + l];
              if (f.state == AT_BALLOT) { f.state = READY; f.value = bits; }
            }
            progress = true;
          }
          bool live = false, at_sync = true;
          for (const auto& f : fibers) {
            if (f.state != DONE) live = true;
            if (f.state != DONE && f.state != AT_SYNCTHREADS) at_sync = false;
          }
          if (!live) break;
          if (at_sync) {
            for (auto& f : fibers)
              if (f.state == AT_SYNCTHREADS) f.state = READY;
            continue;
          }
          if (!progress) {
            fprintf(stderr, "cuda_emu: block (%u, %u, %u) waits forever\n",
                    x, y, z);
            abort();
          }
        }
      }
}
