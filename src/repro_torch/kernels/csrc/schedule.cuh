// The balanced split of a sorted tile table that K1 (bsr_spmv.cu) and K2's
// float32 body (bsr_spmm.cu) walk, and the pass that joins the row tiles the
// split cuts.
//
// The schedule is built on the device by `ops.tile_schedule` from the row
// offsets alone, once per structure: an int32 (n_workers, 5) table whose row
// w holds
//   t0, t1  worker w's range of the tile table, [t0, t1): the table range
//           row_ptr[0]..row_ptr[R] cut into n_workers parts whose lengths
//           differ by at most one tile;
//   r0, r1  the row tiles it walks, [r0, r1): the row tile holding t0 (or
//           the first one starting at t0, empty ones included), up to the
//           last one starting before t1; the last worker also takes the
//           empty row tiles at the end. A worker with no tiles walks none,
//           except the last, which writes the empty row tiles;
//   flags   kHead: row tile r0 began before t0, so the worker holds only a
//           part of it; kTail: row tile r1 - 1 goes on past t1 (and is not
//           the kHead row tile).
// A worker writes each row tile it holds whole into y, and the part of a
// row tile that it shares into its slot of a float32 scratch buffer: slot
// 2w for the kHead part, 2w + 1 for the kTail part. `combine_kernel` then
// adds each shared row tile's parts in worker order and writes it once, so
// two launches on the same inputs give the same bits and no atomics are
// needed.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace sched {

constexpr int kFields = 5;
constexpr int kHead = 1;
constexpr int kTail = 2;

struct Range {
  int t0, t1, r0, r1, flags;
};

__device__ __forceinline__ Range load(const int* __restrict__ schedule, int w) {
  const int* s = schedule + kFields * w;
  return {s[0], s[1], s[2], s[3], s[4]};
}

// The scratch slot worker w writes row tile r to, or -1: r is whole here.
__device__ __forceinline__ int slot(const Range& g, int w, int r) {
  if (r == g.r0 && (g.flags & kHead)) return 2 * w;
  if (r == g.r1 - 1 && (g.flags & kTail)) return 2 * w + 1;
  return -1;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Lets the combine launch that follows start as this grid's CTAs finish.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Grid (n_workers, chunks of the row tile's `elems` values: tm, or tm * n;
// four values a thread). A worker with a kTail part is the first of the
// workers that share that row tile: its CTAs add the parts of the row tile,
// its own first, then the kHead part of every later worker whose range
// starts inside the row tile, and write y. Launched as a programmatic
// dependent of the kernel that wrote the parts: it waits for that grid here,
// after its own start-up.
template <typename T>
__global__ void combine_kernel(const int* __restrict__ schedule, const int* __restrict__ row_ptr,
                               const float* __restrict__ partial, T* __restrict__ y,
                               int n_workers, int64_t elems) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int w = blockIdx.x;
  const int64_t e = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * 4;
  const Range g = load(schedule, w);
  if (!(g.flags & kTail) || e >= elems) return;
  const int r = g.r1 - 1;
  const int end = row_ptr[r + 1];
  int w_end = w + 1;  // the workers whose range starts inside row tile r
  while (w_end < n_workers && schedule[kFields * w_end] < end) ++w_end;
  const int n = static_cast<int>(min(int64_t{4}, elems - e));
  float acc[4];
  const float* tail = partial + (2 * w + 1) * elems + e;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = j < n ? tail[j] : 0.f;
  for (int v = w + 1; v < w_end; ++v) {
    if (!(schedule[kFields * v + 4] & kHead)) continue;
    const float* head = partial + 2 * v * elems + e;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) acc[j] += head[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) store(y + r * elems + e + j, acc[j]);
}

template <typename T>
void combine(const int* schedule, const int* row_ptr, const float* partial, T* y, int n_workers,
             int64_t elems, cudaStream_t stream) {
  constexpr int kThreadsC = 256;
  cudaLaunchConfig_t cfg = {};
  const int64_t chunk = 4 * kThreadsC;
  cfg.gridDim = dim3(n_workers, static_cast<unsigned>((elems + chunk - 1) / chunk));
  cfg.blockDim = dim3(kThreadsC);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, combine_kernel<T>, schedule, row_ptr, partial, y, n_workers, elems);
}

// Streaming multiprocessors of the current device.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace sched
