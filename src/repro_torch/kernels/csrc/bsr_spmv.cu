// K1: block-sparse SpMV over uniformized VBR tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `bsr_spmv_pallas` in
// src/repro/kernels/bsr_spmv.py. Same function:
//   y[r*tm : (r+1)*tm] = sum over tiles b of row tile r of tiles[b] @ x[col_ids[b]*tk : +tk]
// with a float32 accumulator and y in x's dtype (float32 or bfloat16). Row
// tiles that no tile visits come out as zeros; tiles past row_ptr[R] are
// never read.
//
// What bounds it: bytes. Every tile value is read once and used in one
// multiply-add, so the kernel streams `tiles` from device memory (100 MB in
// float32 at the paper's matrix u); x is small and stays in L1/L2. Two
// things kept the first port at 43% of that bound: one CTA per row tile,
// whose runs differ by 4x (u) to 16x (nu), left the card on a tail of long
// rows; and each thread had about one 16-byte load in flight, behind the
// load of its column index.
//
// Design. The grid is sized to the card: `n_workers` CTAs, as many as are
// resident at once, each taking an equal contiguous range of the sorted tile
// table (schedule.cuh). A group of `gw` lanes owns one tile row, one 16-byte
// vector a lane (4 values in float32, 8 in bfloat16), and keeps a float32
// sum over the row tile's tiles, reduced with warp shuffles when the walk
// leaves the row tile; consecutive groups own consecutive rows. At 32 x 32
// tiles a CTA is 256 threads in float32 (two on each SM) and 128 in
// bfloat16 (four). A row tile the CTA holds whole is written into y; the
// parts of a row tile that the split cuts go to a scratch slot and are
// added in worker order by a second, dependent launch, so the result is the
// same bits on every launch.
//
// Bytes in flight: a CTA's range is one contiguous stretch of `tiles`, so one
// thread streams it into a ring of kStages stages of kBatch tiles with 1-D
// bulk copies (cp.async.bulk, completing on an mbarrier a stage): two
// batches, 64 KB a CTA and 128 KB an SM in both dtypes, are in flight while
// the CTA sums the third, and no register or thread holds a load in flight.
// The batch's column indices came in during the previous batch, one a lane,
// and reach the x loads by warp shuffle. Tiles whose rows are not whole
// 16-byte vectors, or longer than 32 of them, or that are not 16-byte
// aligned, take a plain path: scalar loads into registers, four tiles at a
// time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "bulk.cuh"
#include "schedule.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads of a CTA (one worker)
constexpr int kBatch = 8;      // tiles a batch
constexpr int kStages = 3;     // ring stages: two batches in flight while one is summed
constexpr int kPlainBatch = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum of a[j] * b[j] over the 16 / sizeof(T) values of two 16-byte vectors.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  constexpr int V = 16 / sizeof(T);
  T ea[V], eb[V];
  memcpy(ea, &a, 16);
  memcpy(eb, &b, 16);
  float s = to_float(ea[0]) * to_float(eb[0]);
#pragma unroll
  for (int j = 1; j < V; ++j) s = fmaf(to_float(ea[j]), to_float(eb[j]), s);
  return s;
}

// The running sum of one tile row across the worker's walk of row tiles.
template <typename T>
struct RowSums {
  const int* row_ptr;
  T* y;
  float* partial;
  sched::Range g;
  int w, tm, i, gw, lane;
  bool live;
  int r, r_end;
  float acc;

  __device__ void start() {
    r = g.r0;
    r_end = row_ptr[r + 1];
    acc = 0.f;
  }
  // Row tile r's sum, reduced over the group's lanes and written.
  __device__ void flush(float v) {
    for (int off = gw >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (live && lane == 0) {
      const int s = sched::slot(g, w, r);
      if (s < 0)
        sched::store(y + static_cast<int64_t>(r) * tm + i, v);
      else
        partial[static_cast<int64_t>(s) * tm + i] = v;
    }
  }
  // Tile b's part; called alike across the worker, as flush's shuffles need.
  __device__ void add(int b, float part) {
    while (b >= r_end) {  // leaving row tile r (and any empty ones after it)
      flush(acc);
      acc = 0.f;
      r_end = row_ptr[++r + 1];
    }
    acc += part;
  }
  __device__ void finish() {
    flush(acc);
    while (++r < g.r1) flush(0.f);  // the empty row tiles at the end (last worker)
  }
};

// One CTA a worker: `rows` row groups of `gw` lanes (gw * rows threads, a
// power of two from 32 to kThreads, so the walk is uniform across each
// warp); rows past tm take more passes over the range. BULK: tk is a
// multiple of V = 16 / sizeof(T), at most 32 V, and tiles and x are 16-byte
// aligned.
template <typename T, bool BULK>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmv_kernel(const T* __restrict__ tiles, const int* __restrict__ row_ptr,
                const int* __restrict__ col_ids, const T* __restrict__ x, T* __restrict__ y,
                const int* __restrict__ schedule, float* __restrict__ partial, int tm, int tk,
                int gw, int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = BULK ? kBatch : kPlainBatch;
  // BULK: kStages stages of kBatch tiles' pass rows, then a barrier a stage
  extern __shared__ __align__(16) unsigned char ring[];
  sched::launch_dependents();
  const int w = blockIdx.x;
  const sched::Range g = sched::load(schedule, w);
  if (g.r0 >= g.r1) return;
  const int lane = threadIdx.x & (gw - 1);
  const int group = threadIdx.x / gw;
  const int n_vec = (tk + V - 1) / V;
  const int passes = (n_vec + gw - 1) / gw;  // 1 with BULK; the same for every lane
  const int64_t tile_elems = static_cast<int64_t>(tm) * tk;
  const int n_batches = (g.t1 - g.t0 + U - 1) / U;
  // lane l of the warp holds the column index of tile b0 + l % U
  const int cl = (threadIdx.x & 31) % U;
  const int row_bytes = tk * static_cast<int>(sizeof(T));
  const int stage_bytes = kBatch * rows * row_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * stage_bytes);
  if (BULK && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bulk::init(full + s);
    bulk::fence_init();
  }
  if (BULK) __syncthreads();

  for (int i0 = 0, pass = 0; i0 < tm; i0 += rows, ++pass) {
    const int i = i0 + group;
    const int rows_here = min(rows, tm - i0);
    RowSums<T> sums{row_ptr, y, partial, g, w, tm, i, gw, lane, i < tm};
    sums.start();
    // batch k of this pass is batch `base + k` of the CTA: its stage and phase
    const int base = pass * n_batches;
    auto issue = [&](int k) {  // thread 0: batch k's pass rows into its stage
      const int s = (base + k) % kStages;
      const int b0 = g.t0 + k * kBatch;
      const int n = min(kBatch, g.t1 - b0);
      const unsigned bytes = rows_here * row_bytes;
      bulk::expect(full + s, n * bytes);
      if (rows_here == tm)  // whole tiles: the batch is one stretch of `tiles`
        bulk::copy(ring + s * stage_bytes, tiles + b0 * tile_elems, n * bytes, full + s);
      else
        for (int u = 0; u < n; ++u)
          bulk::copy(ring + s * stage_bytes + u * bytes, tiles + (b0 + u) * tile_elems + i0 * tk,
                    bytes, full + s);
    };
    if (BULK && threadIdx.x == 0)
      for (int k = 0; k < kStages - 1 && k < n_batches; ++k) issue(k);
    int cid_next = g.t0 + cl < g.t1 ? col_ids[g.t0 + cl] : 0;
    for (int k = 0; k < n_batches; ++k) {
      const int b0 = g.t0 + k * U;
      const int cid = cid_next;
      cid_next = b0 + U + cl < g.t1 ? col_ids[b0 + U + cl] : 0;
      float part[U];
      if constexpr (BULK) {
        // the stage batch k - 1 used is free (the barrier at the end of k - 1)
        if (threadIdx.x == 0 && k + kStages - 1 < n_batches) issue(k + kStages - 1);
        uint4 xv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t c = __shfl_sync(0xffffffffu, cid, u);
          xv[u] = lane < n_vec && b0 + u < g.t1
                      ? __ldg(reinterpret_cast<const uint4*>(x + c * tk + lane * V))
                      : make_uint4(0, 0, 0, 0);
        }
        const int s = (base + k) % kStages;
        bulk::wait(full + s, ((base + k) / kStages) & 1);
        const unsigned char* st = ring + s * stage_bytes + group * row_bytes + lane * 16;
        const bool mine = group < rows_here && lane < n_vec;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const uint4 tv = mine && b0 + u < g.t1
                               ? *reinterpret_cast<const uint4*>(st + u * rows_here * row_bytes)
                               : make_uint4(0, 0, 0, 0);
          part[u] = dot16<T>(tv, xv[u]);
        }
      } else {
        const T* row = tiles + static_cast<int64_t>(i) * tk;
#pragma unroll
        for (int u = 0; u < U; ++u) part[u] = 0.f;
        for (int p = 0; p < passes; ++p) {
          const int e0 = (lane + p * gw) * V;  // this lane's first value in the tile row
          float tv[U][V], xs[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t c = __shfl_sync(0xffffffffu, cid, u);
            const bool ok = b0 + u < g.t1;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const bool in = ok && e0 + v < tk;
              tv[u][v] = in && i < tm ? to_float(row[(b0 + u) * tile_elems + e0 + v]) : 0.f;
              xs[u][v] = in ? to_float(x[c * tk + e0 + v]) : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v) part[u] = fmaf(tv[u][v], xs[u][v], part[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (b0 + u >= g.t1) break;
        sums.add(b0 + u, part[u]);
      }
      if (BULK) __syncthreads();  // every thread is done with batch k's stage
    }
    sums.finish();
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Lanes a tile row and rows a pass of one worker; W = gw * rows threads.
void worker_shape(int tm, int tk, bool bf16, int* gw, int* rows) {
  const int V = bf16 ? 8 : 4;
  *gw = std::min(32, pow2_ceil((tk + V - 1) / V));
  *rows = std::min(std::max(pow2_ceil(tm), 32 / *gw), kThreads / *gw);
}

// Dynamic shared memory of the BULK kernel: the ring and its barriers.
int ring_bytes(int tk, int rows, int elem_bytes) {
  return kStages * kBatch * rows * tk * elem_bytes + kStages * 8;
}

template <typename T, bool BULK>
void launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x, void* y,
            const int* schedule, int n_workers, float* partial, int tm, int tk,
            cudaStream_t stream) {
  int gw, rows;
  worker_shape(tm, tk, sizeof(T) == 2, &gw, &rows);
  const int smem = BULK ? ring_bytes(tk, rows, sizeof(T)) : 0;
  if (BULK)
    C10_CUDA_CHECK(cudaFuncSetAttribute(bsr_spmv_kernel<T, BULK>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  bsr_spmv_kernel<T, BULK><<<n_workers, gw * rows, smem, stream>>>(
      static_cast<const T*>(tiles), row_ptr, col_ids, static_cast<const T*>(x),
      static_cast<T*>(y), schedule, partial, tm, tk, gw, rows);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  sched::combine<T>(schedule, row_ptr, partial, static_cast<T*>(y), n_workers, tm, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Tile rows of whole 16-byte vectors, at most 32 of them: the BULK shapes.
template <typename T>
bool bulk_shape(int tk) {
  constexpr int V = 16 / sizeof(T);
  return tk % V == 0 && tk <= 32 * V;
}

template <typename T>
void launch_either(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                   void* y, const int* schedule, int n_workers, float* partial, int tm, int tk,
                   cudaStream_t stream) {
  const bool bulk = bulk_shape<T>(tk) && reinterpret_cast<uintptr_t>(tiles) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (bulk)
    launch<T, true>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk, stream);
  else
    launch<T, false>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk, stream);
}

// CTAs resident on one SM of the kernel that tiles of tm x tk take (BULK
// where the shape allows it, as with aligned operands).
template <typename T>
int ctas_per_sm(int tm, int tk) {
  int gw, rows, n = 0;
  worker_shape(tm, tk, sizeof(T) == 2, &gw, &rows);
  if (bulk_shape<T>(tk)) {
    const int smem = ring_bytes(tk, rows, sizeof(T));
    C10_CUDA_CHECK(cudaFuncSetAttribute(bsr_spmv_kernel<T, true>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bsr_spmv_kernel<T, true>,
                                                                 gw * rows, smem));
  } else {
    C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bsr_spmv_kernel<T, false>,
                                                                 gw * rows, 0));
  }
  return std::max(n, 1);
}

}  // namespace

// Workers (CTAs) for tiles of tm x tk on the current device: as many as are
// resident at once.
int bsr_spmv_workers(int tm, int tk, bool bf16) {
  const int per_sm = bf16 ? ctas_per_sm<__nv_bfloat16>(tm, tk) : ctas_per_sm<float>(tm, tk);
  return sched::sm_count() * per_sm;
}

// tiles (nb, tm, tk), row_ptr (R + 1,), col_ids (nb,), x (k_pad,), y (R * tm,),
// schedule (n_workers, 5), partial (2 * n_workers * tm,) float32 scratch; all
// contiguous on one device, checked by the caller.
void bsr_spmv_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, const int* schedule, int n_workers, float* partial, int tm, int tk,
                     bool bf16, cudaStream_t stream) {
  if (bf16)
    launch_either<__nv_bfloat16>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm,
                                 tk, stream);
  else
    launch_either<float>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk,
                         stream);
}
