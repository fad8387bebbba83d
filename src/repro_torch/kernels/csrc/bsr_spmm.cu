// K2: block-sparse SpMM over uniformized VBR tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `bsr_spmm_pallas` in
// src/repro/kernels/bsr_spmm.py. Same function:
//   Y[r*tm : (r+1)*tm, :] = sum over tiles b of row tile r of
//                           tiles[b] @ X[col_ids[b]*tk : +tk, :]
// with a float32 accumulator and Y in X's dtype (float32 or bfloat16). Row
// tiles that no tile visits come out as zeros. Only the tiles in the row
// offsets' range row_ptr[0]..row_ptr[n_row_tiles] are read: padding tiles
// sorted after the last row tile are never visited.
//
// The TPU grid is (n/bn parallel, tiles in order), with the output block
// resident in VMEM across one row's tiles. On the card a loop inside the CTA
// takes the place of the ordered grid axis, and each CTA owns its output
// rows alone, so no atomics are needed.
//
// bfloat16 (runs.cuh). What bounds it: bytes, at both of its callers. At the
// dropless MoE's dsd (tm = 8, tk = 1536, n = 5120) each X value (the stacked
// w2) meets only the rows of the capacity blocks its expert received, and
// the output is a mostly-zero 3.4 GB buffer at prefill; on the first path
// (tm = tk = 32, n = 128) the tiles themselves are most of the bytes. A CTA
// owns a panel of 64 / tm consecutive row tiles (64 rows of one tile when
// tm > 32) by 128 columns, and walks the panel's contiguous table range
// row_ptr[r0]..row_ptr[r0 + P]. Each run of consecutive tiles with one
// column tile, in distinct rows, is one pass over that X chunk: at the dsd
// a run is one expert's capacity blocks, about 2.8 tiles (22 rows) at
// prefill and 1.3 at decode, so each X chunk is read once per run instead of
// once per tile. On the first path a panel is 2 row tiles and a run mostly
// one tile. Panels without tiles only write zeros.
//
// float32. What bounds it: operations. Float32 stays on the FMA pipes
// (TF32 tensor cores would miss the 1e-5 tolerance), 67 TFLOP/s on the card;
// at u (tm = tk = 32, n = 128) that is 0.096 ms, against 0.030 ms for the
// bytes. The first port ran at 14% of it: one CTA per row tile (a 4x spread
// of tiles at u), two FMAs per 4-byte shared-memory load, and each 32-deep
// slice loaded synchronously behind two barriers. Here the tile table is
// split evenly over one wave of workers (six CTAs of 64 threads on each
// SM; schedule.cuh), a CTA being one worker's (32-row block, 128-column
// chunk). Each thread keeps an 8 x 8 block of the output in registers and
// reads both operands with 16-byte shared-memory loads, 256 FMAs for every
// 16 loads; the (tile, 16-deep slice of X) units come through a 3-stage
// ring, A by cp.async and, at n = 128, X by one bulk copy a unit (so that
// the copies do not queue with the shared-memory loads), the column index
// one unit ahead, so the next units load while one is multiplied. Row
// tiles that the split cuts go through the scratch slots and a second,
// dependent launch, as in K1, in a fixed order. What is left between it and
// the FMA rate is shared-memory traffic: 8 x 8 is the largest block the
// registers hold with six CTAs on an SM, and a thread still loads one
// 16-byte value for every four FMAs.
#include <cuda_runtime.h>
#include <c10/cuda/CUDAException.h>

#include <algorithm>
#include <cstdint>

#include "bulk.cuh"
#include "runs.cuh"
#include "schedule.cuh"

namespace {

// ---------------------------------------------------------------- float32
constexpr int kF32Threads = 64;  // 2 warps: 4 row groups x 16 column groups
constexpr int kF32CtasPerSm = 6;
constexpr int kBM = 32;           // rows of a CTA (one row tile, or 32 rows of a taller one)
constexpr int kBN = 128;          // columns of a CTA
constexpr int kBK = 16;           // depth of one stage
constexpr int kStages = 3;        // ring: two stages in flight while one is multiplied
constexpr int kLdA = kBK + 4;     // padded A rows (16-byte aligned)
constexpr int kAFloats = kBM * kLdA;
constexpr int kStageFloats = kAFloats + kBK * kBN;
constexpr int kF32Smem = kStages * kStageFloats * 4 + kStages * 8;  // and a barrier a stage

// 4 bytes from global to shared memory, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(runs::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One stage: kBM rows x kBK depth of a tile (A, row-major, padded rows) and
// the kBK x kBN block of X it meets. VEC: 16-byte copies (tk % 4 == 0,
// n % 4 == 0, aligned operands); else 4-byte ones. BULK: the caller brings
// X in with one bulk copy. Out-of-range values are zeros, so they add
// nothing.
template <bool VEC, bool BULK>
__device__ __forceinline__ void load_stage(float* st, const float* tile, const float* xb, int rows,
                                           int kc, int tk, int n, int cols) {
  float* As = st;
  float* Xs = st + kAFloats;
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / 4 / kF32Threads; ++j) {
      const int c = threadIdx.x + j * kF32Threads;
      const int row = c / (kBK / 4), k4 = (c % (kBK / 4)) * 4;
      const bool ok = row < rows && k4 < kc;
      runs::cp_async16(As + row * kLdA + k4, ok ? tile + static_cast<int64_t>(row) * tk + k4 : tile,
                       ok);
    }
    if constexpr (!BULK) {
#pragma unroll
      for (int j = 0; j < kBK * kBN / 4 / kF32Threads; ++j) {
        const int c = threadIdx.x + j * kF32Threads;
        const int kr = c / (kBN / 4), c4 = (c % (kBN / 4)) * 4;
        const bool ok = kr < kc && c4 < cols;
        runs::cp_async16(Xs + kr * kBN + c4, ok ? xb + static_cast<int64_t>(kr) * n + c4 : xb,
                         ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBM * kBK; e += kF32Threads) {
      const int row = e / kBK, k = e % kBK;
      const bool ok = row < rows && k < kc;
      cp_async4(As + row * kLdA + k, ok ? tile + static_cast<int64_t>(row) * tk + k : tile, ok);
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kF32Threads) {
      const int kr = e / kBN, c = e % kBN;
      const bool ok = kr < kc && c < cols;
      cp_async4(Xs + kr * kBN + c, ok ? xb + static_cast<int64_t>(kr) * n + c : xb, ok);
    }
  }
}

// acc (8 rows x 8 columns a thread) += the stage's A (kBM x kBK) @ X (kBK x kBN).
// A thread's rows are 8 * ty .. +7, its columns 4 * tx .. +3 and 64 + 4 * tx
// .. +3: every shared-memory read is 16 bytes, 16 of them for 256 FMAs.
__device__ __forceinline__ void multiply_stage(float (&acc)[8][8], const float* st, int tx,
                                               int ty) {
  const float* As = st + ty * 8 * kLdA;
  const float* Xs = st + kAFloats + tx * 4;
#pragma unroll
  for (int k = 0; k < kBK; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + i * kLdA + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x0 = *reinterpret_cast<const float4*>(Xs + (k + q) * kBN);
      const float4 x1 = *reinterpret_cast<const float4*>(Xs + (k + q) * kBN + 64);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, xv[j], acc[i][j]);
      }
    }
  }
}

// One CTA per (worker, 128-column chunk, 32-row block of the row tile).
// The worker's tiles come as units of (tile, kBK-deep slice), through a ring
// of kStages shared-memory stages; when the walk leaves a row tile, the
// accumulator goes to y (or to the worker's scratch slot, for a row tile the
// split cuts) straight from registers while the next stages load. BULK
// (VEC, n == kBN, tk % kBK == 0): a unit's X block is one contiguous 8 KB
// stretch of x, brought in by one bulk copy on the stage's barrier.
template <bool VEC, bool BULK>
__global__ void __launch_bounds__(kF32Threads, kF32CtasPerSm)
bsr_spmm_f32_kernel(const float* __restrict__ tiles, const int* __restrict__ row_ptr,
                    const int* __restrict__ col_ids, const float* __restrict__ x,
                    float* __restrict__ y, const int* __restrict__ schedule,
                    float* __restrict__ partial, int tm, int tk, int n) {
  extern __shared__ __align__(16) float smem[];
  sched::launch_dependents();
  const int w = blockIdx.x;
  const sched::Range g = sched::load(schedule, w);
  if (g.r0 >= g.r1) return;
  const int j0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * kBM;
  const int rows = min(kBM, tm - m0);
  const int cols = min(kBN, n - j0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_kc = (tk + kBK - 1) / kBK;
  const int n_units = (g.t1 - g.t0) * n_kc;
  const int64_t tile_elems = static_cast<int64_t>(tm) * tk;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageFloats);
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) bulk::init(full + s);
      bulk::fence_init();
    }
    __syncthreads();
  }
  // stage the unit u: tile t0 + u / n_kc at depth (u % n_kc) * kBK, whose
  // column index `cid` the caller fetched one unit ahead
  auto load_unit = [&](int u, int cid) {
    const int b = g.t0 + u / n_kc, k0 = (u % n_kc) * kBK;
    float* st = smem + (u % kStages) * kStageFloats;
    const float* xb = x + (static_cast<int64_t>(cid) * tk + k0) * n + j0;
    load_stage<VEC, BULK>(st, tiles + b * tile_elems + static_cast<int64_t>(m0) * tk + k0, xb,
                          rows, min(kBK, tk - k0), tk, n, cols);
    if (BULK && threadIdx.x == 0) {
      bulk::expect(full + u % kStages, kBK * kBN * 4);
      bulk::copy(st + kAFloats, xb, kBK * kBN * 4, full + u % kStages);
    }
  };
  auto cid_of = [&](int u) { return u < n_units ? col_ids[g.t0 + u / n_kc] : 0; };

  float acc[8][8];
  auto flush = [&](int r) {  // row tile r's block out of acc, then acc = 0
    const int s = sched::slot(g, w, r);
    float* out = (s < 0 ? y + static_cast<int64_t>(r) * tm * n
                        : partial + static_cast<int64_t>(s) * tm * n) +
                 static_cast<int64_t>(m0) * n + j0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty * 8 + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * 64 + tx * 4;
        float* p = out + static_cast<int64_t>(row) * n + c;
        if (row < rows) {
          if (VEC && c < cols) {
            *reinterpret_cast<float4*>(p) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else if (!VEC) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c + j < cols) p[j] = acc[i][4 * h + j];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * h + j] = 0.f;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int cid = cid_of(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int next = cid_of(s + 1);
    if (s < n_units) load_unit(s, cid);
    runs::cp_async_commit();
    cid = next;
  }
  int r = g.r0;
  int r_end = row_ptr[r + 1];
  for (int u = 0; u < n_units; ++u) {
    runs::cp_async_wait<kStages - 2>();
    if (BULK) bulk::wait(full + u % kStages, (u / kStages) & 1);
    __syncthreads();  // unit u has landed; every thread is done with unit u - 1's stage
    {
      const int ahead = u + kStages - 1;
      const int next = cid_of(ahead + 1);
      if (ahead < n_units) load_unit(ahead, cid);
      runs::cp_async_commit();
      cid = next;
    }
    if (u % n_kc == 0) {
      const int b = g.t0 + u / n_kc;
      while (b >= r_end) {  // leaving row tile r (and any empty ones after it)
        flush(r);
        r_end = row_ptr[++r + 1];
      }
    }
    multiply_stage(acc, smem + (u % kStages) * kStageFloats, tx, ty);
  }
  runs::cp_async_wait<0>();
  flush(r);
  while (++r < g.r1) flush(r);  // the empty row tiles at the end (last worker)
}

template <bool VEC, bool BULK>
void launch_f32(const void* tiles, const int* row_ptr, const int* col_ids, const void* x, void* y,
                const int* schedule, int n_workers, float* partial, int tm, int tk, int n,
                cudaStream_t stream) {
  const dim3 grid(n_workers, (n + kBN - 1) / kBN, (tm + kBM - 1) / kBM);
  TORCH_CHECK(grid.y < 65536 && grid.z < 65536, "bsr_spmm: too many column chunks or row blocks");
  bsr_spmm_f32_kernel<VEC, BULK><<<grid, kF32Threads, kF32Smem, stream>>>(
      static_cast<const float*>(tiles), row_ptr, col_ids, static_cast<const float*>(x),
      static_cast<float*>(y), schedule, partial, tm, tk, n);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  sched::combine<float>(schedule, row_ptr, partial, static_cast<float*>(y), n_workers,
                        static_cast<int64_t>(tm) * n, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// --------------------------------------------------------------- bfloat16
using runs::bf16;

// The passes of one panel: runs of consecutive tiles with one column tile,
// in distinct row tiles.
struct SpmmRuns {
  const bf16* tiles;
  const int* row_ptr;
  const int* col_ids;
  const bf16* x;
  int tm, tk, n, j0;
  int r0, m0, rows_here;  // the panel's first row tile and its first row in that tile
  int e, e_end, row;      // the next tile, the end of the panel's, and e's row tile

  __device__ runs::Pass<bf16> next() {
    runs::Pass<bf16> p{{nullptr, nullptr}, nullptr, 0u};
    if (e >= e_end) return p;
    const int c = col_ids[e];
    p.w = x + static_cast<int64_t>(c) * tk * n + j0;
    for (int prev = -1; e < e_end; ++e, prev = row) {
      while (row_ptr[row + 1] <= e) ++row;
      if (col_ids[e] != c || row == prev) break;
      runs::add_unit(p, (row - r0) * tm - m0, tm, rows_here,
                     tiles + static_cast<int64_t>(e) * tm * tk, tk);
    }
    return p;
  }
};

// One CTA per (panel of `panel_tiles` row tiles, block of 64 rows within a
// row tile when tm > 32, 128 columns); the column chunk varies fastest, so
// the CTAs of one panel run together and share its tiles in L2.
template <bool VEC>
__global__ void __launch_bounds__(runs::kThreads)
bsr_spmm_runs_kernel(const bf16* __restrict__ tiles, const int* __restrict__ row_ptr,
                     const int* __restrict__ col_ids, const bf16* __restrict__ x,
                     bf16* __restrict__ y, int n_row_tiles, int tm, int tk, int n,
                     int panel_tiles, int m_blocks, int n_chunks) {
  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int m0 = (rest % m_blocks) * runs::kRows;
  const int r0 = rest / m_blocks * panel_tiles;
  const int r1 = min(r0 + panel_tiles, n_row_tiles);
  const int rows_here = min(runs::kRows, (r1 - r0) * tm - m0);
  const int j0 = chunk * runs::kBN;
  const int cols_here = min(runs::kBN, n - j0);
  bf16* out = y + (static_cast<int64_t>(r0) * tm + m0) * n + j0;
  const int e0 = row_ptr[r0], e1 = row_ptr[r1];
  if (e0 == e1) {  // no tile in the panel
    runs::write_tile<VEC, true, bf16>(nullptr, out, n, rows_here, cols_here);
    return;
  }
  SpmmRuns sched{tiles, row_ptr, col_ids, x, tm, tk, n, j0, r0, m0, rows_here, e0, e1, r0};
  runs::run_passes<VEC>(sched, tk, n, rows_here, cols_here, out, n);
}

template <bool VEC>
void launch_runs(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                 void* y, int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  const int panel_tiles = tm <= runs::kRows / 2 ? runs::kRows / tm : 1;
  const int m_blocks = panel_tiles > 1 ? 1 : (tm + runs::kRows - 1) / runs::kRows;
  const int n_chunks = (n + runs::kBN - 1) / runs::kBN;
  const int64_t n_ctas = static_cast<int64_t>((n_row_tiles + panel_tiles - 1) / panel_tiles) *
                         m_blocks * n_chunks;
  TORCH_CHECK(n_ctas < (int64_t{1} << 31), "bsr_spmm: too many CTAs for one launch");
  bsr_spmm_runs_kernel<VEC><<<static_cast<unsigned>(n_ctas), runs::kThreads, 0, stream>>>(
      static_cast<const bf16*>(tiles), row_ptr, col_ids, static_cast<const bf16*>(x),
      static_cast<bf16*>(y), n_row_tiles, tm, tk, n, panel_tiles, m_blocks, n_chunks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Workers of the float32 body for tiles of tm rows and n columns on the
// current device: one wave of CTAs (kF32CtasPerSm on each SM) over the
// column chunks and row blocks.
int bsr_spmm_workers(int tm, int n) {
  const int blocks = ((n + kBN - 1) / kBN) * ((tm + kBM - 1) / kBM);
  return std::max(1, (sched::sm_count() * kF32CtasPerSm + blocks - 1) / blocks);
}

// tiles (nb, tm, tk), row_ptr (n_row_tiles + 1,), col_ids (nb,), x (k_pad, n),
// y (n_row_tiles * tm, n); all contiguous on one device, checked by the
// caller. float32 also takes schedule (n_workers, 5) and partial
// (2 * n_workers * tm * n,) float32 scratch; bfloat16 walks row_ptr alone.
void bsr_spmm_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, const int* schedule, int n_workers, float* partial,
                     int n_row_tiles, int tm, int tk, int n, bool is_bf16, cudaStream_t stream) {
  if (n_row_tiles == 0 || n == 0) return;
  if (is_bf16) {
    // 16-byte loads and stores need 16-byte aligned rows of tiles, x and y
    const bool vec = tk % 8 == 0 && n % 8 == 0 && aligned16(tiles) && aligned16(x) &&
                     aligned16(y);
    if (vec)
      launch_runs<true>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
    else
      launch_runs<false>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
    return;
  }
  const bool vec = tk % 4 == 0 && n % 4 == 0 && aligned16(tiles) && aligned16(x) && aligned16(y);
  if (vec && n == kBN && tk % kBK == 0)
    launch_f32<true, true>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk, n,
                           stream);
  else if (vec)
    launch_f32<true, false>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk,
                            n, stream);
  else
    launch_f32<false, false>(tiles, row_ptr, col_ids, x, y, schedule, n_workers, partial, tm, tk,
                             n, stream);
}
