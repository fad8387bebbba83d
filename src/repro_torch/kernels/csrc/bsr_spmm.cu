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
// float32: as first ported, one CTA per (row tile, 8 * RM rows, 32 * CN
// columns), float32 FMAs from shared memory.
#include <cuda_runtime.h>
#include <c10/cuda/CUDAException.h>

#include <cstdint>

#include "runs.cuh"

namespace {

// ---------------------------------------------------------------- float32
constexpr int kThreads = 256;  // 8 warps: 8 row groups x 32 column lanes
constexpr int kBK = 32;        // depth staged in shared memory per step

// RM rows per warp (BM = 8 * RM), CN columns per lane (BN = 32 * CN).
template <int RM, int CN>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ tiles, const int* __restrict__ row_ptr,
                const int* __restrict__ col_ids, const float* __restrict__ x,
                float* __restrict__ y, int tm, int tk, int n, int m_blocks) {
  constexpr int BM = 8 * RM;
  constexpr int BN = 32 * CN;
  __shared__ float As[kBK][BM + 1];  // tile slice, transposed; +1 spreads the stores over banks
  __shared__ float Xs[kBK][BN];

  const int rt = blockIdx.x / m_blocks;
  const int m0 = (blockIdx.x % m_blocks) * BM;
  const int j0 = blockIdx.y * BN;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int rows = min(BM, tm - m0);
  const int cols = min(BN, n - j0);
  const int b0 = row_ptr[rt];
  const int b1 = row_ptr[rt + 1];

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int q = 0; q < CN; ++q) acc[i][q] = 0.f;

  for (int b = b0; b < b1; ++b) {
    const float* tile = tiles + static_cast<size_t>(b) * tm * tk + static_cast<size_t>(m0) * tk;
    const float* xb = x + static_cast<size_t>(col_ids[b]) * tk * n + j0;
    for (int k0 = 0; k0 < tk; k0 += kBK) {
      const int kc = min(kBK, tk - k0);
      for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
        const int row = e / kBK;
        const int kk = e % kBK;
        As[kk][row] = (row < rows && kk < kc) ? tile[static_cast<size_t>(row) * tk + k0 + kk] : 0.f;
      }
      for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
        const int kk = e / BN;
        const int c = e % BN;
        Xs[kk][c] = (kk < kc && c < cols) ? xb[static_cast<size_t>(k0 + kk) * n + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kc; ++kk) {
        float a[RM];
        float xv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
        for (int q = 0; q < CN; ++q) xv[q] = Xs[kk][tx + 32 * q];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int q = 0; q < CN; ++q) acc[i][q] = fmaf(a[i], xv[q], acc[i][q]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = ty * RM + i;
    if (row >= rows) continue;
    float* yrow = y + (static_cast<size_t>(rt) * tm + m0 + row) * n + j0;
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int c = tx + 32 * q;
      if (c < cols) yrow[c] = acc[i][q];
    }
  }
}

template <int RM, int CN>
void launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x, void* y,
            int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  const int m_blocks = (tm + 8 * RM - 1) / (8 * RM);
  const dim3 grid(n_row_tiles * m_blocks, (n + 32 * CN - 1) / (32 * CN));
  bsr_spmm_kernel<RM, CN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(tiles), row_ptr, col_ids, static_cast<const float*>(x),
      static_cast<float*>(y), tm, tk, n, m_blocks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <int RM>
void launch_cn(int cn, const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
               void* y, int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  if (cn == 1)
    launch<RM, 1>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else if (cn == 2)
    launch<RM, 2>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else
    launch<RM, 4>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
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

  __device__ runs::Pass next() {
    runs::Pass p{{nullptr, nullptr}, nullptr, 0u};
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
    runs::write_tile<VEC, true>(nullptr, out, n, rows_here, cols_here);
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

// tiles (nb, tm, tk), row_ptr (n_row_tiles + 1,), col_ids (nb,), x (k_pad, n),
// y (n_row_tiles * tm, n); all contiguous on one device, checked by the caller.
// A float32 CTA takes 32, 64 or 128 columns, the fewest that cover n; a
// bfloat16 CTA always takes 128.
void bsr_spmm_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, int n_row_tiles, int tm, int tk, int n, bool is_bf16,
                     cudaStream_t stream) {
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
  const int cn = n <= 32 ? 1 : n <= 64 ? 2 : 4;
  if (tm <= 8)
    launch_cn<1>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else if (tm <= 16)
    launch_cn<2>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else
    launch_cn<4>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
}
