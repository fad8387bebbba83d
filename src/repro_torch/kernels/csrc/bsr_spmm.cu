// K2: block-sparse SpMM over uniformized VBR tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `bsr_spmm_pallas` in
// src/repro/kernels/bsr_spmm.py. Same function:
//   Y[r*tm : (r+1)*tm, :] = sum over tiles b of row tile r of
//                           tiles[b] @ X[col_ids[b]*tk : +tk, :]
// with a float32 accumulator and Y in X's dtype (float32 or bfloat16).
//
// What bounds it: operations. Each tile value meets n columns of X, so at
// n = 128 the multiply-adds outweigh the bytes; this first version runs them
// as plain float32 FMAs (tensor cores come later).
//
// Design. The TPU grid is (n/bn parallel, tiles in order), with the output
// block resident in VMEM across one row's tiles. Here one CTA owns one
// output block: BM rows of row tile r (all of them when tm <= 32) by BN
// columns. It walks the row's run row_ptr[r]:row_ptr[r+1] of the sorted tile
// table, and for each tile stages a (BM x 32) slice of the tile and the
// matching (32 x BN) slice of X in shared memory, in float32, and adds their
// product into a (BM x BN) float32 accumulator held in registers: each of the
// 8 warps owns BM/8 rows and each lane BN/32 columns. Rows past tm, depth
// past tk and columns past n are masked, and each output block is written
// once at the end, so a row tile without tiles is written as zeros.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 row groups x 32 column lanes
constexpr int kBK = 32;        // depth staged in shared memory per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// RM rows per warp (BM = 8 * RM), CN columns per lane (BN = 32 * CN).
template <typename T, int RM, int CN>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ tiles, const int* __restrict__ row_ptr,
                const int* __restrict__ col_ids, const T* __restrict__ x, T* __restrict__ y,
                int tm, int tk, int n, int m_blocks) {
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
    const T* tile = tiles + static_cast<size_t>(b) * tm * tk + static_cast<size_t>(m0) * tk;
    const T* xb = x + static_cast<size_t>(col_ids[b]) * tk * n + j0;
    for (int k0 = 0; k0 < tk; k0 += kBK) {
      const int kc = min(kBK, tk - k0);
      for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
        const int row = e / kBK;
        const int kk = e % kBK;
        As[kk][row] = (row < rows && kk < kc)
                          ? to_float(tile[static_cast<size_t>(row) * tk + k0 + kk])
                          : 0.f;
      }
      for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
        const int kk = e / BN;
        const int c = e % BN;
        Xs[kk][c] = (kk < kc && c < cols)
                        ? to_float(xb[static_cast<size_t>(k0 + kk) * n + c])
                        : 0.f;
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
    T* yrow = y + (static_cast<size_t>(rt) * tm + m0 + row) * n + j0;
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int c = tx + 32 * q;
      if (c < cols) store(yrow + c, acc[i][q]);
    }
  }
}

template <typename T, int RM, int CN>
void launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x, void* y,
            int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  const int m_blocks = (tm + 8 * RM - 1) / (8 * RM);
  const dim3 grid(n_row_tiles * m_blocks, (n + 32 * CN - 1) / (32 * CN));
  bsr_spmm_kernel<T, RM, CN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(tiles), row_ptr, col_ids, static_cast<const T*>(x),
      static_cast<T*>(y), tm, tk, n, m_blocks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T, int RM>
void launch_cn(int cn, const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
               void* y, int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  if (cn == 1)
    launch<T, RM, 1>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else if (cn == 2)
    launch<T, RM, 2>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else
    launch<T, RM, 4>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
}

template <typename T>
void launch_rm(int cn, const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
               void* y, int n_row_tiles, int tm, int tk, int n, cudaStream_t stream) {
  if (tm <= 8)
    launch_cn<T, 1>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else if (tm <= 16)
    launch_cn<T, 2>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else
    launch_cn<T, 4>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
}

}  // namespace

// tiles (nb, tm, tk), row_ptr (n_row_tiles + 1,), col_ids (nb,), x (k_pad, n),
// y (n_row_tiles * tm, n); all contiguous on one device, checked by the caller.
// bn, the column block, is 32, 64 or 128.
void bsr_spmm_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, int n_row_tiles, int tm, int tk, int n, int bn, bool bf16,
                     cudaStream_t stream) {
  if (n_row_tiles == 0 || n == 0) return;
  const int cn = bn / 32;
  if (bf16)
    launch_rm<__nv_bfloat16>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
  else
    launch_rm<float>(cn, tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, n, stream);
}
