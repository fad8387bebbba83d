// K1: block-sparse SpMV over uniformized VBR tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `bsr_spmv_pallas` in
// src/repro/kernels/bsr_spmv.py. Same function:
//   y[r*tm : (r+1)*tm] = sum over tiles b of row tile r of tiles[b] @ x[col_ids[b]*tk : +tk]
// with a float32 accumulator and y in x's dtype (float32 or bfloat16).
//
// What bounds it: bytes. Every tile value is read once and used in one
// multiply-add, so the kernel streams `tiles` from device memory; x is small
// and stays in L1/L2.
//
// Design. The TPU kernel walks tiles in order on one core and zeroes a row
// tile on its first visit. Here one CTA owns one output row tile r and walks
// its run row_ptr[r]:row_ptr[r+1] of the sorted tile table, so each row tile
// is written exactly once, with no atomics, and a row tile without tiles is
// written as zeros. Inside the CTA a group of `gw` lanes (a power of two up to
// a warp) owns one tile row: its lanes load 16-byte vectors of the tile row
// and of the x slice, keep a float32 partial sum across all the row's tiles,
// and reduce it once at the end with warp shuffles. Consecutive groups own
// consecutive tile rows, so a warp reads one contiguous stretch of the tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Dot product of V consecutive elements; V > 1 means one 16-byte load each.
template <typename T, int V>
__device__ __forceinline__ float dot_vec(const T* a, const T* b) {
  if constexpr (V == 1) {
    return to_float(a[0]) * to_float(b[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 ra = *reinterpret_cast<const uint4*>(a);
    const uint4 rb = __ldg(reinterpret_cast<const uint4*>(b));
    const T* ea = reinterpret_cast<const T*>(&ra);
    const T* eb = reinterpret_cast<const T*>(&rb);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) s = fmaf(to_float(ea[v]), to_float(eb[v]), s);
    return s;
  }
}

template <typename T, int V>
__global__ void bsr_spmv_kernel(const T* __restrict__ tiles, const int* __restrict__ row_ptr,
                                const int* __restrict__ col_ids, const T* __restrict__ x,
                                T* __restrict__ y, int tm, int tk, int gw) {
  const int r = blockIdx.x;
  const int sub = threadIdx.x & (gw - 1);  // lane within the row group
  const int group = threadIdx.x / gw;
  const int n_groups = blockDim.x / gw;
  const int b0 = row_ptr[r];
  const int b1 = row_ptr[r + 1];
  const int nvec = tk / V;
  const size_t tile_elems = static_cast<size_t>(tm) * tk;
  // Every thread runs the same number of passes, so the shuffles below are
  // reached by whole warps.
  for (int i0 = 0; i0 < tm; i0 += n_groups) {
    const int i = i0 + group;
    float acc = 0.f;
    if (i < tm) {
#pragma unroll 4
      for (int b = b0; b < b1; ++b) {
        const T* trow = tiles + b * tile_elems + static_cast<size_t>(i) * tk;
        const T* xs = x + static_cast<size_t>(col_ids[b]) * tk;
        for (int v = sub; v < nvec; v += gw) acc += dot_vec<T, V>(trow + v * V, xs + v * V);
      }
    }
    for (int off = gw >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (i < tm && sub == 0) store(y + static_cast<size_t>(r) * tm + i, acc);
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T, int V>
void launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x, void* y,
            int n_row_tiles, int tm, int tk, cudaStream_t stream) {
  const int gw = pow2_ceil(tk / V) < 32 ? pow2_ceil(tk / V) : 32;
  int threads = pow2_ceil(tm) * gw;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  bsr_spmv_kernel<T, V><<<n_row_tiles, threads, 0, stream>>>(
      static_cast<const T*>(tiles), row_ptr, col_ids, static_cast<const T*>(x),
      static_cast<T*>(y), tm, tk, gw);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// tiles (nb, tm, tk), row_ptr (n_row_tiles + 1,), col_ids (nb,), x (k_pad,),
// y (n_row_tiles * tm,); all contiguous on one device, checked by the caller.
void bsr_spmv_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, int n_row_tiles, int tm, int tk, bool bf16, cudaStream_t stream) {
  if (n_row_tiles == 0) return;
  const bool vec_ok = aligned16(tiles) && aligned16(x);
  if (bf16) {
    if (vec_ok && tk % 8 == 0)
      launch<__nv_bfloat16, 8>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, stream);
    else
      launch<__nv_bfloat16, 1>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, stream);
  } else {
    if (vec_ok && tk % 4 == 0)
      launch<float, 4>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, stream);
    else
      launch<float, 1>(tiles, row_ptr, col_ids, x, y, n_row_tiles, tm, tk, stream);
  }
}
