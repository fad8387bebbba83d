// K3: sampled dense-dense product (sdd) at a block topology, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sdd_kernel` / `_sdd_pallas` in
// src/repro/kernels/bsr_ops.py. Same function:
//   out[i] (bm x bn) = a[rows[i]*bm : +bm, :] @ b[:, cols[i]*bn : +bn]
// for every slot i, with a float32 accumulator and out in a's dtype (float32
// or bfloat16). A slot whose row block lies past the end of a (rows[i] >=
// M / bm) is padding: its block is written as zeros, and neither a nor b is
// read for it. (The reference clamps the padding slots' coordinates, computes
// their blocks and zeroes them afterwards in `_sdd_impl`.)
//
// The TPU grid is (nnz, K/bk) with the output block resident across the K
// steps and zeroed at k == 0. On the card each CTA loops over all of K
// itself: nothing carries across CTAs, no atomics, and each output element
// is written once. b is read through strides (K, column block, column), so a
// stack of per-expert weights (E, K, bn) is read in place as the stacked
// (K, E*bn) matrix.
//
// Both dtypes run the body of runs.cuh: bfloat16 products on mma.sync
// m16n8k16, float32 ones as 3xTF32 on mma.sync m16n8k8. What bounds it:
// bytes, at the dropless MoE's shapes. There a slot is one capacity block of
// 8 token rows against one expert's (K x bn) weight block, so each weight
// value meets only the rows its expert received: at DeepSeek-V2's widths the
// stacked weight (2.5 GB in bfloat16, 5 GB in float32) outweighs the
// multiply-adds, once float32 runs on the tensor cores (165 TFLOP/s of
// float32 work by 3xTF32, against 67 on the FMA pipes, where the first float32
// port was bound by operations). A CTA owns a fixed group of 64 / bm
// consecutive slots (8 at bm = 8; 64 rows of one slot when bm > 32) by 128
// columns, and runs each run of consecutive slots with one column block as
// one pass over that weight chunk, so a chunk is read once a run and not once
// a slot. At the MoE's tables a run is one expert's capacity blocks, about
// 2.8 slots (22 rows) at prefill and 1.3 at decode; consecutive CTAs share
// the group's rows of a in L2. What the design cannot change: the table
// gives an expert one run in each group of tokens (4 at prefill), so its
// chunk comes from device memory about that many times.
//
// Two bodies, picked by the caller (`ops.sdd_body`): VEC copies 16 bytes at a
// time by cp.async into the shared-memory ring; the scalar body copies one
// element at a time, synchronously, for operands that are not 16-byte
// aligned or whose K, bn or strides are not whole 16-byte vectors.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

#include <cstdint>

#include "runs.cuh"

namespace {

using runs::bf16;

// The passes of one group of slots: runs of consecutive slots with one
// column block. Padding slots are in no run, so their positions stay zero.
template <class T>
struct SddRuns {
  const T* a;
  const T* b;
  const int* rows;
  const int* cols;
  int bm, K, n_row_blocks;
  int64_t b_stride_c;
  int j0;
  int s0, m0, rows_here;  // the group's first slot and its first row in that slot
  int s, s_end;           // the next slot and the end of the group

  __device__ runs::Pass<T> next() {
    runs::Pass<T> p{{nullptr, nullptr}, nullptr, 0u};
    while (s < s_end && rows[s] >= n_row_blocks) ++s;
    if (s >= s_end) return p;
    const int c = cols[s];
    p.w = b + c * b_stride_c + j0;
    for (; s < s_end && rows[s] < n_row_blocks && cols[s] == c; ++s)
      runs::add_unit(p, (s - s0) * bm - m0, bm, rows_here,
                     a + static_cast<int64_t>(rows[s]) * bm * K, K);
    return p;
  }
};

// One CTA per (group of `group_slots` slots, block of 64 rows within a slot
// when bm > 32, 128 columns); the column chunk varies fastest.
template <bool VEC, class T>
__global__ void __launch_bounds__(runs::kThreads)
bsr_sdd_runs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const int* __restrict__ rows, const int* __restrict__ cols,
                    T* __restrict__ out, int nnz, int bm, int bn, int K, int n_row_blocks,
                    int64_t b_stride_k, int64_t b_stride_c, int group_slots, int m_blocks,
                    int n_chunks) {
  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int m0 = (rest % m_blocks) * runs::kRows;
  const int s0 = rest / m_blocks * group_slots;
  const int s1 = min(s0 + group_slots, nnz);
  const int rows_here = min(runs::kRows, (s1 - s0) * bm - m0);
  const int j0 = chunk * runs::kBN;
  const int cols_here = min(runs::kBN, bn - j0);
  SddRuns<T> sched{a, b, rows, cols, bm, K, n_row_blocks, b_stride_c, j0, s0, m0, rows_here,
                   s0, s1};
  runs::run_passes<VEC>(sched, K, b_stride_k, rows_here, cols_here,
                        out + (static_cast<int64_t>(s0) * bm + m0) * bn + j0, bn);
}

struct Args {
  const void* a;
  const void* b;
  const int* rows;
  const int* cols;
  void* out;
  int nnz, bm, bn, K, n_row_blocks;
  int64_t b_stride_k, b_stride_c;
  cudaStream_t stream;
};

template <bool VEC, class T>
void launch_runs(const Args& g) {
  const int group_slots = g.bm <= runs::kRows / 2 ? runs::kRows / g.bm : 1;
  const int m_blocks = group_slots > 1 ? 1 : (g.bm + runs::kRows - 1) / runs::kRows;
  const int n_chunks = (g.bn + runs::kBN - 1) / runs::kBN;
  const int64_t n_ctas =
      static_cast<int64_t>((g.nnz + group_slots - 1) / group_slots) * m_blocks * n_chunks;
  bsr_sdd_runs_kernel<VEC, T><<<static_cast<unsigned>(n_ctas), runs::kThreads, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.rows, g.cols,
      static_cast<T*>(g.out), g.nnz, g.bm, g.bn, g.K, g.n_row_blocks, g.b_stride_k,
      g.b_stride_c, group_slots, m_blocks, n_chunks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// a (M, K) contiguous; b read at b[k * b_stride_k + c * b_stride_c + j] for
// depth k, column block c and column j < bn; rows, cols (nnz,) int32, in
// bounds but for padding slots (rows >= n_row_blocks = M / bm); out (nnz, bm,
// bn) contiguous. vec: the cp.async body, for 16-byte aligned a, b and out
// whose K, bn and b strides are whole 16-byte vectors. Checked by the caller;
// the CTA count nnz * ceil(bm / 32) * ceil(bn / 128) must stay below 2^31.
void bsr_sdd_launch(const void* a, const void* b, const int* rows, const int* cols, void* out,
                    int nnz, int bm, int bn, int K, int n_row_blocks, int64_t b_stride_k,
                    int64_t b_stride_c, bool is_bf16, bool vec, cudaStream_t stream) {
  if (nnz == 0 || bm == 0 || bn == 0) return;
  const Args g{a, b, rows, cols, out, nnz, bm, bn, K, n_row_blocks, b_stride_k, b_stride_c,
               stream};
  if (is_bf16 && vec)
    launch_runs<true, bf16>(g);
  else if (is_bf16)
    launch_runs<false, bf16>(g);
  else if (vec)
    launch_runs<true, float>(g);
  else
    launch_runs<false, float>(g);
}
