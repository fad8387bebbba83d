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
// bfloat16 (runs.cuh). What bounds it: bytes, at the dropless MoE's shapes.
// There a slot is one capacity block of 8 token rows against one expert's
// (K x bn) weight block, so each weight value meets only the rows its expert
// received: at DeepSeek-V2's widths the stacked weight (2.5 GB in bfloat16)
// outweighs the multiply-adds. A CTA owns a fixed group of 64 / bm
// consecutive slots (8 at bm = 8; 64 rows of one slot when bm > 32) by 128
// columns, and runs each run of consecutive slots with one column block as
// one pass over that weight chunk. At the MoE's tables a run is one
// expert's capacity blocks, about 2.8 slots (22 rows) at prefill and 1.3 at
// decode; consecutive CTAs share the group's rows of a in L2.
//
// float32: as first ported, one CTA per (slot, up to 32 rows, up to 128
// columns), float32 FMAs from shared memory: per 32-deep step it stages the
// (BM x 32) slice of a (transposed) and the (32 x BN) slice of b as float32,
// and each of the 64 threads adds the outer product of the BM a values
// (broadcast float4 loads) and its CN columns of b into registers. Where the
// rows are aligned, the next step's slices are loaded into registers with
// 16-byte loads while the current one computes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

#include <cstdint>
#include <type_traits>

#include "runs.cuh"

namespace {

// ---------------------------------------------------------------- float32
constexpr int kThreads = 64;  // each thread owns CN columns of the chunk
constexpr int kBK = 32;       // depth staged in shared memory per step

// V consecutive floats: one 16-byte load where V == 4, else one element
// (V == 1). Loaded into registers, stored into shared memory a step later.
template <int V>
struct Pack {
  using Raw = typename std::conditional<V == 1, float, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const float* p) { raw = *reinterpret_cast<const Raw*>(p); }
  __device__ __forceinline__ void zero() { raw = Raw{}; }
  __device__ __forceinline__ float get(int i) const {
    return reinterpret_cast<const float*>(&raw)[i];
  }
};

// BM rows per CTA (8, 16 or 32), CN columns per thread (BN = 64 * CN), V
// elements per global load (16 bytes, or 1 where alignment does not allow).
template <int BM, int CN, int V>
__global__ void __launch_bounds__(kThreads)
bsr_sdd_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const int* __restrict__ rows, const int* __restrict__ cols,
               float* __restrict__ out, int bm, int bn, int K,
               int n_row_blocks, int64_t b_stride_k, int64_t b_stride_c, int m_blocks,
               int n_chunks) {
  constexpr int BN = kThreads * CN;
  constexpr int LDA = BM + 4;  // keeps float4 alignment, spreads the transposed stores
  constexpr int A_VECS = BM * kBK / V;  // loads of one (BM x 32) slice of a
  constexpr int A_LOADS = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_LOADS = kBK * BN / V / kThreads;  // loads of one (32 x BN) slice of b
  __shared__ __align__(16) float As[kBK][LDA];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int mb = rest % m_blocks;
  const int slot = rest / m_blocks;
  const int m0 = mb * BM;
  const int j0 = chunk * BN;
  const int rows_here = min(BM, bm - m0);
  const int cols_here = min(BN, bn - j0);
  float* ob = out + (static_cast<int64_t>(slot) * bm + m0) * bn + j0;
  if (rows[slot] >= n_row_blocks) {  // padding: a zero block, no reads
    for (int r = 0; r < rows_here; ++r)
      for (int c = threadIdx.x; c < cols_here; c += kThreads)
        ob[static_cast<int64_t>(r) * bn + c] = 0.f;
    return;
  }
  const float* ab = a + (static_cast<int64_t>(rows[slot]) * bm + m0) * K;
  const float* bb = b + static_cast<int64_t>(cols[slot]) * b_stride_c + j0;

  Pack<V> pa[A_LOADS], pb[B_LOADS];  // a step's slices on their way to shared memory
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int v = threadIdx.x + kThreads * i;
      const int r = v / (kBK / V);
      const int kk = (v % (kBK / V)) * V;
      if (v < A_VECS && r < rows_here && k0 + kk < K)
        pa[i].load(ab + static_cast<int64_t>(r) * K + k0 + kk);
      else
        pa[i].zero();
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int v = threadIdx.x + kThreads * i;
      const int kk = v / (BN / V);
      const int c = (v % (BN / V)) * V;
      if (k0 + kk < K && c < cols_here)
        pb[i].load(bb + static_cast<int64_t>(k0 + kk) * b_stride_k + c);
      else
        pb[i].zero();
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int v = threadIdx.x + kThreads * i;
      const int kk = (v % (kBK / V)) * V;
      if (v < A_VECS) {
#pragma unroll
        for (int e = 0; e < V; ++e) As[kk + e][v / (kBK / V)] = pa[i].get(e);
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int v = threadIdx.x + kThreads * i;
      const int kk = v / (BN / V);
      const int c = (v % (BN / V)) * V;
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(&Bs[kk][c + e]) =
              make_float4(pb[i].get(e), pb[i].get(e + 1), pb[i].get(e + 2), pb[i].get(e + 3));
      } else {
        Bs[kk][c] = pb[i].get(0);
      }
    }
  };

  float acc[BM][CN];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < CN; ++q) acc[r][q] = 0.f;

  // with 16-byte loads a step's slices take a few registers and are loaded
  // one step ahead; element by element they would take dozens, loaded in turn
  if constexpr (V > 1) load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    if constexpr (V == 1) load(k0);
    stage();
    __syncthreads();
    if constexpr (V > 1) {
      if (k0 + kBK < K) load(k0 + kBK);
    }
    const int kc = min(kBK, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float av[BM];
#pragma unroll
      for (int r = 0; r < BM; r += 4) {
        const float4 f = *reinterpret_cast<const float4*>(&As[kk][r]);
        av[r] = f.x;
        av[r + 1] = f.y;
        av[r + 2] = f.z;
        av[r + 3] = f.w;
      }
#pragma unroll
      for (int q = 0; q < CN; ++q) {
        const float bv = Bs[kk][threadIdx.x + kThreads * q];
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r][q] = fmaf(av[r], bv, acc[r][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int c = threadIdx.x + kThreads * q;
      if (r < rows_here && c < cols_here)
        ob[static_cast<int64_t>(r) * bn + c] = acc[r][q];
    }
  }
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

template <int BM, int CN, int V>
void launch(const Args& g) {
  const int m_blocks = (g.bm + BM - 1) / BM;
  const int n_chunks = (g.bn + kThreads * CN - 1) / (kThreads * CN);
  const int64_t n_ctas = static_cast<int64_t>(g.nnz) * m_blocks * n_chunks;
  bsr_sdd_kernel<BM, CN, V><<<static_cast<unsigned>(n_ctas), kThreads, 0, g.stream>>>(
      static_cast<const float*>(g.a), static_cast<const float*>(g.b), g.rows, g.cols,
      static_cast<float*>(g.out), g.bm, g.bn, g.K, g.n_row_blocks, g.b_stride_k, g.b_stride_c,
      m_blocks, n_chunks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// 16-byte loads need 16-byte aligned rows of a and b and whole vectors at the
// ragged edges: K, bn and b's strides multiples of the vector width.
template <int BM, int CN>
void launch_v(const Args& g) {
  constexpr int V = 4;
  const bool aligned = reinterpret_cast<uintptr_t>(g.a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g.b) % 16 == 0 && g.K % V == 0 &&
                       g.bn % V == 0 && g.b_stride_k % V == 0 && g.b_stride_c % V == 0;
  if (aligned)
    launch<BM, CN, V>(g);
  else
    launch<BM, CN, 1>(g);
}

template <int BM>
void launch_cn(const Args& g) {
  if (g.bn <= kThreads)
    launch_v<BM, 1>(g);
  else
    launch_v<BM, 2>(g);
}

// --------------------------------------------------------------- bfloat16
using runs::bf16;

// The passes of one group of slots: runs of consecutive slots with one
// column block. Padding slots are in no run, so their positions stay zero.
struct SddRuns {
  const bf16* a;
  const bf16* b;
  const int* rows;
  const int* cols;
  int bm, K, n_row_blocks;
  int64_t b_stride_c;
  int j0;
  int s0, m0, rows_here;  // the group's first slot and its first row in that slot
  int s, s_end;           // the next slot and the end of the group

  __device__ runs::Pass next() {
    runs::Pass p{{nullptr, nullptr}, nullptr, 0u};
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
template <bool VEC>
__global__ void __launch_bounds__(runs::kThreads)
bsr_sdd_runs_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const int* __restrict__ rows, const int* __restrict__ cols,
                    bf16* __restrict__ out, int nnz, int bm, int bn, int K, int n_row_blocks,
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
  SddRuns sched{a, b, rows, cols, bm, K, n_row_blocks, b_stride_c, j0, s0, m0, rows_here, s0, s1};
  runs::run_passes<VEC>(sched, K, b_stride_k, rows_here, cols_here,
                        out + (static_cast<int64_t>(s0) * bm + m0) * bn + j0, bn);
}

template <bool VEC>
void launch_runs(const Args& g) {
  const int group_slots = g.bm <= runs::kRows / 2 ? runs::kRows / g.bm : 1;
  const int m_blocks = group_slots > 1 ? 1 : (g.bm + runs::kRows - 1) / runs::kRows;
  const int n_chunks = (g.bn + runs::kBN - 1) / runs::kBN;
  const int64_t n_ctas =
      static_cast<int64_t>((g.nnz + group_slots - 1) / group_slots) * m_blocks * n_chunks;
  bsr_sdd_runs_kernel<VEC><<<static_cast<unsigned>(n_ctas), runs::kThreads, 0, g.stream>>>(
      static_cast<const bf16*>(g.a), static_cast<const bf16*>(g.b), g.rows, g.cols,
      static_cast<bf16*>(g.out), g.nnz, g.bm, g.bn, g.K, g.n_row_blocks, g.b_stride_k,
      g.b_stride_c, group_slots, m_blocks, n_chunks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

// a (M, K) contiguous; b read at b[k * b_stride_k + c * b_stride_c + j] for
// depth k, column block c and column j < bn; rows, cols (nnz,) int32, in
// bounds but for padding slots (rows >= n_row_blocks = M / bm); out (nnz, bm,
// bn) contiguous. Checked by the caller; the CTA count
// nnz * ceil(bm / BM) * ceil(bn / 128) must stay below 2^31.
void bsr_sdd_launch(const void* a, const void* b, const int* rows, const int* cols, void* out,
                    int nnz, int bm, int bn, int K, int n_row_blocks, int64_t b_stride_k,
                    int64_t b_stride_c, bool is_bf16, cudaStream_t stream) {
  if (nnz == 0 || bm == 0 || bn == 0) return;
  const Args g{a, b, rows, cols, out, nnz, bm, bn, K, n_row_blocks, b_stride_k, b_stride_c,
               stream};
  if (is_bf16) {
    // 16-byte loads and stores need 16-byte aligned rows of a, b and out
    const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 && K % 8 == 0 && bn % 8 == 0 &&
                     b_stride_k % 8 == 0 && b_stride_c % 8 == 0;
    if (vec)
      launch_runs<true>(g);
    else
      launch_runs<false>(g);
    return;
  }
  if (bm <= 8)
    launch_cn<8>(g);
  else if (bm <= 16)
    launch_cn<16>(g);
  else
    launch_cn<32>(g);
}
