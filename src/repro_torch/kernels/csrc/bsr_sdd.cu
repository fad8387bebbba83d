// K3: sampled dense-dense product (sdd) at a block topology, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sdd_kernel` / `_sdd_pallas` in
// src/repro/kernels/bsr_ops.py. Same function:
//   out[i] (bm x bn) = a[rows[i]*bm : +bm, :] @ b[:, cols[i]*bn : +bn]
// for every slot i, with a float32 accumulator and out in a's dtype (float32
// or bfloat16). Coordinates arrive clamped in bounds; the caller zeroes the
// padding slots afterwards, as the reference's `_sdd_impl` does.
//
// What bounds it: bytes, at the dropless MoE's shapes. There a slot is one
// capacity block of 8 token rows against one expert's (K x bn) weight block,
// so each weight value meets only the 8-24 rows its expert received: at
// DeepSeek-V2's widths the stacked weight (2.5 GB in bfloat16) outweighs the
// multiply-adds on tensor cores. This version runs the multiply-adds as
// float32 FMAs, and each weight value it brings in from L2 meets only the
// bm = 8 rows of its slot, so on the card it is bound by those loads and
// FMAs instead (tensor cores, and several slots of one expert per CTA,
// come later).
//
// Design. The TPU grid is (nnz, K/bk) with the output block resident across
// the K steps and zeroed at k == 0. Here one CTA owns one output slot, one
// block of up to BM of its bm rows and a chunk of up to BN = 128 of its bn
// columns, and loops over all of K itself: nothing carries across CTAs, no
// atomics, and each output element is written once. Per 32-deep step it
// stages the (BM x 32) slice of a (transposed) and the (32 x BN) slice of b
// in shared memory as float32; each of the 64 threads then adds the outer
// product of the BM a values of a step (broadcast float4 loads) and its CN
// columns of b into a (BM x CN) float32 register accumulator. Where the
// rows are aligned, the next step's slices are loaded into registers with
// 16-byte loads while the current one computes. Rows past bm, depth past K
// and columns past bn are masked, so any bm, bn, K >= 1 work. b is read
// through strides (K, column block, column), so a stack of per-expert
// weights (E, K, bn) is read in place as the stacked (K, E*bn) matrix. CTAs
// are numbered slot-major (slot, row block, column chunk): the slots of one
// expert within a group are adjacent, so consecutive CTAs reuse that
// expert's weight block from L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <c10/cuda/CUDAException.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;  // each thread owns CN columns of the chunk
constexpr int kBK = 32;       // depth staged in shared memory per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// V consecutive elements of T: one 16-byte load where V * sizeof(T) == 16,
// else one element (V == 1). Loaded into registers, converted to float at
// the store into shared memory.
template <typename T, int V>
struct Pack {
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) { raw = *reinterpret_cast<const Raw*>(p); }
  __device__ __forceinline__ void zero() { raw = Raw{}; }
  __device__ __forceinline__ float get(int i) const {
    return to_float(reinterpret_cast<const T*>(&raw)[i]);
  }
};

// BM rows per CTA (8, 16 or 32), CN columns per thread (BN = 64 * CN), V
// elements per global load (16 bytes, or 1 where alignment does not allow).
template <typename T, int BM, int CN, int V>
__global__ void __launch_bounds__(kThreads)
bsr_sdd_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ rows,
               const int* __restrict__ cols, T* __restrict__ out, int bm, int bn, int K,
               int64_t b_stride_k, int64_t b_stride_c, int m_blocks, int n_chunks) {
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
  const T* ab = a + (static_cast<int64_t>(rows[slot]) * bm + m0) * K;
  const T* bb = b + static_cast<int64_t>(cols[slot]) * b_stride_c + j0;

  Pack<T, V> pa[A_LOADS], pb[B_LOADS];  // a step's slices on their way to shared memory
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

  T* ob = out + (static_cast<int64_t>(slot) * bm + m0) * bn + j0;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int c = threadIdx.x + kThreads * q;
      if (r < rows_here && c < cols_here)
        store(ob + static_cast<int64_t>(r) * bn + c, acc[r][q]);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  const int* rows;
  const int* cols;
  void* out;
  int nnz, bm, bn, K;
  int64_t b_stride_k, b_stride_c;
  cudaStream_t stream;
};

template <typename T, int BM, int CN, int V>
void launch(const Args& g) {
  const int m_blocks = (g.bm + BM - 1) / BM;
  const int n_chunks = (g.bn + kThreads * CN - 1) / (kThreads * CN);
  const int64_t n_ctas = static_cast<int64_t>(g.nnz) * m_blocks * n_chunks;
  bsr_sdd_kernel<T, BM, CN, V><<<static_cast<unsigned>(n_ctas), kThreads, 0, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b), g.rows, g.cols,
      static_cast<T*>(g.out), g.bm, g.bn, g.K, g.b_stride_k, g.b_stride_c, m_blocks, n_chunks);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// 16-byte loads need 16-byte aligned rows of a and b and whole vectors at the
// ragged edges: K, bn and b's strides multiples of the vector width.
template <typename T, int BM, int CN>
void launch_v(const Args& g) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(g.a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g.b) % 16 == 0 && g.K % V == 0 &&
                       g.bn % V == 0 && g.b_stride_k % V == 0 && g.b_stride_c % V == 0;
  if (aligned)
    launch<T, BM, CN, V>(g);
  else
    launch<T, BM, CN, 1>(g);
}

template <typename T, int BM>
void launch_cn(const Args& g) {
  if (g.bn <= kThreads)
    launch_v<T, BM, 1>(g);
  else
    launch_v<T, BM, 2>(g);
}

template <typename T>
void launch_bm(const Args& g) {
  if (g.bm <= 8)
    launch_cn<T, 8>(g);
  else if (g.bm <= 16)
    launch_cn<T, 16>(g);
  else
    launch_cn<T, 32>(g);
}

}  // namespace

// a (M, K) contiguous; b read at b[k * b_stride_k + c * b_stride_c + j] for
// depth k, column block c and column j < bn; rows, cols (nnz,) int32 in
// bounds; out (nnz, bm, bn) contiguous. Checked by the caller; the CTA count
// nnz * ceil(bm / BM) * ceil(bn / 128) must stay below 2^31.
void bsr_sdd_launch(const void* a, const void* b, const int* rows, const int* cols, void* out,
                    int nnz, int bm, int bn, int K, int64_t b_stride_k, int64_t b_stride_c,
                    bool bf16, cudaStream_t stream) {
  if (nnz == 0 || bm == 0 || bn == 0) return;
  const Args g{a, b, rows, cols, out, nnz, bm, bn, K, b_stride_k, b_stride_c, stream};
  if (bf16)
    launch_bm<__nv_bfloat16>(g);
  else
    launch_bm<float>(g);
}
