// The CTA body that K2 (bsr_spmm.cu, bfloat16) and K3 (bsr_sdd.cu, bfloat16
// and float32) share: products of a few activation rows against a weight
// chunk, where consecutive table entries with the same column block share
// that chunk.
//
// A CTA owns 64 output rows ("positions", in 8 groups of 8) by a chunk of
// kBN = 128 weight columns, and a float32 accumulator for all of them. The
// kernel walks its part of the table as a sequence of passes: a pass is a run
// of consecutive entries that share one column block (and so one weight
// chunk W, depth x 128) and cover distinct positions. One pass multiplies W
// once against all the run's activation rows A (depth-long rows, zero at the
// positions the run does not cover) and adds the product into the
// accumulator, on the groups of 8 positions that the run covers only. Every
// position is owned by this CTA alone and written once at the end, so no
// atomics are needed, and positions no run covers come out as zeros.
//
// The schedule is a class with one method, `next()`, that returns the next
// pass (its activation rows for this thread, its W chunk and its group mask;
// mask 0 once the table part is exhausted). Each kernel computes it from the
// tables it receives, on the device: every thread runs the same scan.
//
// What bounds both kernels at the dropless MoE's shapes: bytes (the weight
// chunks, and K2's mostly-zero output), not operations. So the design keeps
// copies in flight (a ring of kStages shared-memory stages filled by 16-byte
// cp.async) and multiplies each chunk against a whole run at once. The
// products run on the tensor cores as mma.sync with the roles swapped
// (out^T = W^T A^T), so that the run's 8-row groups fill the instruction's
// 8-wide side and only the groups a run covers are multiplied. wgmma is not
// used: it multiplies 64-row operands, and a run here is 8-24 rows, so most
// of each instruction would multiply padding, for a rate of operations that
// is not the limit.
//
// float32 keeps float32's accuracy on the tensor cores by 3xTF32: each operand
// x is split into hi = tf32(x) and lo = x - hi, read as TF32 (TF32 keeps 11 of
// float32's 24 significant bits, so hi + lo holds about 22 of them), and lo*hi
// + hi*lo, then hi*hi, are accumulated by mma.m16n8k8.tf32 (the dropped lo*lo
// is below float32's rounding). The tensor cores' accumulator truncates, so it
// restarts at every step, added into a float32 accumulator rounded to nearest.
// One TF32 product alone misses the 1e-5 tolerance at K = 5120, and so does
// one tensor-core accumulator over all of K. Three TF32 products for each
// float32 one, at the card's 494.7 TFLOP/s TF32 rate, make 165 TFLOP/s of
// float32 work, 2.5x the FMA pipes' 67: at the MoE's tables that puts the
// operations (1.37 ms at prefill) below the bytes (1.62 ms) again. A step is
// 32 bytes of depth in both types (32 bfloat16, 16 float32 values), so a stage
// holds the same 13.5 KB and three of them fit the 48 KB of static shared
// memory. The ring keeps raw float32; the split happens as the fragments are
// loaded (each warp splits the activation rows it shares with the other three
// itself).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace runs {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // positions of a CTA, 8 groups of 8
constexpr int kBN = 128;       // weight columns of a CTA
constexpr int kStages = 3;     // ring of shared-memory stages: 2 steps in flight

// The ring's layout for one element type: the depth of a step (32 bytes of
// each row) and the padded row lengths, which keep the fragment loads free
// of bank conflicts and every row 16-byte aligned.
template <class T>
struct Shape;
template <>
struct Shape<bf16> {
  static constexpr int kBK = 32;
  static constexpr int kLdA = kBK + 8;  // padded rows: 8 rows of a column of 16-byte
  static constexpr int kLdW = kBN + 8;  // chunks fall in 8 different bank groups
  static constexpr int kLdC = kBN + 8;
};
template <>
struct Shape<float> {
  static constexpr int kBK = 16;
  static constexpr int kLdA = kBK + 4;  // rows 80 bytes apart: ldmatrix's 8 rows in 8 bank groups
  static constexpr int kLdW = kBN + 8;  // rows k and k + 1 of a 16-byte fragment load 8 banks apart
  static constexpr int kLdC = kBN + 4;
};

// One pass: this thread's two activation rows (positions tid / 4 and
// tid / 4 + 32; nullptr where the run does not cover it), at depth 0, the
// weight chunk at depth 0 and the CTA's first column, and the groups of 8
// positions the run covers (bit g for positions 8g..8g+7; 0: no pass).
template <class T>
struct Pass {
  const T* a[2];
  const T* w;
  unsigned mask;
};

// The positions a thread loads activation rows for.
__device__ __forceinline__ int my_position(int j) { return (threadIdx.x >> 2) + 32 * j; }

// Bits of the groups of 8 positions that [lo, hi) touches (lo < hi).
__device__ __forceinline__ unsigned group_bits(int lo, int hi) {
  return (2u << ((hi - 1) >> 3)) - (1u << (lo >> 3));
}

// Adds a unit of `unit_rows` rows whose first row sits at position `lo`
// (may be negative: the CTA starts inside the unit) to a pass: its group
// bits, and for each of this thread's positions that it covers, the
// activation row `unit_a` + (row within the unit) * depth.
template <class T>
__device__ __forceinline__ void add_unit(Pass<T>& p, int lo, int unit_rows, int rows_here,
                                         const T* unit_a, int depth) {
  const int hi = min(lo + unit_rows, rows_here);
  p.mask |= group_bits(max(lo, 0), hi);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = my_position(j);
    if (q >= lo && q < hi) p.a[j] = unit_a + static_cast<int64_t>(q - lo) * depth;
  }
}

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (then nothing is read, but src must still be a global address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit values (8 x 4 of 32-bit ones) from shared
// memory; lanes 8j..8j+7 give the row addresses of matrix j, which lands in
// r[j]: lane l gets the 32 bits at row l / 4, word l % 4. TRANS: each matrix
// transposed (16-bit values only).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d (16 x 8, float32) += a (16 x 16, bfloat16, row-major) @ b (16 x 8, bfloat16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, float32) += a (16 x 8, tf32, row-major) @ b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + (below float32's rounding). hi is cvt.rna.tf32.f32(x),
// rounded to nearest with ties away from zero, computed as half a TF32 ulp
// added to the bits and the 13 bits below cut: the same bits for every
// finite x and for inf, in two integer operations, where cvt.rna compiles to
// a test for finite values and a select besides. lo = x - hi is exact, and
// goes to the tensor cores as it is: they read its top 19 bits (a TF32 cut
// toward zero, which costs nothing measurable against cvt.rna's rounding).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <class T>
struct Smem {
  using S = Shape<T>;
  union {
    struct {
      T a[kStages][kRows][S::kLdA];
      T w[kStages][S::kBK][S::kLdW];
    } ring;
    T c[kRows][S::kLdC];  // the output tile, after the last step
  };
  unsigned mask[kStages];  // the group mask of the step in each stage
};

// Loads one step (depth k0..k0+kBK) of pass p into stage s: this thread's
// 2 x 16 bytes of A and 4 x 16 of W. VEC: 16-byte asynchronous copies
// (depth, ldw and the column count whole 16-byte vectors and the operands
// 16-byte aligned), else one element at a time, synchronously. Out of
// range: zeros.
template <bool VEC, class T>
__device__ __forceinline__ void load_step(Smem<T>& sm, int s, const Pass<T>& p, int k0,
                                          int depth, int64_t ldw, int cols_here) {
  constexpr int kBK = Shape<T>::kBK;
  constexpr int kV = 16 / sizeof(T);  // values of one 16-byte copy
  const T zero = from_float<T>(0.f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kc = (threadIdx.x & 3) * kV;
    T* dst = &sm.ring.a[s][my_position(j)][kc];
    const T* src = p.a[j] + k0 + kc;
    if (VEC) {
      const bool ok = p.a[j] != nullptr && k0 + kc < depth;
      cp_async16(dst, ok ? src : p.w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e)
        dst[e] = (p.a[j] != nullptr && k0 + kc + e < depth) ? src[e] : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / kV / kThreads; ++i) {
    const int q = threadIdx.x + kThreads * i;
    const int kr = q / (kBN / kV);
    const int c = (q % (kBN / kV)) * kV;
    T* dst = &sm.ring.w[s][kr][c];
    const T* src = p.w + static_cast<int64_t>(k0 + kr) * ldw + c;
    const bool row_ok = k0 + kr < depth;
    if (VEC) {
      const bool ok = row_ok && c < cols_here;
      cp_async16(dst, ok ? src : p.w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) dst[e] = (row_ok && c + e < cols_here) ? src[e] : zero;
    }
  }
  if (threadIdx.x == 0) sm.mask[s] = p.mask;
}

// The products on tensor cores, with the roles swapped so that the few
// activation rows fill the 8-wide side: out^T (columns x positions) =
// W^T @ A^T. Warp w owns the 32 weight columns 32w..32w+31 (two 16-row m
// tiles) against all 8 groups of positions (n tiles of 8), and multiplies a
// group only where the step's mask has it.
template <class T>
struct MmaTile;

// bfloat16: mma.sync.m16n8k16. W^T comes from the [k][column] ring by
// ldmatrix.trans, A^T from the [position][k] ring by ldmatrix.
template <>
struct MmaTile<bf16> {
  float acc[2][8][4];  // [m tile][group][fragment]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][g][i] = 0.f;
  }

  __device__ __forceinline__ void step(const Smem<bf16>& sm, int s, unsigned mask) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned wf[2][2][4];  // [k half][m tile]: W^T fragments of this step
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4<true>(wf[kh][mt], &sm.ring.w[s][kh * 16 + (lane >> 4) * 8 + (lane & 7)]
                                                [warp * 32 + mt * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if (!((mask >> g) & 1u)) continue;
      unsigned af[4];  // A^T of group g: depth 0-7, 8-15, 16-23, 24-31
      ldmatrix_x4<false>(af, &sm.ring.a[s][g * 8 + (lane & 7)][(lane >> 3) * 8]);
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][g], wf[kh][mt], af[2 * kh], af[2 * kh + 1]);
    }
  }

  __device__ __forceinline__ void store(Smem<bf16>& sm) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int col = warp * 32 + mt * 16 + (lane >> 2);
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int pos = g * 8 + (lane & 3) * 2;
        sm.c[pos][col] = __float2bfloat16(acc[mt][g][0]);
        sm.c[pos + 1][col] = __float2bfloat16(acc[mt][g][1]);
        sm.c[pos][col + 8] = __float2bfloat16(acc[mt][g][2]);
        sm.c[pos + 1][col + 8] = __float2bfloat16(acc[mt][g][3]);
      }
    }
  }
};

// float32: 3xTF32 on mma.sync.m16n8k8. The m tiles' rows are the warp's
// columns interleaved: row r of m tile mt is column 32w + 4 (r % 8) + 2 mt +
// r / 8, so that one 16-byte load of a ring row gives a lane its W^T values
// of both m tiles at one depth (ldmatrix.trans has no 32-bit form). A^T
// comes from the [position][k] ring by ldmatrix, whose 8 x 4 32-bit layout
// is the tf32 B fragment's. The tensor cores add each product into their
// accumulator rounded toward zero, a bias that grows with the depth (3.4e-5
// of max|out| at K = 5120 on the card, past float32's 1e-5): so each step's
// 6 products start from zero and are added into the float32 accumulator
// rounded to nearest.
template <>
struct MmaTile<float> {
  float acc[2][8][4];  // [m tile][group][fragment]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][g][i] = 0.f;
  }

  __device__ __forceinline__ void step(const Smem<float>& sm, int s, unsigned mask) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned wh[2][2][4], wl[2][2][4];  // [k half][m tile]: W^T fragments, hi and lo
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // depth lane % 4, then lane % 4 + 4, of the half
        const float4 v = *reinterpret_cast<const float4*>(
            &sm.ring.w[s][kh * 8 + r * 4 + (lane & 3)][warp * 32 + (lane >> 2) * 4]);
        split_tf32(v.x, wh[kh][0][2 * r], wl[kh][0][2 * r]);
        split_tf32(v.y, wh[kh][0][2 * r + 1], wl[kh][0][2 * r + 1]);
        split_tf32(v.z, wh[kh][1][2 * r], wl[kh][1][2 * r]);
        split_tf32(v.w, wh[kh][1][2 * r + 1], wl[kh][1][2 * r + 1]);
      }
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if (!((mask >> g) & 1u)) continue;
      unsigned af[4], ah[4], al[4];  // A^T of group g: b0, b1 of depth 0-7, then of 8-15
      ldmatrix_x4<false>(af, &sm.ring.a[s][g * 8 + (lane & 7)][(lane >> 3) * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(af[i]), ah[i], al[i]);
      float d[2][4] = {};  // this step's products: the tensor cores' own accumulator
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wl[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wh[kh][mt], al[2 * kh], al[2 * kh + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(d[mt], wh[kh][mt], ah[2 * kh], ah[2 * kh + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][g][i] += d[mt][i];
    }
  }

  __device__ __forceinline__ void store(Smem<float>& sm) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int col = warp * 32 + (lane >> 2) * 4 + mt * 2;  // fragments 0, 1; 2, 3 at col + 1
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int pos = g * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(&sm.c[pos][col]) = make_float2(acc[mt][g][0], acc[mt][g][2]);
        *reinterpret_cast<float2*>(&sm.c[pos + 1][col]) = make_float2(acc[mt][g][1], acc[mt][g][3]);
      }
    }
  }
};

// Writes rows [0, rows_here) x columns [0, cols_here) of the tile to `out`
// (row stride ld): from shared memory, or zeros.
template <bool VEC, bool ZERO, class T>
__device__ __forceinline__ void write_tile(const Smem<T>* sm, T* out, int64_t ld, int rows_here,
                                           int cols_here) {
  constexpr int kV = 16 / sizeof(T);
  for (int q = threadIdx.x; q < kRows * (kBN / kV); q += kThreads) {
    const int r = q / (kBN / kV);
    const int c = (q % (kBN / kV)) * kV;
    if (r >= rows_here || c >= cols_here) continue;
    T* dst = out + static_cast<int64_t>(r) * ld + c;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) =
          ZERO ? uint4{0, 0, 0, 0} : *reinterpret_cast<const uint4*>(&sm->c[r][c]);
    } else {
      for (int e = 0; e < kV && c + e < cols_here; ++e)
        dst[e] = ZERO ? from_float<T>(0.f) : sm->c[r][c + e];
    }
  }
}

// The CTA body: walks the schedule's passes in steps of kBK, with the
// copies of the next kStages - 1 steps in flight while one step multiplies,
// then writes the tile to `out` (the CTA's first position and column, row
// stride ld).
template <bool VEC, class Sched, class T>
__device__ __forceinline__ void run_passes(Sched& sched, int depth, int64_t ldw, int rows_here,
                                           int cols_here, T* out, int64_t ld) {
  constexpr int kBK = Shape<T>::kBK;
  __shared__ __align__(16) Smem<T> sm;
  MmaTile<T> tile;
  tile.zero();
  Pass<T> p = sched.next();
  int k0 = 0;
  auto prefetch = [&](int s) {
    if (p.mask == 0) {
      if (threadIdx.x == 0) sm.mask[s] = 0;
      return;
    }
    load_step<VEC>(sm, s, p, k0, depth, ldw, cols_here);
    k0 += kBK;
    if (k0 >= depth) {
      k0 = 0;
      p = sched.next();
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    prefetch(s);
    cp_async_commit();
  }
  for (int t = 0;; ++t) {
    cp_async_wait<kStages - 2>();  // step t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; stage t - 1 is free
    const unsigned mask = sm.mask[t % kStages];
    if (mask == 0) break;
    prefetch((t + kStages - 1) % kStages);
    cp_async_commit();
    tile.step(sm, t % kStages, mask);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: its memory takes the output tile
  tile.store(sm);
  __syncthreads();
  write_tile<VEC, false>(&sm, out, ld, rows_here, cols_here);
}

}  // namespace runs
