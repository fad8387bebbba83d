// Python binding of the block-sparse kernels. The only source that includes
// torch/extension.h: the kernels' own files include only CUDA and c10
// headers, so they build in seconds.
#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

void bsr_spmv_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, const int* schedule, int n_workers, float* partial, int tm, int tk,
                     bool bf16, cudaStream_t stream);
void bsr_spmm_launch(const void* tiles, const int* row_ptr, const int* col_ids, const void* x,
                     void* y, const int* schedule, int n_workers, float* partial,
                     int n_row_tiles, int tm, int tk, int n, bool bf16, cudaStream_t stream);
int bsr_spmv_workers(int tm, int tk, bool bf16);
int bsr_spmm_workers(int tm, int n);
void bsr_sdd_launch(const void* a, const void* b, const int* rows, const int* cols, void* out,
                    int nnz, int bm, int bn, int K, int n_row_blocks, int64_t b_stride_k,
                    int64_t b_stride_c, bool bf16, bool vec, cudaStream_t stream);

namespace {

void check_operands(const torch::Tensor& tiles, const torch::Tensor& row_ptr,
                    const torch::Tensor& col_ids, const torch::Tensor& x,
                    const torch::Tensor& y) {
  for (const torch::Tensor* t : {&tiles, &row_ptr, &col_ids, &x, &y}) {
    TORCH_CHECK(t->is_cuda() && t->device() == tiles.device(),
                "all operands must lie on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "operands must be contiguous");
  }
  TORCH_CHECK(tiles.dim() == 3, "tiles must be (nb, tm, tk)");
  TORCH_CHECK(tiles.scalar_type() == at::kFloat || tiles.scalar_type() == at::kBFloat16,
              "tiles must be float32 or bfloat16");
  TORCH_CHECK(x.scalar_type() == tiles.scalar_type() && y.scalar_type() == tiles.scalar_type(),
              "tiles, x and y must share one dtype");
  TORCH_CHECK(row_ptr.scalar_type() == at::kInt && col_ids.scalar_type() == at::kInt,
              "row_ptr and col_ids must be int32");
  TORCH_CHECK(row_ptr.dim() == 1 && row_ptr.size(0) >= 1, "row_ptr must be (n_row_tiles + 1,)");
  TORCH_CHECK(col_ids.dim() == 1 && col_ids.size(0) == tiles.size(0),
              "col_ids must be (nb,)");
}

// The tile split (n_workers, 5) int32 and the float32 scratch of at least
// 2 * n_workers * elems values that the kernels write cut row tiles to.
void check_schedule(const torch::Tensor& tiles, const torch::Tensor& schedule,
                    const torch::Tensor& partial, int64_t elems) {
  for (const torch::Tensor* t : {&schedule, &partial}) {
    TORCH_CHECK(t->is_cuda() && t->device() == tiles.device(),
                "schedule and partial must lie on the operands' device");
    TORCH_CHECK(t->is_contiguous(), "schedule and partial must be contiguous");
  }
  TORCH_CHECK(schedule.scalar_type() == at::kInt && schedule.dim() == 2 &&
                  schedule.size(0) >= 1 && schedule.size(1) == 5,
              "schedule must be (n_workers, 5) int32");
  TORCH_CHECK(partial.scalar_type() == at::kFloat &&
                  partial.numel() >= 2 * schedule.size(0) * elems,
              "partial must be float32 with 2 * n_workers * tm (* n) values");
}

void bsr_spmv(torch::Tensor tiles, torch::Tensor row_ptr, torch::Tensor col_ids,
              torch::Tensor x, torch::Tensor y, torch::Tensor schedule, torch::Tensor partial) {
  check_operands(tiles, row_ptr, col_ids, x, y);
  const int tm = tiles.size(1), tk = tiles.size(2);
  const int n_row_tiles = row_ptr.size(0) - 1;
  TORCH_CHECK(x.dim() == 1 && x.size(0) % tk == 0, "x must be (k_pad,) with k_pad % tk == 0");
  TORCH_CHECK(y.dim() == 1 && y.size(0) == static_cast<int64_t>(n_row_tiles) * tm,
              "y must be (n_row_tiles * tm,)");
  check_schedule(tiles, schedule, partial, tm);
  if (n_row_tiles == 0) return;
  const c10::cuda::CUDAGuard guard(tiles.device());
  bsr_spmv_launch(tiles.data_ptr(), row_ptr.data_ptr<int>(), col_ids.data_ptr<int>(),
                  x.data_ptr(), y.data_ptr(), schedule.data_ptr<int>(), schedule.size(0),
                  partial.data_ptr<float>(), tm, tk, tiles.scalar_type() == at::kBFloat16,
                  c10::cuda::getCurrentCUDAStream());
}

// schedule and partial are read by the float32 body only; bfloat16 takes
// them empty.
void bsr_spmm(torch::Tensor tiles, torch::Tensor row_ptr, torch::Tensor col_ids,
              torch::Tensor x, torch::Tensor y, torch::Tensor schedule, torch::Tensor partial) {
  check_operands(tiles, row_ptr, col_ids, x, y);
  const int tm = tiles.size(1), tk = tiles.size(2);
  const int n_row_tiles = row_ptr.size(0) - 1;
  TORCH_CHECK(x.dim() == 2 && x.size(0) % tk == 0, "x must be (k_pad, n) with k_pad % tk == 0");
  TORCH_CHECK(y.dim() == 2 && y.size(0) == static_cast<int64_t>(n_row_tiles) * tm &&
                  y.size(1) == x.size(1),
              "y must be (n_row_tiles * tm, n)");
  const bool bf16 = tiles.scalar_type() == at::kBFloat16;
  if (!bf16) check_schedule(tiles, schedule, partial, static_cast<int64_t>(tm) * x.size(1));
  const c10::cuda::CUDAGuard guard(tiles.device());
  bsr_spmm_launch(tiles.data_ptr(), row_ptr.data_ptr<int>(), col_ids.data_ptr<int>(),
                  x.data_ptr(), y.data_ptr(), bf16 ? nullptr : schedule.data_ptr<int>(),
                  bf16 ? 0 : schedule.size(0), bf16 ? nullptr : partial.data_ptr<float>(),
                  n_row_tiles, tm, tk, x.size(1), bf16, c10::cuda::getCurrentCUDAStream());
}

// Workers of K1 / K2's float32 body on `device`: the schedule's length.
int64_t spmv_workers(int64_t tm, int64_t tk, bool bf16, int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  return bsr_spmv_workers(tm, tk, bf16);
}

int64_t spmm_workers(int64_t tm, int64_t n, int64_t device) {
  const c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(device));
  return bsr_spmm_workers(tm, n);
}

// a (M, K); b the (K, N / bn, bn) block-column view of the (K, N) operand,
// any strides with a unit last one; rows, cols (nnz,) int32, in bounds but
// for padding slots (rows >= M / bm), which come out as zero blocks;
// out (nnz, bm, bn). vec: the body with 16-byte cp.async copies (else one
// element at a time), which ops.sdd_body picks; checked here.
void bsr_sdd(torch::Tensor a, torch::Tensor b, torch::Tensor rows, torch::Tensor cols,
             torch::Tensor out, bool vec) {
  for (const torch::Tensor* t : {&a, &b, &rows, &cols, &out}) {
    TORCH_CHECK(t->is_cuda() && t->device() == a.device(),
                "all operands must lie on one CUDA device");
  }
  for (const torch::Tensor* t : {&a, &rows, &cols, &out}) {
    TORCH_CHECK(t->is_contiguous(), "a, rows, cols and out must be contiguous");
  }
  TORCH_CHECK(a.scalar_type() == at::kFloat || a.scalar_type() == at::kBFloat16,
              "a must be float32 or bfloat16");
  TORCH_CHECK(b.scalar_type() == a.scalar_type() && out.scalar_type() == a.scalar_type(),
              "a, b and out must share one dtype");
  TORCH_CHECK(rows.scalar_type() == at::kInt && cols.scalar_type() == at::kInt,
              "rows and cols must be int32");
  TORCH_CHECK(a.dim() == 2 && a.size(1) >= 1, "a must be (M, K) with K >= 1");
  TORCH_CHECK(out.dim() == 3 && out.size(1) >= 1 && out.size(2) >= 1, "out must be (nnz, bm, bn)");
  const int64_t nnz = out.size(0), bm = out.size(1), bn = out.size(2), K = a.size(1);
  TORCH_CHECK(a.size(0) % bm == 0, "a's rows must be a multiple of bm");
  TORCH_CHECK(b.dim() == 3 && b.size(0) == K && b.size(2) == bn && b.stride(2) == 1,
              "b must be a (K, N / bn, bn) view with unit last stride");
  TORCH_CHECK(rows.dim() == 1 && rows.size(0) == nnz && cols.dim() == 1 && cols.size(0) == nnz,
              "rows and cols must be (nnz,)");
  TORCH_CHECK(nnz * ((bm + 31) / 32) * ((bn + 127) / 128) < (int64_t{1} << 31) &&
                  K < (int64_t{1} << 31) && a.size(0) / bm < (int64_t{1} << 31),
              "too many slots for one launch");
  if (vec) {
    const int64_t v = 16 / a.element_size();  // values of one 16-byte copy
    const auto aligned = [](const torch::Tensor& t) {
      return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
    };
    TORCH_CHECK(aligned(a) && aligned(b) && aligned(out) && K % v == 0 && bn % v == 0 &&
                    b.stride(0) % v == 0 && b.stride(1) % v == 0,
                "the cp.async body of bsr_sdd needs 16-byte aligned operands and K, bn and "
                "b's strides in whole 16-byte vectors");
  }
  const c10::cuda::CUDAGuard guard(a.device());
  bsr_sdd_launch(a.data_ptr(), b.data_ptr(), rows.data_ptr<int>(), cols.data_ptr<int>(),
                 out.data_ptr(), static_cast<int>(nnz), static_cast<int>(bm),
                 static_cast<int>(bn), static_cast<int>(K), static_cast<int>(a.size(0) / bm),
                 b.stride(0), b.stride(1),
                 a.scalar_type() == at::kBFloat16, vec, c10::cuda::getCurrentCUDAStream());
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bsr_spmv", &bsr_spmv, "K1: block-sparse SpMV into y (launches on the current stream)");
  m.def("bsr_spmm", &bsr_spmm, "K2: block-sparse SpMM into y (launches on the current stream)");
  m.def("spmv_workers", &spmv_workers, "K1's schedule length for (tm, tk, bf16, device)");
  m.def("spmm_workers", &spmm_workers, "K2 float32's schedule length for (tm, n, device)");
  m.def("bsr_sdd", &bsr_sdd,
        "K3: sampled dense-dense blocks into out, by the cp.async body (vec) or the scalar "
        "one (launches on the current stream)");
}
