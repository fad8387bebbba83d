"""PyTorch port, K3's float32 body: the plain emulation of its TF32 rounding
and 3xTF32 product (``kernels.testing``), and the rule that picks K3's body
(``ops.sdd_body``). CPU only: the kernel itself is held against its plain
version on a card (``tests/test_torch_kernels.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs this file beside the JAX suites

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import testing as ttesting  # noqa: E402

TF32_ULP = 2.0**-10  # TF32's mantissa step at 1.0


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + TF32_ULP / 2, 1 + TF32_ULP),  # a tie: away from zero (to even would give 1.0)
    (-(1 + TF32_ULP / 2), -(1 + TF32_ULP)),
    (1 + TF32_ULP / 2 - 2.0**-23, 1.0),  # just below the tie
    (1 + 1.5 * TF32_ULP, 1 + 2 * TF32_ULP),  # a tie from an odd mantissa
    (2 - 2.0**-23, 2.0),  # the carry moves the exponent
    (2.0**100 * (1 + TF32_ULP / 2), 2.0**100 * (1 + TF32_ULP)),  # float32's range, not fp16's
    (2.0**-100, 2.0**-100),
    (2.0**-130, 2.0**-130),  # a subnormal that TF32 holds
    (float(np.finfo(np.float32).max), float("inf")),  # past TF32's largest finite value
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    got = ttesting.tf32_rna(np.float32(x))
    assert got == np.float32(want)


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_tf32_keeps_signed_zeros(zero):
    got = ttesting.tf32_rna(np.float32(zero))
    assert got == 0 and np.signbit(got) == np.signbit(np.float32(zero))


def test_tf32_passes_inf_and_nan_and_zeroes_the_low_bits():
    special = ttesting.tf32_rna(np.array([np.inf, -np.inf, np.nan], np.float32))
    assert special[0] == np.inf and special[1] == -np.inf and np.isnan(special[2])
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 1e3
    hi = ttesting.tf32_rna(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x - hi) <= np.abs(x) * TF32_ULP / 2)
    lo = ttesting.tf32_rna(x - hi)  # hi + lo holds about 22 of the 24 bits
    assert np.all(np.abs(x - hi - lo) <= np.abs(x) * 2.0**-21)


def test_3xtf32_holds_float32_tolerance_where_one_tf32_product_misses():
    """At the MoE's depth K = 5120 (seeded normal inputs, against a float64
    product): the three-term product, its tensor-core accumulator restarted
    every 16-deep step as K3's float32 body does, stays within 1e-5 of
    max|ref|, the tolerance every float32 kernel is held to. One TF32
    product does not, nor do three products kept in one tensor-core
    accumulator over all of K, whose rounding toward zero drifts: which is
    why the body runs three and restarts the accumulator."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((8, 5120)).astype(np.float32)
    b = rng.standard_normal((5120, 64)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(ttesting.matmul_3xtf32(a, b) - ref).max() / scale <= 1e-5
    assert np.abs(ttesting.matmul_3xtf32(a, b, step=None) - ref).max() / scale > 1e-5
    one_tf32 = np.matmul(ttesting.tf32_rna(a), ttesting.tf32_rna(b), dtype=np.float32)
    assert np.abs(one_tf32 - ref).max() / scale > 1e-5


def _operands(dtype, K, bn, n_blocks=3, a_shift=0, b_pad=0):
    """a (16, K) and the block-column view (K, n_blocks, bn) of an expert
    stack (n_blocks, K, bn + b_pad), as the MoE passes it; a_shift moves a's
    start by that many elements."""
    a = torch.zeros(16 * K + a_shift, dtype=dtype)[a_shift:].view(16, K)
    w = torch.zeros((n_blocks, K, bn + b_pad), dtype=dtype)[:, :, :bn]
    return a, w.permute(1, 0, 2)


@pytest.mark.parametrize("dtype,K,bn,a_shift,b_pad,want", [
    (torch.float32, 64, 32, 0, 0, "cp.async"),
    (torch.float32, 5120, 1536, 0, 0, "cp.async"),  # the MoE's tables
    (torch.bfloat16, 5120, 1536, 0, 0, "cp.async"),
    (torch.float32, 44, 200, 0, 0, "cp.async"),  # K and bn not multiples of 32 or 128
    (torch.bfloat16, 44, 200, 0, 0, "scalar"),  # ... but K not whole 8-value vectors
    (torch.float32, 45, 32, 0, 0, "scalar"),  # K not whole 4-value vectors
    (torch.float32, 64, 6, 0, 0, "scalar"),  # bn not whole vectors
    (torch.float32, 64, 32, 1, 0, "scalar"),  # a 4 bytes past a 16-byte boundary
    (torch.float32, 64, 32, 4, 0, "cp.async"),  # a one whole vector past a boundary
    (torch.float32, 64, 32, 0, 1, "scalar"),  # b's strides 33 and 64 * 33
    (torch.bfloat16, 64, 32, 0, 8, "cp.async"),  # padded stack rows, whole vectors
])
def test_sdd_body_choice(dtype, K, bn, a_shift, b_pad, want):
    a, b = _operands(dtype, K, bn, a_shift=a_shift, b_pad=b_pad)
    assert tops.sdd_body(a, b) == want

