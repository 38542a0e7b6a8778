"""The prepared-weight s8 GEMM (ops/conv_s8.py: prepare_s8_gemm_weight,
matmul_s8_nk_plain, the matmul_s8_nk dispatch) against the JAX package's
matmul_s8_pallas in interpret mode and the port's matmul_s8_plain, bit for
bit, and the refusals of its CUDA wrapper (ops/conv_s8_cuda.py). The kernel
itself runs on the card (chip_smoke.py:phase_matmul_s8)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops.conv_s8_pallas import matmul_s8_pallas  # noqa: E402
from mv3d_tf_tpu_torch.ops import conv_s8 as S8  # noqa: E402
from mv3d_tf_tpu_torch.ops.conv_s8_cuda import (matmul_s8_cuda,  # noqa: E402
                                                matmul_s8_nk_cuda)

_T = torch.from_numpy


def _operands(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randint(-128, 128, (m, k)).astype(np.int8),
            rng.randint(-127, 128, (k, n)).astype(np.int8))


def test_prepared_weight_layout():
    """(K, N) -> (N, Kp): K-major, K zero-padded to a multiple of 16, a
    fresh contiguous tensor; the weight it came from is left as it is."""
    _, b = _operands(0, 1, 200, 40)
    bt = S8.prepare_s8_gemm_weight(_T(b))
    assert bt.dtype == torch.int8 and tuple(bt.shape) == (40, 208)
    assert bt.is_contiguous()
    np.testing.assert_array_equal(bt[:, :200].numpy(), b.T)
    assert not bt[:, 200:].any()
    again = _T(b.copy())
    S8.prepare_s8_gemm_weight(again)
    np.testing.assert_array_equal(again.numpy(), b)


@pytest.mark.parametrize("m, k, n", [(64, 256, 128),     # no padding
                                     (64, 200, 40),      # K and N padded
                                     (37, 1000, 200)])   # K off 128, N off 160
def test_prepared_plain_matches_pallas_and_plain(m, k, n):
    """a @ bt.T on the prepared weight equals matmul_s8_pallas (interpret,
    on operands zero-padded to its blocks) and matmul_s8_plain, int32."""
    a, b = _operands(m + k + n, m, k, n)
    mp, kp, np_ = (-(-d // 128) * 128 for d in (m, k, n))
    a_p = np.zeros((mp, kp), np.int8)
    a_p[:m, :k] = a
    b_p = np.zeros((kp, np_), np.int8)
    b_p[:k, :n] = b
    want = np.asarray(matmul_s8_pallas(jnp.asarray(a_p), jnp.asarray(b_p),
                                       bm=mp, bk=128, bn=np_,
                                       interpret=True))[:m, :n]
    got = S8.matmul_s8_nk(_T(a), S8.prepare_s8_gemm_weight(_T(b)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(S8.matmul_s8_plain(_T(a), _T(b)).numpy(),
                                  want)


def test_prepared_plain_exact_at_fc6_depth():
    """K = 25088: the extreme sums stay exact through the prepared route."""
    a = np.full((2, 25088), -128, np.int8)
    a[1] = 127
    b = np.full((25088, 16), -127, np.int8)
    b[:, 1] = 127
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = S8.matmul_s8_nk(_T(a), S8.prepare_s8_gemm_weight(_T(b)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bt_shape, what", [
    ((16, 32), "bt"),            # K not padded as prepared: 32 != 48
    ((16, 40), "bt"),
    ((16, 48), "CUDA device"),   # the right operand, on the CPU
])
def test_cuda_wrapper_refuses(bt_shape, what):
    """matmul_s8_nk_cuda refuses an (N, K) operand that is not the prepared
    one of a, and CPU tensors; it never falls back to the plain version,
    and the GEMM kernel's launch count stays put."""
    a = torch.zeros(4, 40, dtype=torch.int8)
    bt = torch.zeros(bt_shape, dtype=torch.int8)
    before = matmul_s8_cuda.launches
    with pytest.raises(ValueError, match=what):
        matmul_s8_nk_cuda(a, bt)
    assert matmul_s8_cuda.launches == before


def test_plain_refuses_a_wrong_operand():
    """The dispatch's plain route holds bt to the same shape rule."""
    with pytest.raises(ValueError, match="prepare_s8_gemm_weight"):
        S8.matmul_s8_nk(torch.zeros(4, 40, dtype=torch.int8),
                        torch.zeros(16, 40, dtype=torch.int8))
    with pytest.raises(TypeError):
        S8.matmul_s8_nk(torch.zeros(4, 48, dtype=torch.int8),
                        torch.zeros(16, 48, dtype=torch.int32))
