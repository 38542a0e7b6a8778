"""The port's VGG trunk and plain fused-stem versions against mv3d_tf_tpu:
the literal stem and the fused s2d stem's plain version in bf16 against
vgg_stem_pallas(interpret=True) within bf16 tolerance, the float32 trunk
against the JAX trunk. The CUDA stem kernel (csrc/stem_s2d.cu's bf16
instance) is compared with both plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.models import vgg as J  # noqa: E402
from mv3d_tf_tpu.ops.vgg_stem_pallas import vgg_stem_pallas  # noqa: E402
from mv3d_tf_tpu_torch.models import vgg as T  # noqa: E402
from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import (  # noqa: E402
    stem_s2d_fused_cuda, stem_s2d_fused_plain)
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("B,H,W,Cin,tr", [
    (2, 36, 40, 9, 2),     # BEV-like channels, multi-frame
    (1, 20, 132, 3, 5),    # image-like channels, wide
    (1, 21, 131, 9, 2),    # odd H and W (601-style edge handling)
])
def test_plain_stem_matches_pallas_interpret(rng, B, H, W, Cin, tr):
    x = rng.rand(B, H, W, Cin).astype(np.float32)
    w1 = (rng.rand(3, 3, Cin, 64).astype(np.float32) - 0.5) * 0.2
    b1 = rng.rand(64).astype(np.float32) * 0.1
    w2 = (rng.rand(3, 3, 64, 64).astype(np.float32) - 0.5) * 0.2
    b2 = rng.rand(64).astype(np.float32) * 0.1
    ref = np.asarray(vgg_stem_pallas(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), tile_rows=tr, interpret=True), np.float32)
    out = T.vgg_stem_plain(torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1),
                           _oihw(w2), torch.from_numpy(b2))
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    # accumulation and bias rounding differ -> one-ulp bf16 tolerance
    # (tests/test_vgg_stem.py:37-38)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max() + 1e-6


@pytest.mark.parametrize("B,H,W,Cin,tr", [
    (1, 21, 131, 9, 2),    # odd H and W: the last row and column dropped
    (2, 24, 34, 3, 4),     # image-like channels, even extents
    (1, 17, 19, 9, 8),     # odd, pooled extents off the kernel's 8 x 16 tile
])
def test_s2d_fused_plain_bf16_matches_vgg_stem_pallas(rng, B, H, W, Cin, tr):
    """The literal stem and the fused s2d stem are one function with one
    rounding rule (float32 sums and biases, the intermediate masked and
    rounded once to bf16, one rounding of the pooled output), which lets
    the bf16 kernel of csrc/stem_s2d.cu serve both TPU kernels: the s2d
    stem's plain version in bf16 stays within one bf16 ulp of the max of
    vgg_stem_pallas(interpret=True), nonzero biases included."""
    x = rng.rand(B, H, W, Cin).astype(np.float32)
    w1 = (rng.rand(3, 3, Cin, 64).astype(np.float32) - 0.5) * 0.2
    b1 = 0.5 + 0.5 * rng.rand(64).astype(np.float32)
    w2 = (rng.rand(3, 3, 64, 64).astype(np.float32) - 0.5) * 0.2
    b2 = (rng.rand(64).astype(np.float32) - 0.5) * 0.2
    ref = np.asarray(vgg_stem_pallas(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), tile_rows=tr, interpret=True), np.float32)
    out = stem_s2d_fused_plain(torch.from_numpy(x), _oihw(w1),
                               torch.from_numpy(b1), _oihw(w2),
                               torch.from_numpy(b2), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    # summation order differs; one bf16 ulp of the max covers it
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max() + 1e-6


@pytest.fixture(scope="module")
def he_params():
    return he_normal_params(5, fc_dim=8)


def test_trunk_f32_matches_jax(rng, he_params):
    x = rng.rand(1, 40, 48, 9).astype(np.float32)
    ref = np.asarray(J.trunk_apply(
        {k: {n: jnp.asarray(a) for n, a in v.items()}
         for k, v in he_params.items()}, jnp.asarray(x)))
    with torch.no_grad():
        got = T.trunk_apply(params_from_jax(he_params, device="cpu"),
                            torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 5, 6, 512)
    assert np.abs(ref).max() > 0.1          # He scale: O(1) features
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max()


def test_fused_stem_dispatch_on_cpu(rng, he_params):
    """stem_impl="fused" on a CPU tensor is the plain stem, which is the
    literal bf16 stem; the stem kernel's wrapper (stem_s2d_fused_cuda,
    which the fused stem calls on a card) is not launched, and a CPU
    tensor given to it raises."""
    params = params_from_jax(he_params, device="cpu")
    x = torch.from_numpy(rng.rand(1, 24, 28, 3).astype(np.float32))
    before = stem_s2d_fused_cuda.launches
    with torch.no_grad():
        fused = T.trunk_apply(params, x, "_2", torch.bfloat16,
                              stem_impl="fused")
        literal = T.trunk_apply(params, x, "_2", torch.bfloat16)
    assert torch.equal(fused, literal)
    assert stem_s2d_fused_cuda.launches == before
    w1, b1 = T.layer(params, "conv1_1_2")
    w2, b2 = T.layer(params, "conv1_2_2")
    with pytest.raises(ValueError, match="CUDA"):
        stem_s2d_fused_cuda(x, w1, b1, w2, b2, torch.bfloat16)
    assert stem_s2d_fused_cuda.launches == before
    with pytest.raises(ValueError, match="bfloat16"):
        T.trunk_apply(params, x, stem_impl="pallas")
    with pytest.raises(ValueError, match="unknown stem_impl"):
        T.trunk_apply(params, x, stem_impl="s2d_int8")
