"""The port's plain ROI-pool gradient (ops/roi_pool.py:roi_pool_bwd) against
the TPU kernel roi_pool_pallas_bwd in interpret mode, on distinct,
all-zero, sparse post-ReLU and tied maps (ties split dy evenly), and the
train pool's autograd on the CPU. The CUDA kernel is held to this plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops.roi_pool_pallas import roi_pool_pallas_bwd  # noqa: E402
from mv3d_tf_tpu_torch.ops import roi_pool as T  # noqa: E402
from mv3d_tf_tpu_torch.ops.roi_pool_cuda import (  # noqa: E402
    roi_pool_bwd_cuda, roi_pool_cuda)

H, W, C = 14, 20, 8
# overlapping rois (the 1st twice), the whole map, the right/bottom edge,
# past the edge, a sub-cell roi and a malformed one (x2 < x1)
ROIS = np.array([
    [0, 8, 16, 100, 90],
    [0, 8, 16, 100, 90],
    [0, 40, 30, 150, 110],
    [0, 0, 0, 8 * W - 1, 8 * H - 1],
    [0, 8 * W - 30, 8 * H - 20, 8 * W - 1, 8 * H - 1],
    [0, -40, -30, 60, 50],
    [0, 70, 60, 72, 61],
    [0, 120, 40, 60, 90],
], np.float32)


def _map(kind, rng):
    if kind == "distinct":
        return rng.permutation(H * W * C).reshape(H, W, C).astype(np.float32)
    if kind == "zeros":
        return np.zeros((H, W, C), np.float32)
    if kind == "sparse":            # post-ReLU: about half the cells are 0
        return np.maximum(rng.randn(H, W, C), 0).astype(np.float32)
    if kind == "levels":            # a few positive levels: ties above 0
        return rng.randint(1, 4, (H, W, C)).astype(np.float32)
    raise ValueError(kind)


def _pallas(feat, out, dy, dtype, pooled=7):
    return np.asarray(roi_pool_pallas_bwd(
        jnp.asarray(feat).astype(dtype), jnp.asarray(ROIS),
        jnp.asarray(out.float().numpy()).astype(dtype), jnp.asarray(dy),
        pooled=pooled, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["distinct", "zeros", "sparse", "levels"])
def test_plain_bwd_matches_pallas_bwd(rng, kind, dtype):
    feat = torch.from_numpy(_map(kind, rng)).to(getattr(torch, dtype))
    rois = torch.from_numpy(ROIS)
    out = T.roi_pool(feat, rois)
    dy = rng.rand(len(ROIS), 7, 7, C).astype(np.float32)
    got = T.roi_pool_bwd(feat, rois, out, torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == (H, W, C)
    ref = _pallas(feat.float().numpy(), out, dy, dtype)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # mass: each non-empty bin hands on all of its dy
    nonempty = torch.stack([T.roi_pool(torch.ones(H, W, 1), rois)[..., 0]]
                           * C, -1).numpy() > 0
    np.testing.assert_allclose(got.sum().item(), dy[nonempty].sum(),
                               rtol=1e-5)


def test_ties_split_evenly():
    """tests/test_roi_pool.py:247-278 on the port: all-zero bins spread dy
    over the bin, two equal maxima in one bin each get dy/2."""
    feat = torch.zeros(16, 16, 8)
    rois = torch.tensor([[0, 0, 0, 120, 120]], dtype=torch.float32)
    g = T.roi_pool_bwd(feat, rois, T.roi_pool(feat, rois),
                       torch.ones(1, 7, 7, 8))
    np.testing.assert_allclose(g.sum().item(), 7 * 7 * 8, rtol=1e-5)
    assert (g > 0).all()

    feat2 = torch.zeros(8, 8, 1)
    feat2[1, 1, 0] = feat2[2, 3, 0] = 5.0
    rois2 = torch.tensor([[0, 0, 0, 63, 63]], dtype=torch.float32)
    g2 = T.roi_pool_bwd(feat2, rois2, T.roi_pool(feat2, rois2, pooled=1),
                        torch.ones(1, 1, 1, 1), pooled=1)
    assert g2[1, 1, 0] == 0.5 and g2[2, 3, 0] == 0.5 and g2.sum() == 1.0


def test_plain_bwd_crosses_roi_blocks(rng):
    """More rois than _CHUNK: the blocks add up to the one-shot result."""
    feat = torch.from_numpy(_map("sparse", rng))
    rois = torch.from_numpy(np.concatenate([ROIS] * (T._CHUNK // 8 + 2)))
    out = T.roi_pool(feat, rois)
    dy = torch.from_numpy(rng.rand(*out.shape).astype(np.float32))
    got = T.roi_pool_bwd(feat, rois, out, dy)
    n = len(ROIS)
    want = sum(T.roi_pool_bwd(feat, rois[i:i + n], out[i:i + n], dy[i:i + n])
               for i in range(0, len(rois), n))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_pool_autograd_on_cpu(rng, dtype):
    """On distinct values the train pool's gradient equals autograd through
    the plain pool's max chain, and it returns feat's dtype; the kernels
    are not launched for CPU tensors."""
    dt = getattr(torch, dtype)
    feat = torch.from_numpy(_map("distinct", rng) / (H * W * C)).to(dt)
    rois = torch.from_numpy(ROIS)
    dy = torch.from_numpy(rng.rand(len(ROIS), 7, 7, C).astype(np.float32))
    launches = (roi_pool_cuda.launches, roi_pool_bwd_cuda.launches)
    f1 = feat.clone().requires_grad_()
    out = T.roi_pool_train(f1, rois)
    (out.float() * dy).sum().backward()
    assert (roi_pool_cuda.launches, roi_pool_bwd_cuda.launches) == launches
    f2 = feat.clone().requires_grad_()
    (T.roi_pool(f2, rois).float() * dy).sum().backward()
    assert f1.grad.dtype == dt and torch.equal(out, T.roi_pool(feat, rois))
    if dtype == "float32":
        np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert f1.grad.float().abs().sum() > 0


def test_train_pool_and_bwd_kernel_reject_other_devices():
    feat = torch.zeros(4, 4, 8)
    rois = torch.zeros(2, 5)
    with pytest.raises(ValueError):
        T.roi_pool_train(feat.to("meta"), rois.to("meta"))
    with pytest.raises(ValueError):
        T.roi_pool_train(feat[None], rois)         # one frame only
    with pytest.raises(ValueError):   # the kernel wrapper takes no CPU tensor
        roi_pool_bwd_cuda(feat, rois, torch.zeros(2, 7, 7, 8),
                          torch.zeros(2, 7, 7, 8))
