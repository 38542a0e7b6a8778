"""The port's ROI-pool gradient over a batched map (B,H,W,C), the pool of the
Fast R-CNN step's image pyramid: the plain version (ops/roi_pool.py:
roi_pool_bwd) against jax.grad of the JAX package's batched roi_pool on a
map without ties, against the TPU kernel roi_pool_pallas_bwd in interpret
mode frame by frame on a map full of ties, and the train pool's autograd on
a 4-D CPU map. A roi's frame is its column 0, truncated and clamped to
[0, B-1]; rois of every frame come in one call, in any order. The CUDA
kernel is held to this plain version on the card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops.roi_pool import roi_pool as j_roi_pool  # noqa: E402
from mv3d_tf_tpu.ops.roi_pool_pallas import roi_pool_pallas_bwd  # noqa: E402
from mv3d_tf_tpu_torch.ops import roi_pool as T  # noqa: E402
from mv3d_tf_tpu_torch.ops.roi_pool_cuda import (  # noqa: E402
    roi_pool_bwd_cuda, roi_pool_cuda)

B, H, W, C = 3, 10, 14, 8
SCALE = 1.0 / 16


def _rois(rng, n):
    """n rois at 1/16 of random frames 0.9, 1.0 or 2.7 (in range after
    truncation), shuffled: overlapping, edge-crossing, sub-cell and
    malformed boxes."""
    x1 = rng.uniform(-40, 16 * W, n)
    y1 = rng.uniform(-40, 16 * H, n)
    x2 = x1 + rng.uniform(-20, 16 * W, n)
    y2 = y1 + rng.uniform(-20, 16 * H, n)
    frame = rng.choice([0.9, 1.0, 2.7], n)
    return np.stack([frame, x1, y1, x2, y2], 1).astype(np.float32)


def test_plain_batched_bwd_matches_jax_grad(rng):
    """On a map of distinct values (every bin has one max) the even split
    is the plain argmax routing: the plain gradient equals jax.grad of
    JAX's batched XLA roi_pool within 1e-6 relative and absolute (float32
    sums of up to ~40 shares per cell, in another order)."""
    feat = (rng.permutation(B * H * W * C).reshape(B, H, W, C)
            / (B * H * W * C)).astype(np.float32)
    rois = _rois(rng, 40)
    dy = rng.rand(len(rois), 7, 7, C).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(j_roi_pool(
        f, jnp.asarray(rois), spatial_scale=SCALE,
        max_in_h=2000, max_in_w=2000) * dy))(jnp.asarray(feat))
    tf, tr = torch.from_numpy(feat), torch.from_numpy(rois)
    out = T.roi_pool(tf, tr, spatial_scale=SCALE)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_roi_pool(
        jnp.asarray(feat), jnp.asarray(rois), spatial_scale=SCALE,
        max_in_h=2000, max_in_w=2000)))
    got = T.roi_pool_bwd(tf, tr, out, torch.from_numpy(dy),
                         spatial_scale=SCALE)
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_batched_bwd_matches_pallas_per_frame(rng, dtype):
    """A map of the values 1, 2, 3 (ties in almost every bin) and rois
    whose bins do not overlap (each side a multiple of 7 cells), so every
    cell takes at most one share and the sums are exact: the batched plain
    gradient equals roi_pool_pallas_bwd run on each frame with that frame's
    rois, bit for bit. Frame columns 2.7 and 5.0 (past B) truncate and
    clamp to frame 2; the rois come interleaved across the frames, two a
    frame; a 14-cell roi past the map's edges has empty bins."""
    dt = getattr(torch, dtype)
    feat = torch.from_numpy(rng.randint(1, 4, (B, H, W, C))
                            .astype(np.float32)).to(dt)
    # (frame column, x0, y0 in cells, side in cells)
    spec = [(1.3, 7, 0, 14), (0.0, 0, 0, 7), (5.0, 7, 0, 7), (0.9, 7, 3, 7),
            (2.7, 0, 0, 7), (1.0, 0, 0, 7)]
    rois = torch.tensor([[f, 16 * x, 16 * y, 16 * (x + s - 1),
                          16 * (y + s - 1)] for f, x, y, s in spec],
                        dtype=torch.float32)
    out = T.roi_pool(feat, rois, spatial_scale=SCALE)
    dy = torch.from_numpy(rng.rand(len(spec), 7, 7, C).astype(np.float32))
    got = T.roi_pool_bwd(feat, rois, out, dy, spatial_scale=SCALE)
    frame = rois[:, 0].to(torch.int32).clamp(0, B - 1)
    jdt = getattr(jnp, dtype)
    for b in range(B):
        sel = (frame == b).numpy()
        assert sel.any()
        want = roi_pool_pallas_bwd(
            jnp.asarray(feat[b].float().numpy()).astype(jdt),
            jnp.asarray(rois.numpy()[sel]),
            jnp.asarray(out.float().numpy()[sel]).astype(jdt),
            jnp.asarray(dy.numpy()[sel]), spatial_scale=SCALE,
            interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_train_pool_autograd_on_a_batched_cpu_map(rng):
    """roi_pool_train takes (B,H,W,C): on distinct values its gradient
    equals autograd through the plain pool's max chain, in feat's shape and
    dtype; the kernels are not launched for CPU tensors."""
    feat = torch.from_numpy((rng.permutation(B * H * W * C)
                             .reshape(B, H, W, C) / 1e3).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 24))
    dy = torch.from_numpy(rng.rand(24, 7, 7, C).astype(np.float32))
    launches = (roi_pool_cuda.launches, roi_pool_bwd_cuda.launches)
    f1 = feat.clone().requires_grad_()
    out = T.roi_pool_train(f1, rois, spatial_scale=SCALE)
    (out * dy).sum().backward()
    f2 = feat.clone().requires_grad_()
    (T.roi_pool(f2, rois, spatial_scale=SCALE) * dy).sum().backward()
    assert (roi_pool_cuda.launches, roi_pool_bwd_cuda.launches) == launches
    assert f1.grad.shape == (B, H, W, C) and f1.grad.abs().sum() > 0
    np.testing.assert_allclose(f1.grad.numpy(), f2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the plain pair (chip_smoke.py's reference) gives the same gradient
    f3 = feat.clone().requires_grad_()
    (T.roi_pool_train_plain(f3, rois, spatial_scale=SCALE) * dy).sum() \
        .backward()
    torch.testing.assert_close(f3.grad, f1.grad, rtol=0, atol=0)


def test_batched_bwd_kernel_wrapper_refuses_cpu_tensors():
    feat = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError):
        roi_pool_bwd_cuda(feat, torch.zeros(2, 5), torch.zeros(2, 7, 7, 8),
                          torch.zeros(2, 7, 7, 8))
