"""The port's s8 plain versions against the JAX package on CPU: the requant
epilogue against XLA's fused one, the 3x3 and 2x2 convolutions and the GEMM
against the Pallas kernels in interpret mode, the int8 ROI pool against
roi_pool_fast; all bit for bit. The CUDA kernels themselves run only on a
card (chip_smoke.py:phase_conv_s8, phase_matmul_s8)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops.conv_s8_pallas import (conv2x2_s8_pallas,  # noqa: E402
                                            conv3x3_s8_pallas,
                                            conv3x3_s8_pallas_v2,
                                            matmul_s8_pallas)
from mv3d_tf_tpu.ops.roi_pool import roi_pool_fast as j_roi_pool  # noqa: E402
from mv3d_tf_tpu_torch.ops import conv_s8 as S8  # noqa: E402
from mv3d_tf_tpu_torch.ops.conv_s8_cuda import (conv2x2_s8_cuda,  # noqa: E402
                                                conv3x3_s8_cuda,
                                                matmul_s8_cuda)
from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool, roi_pool_fast  # noqa: E402

_T = torch.from_numpy


def _case(rng, B, H, W, C, K, taps=3):
    """tests/test_conv_s8.py:15-20: post-ReLU s8 activations, symmetric s8
    weights, requant scale and bias as the trunk has them."""
    x = rng.randint(0, 128, (B, H, W, C)).astype(np.int8)
    w = rng.randint(-127, 128, (taps, taps, C, K)).astype(np.int8)
    k = (rng.rand(K) * 2e-3 + 1e-4).astype(np.float32)
    b = (rng.rand(K) - 0.5).astype(np.float32)
    return x, w, k, b


def _accumulators(n, seed=0):
    """n s32 sums with k and b as the requant sees them (y mostly in
    [-8, 140]); then 2^16 sums near a half code: the product acc*k in
    [200, 2000] and b = float32(c + 0.5 - acc*k) for a code c, so the
    exact y lies within half an ulp of b from c + 0.5, and rounding the
    product first (an error up to half an ulp of the product) moves the
    code; then exact .5 ties: acc odd, k = 0.5, b = 0."""
    rng = np.random.RandomState(seed)
    k = (rng.rand(n) * 2e-3 + 1e-4).astype(np.float32)
    acc = (rng.rand(n) * 148 / k).astype(np.int32) - (8 / k).astype(np.int32)
    b = ((rng.rand(n) - 0.5) * 8).astype(np.float32)
    m = 1 << 16
    kn = (rng.rand(m) * 1.9e-3 + 2e-4).astype(np.float32)
    an = ((rng.rand(m) * 1800 + 200) / kn).astype(np.int32)
    p = an.astype(np.float64) * kn
    bn = (rng.randint(0, 127, m) + 0.5 - p).astype(np.float32)
    ties = np.arange(-255, 256, 2, dtype=np.int32)
    acc = np.concatenate([acc, an, ties])
    k = np.concatenate([k, kn, np.full(ties.size, 0.5, np.float32)])
    b = np.concatenate([b, bn, np.zeros(ties.size, np.float32)])
    return acc, k, b


@pytest.mark.parametrize("out_dtype", ["int8", "float32"])
def test_requant_matches_xla_fused_epilogue(out_dtype):
    """requant equals XLA's `acc.astype(f32) * k + b` under jit (one FMA
    there) on 2^20 sums, 2^16 near half codes and 256 exact ties, bit for
    bit; the two-rounding eager form `a * k + b` misses the same
    comparison."""
    acc, k, b = _accumulators(1 << 20)

    @jax.jit
    def xla(a, k, b):
        y = a.astype(jnp.float32) * k + b
        if out_dtype == "int8":
            return jnp.clip(jnp.round(y), 0, 127).astype(jnp.int8)
        return jnp.maximum(y, 0.0)

    want = np.asarray(xla(acc, k, b))
    dt = getattr(torch, out_dtype)
    got = S8.requant(_T(acc), _T(k), _T(b), dt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    y2 = _T(acc).float() * _T(k) + _T(b)          # two roundings
    two = (torch.round(y2).clamp(0, 127).to(torch.int8) if dt == torch.int8
           else y2.clamp_min(0.0)).numpy()
    assert (two != want).sum() > 0
    # the ties round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    if dt == torch.int8:
        np.testing.assert_array_equal(got[-128:-125], [0, 2, 2])


def test_fma_f32_breaks_ties_by_the_exact_sum():
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is a float32 tie, exact in
    float64; adding +-2^-80 leaves the float64 sum on the tie, so a second
    rounding (half to even) gives 1 + 2^-11 for both, where one fused
    multiply-add rounds the + case up."""
    a = torch.full((3,), 1 + 2.0 ** -12)
    b = torch.tensor([2.0 ** -80, -2.0 ** -80, 0.0])
    lo, hi = 1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -23
    assert S8.fma_f32(a, a, b).tolist() == [hi, lo, lo]
    twice = (a.double() * a.double() + b.double()).float()
    assert twice.tolist() == [lo, lo, lo]


@pytest.mark.parametrize("out_dtype", ["int8", "float32"])
@pytest.mark.parametrize("kernel", [conv3x3_s8_pallas, conv3x3_s8_pallas_v2])
@pytest.mark.parametrize("shape", [
    (1, 8, 7, 128, 128),      # W not a multiple of 8, tiny rows
    (2, 19, 33, 128, 256),    # H not divisible by tile_rows
    (1, 16, 76, 256, 128),    # conv4/5-ish width
])
def test_conv3x3_plain_matches_pallas(shape, kernel, out_dtype):
    """tests/test_conv_s8.py:31-50's shapes against both Pallas kernels in
    interpret mode, bit for bit: int8 output, and float32 output (the int8
    RPN conv's), whose epilogue is the same single-rounding FMA."""
    x, w, k, b = _case(np.random.RandomState(0), *shape)
    want = np.asarray(kernel(*map(jnp.asarray, (x, w, k, b)), tile_rows=8,
                             interpret=True,
                             out_dtype=getattr(jnp, out_dtype)))
    got = S8.conv3x3_s8_plain(*map(_T, (x, w, k, b)),
                              out_dtype=getattr(torch, out_dtype)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [
    (1, 9, 9, 128, 128),      # W-1 not a multiple of 8
    (2, 21, 14, 256, 256),    # packed-stem channel count, odd rows
])
def test_conv2x2_plain_matches_pallas(shape):
    """tests/test_conv_s8.py:65-86's shapes, bit for bit."""
    x, w, k, b = _case(np.random.RandomState(4), *shape, taps=2)
    want = np.asarray(conv2x2_s8_pallas(*map(jnp.asarray, (x, w, k, b)),
                                        tile_rows=4, interpret=True))
    got = S8.conv2x2_s8(*map(_T, (x, w, k, b))).numpy()
    assert got.shape == (shape[0], shape[1] - 1, shape[2] - 1, shape[4])
    np.testing.assert_array_equal(got, want)


def test_conv3x3_plain_any_cin_matches_xla():
    """Cin that is no multiple of 128 (the int8 stem's 9 and conv2_1's 64)
    against the JAX package's own s8 conv and epilogue under jit."""
    from mv3d_tf_tpu import quant as JQ
    rng = np.random.RandomState(5)
    for cin in (9, 64):
        x, w, k, b = _case(rng, 2, 11, 13, cin, 64)
        x = x - 64                                  # signed inputs too
        p = {"w_q": w, "s_in": np.float32(1), "s_w": k,
             "s_out": np.float32(1), "bias": b}
        want = np.asarray(jax.jit(JQ._conv_requant)(x, p))
        got = S8.conv3x3_s8(*map(_T, (x, w, k, b))).numpy()
        np.testing.assert_array_equal(got, want)


def test_matmul_plain_matches_pallas():
    """The plain s8 GEMM against matmul_s8_pallas (interpret), int32."""
    rng = np.random.RandomState(2)
    a = rng.randint(-128, 128, (1024, 2048)).astype(np.int8)
    b = rng.randint(-127, 128, (2048, 512)).astype(np.int8)
    want = np.asarray(matmul_s8_pallas(jnp.asarray(a), jnp.asarray(b),
                                       bm=512, bk=1024, bn=512,
                                       interpret=True))
    got = S8.matmul_s8(_T(a), _T(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_plain_exact_at_fc6_depth():
    """K = 25088 (fc6): sums up to 127 * 128 * 25088 > 2^24 stay exact in
    the plain version's float64 product (equal to numpy's int64 one)."""
    a = np.full((3, 25088), -128, np.int8)
    a[1] = 127
    a[2, ::2] = 5
    b = np.full((25088, 16), -127, np.int8)
    b[:, 1] = 127
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(S8.matmul_s8(_T(a), _T(b)).numpy(), want)


@pytest.mark.parametrize("fn, args", [
    ("conv3x3", lambda: (torch.zeros(1, 4, 4, 16, dtype=torch.int8),
                         torch.zeros(3, 3, 16, 16, dtype=torch.int8),
                         torch.ones(16), torch.zeros(16))),
    ("conv2x2", lambda: (torch.zeros(1, 4, 4, 16, dtype=torch.int8),
                         torch.zeros(2, 2, 16, 16, dtype=torch.int8),
                         torch.ones(16), torch.zeros(16))),
    ("matmul", lambda: (torch.zeros(4, 16, dtype=torch.int8),
                        torch.zeros(16, 16, dtype=torch.int8))),
])
def test_cuda_wrappers_refuse_cpu_tensors(fn, args):
    """A wrapper launches on CUDA tensors or raises; it never falls back to
    the plain version, and its launch count stays put."""
    wrapper = {"conv3x3": conv3x3_s8_cuda, "conv2x2": conv2x2_s8_cuda,
               "matmul": matmul_s8_cuda}[fn]
    before = wrapper.launches
    with pytest.raises(ValueError):
        wrapper(*args())
    assert wrapper.launches == before


def _maps_and_rois(rng, B, H, W, C):
    feat = rng.randint(-128, 128, (B, H, W, C)).astype(np.int8)
    n = 40
    x1 = rng.rand(n) * (W * 8 + 40) - 20
    y1 = rng.rand(n) * (H * 8 + 40) - 20
    rois = np.stack([rng.randint(0, B, n).astype(np.float32), x1, y1,
                     x1 + rng.rand(n) * W * 2 + 2,
                     y1 + rng.rand(n) * H * 2 + 2], 1).astype(np.float32)
    edge = np.array([[B - 1, W * 8 - 8, H * 8 - 8, W * 8 - 1, H * 8 - 1],
                     [B - 1, 0, 0, W * 8 - 1, H * 8 - 1],
                     [B - 1, 30, 20, 30, 20],
                     [B - 1, 40, 10, 20, 30]], np.float32)
    return feat, np.concatenate([rois, edge])


@pytest.mark.parametrize("batched", [False, True])
def test_int8_roi_pool_matches_jax(batched):
    """The plain pool on s8 maps against JAX's roi_pool_fast (CPU path),
    bit for bit, edge and malformed rois included; int8 out."""
    feat, rois = _maps_and_rois(np.random.RandomState(6), 2, 9, 13, 32)
    if not batched:
        feat, rois = feat[0], rois.copy()
        rois[:, 0] = 0
    want = np.asarray(j_roi_pool(jnp.asarray(feat), jnp.asarray(rois),
                                 spatial_scale=1.0 / 8))
    got = roi_pool_fast(_T(feat), _T(rois))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want < 0).any()
    # the int8 pool is the float pool on the same values
    np.testing.assert_array_equal(
        roi_pool(_T(feat).float(), _T(rois)).numpy(), want.astype(np.float32))
