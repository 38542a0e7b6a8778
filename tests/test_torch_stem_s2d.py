"""The port's space-to-depth stem (ops/stem_s2d.py) against the JAX
package's on CPU: the packed weights equal, the edge mask equal, the stem
within float32 summation noise in float32 and within bf16 rounding in bf16,
and its gradient equal to the literal stem's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.ops import stem_s2d as JS  # noqa: E402
from mv3d_tf_tpu_torch.models import vgg  # noqa: E402
from mv3d_tf_tpu_torch.ops import stem_s2d as TS  # noqa: E402

_T = torch.from_numpy


def _case(rng, B, H, W, Cin, C1=64, C2=64):
    """tests/test_stem_s2d.py:17-23: inputs of both signs, HWIO weights."""
    x = rng.rand(B, H, W, Cin).astype(np.float32) * 2 - 0.5
    w1 = (rng.randn(3, 3, Cin, C1) * 0.1).astype(np.float32)
    b1 = (rng.rand(C1) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, C1, C2) * 0.1).astype(np.float32)
    b2 = (rng.rand(C2) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _oihw(w):
    return _T(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("cin", [9, 3])
def test_pack_stem_weights_equal_jax(cin):
    """The gathers of the port place every literal weight where the JAX
    package's scatters do; the rest is exact zeros."""
    _, w1, b1, w2, b2 = _case(np.random.RandomState(cin), 1, 4, 4, cin,
                              C1=8, C2=16)
    want = JS.pack_stem_weights(*map(jnp.asarray, (w1, b1, w2, b2)))
    got = TS.pack_stem_weights(*map(_T, (w1, b1, w2, b2)))
    for name, g, w in zip(("K1", "B1", "K2", "B2"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_hwio_of_the_port_layers_packs_alike():
    """Packing the port's OIHW layers through hwio() gives the weights
    packed from the JAX layout."""
    _, w1, b1, w2, b2 = _case(np.random.RandomState(3), 1, 4, 4, 9)
    got = TS.pack_stem_weights(TS.hwio(_oihw(w1)), _T(b1),
                               TS.hwio(_oihw(w2)), _T(b2))
    want = TS.pack_stem_weights(*map(_T, (w1, b1, w2, b2)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("H, W", [(11, 9), (10, 12), (9, 10)])
def test_mask_edges_equal_jax(H, W):
    """Odd and even extents: the same packed entries are zeroed."""
    C1 = 4
    y = np.random.RandomState(H * W).rand(2, H // 2 + 1, W // 2 + 1,
                                          4 * C1).astype(np.float32) + 1
    want = np.asarray(JS._mask_edges(jnp.asarray(y), H, W, C1))
    np.testing.assert_array_equal(TS._mask_edges(_T(y), H, W, C1).numpy(),
                                  want)
    assert (want == 0).any()


@pytest.mark.parametrize("shape", [
    (1, 21, 17, 9),    # odd/odd (BEV 601x601 class)
    (2, 16, 24, 3),    # even/even (image 384x1248 class)
    (1, 15, 16, 9),    # odd/even mix
])
def test_stem_s2d_f32_matches_jax(shape):
    """float32 against the JAX stem at HIGHEST precision: the same
    multiply-adds in another summation order, within 2e-5 (the JAX test's
    own tolerance, tests/test_stem_s2d.py:39)."""
    x, w1, b1, w2, b2 = _case(np.random.RandomState(0), *shape)
    want = np.asarray(JS.stem_s2d(*map(jnp.asarray, (x, w1, b1, w2, b2))))
    got = TS.stem_s2d(_T(x), _oihw(w1), _T(b1), _oihw(w2), _T(b2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_stem_s2d_bf16_matches_jax():
    """bfloat16: inputs and packed weights cast alike; the two frameworks'
    bf16 convs round at other places, so within a few bf16 ulps of the
    output's scale (2^-8 relative is one ulp)."""
    x, w1, b1, w2, b2 = _case(np.random.RandomState(1), 1, 20, 22, 9)
    want = np.asarray(JS.stem_s2d(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                  dtype=jnp.bfloat16), np.float32)
    got = TS.stem_s2d(_T(x), _oihw(w1), _T(b1), _oihw(w2), _T(b2),
                      dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -8 * scale)


def _literal(x, w1, b1, w2, b2):
    y = vgg.conv2d(vgg.conv2d(x, w1, b1), w2, b2)
    return vgg.max_pool_2x2_valid(y)


def test_stem_s2d_gradient_equals_literal():
    """The packing is gathers, so gradients flow to the literal weights and
    equal the literal stem's within float32 summation noise."""
    x, w1, b1, w2, b2 = _case(np.random.RandomState(2), 1, 12, 14, 9,
                              C1=8, C2=8)
    grads = []
    for fn in (TS.stem_s2d, _literal):
        ws = [t.clone().requires_grad_() for t in
              (_oihw(w1), _T(b1), _oihw(w2), _T(b2))]
        (fn(_T(x), *ws) ** 2).sum().backward()
        grads.append([w.grad for w in ws])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
