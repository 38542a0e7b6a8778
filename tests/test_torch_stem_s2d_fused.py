"""The fused s2d stem of the port (ops/stem_s2d_cuda.py) against the JAX
package's Pallas kernel (ops/stem_s2d_pallas.py, interpret mode) on CPU,
and the trunks that run it (models/vgg.trunk_apply) against JAX's.

JAX's trunk imports stem_s2d_fused at call time and calls it without
``interpret``, so the trunk tests patch the module attribute with the
interpret-mode kernel; nothing in the JAX package changes."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu.models import vgg as JV  # noqa: E402
from mv3d_tf_tpu.ops import stem_s2d_pallas as JP  # noqa: E402
from mv3d_tf_tpu_torch.models import vgg as TV  # noqa: E402
from mv3d_tf_tpu_torch.ops.stem_s2d import (_conv, _mask_edges,  # noqa
                                            group_max, hwio,
                                            pack_stem_weights)
from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import (  # noqa: E402
    stem_s2d_fused, stem_s2d_fused_cuda, stem_s2d_fused_plain)
from mv3d_tf_tpu_torch.train import build_forward_losses  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)

_T = torch.from_numpy
BF16_TOL = 2.0 ** -7
# tests/test_stem_s2d_pallas.py:22-27: even/even, odd/odd (the BEV's 601
# class), the image's 3 channels even, and an odd/even mix
SHAPES = [(26, 26, 9), (25, 21, 9), (24, 34, 3), (27, 20, 3)]


def _case(H, W, Cin):
    """tests/test_stem_s2d_pallas.py:13-20,30-32: B=2, nonzero biases."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, H, W, Cin).astype(np.float32)
    w1 = rng.randn(3, 3, Cin, 64).astype(np.float32) * 0.1
    b1 = rng.randn(64).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    b2 = rng.randn(64).astype(np.float32) * 0.1
    return x, w1, b1, w2, b2


def _port_args(x, w1, b1, w2, b2):
    oihw = lambda w: _T(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # noqa
    return _T(x), oihw(w1), _T(b1), oihw(w2), _T(b2)


def _jax_fused(args, dtype):
    out = JP.stem_s2d_fused(*args, dtype=dtype, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("H, W, Cin", SHAPES)
def test_plain_matches_jax_kernel_f32(H, W, Cin):
    """float32: the same products summed in another order, within the JAX
    kernel test's own 2e-5 (tests/test_stem_s2d_pallas.py:38-39)."""
    args = _case(H, W, Cin)
    want = _jax_fused(args, jnp.float32)
    got = stem_s2d_fused_plain(*_port_args(*args), dtype=torch.float32)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, H // 2, W // 2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H, W, Cin", SHAPES)
def test_plain_matches_jax_kernel_bf16(H, W, Cin):
    """bfloat16: within 2^-7 * max|ref|, the bf16 ulp at the top of the
    range (one y entry may round to a neighbouring bf16 value under another
    summation order; the largest error measured at these cases is 8.1e-4 of
    max|ref|, most are 0 to 5e-6)."""
    args = _case(H, W, Cin)
    want = _jax_fused(args, jnp.bfloat16)
    got = stem_s2d_fused_plain(*_port_args(*args), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max()


def _replay_biases_in_bf16(x, w1, b1, w2, b2):
    """The fused stem with the XLA twin's bias order (ops/stem_s2d.py:
    stem_s2d): each conv rounds to bf16, then the bf16 bias is added and
    rounded again."""
    bf, f32 = torch.bfloat16, torch.float32
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    K1, B1, K2, B2 = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
    x, K1, K2 = (t.to(bf).to(f32) for t in (x, K1, K2))
    y = _conv(x, K1, 2, (2, 2 * Wo + 2 - W, 2, 2 * Ho + 2 - H)).to(bf)
    y = _mask_edges(torch.relu(y + B1.to(bf)), H, W, 64).to(f32)
    z = _conv(y, K2).to(bf)
    return group_max(torch.relu(z + B2.to(bf)), 64)


def test_one_rounding_rule_pinned():
    """The bias is added in float32 before the one rounding to bf16: the
    replay that adds it in bf16 after the conv has rounded (the XLA twin's
    order) is farther from JAX's kernel than the plain version is."""
    args = _case(26, 26, 9)
    want = _jax_fused(args, jnp.bfloat16)
    port = _port_args(*args)
    plain = np.abs(stem_s2d_fused_plain(*port).float().numpy() - want).max()
    replay = np.abs(_replay_biases_in_bf16(*port).float().numpy()
                    - want).max()
    assert replay > 0 and plain < replay


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_on_the_cpu_is_the_plain_version(dtype):
    port = _port_args(*_case(25, 21, 9))
    assert torch.equal(stem_s2d_fused(*port, dtype=dtype),
                       stem_s2d_fused_plain(*port, dtype=dtype))


def test_kernel_wrapper_refuses_cpu_tensors_and_other_widths():
    """The wrapper launches only on a card, at C1 = C2 = 64."""
    port = _port_args(*_case(24, 34, 3))
    with pytest.raises(ValueError, match="CUDA"):
        stem_s2d_fused_cuda(*port)
    with pytest.raises(ValueError, match="dtype"):
        stem_s2d_fused_cuda(*port, dtype=torch.float16)


# --- the trunks ------------------------------------------------------------

@pytest.fixture(scope="module")
def trunk_case():
    P = he_normal_params(1, fc_dim=8)
    rng = np.random.RandomState(1)
    return dict(P=P, params=params_from_jax(P, device="cpu"),
                bev=rng.rand(1, 17, 18, 9).astype(np.float32),
                image=(rng.rand(1, 16, 24, 3) * 255 - 96).astype(np.float32))


@pytest.mark.parametrize("stem", ["s2d", "s2d_fused"])
@pytest.mark.parametrize("view, suffix", [("bev", ""), ("image", "_2")])
def test_trunk_matches_jax_f32(trunk_case, monkeypatch, stem, view, suffix):
    """trunk_apply with each s2d stem in float32 against JAX's (the Pallas
    kernel in interpret mode), within 1e-4 * max|ref| over the 13 convs."""
    monkeypatch.setattr(JP, "stem_s2d_fused",
                        functools.partial(JP.stem_s2d_fused, interpret=True))
    x = trunk_case[view]
    want = np.asarray(JV.trunk_apply(trunk_case["P"], x, suffix=suffix,
                                     stem_impl=stem))
    with torch.no_grad():
        got = TV.trunk_apply(trunk_case["params"], _T(x), suffix=suffix,
                             stem_impl=stem).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("jax_name, port_name", [("pallas", "fused"),
                                                 ("bf16", "literal")])
def test_pallas_is_the_fused_stems_jax_name(trunk_case, jax_name, port_name):
    """The JAX package's stem names run the port's stem of the same
    function: "pallas" the fused stem, "bf16" the literal stem, equal at
    the same dtype."""
    x = _T(trunk_case["bev"])
    with torch.no_grad():
        a, b = (TV.trunk_apply(trunk_case["params"], x,
                               dtype=torch.bfloat16, stem_impl=stem)
                for stem in (jax_name, port_name))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="s2d_int8"):
        TV.trunk_apply(trunk_case["params"], x, stem_impl="s2d_int8")


def test_s2d_trunk_gradient_matches_jax(trunk_case):
    """The gradient through the s2d stem's packed convs of <trunk, g>
    against jax.grad, for every trunk weight and bias, within
    1e-4 * max|g| of each."""
    P, params = trunk_case["P"], trunk_case["params"]
    x = trunk_case["bev"]
    cot = np.random.RandomState(2).randn(1, 2, 2, 512).astype(np.float32)
    names = [name for name, _, _ in TV.VGG_LAYERS]

    def jloss(sub):
        out = JV.trunk_apply(dict(P, **sub), x, stem_impl="s2d")
        return jnp.sum(out * cot)

    want = jax.grad(jloss)({n: P[n] for n in names})
    params.zero_grad()
    out = TV.trunk_apply(params, _T(x), stem_impl="s2d")
    (out * _T(cot)).sum().backward()
    for n in names:
        w, b = TV.layer(params, n)
        jw = np.asarray(want[n]["weights"]).transpose(3, 2, 0, 1)
        jb = np.asarray(want[n]["biases"])
        for got, ref in ((w.grad.numpy(), jw), (b.grad.numpy(), jb)):
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=n)
    params.zero_grad()


@pytest.mark.parametrize("stem", ["fused", "pallas", "s2d_fused"])
def test_training_refuses_the_fused_stems(stem):
    with pytest.raises(ValueError, match="gradient"):
        build_forward_losses(stem_impl=stem)
