"""The prepared-weight s8 3x3 conv (ops/conv_s8.py: prepare_s8_conv_weight,
conv3x3_s8_nk_plain, the conv3x3_s8_nk dispatch; quant.prepare_trunk_weights)
against the JAX package's conv3x3_s8_pallas_v2 in interpret mode under jit,
the port's conv3x3_s8_plain and JAX's folded requant, bit for bit, and the
refusals of its CUDA wrapper (ops/conv_s8_cuda.py). The kernel itself runs
on the card (chip_smoke.py:phase_conv_s8)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu import quant as JQ  # noqa: E402
from mv3d_tf_tpu.ops.conv_s8_pallas import conv3x3_s8_pallas_v2  # noqa: E402
from mv3d_tf_tpu_torch import quant as Q  # noqa: E402
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn  # noqa: E402
from mv3d_tf_tpu_torch.models import vgg  # noqa: E402
from mv3d_tf_tpu_torch.ops import conv_s8 as S8  # noqa: E402
from mv3d_tf_tpu_torch.ops.conv_s8_cuda import (conv3x3_s8_cuda,  # noqa: E402
                                                conv3x3_s8_nk_cuda)
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax,
                                             quant_state_from_jax)

_T = torch.from_numpy
SMALL = dict(feat_h=5, feat_w=5, pre_nms_top_n=30, post_nms_top_n=8)


def _case(seed, B, H, W, C, N):
    """Post-ReLU s8 activations, symmetric s8 weights, requant k and b as
    the trunk has them (tests/test_torch_conv_s8.py:_case)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 128, (B, H, W, C)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, C, N)).astype(np.int8)
    k = (rng.rand(N) * 2e-3 + 1e-4).astype(np.float32)
    b = (rng.rand(N) - 0.5).astype(np.float32)
    return x, w, k, b


@pytest.mark.parametrize("C, cp", [(9, 64), (64, 64), (96, 128), (512, 512)])
def test_prepared_conv_weight_layout(C, cp):
    """(3,3,C,N) HWIO -> (N, 9*Cp): output channel major, the reduction in
    (dy, dx, c) order, C zero-padded to a multiple of 64, a fresh contiguous
    tensor; the weight it came from is left as it is."""
    _, w, _, _ = _case(C, 1, 1, 1, C, 32)
    w_nk = S8.prepare_s8_conv_weight(_T(w))
    assert w_nk.dtype == torch.int8 and tuple(w_nk.shape) == (32, 9 * cp)
    assert w_nk.is_contiguous() and S8.conv_channels(C) == cp
    blocks = w_nk.numpy().reshape(32, 3, 3, cp)
    np.testing.assert_array_equal(blocks[..., :C], w.transpose(3, 0, 1, 2))
    assert not blocks[..., C:].any()
    again = _T(w.copy())
    S8.prepare_s8_conv_weight(again)
    np.testing.assert_array_equal(again.numpy(), w)


@pytest.mark.parametrize("out_dtype", ["int8", "float32"])
@pytest.mark.parametrize("C", [9, 64, 96])
def test_nk_plain_matches_pallas_v2_and_plain(C, out_dtype):
    """conv3x3_s8_nk_plain on the prepared weight equals JAX's
    conv3x3_s8_pallas_v2 (interpret mode, under jax.jit, on operands
    zero-padded to its 128 channels and 128 outputs) and conv3x3_s8_plain,
    bit for bit, with the int8 requant and the float32 dequant + ReLU
    epilogues; odd H, and W no multiple of 8."""
    N = 48
    x, w, k, b = _case(C + 1, 2, 9, 13, C, N)
    x_p = np.zeros(x.shape[:3] + (128,), np.int8)
    x_p[..., :C] = x
    w_p = np.zeros((3, 3, 128, 128), np.int8)
    w_p[:, :, :C, :N] = w
    k_p, b_p = np.ones(128, np.float32), np.zeros(128, np.float32)
    k_p[:N], b_p[:N] = k, b
    pallas = jax.jit(functools.partial(
        conv3x3_s8_pallas_v2, tile_rows=8, interpret=True,
        out_dtype=getattr(jnp, out_dtype)))
    want = np.asarray(pallas(*map(jnp.asarray, (x_p, w_p, k_p, b_p))))[..., :N]
    dt = getattr(torch, out_dtype)
    got = S8.conv3x3_s8_nk(_T(x), S8.prepare_s8_conv_weight(_T(w)), _T(k),
                           _T(b), dt)
    assert got.dtype == dt and tuple(got.shape) == (2, 9, 13, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        S8.conv3x3_s8_plain(*map(_T, (x, w, k, b)), out_dtype=dt).numpy(),
        want)
    if dt == torch.int8:
        assert 0.05 < ((want > 0) & (want < 127)).mean()


@pytest.fixture(scope="module")
def trunks():
    """He-scaled params with nonzero biases, both trunks quantized by the
    JAX package from fixed activation scales, and the port's state."""
    P = he_normal_params(11, fc_dim=8)
    rng = np.random.RandomState(11)
    for name in P:
        P[name]["biases"] = (rng.randn(*P[name]["biases"].shape)
                             * 0.1).astype(np.float32)
    jstate = {"use_stem": True, "head": None}
    for key, suffix in (("trunk_bv", ""), ("trunk_img", "_2")):
        scales = {"__input__": 1.0 / 127}
        scales.update({name: float(0.01 + 0.03 * rng.rand())
                       for name, _, _ in vgg.VGG_LAYERS})
        jstate[key] = JQ.quantize_trunk(P, scales, suffix=suffix)
    return dict(P=P, jstate=jstate, state=quant_state_from_jax(jstate, "cpu"))


@pytest.mark.parametrize("key", ["trunk_bv", "trunk_img"])
def test_prepare_trunk_weights_k_and_b_bit_identical(trunks, key):
    """prepare_trunk_weights folds k = s_in*s_w/s_out and b = bias/s_out
    once, with the bits of the per-call epilogue (the same tensor ops on
    the state) and of JAX's _conv_requant under jit (quant.py:172-173);
    its weights are prepare_s8_conv_weight's, for all 13 layers."""
    qt = trunks["state"][key]
    prepared = Q.prepare_trunk_weights(qt)
    assert set(prepared) == {name for name, _, _ in vgg.VGG_LAYERS}

    @jax.jit
    def folded(p):
        return ((p["s_in"] * p["s_w"] / p["s_out"]).astype(jnp.float32),
                (p["bias"] / p["s_out"]).astype(jnp.float32))

    for name, pw in prepared.items():
        p = qt[name]
        assert torch.equal(pw["k"], p["s_in"] * p["s_w"] / p["s_out"])
        assert torch.equal(pw["b"], p["bias"] / p["s_out"])
        jk, jb = folded(trunks["jstate"][key][name])
        np.testing.assert_array_equal(pw["k"].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pw["b"].numpy(), np.asarray(jb))
        assert pw["b"].abs().max() > 0
        assert torch.equal(pw["w_nk"], S8.prepare_s8_conv_weight(p["w_q"]))


def test_building_the_detector_prepares_the_trunks_once(trunks, monkeypatch):
    """build_detect_batch_fn(quant=state) prepares the 26 trunk convs when
    it is built and none when it runs; after building and running it, the
    quant state still equals JAX's leaf for leaf (HWIO w_q, no new key)."""
    prepared = []
    prepare = S8.prepare_s8_conv_weight

    def counting_prepare(w):
        prepared.append(tuple(w.shape))
        return prepare(w)

    monkeypatch.setattr(S8, "prepare_s8_conv_weight", counting_prepare)
    state = trunks["state"]
    detect = build_detect_batch_fn(quant=state, stem_impl="s2d_int8",
                                   **SMALL)
    assert len(prepared) == 26
    rng = np.random.RandomState(2)
    bev = rng.rand(1, 40, 40, 9).astype(np.float32)
    image = (rng.rand(1, 40, 48, 3) * 255).astype(np.float32)
    calib = np.zeros((1, 4, 12), np.float32)
    calib[:, 0, [0, 5, 10]] = 1
    calib[:, 2, [0, 4, 8]] = 1
    calib[:, 3, [1, 6, 8]] = [-1, -1, 1]
    out = detect(params_from_jax(trunks["P"], device="cpu"), bev, image,
                 calib)
    assert len(prepared) == 26 and torch.isfinite(out["scores"]).all()
    for key in ("trunk_bv", "trunk_img"):
        jt = trunks["jstate"][key]
        assert set(state[key]) == set(jt)
        for name, p in state[key].items():
            assert set(p) == set(jt[name])
            for leaf, v in p.items():
                want = np.asarray(jt[name][leaf])
                assert v.numpy().dtype == want.dtype, (name, leaf)
                np.testing.assert_array_equal(v.numpy(), want)


@pytest.mark.parametrize("w_shape, what", [
    ((32, 9 * 9), "prepare_s8_conv_weight"),   # C not padded as prepared
    ((32, 9 * 128), "prepare_s8_conv_weight"),
    ((32, 9 * 64), "CUDA device"),             # the right operand, on the CPU
])
def test_cuda_wrapper_refuses(w_shape, what):
    """conv3x3_s8_nk_cuda refuses an operand that is not the prepared one
    of x, and CPU tensors; conv3x3_s8_cuda refuses CPU tensors too. Neither
    falls back to the plain version, and the kernel's launch count stays
    put."""
    x = torch.zeros(1, 4, 4, 9, dtype=torch.int8)
    w_nk = torch.zeros(w_shape, dtype=torch.int8)
    k, b = torch.ones(32), torch.zeros(32)
    before = conv3x3_s8_cuda.launches
    with pytest.raises(ValueError, match=what):
        conv3x3_s8_nk_cuda(x, w_nk, k, b)
    with pytest.raises(ValueError, match="CUDA device"):
        conv3x3_s8_cuda(x, torch.zeros(3, 3, 9, 32, dtype=torch.int8), k, b)
    assert conv3x3_s8_cuda.launches == before


def test_plain_refuses_a_wrong_operand():
    """The dispatch's plain route holds w_nk to the same rule: an HWIO
    weight, or one not padded as prepared, is refused."""
    x = torch.zeros(1, 4, 4, 9, dtype=torch.int8)
    k, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="prepare_s8_conv_weight"):
        S8.conv3x3_s8_nk(x, torch.zeros(16, 81, dtype=torch.int8), k, b)
    with pytest.raises(ValueError):
        S8.conv3x3_s8_nk(x, torch.zeros(3, 3, 9, 16, dtype=torch.int8), k, b)
    with pytest.raises(TypeError):
        S8.conv3x3_s8_nk(x, torch.zeros(16, 576, dtype=torch.int32), k, b)
