"""The prepared-weight s8 2x2 VALID conv (ops/conv_s8.py:
prepare_s8_conv2x2_weight, conv2x2_s8_nk_plain, the conv2x2_s8_nk dispatch)
against the JAX package's conv2x2_s8_pallas in interpret mode under jit,
bit for bit; the s2d int8 stem's weights prepared once per view
(quant.prepare_s2d_stem_int8, s2d_stem_weights) against the per-call
values and JAX's in-graph ones (the built detector preparing them once:
tests/test_torch_quant.py); and the refusals of the CUDA wrapper
(ops/conv_s8_cuda.conv2x2_s8_nk_cuda). The kernel itself runs on the card
(chip_smoke.py:phase_conv_s8)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu import quant as JQ  # noqa: E402
from mv3d_tf_tpu.ops.conv_s8_pallas import conv2x2_s8_pallas  # noqa: E402
from mv3d_tf_tpu.ops.stem_s2d import pack_stem_weights as j_pack  # noqa
from mv3d_tf_tpu_torch import quant as Q  # noqa: E402
from mv3d_tf_tpu_torch.models import vgg  # noqa: E402
from mv3d_tf_tpu_torch.ops import conv_s8 as S8  # noqa: E402
from mv3d_tf_tpu_torch.ops.conv_s8_cuda import (conv2x2_s8_cuda,  # noqa: E402
                                                conv2x2_s8_nk_cuda)
from mv3d_tf_tpu_torch.ops.stem_s2d import hwio, pack_stem_weights  # noqa
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax,
                                             quant_state_from_jax)

_T = torch.from_numpy
VIEWS = [("trunk_bv", ""), ("trunk_img", "_2")]


def _case(seed, B, H, W, C, N):
    """Post-ReLU s8 activations, symmetric s8 weights, requant k and b as
    the stem has them (tests/test_torch_conv_s8.py:_case)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 128, (B, H, W, C)).astype(np.int8)
    w = rng.randint(-127, 128, (2, 2, C, N)).astype(np.int8)
    k = (rng.rand(N) * 2e-3 + 1e-4).astype(np.float32)
    b = (rng.rand(N) - 0.5).astype(np.float32)
    return x, w, k, b


@pytest.mark.parametrize("C, cp", [(9, 64), (96, 128), (256, 256)])
def test_prepared_conv2x2_weight_layout(C, cp):
    """(2,2,C,N) HWIO -> (N, 4*Cp): output channel major, the reduction in
    (dy, dx, c) order, C zero-padded to a multiple of 64, a fresh contiguous
    tensor; the weight it came from is left as it is."""
    _, w, _, _ = _case(C, 1, 1, 1, C, 48)
    w_nk = S8.prepare_s8_conv2x2_weight(_T(w))
    assert w_nk.dtype == torch.int8 and tuple(w_nk.shape) == (48, 4 * cp)
    assert w_nk.is_contiguous() and S8.conv_channels(C) == cp
    blocks = w_nk.numpy().reshape(48, 2, 2, cp)
    np.testing.assert_array_equal(blocks[..., :C], w.transpose(3, 0, 1, 2))
    assert not blocks[..., C:].any()
    again = _T(w.copy())
    S8.prepare_s8_conv2x2_weight(again)
    np.testing.assert_array_equal(again.numpy(), w)
    with pytest.raises(TypeError):
        S8.prepare_s8_conv2x2_weight(torch.zeros(3, 3, C, 48,
                                                 dtype=torch.int8))


@pytest.mark.parametrize("out_dtype", ["int8", "float32"])
@pytest.mark.parametrize("shape", [
    (1, 9, 11, 256, 256),     # the packed stem's 256 -> 256, odd map
    (2, 7, 13, 96, 48),       # ragged: C padded to 128, N under one tile
    (2, 6, 2, 128, 128),      # W = 2: one output column
])
def test_nk_plain_matches_pallas_and_plain(shape, out_dtype):
    """conv2x2_s8_nk_plain on the prepared weight equals JAX's
    conv2x2_s8_pallas (interpret mode, under jax.jit, on operands
    zero-padded to its 128-multiples) and conv2x2_s8_plain, bit for bit,
    with the int8 requant and the float32 dequant + ReLU epilogues."""
    B, H, W, C, N = shape
    x, w, k, b = _case(C + N, B, H, W, C, N)
    cq, nq = -(-C // 128) * 128, -(-N // 128) * 128
    x_p = np.zeros(x.shape[:3] + (cq,), np.int8)
    x_p[..., :C] = x
    w_p = np.zeros((2, 2, cq, nq), np.int8)
    w_p[:, :, :C, :N] = w
    k_p, b_p = np.ones(nq, np.float32), np.zeros(nq, np.float32)
    k_p[:N], b_p[:N] = k, b
    pallas = jax.jit(functools.partial(
        conv2x2_s8_pallas, tile_rows=4, interpret=True,
        out_dtype=getattr(jnp, out_dtype)))
    want = np.asarray(pallas(*map(jnp.asarray, (x_p, w_p, k_p, b_p))))[..., :N]
    dt = getattr(torch, out_dtype)
    got = S8.conv2x2_s8_nk(_T(x), S8.prepare_s8_conv2x2_weight(_T(w)), _T(k),
                           _T(b), dt)
    assert got.dtype == dt and tuple(got.shape) == (B, H - 1, W - 1, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        S8.conv2x2_s8_plain(*map(_T, (x, w, k, b)), out_dtype=dt).numpy(),
        want)
    if dt == torch.int8:
        assert 0.05 < ((want > 0) & (want < 127)).mean()


@pytest.fixture(scope="module")
def stems():
    """He-scaled params with nonzero biases, both trunks quantized by the
    JAX package from fixed activation scales, and the port's state."""
    P = he_normal_params(5, fc_dim=8)
    rng = np.random.RandomState(5)
    for name in P:
        P[name]["biases"] = (rng.randn(*P[name]["biases"].shape)
                             * 0.1).astype(np.float32)
    jstate = {"use_stem": True, "head": None}
    for key, suffix in VIEWS:
        scales = {"__input__": 1.0 / 127}
        scales.update({name: float(0.01 + 0.03 * rng.rand())
                       for name, _, _ in vgg.VGG_LAYERS})
        jstate[key] = JQ.quantize_trunk(P, scales, suffix=suffix)
    return dict(P=P, params=params_from_jax(P, device="cpu"), jstate=jstate,
                state=quant_state_from_jax(jstate, "cpu"))


@pytest.mark.parametrize("key, suffix", VIEWS)
def test_prepared_stem_k_and_b_bit_identical(stems, key, suffix):
    """prepare_s2d_stem_int8's conv1_2 operand: its k = s1*s_w/s2 and
    b = tile(b2, 4)/s2 have the bits of the per-call s2d_conv1_2_int8 (the
    same tensor ops on the state) and of JAX's in-graph quantization under
    jit (quant.py:499-507), and its weight is JAX's K2q laid out by
    prepare_s8_conv2x2_weight; K1 and B1 are the bf16 packed conv1_1."""
    qt = stems["state"][key]
    pw = Q.prepare_s2d_stem_int8(stems["params"], qt, suffix)
    w1, b1 = vgg.layer(stems["params"], "conv1_1" + suffix)
    w2, b2 = vgg.layer(stems["params"], "conv1_2" + suffix)
    with torch.no_grad():
        K1, B1, K2, _ = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
        K2q, s_w = Q._quantize_weights_t(K2.float())
        s1, s2 = qt["conv1_1"]["s_out"], qt["conv1_2"]["s_out"]
        k, b = s1 * s_w / s2, b2.float().repeat(4) / s2
    op = pw["conv1_2"]
    assert torch.equal(op["k"], k) and torch.equal(op["b"], b)
    assert torch.equal(op["w_nk"], S8.prepare_s8_conv2x2_weight(K2q))
    assert torch.equal(pw["K1"], K1.to(torch.bfloat16))
    assert torch.equal(pw["B1"], B1.to(torch.bfloat16))
    assert not op["k"].requires_grad and not pw["K1"].requires_grad

    @jax.jit
    def in_graph(p1, p2, q):
        _, _, K2j, _ = j_pack(p1["weights"], p1["biases"], p2["weights"],
                              p2["biases"])
        K2f = K2j.astype(jnp.float32)
        sw = jnp.maximum(jnp.max(jnp.abs(K2f).reshape(-1, K2f.shape[-1]),
                                 axis=0) / 127.0, 1e-12)
        K2qj = jnp.clip(jnp.round(K2f / sw), -127, 127).astype(jnp.int8)
        s1j, s2j = q["conv1_1"]["s_out"], q["conv1_2"]["s_out"]
        return (K2qj, (s1j * sw / s2j).astype(jnp.float32),
                (jnp.tile(p2["biases"], 4) / s2j).astype(jnp.float32))

    P = stems["P"]
    jk2q, jk, jb = in_graph(P["conv1_1" + suffix], P["conv1_2" + suffix],
                            stems["jstate"][key])
    np.testing.assert_array_equal(K2q.numpy(), np.asarray(jk2q))
    np.testing.assert_array_equal(op["k"].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(op["b"].numpy(), np.asarray(jb))


def test_stem_cache_follows_the_params(stems, monkeypatch):
    """s2d_stem_weights prepares once for the same params and state, again
    for other params or after an in-place change of a conv1 tensor, and
    again for another conv1 scale of the state or after an in-place change
    of one."""
    calls = []
    prepare = Q.prepare_s2d_stem_int8
    monkeypatch.setattr(Q, "prepare_s2d_stem_int8",
                        lambda *a: calls.append(a[2]) or prepare(*a))
    qt, params = stems["state"]["trunk_bv"], stems["params"]
    cache = {}
    first = Q.s2d_stem_weights(cache, params, qt)
    assert Q.s2d_stem_weights(cache, params, qt) is first and calls == [""]
    other = params_from_jax(stems["P"], device="cpu")
    Q.s2d_stem_weights(cache, other, qt)
    assert len(calls) == 2
    w2, _ = vgg.layer(other, "conv1_2")
    with torch.no_grad():
        w2.mul_(2.0)
    again = Q.s2d_stem_weights(cache, other, qt)
    assert len(calls) == 3
    assert not torch.equal(again["conv1_2"]["k"], first["conv1_2"]["k"])
    # a recalibrated state: another conv1_2 scale, then one changed in place
    recal = {**qt, "conv1_2": {**qt["conv1_2"],
                               "s_out": qt["conv1_2"]["s_out"] * 2}}
    moved = Q.s2d_stem_weights(cache, other, recal)
    assert len(calls) == 4
    assert torch.equal(moved["conv1_2"]["k"], again["conv1_2"]["k"] / 2)
    with torch.no_grad():
        recal["conv1_2"]["s_out"].mul_(2.0)
    Q.s2d_stem_weights(cache, other, recal)
    assert len(calls) == 5


@pytest.mark.parametrize("w_shape, what", [
    ((48, 4 * 96), "prepare_s8_conv2x2_weight"),   # C not padded
    ((48, 9 * 128), "prepare_s8_conv2x2_weight"),  # a 3x3 operand
    ((48, 4 * 128), "CUDA device"),                # the right one, on the CPU
])
def test_cuda_wrapper_refuses(w_shape, what):
    """conv2x2_s8_nk_cuda refuses an operand that is not the prepared one
    of x, and CPU tensors; conv2x2_s8_cuda refuses CPU tensors too. Neither
    falls back to the plain version, and the kernel's launch count stays
    put."""
    x = torch.zeros(1, 4, 4, 96, dtype=torch.int8)
    w_nk = torch.zeros(w_shape, dtype=torch.int8)
    k, b = torch.ones(48), torch.zeros(48)
    before = conv2x2_s8_cuda.launches
    with pytest.raises(ValueError, match=what):
        conv2x2_s8_nk_cuda(x, w_nk, k, b)
    with pytest.raises(ValueError, match="CUDA device"):
        conv2x2_s8_cuda(x, torch.zeros(2, 2, 96, 48, dtype=torch.int8), k, b)
    assert conv2x2_s8_cuda.launches == before


def test_plain_refuses_a_wrong_operand():
    """The dispatch's plain route holds w_nk to the same rule: an HWIO
    weight, or one not padded as prepared, is refused."""
    x = torch.zeros(1, 4, 4, 96, dtype=torch.int8)
    k, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="prepare_s8_conv2x2_weight"):
        S8.conv2x2_s8_nk(x, torch.zeros(16, 4 * 96, dtype=torch.int8), k, b)
    with pytest.raises(ValueError):
        S8.conv2x2_s8_nk(x, torch.zeros(2, 2, 96, 16, dtype=torch.int8), k, b)
    with pytest.raises(TypeError):
        S8.conv2x2_s8_nk(x, torch.zeros(16, 512, dtype=torch.int32), k, b)
