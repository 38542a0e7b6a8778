"""The port's int8 PTQ path (quant.py, eval.build_detect_batch_fn(quant=))
against the JAX package's on CPU, He-scaled params with fc_dim 64, frames
of 40x40 (BEV) and 40x48 (image).

What is integer, or the one fused multiply-add XLA makes of the requant
epilogue under jit, is held bit for bit given the same inputs: JAX's quant
state and codes are handed to the port. What runs a bf16 convolution or
matmul (calibration, the packed conv1_1, the 1x1 RPN heads, cls/bbox) is
held within a stated tolerance, since the two frameworks' bf16 kernels
round at other places."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402
from mv3d_tf_tpu import quant as JQ  # noqa: E402
from mv3d_tf_tpu.eval import PIXEL_MEANS  # noqa: E402
from mv3d_tf_tpu.eval import build_detect_batch_fn as j_detect_batch  # noqa
from mv3d_tf_tpu.ops.stem_s2d import _mask_edges as j_mask_edges  # noqa
from mv3d_tf_tpu.ops.stem_s2d import pack_stem_weights as j_pack  # noqa
from mv3d_tf_tpu_torch import quant as Q  # noqa: E402
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn  # noqa: E402
from mv3d_tf_tpu_torch.ops import conv_s8 as S8  # noqa: E402
from mv3d_tf_tpu_torch.ops.stem_s2d import hwio, pack_stem_weights  # noqa
from mv3d_tf_tpu_torch.models import vgg  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax,
                                             quant_state_from_jax,
                                             quant_state_to_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, B = 3, 2
SMALL = dict(feat_h=5, feat_w=5, pre_nms_top_n=30, post_nms_top_n=8)
VIEWS = [("trunk_bv", "", "bev"), ("trunk_img", "_2", "img_ms")]
_T = torch.from_numpy


def _np(x):
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else \
        np.asarray(x)


@pytest.fixture(scope="module")
def case():
    """He-scaled params in both layouts, B=2 frames, and JAX's quant state
    with an int8 head calibrated on its pooled features."""
    P = he_normal_params(SEED, fc_dim=64)
    rng = np.random.RandomState(SEED)
    bev = rng.rand(B, 40, 40, 9).astype(np.float32)
    image = (rng.rand(B, 40, 48, 3) * 255).astype(np.float32)
    img_ms = image - PIXEL_MEANS
    # the example calib with its image rows scaled by 1/26, so that the
    # projected rois land in the 40x48 image (1242 -> 48 columns)
    calib = _example_calib()
    calib[0, :8] /= 26
    calib[1] = calib[0]
    calib = np.tile(calib[None], (B, 1, 1))
    pooled = [np.asarray(p, np.float32) for p in JQ.calibrate_pooled_features(
        P, bev, img_ms, calib, feat_h=5, feat_w=5, post_nms_top_n=8)]
    jstate = JQ.build_quant_state(P, bev, img_ms, *pooled)
    return dict(P=P, params=params_from_jax(P, device="cpu"), bev=bev,
                image=image, img_ms=img_ms, calib=calib, pooled=pooled,
                jstate=jstate, state=quant_state_from_jax(jstate, "cpu"))


def _assert_tree_equal(got, want, path="q"):
    """Same keys, dtypes and values; None where None."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], path + "/" + k)
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# --- calibration and weight quantization -----------------------------------

@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_quantize_trunk_equals_jax(case, key, suffix, frames):
    """Given the same activation scales, the int8 trunk (HWIO w_q, bias,
    s_w, s_in, s_out) is the JAX package's, leaf for leaf."""
    scales = JQ.calibrate_trunk(case["P"], case[frames], suffix=suffix)
    got = Q.quantize_trunk(case["params"], scales, suffix=suffix)
    _assert_tree_equal(got, JQ.quantize_trunk(case["P"], scales,
                                              suffix=suffix))
    _assert_tree_equal(got, case["jstate"][key])


@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_calibrate_trunk_tracks_jax(case, key, suffix, frames):
    """The input scale is exact (a max of the same floats); each layer's
    scale is a max over a bf16 trunk, whose convs round at other places in
    the two frameworks: within 2% over the 13 layers."""
    want = JQ.calibrate_trunk(case["P"], case[frames], suffix=suffix)
    got = Q.calibrate_trunk(case["params"], case[frames], suffix=suffix)
    assert set(got) == set(want)
    assert got["__input__"] == want["__input__"]
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=2e-2), name


def test_calibrate_and_quantize_head_match_jax(case):
    """Head scales from the same pooled features: the pooled ones exact,
    fc6/fc7 within 2% (bf16 matmuls); given JAX's scales, the int8 head is
    JAX's leaf for leaf."""
    want = JQ.calibrate_head(case["P"], *map(jnp.asarray, case["pooled"]))
    got = Q.calibrate_head(case["params"], *map(_T, case["pooled"]))
    assert set(got) == set(want)
    for name in want:
        rel = 0 if name.startswith("pooled") else 2e-2
        assert got[name] == pytest.approx(want[name], rel=rel), name
    _assert_tree_equal(Q.quantize_head(case["params"], want),
                       case["jstate"]["head"])


# --- the int8 trunk, bit for bit given JAX's codes --------------------------

def _j_stem(case, key, suffix, frames):
    return jax.jit(lambda q, x: JQ._s2d_stem_int8(case["P"], q, x, suffix))(
        case["jstate"][key], case[frames])


@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_trunk_from_stem_q_bit_identical(case, key, suffix, frames):
    """conv2_1 .. conv5_3 from JAX's s2d stem codes: the same int8 features
    and scale as JAX's trunk under jit."""
    stem_q, _ = _j_stem(case, key, suffix, frames)
    want, s_want = jax.jit(JQ.trunk_apply_int8_from_stem_q)(
        case["jstate"][key], stem_q)
    qt = case["state"][key]
    got, s_got = Q.trunk_apply_int8_from_stem_q(qt, _T(np.array(stem_q)),
                                                Q.prepare_trunk_weights(qt))
    assert got.dtype == torch.int8 and float(s_got) == float(s_want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < (got.numpy() > 0).mean() < 1


@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_trunk_apply_int8_from_the_input_bit_identical(case, key, suffix,
                                                        frames):
    """The "int8" stem: the float input quantized at conv1_1's input scale,
    all 13 convs in s8 (conv1_1's 9 or 3 channels included): bit for bit."""
    want, _ = jax.jit(JQ.trunk_apply_int8)(case["jstate"][key], case[frames])
    qt = case["state"][key]
    got, _ = Q.trunk_apply_int8(qt, _T(case[frames]),
                                Q.prepare_trunk_weights(qt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trunk_from_bf16_stem_bit_identical(case):
    """A bf16 stem output (JAX's literal stem) quantized at conv1_2's scale,
    then the s8 tail: bit for bit."""
    q = case["jstate"]["trunk_bv"]
    stem = jax.jit(lambda x: JQ._bf16_stem(case["P"], x))(case["bev"])
    want, _ = jax.jit(JQ.trunk_apply_int8_from_stem)(q, stem)
    qt = case["state"]["trunk_bv"]
    got, _ = Q.trunk_apply_int8_from_stem(qt, _T(_np(stem)).to(torch.bfloat16),
                                          Q.prepare_trunk_weights(qt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _j_conv1_1_codes(P, q, x, suffix):
    """The JAX package's packed conv1_1 and its codes, quant.py:480-498."""
    p1, p2 = P["conv1_1" + suffix], P["conv1_2" + suffix]
    K1, B1, _, _ = j_pack(p1["weights"], p1["biases"], p2["weights"],
                          p2["biases"])
    _, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    y = jax.lax.conv_general_dilated(
        x.astype(jnp.bfloat16), K1.astype(jnp.bfloat16), (2, 2),
        ((2, 2 * Ho + 2 - H), (2, 2 * Wo + 2 - W)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = j_mask_edges(jax.nn.relu(y + B1.astype(jnp.bfloat16)), H, W,
                     p1["weights"].shape[3])
    return jnp.clip(jnp.round(y.astype(jnp.float32) / q["conv1_1"]["s_out"]),
                    0, 127).astype(jnp.int8)


@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_s2d_conv1_2_int8_bit_identical(case, key, suffix, frames):
    """The packed conv1_2 in s8 and the group max, given JAX's conv1_1
    codes y_q: the JAX s2d int8 stem's output, bit for bit."""
    q = case["jstate"][key]
    y_q = jax.jit(lambda q, x: _j_conv1_1_codes(case["P"], q, x, suffix))(
        q, case[frames])
    want, _ = _j_stem(case, key, suffix, frames)
    w1, b1 = vgg.layer(case["params"], "conv1_1" + suffix)
    w2, b2 = vgg.layer(case["params"], "conv1_2" + suffix)
    _, _, K2, _ = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
    qt = case["state"][key]
    with torch.no_grad():
        got = Q.s2d_conv1_2_int8(_T(np.array(y_q)), K2, b2,
                                 qt["conv1_1"]["s_out"],
                                 qt["conv1_2"]["s_out"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key, suffix, frames", VIEWS)
def test_s2d_int8_stem_codes_track_jax(case, key, suffix, frames):
    """The whole s2d int8 stem from the input: its packed conv1_1 runs in
    bf16, so a code can move by one where the two frameworks' bf16 convs
    round apart; nearly all codes agree exactly (the statistics of
    tests/test_quant.py:177-178, made stricter)."""
    want, s_want = _j_stem(case, key, suffix, frames)
    with torch.no_grad():
        qt = case["state"][key]
        got, s_got = Q._s2d_stem_int8(
            qt, _T(case[frames]),
            Q.prepare_s2d_stem_int8(case["params"], qt, suffix))
    assert float(s_got) == float(s_want)
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99, (
        diff.max(), (diff == 0).mean())


# --- the int8 RPN and head --------------------------------------------------

def _j_feat(case):
    stem_q, _ = _j_stem(case, "trunk_bv", "", "bev")
    return jax.jit(JQ.trunk_apply_int8_from_stem_q)(
        case["jstate"]["trunk_bv"], stem_q)


def test_rpn_conv_int8_bit_identical(case):
    """The RPN's s8 3x3 conv with its float32 dequant + ReLU epilogue,
    quant.py:558-588 under jit, bit for bit; the bf16 1x1 heads after it
    within bf16 rounding (2^-6 of the largest magnitude)."""
    P = case["P"]
    feat_q, s = _j_feat(case)

    def j_conv(p, feat_q, s_in):       # quant.py:558-588, the CPU branch
        w = p["weights"].astype(jnp.float32)
        s_w = jnp.maximum(jnp.max(jnp.abs(w).reshape(-1, w.shape[-1]),
                                  axis=0) / 127.0, 1e-12)
        w_q = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
        y32 = JQ._conv_s8_im2col(feat_q, w_q)
        return jnp.maximum(y32.astype(jnp.float32) * (s_in * s_w)
                           + p["biases"].astype(jnp.float32), 0.0)

    want = np.asarray(jax.jit(j_conv)(P["rpn_conv/3x3"], feat_q, s))
    feat_t, s_t = _T(np.array(feat_q)), torch.tensor(np.asarray(s))
    with torch.no_grad():
        got = Q.rpn_conv_int8(case["params"], feat_t, s_t)
        cls, box = Q.rpn_head_int8(case["params"], feat_t, s_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    j_cls, j_box = jax.jit(lambda f, s: JQ.rpn_head_int8(P, f, s))(feat_q, s)
    for g, w in ((cls, j_cls), (box, j_box)):
        w = _np(w)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -6 * np.abs(w).max())


@pytest.mark.parametrize("view", ["1", "2"])
def test_fc_int8_bit_identical(case, view):
    """fc6 and fc7 of one view in s8 with the requant between them,
    quant.py:360-365 under jit, given the same pooled codes (the
    calibration features at their calibrated scale): bit for bit."""
    head = case["jstate"]["head"]
    s_in = np.asarray(head["scales"][("pooled_bv", "pooled_img")[
        int(view) - 1]])
    codes = np.clip(np.round(case["pooled"][int(view) - 1] / s_in), 0,
                    127).astype(np.int8)

    def j_fc(head, x, s_in):
        sc = head["scales"]
        f = JQ._fc_s8(x.reshape(x.shape[0], -1), head["fc6_" + view], s_in)
        f = jnp.clip(jnp.round(f / sc["fc6_" + view]), 0, 127)
        return JQ._fc_s8(f.astype(jnp.int8), head["fc7_" + view],
                         sc["fc6_" + view])

    want = np.asarray(jax.jit(j_fc)(head, codes, s_in))
    with torch.no_grad():
        got = Q.fc_int8(case["state"]["head"], _T(codes),
                        torch.tensor(s_in), view,
                        Q.prepare_head_weights(case["state"]["head"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (codes > 0).mean() > 0.2 and (want > 0).mean() > 0.2


def _j_fc_pair(head, view):
    """JAX's fc6 -> requant -> fc7 of one view (quant.py:360-365), jitted."""
    def fc(head, x, s_in):
        sc = head["scales"]
        f = JQ._fc_s8(x.reshape(x.shape[0], -1), head["fc6_" + view], s_in)
        f = jnp.clip(jnp.round(f / sc["fc6_" + view]), 0, 127)
        return JQ._fc_s8(f.astype(jnp.int8), head["fc7_" + view],
                         sc["fc6_" + view])
    return jax.jit(fc)


def test_detector_head_on_prepared_weights_matches_jax(case, monkeypatch):
    """build_detect_batch_fn(quant=state) lays the four fc weights out for
    the GEMM once, when it is built, and its int8 head then runs on them
    (no layout per call): each view's fc6/fc7 output, given the pooled
    codes the detector produced, equals JAX's _fc_s8 pair under jit on
    JAX's state, bit for bit."""
    prepared, seen = [], []
    prepare = S8.prepare_s8_gemm_weight
    fc_int8 = Q.fc_int8

    def counting_prepare(b):
        prepared.append(tuple(b.shape))
        return prepare(b)

    def recording_fc(qhead, pooled_q, s_in, view, weights_nk):
        out = fc_int8(qhead, pooled_q, s_in, view, weights_nk)
        seen.append((view, pooled_q.clone(), s_in, weights_nk, out))
        return out

    monkeypatch.setattr(S8, "prepare_s8_gemm_weight", counting_prepare)
    monkeypatch.setattr(Q, "fc_int8", recording_fc)
    detect = build_detect_batch_fn(quant=case["state"], stem_impl="s2d_int8",
                                   quant_rpn=True, **SMALL)
    assert len(prepared) == 4
    detect(case["params"], case["bev"], case["image"], case["calib"])
    assert len(prepared) == 4 and [v for v, *_ in seen] == ["1", "2"]
    head = case["jstate"]["head"]
    for view, codes, s_in, w_nk, got in seen:
        assert set(w_nk) == set(Q.FC_LAYERS)
        assert tuple(w_nk["fc6_" + view].shape) == tuple(
            case["state"]["head"]["fc6_" + view]["w_q"].shape[::-1])
        want = _j_fc_pair(head, view)(head, codes.numpy(),
                                      np.asarray(s_in, np.float32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (codes > 0).float().mean() > 0.05


def test_building_the_detector_leaves_the_state_as_jax(case):
    """The prepared copy lives in the built detector: after building and
    running it, the quant state still equals JAX's leaf for leaf, (in, out)
    fc weights included, with no new key."""
    detect = build_detect_batch_fn(quant=case["state"], **SMALL)
    detect(case["params"], case["bev"], case["image"], case["calib"])
    _assert_tree_equal(case["state"], case["jstate"])
    assert tuple(case["state"]["head"]["fc6_1"]["w_q"].shape) == tuple(
        np.asarray(case["jstate"]["head"]["fc6_1"]["w_q"]).shape)


def test_fusion_head_int8_tracks_jax(case):
    """The whole int8 head: its cls/bbox matmuls run in bf16, so the class
    probabilities agree within 2e-2 and bbox deltas within 2^-6 of their
    scale."""
    head = case["jstate"]["head"]
    rng = np.random.RandomState(7)
    bv, img = (rng.randint(0, 128, (12, 7, 7, 512)).astype(np.int8)
               for _ in range(2))
    s_bv, s_img = np.float32(0.02), np.float32(0.03)
    _, j_prob, j_box = jax.jit(
        lambda h, a, b: JQ.fusion_head_int8(case["P"], h, a, s_bv, b, s_img))(
            head, bv, img)
    with torch.no_grad():
        _, prob, box = Q.fusion_head_int8(
            case["params"], case["state"]["head"], _T(bv), torch.tensor(s_bv),
            _T(img), torch.tensor(s_img),
            Q.prepare_head_weights(case["state"]["head"]))
    np.testing.assert_allclose(prob.numpy(), np.asarray(j_prob), atol=2e-2)
    j_box = _np(j_box)
    np.testing.assert_allclose(box.float().numpy(), j_box, rtol=0,
                               atol=2.0 ** -6 * np.abs(j_box).max())


# --- the state file, both ways ---------------------------------------------

@pytest.mark.parametrize("with_head", [False, True])
def test_quant_state_file_serves_both_packages(case, with_head, tmp_path):
    """JAX's save_quant_state -> the port's load_quant_state, and the port's
    save -> JAX's load: the same keys, dtypes and values, a missing head
    kept as None."""
    jstate = dict(case["jstate"])
    if not with_head:
        jstate["head"] = None
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JQ.save_quant_state(jpath, jstate)
    loaded = Q.load_quant_state(jpath, device="cpu")
    want = JQ.load_quant_state(jpath)
    _assert_tree_equal(loaded, want)
    assert (loaded["head"] is None) == (not with_head)
    Q.save_quant_state(tpath, loaded)
    _assert_tree_equal(JQ.load_quant_state(tpath), want)


def test_quant_state_conversion_round_trip(case):
    state = case["state"]
    assert state["trunk_bv"]["conv1_1"]["w_q"].dtype == torch.int8
    assert state["trunk_bv"]["conv1_1"]["s_in"].dim() == 0
    _assert_tree_equal(quant_state_from_jax(quant_state_to_jax(state), "cpu"),
                       quant_state_to_jax(state))


# --- the int8 batch detector ------------------------------------------------

def _detectors(case, **kw):
    want = j_detect_batch(quant=case["jstate"], **SMALL, **kw)(
        case["P"], case["bev"], case["image"], case["calib"])
    got = build_detect_batch_fn(quant=case["state"], **SMALL, **kw)(
        case["params"], case["bev"], case["image"], case["calib"])
    return ({k: _np(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_int8_detector_matches_jax(case):
    """The bench configuration (s2d_int8 stem, int8 RPN, int8 pool and head,
    blocked_fixed NMS) on JAX's state: the same keys and valid slots.
    Scores within 1e-3 and regressed corners within 1e-2 m: the heads run
    in bf16, where the two frameworks may round a logit or a delta one
    bf16 ulp apart (measured here: 2e-9 and 4e-6; the stem codes agree)."""
    want, got = _detectors(case, stem_impl="s2d_int8", quant_rpn=True,
                           nms_impl="blocked_fixed")
    assert set(got) == set(want)
    assert got["nms_converged"].tolist() == [True] * B
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["boxes_cnr_r"], want["boxes_cnr_r"],
                               atol=1e-2)


def test_int8_detector_prepares_its_stem_once(case, monkeypatch):
    """The built s2d_int8 detector prepares each view's packed conv1_2
    operand once across two calls (quant.s2d_stem_weights), and both calls
    hold test_int8_detector_matches_jax's comparison with JAX."""
    prepared = []
    prepare = S8.prepare_s8_conv2x2_weight
    monkeypatch.setattr(S8, "prepare_s8_conv2x2_weight",
                        lambda w: prepared.append(tuple(w.shape))
                        or prepare(w))
    kw = dict(stem_impl="s2d_int8", quant_rpn=True, nms_impl="blocked_fixed",
              **SMALL)
    want = j_detect_batch(quant=case["jstate"], **kw)(
        case["P"], case["bev"], case["image"], case["calib"])
    detect = build_detect_batch_fn(quant=case["state"], **kw)
    assert prepared == []
    outs = [detect(case["params"], case["bev"], case["image"], case["calib"])
            for _ in range(2)]
    assert len(prepared) == 2                   # one per view, once
    for got in outs:
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      _np(want["valid"]))
        np.testing.assert_allclose(got["scores"].numpy(),
                                   _np(want["scores"]), atol=1e-3)
        np.testing.assert_allclose(got["boxes_cnr_r"].numpy(),
                                   _np(want["boxes_cnr_r"]), atol=1e-2)
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_int8_detector_int8_stem_pool_false_matches_jax(case):
    """The "int8" stem makes the trunks integer from the input, so the
    features are bit-identical; quant_pool=False pools dequantized bf16 maps
    and requantizes for the int8 head. Same valid slots, scores within
    1e-3 (the bf16 RPN heads and cls/bbox, as above)."""
    want, got = _detectors(case, stem_impl="int8", quant_pool=False)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)


@pytest.mark.parametrize("stem", ["bf16", "s2d", "pallas", "int8",
                                  "s2d_fused", "literal", "fused"])
def test_int8_detector_stems_run(case, stem):
    """Every ported stem drives the int8 detector to finite outputs of the
    batch detector's shapes."""
    out = build_detect_batch_fn(quant=case["state"], stem_impl=stem,
                                **SMALL)(case["params"], case["bev"],
                                         case["image"], case["calib"])
    assert tuple(out["scores"].shape) == (B, 8, 2)
    assert torch.isfinite(out["scores"]).all() and out["valid"].any()


@pytest.mark.parametrize("jax_name, port_name", [("bf16", "literal"),
                                                 ("pallas", "fused")])
def test_int8_detector_stem_names_are_one_stem(case, jax_name, port_name):
    """The JAX package's name of a stem and the port's run one stem in the
    int8 detector (models/vgg.STEMS): every output equal bit for bit."""
    a, b = (build_detect_batch_fn(quant=case["state"], stem_impl=stem,
                                  **SMALL)(case["params"], case["bev"],
                                           case["image"], case["calib"])
            for stem in (jax_name, port_name))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_int8_detector_s2d_fused_matches_jax(case, monkeypatch):
    """The fused s2d stem in bf16 (JAX's Pallas kernel in interpret mode,
    the port's plain version on the CPU) feeding the int8 trunks, with the
    int8 RPN and blocked_fixed NMS, on JAX's state: the same keys and valid
    slots, scores within 1e-3 and regressed corners within 1e-2 m, the
    tolerances of test_int8_detector_matches_jax."""
    from mv3d_tf_tpu.ops import stem_s2d_pallas as JP
    monkeypatch.setattr(JP, "stem_s2d_fused",
                        functools.partial(JP.stem_s2d_fused, interpret=True))
    want, got = _detectors(case, stem_impl="s2d_fused", quant_rpn=True,
                           nms_impl="blocked_fixed")
    assert set(got) == set(want)
    assert got["nms_converged"].tolist() == [True] * B
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["boxes_cnr_r"], want["boxes_cnr_r"],
                               atol=1e-2)


def test_build_quant_state_on_the_port(case):
    """The port's own PTQ: calibration and head quantization on its own
    trunks give a state of JAX's shape that drives the detector."""
    img = _T(case["img_ms"])
    pooled = Q.calibrate_pooled_features(case["params"], _T(case["bev"]), img,
                                         _T(case["calib"]), feat_h=5,
                                         feat_w=5, post_nms_top_n=8)
    state = Q.build_quant_state(case["params"], _T(case["bev"]), img, *pooled)
    want = case["jstate"]
    assert set(state) == set(want) and set(state["head"]) == set(want["head"])
    for key in ("trunk_bv", "trunk_img"):
        np.testing.assert_array_equal(
            state[key]["conv3_3"]["w_q"].numpy(),
            np.asarray(want[key]["conv3_3"]["w_q"]))
    out = build_detect_batch_fn(quant=state, stem_impl="s2d_int8",
                                quant_rpn=True, **SMALL)(
        case["params"], case["bev"], case["image"], case["calib"])
    assert torch.isfinite(out["scores"]).all()


def test_int8_detector_runs_without_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from mv3d_tf_tpu_torch import quant as Q\n"
        "from mv3d_tf_tpu_torch.eval import build_detect_batch_fn\n"
        "from mv3d_tf_tpu_torch.utils.weights import he_normal_params, "
        "params_from_jax\n"
        "p = params_from_jax(he_normal_params(0, fc_dim=8), device='cpu')\n"
        "rng = np.random.RandomState(0)\n"
        "bev = rng.rand(2, 40, 40, 9).astype(np.float32)\n"
        "img = (rng.rand(2, 40, 48, 3) * 255).astype(np.float32)\n"
        "cal = np.zeros((2, 4, 12), np.float32); cal[:, 0, [0, 5, 10]] = 1\n"
        "cal[:, 2, [0, 4, 8]] = 1; cal[:, 3, [1, 6, 8]] = [-1, -1, 1]\n"
        "state = Q.build_quant_state(p, bev, img - 100.0)\n"
        "det = build_detect_batch_fn(quant=state, stem_impl='s2d_int8',\n"
        "    quant_rpn=True, feat_h=5, feat_w=5, pre_nms_top_n=30,\n"
        "    post_nms_top_n=8)(p, bev, img, cal)\n"
        "assert det['scores'].shape == (2, 8, 2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
        "assert not bad, 'loaded: %s' % bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
