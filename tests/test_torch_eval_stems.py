"""The float batched detector with the space-to-depth stems
(eval.build_detect_batch_fn(stem_impl=...)) against the JAX package's on
CPU, float32, on the He-scaled case of tests/test_torch_eval.py. JAX's
fused s2d stem runs its Pallas kernel in interpret mode."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu.eval import build_detect_batch_fn as j_detect_batch  # noqa
from mv3d_tf_tpu.ops import stem_s2d_pallas as JP  # noqa: E402
from mv3d_tf_tpu_torch.eval import build_detect_batch_fn  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)
from test_torch_eval import HE, HE_FRAMES, HE_SEED, _frame  # noqa: E402


@pytest.fixture(scope="module")
def case():
    P = he_normal_params(HE_SEED, fc_dim=64)
    frames = [np.stack(x) for x in zip(*[_frame(f) for f in HE_FRAMES])]
    return P, params_from_jax(P, device="cpu"), frames


@pytest.mark.parametrize("stem", ["s2d", "s2d_fused"])
def test_float_detector_stem_matches_jax(case, monkeypatch, stem):
    """Same valid slots, scores within 1e-3 and regressed corners within
    1e-2 m: the stems sum the same float32 products in other orders."""
    monkeypatch.setattr(JP, "stem_s2d_fused",
                        functools.partial(JP.stem_s2d_fused, interpret=True))
    P, params, frames = case
    kw = dict(HE, nms_impl="blocked_fixed", stem_impl=stem)
    want = {k: np.asarray(v) for k, v in
            j_detect_batch(**kw)(P, *frames).items()}
    got = {k: v.numpy() for k, v in
           build_detect_batch_fn(**kw)(params, *frames).items()}
    assert set(got) == set(want)
    assert got["nms_converged"].tolist() == [True, True]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 10
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3)
    np.testing.assert_allclose(got["boxes_cnr_r"], want["boxes_cnr_r"],
                               atol=1e-2)


def test_bf16_default_stem_is_the_fused_one(case):
    """stem_impl None in bfloat16 is the fused literal stem, as before."""
    _, params, frames = case
    kw = dict(HE, compute_dtype=torch.bfloat16)
    a = build_detect_batch_fn(**kw)(params, *frames)
    b = build_detect_batch_fn(stem_impl="fused", **kw)(params, *frames)
    for k in a:
        assert torch.equal(a[k], b[k]), k
