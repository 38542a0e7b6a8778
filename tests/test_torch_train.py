"""The port's train step against mv3d_tf_tpu's on CPU in float32, with
JAX's random draws (sample uniforms, dropout masks) reconstructed from the
step key and injected into the port: the losses, the fusion head in train
mode, one whole forward's losses and parameter gradients, the Adam update,
the device-resident step, and a run without jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from __graft_entry__ import _example_calib  # noqa: E402
from mv3d_tf_tpu import geometry as G  # noqa: E402
from mv3d_tf_tpu import targets as JT  # noqa: E402
from mv3d_tf_tpu import train as JTR  # noqa: E402
from mv3d_tf_tpu.eval import PIXEL_MEANS  # noqa: E402
from mv3d_tf_tpu.models import mv3d as JM  # noqa: E402
from mv3d_tf_tpu.proposals import proposal_layer_3d  # noqa: E402
from mv3d_tf_tpu_torch import train as TR  # noqa: E402
from mv3d_tf_tpu_torch.models import mv3d as TM  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_GT = 8
FC = 64
SMALL = dict(feat_h=10, feat_w=10, pre_nms_top_n=100, post_nms_top_n=30,
             rois_per_image=16)
# He-scaled params seed, frame seed and step key, chosen so that both
# packages sample the same rois (asserted below)
HE_SEED, FRAME_SEED, STEP_KEY = 21, 1, 1


def _t(a):
    return torch.tensor(np.asarray(a))


def _batch(seed):
    """One small frame (tests/test_train.py:_batch): 81x81 BEV, 88x120
    image, two gts equal to inside anchors, pad_gt padding."""
    from mv3d_tf_tpu.anchors import get_anchor_grid
    rng = np.random.RandomState(seed)
    grid = get_anchor_grid(10, 10)
    inside = np.where(grid.inside)[0]
    gt_bv = np.zeros((MAX_GT, 5), np.float32)
    gt_3d = np.zeros((MAX_GT, 7), np.float32)
    gt_3d[:, 3:6] = 1.0
    gt_cnr = np.zeros((MAX_GT, 25), np.float32)
    for i, a in enumerate((40, 200)):
        gt_bv[i, :4] = grid.anchors_bv[inside[a]]
        gt_3d[i, :6] = np.asarray(G.bv_anchor_to_lidar(gt_bv[i:i + 1, :4]))[0]
        gt_cnr[i, :24] = np.asarray(G.lidar_3d_to_corners(gt_3d[i:i + 1, :6]))[0]
        gt_bv[i, 4] = gt_3d[i, 6] = gt_cnr[i, 24] = 1.0
    return {
        "bev": rng.rand(81, 81, 9).astype(np.float32),
        "image": (rng.rand(88, 120, 3) * 255).astype(np.float32),
        "calib": _example_calib(),
        "gt_boxes_bv": gt_bv, "gt_boxes_3d": gt_3d,
        "gt_boxes_corners": gt_cnr, "gt_valid": np.arange(MAX_GT) < 2,
    }


def _jax_draws(key, n_anchors, n_all, n_rois, fc, keep_prob=0.5):
    """The draws the JAX step makes from its key (train.py:122,
    targets.py:90,155, mv3d.py:154), as the port's draws dict."""
    k_anchor, k_roi, k_drop = jax.random.split(key, 3)

    def uniforms(k, n):
        return [_t(jax.random.uniform(s, (n,))) for s in jax.random.split(k)]

    shapes = [(n_rois, fc)] * 4 + [(n_rois, 2 * fc)]
    a_fg, a_bg = uniforms(k_anchor, n_anchors)
    r_fg, r_bg = uniforms(k_roi, n_all)
    drop = tuple(_t(jax.random.bernoulli(k, keep_prob, s))
                 for k, s in zip(jax.random.split(k_drop, 5), shapes))
    return {"anchor_fg": a_fg, "anchor_bg": a_bg, "roi_fg": r_fg,
            "roi_bg": r_bg, "drop": drop}


def _grads_to_jax(params):
    """The port's parameter gradients in the JAX layout."""
    out = {}
    for key, m in params.items():
        w = m.weight.grad.numpy()
        out[key.replace("__", "/")] = {
            "weights": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T,
            "biases": m.bias.grad.numpy()}
    return out


def test_smooth_l1_matches_jax():
    x = np.linspace(-2, 2, 101).astype(np.float32)
    np.testing.assert_allclose(TR.smooth_l1(_t(x)).numpy(),
                               np.asarray(JTR.smooth_l1(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def _loss_inputs(rng, masking):
    if masking:   # tests/test_train.py:57-82
        labels = np.full(16, -1, np.int32)
        labels[:2] = [1, 0]
        tgt = np.zeros((16, 6), np.float32)
        tgt[0] = 1.0
        return (np.zeros((1, 2, 2, 8), np.float32),
                np.zeros((1, 2, 2, 24), np.float32), labels, tgt,
                np.zeros((4, 2), np.float32), np.zeros((4, 48), np.float32),
                np.array([1, 0, 0, 0], np.int32),
                np.zeros((4, 48), np.float32),
                np.array([True, True, False, False]))
    return (rng.randn(1, 3, 3, 8).astype(np.float32),
            rng.randn(1, 3, 3, 24).astype(np.float32),
            rng.randint(-1, 2, 36).astype(np.int32),
            rng.randn(36, 6).astype(np.float32),
            rng.randn(16, 2).astype(np.float32),
            (rng.randn(16, 48) * 0.2).astype(np.float32),
            rng.randint(0, 2, 16).astype(np.int32),
            (rng.randn(16, 48) * 0.2).astype(np.float32),
            rng.rand(16) > 0.3)


@pytest.mark.parametrize("masking", [True, False])
def test_compute_losses_match_jax(rng, masking):
    args = _loss_inputs(rng, masking)
    ref = JTR.compute_losses(*[jnp.asarray(a) for a in args])
    got = TR.compute_losses(*[_t(a) for a in args])
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    if masking:
        np.testing.assert_allclose(got["rpn_loss_box"].item(),
                                   6 * (1 - 0.5 / 9), rtol=1e-5)
        assert got["loss_box"].item() == 0.0


def test_fusion_head_train_matches_jax(rng):
    p = he_normal_params(3, fc_dim=FC)
    pooled = [rng.randn(12, 7, 7, 512).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(9)
    ref = JM.fusion_head(p, *pooled, keep_prob=0.5, rng=key, train=True)
    # the JAX head splits its key into k1..k5 and draws one mask from each
    shapes = [(12, FC)] * 4 + [(12, 2 * FC)]
    masks = tuple(_t(jax.random.bernoulli(k, 0.5, s))
                  for k, s in zip(jax.random.split(key, 5), shapes))
    params = params_from_jax(p, device="cpu")
    with torch.no_grad():
        got = TM.fusion_head(params, *map(_t, pooled), train=True,
                             masks=masks, keep_prob=0.5)
        plain = TM.fusion_head(params, *map(_t, pooled))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    assert not torch.allclose(got[0], plain[0])     # the masks did drop


@pytest.fixture(scope="module")
def jax_step():
    """JAX's forward losses and parameter gradients for one small step
    (one jit), and the sampled labels of its target layers."""
    p = he_normal_params(HE_SEED, fc_dim=FC)
    batch = _batch(FRAME_SEED)
    key = jax.random.PRNGKey(STEP_KEY)
    fwd = JTR.build_forward_losses(**SMALL)
    grads, metrics = jax.jit(jax.grad(
        lambda q: (lambda m: (m["loss"], m))(fwd(q, batch, key)),
        has_aux=True))(p)

    k_anchor, k_roi, _ = jax.random.split(key, 3)
    rpn_labels, _ = JT.anchor_target_layer(
        k_anchor, batch["gt_boxes_bv"], batch["gt_valid"],
        batch["gt_boxes_3d"], 10, 10)
    c5, _ = JM.extract_features(p, batch["bev"][None],
                                (batch["image"] - PIXEL_MEANS)[None])
    cls, box = JM.rpn_head(p, c5)
    rois = proposal_layer_3d(JM.rpn_probs(cls), box, batch["calib"], 10, 10,
                             pre_nms_top_n=100, post_nms_top_n=30)
    roi_data = JT.proposal_target_layer_3d(
        k_roi, rois["rois_bv"], rois["rois_3d"], rois["valid"],
        batch["gt_boxes_bv"], batch["gt_valid"], batch["gt_boxes_3d"],
        batch["gt_boxes_corners"], batch["calib"], rois_per_image=16)
    sampled = {"rpn_labels": np.asarray(rpn_labels),
               **{k: np.asarray(roi_data[k])
                  for k in ("labels", "valid", "rois_bv")}}
    return p, batch, key, metrics, grads, sampled


def test_forward_losses_and_grads_match_jax(jax_step, monkeypatch):
    p, batch, key, metrics, grads, sampled = jax_step
    seen = {}

    def recording(layer, names):
        def wrapped(*a, **kw):
            out = layer(*a, **kw)
            seen.update(zip(names, out) if isinstance(out, tuple) else out)
            return out
        return wrapped

    monkeypatch.setattr(TR, "anchor_target_layer", recording(
        TR.anchor_target_layer, ("rpn_labels", "rpn_bbox_targets")))
    monkeypatch.setattr(TR, "proposal_target_layer_3d", recording(
        TR.proposal_target_layer_3d, ()))
    params = params_from_jax(p, device="cpu")
    draws = _jax_draws(key, 10 * 10 * 4, 30 + MAX_GT, 16, FC)
    got = TR.build_forward_losses(**SMALL)(params, batch, draws)

    # the two packages sampled the same anchors and rois
    assert (sampled["rpn_labels"] == 1).sum() > 0
    assert sampled["labels"].sum() > 0                   # fg rois
    assert (sampled["valid"] & (sampled["labels"] == 0)).sum() > 0   # bg
    for k in ("rpn_labels", "labels", "valid", "rois_bv"):
        np.testing.assert_array_equal(seen[k].numpy(), sampled[k], err_msg=k)
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    got["loss"].backward()
    port = _grads_to_jax(params)
    assert set(port) == set(grads)
    for name in grads:
        for sub in ("weights", "biases"):
            ref = np.asarray(grads[name][sub])
            tol = 1e-4 * np.abs(ref).max()
            np.testing.assert_allclose(port[name][sub], ref, rtol=0, atol=tol,
                                       err_msg=name + "/" + sub)
    assert np.abs(np.asarray(grads["conv1_1"]["weights"])).max() > 0


def test_adam_step_matches_optax(rng):
    """Two Adam steps on the same gradients. Parameters start at 0 and are
    reset to 0 before the second step, so each step's result is its update.

    The port's update equals Adam's formula (optax.adam's), evaluated in
    float64, within 1e-6 relative. optax's own update equals the same
    formula within 1e-6 once its bias corrections 1 - b**t are taken in
    float32, as optax takes them: 0.999 rounds in float32 so that
    1 - 0.999 is 1.3e-5 off, which moves optax's first update by 6.4e-6
    relative from the port's."""
    shapes = {"a": (3, 5), "b": (7,)}
    params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
    opt = TR.build_train_step(lr=1e-5)[1](torch.nn.ParameterDict(params))
    tx = optax.adam(1e-5)
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    state = tx.init(jp)
    mu = {k: np.zeros(s) for k, s in shapes.items()}
    nu = {k: np.zeros(s) for k, s in shapes.items()}
    for t in (1, 2):
        g = {k: (rng.randn(*s) * 10.0 ** rng.uniform(-4, 1, s)).astype(
            np.float32) for k, s in shapes.items()}
        for k, prm in params.items():
            prm.grad = _t(g[k])
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        for k, prm in params.items():
            mu[k] = 0.9 * mu[k] + 0.1 * g[k]
            nu[k] = 0.999 * nu[k] + 0.001 * np.float64(g[k]) ** 2
            big = np.abs(g[k]) > 1e-6
            for one, ref in ((1.0, prm.detach().numpy()),
                             (np.float32(1), np.asarray(upd[k]))):
                bc1 = one - type(one)(0.9) ** t
                bc2 = one - type(one)(0.999) ** t
                want = -1e-5 * (mu[k] / bc1) / (np.sqrt(nu[k] / bc2) + 1e-8)
                np.testing.assert_allclose(ref[big], want[big], rtol=1e-6)
            with torch.no_grad():
                prm.zero_()


def test_cached_step_matches_host_feed():
    """build_train_step_cached over stacked frames (bf16 bev, uint8 image)
    equals build_train_step fed the same frame after that rounding
    (tests/test_train.py:141-183)."""
    frames = [_batch(s) for s in (2, 3)]
    data = {k: torch.stack([_t(f[k]) for f in frames]) for k in frames[0]}
    data["bev"] = data["bev"].bfloat16()
    data["image"] = data["image"].to(torch.uint8)
    kw = dict(SMALL, pre_nms_top_n=60, post_nms_top_n=12, rois_per_image=8)
    step_c, make_opt = TR.build_train_step_cached(**kw)
    step_h, _ = TR.build_train_step(**kw)
    p = he_normal_params(HE_SEED, fc_dim=8)
    gen = torch.Generator().manual_seed(0)
    for idx, frame in enumerate(frames):
        draws = TR.make_draws(gen, 400, 12 + MAX_GT, 8, 8, 0.5, "cpu")
        host = dict(frame, bev=data["bev"][idx].float(),
                    image=data["image"][idx].float())
        runs = []
        for step, args in ((step_c, (data, idx)), (step_h, (host,))):
            params = params_from_jax(p, device="cpu")
            runs.append((step(params, make_opt(params), *args, draws), params))
        (mc, pc), (mh, ph) = runs
        for k in mh:
            assert torch.isfinite(mc[k]) and mc[k] == mh[k], k
        for a, b in zip(pc.parameters(), ph.parameters()):
            assert torch.equal(a, b)
        w0 = torch.from_numpy(p["rpn_conv/3x3"]["weights"]).permute(3, 2, 0, 1)
        assert not torch.equal(pc["rpn_conv__3x3"].weight, w0)


def test_make_draws_shapes_and_rates():
    gen = torch.Generator().manual_seed(1)
    d = TR.make_draws(gen, 400, 38, 16, 64, 0.5, "cpu")
    assert d["anchor_fg"].shape == d["anchor_bg"].shape == (400,)
    assert d["roi_fg"].shape == d["roi_bg"].shape == (38,)
    assert [tuple(m.shape) for m in d["drop"]] == [(16, 64)] * 4 + [(16, 128)]
    assert all(m.dtype == torch.bool for m in d["drop"])
    assert 0.4 < torch.cat([m.flatten() for m in d["drop"]]).float().mean() < 0.6
    u = d["anchor_fg"]
    assert 0 <= u.min() and u.max() < 1 and not torch.equal(u, d["anchor_bg"])


def test_filter_roidb_matches_jax(capsys):
    roidb = [{"max_overlaps": np.array(o, np.float32), "id": i}
             for i, o in enumerate([[0.6, 0.0], [0.05, 0.02], [0.3],
                                    [], [0.5], [0.1], [0.09, 0.7]])]
    got = TR.filter_roidb(roidb)
    want = JTR.filter_roidb(roidb)
    assert [e["id"] for e in got] == [e["id"] for e in want] == [0, 2, 4, 5, 6]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "Filtered 2 roidb entries: 7 -> 5"


def test_train_step_runs_without_jax():
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from mv3d_tf_tpu_torch import geometry as G, train as TR\n"
        "from mv3d_tf_tpu_torch.anchors import get_anchor_grid\n"
        "from mv3d_tf_tpu_torch.utils.weights import he_normal_params, "
        "params_from_jax\n"
        "rng = np.random.RandomState(0)\n"
        "grid = get_anchor_grid(5, 5)\n"
        "bv = np.zeros((4, 5), np.float32); b3 = np.zeros((4, 7), np.float32)\n"
        "b3[:, 3:6] = 1; cnr = np.zeros((4, 25), np.float32)\n"
        "bv[0, :4] = grid.anchors_bv[np.where(grid.inside)[0][10]]\n"
        "b3[0, :6] = G.bv_anchor_to_lidar(torch.tensor(bv[:1, :4]))[0]\n"
        "cnr[0, :24] = G.lidar_3d_to_corners(torch.tensor(b3[:1, :6]))[0]\n"
        "bv[0, 4] = b3[0, 6] = cnr[0, 24] = 1\n"
        "cal = np.zeros((4, 12), np.float32); cal[0, [0, 5, 10]] = 1\n"
        "cal[2, [0, 4, 8]] = 1; cal[3, [1, 6, 8]] = [-1, -1, 1]\n"
        "batch = dict(bev=rng.rand(41, 41, 9), image=rng.rand(40, 48, 3) * 255,\n"
        "    calib=cal, gt_boxes_bv=bv, gt_boxes_3d=b3, gt_boxes_corners=cnr,\n"
        "    gt_valid=np.arange(4) < 1)\n"
        "step, make_opt = TR.build_train_step(feat_h=5, feat_w=5,\n"
        "    pre_nms_top_n=40, post_nms_top_n=10, rois_per_image=8)\n"
        "params = params_from_jax(he_normal_params(0, fc_dim=8),\n"
        "                         device='cpu')\n"
        "opt = make_opt(params)\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "for _ in range(2):\n"
        "    m = step(params, opt, batch, TR.make_draws(gen, 100, 14, 8, 8, 0.5,"
        " 'cpu'))\n"
        "    assert torch.isfinite(m['loss']) and m['loss'] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'mv3d_tf_tpu')]\n"
        "assert not bad, 'loaded: %s' % bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
