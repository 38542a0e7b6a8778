"""The port's training driver against mv3d_tf_tpu's on CPU: the data layer's
epoch order and prefetch errors, the staircase LR schedule against optax's,
the Adam state conversion, and solver.train_net itself, JAX's and the
port's, over one synthetic tree from one .npy of He weights with JAX's
draws injected: losses, final params and Adam moments, through a snapshot
and a resume; then the port's snapshots and its train_net CLI.

Both packages' init_params and step builders are monkeypatched to the small
shapes of tests/test_torch_train.py (SMALL, FC): the tree's images are
written 88x120, its BEV rasters cropped to 81x81, and each frame's gt rows
replaced by test_torch_train's (two gts equal to inside anchors), so that
both packages sample rois on the same frames."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from mv3d_tf_tpu import solver as JSOL  # noqa: E402
from mv3d_tf_tpu import train as JTR  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data import kitti as JK  # noqa: E402
from mv3d_tf_tpu.data import loader as JL  # noqa: E402
from mv3d_tf_tpu.models import mv3d as JM  # noqa: E402
from mv3d_tf_tpu.utils import checkpoint as JC  # noqa: E402
from mv3d_tf_tpu_torch import solver as TSOL  # noqa: E402
from mv3d_tf_tpu_torch import train as TR  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import kitti as TK  # noqa: E402
from mv3d_tf_tpu_torch.data import loader as TL  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402
from mv3d_tf_tpu_torch.models import mv3d as TM  # noqa: E402
from mv3d_tf_tpu_torch.utils import checkpoint as TC  # noqa: E402
from mv3d_tf_tpu_torch.utils import weights as TW  # noqa: E402
from test_torch_train import (FC, HE_SEED, MAX_GT, SMALL,  # noqa: E402
                              _batch, _jax_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, RESUME_AT = 4, 2
N_ANCHORS = SMALL["feat_h"] * SMALL["feat_w"] * 4
N_ALL = SMALL["post_nms_top_n"] + MAX_GT
# BEV rows/cols kept of each 601x601 raster: x 22-30 m, y -4-4 m
BEV_CROP = (slice(300, 381), slice(260, 341))
GT_KEYS = ("gt_boxes_bv", "gt_boxes_3d", "gt_boxes_corners", "gt_valid")
# Tolerances. At equal params, tests/test_torch_train.py's: each loss term
# rtol 1e-5, gradients within 1e-4 of the tensor's max |g|, so Adam's first
# moments too, their squares (second moments) within 2e-4. Each later step
# starts from params that differ: an element whose gradient is rounding
# noise takes lr * sign(noise) in either package, so params may differ by
# 2 lr per update elementwise, and from then on a ReLU or ROI max-pool
# argmax may flip. So: every loss term within 1e-5 of the step's total loss;
# the moments of the iteration-2 snapshot at the equal-params tolerances
# (measured: 6e-6 of the max); params within 2 lr per update elementwise and
# their moves within 1e-2 in relative norm; at iteration 4, after flips, the
# moments and the moves within 5e-2 in relative norm (measured: 1.3e-2).
LOSS_RTOL, MU_TOL, NU_TOL, LR = 1e-5, 1e-4, 2e-4, 1e-5


def _frame_gts():
    g = _batch(1)
    return {k: g[k] for k in GT_KEYS}


# ---------------------------------------------------------------- data layer

def _ids(layer, n, forward):
    return [int(layer.forward() if forward else layer.next_index())
            for _ in range(n)]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_roi_data_layer_order_matches_jax(prefetch, monkeypatch):
    """Three epochs of five frames: forward()'s frames and next_index()'s
    indices in JAX's order, from the same seed."""
    roidb = [{"id": i} for i in range(5)]
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "get_minibatch", lambda e: e["id"])
    want = _ids(JL.RoIDataLayer(roidb, prefetch=prefetch), 15, True)
    got = _ids(TL.RoIDataLayer(roidb, prefetch=prefetch), 15, True)
    assert got == want
    assert sorted(want[:5]) == sorted(want[5:10]) == list(range(5))
    assert want[:5] != want[5:10]
    assert (_ids(TL.RoIDataLayer(roidb, prefetch=0, seed=9), 15, False)
            == _ids(JL.RoIDataLayer(roidb, prefetch=0, seed=9), 15, False))


def test_prefetch_worker_error_propagates():
    """tests/test_data.py:138-151 on the port's layer: a roidb entry whose
    files are missing raises in forward() from the worker's exception."""
    bad = [{"image_path": "/nonexistent/definitely_missing.png",
            "lidar_bv_path": "/nonexistent/missing.npy",
            "calib": np.zeros((4, 12), np.float32),
            "gt_classes": np.array([1]),
            "boxes": np.zeros((1, 4), np.float32),
            "boxes_bv": np.zeros((1, 4), np.float32),
            "boxes_3D": np.zeros((1, 6), np.float32),
            "boxes_corners": np.zeros((1, 24), np.float32)}]
    layer = TL.RoIDataLayer(bad, prefetch=1)
    with pytest.raises(RuntimeError, match="prefetch worker died") as e:
        layer.forward()
    assert isinstance(e.value.__cause__, OSError)


# ---------------------------------------------------------------- lr, Adam

def test_lr_schedule_matches_optax(monkeypatch):
    """cfg.TRAIN.LR_DECAY's scheduler gives optax.exponential_decay's
    staircase lr, to float32 rounding, for the update after count updates:
    stepped from 0, and built at a resume iteration."""
    S = 3
    monkeypatch.setattr(tcfg.TRAIN, "STEPSIZE", S)
    monkeypatch.setattr(tcfg.TRAIN, "GAMMA", 0.1)
    schedule = optax.exponential_decay(init_value=1e-5, transition_steps=S,
                                       decay_rate=0.1, staircase=True)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=1e-5)
    sched = TSOL._lr_scheduler(opt, 0)
    lrs = []
    for _ in range(2 * S + 1):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    for count in (0, S - 1, S, 2 * S - 1, 2 * S):
        want = np.float32(schedule(count))
        assert np.float32(lrs[count]) == want, count
        resumed = torch.optim.Adam([p], lr=1e-5)
        TSOL._lr_scheduler(resumed, count)
        assert np.float32(resumed.param_groups[0]["lr"]) == want, count
    assert lrs[S - 1] == 1e-5 and np.isclose(lrs[2 * S], 1e-7)


def test_adam_state_round_trip():
    """optax's adam state after two updates -> torch.optim.Adam's state ->
    back: exact, the count included; each moment lands where
    params_from_jax puts its weight (conv HWIO -> OIHW, fc (in, out) ->
    (out, in), fc6 rows in the order of its weights)."""
    p = {k: v for k, v in TW.he_normal_params(0, fc_dim=8).items()
         if k in ("conv1_1", "conv5_3_2", "fc6_1", "cls_score")}
    rng = np.random.RandomState(4)
    tx = optax.adam(1e-5)
    state = tx.init(p)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), p)
        _, state = tx.update(g, state, p)
    params = TW.params_from_jax(p, device="cpu")
    opt = torch.optim.Adam(params.parameters(), lr=1e-5)
    assert TW.adam_state_from_jax(state, params, opt) == 2
    mu, nu = state[0].mu, state[0].nu
    for field, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        placed = TW.params_from_jax(
            jax.tree.map(np.asarray, tree), device="cpu")
        for key, m in params.items():
            for t, ref in ((m.weight, placed[key].weight),
                           (m.bias, placed[key].bias)):
                assert torch.equal(opt.state[t][field], ref), (key, field)
                assert opt.state[t]["step"].item() == 2
    fc6 = params["fc6_1"].weight
    assert torch.equal(opt.state[fc6]["exp_avg"],
                       torch.from_numpy(np.array(mu["fc6_1"]["weights"]).T))
    back = TW.adam_state_to_jax(opt, params)
    assert back["count"] == np.int32(2)
    for name in p:
        for sub in ("weights", "biases"):
            np.testing.assert_array_equal(back["mu"][name][sub],
                                          np.asarray(mu[name][sub]))
            np.testing.assert_array_equal(back["nu"][name][sub],
                                          np.asarray(nu[name][sub]))
    # the optax NamedTuple takes the fields as they are, and goes back in
    rebuilt = (optax.ScaleByAdamState(**back), state[1])
    assert jax.tree.structure(rebuilt) == jax.tree.structure(state)
    opt2 = torch.optim.Adam(params.parameters(), lr=1e-5)
    assert TW.adam_state_from_jax(rebuilt, params, opt2) == 2
    for t in params.parameters():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt2.state[t][k], opt.state[t][k])
    sched = optax.adam(optax.exponential_decay(
        1e-5, 3, 0.1, staircase=True)).init(p)
    sched = (sched[0]._replace(count=np.int32(5)),
             sched[1]._replace(count=np.int32(5)))
    assert TW.adam_state_from_jax(sched, params, opt2) == 5


# ---------------------------------------------------------------- train_net

def _tree(root):
    """A 6-frame synthetic tree (3 train frames): 88x120 images, BEV rasters
    cropped to 81x81."""
    synthetic.generate(root, num_frames=6, cars_per_frame=2, seed=5,
                       image_hw=(88, 120))
    bvdir = os.path.join(root, "object", "training", "lidar_bv")
    for name in os.listdir(bvdir):
        path = os.path.join(bvdir, name)
        np.save(path, np.load(path)[BEV_CROP])
    return root


def _jax_keys(n):
    """JAX's train_net key chain (solver.py:92-93, 193): the step keys."""
    key = jax.random.PRNGKey(jcfg.RNG_SEED)
    key, _ = jax.random.split(key)
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(k)
    return out


class _Runs:
    """Both packages' train_net with small step builders and JAX's draws:
    each run's per-iteration metrics, log lines and the lr each port
    update used."""

    def __init__(self, mp, tmp):
        self.keys = _jax_keys(ITERS)
        self.gts = _frame_gts()
        self.jax_step = None
        self.metrics, self.lrs, self.frames = [], [], []
        j_build, t_build = JTR.build_train_step, TR.build_train_step
        self.draw_calls = 0

        def jax_builder(**kw):
            if self.jax_step is None:        # one jit for every run
                self.jax_step = j_build(**dict(kw, **SMALL))
            step, tx = self.jax_step

            def wrapped(params, opt_state, batch, key):
                self.frames.append(float(np.asarray(batch["bev"]).sum()))
                params, opt_state, m = step(params, opt_state,
                                            dict(batch, **self.gts), key)
                self.metrics.append({k: float(v) for k, v in m.items()})
                return params, opt_state, m
            return wrapped, tx

        def port_builder(**kw):
            step, make_opt = t_build(**dict(kw, **SMALL))

            def wrapped(params, opt, batch, draws):
                self.frames.append(float(np.asarray(batch["bev"]).sum()))
                self.lrs.append(opt.param_groups[0]["lr"])
                m = step(params, opt, dict(batch, **self.gts), draws)
                self.metrics.append({k: v.item() for k, v in m.items()})
                return m
            return wrapped, make_opt

        draws = {}

        def jax_draws(gen, *args):
            assert args[-1] == torch.device("cpu")
            i = self.draw_calls
            self.draw_calls += 1
            if i not in draws:
                draws[i] = _jax_draws(self.keys[i], N_ANCHORS, N_ALL,
                                      SMALL["rois_per_image"], FC)
            return draws[i]

        for c, sub in ((jcfg, "jax"), (tcfg, "port")):
            mp.setattr(c, "DATA_DIR", os.path.join(tmp, sub, "data"))
            mp.setattr(c, "ROOT_DIR", os.path.join(tmp, sub))
            mp.setattr(c.TPU, "IMAGE_SHAPE", (88, 120, 3))
        # zeros of the small shapes: the .npy then sets every parameter
        zeros = {k: {s: np.zeros_like(a) for s, a in v.items()}
                 for k, v in TW.he_normal_params(HE_SEED, fc_dim=FC).items()}
        mp.setattr(JM, "init_params", lambda key: zeros)
        mp.setattr(TM, "init_params", lambda gen, device: TW.params_from_jax(
            zeros, device=device))
        mp.setattr(JSOL, "build_train_step", jax_builder)
        mp.setattr(TR, "build_train_step", port_builder)
        mp.setattr(TR, "make_draws", jax_draws)

        root = _tree(os.path.join(tmp, "kitti"))
        self.weights = os.path.join(tmp, "he.npy")
        np.save(self.weights, TW.he_normal_params(HE_SEED, fc_dim=FC))
        self.roidb = {
            "jax": JK.prepare_roidb(JK.KittiMV3D("train", kitti_path=root)),
            "port": TK.prepare_roidb(TK.KittiMV3D("train", kitti_path=root))}


class _Imdb:
    num_classes = 2


def _run(r, pkg, out, **kw):
    """One train_net run of a package; returns (params, per-iteration
    metrics, log lines, the lr of each port update, each step's frame as
    its BEV sum)."""
    r.metrics, r.lrs, r.frames, r.draw_calls = [], [], [], 0
    log = []
    args = dict(pretrained_model=r.weights, max_iters=ITERS, display=2,
                snapshot_iters=2, log=log.append)
    args.update(kw)
    if pkg == "jax":
        params = JSOL.train_net(_Imdb(), r.roidb["jax"], out, **args)
    else:
        params = TSOL.train_net(_Imdb(), r.roidb["port"], out,
                                device="cpu", **args)
    return params, r.metrics, log, r.lrs, r.frames


def _snapshot(out, it):
    """The snapshot of iteration ``it`` in out (JAX's dir or the port's .pt)."""
    names = [n for n in os.listdir(out)
             if n.rsplit("_iter_", 1)[1].split(".")[0] == str(it)]
    assert len(names) == 1, os.listdir(out)
    return os.path.join(out, names[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's train_net, 4 iterations, then a resume from
    each one's iteration-2 snapshot to 4 in a fresh output dir."""
    tmp = str(tmp_path_factory.mktemp("train_net"))
    with pytest.MonkeyPatch.context() as mp:
        r = _Runs(mp, tmp)
        out = {}
        for pkg in ("jax", "port"):
            full = os.path.join(tmp, pkg, "full")
            out[pkg] = _run(r, pkg, full)
            resumed = os.path.join(tmp, pkg, "resumed")
            os.makedirs(resumed)
            src = _snapshot(full, RESUME_AT)
            dst = os.path.join(resumed, os.path.basename(src))
            (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
            out[pkg + "_resume"] = _run(r, pkg, resumed, resume=True)
            (shutil.rmtree if os.path.isdir(dst) else os.remove)(dst)
            out[pkg + "_dirs"] = (full, resumed)
        yield r, mp, out
    shutil.rmtree(tmp)           # ~2.5 GB of snapshots at full trunk width


def _loss_lines(log):
    """{iteration: the five numbers} of the display lines."""
    out = {}
    for line in log:
        m = re.match(r"iter: (\d+) / \d+, total loss: (\S+), rpn_loss_cls: "
                     r"(\S+), rpn_loss_box: (\S+), loss_cls: (\S+), "
                     r"loss_box: (\S+)$", line)
        if m:
            out[int(m.group(1))] = [float(v) for v in m.groups()[1:]]
    return out


def _assert_metrics(got, want, equal_start=True):
    """Iteration 0 per term at rtol 1e-5 when both runs start from equal
    params; every other iteration's terms within 1e-5 of its total loss."""
    assert len(got) == len(want)
    for it, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        first = it == 0 and equal_start
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=LOSS_RTOL if first else 0,
                atol=0 if first else LOSS_RTOL * w["loss"],
                err_msg="iteration %d %s" % (it, k))


def _rel(a, b):
    """|a - b| / |b| in the Frobenius norm; 0 where both are 0 (the image
    trunk at these shapes: its rois lie off the 11x15 map)."""
    diff = np.linalg.norm((a - b).ravel())
    return diff / np.linalg.norm(b.ravel()) if diff else 0.0


def _jax_snapshot(path):
    """JAX's params and adam state {count, mu, nu} from its snapshot, as
    host arrays keyed by layer name."""
    tree = JC.load_checkpoint_host(path)
    return tree["params"], tree["opt_state"][0]


def _port_snapshot(path):
    params = TW.params_from_jax(TW.he_normal_params(0, fc_dim=FC),
                                device="cpu")
    opt = torch.optim.Adam(params.parameters(), lr=1e-5)
    TC.load_checkpoint(path, params, opt)
    return TW.params_to_jax(params), TW.adam_state_to_jax(opt, params)


def _assert_state(port_path, jax_path, start, updates, exact_moments):
    """A port snapshot against JAX's: Adam's count, the moments (at the
    equal-params tolerances, or in relative norm), the params (elementwise
    within 2 lr per update; their moves from ``start``, JAX's params where
    the run began, in relative norm)."""
    p_params, p_adam = _port_snapshot(port_path)
    j_params, j_adam = _jax_snapshot(jax_path)
    assert int(p_adam["count"]) == int(j_adam["count"]) == updates
    norm_tol = 1e-2 if exact_moments else 5e-2
    moved = []
    for name in j_params:
        for sub in ("weights", "biases"):
            what = "%s/%s" % (name, sub)
            for key, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
                got = p_adam[key][name][sub]
                ref = np.asarray(j_adam[key][name][sub])
                if exact_moments:
                    np.testing.assert_allclose(
                        got, ref, rtol=0, atol=tol * np.abs(ref).max(),
                        err_msg=key + " " + what)
                else:
                    assert _rel(got, ref) <= norm_tol, (key, what)
            ref = np.asarray(j_params[name][sub])
            got = p_params[name][sub]
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=2 * LR * updates * 1.01,
                                       err_msg=what)
            moved.append(np.abs(ref - start[name][sub]).max() > 0)
            assert (_rel(got - start[name][sub], ref - start[name][sub])
                    <= norm_tol), what
    assert moved[0] and sum(moved) > len(moved) // 2   # bbox_pred, most


def _start_params(weights):
    """Both runs' starting params in the JAX layout: the init, then the
    .npy (whose fc6 rows load_npy_weights permutes)."""
    from mv3d_tf_tpu.utils.weights import load_npy_weights
    p = load_npy_weights(JM.init_params(jax.random.PRNGKey(0)), weights,
                         log=None)
    return jax.tree.map(np.asarray, p)


def test_train_net_matches_jax(runs):
    """4 iterations, DISPLAY 2, SNAPSHOT_ITERS 2: per-iteration losses, the
    printed loss lines, the snapshots, and the final params and Adam
    moments."""
    r, _, out = runs
    j_params, j_metrics, j_log, _, j_frames = out["jax"]
    t_params, t_metrics, t_log, t_lrs, t_frames = out["port"]
    assert len(j_metrics) == ITERS
    # the epoch order: 3 train frames, then a new permutation
    assert t_frames == j_frames and len(set(j_frames[:3])) == 3
    assert j_metrics[0]["cross_entropy"] > 0 and j_metrics[0]["loss_box"] > 0
    _assert_metrics(t_metrics, j_metrics)
    j_lines, t_lines = _loss_lines(j_log), _loss_lines(t_log)
    assert sorted(j_lines) == sorted(t_lines) == [2, 4]
    for it in j_lines:
        np.testing.assert_allclose(t_lines[it], j_lines[it], rtol=0,
                                   atol=1.5e-4)
    assert sum("speed:" in line for line in t_log) == 2
    assert t_lrs == [1e-5] * ITERS
    (j_full, _), (t_full, _) = out["jax_dirs"], out["port_dirs"]
    assert sorted(os.listdir(t_full)) == [
        "VGGnet_fast_rcnn_iter_2.pt", "VGGnet_fast_rcnn_iter_4.pt"]
    start = _start_params(r.weights)
    _assert_state(_snapshot(t_full, RESUME_AT), _snapshot(j_full, RESUME_AT),
                  start, RESUME_AT, exact_moments=True)
    _assert_state(_snapshot(t_full, ITERS), _snapshot(j_full, ITERS),
                  start, ITERS, exact_moments=False)
    final = TW.params_to_jax(t_params)
    snap = _port_snapshot(_snapshot(t_full, ITERS))[0]
    for name in final:
        for sub in ("weights", "biases"):
            np.testing.assert_array_equal(final[name][sub], snap[name][sub])


def test_resume_tracks_jax_resume(runs):
    """A resume from the iteration-2 snapshot to 4: each package restores
    params and Adam and replays its seed's draws and epoch order (the
    port's as JAX's); the two resumes agree as the uninterrupted runs do."""
    r, _, out = runs
    _, j_metrics, j_log, _, j_frames = out["jax_resume"]
    _, t_metrics, t_log, _, t_frames = out["port_resume"]
    assert len(j_metrics) == ITERS - RESUME_AT
    # each resume starts from its own package's snapshot
    _assert_metrics(t_metrics, j_metrics, equal_start=False)
    for log in (j_log, t_log):
        assert any(line.startswith("Resumed from") and
                   line.endswith("(iter %d)" % RESUME_AT) for line in log)
    # the replay: both resumes take the epoch order from its start again
    assert t_frames == j_frames == out["jax"][4][:ITERS - RESUME_AT]
    (_, j_res), (_, t_res) = out["jax_dirs"], out["port_dirs"]
    j_start = _jax_snapshot(_snapshot(out["jax_dirs"][0], RESUME_AT))[0]
    _assert_state(_snapshot(t_res, ITERS), _snapshot(j_res, ITERS), j_start,
                  ITERS, exact_moments=False)


def test_constant_lr_snapshot_resumes_under_lr_decay(runs, tmp_path):
    """The port's iteration-2 snapshot of a constant-lr run, resumed with
    cfg.TRAIN.LR_DECAY on (STEPSIZE 3): no graft, the scheduler starts at
    iteration 2, so the updates take 1e-5 then 1e-6, and the final snapshot
    holds the scheduler at count 4."""
    r, mp, out = runs
    mp.setattr(tcfg.TRAIN, "LR_DECAY", True)
    mp.setattr(tcfg.TRAIN, "STEPSIZE", 3)
    mp.setattr(tcfg.TRAIN, "GAMMA", 0.1)
    try:
        src = _snapshot(out["port_dirs"][0], RESUME_AT)
        assert "sched" not in torch.load(src, weights_only=True)
        shutil.copy(src, str(tmp_path))
        _, metrics, log, lrs, _ = _run(r, "port", str(tmp_path), resume=True)
    finally:
        mp.setattr(tcfg.TRAIN, "LR_DECAY", False)
    assert lrs == [1e-5, pytest.approx(1e-6, rel=1e-12)]
    assert any(line.startswith("LR_DECAY on") for line in log)
    assert len(metrics) == ITERS - RESUME_AT
    blob = torch.load(_snapshot(str(tmp_path), ITERS), weights_only=True)
    assert blob["sched"]["last_epoch"] == ITERS
    assert blob["opt"]["param_groups"][0]["lr"] == pytest.approx(1e-6)


def test_snapshot_round_trip_is_exact(tmp_path):
    """save_checkpoint -> load_checkpoint restores params, Adam and the
    scheduler bit for bit; a params-only load of the full snapshot works;
    the .pt suffix is stripped from the iteration."""
    p = {k: v for k, v in TW.he_normal_params(1, fc_dim=8).items()
         if k in ("conv1_1", "fc6_1", "bbox_pred")}
    params = TW.params_from_jax(p, device="cpu")
    opt = torch.optim.Adam(params.parameters(), lr=1e-5)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 0.5 ** c)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for q in params.parameters():
            q.grad = torch.randn(q.shape, generator=gen)
        opt.step()
        sched.step()
    for it in (2, 10):
        path = TC.save_checkpoint(str(tmp_path), it, params, opt, sched)
    assert path.endswith("_iter_10.pt") and TC.snapshot_iter(path) == 10
    assert TC.latest_snapshot(str(tmp_path)) == path

    p2 = TW.params_from_jax({k: {s: np.zeros_like(a) for s, a in v.items()}
                             for k, v in p.items()}, device="cpu")
    opt2 = torch.optim.Adam(p2.parameters(), lr=1e-5)
    sched2 = torch.optim.lr_scheduler.LambdaLR(opt2, lambda c: 0.5 ** c)
    TC.load_checkpoint(path, p2, opt2, sched2)
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[a][k], opt2.state[b][k])
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    assert sched2.state_dict() == sched.state_dict()
    p3 = TW.params_from_jax(p, device="cpu")
    TC.load_checkpoint(path, p3)
    assert all(torch.equal(a, b)
               for a, b in zip(params.parameters(), p3.parameters()))


_CLI = """
import functools, os, sys
import numpy as np
from mv3d_tf_tpu_torch import train as TR
from mv3d_tf_tpu_torch.config import cfg
from mv3d_tf_tpu_torch.data import synthetic
from mv3d_tf_tpu_torch.models import mv3d
from mv3d_tf_tpu_torch.tools.train_net import main
tmp = sys.argv[1]
root = synthetic.generate(os.path.join(tmp, "kitti"), num_frames=4,
                          cars_per_frame=2, seed=1, image_hw=(40, 48))
bvdir = os.path.join(root, "object", "training", "lidar_bv")
for f in os.listdir(bvdir):
    np.save(os.path.join(bvdir, f),
            np.load(os.path.join(bvdir, f))[300:341, 280:321])
# a 41x41 BEV and a 40x48 image: feat 5x5, and a small head
cfg.TPU.IMAGE_SHAPE = (40, 48, 3)
small = dict(feat_h=5, feat_w=5, pre_nms_top_n=40, post_nms_top_n=10,
             rois_per_image=8)
build, draws = TR.build_train_step, TR.make_draws
TR.build_train_step = lambda **kw: build(**dict(kw, **small))
TR.make_draws = lambda gen, *a: draws(gen, 100, 10 + cfg.TPU.MAX_GT, 8, 8,
                                      0.5, a[-1])
mv3d.init_params = functools.partial(mv3d.init_params, fc_dim=8)
for extra in (["--iters", "2"], ["--iters", "3", "--resume"]):
    main(["--device", "cpu", "--imdb", "kitti_train", "--kitti_path", root,
          "--dtype", "float32"] + extra + [
          "--set", "ROOT_DIR", tmp, "DATA_DIR", os.path.join(tmp, "data"),
          "TRAIN.SNAPSHOT_ITERS", "1", "TRAIN.DISPLAY", "1"])
print(sorted(os.listdir(os.path.join(tmp, "output", "default",
                                     "kitti_train"))))
# VGGnet_train with TRAIN.HAS_RPN off (the config default) trains Fast
# R-CNN over the imdb's roidb: fc 8 and a 48x64 bucket at CPU sizes
from mv3d_tf_tpu_torch import solver
from mv3d_tf_tpu_torch.models import vggnet
vggnet.init_params_2d = functools.partial(vggnet.init_params_2d, fc_dim=8)
solver.train_net_2d = functools.partial(solver.train_net_2d,
                                        bucket_hw=(48, 64))
assert not cfg.TRAIN.HAS_RPN
main(["--network", "VGGnet_train", "--imdb", "kitti2d_train", "--kitti_path",
      root, "--device", "cpu", "--dtype", "float32", "--iters", "1",
      "--set", "TRAIN.BATCH_SIZE", "8"])
print(sorted(os.listdir(os.path.join(tmp, "output", "default",
                                     "kitti2d_train"))))
try:
    main([])
except SystemExit as e:
    assert e.code == 1, e.code
else:
    raise AssertionError("no arguments")
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "mv3d_tf_tpu")]
assert not bad, "loaded: %s" % bad
print("ok")
"""


def test_train_net_cli_on_the_cpu_without_jax(tmp_path):
    """python -m ...tools.train_net's main with --device cpu over a 2-frame
    train split at small shapes (its step builder patched, as above): two
    iterations, then --resume to three; one snapshot an iteration;
    VGGnet_train over kitti2d_train with TRAIN.HAS_RPN off (the default)
    trains Fast R-CNN one iteration (fc 8, a 48x64 bucket) and writes its
    snapshot; no arguments prints the help and exits 1; nothing of jax or
    the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CLI, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert ("['VGGnet_fast_rcnn_iter_1.pt', 'VGGnet_fast_rcnn_iter_2.pt', "
            "'VGGnet_fast_rcnn_iter_3.pt']") in lines
    assert any(line.startswith("Resumed from") and line.endswith("(iter 2)")
               for line in lines)
    assert sum(line.startswith("iter: ") for line in lines) == 4
    assert "['VGGnet_fast_rcnn_iter_1.pt']" in lines
