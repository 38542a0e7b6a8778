"""The port's training-evidence pieces against the JAX package on CPU:
utils/weights.make_mv3d_pretrain_dict bit for bit, tools/accuracy_eval's
segmenting, resume and trajectory file against tools/accuracy_eval.py's
(both packages' solver.train_net and test_net replaced by recorders: a
full-width train step takes minutes on the CPU; chip_smoke.py runs the
tool for real on the card), and the refusal to resume a decayed snapshot
at a constant lr (ROADMAP.md's repro: STEPSIZE 2, GAMMA 0.1, 4
iterations), which the JAX package refuses too."""

import copy
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import optax  # noqa: E402

from mv3d_tf_tpu import solver as JSOL  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.models import mv3d as JM  # noqa: E402
from mv3d_tf_tpu.utils import checkpoint as JC  # noqa: E402
from mv3d_tf_tpu.utils import weights as JW  # noqa: E402
from mv3d_tf_tpu_torch import solver as TSOL  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.models import mv3d as TM  # noqa: E402
from mv3d_tf_tpu_torch.tools import accuracy_eval as TAE  # noqa: E402
from mv3d_tf_tpu_torch.utils import checkpoint as TC  # noqa: E402
from mv3d_tf_tpu_torch.utils import weights as TW  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow_vgg(seed, widths=(4, 4, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8),
                pooled_c=8, fc=32):
    """A VGG-style dict at narrow widths: 13 3x3 convs, fc6 (49*C, fc),
    fc7 (fc, fc), drawn from a seed."""
    rng = np.random.RandomState(seed)
    names = ["conv%d_%d" % (b, i) for b, n in
             ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3)) for i in range(1, n + 1)]
    out, c_in = {}, 3
    for name, c_out in zip(names, widths):
        out[name] = {"weights": rng.randn(3, 3, c_in, c_out).astype(
            np.float32), "biases": rng.randn(c_out).astype(np.float32)}
        c_in = c_out
    out["fc6"] = {"weights": rng.randn(49 * pooled_c, fc).astype(np.float32),
                  "biases": rng.randn(fc).astype(np.float32)}
    out["fc7"] = {"weights": rng.randn(fc, fc).astype(np.float32),
                  "biases": rng.randn(fc).astype(np.float32)}
    return out


@pytest.mark.parametrize("seed,fc_dim", [(3, 16), (0, 48)])
def test_make_mv3d_pretrain_dict_matches_jax(seed, fc_dim):
    vgg = _narrow_vgg(seed + 100)
    got = TW.make_mv3d_pretrain_dict(vgg, fc_dim=fc_dim, seed=seed)
    want = JW.make_mv3d_pretrain_dict(vgg, fc_dim=fc_dim, seed=seed)
    assert sorted(got) == sorted(want)
    assert {"conv5_3_2", "fc6_1", "fc6_2", "fc7_1", "fc7_2"} <= set(got)
    for key in want:
        assert sorted(got[key]) == sorted(want[key])
        for sub, arr in want[key].items():
            assert got[key][sub].dtype == arr.dtype, (key, sub)
            assert np.array_equal(got[key][sub], arr), (key, sub)
    assert got["fc6_1"]["weights"].shape == (49 * 8, fc_dim)
    assert got["fc7_2"]["weights"].shape == (fc_dim, fc_dim)


class _FastRandomState(np.random.RandomState):
    """The JAX tool draws a 25088x4096 VGG fc6 with randn (seconds on the
    CPU) before it subsamples it; the segmenting does not read it, so large
    draws come back as zeros of their shape, and both tools subsample the
    narrow dict. Small draws are the real ones."""

    def randn(self, *shape):
        if int(np.prod(shape)) > 1 << 20:
            return np.zeros(shape)
        return super().randn(*shape)


def _recorders(calls, write_snapshot, latest):
    """train_net and test_net stand-ins: train_net records (max_iters,
    resume, the iteration it resumes at, pretrained weights given), logs a
    loss line every ``display`` iterations and writes an empty snapshot
    where its package's ``latest`` snapshot search looks; test_net records
    its weights name and returns no detections."""
    def train_net(imdb, roidb, output_dir, pretrained_model=None,
                  max_iters=0, resume=False, display=50, log=print, **kw):
        start = (int(latest(output_dir).rsplit("_iter_", 1)[1].split(".")[0])
                 if resume else 0)
        calls.append(("train", max_iters, resume, start,
                      pretrained_model is not None))
        for it in range(start, max_iters):
            if (it + 1) % display == 0:
                log("iter: %d / %d, total loss: 1.0000" % (it + 1, max_iters))
        write_snapshot(output_dir, max_iters)
        return "params@%d" % max_iters

    def test_net(params, imdb, weights_filename=None, return_cnr_r=False,
                 **kw):
        calls.append(("test", weights_filename))
        n = imdb.num_images
        boxes = [[np.zeros((0, 5), np.float32)] * n for _ in range(2)]
        cnr = [[np.zeros((0, 25), np.float32)] * n for _ in range(2)]
        return (boxes, cnr, cnr) if return_cnr_r else (boxes, cnr)

    return train_net, test_net


@pytest.fixture
def both_cfgs(tmp_path):
    saved = copy.deepcopy(dict(jcfg)), copy.deepcopy(dict(tcfg))
    for c in (jcfg, tcfg):
        c.DATA_DIR = str(tmp_path / "cache")
    yield
    for c, snap in zip((jcfg, tcfg), saved):
        c.clear()
        c.update(snap)


def _run_jax(argv, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import accuracy_eval as JAE
        monkeypatch.setattr(sys, "argv", ["accuracy_eval.py"] + argv)
        JAE.main()
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))


def test_segments_resume_and_trajectory_match_jax(tmp_path, monkeypatch,
                                                  both_cfgs):
    """Both tools over one 4-frame tree: --iters 4 --eval-every 2, then
    --resume to 6. The same train_net calls (iterations, resume, pretrained
    weights only from 0), the same evaluations and trajectory keys; the
    pretrain .npy beside the snapshots. The port logs losses every
    min(50, --eval-every) iterations and keeps them across a resume."""
    j_calls, t_calls = [], []

    def j_snap(out, it):
        os.makedirs(os.path.join(out, JC.snapshot_name(it)), exist_ok=True)

    def t_snap(out, it):
        open(os.path.join(out, TC.snapshot_name(it) + TC.SUFFIX), "w").close()

    for mod, calls, snap, latest in ((JSOL, j_calls, j_snap,
                                      JC.latest_snapshot),
                                     (TSOL, t_calls, t_snap,
                                      TC.latest_snapshot)):
        train_net, test_net = _recorders(calls, snap, latest)
        monkeypatch.setattr(mod, "train_net", train_net)
        monkeypatch.setattr(mod, "test_net", test_net)
    monkeypatch.setattr(np.random, "RandomState", _FastRandomState)
    monkeypatch.setattr(JM, "init_params", lambda key: {})
    monkeypatch.setattr(JW, "load_npy_weights", lambda p, d, log=None: p)
    make = JW.make_mv3d_pretrain_dict
    monkeypatch.setattr(JW, "make_mv3d_pretrain_dict",
                        lambda vgg, seed: make(_narrow_vgg(seed), seed=seed))
    monkeypatch.setattr(TAE, "synthetic_vgg_dict",
                        lambda seed: _narrow_vgg(seed))
    monkeypatch.setattr(TM, "init_params",
                        lambda gen, device=None: torch.nn.ModuleDict())

    outs = {}
    for name, run in (("jax", lambda a: _run_jax(a, monkeypatch)),
                      ("port", lambda a: TAE.main(a + ["--device", "cpu"]))):
        data, out = str(tmp_path / name / "kitti"), str(tmp_path / name / "o")
        common = ["--frames", "4", "--cars", "2", "--data", data, "--out",
                  out, "--eval-every", "2", "--dtype", "f32"]
        run(common + ["--iters", "4"])
        run(common + ["--iters", "6", "--resume"])
        with open(os.path.join(out, "accuracy_trajectory.json")) as f:
            outs[name] = json.load(f)
        assert os.path.isfile(os.path.join(out, "vgg_synth_sampled.npy"))

    assert t_calls == j_calls == [
        ("test", "accuracy_iter0"), ("train", 2, False, 0, True),
        ("test", "accuracy_iter2"), ("train", 4, True, 2, False),
        ("test", "accuracy_iter4"), ("train", 6, True, 4, False),
        ("test", "accuracy_iter6")]
    j, t = outs["jax"], outs["port"]
    assert sorted(t) == sorted(j) == ["config", "evals", "losses"]
    assert set(t["config"]) == set(j["config"]) | {"device"}
    assert [e["tag"] for e in t["evals"]] == [e["tag"] for e in j["evals"]]
    for te, je in zip(t["evals"], j["evals"]):
        assert sorted(te) == sorted(je)
        for key in ("official", "official_proper_projection",
                    "official_quality_regressed"):
            assert te[key] == je[key]
        assert te["bev_ap@0.5"] == je["bev_ap@0.5"] == 0.0
    # JAX logs every 50 iterations (none here); the port every 2, and the
    # resume keeps the first run's lines
    assert j["losses"] == []
    assert t["losses"] == ["iter: %d / %d, total loss: 1.0000" % (i, n)
                           for i, n in ((2, 2), (4, 4), (6, 6))]


def _decayed_snapshots(tmp_path):
    """The repro: a decayed run (STEPSIZE 2, GAMMA 0.1) of 4 iterations on
    an nn.Linear, in the port (.pt) and in the JAX package (orbax)."""
    tcfg.TRAIN.STEPSIZE, tcfg.TRAIN.GAMMA = 2, 0.1
    lin = torch.nn.Linear(3, 2)
    params = torch.nn.ModuleDict({"fc": lin})
    opt = torch.optim.Adam(params.parameters(), lr=TSOL.LR)
    sched = TSOL._lr_scheduler(opt, 0)
    for _ in range(4):
        params["fc"](torch.ones(1, 3)).sum().backward()
        opt.step()
        sched.step()
    port = TC.save_checkpoint(str(tmp_path / "port"), 4, params, opt, sched)
    jparams = {"fc": {"weights": np.ones((3, 2), np.float32)}}
    decay = optax.adam(optax.exponential_decay(1e-5, 2, 0.1, staircase=True))
    jstate = decay.init(jparams)
    jax_ = JC.save_checkpoint(str(tmp_path / "jax"), 4, jparams, jstate)
    return port, opt, jax_, jparams


def test_constant_lr_resume_of_a_decayed_snapshot_raises(tmp_path,
                                                         both_cfgs):
    port, opt, jax_path, jparams = _decayed_snapshots(tmp_path)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-7)
    # JAX: a constant-lr Adam state does not match the snapshot's tree,
    # and solver.train_net re-raises with LR_DECAY off (solver.py:142-144)
    with pytest.raises(ValueError):
        JC.load_checkpoint(jax_path, jparams,
                           optax.adam(1e-5).init(jparams))
    params = torch.nn.ModuleDict({"fc": torch.nn.Linear(3, 2)})
    opt2 = torch.optim.Adam(params.parameters(), lr=TSOL.LR)
    with pytest.raises(ValueError, match="LR_DECAY"):
        TC.load_checkpoint(port, params, opt2)
    assert opt2.param_groups[0]["lr"] == TSOL.LR      # nothing was loaded
    # what stays: the decayed resume, and a params-only load
    sched2 = TSOL._lr_scheduler(opt2, 4)
    TC.load_checkpoint(port, params, opt2, sched2)
    assert opt2.param_groups[0]["lr"] == pytest.approx(1e-7)
    TC.load_pretrained(torch.nn.ModuleDict({"fc": torch.nn.Linear(3, 2)}),
                       port)
