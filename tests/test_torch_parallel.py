"""The port's multi-device layer (mv3d_tf_tpu_torch/parallel/mesh.py) on two
gloo ranks on the CPU, against the port's one-process step and
single-frame detector and against the JAX package's parallel/mesh.py on a
2-device sub-mesh of the 8 fake CPU devices, at the dry run's shapes (81x81
BEV, 88x120 image, 10x10 features, pre-NMS 50, post-NMS 10, 8 rois).

The ranks run the dry run (parallel/dryrun.dryrun_multidevice) and then
this module's parallel/dryrun.run_checks spec in spawned processes (no
jax, no test module), from a background thread while this process jits
the JAX references. Tolerances: the metrics within 1e-5 of the total
loss; the all-reduced gradients within 1e-4 of each leaf's largest
(tests/test_torch_train.py's) of the mean-loss gradients taken frame by
frame apart from the parallel step, and of JAX's parallel step's; the
parameters after one Adam step within 2 lr (the first Adam update is
+-lr wherever a gradient is not noise, and a noise gradient's sign may
flip: ROADMAP.md), a bound that no gradient can miss, so it stands only
beside the gradients'; detections within rtol 1e-5, atol 1e-5
(tests/test_sharding.py's), valid equal."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mv3d_tf_tpu.eval import build_detect_fn as j_build_detect_fn  # noqa: E402
from mv3d_tf_tpu.parallel import mesh as JM  # noqa: E402
from mv3d_tf_tpu_torch import train as TR  # noqa: E402
from mv3d_tf_tpu_torch.eval import build_detect_fn  # noqa: E402
from mv3d_tf_tpu_torch.parallel import dryrun as D  # noqa: E402
from mv3d_tf_tpu_torch.parallel import mesh as M  # noqa: E402
from mv3d_tf_tpu_torch.tools.profiling import example_calib  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,  # noqa: E402
                                             params_from_jax)

FC, LR = 16, 1e-5
HE_SEED, FRAME_SEED, STEP_KEY = 21, 0, 1
DETECT_SEEDS, SPATIAL_SEED = (1, 2, 3, 4), 6
TRAIN_KW = dict(D.DRY, rois_per_image=D.DRY_ROIS)
KEYS = ("scores", "boxes_bv", "boxes_cnr_r", "valid")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread in this worker while the module runs: its shapes
    are tiny, and under xdist's parallel workers the default thread pool
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_draws(key, n_anchors, n_all, n_rois, fc, keep_prob=0.5):
    """The draws JAX's per-frame forward makes from its key (train.py:122,
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


def _frames(seeds, rows=81):
    out = []
    for s in seeds:
        rng = np.random.RandomState(s)
        out.append((rng.rand(rows, 81, 9).astype(np.float32),
                    (rng.rand(88, 120, 3) * 255).astype(np.float32),
                    example_calib()))
    return [np.stack(x) for x in zip(*out)]


def _case():
    batch = D.dry_batch(2, seed=FRAME_SEED)
    keys = jax.random.split(jax.random.PRNGKey(STEP_KEY), 2)
    draws = [_jax_draws(k, 400, D.DRY["post_nms_top_n"] + D.DRY_GT,
                        D.DRY_ROIS, FC) for k in keys]
    bev, image, calib = _frames(DETECT_SEEDS)
    sbev, simage, scalib = (a[0] for a in _frames([SPATIAL_SEED]))
    spec = {"seed": HE_SEED, "fc_dim": FC, "return_params": True,
            "train": [{"batch": batch, "draws": draws, "kwargs": TRAIN_KW,
                       "lr": LR}],
            "detect": {"bev": bev, "image": image, "calib": calib,
                       "kwargs": D.DRY},
            "spatial": [{"bev": sbev, "image": simage, "calib": scalib,
                         "kwargs": D.DRY}]}
    return spec, keys


def _keep_grads():
    """An optax transformation that passes the updates on unchanged and
    keeps them, the step's gradients, as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def case():
    """The spec, the ranks' results (spawned in a thread now, joined on
    first use: the dry run's at fc 16, its log, then this spec's) and the
    JAX references computed meanwhile."""
    spec, keys = _case()
    box = {"log": []}

    def run():
        try:
            box["dry"], box["ranks"] = D.dryrun_multidevice(
                2, device="cpu", backend="gloo", fc_dim=FC, timeout=300,
                log=box["log"].append, extra=[spec])
        except BaseException as e:     # re-raised in the test thread
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    p = he_normal_params(HE_SEED, fc_dim=FC)
    mesh = JM.make_mesh(jax.devices()[:2])
    step, tx = JM.build_parallel_train_step(
        mesh, optimizer=optax.chain(_keep_grads(), optax.adam(LR)),
        **TRAIN_KW)
    jp, jstate, jm = step(JM.replicate(mesh, p),
                          JM.replicate(mesh, tx.init(p)),
                          JM.shard_batch(mesh, spec["train"][0]["batch"]),
                          keys)
    single = j_build_detect_fn(**D.DRY)
    det = spec["detect"]
    jdet = [single(p, det["bev"][b], det["image"][b], det["calib"][b])
            for b in range(4)]
    sp = spec["spatial"][0]
    jspatial = single(p, sp["bev"], sp["image"], sp["calib"])
    jax_ref = {"params": jax.tree.map(np.asarray, jp),
               "grads": jax.tree.map(np.asarray, jstate[0]),
               "metrics": {k: float(v) for k, v in jm.items()},
               "detect": [{k: np.asarray(v) for k, v in o.items()}
                          for o in jdet],
               "spatial": {k: np.asarray(v) for k, v in jspatial.items()}}
    thread.join(timeout=400)
    if thread.is_alive():
        raise TimeoutError("the ranks' thread still runs after 400 s")
    if "error" in box:
        raise box["error"]
    return spec, box["ranks"], jax_ref, box["dry"], box["log"]


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, and its mesh."""
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        yield M.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _one_process_step(spec, mesh):
    """The parallel step on one rank over both frames."""
    params = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                             device="cpu")
    tr = spec["train"][0]
    step, make_opt = M.build_parallel_train_step(mesh, lr=LR, **TRAIN_KW)
    metrics = step(params, make_opt(params), tr["batch"], tr["draws"])
    return params, {k: v.item() for k, v in metrics.items()}


def _close(got, ref, what):
    for k in KEYS:
        g, r = np.asarray(got[k], np.float32), np.asarray(ref[k], np.float32)
        if k == "valid":
            np.testing.assert_array_equal(g, r, err_msg=what + " " + k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5,
                                       err_msg=what + " " + k)


def _frame_grads(spec):
    """Each frame's gradients of its loss over the global frame count,
    frame by frame through train.build_forward_losses and
    torch.autograd.grad: a reference apart from the parallel step."""
    params = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                             device="cpu")
    tr = spec["train"][0]
    fwd = TR.build_forward_losses(**TRAIN_KW)
    names = [(k, sub) for k in params for sub in ("weight", "bias")]
    leaves = [getattr(params[k], sub) for k, sub in names]
    n, out = len(tr["draws"]), []
    for i in range(n):
        frame = {k: torch.as_tensor(v[i]) for k, v in tr["batch"].items()}
        loss = fwd(params, frame, tr["draws"][i])["loss"] / n
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append({name: torch.zeros_like(t) if g is None else g
                    for name, t, g in zip(names, leaves, grads)})
    return out


def _grad_errors(got, ref):
    """Per leaf, max |got - ref| over the largest |ref| (got's None a
    zero gradient)."""
    errs = {}
    for (key, sub), r in ref.items():
        g = got[key][sub]
        g = torch.zeros_like(r) if g is None else g
        errs[key + "." + sub] = ((g - r).abs().max()
                                 / r.abs().max().clamp_min(1e-30)).item()
    return errs


def test_two_rank_train_step_matches_one_process_and_jax(case, world1):
    spec, ranks, jax_ref = case[:3]
    got = ranks[0]["train"][0]
    assert ranks[1]["train"][0]["metrics"] == got["metrics"]
    assert "params" not in ranks[1]["train"][0]
    params1, metrics1 = _one_process_step(spec, world1)
    # no group: the same step, bit for bit
    params0, metrics0 = _one_process_step(spec, None)
    assert metrics0 == metrics1
    for a, b in zip(params0.parameters(), params1.parameters()):
        assert torch.equal(a, b)
    total = abs(metrics1["loss"])
    assert set(got["metrics"]) == set(metrics1) == set(jax_ref["metrics"])
    for k, v in metrics1.items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * total, k
        np.testing.assert_allclose(got["metrics"][k], jax_ref["metrics"][k],
                                   rtol=1e-5, err_msg=k)

    # the all-reduced gradients: the mean over both frames, of the port
    # frame by frame and of JAX's parallel step
    frames = _frame_grads(spec)
    mean = {k: frames[0][k] + frames[1][k] for k in frames[0]}
    jgrads = params_from_jax(jax_ref["grads"], device="cpu")
    jmean = {(k, sub): getattr(jgrads[k], sub).detach() for k, sub in mean}
    for what, ref in (("the port's frames", mean), ("JAX", jmean)):
        errs = _grad_errors(got["grads"], ref)
        bad = {k: e for k, e in errs.items() if not e <= 1e-4}
        assert not bad, (what, bad)
    # the check can fail: rank 0's gradient in place of the sum (rank 1's
    # frame dropped), or each frame's loss over the local frame count, is
    # off by far more than 1e-4
    for wrong in (frames[0], {k: 2 * v for k, v in mean.items()}):
        assert max(_grad_errors(got["grads"], wrong).values()) > 0.1
    # at these shapes no roi reaches the image view: its trunk, fc6_2 and
    # fc7_2 get zero gradients (so do JAX's); the other 40 leaves get some
    assert sum(int(g.abs().max() > 0) for g in mean.values()) == 40

    # after Adam (beside the gradients: one step moves no parameter by
    # more than lr, whatever its gradient)
    jparams = params_from_jax(jax_ref["params"], device="cpu")
    start = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                            device="cpu")
    moved = 0
    for key, m in params1.items():
        for sub in ("weight", "bias"):
            two = got["params"][key][sub]
            one = getattr(m, sub).detach()
            ref = getattr(jparams[key], sub).detach()
            assert (two - one).abs().max() <= 2 * LR, key + sub
            assert (two - ref).abs().max() <= 2 * LR * (1 + 1e-3), key + sub
            moved += int((two != getattr(start[key], sub)).sum())
    assert moved > 0.25 * sum(p.numel() for p in start.parameters())


def test_dryrun_multidevice_on_two_gloo_ranks(case):
    """dryrun_multidevice(2, device="cpu", backend="gloo") at fc 16, run
    by the fixture on the ranks that then run this module's spec."""
    dry, log = case[3], "\n".join(case[4])
    assert "loss=" in log and "sharded detect ok" in log
    assert "spatial-sharded detect ok" in log
    assert [r["rank"] for r in dry] == [0, 1]
    assert dry[0]["detect"]["out"]["scores"].shape == (2, 10, 2)
    # no kernel on the CPU
    assert not any(dry[0]["train"][0]["launches"].values())


def test_frame_parallel_detect_matches_single_frame(case):
    spec, ranks, jax_ref = case[:3]
    det = spec["detect"]
    params = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                             device="cpu")
    single = build_detect_fn(**D.DRY)
    for r in ranks:                     # every rank holds the whole batch
        assert all(v.shape[0] == 4 for v in r["detect"]["out"].values())
    out = ranks[0]["detect"]["out"]
    assert torch.equal(out["scores"], ranks[1]["detect"]["out"]["scores"])
    assert int(out["valid"].sum()) >= 20
    for b in range(4):
        one = single(params, det["bev"][b], det["image"][b], det["calib"][b])
        got = {k: v[b] for k, v in out.items()}
        _close(got, one, "frame %d vs the port" % b)
        _close(got, jax_ref["detect"][b], "frame %d vs JAX" % b)


def test_parallel_detect_with_a_single_frame_detector(case, world1):
    """build_parallel_detect(detect_single=...) runs a rank's frames one by
    one: on one rank, the batched route's dict."""
    det = case[0]["detect"]
    params = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                             device="cpu")
    args = (params, det["bev"], det["image"], det["calib"])
    one = M.build_parallel_detect(world1, build_detect_fn(**D.DRY))(*args)
    batched = M.build_parallel_detect(world1, **D.DRY)(*args)
    assert set(one) == set(batched) | {"rois_img"}
    for b in range(4):
        _close({k: v[b] for k, v in one.items()},
               {k: v[b] for k, v in batched.items()}, "frame %d" % b)


def test_row_sharded_detect_matches_single_frame(case):
    spec, ranks, jax_ref = case[:3]
    sp = spec["spatial"][0]
    params = params_from_jax(he_normal_params(HE_SEED, fc_dim=FC),
                             device="cpu")
    one = build_detect_fn(**D.DRY)(params, sp["bev"], sp["image"],
                                   sp["calib"])
    got = ranks[0]["spatial"][0]["out"]
    assert int(got["valid"].sum()) >= 5
    _close(got, one, "row-sharded vs the port")
    _close(got, jax_ref["spatial"], "row-sharded vs JAX")
    _close(ranks[1]["spatial"][0]["out"], got, "rank 1 vs rank 0")


def test_shard_rows_and_batch():
    class FakeMesh:
        size = 4
        device = torch.device("cpu")

        def __init__(self, rank):
            self.rank = rank

    rows = [M.shard_rows(FakeMesh(r), 8) for r in range(4)]
    assert rows == [(0, 2), (2, 4), (4, 6), (6, 8)]
    got = M.shard_batch(FakeMesh(2), {"x": np.arange(8.0)})
    assert got["x"].tolist() == [4.0, 5.0]
    with pytest.raises(ValueError, match="do not split"):
        M.shard_rows(FakeMesh(0), 6)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        M.make_mesh(device="cpu")
