"""Multi-device dry run (__graft_entry__.py:35-190, dryrun_multichip): one
data-parallel train step, the frame-parallel detector and the row-sharded
detector over n ranks, each detector held to the single-frame one.

    python -m mv3d_tf_tpu_torch.parallel.dryrun --n 2 [--backend gloo] \\
        [--device cuda|cpu] [--fc_dim 2048]

``spawn`` starts the ranks: one process each, a torch.distributed group
over a FileStore in a temporary directory (no port to collide on), the
backend named by the caller (NCCL by default on the card, gloo on the
CPU; NCCL refuses two ranks on one card, so one card takes two ranks only
with gloo). A rank that raises or outlives the timeout makes ``spawn``
raise; the other ranks are killed. The kernels are built once in the
caller before the ranks start, and the ranks load the built library.
"""

import argparse
import datetime
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mv3d_tf_tpu_torch.parallel import mesh as M

# the dry run's shapes (__graft_entry__.py:106-150): an 81x81 BEV, an
# 88x120 image, a 10x10 feature map, pre-NMS 50, post-NMS 10, 8 rois
DRY = dict(feat_h=10, feat_w=10, pre_nms_top_n=50, post_nms_top_n=10)
DRY_ROIS, DRY_GT = 8, 4
DRY_BEV, DRY_IMAGE = (81, 81, 9), (88, 120, 3)
_FORBIDDEN = ("jax", "jaxlib", "mv3d_tf_tpu")


def _rank_main(rank, n, fn, args, backend, device, tmp, timeout):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(M.make_mesh(device=device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, "rank%d.pt" % rank))
    except BaseException:
        with open(os.path.join(tmp, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


def _raise_failed(procs, tmp):
    """Raise with the first failed rank's traceback, if one failed."""
    for r, p in enumerate(procs):
        if p.exitcode:
            err = os.path.join(tmp, "rank%d.err" % r)
            msg = (open(err).read() if os.path.exists(err)
                   else "exit code %d" % p.exitcode)
            raise RuntimeError("rank %d of %d failed:\n%s"
                               % (r, len(procs), msg))


def spawn(fn, n, *args, backend=None, device="cuda", timeout=600):
    """Run fn(mesh, *args) on n ranks, one process each, and return their
    results in rank order (fn's module must be importable: a spawned
    process imports it anew).

    backend defaults to "nccl" on a CUDA device and "gloo" on the CPU.
    Raises with the rank's traceback if a rank fails, and if the ranks
    have not all ended within timeout seconds."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if backend == "nccl" and dev.index is None \
                and n > torch.cuda.device_count():
            raise ValueError(
                "NCCL refuses two ranks on one GPU: %d ranks over %d "
                "card(s) need backend='gloo'" % (n, torch.cuda.device_count()))
        from mv3d_tf_tpu_torch import kernels
        kernels.library()               # build here, once; the ranks load it
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            r, n, fn, args, backend, device, tmp, timeout)) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                _raise_failed(procs, tmp)
                running = [p.sentinel for p in procs if p.exitcode is None]
                if not running:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("%d ranks still running after %d s"
                                       % (n, timeout))
                multiprocessing.connection.wait(running, min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, "rank%d.pt" % r),
                           weights_only=False) for r in range(n)]


# --------------------------------------------------------------------------
# The ranks' work
# --------------------------------------------------------------------------

def _launches():
    """The counts of the kernels these paths reach (each wrapper counts
    its own launches in this process)."""
    from mv3d_tf_tpu_torch.ops.roi_pool_cuda import (roi_pool_bwd_cuda,
                                                     roi_pool_cuda)
    from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import stem_s2d_fused_cuda
    return {"roi_pool": roi_pool_cuda.launches,
            "roi_pool_bwd": roi_pool_bwd_cuda.launches,
            "vgg_stem": stem_s2d_fused_cuda.launches}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(ms, fn()) on the host clock between device syncs."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3, out


def _cpu(tree):
    """A copy on the CPU (never a view of a tensor that may change)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _draws_to(draws, device):
    return {k: (tuple(m.to(device) for m in v) if k == "drop"
                else v.to(device)) for k, v in draws.items()}


def _check_replicas(mesh, params):
    """Raise unless every rank holds rank 0's parameters bit for bit."""
    flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0, group=mesh.group)
    same = torch.tensor([int(torch.equal(flat, ref))], device=mesh.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    if not same.item():
        raise AssertionError("the ranks' parameters differ after the step")


def run_checks(mesh, spec):
    """One rank's part of a multi-device run, as spec says:

      seed, fc_dim  the parameters (utils/weights.he_normal_params); ranks
                    other than 0 start from seed + 1, and replicate gives
                    them rank 0's; with return_params, rank 0 returns
                    them and their all-reduced gradients after each train
                    run's first step;
      train         a list of {"batch": B frames, "draws": B draws on the
                    CPU, "kwargs": train.build_forward_losses', "lr",
                    "timed_steps"}: one parallel step each from the same
                    parameters, then timed_steps more, timed;
      detect        {"bev", "image", "calib": B frames, "kwargs":
                    eval.build_detect_batch_fn's, "timed_calls"}: the
                    frame-parallel detector;
      spatial       a list of {"bev", "image", "calib": one frame,
                    "kwargs": eval.build_detect_fn's, "timed_calls"}: the
                    row-sharded detector.

    The detectors run on the replicated starting parameters. Returns the
    broadcast's ms and per run its outputs, ms and kernel launches, on the
    CPU.
    """
    loaded = [m for m in sys.modules if m.split(".")[0] in _FORBIDDEN]
    if loaded:
        raise RuntimeError("a rank loaded %s" % loaded[:5])
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                  params_from_jax)
    dev = mesh.device
    params = params_from_jax(he_normal_params(
        spec["seed"] + (mesh.rank > 0), fc_dim=spec["fc_dim"]), device=dev)
    ms, _ = _timed(lambda: M.replicate(mesh, params), dev)
    out = {"rank": mesh.rank, "broadcast_ms": ms, "train": [], "spatial": []}
    start = [p.detach().clone() for p in params.parameters()]

    def restart():
        with torch.no_grad():
            for p, s in zip(params.parameters(), start):
                p.copy_(s)

    for tr in spec.get("train", ()):
        restart()
        step, make_opt = M.build_parallel_train_step(
            mesh, lr=tr.get("lr", 1e-5), **tr["kwargs"])
        opt = make_opt(params)
        draws = [_draws_to(d, dev) for d in tr["draws"]]
        before = _launches()
        ms, metrics = _timed(lambda: step(params, opt, tr["batch"], draws),
                             dev)
        res = {"metrics": {k: v.item() for k, v in metrics.items()},
               "ms": [ms]}
        _check_replicas(mesh, params)
        if mesh.rank == 0 and spec.get("return_params"):
            res["params"] = {k: _cpu(m.state_dict())
                             for k, m in params.items()}
            res["grads"] = {k: {"weight": _cpu(m.weight.grad),
                                "bias": _cpu(m.bias.grad)}
                            for k, m in params.items()}
        for _ in range(tr.get("timed_steps", 0)):
            res["ms"].append(_timed(
                lambda: step(params, opt, tr["batch"], draws), dev)[0])
        res["launches"] = _since(before)
        out["train"].append(res)
    restart()                   # the detectors run on the replicated params
    del start

    det = spec.get("detect")
    if det is not None:
        detect = M.build_parallel_detect(mesh, **det["kwargs"])
        args = (params, det["bev"], det["image"], det["calib"])
        before = _launches()
        ms, got = _timed(lambda: detect(*args), dev)
        res = {"out": _cpu(got), "ms": [ms]}
        res["ms"] += [_timed(lambda: detect(*args), dev)[0]
                      for _ in range(det.get("timed_calls", 0))]
        res["launches"] = _since(before)
        out["detect"] = res

    for sp in spec.get("spatial", ()):
        detect = M.build_spatial_detect(mesh, **sp["kwargs"])
        args = (params, sp["bev"], sp["image"], sp["calib"])
        before = _launches()
        ms, got = _timed(lambda: detect(*args), dev)
        res = {"out": _cpu(got), "ms": [ms]}
        res["ms"] += [_timed(lambda: detect(*args), dev)[0]
                      for _ in range(sp.get("timed_calls", 0))]
        res["launches"] = _since(before)
        out["spatial"].append(res)
    return out


# --------------------------------------------------------------------------
# The dry run
# --------------------------------------------------------------------------

def dry_batch(b, seed=0):
    """b frames at the dry run's shapes (__graft_entry__.py:106-141): random
    BEV and image, the example calib, one gt car per frame on an inside
    anchor, DRY_GT rows padded."""
    from mv3d_tf_tpu_torch import geometry as G
    from mv3d_tf_tpu_torch.anchors import get_anchor_grid
    from mv3d_tf_tpu_torch.tools.profiling import example_calib
    rng = np.random.RandomState(seed)
    grid = get_anchor_grid(DRY["feat_h"], DRY["feat_w"])
    inside = np.where(grid.inside)[0]
    gt_bv = np.zeros((b, DRY_GT, 5), np.float32)
    gt_3d = np.zeros((b, DRY_GT, 7), np.float32)
    gt_3d[..., 3:6] = 1.0
    gt_cnr = np.zeros((b, DRY_GT, 25), np.float32)
    for f in range(b):
        a = inside[(f * 53 + 40) % len(inside)]
        gt_bv[f, 0, :4] = grid.anchors_bv[a]
        box = G.bv_anchor_to_lidar(torch.from_numpy(gt_bv[f, :1, :4]))
        gt_3d[f, 0, :6] = box[0].numpy()
        gt_cnr[f, 0, :24] = G.lidar_3d_to_corners(box)[0].numpy()
        gt_bv[f, 0, 4] = gt_3d[f, 0, 6] = gt_cnr[f, 0, 24] = 1.0
    return {"bev": rng.rand(b, *DRY_BEV).astype(np.float32),
            "image": (rng.rand(b, *DRY_IMAGE) * 255).astype(np.float32),
            "calib": np.repeat(example_calib()[None], b, 0),
            "gt_boxes_bv": gt_bv, "gt_boxes_3d": gt_3d,
            "gt_boxes_corners": gt_cnr,
            "gt_valid": np.arange(DRY_GT)[None].repeat(b, 0) < 1}


def dry_draws(b, fc_dim, seed=1):
    """The b frames' train draws (train.make_draws) from one CPU generator."""
    from mv3d_tf_tpu_torch.train import make_draws
    gen = torch.Generator().manual_seed(seed)
    return [make_draws(gen, DRY["feat_h"] * DRY["feat_w"] * 4,
                       DRY["post_nms_top_n"] + DRY_GT, DRY_ROIS, fc_dim, 0.5,
                       "cpu") for _ in range(b)]


DET_KEYS = ("scores", "boxes_bv", "boxes_cnr_r", "valid")


def check_close(got, ref, what, tol=1e-5, keys=DET_KEYS):
    """Raise unless every key of two detection dicts agrees within tol."""
    for k in keys:
        g, r = got[k].float().cpu(), ref[k].float().cpu()
        err = (g - r).abs().max().item() if g.numel() else 0.0
        if g.shape != r.shape or not err <= tol + tol * r.abs().max().item():
            raise AssertionError("%s: %s differs by %s (shapes %s, %s)"
                                 % (what, k, err, tuple(g.shape),
                                    tuple(r.shape)))


def run_all(mesh, specs):
    """run_checks over each spec in turn, on the same ranks."""
    return [run_checks(mesh, spec) for spec in specs]


def dry_spec(n, fc_dim=2048):
    """The dry run's run_checks spec over n frames (one a rank): one
    parallel train step, the frame-parallel detector over the n frames and
    the row-sharded detector on frame 0, on he_normal_params(0)."""
    batch = dry_batch(n)
    frames = {k: batch[k] for k in ("bev", "image", "calib")}
    return {"seed": 0, "fc_dim": fc_dim,
            "train": [{"batch": batch, "draws": dry_draws(n, fc_dim),
                       "kwargs": dict(DRY, rois_per_image=DRY_ROIS)}],
            "detect": dict(frames, kwargs=DRY),
            "spatial": [dict({k: v[0] for k, v in frames.items()},
                             kwargs=DRY)]}


def check_dry(results, spec, device="cuda", backend=None, log=print):
    """Hold the ranks' results of dry_spec: a finite loss, equal on every
    rank; the frame-parallel detector's frames 0 and n-1 and the
    row-sharded detector within 1e-5 of the single-frame detector on
    this process's device. Raises on any failure."""
    from mv3d_tf_tpu_torch.eval import build_detect_fn
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                  params_from_jax)
    n = len(results)
    loss = results[0]["train"][0]["metrics"]["loss"]
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in the dry run: %s" % loss)
    if any(r["train"][0]["metrics"] != results[0]["train"][0]["metrics"]
           for r in results):
        raise AssertionError("the ranks' metrics differ")
    log("dryrun_multidevice(%d): loss=%.4f on %d ranks (%s, %s)"
        % (n, loss, n, backend or ("nccl" if torch.device(device).type
                                   == "cuda" else "gloo"), device))

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    params = params_from_jax(he_normal_params(spec["seed"],
                                              fc_dim=spec["fc_dim"]),
                             device=dev)
    single = build_detect_fn(**DRY)
    frames = spec["detect"]
    det = results[0]["detect"]["out"]
    for f in sorted({0, n - 1}):
        one = single(params, frames["bev"][f], frames["image"][f],
                     frames["calib"][f])
        check_close({k: v[f] for k, v in det.items()}, one,
                    "frame-parallel detect, frame %d" % f)
    log("dryrun_multidevice(%d): sharded detect ok (%d valid rois across "
        "%d frames)" % (n, int(det["valid"].sum()), n))
    one = single(params, frames["bev"][0], frames["image"][0],
                 frames["calib"][0])
    check_close(results[0]["spatial"][0]["out"], one, "row-sharded detect")
    log("dryrun_multidevice(%d): spatial-sharded detect ok" % n)


def dryrun_multidevice(n, device="cuda", backend=None, fc_dim=2048,
                       timeout=600, log=print, extra=()):
    """One parallel train step over n frames (one a rank), then the
    frame-parallel detector over the same frames and the row-sharded
    detector on frame 0, each held to the single-frame detector within
    1e-5 (frames 0 and n-1). The same ranks then run each run_checks spec
    of extra, so a caller with more multi-device work starts the ranks
    once. Raises on any failure; returns, for the dry run and then each
    spec of extra, the ranks' results (run_checks) in rank order."""
    spec = dry_spec(n, fc_dim)
    specs = [spec] + list(extra)
    ranks = spawn(run_all, n, specs, backend=backend, device=device,
                  timeout=timeout)
    results = [[r[i] for r in ranks] for i in range(len(specs))]
    check_dry(results[0], spec, device=device, backend=backend, log=log)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-device dry run")
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--fc_dim", type=int, default=2048)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args(argv)
    dryrun_multidevice(args.n, device=args.device, backend=args.backend,
                       fc_dim=args.fc_dim, timeout=args.timeout)


if __name__ == "__main__":
    main()
