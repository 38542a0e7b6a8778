"""MV3D training, one frame a step as tools.train_net runs it: a closed loop
over train.build_train_step's train_step (the configuration's "train":
pre-/post-NMS 12000/2000, 128 rois, Adam at 1e-5, bfloat16), each step on
the next frame of a pool held on the card, with that step's draws
(train.make_draws) made on the card from the run's seed. A call ends with
the step's loss on the host.

The rasters are made in set-up by the reference's rasterizer, and the
ground truth is the scans' own cars (traffic/frames_gt.py). The judgement
replays two steps for each of the first JUDGED frames that the window
trained, that frame's and the next one's of the pool: from the
configuration's weights, through the same entry and one optimizer, with
the draws those frames last had in the window; the program's anchor
labels, proposals and RCNN minibatch are recorded on the way (the target
layers wrapped for the replay), its losses returned, its gradients and
updates read from the parameters. The float32 reference recomputes each
step at the program's parameters and proposals, judges the proposals by
what greedy NMS promises, and Adam's two updates from the program's
gradients (reference/mv3d_train.py)."""

import contextlib

import torch

from benchmark.drivers.base import Driver as BaseDriver
from benchmark.drivers.mv3d_common import crop_raster
from benchmark.lib import roofline as R
from benchmark.reference import mv3d as det
from benchmark.reference import mv3d_train as ref
from benchmark.reference import nets
from benchmark.reference.ops import point_cloud_2_top_np
from benchmark.traffic import frames_gt

JUDGED = 4


def fp8_through(x):
    """The control's rounding with its gradient passed straight through:
    float8 e4m3 values forward, the rounded operands saved for the
    backward pass."""
    return x + (nets.fp8(x.detach()) - x.detach())


@contextlib.contextmanager
def recording(train_module, rec):
    """train's two target layers wrapped, for one replayed step, so that
    their inputs and outputs land in rec."""
    anchor, roi = (train_module.anchor_target_layer,
                   train_module.proposal_target_layer_3d)

    def anchor_rec(*a, **kw):
        out = anchor(*a, **kw)
        rec["anchor_labels"] = out[0]
        return out

    def roi_rec(u_fg, u_bg, rois_bv, rois_3d, valid, *a, **kw):
        rec["props"] = {"rois_bv": rois_bv, "rois_3d": rois_3d,
                        "valid": valid}
        out = roi(u_fg, u_bg, rois_bv, rois_3d, valid, *a, **kw)
        rec["rois"] = out
        return out

    train_module.anchor_target_layer = anchor_rec
    train_module.proposal_target_layer_3d = roi_rec
    try:
        yield rec
    finally:
        train_module.anchor_target_layer = anchor
        train_module.proposal_target_layer_3d = roi


class Driver(BaseDriver):
    ITEMS_METRIC = "frames_per_s"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mv3d_tf_tpu_torch import train
        self.T = train
        pool = frames_gt.make(traffic, seed)
        h, w = cfg["image_hw"]
        dev = device
        self.frames = []
        for f in range(traffic["pool"]):
            raster = crop_raster(point_cloud_2_top_np(pool["scans"][f]),
                                 cfg["bev_hw"])
            frame = {"bev": torch.from_numpy(raster),
                     "image": torch.from_numpy(pool["images"][f][:h, :w]
                                               .copy()),
                     "calib": torch.from_numpy(pool["calib"]),
                     **pool["gt"][f]}
            self.frames.append({k: v.to(dev) for k, v in frame.items()})
        t = cfg["train"]
        self.feat_hw = (cfg["bev_hw"][0] // 8, cfg["bev_hw"][1] // 8)
        self.step_kw = dict(
            feat_h=self.feat_hw[0], feat_w=self.feat_hw[1],
            pre_nms_top_n=t["pre_nms_top_n"],
            post_nms_top_n=t["post_nms_top_n"],
            rpn_nms_thresh=cfg["test"]["rpn_nms_thresh"],
            rois_per_image=t["rois_per_image"], keep_prob=ref.KEEP_PROB,
            lr=t["lr"], compute_dtype=getattr(torch, cfg["dtype"]))
        n_gt = len(pool["gt"][0]["gt_valid"])
        self.draw_args = (self.feat_hw[0] * self.feat_hw[1]
                          * cfg["num_anchors"],
                          t["post_nms_top_n"] + n_gt, t["rois_per_image"],
                          cfg["fc_dim"], ref.KEEP_PROB, dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed % (1 << 63))
        self.p_step, make_opt = train.build_train_step(**self.step_kw)
        self.p_params = self.params()
        self.p_opt = make_opt(self.p_params)
        self.draws, self.losses = {}, {}
        self.warm_up(traffic["pool"])

    def call(self, i):
        f = i % len(self.frames)
        draws = self.T.make_draws(self.gen, *self.draw_args)
        metrics = self.p_step(self.p_params, self.p_opt, self.frames[f],
                              draws)
        self.draws[f] = draws
        self.losses[f] = float(metrics["loss"])
        self.kept[f] = True
        return 1

    def flops_per_item(self):
        """A step's FLOPs: three times the forward's (the forward, and the
        backward's two products a layer) over both trunks, the RPN and the
        fusion head on the sampled rois."""
        cfg, t = self.cfg, self.cfg["train"]
        bev, (h, w) = R.vgg16_flops(*cfg["bev_hw"], cfg["bev_channels"], 8)
        img, _ = R.vgg16_flops(*cfg["image_hw"], 3, 8)
        fc, k = cfg["fc_dim"], cfg["num_classes"]
        pooled = 512 * cfg["pooled"] ** 2
        head = 2 * t["rois_per_image"] * (2 * (pooled * fc + fc * fc)
                                          + 2 * fc * k * 25)
        return 3 * (bev + img + R.rpn_flops(h, w, cfg["num_anchors"], 6)
                    + head)

    def stages(self):
        return {}

    def replay(self, frames):
        """The program's steps on frames in turn, one optimizer, from the
        configuration's weights, each with the window's draws of its frame:
        per step {"weights" (the parameters it started from, the
        reference's layout), "losses", "grads", "updates",
        "anchor_labels", "rois", "props"}."""
        train = self.T
        params = self.params()
        step, make_opt = train.build_train_step(**self.step_kw)
        opt = make_opt(params)
        out = []
        for f in frames:
            before = {k.replace("__", "/"): (m.weight.detach().clone(),
                                             m.bias.detach().clone())
                      for k, m in params.items()}
            with recording(train, {}) as rec:
                metrics = step(params, opt, self.frames[f], self.draws[f])
            r = {"weights": before,
                 "losses": {k: float(metrics[k]) for k in ref.LOSSES},
                 "grads": {}, "updates": {}}
            for k, m in params.items():
                name = k.replace("__", "/")
                r["grads"][name] = tuple(
                    torch.zeros_like(p) if p.grad is None else p.grad.clone()
                    for p in (m.weight, m.bias))
                r["updates"][name] = (m.weight.detach() - before[name][0],
                                      m.bias.detach() - before[name][1])
            r.update(rec)
            out.append(r)
        return out

    def judge(self, control=False):
        """Each of the first JUDGED frames the window trained, and the
        frame after it in the pool, replayed as two steps (replay), each
        step recomputed by the reference at the program's parameters and
        proposals (reference/mv3d_train.py). The control puts the
        reference's steps in float8 in the program's place: its gradients,
        its own proposal layer and its Adam."""
        nets.no_tf32()
        t = self.cfg["train"]
        lr = t["lr"]
        nms = (t["pre_nms_top_n"], t["post_nms_top_n"],
               self.cfg["test"]["rpn_nms_thresh"])
        replays = []
        for f in sorted(self.kept)[:JUDGED]:
            frames = (f, (f + 1) % len(self.frames))
            steps = []
            for g, got in zip(frames, self.replay(frames)):
                frame, w = self.frames[g], got["weights"]
                props = {k: v.detach() for k, v in got["props"].items()}
                want = ref.step(w, frame, self.draws[g], props)
                a = det.anchors_all(w, want["c5"], frame["calib"])
                if control:
                    ctl = ref.step(w, frame, self.draws[g], props,
                                   q=fp8_through)
                    ctl_a = det.anchors_all(w, ctl["c5"], frame["calib"],
                                            q=fp8_through)
                    got = dict(got, losses=ctl["losses"], grads=ctl["grads"],
                               anchor_labels=ctl["anchor_labels"],
                               rois=ctl["rois"],
                               props=ref.proposals(ctl_a, *nms), updates={})
                steps.append((ref.judge_step(want, got, a, nms), got))
            if control:
                for name in steps[0][1]["grads"]:
                    w, b = (ref.adam([got["grads"][name][i]
                                      for _, got in steps], lr, q=nets.fp8)
                            for i in (0, 1))
                    for (_, got), dw, db in zip(steps, w, b):
                        got["updates"][name] = (dw, db)
            replays.append(steps)
        out = ref.judge_replays(replays, lr)
        out["nonfinite_loss"] = int(not all(
            torch.isfinite(torch.tensor(v)) for v in self.losses.values()))
        return out
