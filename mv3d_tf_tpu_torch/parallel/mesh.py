"""Multi-device runs on torch.distributed (mv3d_tf_tpu/parallel/mesh.py): one
process per device, the frame batch split over the ranks.

The JAX package lays out a 1-D ``data`` mesh and lets XLA insert the
collectives from sharding annotations. PyTorch has no partitioner, so the
port spells each collective out:

  * ``build_parallel_train_step``: each rank runs its frames' forward and
    backward (train.build_forward_losses, one frame at a time), its loss
    divided by the global frame count, then one all_reduce (sum) over a
    flat bucket of the gradients; Adam steps alike on every rank;
  * ``build_parallel_detect``: each rank detects its frames
    (eval.build_detect_batch_fn) and the outputs are all_gathered, so
    every rank holds the whole batch's dict;
  * ``build_spatial_detect``: one frame's rows split over the ranks by halo
    recompute. Each rank runs both trunks on its band of input rows widened
    by the trunk's receptive-field halo, keeps its own band of feature rows,
    and the bands are all_gathered into the whole conv5_3 maps; the RPN,
    proposals, ROI pools and fusion head then run replicated.

The process group comes from the caller (torchrun's environment, or
parallel/dryrun.spawn). Collectives take the tensors where they lie: a
backend that refuses a CUDA tensor raises, nothing is copied to the host
here.
"""

import dataclasses
import os

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from mv3d_tf_tpu_torch import train as train_mod
from mv3d_tf_tpu_torch.models import vgg

METRICS = ("loss", "rpn_cross_entropy", "rpn_loss_box", "cross_entropy",
           "loss_box")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: the process group, this rank, the world size and
    the device this rank owns."""
    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, device="cuda"):
    """The mesh of an initialized process group (default: the world).

    device "cuda" without an index takes cuda:LOCAL_RANK under torchrun,
    else cuda:(rank mod the device count), and makes it current; "cpu" or
    an indexed device is taken as given (two gloo ranks may share
    cuda:0; NCCL refuses that)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: run under "
            "torchrun, or through parallel.dryrun.spawn")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, device)


def shard_rows(mesh, n):
    """This rank's contiguous share [lo, hi) of n leading rows: the rows
    that P("data") gives device ``rank`` in JAX. n must divide evenly."""
    if n % mesh.size:
        raise ValueError("{} frames do not split over {} ranks".format(
            n, mesh.size))
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(mesh, batch):
    """This rank's slice of the leading frame dim of every entry of batch
    (arrays or tensors), as tensors on the rank's device."""
    lo, hi = shard_rows(mesh, len(next(iter(batch.values()))))
    return {k: torch.as_tensor(v[lo:hi]).to(mesh.device)
            for k, v in batch.items()}


def _tensors(tree):
    return (list(tree.parameters()) if isinstance(tree, torch.nn.Module)
            else list(tree.values()))


def replicate(mesh, params):
    """Broadcast params (a parameter ModuleDict, or a dict of tensors) from
    rank 0 in place, one flat bucket; returns params."""
    tensors = _tensors(params)
    with torch.no_grad():
        flat = _flatten_dense_tensors([t.data for t in tensors])
        dist.broadcast(flat, 0, group=mesh.group)
        for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
            t.copy_(v)
    return params


def _all_reduce_grads(mesh, params):
    """Sum every parameter's gradient over the ranks, in one bucket. A
    parameter that got no gradient on some rank gets zeros where another
    rank has one, and stays None where no rank has one, so every rank
    steps the same parameters."""
    ps = list(params.parameters())
    has = torch.tensor([p.grad is not None for p in ps], dtype=torch.int32,
                       device=mesh.device)
    dist.all_reduce(has, op=dist.ReduceOp.MAX, group=mesh.group)
    live = [p for p, h in zip(ps, has.tolist()) if h]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not live:
        return
    grads = [p.grad for p in live]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group)
    for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(v)


def build_parallel_train_step(mesh, lr=1e-5, optimizer=None,
                              **forward_kwargs):
    """Data-parallel train step over a frame batch (mesh.py:47-83).

    Returns (train_step, make_optimizer). make_optimizer(params) is
    ``optimizer(params)`` when given, else Adam at lr with optax.adam's
    defaults, as train.build_train_step's. train_step(params, opt, batch,
    draws) takes the whole batch (every entry with a leading frame dim B
    that divides by the world size, arrays or tensors) and the B frames'
    draws (train.make_draws) in frame order; this rank runs its own frames
    and their draws. The loss is the mean over all B frames of the
    per-frame train.build_forward_losses (forward_kwargs are its), so the
    result does not depend on the world size. Returns the metrics, each the
    mean over the B frames, as 0-d tensors on every rank. mesh None is one
    process without a group: all B frames on the params' device, no
    collective.
    """
    forward_losses = train_mod.build_forward_losses(**forward_kwargs)

    def make_optimizer(params):
        if optimizer is not None:
            return optimizer(params)
        return torch.optim.Adam(params.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)

    def train_step(params, opt, batch, draws):
        n = len(draws)
        m = mesh or Mesh(None, 0, 1, next(params.parameters()).device)
        lo, hi = shard_rows(m, n)
        local = shard_batch(m, batch)
        opt.zero_grad(set_to_none=True)
        sums = torch.zeros(len(METRICS), dtype=torch.float32,
                           device=m.device)
        for i in range(hi - lo):
            f = forward_losses(params, {k: v[i] for k, v in local.items()},
                               draws[lo + i])
            # one frame's backward at a time: the gradients sum as the
            # local sum's would, with one frame's graph alive
            (f["loss"] / n).backward()
            sums += torch.stack([f[k].detach().float() for k in METRICS])
        if mesh is not None:
            _all_reduce_grads(mesh, params)
            dist.all_reduce(sums, group=mesh.group)
        opt.step()
        return dict(zip(METRICS, (sums / n).unbind()))

    return train_step, make_optimizer


def _all_gather(mesh, t):
    """The ranks' equal-shaped tensors t (at least 1-D), in rank order. A
    gather moves bits: bool and bfloat16 travel as their bytes (a uint8
    view, no copy), which every backend takes (gloo has no int16)."""
    send = t.contiguous()
    if t.dtype in (torch.bool, torch.bfloat16):
        send = send.view(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    return [p.view(t.dtype) for p in parts]


def _all_gather_rows(mesh, t):
    """The ranks' equal-shaped tensors concatenated along dim 0."""
    return torch.cat(_all_gather(mesh, t))


def build_parallel_detect(mesh, detect_single=None, **kwargs):
    """Frame-parallel detection (mesh.py:120-136).

    Returns detect_batch(params, bev (B,...), image (B,...), calib
    (B,4,12)) -> the stacked (B, ...) dict on every rank. Each rank detects
    its B / world-size frames: one by one through detect_single (a
    single-frame detector such as eval.build_detect_fn's) when given, else
    as one batch through eval.build_detect_batch_fn(**kwargs).
    """
    if detect_single is None:
        from mv3d_tf_tpu_torch.eval import build_detect_batch_fn
        run = build_detect_batch_fn(**kwargs)
    else:
        def run(params, bev, image, calib):
            outs = [detect_single(params, *f) for f in zip(bev, image, calib)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def detect_batch(params, bev, image, calib):
        local = shard_batch(mesh, {"bev": bev, "image": image,
                                   "calib": calib})
        out = run(params, local["bev"], local["image"], local["calib"])
        return {k: _all_gather_rows(mesh, v) for k, v in out.items()}

    return detect_batch


# --------------------------------------------------------------------------
# Row sharding by halo recompute
# --------------------------------------------------------------------------

def trunk_geometry(layers=vgg.VGG_LAYERS):
    """(stride, halo) of the trunk's layer list: 3x3 SAME convs and 2x2
    VALID pools. Feature row r sees input rows [stride*r + lo, stride*r +
    hi]; halo is the larger of -lo and hi - (stride - 1), rounded up to a
    multiple of the stride, so that a band of feature rows [r0, r1) is
    exact from input rows [stride*r0 - halo, stride*r1 + halo) and every
    band start keeps the pools aligned with the whole frame's."""
    stride, lo, hi = 1, 0, 0
    for _, _, pool in reversed(layers):
        if pool:                 # output row q pools input rows 2q, 2q+1
            stride, lo, hi = stride * 2, 2 * lo, 2 * hi + 1
        lo, hi = lo - 1, hi + 1  # a 3x3 SAME conv
    need = max(-lo, hi - (stride - 1))
    halo = -(-need // stride) * stride
    assert halo >= need and halo % stride == 0, (halo, need, stride)
    return stride, halo


def feature_rows(h, layers=vgg.VGG_LAYERS):
    """The trunk's output rows from h input rows (each VALID pool drops an
    odd last row)."""
    for _, _, pool in layers:
        if pool:
            h //= 2
    return h


def row_bands(rows, n):
    """n contiguous bands [lo, hi) of ``rows`` feature rows, rows // n
    each, the last taking the rest."""
    per = rows // n
    return [(r * per, rows if r == n - 1 else (r + 1) * per)
            for r in range(n)]


def band_slice(band, h, layers=vgg.VGG_LAYERS):
    """Input rows [start, stop) that a band of feature rows needs: the band
    widened by the halo on both sides, clipped to the frame; the last band
    runs to the frame's end."""
    stride, halo = trunk_geometry(layers)
    r0, r1 = band
    stop = h if r1 == feature_rows(h, layers) else min(h, stride * r1 + halo)
    return max(0, stride * r0 - halo), stop


def band_trunk(params, x, band, suffix="", dtype=None, stem_impl=None):
    """The trunk's conv5_3 rows [r0, r1) = band of x (B,H,W,C), computed
    from the band's input rows with the halo (band_slice)."""
    r0, r1 = band
    start, stop = band_slice(band, x.shape[1])
    y = vgg.trunk_apply(params, x[:, start:stop], suffix, dtype, stem_impl)
    off = start // trunk_geometry()[0]
    return y[:, r0 - off:r1 - off]


def _band_features(mesh, params, x, suffix, dtype, stem_impl):
    """This rank's band of one trunk's conv5_3 rows, all_gathered into the
    whole map: x (1,H,W,C) -> (1,H/8,W/8,512) on every rank."""
    bands = row_bands(feature_rows(x.shape[1]), mesh.size)
    r0, r1 = bands[mesh.rank]
    own = band_trunk(params, x, (r0, r1), suffix, dtype, stem_impl)
    width = max(b - a for a, b in bands)
    send = own.new_zeros((width,) + own.shape[:1] + own.shape[2:])
    send[:r1 - r0] = own.transpose(0, 1)       # rows first, padded
    parts = _all_gather(mesh, send)
    full = torch.cat([p[:b - a] for p, (a, b) in zip(parts, bands)])
    return full.transpose(0, 1).contiguous()


def build_spatial_detect(mesh, detect_single=None, **kwargs):
    """Row-sharded single-frame detection, the latency mode (mesh.py:86-117).

    Returns detect(params, bev (H,W,9), image (H',W',3), calib (4,12)) ->
    the single-frame detector's dict on every rank. kwargs are
    eval.build_detect_fn's. Each rank runs both trunks on its band of rows
    with the trunk's halo (trunk_geometry); the bands are all_gathered and
    the rest runs replicated. The JAX version partitions detect_single
    through XLA; here the trunks must run apart from the head, so
    detect_single is refused.
    """
    if detect_single is not None:
        raise ValueError("build_spatial_detect runs the trunks by band and "
                         "cannot partition a given detector; pass "
                         "eval.build_detect_fn's kwargs instead")
    from mv3d_tf_tpu_torch import eval as E
    dtype = kwargs.pop("compute_dtype", None)
    stem_impl = vgg.detector_stem(None, dtype)

    @torch.inference_mode()
    def detect(params, bev, image, calib):
        bev, image, calib = E._inputs(params, torch.as_tensor(bev)[None],
                                      torch.as_tensor(image)[None],
                                      torch.as_tensor(calib)[None])
        c5 = _band_features(mesh, params, bev, "", dtype, stem_impl)
        c5_2 = _band_features(mesh, params, image, "_2", dtype, stem_impl)
        out = E.detect_from_features(params, c5, c5_2, calib,
                                     compute_dtype=dtype, **kwargs)
        return {k: v[0] for k, v in out.items()}

    return detect
