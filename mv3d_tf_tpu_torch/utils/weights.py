"""Conversion between the JAX package's parameter dict and the port's.

The JAX package keeps a flat dict ``{name: {"weights", "biases"}}`` of
numpy-convertible arrays with the reference layer names (conv1_1 ...
conv5_3, the ``_2`` image trunk, rpn_conv/3x3, fc6_1 ... bbox_pred; the
legacy 2D net's conv1_1 ... conv5_3, rpn_conv/3x3, rpn_cls_score,
rpn_bbox_pred, fc6, fc7, cls_score and bbox_pred); conv
weights are HWIO and fc weights (in, out). The port keeps an
``nn.ModuleDict`` of Conv2d (OIHW) and Linear ((out, in)) layers. The
layout change happens here and nowhere else. Both packages flatten pooled
maps in (h, w, c) order, so fc rows need no permutation.
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch.models import vgg
from mv3d_tf_tpu_torch.models.mv3d import N_CLASSES, NUM_ANCHORS
from mv3d_tf_tpu_torch.models.vggnet import N_CLASSES_2D, NUM_ANCHORS_2D


def _to_port(w):
    """A JAX-layout weight (HWIO conv, (in, out) fc; or a bias) as a float32
    tensor in the port's layout (OIHW, (out, in))."""
    w = np.array(w, np.float32)
    if w.ndim == 4:
        w = w.transpose(3, 2, 0, 1)
    elif w.ndim == 2:
        w = w.T
    return torch.from_numpy(np.ascontiguousarray(w))


def _to_jax(t):
    """The inverse of _to_port: a port tensor as a JAX-layout numpy array."""
    w = t.detach().float().cpu().numpy()
    if w.ndim == 4:
        w = w.transpose(2, 3, 1, 0)
    elif w.ndim == 2:
        w = w.T
    return np.ascontiguousarray(w)


def _pairs(params):
    """(JAX name, subkey, port parameter) for every parameter."""
    for key, m in params.items():
        name = key.replace("__", "/")
        yield name, "weights", m.weight
        yield name, "biases", m.bias


def params_from_jax(np_params, device="cuda"):
    """JAX flat param dict -> the port's ModuleDict, float32 on ``device``
    (the card unless the caller asks for another; without one it raises)."""
    layers = {}
    for name, p in np_params.items():
        shape = np.shape(p["weights"])
        if len(shape) == 4:
            kh, _, cin, cout = shape
            m = vgg.empty_layer(torch.nn.Conv2d, (cin, cout, kh), device)
        else:
            m = vgg.empty_layer(torch.nn.Linear, shape, device)
        with torch.no_grad():
            m.weight.copy_(_to_port(p["weights"]))
            m.bias.copy_(_to_port(p["biases"]))
        layers[vgg.module_key(name)] = m
    return torch.nn.ModuleDict(layers)


def params_to_jax(params):
    """The port's ModuleDict -> JAX flat param dict of float32 numpy arrays."""
    out = {}
    for name, sub, t in _pairs(params):
        out.setdefault(name, {})[sub] = _to_jax(t)
    return out


def _adam_leaves(np_opt_state):
    """(count, mu, nu, schedule count or None) of an optax adam state: the
    chain's tuple (ScaleByAdamState, then EmptyState or, with a schedule,
    ScaleByScheduleState) or a ScaleByAdamState alone."""
    states = ([np_opt_state] if hasattr(np_opt_state, "mu")
              else list(np_opt_state))
    adam = next(s for s in states if hasattr(s, "mu"))
    sched = [s.count for s in states
             if getattr(s, "_fields", None) == ("count",)]
    return adam.count, adam.mu, adam.nu, (sched[0] if sched else None)


def adam_state_from_jax(np_opt_state, params, opt):
    """Load an optax adam state (optax.adam's, with or without an lr
    schedule; numpy or JAX leaves in the JAX layout) into ``opt``, a
    torch.optim.Adam over ``params``: per parameter ``step`` = count,
    ``exp_avg`` = mu, ``exp_avg_sq`` = nu, moved into the port's layout as
    params_from_jax moves the weights (the fc rows keep their order: both
    packages flatten pooled maps in (h, w, c) order). Returns the number of
    updates taken (the schedule's count when it has one)."""
    count, mu, nu, sched_count = _adam_leaves(np_opt_state)
    step = float(np.asarray(count))
    for name, sub, p in _pairs(params):
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": _to_port(mu[name][sub]).to(p.device),
            "exp_avg_sq": _to_port(nu[name][sub]).to(p.device)}
    return int(np.asarray(count if sched_count is None else sched_count))


def adam_state_to_jax(opt, params):
    """The inverse of adam_state_from_jax: ``opt``'s state over ``params``
    as {"count": int32, "mu": {name: {"weights", "biases"}}, "nu": ...} of
    numpy arrays in the JAX layout, the fields of optax's
    ScaleByAdamState (a schedule's count, when there is one, equals count).
    A parameter without state (no update yet) gives zeros."""
    mu, nu, steps = {}, {}, set()
    for name, sub, p in _pairs(params):
        st = opt.state.get(p, {})
        zero = torch.zeros_like(p)
        mu.setdefault(name, {})[sub] = _to_jax(st.get("exp_avg", zero))
        nu.setdefault(name, {})[sub] = _to_jax(st.get("exp_avg_sq", zero))
        steps.add(int(st["step"]) if "step" in st else 0)
    if len(steps) > 1:
        raise ValueError("parameters at different step counts: {}".format(
            sorted(steps)))
    return {"count": np.int32(steps.pop() if steps else 0), "mu": mu,
            "nu": nu}


def jax_param_shapes(bev_channels=9, fc_dim=2048, pooled=7):
    """{name: weight shape} of the JAX layout (mv3d.py:33-65)."""
    shapes = {}
    for suffix, cin in (("", bev_channels), ("_2", 3)):
        for name, cout, _ in vgg.VGG_LAYERS:
            shapes[name + suffix] = (3, 3, cin, cout)
            cin = cout
    roi_dim = 512 * pooled * pooled
    shapes.update({
        "rpn_conv/3x3": (3, 3, 512, 512),
        "rpn_cls_score": (1, 1, 512, NUM_ANCHORS * 2),
        "rpn_bbox_pred": (1, 1, 512, NUM_ANCHORS * 6),
        "fc6_1": (roi_dim, fc_dim), "fc7_1": (fc_dim, fc_dim),
        "fc6_2": (roi_dim, fc_dim), "fc7_2": (fc_dim, fc_dim),
        "cls_score": (2 * fc_dim, N_CLASSES),
        "bbox_pred": (2 * fc_dim, N_CLASSES * 24),
    })
    return shapes


def jax_param_shapes_2d(n_classes=N_CLASSES_2D, fc_dim=4096, pooled=7):
    """{name: weight shape} of the legacy 2D net's JAX layout
    (vggnet.py:27-48)."""
    shapes = {}
    cin = 3
    for name, cout, _ in vgg.VGG_LAYERS:
        shapes[name] = (3, 3, cin, cout)
        cin = cout
    shapes.update({
        "rpn_conv/3x3": (3, 3, 512, 512),
        "rpn_cls_score": (1, 1, 512, NUM_ANCHORS_2D * 2),
        "rpn_bbox_pred": (1, 1, 512, NUM_ANCHORS_2D * 4),
        "fc6": (512 * pooled * pooled, fc_dim), "fc7": (fc_dim, fc_dim),
        "cls_score": (fc_dim, n_classes), "bbox_pred": (fc_dim, n_classes * 4),
    })
    return shapes


def _fc_row_perm(channels, pooled=7):
    """Row permutation from the reference's channel-major fc flatten
    (c, h, w) to the NHWC flatten (h, w, c) of models/mv3d.fc_apply
    (weights.py:17-23)."""
    return (np.arange(channels * pooled * pooled)
            .reshape(channels, pooled, pooled).transpose(1, 2, 0).reshape(-1))


# fc layers whose inputs are ROI-pooled maps in the reference graphs
_POOLED_FC_KEYS = ("fc6", "fc6_1", "fc6_2")


def load_npy_weights(params, path_or_dict, ignore_missing=True, log=print):
    """Merge a reference-style .npy weight dict ({name: {"weights",
    "biases"}} in the JAX layout: HWIO convs, (in, out) fcs) into the port's
    ModuleDict in place, with the reference's semantics (network.py:45-64,
    weights.py:30-74): unknown names and, with ignore_missing, shape
    mismatches are skipped (so ImageNet's 3-channel conv1_1 leaves the
    9-channel BEV conv1_1 as it was); fc6-family weight rows are permuted
    from the channel-major flatten to NHWC. Returns params."""
    if isinstance(path_or_dict, (str, bytes)):
        data = np.load(path_or_dict, allow_pickle=True).item()
    else:
        data = path_or_dict
    for key, sub in data.items():
        mkey = vgg.module_key(key)
        if mkey not in params:
            if log:
                log("ignore " + key)
            if not ignore_missing:
                raise KeyError(key)
            continue
        m = params[mkey]
        targets = {"weights": m.weight, "biases": m.bias}
        for subkey, value in sub.items():
            if subkey not in targets:
                if log:
                    log("ignore {}/{}".format(key, subkey))
                if not ignore_missing:
                    raise KeyError((key, subkey))
                continue
            t = targets[subkey]
            # the JAX layout's shape: HWIO convs, (in, out) fcs
            shape = (tuple(t.shape) if t.dim() == 1 else
                     tuple(t.permute(2, 3, 1, 0).shape) if t.dim() == 4 else
                     tuple(t.shape[::-1]))
            if shape != tuple(np.shape(value)):
                if log:
                    log("ignore " + key + " (shape mismatch)")
                if not ignore_missing:
                    raise ValueError((key, subkey))
                continue
            arr = np.asarray(value, np.float32)
            if (key in _POOLED_FC_KEYS and subkey == "weights"
                    and arr.ndim == 2 and arr.shape[0] % 49 == 0):
                arr = arr[_fc_row_perm(arr.shape[0] // 49)]
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)             # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T                                 # (in, out) -> (out, in)
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            if log:
                log("assign pretrain model " + subkey + " to " + key)
    return params


def make_mv3d_pretrain_dict(vgg_dict, fc_dim=2048, seed=None):
    """A standard VGG16 .npy dict -> the MV3D pretrain dict, in numpy
    (mv3d_tf_tpu/utils/weights.py:77, the reference's
    make_pretrain_data.ipynb): conv weights duplicated under ``*_2``; fc6
    (25088x4096) and fc7 (4096x4096) subsampled to fc_dim columns drawn by
    np.random.RandomState(seed).randint WITH replacement, for both the
    ``_1`` and ``_2`` copies. One seed gives the JAX package's arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for k in [k for k in vgg_dict if k.startswith("conv")]:
        out[k] = dict(vgg_dict[k])
        out[k + "_2"] = dict(vgg_dict[k])
    if "fc6" in vgg_dict and "fc7" in vgg_dict:
        idx6 = rng.randint(vgg_dict["fc6"]["weights"].shape[1], size=fc_dim)
        idx7 = rng.randint(vgg_dict["fc7"]["weights"].shape[1], size=fc_dim)
        fc6 = {"weights": vgg_dict["fc6"]["weights"][:, idx6],
               "biases": vgg_dict["fc6"]["biases"][idx6]}
        fc7 = {"weights": vgg_dict["fc7"]["weights"][idx6][:, idx7],
               "biases": vgg_dict["fc7"]["biases"][idx7]}
        for tgt, src in (("fc6_1", fc6), ("fc6_2", fc6),
                         ("fc7_1", fc7), ("fc7_2", fc7)):
            out[tgt] = {k: np.array(v) for k, v in src.items()}
    return out


def he_normal_params(seed, bev_channels=9, fc_dim=2048, pooled=7):
    """JAX-layout params with He-scaled normal weights (std sqrt(2/fan_in))
    and zero biases, from a numpy seed.

    The JAX package's own init (std 0.01) shrinks activations ~10x per
    layer: at small shapes every RPN score comes out exactly 0.5, and the
    detector's outputs then test tie rules rather than the network. At He
    scale features stay O(1) and scores are distinct. Two layers differ
    from plain He: the image trunk's conv1_1 is divided by 64, about the
    std of 8-bit pixels after mean subtraction, so that trunk also sees
    unit-scale inputs; bbox_pred keeps the JAX init's 10x smaller scale.
    """
    return _he_normal(jax_param_shapes(bev_channels, fc_dim, pooled),
                      {"conv1_1_2": 1.0 / 64, "bbox_pred": 0.1}, seed)


def he_normal_params_2d(seed, n_classes=N_CLASSES_2D, fc_dim=4096, pooled=7):
    """he_normal_params for the legacy 2D net: its image conv1_1 divided by
    64 and bbox_pred by 10, as there."""
    return _he_normal(jax_param_shapes_2d(n_classes, fc_dim, pooled),
                      {"conv1_1": 1.0 / 64, "bbox_pred": 0.1}, seed)


def _he_normal(shapes, gain, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        std = np.sqrt(2.0 / np.prod(shape[:-1])) * gain.get(name, 1.0)
        w = rng.standard_normal(shape, dtype=np.float32)
        out[name] = {"weights": w * np.float32(std),
                     "biases": np.zeros(shape[-1], np.float32)}
    return out


def quant_state_from_jax(np_state, device="cuda"):
    """The JAX package's int8 quant state (quant.build_quant_state or
    load_quant_state: nested dicts of arrays, None for a missing head) as
    the port's: the same keys and layouts (HWIO conv w_q, (in, out) fc w_q),
    each leaf a tensor of the leaf's dtype on ``device`` (the card unless
    the caller asks for another)."""
    if np_state is None or isinstance(np_state, bool):
        return np_state                   # a missing head; use_stem
    if isinstance(np_state, dict):
        return {k: quant_state_from_jax(v, device)
                for k, v in np_state.items()}
    return torch.from_numpy(np.array(np_state)).to(device)


def quant_state_to_jax(state):
    """The port's quant state with numpy leaves, as the JAX package takes
    it (its functions convert numpy arrays themselves)."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: quant_state_to_jax(v) for k, v in state.items()}
    if torch.is_tensor(state):
        return state.detach().cpu().numpy()
    return np.asarray(state)
