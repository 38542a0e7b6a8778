"""The legacy 2D Faster R-CNN VGG16 (mv3d_tf_tpu/models/vggnet.py, the
reference's VGGnet_train.py / VGGnet_test.py): the 21-class VOC detector of
tools/demo.py.

Unlike the MV3D trunks: four VALID pools (stride 16), 9 anchors a location
(3 scales x 3 ratios), 4096-wide fc6/fc7, 4-dof box deltas, and conv1/conv2
frozen in training. Parameters are one ``nn.ModuleDict`` keyed by the
reference names, as in models/mv3d.py; utils/weights.params_from_jax
converts the JAX package's dict.
"""

import torch

from mv3d_tf_tpu_torch.models import mv3d, vgg

N_CLASSES_2D = 21
FEAT_STRIDE_2D = 16
NUM_ANCHORS_2D = 9
# pools after conv1_2, conv2_2, conv3_3, conv4_3 (VGGnet_train.py:34-51)
VGG16_LAYERS = tuple(
    (name, c, name in ("conv1_2", "conv2_2", "conv3_3", "conv4_3"))
    for name, c, _ in vgg.VGG_LAYERS)
# conv1/conv2 are frozen in the reference (trainable=False)
FROZEN_2D = ("conv1_1", "conv1_2", "conv2_1", "conv2_2")


def init_params_2d(generator, n_classes=N_CLASSES_2D, fc_dim=4096, pooled=7,
                   device="cuda"):
    """The 2D parameter set with the JAX package's init (vggnet.py:27-48):
    truncated-normal std 0.01 (bbox_pred 0.001) cut at two std, zero
    biases, on ``device`` (the card unless the caller asks for another)."""
    def layer(cls, shape, std=0.01):
        return vgg.init_layer(generator, cls, shape, std=std, device=device)

    params = vgg.init_trunk(generator, 3, "", device)
    params.update({
        vgg.module_key("rpn_conv/3x3"): layer(torch.nn.Conv2d, (512, 512, 3)),
        "rpn_cls_score": layer(torch.nn.Conv2d, (512, NUM_ANCHORS_2D * 2, 1)),
        "rpn_bbox_pred": layer(torch.nn.Conv2d, (512, NUM_ANCHORS_2D * 4, 1)),
        "fc6": layer(torch.nn.Linear, (512 * pooled * pooled, fc_dim)),
        "fc7": layer(torch.nn.Linear, (fc_dim, fc_dim)),
        "cls_score": layer(torch.nn.Linear, (fc_dim, n_classes)),
        "bbox_pred": layer(torch.nn.Linear, (fc_dim, n_classes * 4),
                           std=0.001),
    })
    return torch.nn.ModuleDict(params)


def trunk_apply_2d(params, x, dtype=None):
    """Stride-16 VGG16 trunk: (B,H,W,3) NHWC -> conv5_3 (B,H/16,W/16,512)."""
    for name, _, pool in VGG16_LAYERS:
        x = vgg.conv2d(x, *vgg.layer(params, name), dtype=dtype)
        if pool:
            x = vgg.max_pool_2x2_valid(x)
    return x


# the RPN conv and its score/delta heads are the MV3D ones, layer names
# included (vggnet.py:61-71): (B,h,w,18) scores, (B,h,w,36) deltas
rpn_head_2d = mv3d.rpn_head


def head_2d(params, pooled, train=False, masks=None, keep_prob=1.0):
    """fc6 -> drop -> fc7 -> drop -> cls/bbox (vggnet.py:74-87). Returns
    cls_score, cls_prob (float32 softmax), bbox_pred.

    With train=True, masks holds the two boolean keep masks (N, fc), after
    fc6 and after fc7, in the order of the JAX keys k1, k2 (the dropout of
    models/mv3d.py); keep_prob >= 1 or masks=None drops nothing."""
    drop = train and masks is not None and keep_prob < 1.0
    x = mv3d.fc_apply(params, "fc6", pooled)
    if drop:
        x = mv3d.dropout(masks[0], x, keep_prob)
    x = mv3d.fc_apply(params, "fc7", x)
    if drop:
        x = mv3d.dropout(masks[1], x, keep_prob)
    cls_score = mv3d.fc_apply(params, "cls_score", x, relu=False)
    cls_prob = torch.softmax(cls_score.float(), dim=-1)
    bbox_pred = mv3d.fc_apply(params, "bbox_pred", x, relu=False)
    return cls_score, cls_prob, bbox_pred


def freeze_2d_grads(params):
    """Freeze conv1/conv2 (vggnet.py:90-96): their parameters stop requiring
    gradients, so the backward pass never reaches them and an optimizer over
    the trainable parameters leaves them bit for bit as they were. The JAX
    package computes their gradients and zeroes them; the step's result is
    the same. Returns the trainable parameters, in the ModuleDict's order."""
    for name in FROZEN_2D:
        if name in params:
            params[name].requires_grad_(False)
    return [p for p in params.parameters() if p.requires_grad]
