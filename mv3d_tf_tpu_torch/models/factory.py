"""Network factory (mv3d_tf_tpu/models/factory.py, the reference's
lib/networks/factory.py:23-33): a network name -> a (name, mode)
descriptor. *_train and *_test share one parameter set; they differ by
dropout and the target layers, not by graph. ``VGGnet*`` names are the
legacy 2D Faster R-CNN (models/vggnet.py), ``Res101C4_test`` the 2D Faster
R-CNN ResNet-101 C4 (models/resnet.py, test only), ``MaskRCNN_R101_FPN_test``
Mask R-CNN ResNet-101-FPN (models/fpn.py, test only), every other name MV3D
(models/mv3d.py).

A 2D spec carries what the 2D path (faster_rcnn_2d.build_im_detect_2d,
tools/test_net) takes of its network: ``trunk_apply(params, x, dtype)``
to the stride-16 map, ``trunk_graphs`` (None, or a class whose instances
run trunk_apply on the card as CUDA graphs, one a detector: ResNet-101
C4's), ``head(params, pooled, dtype, decode)`` from the
pooled RoIs to ``decode(cls_prob, bbox_pred)``, ``init_params(generator,
n_classes, device)``, the anchor scales (at base 16, three ratios each),
the RoI pool's size and the bucket test_net pads its images into.

A spec with ``levels`` (Mask R-CNN R-101-FPN's: P2-P6) takes the pyramid
path of build_im_detect_2d instead: ``trunk_stages`` and ``head_stages``
(resnet.StageGraphs' stages: the trunk to C2-C5, then the pyramid and the
RPN), per-level anchors and proposals (``test_budget``: the top-k a level
and the proposals kept), the multi-level RoIAlign at ``pooled`` and
``head(params, pooled, dtype)`` -> (cls_prob, bbox_pred of 80 x 4); its
``mask_head(params, pooled, classes, dtype)`` runs on the class step's
detections (build_im_mask_2d) at ``mask_pooled``. Every other spec has
``levels`` and ``mask_head`` None."""

from mv3d_tf_tpu_torch.models import fpn, mv3d, resnet, vggnet

R101_C4 = "Res101C4"
MASK_RCNN_FPN = "MaskRCNN_R101_FPN"
TEST_ONLY = (R101_C4, MASK_RCNN_FPN)


class NetworkSpec:
    def __init__(self, name, mode):
        self.name = name
        self.mode = mode                     # 'train' | 'test'
        self.is_2d = name.startswith(("VGGnet",) + TEST_ONLY)
        self.levels = self.mask_head = None
        if name.startswith(MASK_RCNN_FPN):
            self.levels = fpn.LEVELS
            self.trunk_apply = fpn.trunk_apply
            self.trunk_stages = fpn.trunk_stages
            self.head_stages = fpn.head_stages
            self.trunk_graphs = None
            self.head = fpn.box_head
            self.mask_head = fpn.mask_probs
            self.init_params = fpn.init_params_mask_rcnn_fpn
            self.n_classes = fpn.N_CLASSES
            self.feat_stride = 2 ** fpn.LEVELS[0]
            self.anchor_scales = None
            self.pooled = fpn.BOX_POOLED
            self.mask_pooled = fpn.MASK_POOLED
            self.test_budget = (fpn.PRE_NMS_PER_LEVEL, fpn.POST_NMS)
            self.bucket_hw = (800, 1344)
        elif name.startswith(R101_C4):
            self.trunk_apply = resnet.trunk_apply_r101
            self.trunk_graphs = resnet.TrunkGraphs
            self.head = resnet.detect_head
            self.init_params = resnet.init_params_r101_c4
            self.n_classes = resnet.N_CLASSES
            self.feat_stride = resnet.FEAT_STRIDE
            self.anchor_scales = resnet.ANCHOR_SCALES
            self.pooled = resnet.POOLED
            self.bucket_hw = (800, 1344)
        elif self.is_2d:
            self.trunk_apply = vggnet.trunk_apply_2d
            self.trunk_graphs = None
            self.head = vggnet.detect_head_2d
            self.init_params = vggnet.init_params_2d
            self.n_classes = vggnet.N_CLASSES_2D
            self.feat_stride = vggnet.FEAT_STRIDE_2D
            self.anchor_scales = vggnet.ANCHOR_SCALES_2D
            self.pooled = 7
            self.bucket_hw = (608, 1024)
        else:
            self.n_classes = mv3d.N_CLASSES
            self.feat_stride = mv3d.FEAT_STRIDE


def get_network(name):
    """'..._train' -> train spec, '..._test' -> test spec (factory.py:23-29);
    any other name, Res101C4_train and MaskRCNN_R101_FPN_train raise
    KeyError."""
    if name.endswith("_train"):
        if name.startswith(TEST_ONLY):
            raise KeyError("Unknown network: {} (ResNet-101 C4 and Mask "
                           "R-CNN R-101-FPN have a test network only)"
                           .format(name))
        return NetworkSpec(name, "train")
    if name.endswith("_test"):
        return NetworkSpec(name, "test")
    raise KeyError("Unknown network: {}".format(name))
