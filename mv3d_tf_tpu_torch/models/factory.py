"""Network factory (mv3d_tf_tpu/models/factory.py, the reference's
lib/networks/factory.py:23-33): a network name -> a (name, mode)
descriptor. *_train and *_test share one parameter set; they differ by
dropout and the target layers, not by graph. ``VGGnet*`` names are the
legacy 2D Faster R-CNN (models/vggnet.py), every other name MV3D
(models/mv3d.py)."""

from mv3d_tf_tpu_torch.models import mv3d, vggnet


class NetworkSpec:
    def __init__(self, name, mode):
        self.name = name
        self.mode = mode                     # 'train' | 'test'
        self.is_2d = name.startswith("VGGnet")
        self.n_classes = (vggnet.N_CLASSES_2D if self.is_2d
                          else mv3d.N_CLASSES)
        self.feat_stride = (vggnet.FEAT_STRIDE_2D if self.is_2d
                            else mv3d.FEAT_STRIDE)


def get_network(name):
    """'..._train' -> train spec, '..._test' -> test spec (factory.py:23-29);
    any other name raises KeyError."""
    if name.endswith("_train"):
        return NetworkSpec(name, "train")
    if name.endswith("_test"):
        return NetworkSpec(name, "test")
    raise KeyError("Unknown network: {}".format(name))
