"""Fused VGG stem: the wrapper of its CUDA kernel, its plain PyTorch version
and the dispatch between them. The kernel replaces
mv3d_tf_tpu/ops/vgg_stem_pallas.py:vgg_stem_pallas.

All three compute pool2x2_valid(relu(conv1_2(relu(conv1_1(x))))) with bf16
operands: (B,H,W,Cin) NHWC, Cin <= 16 -> (B,H/2,W/2,64) bfloat16. Weights
are OIHW as the port stores them.

The kernel is the bf16 tensor-core instance of csrc/stem_s2d.cu (entry
mv3d_stem_s2d_bf16), which also replaces stem_s2d_pallas.py:stem_s2d_fused:
the two TPU kernels compute one function. Both sum conv1_1 in float32 with
a float32 b1, zero the intermediate outside the image (conv1_2's SAME
padding), round it once to bf16, then sum conv1_2 in float32 with a float32
b2, apply ReLU, pool and round once (vgg_stem_pallas.py:73-82, :131-147;
stem_s2d_pallas.py:171-184); the s2d kernel sums the literal 3x3 products.
Its own plain version, ops/stem_s2d_cuda.stem_s2d_fused_plain in bf16,
follows that rounding; vgg_stem_plain below is the literal bf16 conv pair
(cuDNN on a card, JAX's CPU XLA stem's twin), which rounds after each bias
and stays within one bf16 ulp of the max.
"""

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.models.vgg import conv2d, max_pool_2x2_valid

MAX_CIN = 16   # the kernel's padded input-channel count


def vgg_stem_plain(x, w1, b1, w2, b2):
    """The plain version: two bfloat16 convs and the pool."""
    y = conv2d(x, w1, b1, dtype=torch.bfloat16)
    y = conv2d(y, w2, b2, dtype=torch.bfloat16)
    return max_pool_2x2_valid(y)


def vgg_stem_cuda(x, w1, b1, w2, b2):
    """The fused stem on the card, through the bf16 kernel of
    csrc/stem_s2d.cu. x (B,H,W,Cin) float32 or bfloat16 on a CUDA device
    (cast to bf16, as the TPU kernel does); w1 (64,Cin,3,3), w2
    (64,64,3,3), biases (64,), on the same device. Its launches are counted
    here, apart from the s2d stem's."""
    if not x.is_cuda or any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("vgg_stem_cuda: all inputs must be on one CUDA device")
    if x.dim() != 4:
        raise ValueError("vgg_stem_cuda: x must be (B,H,W,Cin)")
    B, H, W, cin = x.shape
    if not 1 <= cin <= MAX_CIN:
        raise ValueError("vgg_stem_cuda: Cin=%d is outside [1, %d]"
                         % (cin, MAX_CIN))
    if tuple(w1.shape) != (64, cin, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
        raise ValueError("vgg_stem_cuda: weights must be (64,Cin,3,3) and "
                         "(64,64,3,3), got %s and %s"
                         % (tuple(w1.shape), tuple(w2.shape)))
    if tuple(b1.shape) != (64,) or tuple(b2.shape) != (64,):
        raise ValueError("vgg_stem_cuda: biases must be (64,)")
    H2, W2 = H // 2, W // 2
    out = torch.empty((B, H2, W2, 64), dtype=torch.bfloat16, device=x.device)
    if B == 0 or H2 == 0 or W2 == 0:
        return out
    xb = x.to(torch.bfloat16).contiguous()
    # HWIO, input channels zero-padded to MAX_CIN; one fresh allocation
    # each, so every pointer is 16-byte aligned for the kernel's vector loads
    w1k = F.pad(w1.permute(2, 3, 1, 0), (0, 0, 0, MAX_CIN - cin)).to(
        torch.bfloat16).contiguous()
    w2k = w2.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    b1k = b1.to(torch.float32).contiguous()
    b2k = b2.to(torch.float32).contiguous()
    lib = kernels.library()
    with torch.cuda.device(x.device):
        vgg_stem_cuda.launches += 1
        err = lib.mv3d_stem_s2d_bf16(
            xb.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
            b2k.data_ptr(), out.data_ptr(), B, H, W, cin,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "vgg_stem_cuda")
    return out


vgg_stem_cuda.launches = 0


def vgg_stem(x, w1, b1, w2, b2):
    """Dispatch: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    if x.is_cuda:
        return vgg_stem_cuda(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return vgg_stem_plain(x, w1, b1, w2, b2)
    raise ValueError("vgg_stem: no stem for device " + str(x.device))
