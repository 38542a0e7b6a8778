"""Fused space-to-depth stem: the CUDA kernel (csrc/stem_s2d.cu), its plain
PyTorch version and the dispatch between them. The kernel replaces
mv3d_tf_tpu/ops/stem_s2d_pallas.py:stem_s2d_fused.

All three compute the s2d stem (conv1_1 + ReLU + conv1_2 + ReLU + pool1,
ops/stem_s2d.py) with the fused kernel's rounding: operands in ``dtype``,
sums and both biases in float32, the masked intermediate rounded ONCE to
``dtype`` and the pooled output rounded once. The XLA twin
``ops/stem_s2d.stem_s2d`` adds the biases in ``dtype`` after each conv has
rounded, so in bfloat16 it rounds twice where these round once; in float32
the two agree up to summation order. x (B,H,W,Cin) NHWC, weights OIHW as the
port stores them, biases (64,); output (B,H//2,W//2,64) in ``dtype``.
"""

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.ops.stem_s2d import (_conv, _mask_edges, group_max,
                                            hwio, pack_stem_weights)

MAX_CIN = 16   # the kernel's padded input-channel count
_ENTRY = {torch.float32: "mv3d_stem_s2d_f32",
          torch.bfloat16: "mv3d_stem_s2d_bf16"}


def stem_s2d_fused_plain(x, w1, b1, w2, b2, dtype=torch.bfloat16):
    """The plain version, the four steps of stem_s2d_pallas.py:143-200 on the
    packed weights: y = relu(x @ K1 + b1) summed in float32, the edge mask,
    one rounding to dtype; z = y @ K2 summed in float32, relu(z + b2), the
    max over the 4 subpixel groups, one rounding. The dtype-rounded operands
    are convolved as float32 (exact products; TF32 off on a card)."""
    C1, C2 = w1.shape[0], w2.shape[0]
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    K1, B1, K2, B2 = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
    f32 = torch.float32
    x, K1, K2 = (t.to(dtype).to(f32) for t in (x, K1, K2))
    y = _conv(x, K1, 2, (2, 2 * Wo + 2 - W, 2, 2 * Ho + 2 - H))
    y = _mask_edges(F.relu(y + B1.to(f32)), H, W, C1).to(dtype).to(f32)
    z = F.relu(_conv(y, K2) + B2.to(f32))
    return group_max(z, C2).to(dtype)


def stem_s2d_fused_cuda(x, w1, b1, w2, b2, dtype=torch.bfloat16):
    """The fused stem on the card. x (B,H,W,Cin) on a CUDA device, cast to
    dtype (float32 or bfloat16) as the TPU kernel casts it; w1 (64,Cin,3,3),
    w2 (64,64,3,3), biases (64,), on the same device."""
    if dtype not in _ENTRY:
        raise ValueError("stem_s2d_fused_cuda: dtype must be float32 or "
                         "bfloat16, got %s" % dtype)
    if not x.is_cuda or any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("stem_s2d_fused_cuda: all inputs must be on one "
                         "CUDA device")
    if x.dim() != 4:
        raise ValueError("stem_s2d_fused_cuda: x must be (B,H,W,Cin)")
    B, H, W, cin = x.shape
    if not 1 <= cin <= MAX_CIN:
        raise ValueError("stem_s2d_fused_cuda: Cin=%d is outside [1, %d]"
                         % (cin, MAX_CIN))
    if tuple(w1.shape) != (64, cin, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
        raise ValueError("stem_s2d_fused_cuda: the kernel takes C1 = C2 = 64: "
                         "weights must be (64,Cin,3,3) and (64,64,3,3), got "
                         "%s and %s" % (tuple(w1.shape), tuple(w2.shape)))
    if tuple(b1.shape) != (64,) or tuple(b2.shape) != (64,):
        raise ValueError("stem_s2d_fused_cuda: biases must be (64,)")
    Ho, Wo = H // 2, W // 2
    out = torch.empty((B, Ho, Wo, 64), dtype=dtype, device=x.device)
    if B == 0 or Ho == 0 or Wo == 0:
        return out
    xk = x.to(dtype).contiguous()
    # HWIO, input channels zero-padded to MAX_CIN; fresh allocations, so
    # every pointer is 16-byte aligned for the kernel's vector loads
    w1k = F.pad(hwio(w1), (0, 0, 0, MAX_CIN - cin)).to(dtype).contiguous()
    w2k = hwio(w2).to(dtype).contiguous()
    b1k = b1.to(torch.float32).contiguous()
    b2k = b2.to(torch.float32).contiguous()
    fn = getattr(kernels.library(), _ENTRY[dtype])
    with torch.cuda.device(x.device):
        stem_s2d_fused_cuda.launches += 1
        err = fn(xk.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
                 b2k.data_ptr(), out.data_ptr(), B, H, W, cin,
                 torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "stem_s2d_fused_cuda")
    return out


stem_s2d_fused_cuda.launches = 0


def stem_s2d_fused(x, w1, b1, w2, b2, dtype=torch.bfloat16):
    """Dispatch: the kernel for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    if x.is_cuda:
        return stem_s2d_fused_cuda(x, w1, b1, w2, b2, dtype)
    if x.device.type == "cpu":
        return stem_s2d_fused_plain(x, w1, b1, w2, b2, dtype)
    raise ValueError("stem_s2d_fused: no stem for device " + str(x.device))
