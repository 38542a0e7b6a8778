"""Space-to-depth VGG stem (mv3d_tf_tpu/ops/stem_s2d.py): conv1_1 + ReLU +
conv1_2 + ReLU + pool1 as 256-channel convs at half resolution.

Packing 2x2 pixel blocks into channels rewrites the same math as
  conv1_1:  4x4 stride-2 conv, Cin -> 4*64 = 256   (at (H/2+1)^2)
  conv1_2:  2x2 VALID conv, 256 -> 256             (at (H/2+1)^2)
  pool1:    max over the 4 subpixel channel groups (at (H/2)^2)
with the SHIFTED packing: block p holds conv1_1 output rows {2p-1, 2p}, so
a 3x3 window of conv1_2 spans two blocks per axis. Packed entries that map
outside y1 (row -1; row H on even H) are zeroed after the ReLU and act as
conv1_2's zero padding. Each multiply-add of the literal stem appears once,
plus exact zeros, so float32 output equals the literal stem up to summation
order.

The int8 detector's ``s2d_int8`` stem (quant.py) runs the packed conv1_1
here in bf16 and the packed conv1_2 as the s8 2x2 kernel. Weights given to
``pack_stem_weights`` are HWIO, as the JAX package's; ``stem_s2d`` takes the
port's OIHW layers.
"""

import numpy as np
import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch.models.vgg import f32_convs_without_tf32


def hwio(w):
    """An OIHW conv weight as an HWIO view."""
    return w.permute(2, 3, 1, 0)


def _pack_index():
    """Gather indices of the packing into zero-bordered weights.

    K1[a, b, :, g] = w1[a - r, b - c] for subpixel group g = 2r + c, zero
    where a - r or b - c leaves [0, 3): w1 is padded by 1 before and 2
    after, so index a - r + 1. K2[P, Q, gi, go] = w2[2P + r - di,
    2Q + c - dj] for gi = 2r + c, go = 2di + dj (pack_stem_weights:75-91):
    w2 is padded by 1 on each side, so index 2P + r - di + 1."""
    g = np.arange(4)
    r, c = g // 2, g % 2
    a = np.arange(4)
    i1 = (a[:, None, None] - r[None, None, :] + 1,
          a[None, :, None] - c[None, None, :] + 1)           # (4, 4, 4)
    P = np.arange(2)
    i2 = (2 * P[:, None, None, None] + r[None, None, :, None]
          - r[None, None, None, :] + 1,
          2 * P[None, :, None, None] + c[None, None, :, None]
          - c[None, None, None, :] + 1)                      # (2, 2, 4, 4)
    return i1, i2


def pack_stem_weights(w1, b1, w2, b2):
    """Remap literal stem weights to the s2d layout (stem_s2d.py:44-93).

    w1 (3,3,Cin,C1) and w2 (3,3,C1,C2) HWIO tensors, biases (C1,), (C2,).
    Returns K1 (4,4,Cin,4*C1), B1 (4*C1,), K2 (2,2,4*C1,4*C2), B2 (4*C2,);
    subpixel group g = 2r + c owns channels [g*C, (g+1)*C). Gathers, so the
    remap is differentiable."""
    Cin, C1 = w1.shape[2], w1.shape[3]
    C2 = w2.shape[3]
    (a1, b1i), (a2, b2i) = (tuple(torch.as_tensor(i, device=w1.device)
                                  for i in ix) for ix in _pack_index())
    w1p = F.pad(w1, (0, 0, 0, 0, 1, 2, 1, 2))               # (6, 6, Cin, C1)
    K1 = w1p[a1, b1i]                                       # (4,4,4,Cin,C1)
    K1 = K1.permute(0, 1, 3, 2, 4).reshape(4, 4, Cin, 4 * C1)
    w2p = F.pad(w2, (0, 0, 0, 0, 1, 1, 1, 1))               # (5, 5, C1, C2)
    K2 = w2p[a2, b2i]                                       # (2,2,4,4,C1,C2)
    K2 = K2.permute(0, 1, 2, 4, 3, 5).reshape(2, 2, 4 * C1, 4 * C2)
    return K1, b1.repeat(4), K2, b2.repeat(4)


def _mask_edges(y, H, W, C1):
    """Zero packed entries that map outside y1's [0,H) x [0,W) range, so
    they act as conv1_2's zero SAME padding (stem_s2d.py:96-118)."""
    Hb, Wb, C = y.shape[1], y.shape[2], y.shape[3]
    row = torch.arange(Hb, device=y.device)[None, :, None, None]
    col = torch.arange(Wb, device=y.device)[None, None, :, None]
    ch = torch.arange(C, device=y.device)[None, None, None, :]
    # r = 0 groups at block 0 (y1 row -1): g in {0, 1}
    dead = (row == 0) & (ch < 2 * C1)
    # c = 0 groups at block 0 (y1 col -1): g in {0, 2}
    dead = dead | ((col == 0)
                   & ((ch < C1) | ((ch >= 2 * C1) & (ch < 3 * C1))))
    if H % 2 == 0:   # r = 1 groups at block H//2 map to y1 row H
        dead = dead | ((row == H // 2) & (ch >= 2 * C1))
    if W % 2 == 0:   # c = 1 groups at block W//2 (y1 col W): g in {1, 3}
        dead = dead | ((col == W // 2) & (((ch >= C1) & (ch < 2 * C1))
                                          | (ch >= 3 * C1)))
    return y.masked_fill(dead, 0)


def _conv(x, w, stride=1, pad=(0, 0, 0, 0)):
    """NHWC conv, HWIO weight, no bias; pad = (left, right, top, bottom)."""
    if x.dtype == torch.float32 and x.is_cuda:
        f32_convs_without_tf32()
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad), w.permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def packed_conv1_1(x, K1, B1, C1):
    """Shifted-packed conv1_1 + ReLU + edge mask: x (B,H,W,Cin) ->
    (B, H//2+1, W//2+1, 4*C1) in x's dtype; the bias is added after the
    conv, in that dtype, as the JAX package adds it. Block p needs x rows
    [2p-2, 2p+2): pad 2 low and 2*Ho + 2 - H high."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    y = _conv(x, K1, 2, (2, 2 * Wo + 2 - W, 2, 2 * Ho + 2 - H))
    return _mask_edges(F.relu(y + B1), H, W, C1)


def group_max(z, C2):
    """pool1 as the max over the 4 subpixel channel groups of z (...,4*C2)."""
    m = z[..., :C2]
    for g in range(1, 4):
        m = torch.maximum(m, z[..., g * C2:(g + 1) * C2])
    return m


def stem_s2d(x, w1, b1, w2, b2, dtype=None):
    """Twin of the literal conv1_1 + conv1_2 + pool1 stem (stem_s2d.py:122).

    x (B,H,W,Cin); w1 (C1,Cin,3,3), w2 (C2,C1,3,3) OIHW as the port keeps
    them, biases (C1,), (C2,). dtype None is float32 (TF32 off on a card);
    bfloat16 casts input and packed weights. Returns (B,H//2,W//2,C2)."""
    C1, C2 = w1.shape[0], w2.shape[0]
    K1, B1, K2, B2 = pack_stem_weights(hwio(w1), b1, hwio(w2), b2)
    if dtype is not None:
        x, K1, B1, K2, B2 = (t.to(dtype) for t in (x, K1, B1, K2, B2))
    y = packed_conv1_1(x, K1, B1, C1)
    # packed conv1_2: out block i uses shifted blocks {i, i+1}
    z = F.relu(_conv(y, K2) + B2)
    return group_max(z, C2)
