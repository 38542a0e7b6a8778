"""s8 convolutions and the s8 GEMM: the plain PyTorch versions, the
requant epilogue they share with the CUDA kernels, and the dispatch between
them (mv3d_tf_tpu/ops/conv_s8_pallas.py, quant.py:_conv_requant).

    conv3x3_s8(x, w, k, b)  3x3 SAME, (B,H,W,C) int8 -> (B,H,W,N)
    conv3x3_s8_nk(x, w_nk, k, b)  the same on w_nk, the (N, 9*Cp) operand
                            prepare_s8_conv_weight makes once
    conv2x2_s8(x, w, k, b)  2x2 VALID, (B,H,W,C) int8 -> (B,H-1,W-1,N)
    conv2x2_s8_nk(x, w_nk, k, b)  the same on w_nk, the (N, 4*Cp) operand
                            prepare_s8_conv2x2_weight makes once
    matmul_s8(a, b)         (M,K) int8 @ (K,N) int8 -> (M,N) int32
    matmul_s8_nk(a, bt)     (M,K) int8 @ bt.T -> (M,N) int32, bt the (N,Kp)
                            operand prepare_s8_gemm_weight makes once

Weights are HWIO int8 as the JAX package keeps them; k and b are the (N,)
float32 requant scale and bias. The output is
clip(round(fma(float(acc), k, b)), 0, 127) as int8, or max(fma(...), 0) as
float32: the epilogue that XLA fuses into ONE fused multiply-add under jit
(rounded once; PyTorch's eager ``a * k + b`` rounds twice and differs on a
quarter of float32 values). ``torch.round`` rounds half to even, as
``jnp.round`` does.

The dispatch sends a CUDA tensor to the hand-written kernel
(ops/conv_s8_cuda.py) and a CPU tensor to the plain version; any other
device raises.
"""

import torch
import torch.nn.functional as F

GEMM_K_ALIGN = 16   # bytes: the prepared GEMM operand's K padding
CONV_C_ALIGN = 64   # channels: the prepared conv operands' C padding, one
                    # K slab of the conv kernel (csrc/conv_s8.cu)


def fma_f32(a, k, b):
    """float32 a * k + b rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64; TwoSum gives the
    float64 sum s and its exact error e. Rounding s to float32 is then right
    unless s is a float32 midpoint and e is not 0 (a second rounding would
    break the tie the wrong way): there e's sign picks the neighbour.
    """
    p = a.double() * k.double()
    bd = b.double()
    s = p + bd
    bb = s - p
    e = (p - (s - bb)) + (bd - bb)
    r = s.float()
    rd = r.double()
    half = s - rd                       # exact: s and r are close
    other = rd + 2.0 * half             # r's other neighbour if s is a tie
    tie = (half != 0) & (other.float().double() == other)
    away = tie & (e != 0) & ((e > 0) == (half > 0))
    return torch.where(away, other.float(), r)


def requant(acc, k, b, out_dtype=torch.int8):
    """The kernels' epilogue on s32 sums acc (..., N) with (N,) float32 k, b:
    clip(round(fma(float(acc), k, b)), 0, 127) int8, or for float32 output
    max(fma(...), 0)."""
    y = fma_f32(acc.float(), k, b)
    if out_dtype == torch.int8:
        return torch.round(y).clamp(0, 127).to(torch.int8)
    if out_dtype == torch.float32:
        return y.clamp_min(0.0)
    raise ValueError("requant: out_dtype must be int8 or float32")


def _exact_mm(a, b):
    """Integer a @ b, exactly, as int32: in float64 every product and partial
    sum is an integer below 2^53 (127 * 128 * 25088 < 2^29), so any
    summation order gives the same sum. float32 would not be exact."""
    return (a.double() @ b.double()).to(torch.int32)


def _im2col(x, kh, kw, pad):
    """x (B,H,W,C) zero-padded by ``pad`` on each side -> (B*Ho*Wo,
    kh*kw*C) rows in the (dy, dx, c) order of quant.py:_conv_s8_im2col,
    and (B, Ho, Wo)."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    B, H, W, C = x.shape
    Ho, Wo = H - kh + 1, W - kw + 1
    cols = torch.cat([x[:, dy:dy + Ho, dx:dx + Wo, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    return cols.reshape(B * Ho * Wo, kh * kw * C), (B, Ho, Wo)


def conv_acc_plain(x, w, pad):
    """The s32 sums of an s8 conv, stride 1: x (B,H,W,C) int8 zero-padded by
    ``pad`` on each side, w (kh,kw,C,N) int8 HWIO. im2col in the (dy, dx, c)
    order of quant.py:_conv_s8_im2col, then one exact matmul."""
    kh, kw, C, N = w.shape
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("s8 conv: x and w must be int8")
    if x.shape[-1] != C:
        raise ValueError("s8 conv: x has %d channels, w %d" % (x.shape[-1], C))
    cols, lead = _im2col(x, kh, kw, pad)
    return _exact_mm(cols, w.reshape(kh * kw * C, N)).reshape(*lead, N)


def conv3x3_s8_plain(x, w, k, b, out_dtype=torch.int8):
    """The plain 3x3 SAME s8 conv + requant: x (B,H,W,C) int8, w (3,3,C,N)."""
    return requant(conv_acc_plain(x, w, 1), k, b, out_dtype)


def conv2x2_s8_plain(x, w, k, b, out_dtype=torch.int8):
    """The plain 2x2 VALID s8 conv + requant: x (B,H,W,C) int8, w (2,2,C,N)."""
    return requant(conv_acc_plain(x, w, 0), k, b, out_dtype)


def matmul_s8_plain(a, b):
    """The plain s8 GEMM: (M,K) int8 @ (K,N) int8 -> (M,N) int32."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("matmul_s8: a and b must be int8")
    return _exact_mm(a, b)


def prepare_s8_gemm_weight(b):
    """The GEMM kernel's operand for a (K,N) int8 weight, made once: (N,Kp)
    int8, K-major (each output column's weights contiguous), K zero-padded
    to Kp, a multiple of GEMM_K_ALIGN bytes. Zeros add zero to every sum."""
    if b.dtype != torch.int8 or b.dim() != 2:
        raise TypeError("prepare_s8_gemm_weight: b must be a 2-D int8 tensor")
    extra = (-b.shape[0]) % GEMM_K_ALIGN
    return F.pad(b, (0, 0, 0, extra)).t().clone(
        memory_format=torch.contiguous_format)


def conv_channels(c):
    """The channel count Cp of the prepared conv operands for c input
    channels: c rounded up to CONV_C_ALIGN."""
    return -(-c // CONV_C_ALIGN) * CONV_C_ALIGN


def _prepare_conv(w, taps, name):
    """A (taps,taps,C,N) int8 HWIO weight as the conv kernel's operand:
    (N, taps*taps*Cp), output channel major with the reduction contiguous in
    (dy, dx, c) order, C zero-padded to Cp = conv_channels(C)."""
    if w.dtype != torch.int8 or w.dim() != 4 or tuple(w.shape[:2]) != (taps,
                                                                       taps):
        raise TypeError("%s: w must be a (%d,%d,C,N) int8 tensor"
                        % (name, taps, taps))
    C, N = w.shape[2], w.shape[3]
    cp = conv_channels(C)
    return F.pad(w, (0, 0, 0, cp - C)).reshape(taps * taps * cp, N).t().clone(
        memory_format=torch.contiguous_format)


def prepare_s8_conv_weight(w):
    """The 3x3 kernel's operand for a (3,3,C,N) int8 HWIO weight, made once:
    (N, 9*Cp) int8, output channel major with the reduction contiguous in
    (dy, dx, c) order, C zero-padded to Cp = conv_channels(C). Zeros add
    zero to every sum."""
    return _prepare_conv(w, 3, "prepare_s8_conv_weight")


def prepare_s8_conv2x2_weight(w):
    """The 2x2 kernel's operand for a (2,2,C,N) int8 HWIO weight, made once:
    (N, 4*Cp) int8, laid out as prepare_s8_conv_weight lays out a 3x3."""
    return _prepare_conv(w, 2, "prepare_s8_conv2x2_weight")


def check_conv_nk(x, w_nk, name, taps=3):
    """Raise unless w_nk is the (N, taps*taps*Cp) operand of a (B,H,W,C)
    int8 x for a taps x taps window."""
    prepare = ("prepare_s8_conv_weight" if taps == 3
               else "prepare_s8_conv2x2_weight")
    if x.dtype != torch.int8 or w_nk.dtype != torch.int8:
        raise TypeError("%s: x and w_nk must be int8" % name)
    if x.dim() != 4 or w_nk.dim() != 2:
        raise ValueError("%s: x must be (B,H,W,C) and w_nk (N, %d*Cp)"
                         % (name, taps * taps))
    kp = taps * taps * conv_channels(x.shape[3])
    if w_nk.shape[1] != kp:
        raise ValueError("%s: w_nk %s is not the (N, %d) operand of x %s "
                         "(%s makes it)"
                         % (name, tuple(w_nk.shape), kp, tuple(x.shape),
                            prepare))


def _conv_nk_plain(x, w_nk, k, b, out_dtype, taps, pad):
    """x's channels zero-padded to the operand's Cp, then im2col and one
    exact matmul against w_nk, then the requant."""
    cp = w_nk.shape[1] // (taps * taps)
    cols, lead = _im2col(F.pad(x, (0, cp - x.shape[3])), taps, taps, pad)
    acc = _exact_mm(cols, w_nk.t()).reshape(*lead, w_nk.shape[0])
    return requant(acc, k, b, out_dtype)


def conv3x3_s8_nk_plain(x, w_nk, k, b, out_dtype=torch.int8):
    """The plain 3x3 SAME s8 conv + requant on a prepared weight: x
    (B,H,W,C) int8, w_nk the (N, 9*Cp) operand of prepare_s8_conv_weight."""
    check_conv_nk(x, w_nk, "conv3x3_s8_nk")
    return _conv_nk_plain(x, w_nk, k, b, out_dtype, 3, 1)


def conv2x2_s8_nk_plain(x, w_nk, k, b, out_dtype=torch.int8):
    """The plain 2x2 VALID s8 conv + requant on a prepared weight: x
    (B,H,W,C) int8, w_nk the (N, 4*Cp) operand of
    prepare_s8_conv2x2_weight."""
    check_conv_nk(x, w_nk, "conv2x2_s8_nk", taps=2)
    return _conv_nk_plain(x, w_nk, k, b, out_dtype, 2, 0)


def check_nk(a, bt, name):
    """Raise unless bt is the (N, Kp) operand of a (M,K) int8 a."""
    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError("%s: a and bt must be int8" % name)
    if a.dim() != 2 or bt.dim() != 2:
        raise ValueError("%s: a must be (M,K) and bt (N,Kp)" % name)
    kp = -(-a.shape[1] // GEMM_K_ALIGN) * GEMM_K_ALIGN
    if bt.shape[1] != kp:
        raise ValueError("%s: bt %s is not the (N, %d) operand of a %s "
                         "(prepare_s8_gemm_weight makes it)"
                         % (name, tuple(bt.shape), kp, tuple(a.shape)))


def matmul_s8_nk_plain(a, bt):
    """The plain prepared-weight s8 GEMM: a (M,K) int8 @ bt.T, bt the (N,Kp)
    operand of prepare_s8_gemm_weight -> (M,N) int32."""
    check_nk(a, bt, "matmul_s8_nk")
    return _exact_mm(F.pad(a, (0, bt.shape[1] - a.shape[1])), bt.t())


def _dispatch(name, x):
    if x.is_cuda:
        from mv3d_tf_tpu_torch.ops import conv_s8_cuda
        return getattr(conv_s8_cuda, name + "_cuda")
    if x.device.type == "cpu":
        return globals()[name + "_plain"]
    raise ValueError("%s: no kernel for device %s" % (name, x.device))


def conv3x3_s8(x, w, k, b, out_dtype=torch.int8):
    """3x3 SAME s8 conv + requant: the kernel on a card, plain on the CPU."""
    return _dispatch("conv3x3_s8", x)(x, w, k, b, out_dtype)


def conv3x3_s8_nk(x, w_nk, k, b, out_dtype=torch.int8):
    """3x3 SAME s8 conv + requant on a prepared (N, 9*Cp) weight: the
    kernel on a card, plain on the CPU."""
    return _dispatch("conv3x3_s8_nk", x)(x, w_nk, k, b, out_dtype)


def conv2x2_s8(x, w, k, b, out_dtype=torch.int8):
    """2x2 VALID s8 conv + requant: the kernel on a card, plain on the CPU."""
    return _dispatch("conv2x2_s8", x)(x, w, k, b, out_dtype)


def conv2x2_s8_nk(x, w_nk, k, b, out_dtype=torch.int8):
    """2x2 VALID s8 conv + requant on a prepared (N, 4*Cp) weight: the
    kernel on a card, plain on the CPU."""
    return _dispatch("conv2x2_s8_nk", x)(x, w_nk, k, b, out_dtype)


def matmul_s8(a, b):
    """s8 GEMM to int32: the kernel on a card, plain on the CPU."""
    return _dispatch("matmul_s8", a)(a, b)


def matmul_s8_nk(a, bt):
    """s8 GEMM on a prepared (N,Kp) weight: the kernel on a card, plain on
    the CPU."""
    return _dispatch("matmul_s8_nk", a)(a, bt)
