"""Wrappers of the CUDA s8 kernels, the Hopper replacements of
mv3d_tf_tpu/ops/conv_s8_pallas.py: the s8 convolutions with the fused
requant epilogue (csrc/conv_s8.cu, one wgmma kernel fed by TMA, im2col
mode for the activations, templated over the window:
conv3x3_s8_pallas_v2 and its v1 twin conv3x3_s8_pallas as the 3x3 SAME,
conv2x2_s8_pallas as the 2x2 VALID) and the s8 GEMM (csrc/matmul_s8.cu,
matmul_s8_pallas; wgmma fed by TMA).

The plain PyTorch versions are ops/conv_s8.py:conv3x3_s8_nk_plain,
conv3x3_s8_plain, conv2x2_s8_nk_plain, conv2x2_s8_plain, matmul_s8_plain
and matmul_s8_nk_plain. The wrappers take the same arguments: they
zero-pad channels (and the GEMM's K) to the kernels' granularity, which
adds zero to every integer sum. The weights are laid out output-channel
major with the reduction contiguous once per weight
(conv_s8.prepare_s8_conv_weight, prepare_s8_conv2x2_weight,
prepare_s8_gemm_weight): conv3x3_s8_nk_cuda, conv2x2_s8_nk_cuda and
matmul_s8_nk_cuda take them as they are and refuse any other operand;
conv3x3_s8_cuda, conv2x2_s8_cuda and matmul_s8_cuda prepare per call.
"""

import torch
import torch.nn.functional as F

from mv3d_tf_tpu_torch import kernels
from mv3d_tf_tpu_torch.ops.conv_s8 import (CONV_C_ALIGN, check_conv_nk,
                                           check_nk,
                                           prepare_s8_conv2x2_weight,
                                           prepare_s8_conv_weight,
                                           prepare_s8_gemm_weight)

_ALIGN = 16   # bytes: the alignment of every TMA operand, and the GEMM's
              # K and every kernel's N granularity
_NO_ENCODE_ENTRY = -999   # a TMA kernel: cudaGetDriverEntryPoint failed


def _pad_dim(t, dim, mult):
    """Zero-pad dimension ``dim`` of t up to a multiple of mult."""
    extra = (-t.shape[dim]) % mult
    if not extra:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra]
    return F.pad(t, pad)


def _aligned(t):
    """t contiguous at a 16-byte aligned address (a fresh copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


def _check_tma(err, entry):
    """Raise for the return code of a C entry that encodes tensor maps:
    -999 a missing driver entry point, -CUresult a failed encode, else a
    cudaError."""
    if err == _NO_ENCODE_ENTRY:
        raise RuntimeError("%s: the driver has no tensor-map encoding entry "
                           "point" % entry)
    if err < 0:
        raise RuntimeError("%s: tensor map encode failed, CUresult %d"
                           % (entry, -err))
    kernels.check(err, entry)


def _check_requant(x, k, b, N, out_dtype, entry):
    if not x.is_cuda or any(t.device != x.device for t in (k, b)):
        raise ValueError("%s: all inputs must be on one CUDA device" % entry)
    if k.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("%s: k and b must be float32" % entry)
    if tuple(k.shape) != (N,) or tuple(b.shape) != (N,):
        raise ValueError("%s: k %s and b %s are not (%d,)" % (
            entry, tuple(k.shape), tuple(b.shape), N))
    if out_dtype not in (torch.int8, torch.float32):
        raise ValueError("%s: out_dtype must be int8 or float32" % entry)
    if N % _ALIGN:
        raise ValueError("%s: N=%d is not a multiple of %d"
                         % (entry, N, _ALIGN))


def _conv_nk_cuda(x, w_nk, k, b, out_dtype, taps, name, entry, counted):
    """The one launch site of the conv kernel (a taps x taps window: 3 is
    the SAME 3x3, 2 the VALID 2x2) on a prepared weight w_nk; counted is
    the wrapper whose ``launches`` it adds to."""
    check_conv_nk(x, w_nk, name, taps)
    if w_nk.device != x.device:
        raise ValueError("%s: all inputs must be on one CUDA device" % name)
    N = w_nk.shape[0]
    _check_requant(x, k, b, N, out_dtype, name)
    if not w_nk.is_contiguous() or w_nk.data_ptr() % _ALIGN:
        raise ValueError("%s: w_nk must be contiguous and 16-byte aligned, "
                         "as the weight preparation makes it" % name)
    B, H, W, _ = x.shape
    if B * H * W > 2 ** 31 - 128:      # M plus a 128-pixel tile in an int
        raise ValueError("%s: x %s is too large for the kernel's 32-bit "
                         "pixel index" % (name, tuple(x.shape)))
    pad = 1 if taps == 3 else 0
    Ho, Wo = H + 2 * pad - taps + 1, W + 2 * pad - taps + 1
    out = torch.empty((B, max(Ho, 0), max(Wo, 0), N), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    xk = _aligned(_pad_dim(x, 3, CONV_C_ALIGN))
    kk, bk = _aligned(k), _aligned(b)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        counted.launches += 1
        err = getattr(lib, entry)(
            xk.data_ptr(), w_nk.data_ptr(), kk.data_ptr(), bk.data_ptr(),
            out.data_ptr(), B, H, W, xk.shape[3], N,
            int(out_dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    _check_tma(err, entry)
    return out


def _check_conv_args(x, w, taps, name):
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("%s: x and w must be on one CUDA device" % name)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("%s: x and w must be int8" % name)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (taps, taps,
                                                              x.shape[3]):
        raise ValueError("%s: x must be (B,H,W,C) and w (%d,%d,C,N), got %s "
                         "and %s" % (name, taps, taps, tuple(x.shape),
                                     tuple(w.shape)))


def conv3x3_s8_nk_cuda(x, w_nk, k, b, out_dtype=torch.int8):
    """3x3 SAME s8 conv + requant on the card, on a prepared weight: x
    (B,H,W,C) int8, w_nk the (N, 9*Cp) operand of
    conv_s8.prepare_s8_conv_weight, taken as it is (no copy); k and b (N,)
    float32, N % 16 == 0, all on one CUDA device. Returns (B,H,W,N) int8, or
    float32 max(fma, 0). Its launches are counted on
    ``conv3x3_s8_cuda.launches``."""
    return _conv_nk_cuda(x, w_nk, k, b, out_dtype, 3, "conv3x3_s8_nk_cuda",
                         "mv3d_conv3x3_s8", conv3x3_s8_cuda)


def conv3x3_s8_cuda(x, w, k, b, out_dtype=torch.int8):
    """3x3 SAME s8 conv + requant on the card: x (B,H,W,C) int8, w (3,3,C,N)
    int8 HWIO, laid out by prepare_s8_conv_weight on every call, then
    conv3x3_s8_nk_cuda. Callers that reuse a weight prepare it once.
    ``launches`` counts the kernel's launches through either wrapper."""
    _check_conv_args(x, w, 3, "conv3x3_s8_cuda")
    return conv3x3_s8_nk_cuda(x, prepare_s8_conv_weight(w), k, b, out_dtype)


conv3x3_s8_cuda.launches = 0


def conv2x2_s8_nk_cuda(x, w_nk, k, b, out_dtype=torch.int8):
    """2x2 VALID s8 conv + requant on the card, on a prepared weight: x
    (B,H,W,C) int8, w_nk the (N, 4*Cp) operand of
    conv_s8.prepare_s8_conv2x2_weight, taken as it is (no copy); k and b
    (N,) float32, N % 16 == 0, all on one CUDA device. Returns
    (B,H-1,W-1,N) int8, or float32 max(fma, 0). Its launches are counted on
    ``conv2x2_s8_cuda.launches``."""
    return _conv_nk_cuda(x, w_nk, k, b, out_dtype, 2, "conv2x2_s8_nk_cuda",
                         "mv3d_conv2x2_s8", conv2x2_s8_cuda)


def conv2x2_s8_cuda(x, w, k, b, out_dtype=torch.int8):
    """2x2 VALID s8 conv + requant on the card: x (B,H,W,C) int8, w
    (2,2,C,N) int8 HWIO, laid out by prepare_s8_conv2x2_weight on every
    call, then conv2x2_s8_nk_cuda. Callers that reuse a weight prepare it
    once. ``launches`` counts the kernel's launches through either
    wrapper."""
    _check_conv_args(x, w, 2, "conv2x2_s8_cuda")
    return conv2x2_s8_nk_cuda(x, prepare_s8_conv2x2_weight(w), k, b,
                              out_dtype)


conv2x2_s8_cuda.launches = 0


def matmul_s8_nk_cuda(a, bt):
    """(M,K) int8 @ bt.T -> (M,N) int32 on the card, exact; bt is the (N,Kp)
    operand of conv_s8.prepare_s8_gemm_weight, taken as it is (no copy). The
    one launch site of csrc/matmul_s8.cu; its launches are counted on
    ``matmul_s8_cuda.launches``, the GEMM kernel's one count."""
    check_nk(a, bt, "matmul_s8_nk_cuda")
    if not (a.is_cuda and bt.device == a.device):
        raise ValueError("matmul_s8_nk_cuda: a and bt must be on one CUDA "
                         "device")
    if not bt.is_contiguous() or bt.data_ptr() % _ALIGN:
        raise ValueError("matmul_s8_nk_cuda: bt must be contiguous and "
                         "16-byte aligned, as prepare_s8_gemm_weight makes it")
    M, N = a.shape[0], bt.shape[0]
    if M == 0 or N == 0 or a.shape[1] == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    ak = _aligned(_pad_dim(a, 1, _ALIGN))
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lib = kernels.library()
    with torch.cuda.device(a.device):
        matmul_s8_cuda.launches += 1
        err = lib.mv3d_matmul_s8(ak.data_ptr(), bt.data_ptr(), out.data_ptr(),
                                 M, ak.shape[1], N,
                                 torch.cuda.current_stream().cuda_stream)
    _check_tma(err, "mv3d_matmul_s8")
    return out


def matmul_s8_cuda(a, b):
    """(M,K) int8 @ (K,N) int8 -> (M,N) int32 on the card, exact: b laid
    out by prepare_s8_gemm_weight on every call, then matmul_s8_nk_cuda.
    Callers that reuse a weight prepare it once. ``launches`` counts the
    kernel's launches through either wrapper."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("matmul_s8_cuda: a and b must be on one CUDA device")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("matmul_s8_cuda: a and b must be int8")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("matmul_s8_cuda: shapes %s and %s do not multiply"
                         % (tuple(a.shape), tuple(b.shape)))
    return matmul_s8_nk_cuda(a, prepare_s8_gemm_weight(b))


matmul_s8_cuda.launches = 0
