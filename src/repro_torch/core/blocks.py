"""TINA building blocks (paper §2) in torch.

The four NN layers TINA composes everything from, plus the transposed
convolution:

  * standard convolution   (§2.1, Eq. 1)
  * depthwise convolution  (§2.2, Eq. 2)
  * pointwise convolution  (§2.3, Eq. 3)
  * fully connected layer  (§2.4, Eq. 4)

Every block supports two lowerings, with the reference's layouts (NCHW /
OIHW, as ``nn.Conv2d``):

  * ``lowering="conv"``   -- the paper-faithful NN layer: ``F.conv2d`` /
    ``F.conv_transpose1d``.
  * ``lowering="native"`` -- the matmul / elementwise form: pointwise conv
    -> matmul; depthwise 1x1 -> elementwise; standard conv -> im2col +
    matmul.

The reference pins ``Precision.HIGHEST``.  Here every convolution runs
with ``torch.backends.cudnn.allow_tf32`` off (cuDNN's default for fp32
convolutions is TF32, about three decimal digits); matmuls already run in
full fp32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@contextlib.contextmanager
def fp32_convs():
    """Run the enclosed convolutions in full fp32 (no TF32 in cuDNN)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _bias4d(b: Optional[Tensor], c: int, like: Tensor) -> Tensor:
    if b is None:
        return torch.zeros((1, c, 1, 1), dtype=like.dtype, device=like.device)
    return b.reshape(1, c, 1, 1).to(like.dtype)


def _explicit_padding(padding, hw, kernel_hw, stride):
    """"VALID" / "SAME" / ((p0, p1), (p2, p3)) -> ((p0, p1), (p2, p3)),
    with SAME as XLA computes it (output ceil(h / s), extra on the high
    side)."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        pads = []
        for d, k, s in zip(hw, kernel_hw, stride):
            out = -(-d // s)
            total = max((out - 1) * s + k - d, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (p0, p1), (p2, p3) = padding
    return ((p0, p1), (p2, p3))


def _pad2d(x: Tensor, pads) -> Tensor:
    (p0, p1), (p2, p3) = pads
    if p0 or p1 or p2 or p3:
        return F.pad(x, (p2, p3, p0, p1))
    return x


# ---------------------------------------------------------------------------
# §2.1 standard convolution
# ---------------------------------------------------------------------------
def standard_conv(x: Tensor, kernel: Tensor, bias: Optional[Tensor] = None,
                  *, stride: tuple[int, int] = (1, 1),
                  padding: str | tuple = "VALID", groups: int = 1,
                  lowering: str = "conv") -> Tensor:
    """Paper Eq. (1).  x: (T, C_in, H, W); kernel: (C_out, C_in//groups,
    M, N).  Cross-correlation (no kernel flip), as ``nn.Conv2d``."""
    if x.ndim != 4:
        raise ValueError(f"standard_conv expects NCHW, got {tuple(x.shape)}")
    c_out = kernel.shape[0]
    if lowering == "conv":
        pads = _explicit_padding(padding, x.shape[2:], kernel.shape[2:],
                                 stride)
        with fp32_convs():
            out = F.conv2d(_pad2d(x, pads), kernel, stride=stride,
                           groups=groups)
    elif lowering == "native":
        out = _conv_via_im2col(x, kernel, stride=stride, padding=padding,
                               groups=groups)
    else:
        raise ValueError(f"unknown lowering {lowering!r}")
    return out + _bias4d(bias, c_out, out)


def _sliding_windows_2d(x: Tensor, window, stride) -> Tensor:
    """(T,C,H,W) -> (T,C,Ho,Wo,M,N) sliding windows, pure gather."""
    m, n = window
    t, c, h, w = x.shape
    ho = (h - m) // stride[0] + 1
    wo = (w - n) // stride[1] + 1
    dev = x.device
    ih = (torch.arange(ho, device=dev)[:, None] * stride[0]
          + torch.arange(m, device=dev)[None, :])
    iw = (torch.arange(wo, device=dev)[:, None] * stride[1]
          + torch.arange(n, device=dev)[None, :])
    return x[:, :, ih[:, None, :, None], iw[None, :, None, :]]


def _conv_via_im2col(x, kernel, *, stride, padding, groups):
    """Standard conv as unfold + matmul (the native lowering)."""
    c_out, c_in_g, m, n = kernel.shape
    if padding != "VALID":
        if padding == "SAME":
            ph, pw = (m - 1) // 2, (n - 1) // 2
            pads = ((ph, m - 1 - ph), (pw, n - 1 - pw))
        else:
            pads = padding
        x = _pad2d(x, pads)
    t, c_in, h, w = x.shape
    ho = (h - m) // stride[0] + 1
    wo = (w - n) // stride[1] + 1
    patches = _sliding_windows_2d(x, (m, n), stride)
    if groups == 1:
        lhs = patches.permute(0, 2, 3, 1, 4, 5).reshape(t * ho * wo,
                                                        c_in * m * n)
        rhs = kernel.reshape(c_out, c_in * m * n).T
        out = torch.matmul(lhs, rhs)
        return out.reshape(t, ho, wo, c_out).permute(0, 3, 1, 2)
    g = groups
    cg_in, cg_out = c_in // g, c_out // g
    lhs = patches.reshape(t, g, cg_in, ho, wo, m, n)
    rhs = kernel.reshape(g, cg_out, c_in_g, m, n)
    out = torch.einsum("tgihwmn,goimn->tgohw", lhs, rhs)
    return out.reshape(t, c_out, ho, wo)


# ---------------------------------------------------------------------------
# §2.2 depthwise convolution
# ---------------------------------------------------------------------------
def depthwise_conv(x: Tensor, kernel: Tensor, bias: Optional[Tensor] = None,
                   *, stride: tuple[int, int] = (1, 1),
                   padding: str | tuple = "VALID",
                   lowering: str = "conv") -> Tensor:
    """Paper Eq. (2).  x: (T, C, H, W); kernel: (C, M, N) -- channel c of
    the kernel applied to input channel c independently."""
    c = x.shape[1]
    if kernel.shape[0] != c:
        raise ValueError(f"kernel channels {kernel.shape[0]} != input {c}")
    m, n = kernel.shape[1], kernel.shape[2]
    if lowering == "conv":
        pads = _explicit_padding(padding, x.shape[2:], (m, n), stride)
        with fp32_convs():
            out = F.conv2d(_pad2d(x, pads), kernel[:, None], stride=stride,
                           groups=c)
        return out + _bias4d(bias, c, out)
    if lowering == "native":
        if m == 1 and n == 1 and tuple(stride) == (1, 1) and padding == "VALID":
            out = x * kernel.reshape(1, c, 1, 1)   # the TINA elementwise case
        else:
            xs = x
            if padding != "VALID":
                ph, pw = (m - 1) // 2, (n - 1) // 2
                xs = _pad2d(x, ((ph, m - 1 - ph), (pw, n - 1 - pw)))
            patches = _sliding_windows_2d(xs, (m, n), stride)
            out = torch.einsum("tchwmn,cmn->tchw", patches, kernel)
        return out + _bias4d(bias, c, out)
    raise ValueError(f"unknown lowering {lowering!r}")


# ---------------------------------------------------------------------------
# §2.3 pointwise convolution
# ---------------------------------------------------------------------------
def pointwise_conv(x: Tensor, kernel: Tensor, bias: Optional[Tensor] = None,
                   *, lowering: str = "conv") -> Tensor:
    """Paper Eq. (3).  x: (T, C_in, H, W); kernel: (C_in, C_out) -- a 1x1
    conv, i.e. a matmul over the channel axis."""
    c_in, c_out = kernel.shape
    if lowering == "conv":
        with fp32_convs():
            out = F.conv2d(x, kernel.T.reshape(c_out, c_in, 1, 1))
        return out + _bias4d(bias, c_out, out)
    if lowering == "native":
        out = torch.einsum("tihw,io->tohw", x, kernel)
        return out + _bias4d(bias, c_out, out)
    raise ValueError(f"unknown lowering {lowering!r}")


# ---------------------------------------------------------------------------
# transposed (fractionally-strided) convolution -- beyond-paper block
# ---------------------------------------------------------------------------
def transposed_conv(x: Tensor, kernel: Tensor, *, stride: int = 1,
                    lowering: str = "conv") -> Tensor:
    """Scatter semantics: out[n, t·s + w, o] += x[n, t, i] · kernel[w, i, o].

    x: (T, W, C_in); kernel: (K, C_in, C_out); output (T, (W−1)·s + K,
    C_out).  ``conv`` is the literal ``F.conv_transpose1d`` layer, whose
    weight (C_in, C_out, K) scatters with exactly these semantics;
    ``native`` is the gather/scatter form."""
    if x.ndim != 3 or kernel.ndim != 3:
        raise ValueError(f"transposed_conv expects (T, W, C_in) x and "
                         f"(K, C_in, C_out) kernel, got {tuple(x.shape)} "
                         f"{tuple(kernel.shape)}")
    if lowering == "conv":
        with fp32_convs():
            out = F.conv_transpose1d(x.transpose(1, 2),
                                     kernel.permute(1, 2, 0), stride=stride)
        return out.transpose(1, 2)
    if lowering == "native":
        t, w, _ = x.shape
        k, _, c_out = kernel.shape
        contrib = torch.einsum("nti,wio->ntwo", x, kernel)
        length = (w - 1) * stride + k
        idx = (torch.arange(w, device=x.device)[:, None] * stride
               + torch.arange(k, device=x.device)[None, :]).reshape(-1)
        out = torch.zeros((t, length, c_out), dtype=contrib.dtype,
                          device=x.device)
        return out.index_add(1, idx, contrib.reshape(t, w * k, c_out))
    raise ValueError(f"unknown lowering {lowering!r}")


# ---------------------------------------------------------------------------
# §2.4 fully connected layer
# ---------------------------------------------------------------------------
def fully_connected(x: Tensor, kernel: Tensor, bias: Optional[Tensor] = None,
                    *, lowering: str = "native") -> Tensor:
    """Paper Eq. (4).  x: (..., C_in); kernel: (C_in, C_out).  One code
    path whatever the lowering."""
    out = torch.tensordot(x, kernel, dims=([-1], [0]))
    if bias is not None:
        out = out + bias
    return out


__all__ = ["standard_conv", "depthwise_conv", "pointwise_conv",
           "transposed_conv", "fully_connected", "fp32_convs"]
