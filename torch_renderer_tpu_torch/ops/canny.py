"""Differentiable Canny edge extraction with fixed-weight convolutions
(PyTorch counterpart of ``torch_renderer_tpu.ops.canny``, itself the
rebuild of the reference's net_canny.py: a 5-tap separable Gaussian blur,
Sobel filters and directional non-max suppression, whose forward returns
(blurred, grad_mag, grad_orientation, thin_edges, thresholded,
early_threshold)).

Semantics (each the reference's):
  * the Gaussian taps are scipy.signal.gaussian(5, 1) UNNORMALIZED (sum
    ~2.48 per axis), so the blur amplifies;
  * Sobel runs per color channel and grad_mag is the SUM of the
    per-channel magnitudes;
  * orientation is atan2(sum gy, sum gx) * (180 / 3.14159) + 180, rounded
    to 45-degree multiples;
  * NMS keeps a pixel iff grad_mag strictly exceeds both neighbours along
    the quantized orientation axis, with zero-padded borders.

In the JAX package this is XLA work (``lax.conv_general_dilated`` and
elementwise ops, no Pallas site); here it is ``F.conv2d`` (depthwise, on
NCHW) and plain tensor ops, one function of (B, H, W, C) images,
differentiable through the retained magnitudes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CannyOutputs:
    """Field for field the reference Net.forward tuple."""

    blurred: torch.Tensor           # (B, H, W, C)
    grad_magnitude: torch.Tensor    # (B, H, W) sum of per-channel magnitudes
    grad_orientation: torch.Tensor  # (B, H, W) degrees in {0, 45, ..., 360}
    thin_edges: torch.Tensor        # (B, H, W) NMS-suppressed magnitudes
    thresholded: torch.Tensor       # (B, H, W) thin edges after threshold
    early_threshold: torch.Tensor   # (B, H, W) raw magnitude after threshold


def gaussian_kernel_1d(size: int = 5, sigma: float = 1.0,
                       normalize: bool = True, device=None) -> torch.Tensor:
    """1D Gaussian taps. normalize=False reproduces scipy.signal.gaussian
    (peak 1, sum > 1), as the reference's conv weights do."""
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum() if normalize else k


def _conv2d_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' cross-correlation of (B, H, W, C) with (kh, kw)
    (zero padding; kh and kw odd)."""
    C = img.shape[-1]
    kh, kw = kernel.shape
    w = kernel.to(img.dtype).expand(C, 1, kh, kw)
    out = F.conv2d(img.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2),
                   groups=C)
    return out.permute(0, 2, 3, 1)


def gaussian_blur(img: torch.Tensor, size: int = 5, sigma: float = 1.0,
                  normalize: bool = True) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W, C) (the reference's two 1D
    convs, which use UNNORMALIZED taps: pass normalize=False for
    parity)."""
    k = gaussian_kernel_1d(size, sigma, normalize, device=img.device)
    img = _conv2d_same(img, k[None, :])
    return _conv2d_same(img, k[:, None])


# The reference's Sobel weights; conv2d cross-correlates, so the taps carry
# over unflipped.
SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))

_SOBEL: dict = {}


def sobel_taps(device) -> torch.Tensor:
    """SOBEL_X as a float32 tensor on ``device``, made once per device: a
    tensor from host data is a host-to-device copy, which a CUDA graph
    capture cannot hold, so a captured caller makes the taps before its
    capture (COCODataGenerator does, when it renders edge maps)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    taps = _SOBEL.get(device)
    if taps is None:
        taps = _SOBEL[device] = torch.tensor(SOBEL_X, dtype=torch.float32,
                                             device=device)
    return taps

# Neighbour offset (dy, dx) of directional filter k: the neighbour 45k
# degrees from east, y down.
_NEIGHBOR_SHIFTS = (
    (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1),
)


def _neighbor(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y+dy, x+dx] with zeros outside the image."""
    H, W = img.shape[1:3]
    p = F.pad(img, (1, 1, 1, 1))
    return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def canny_edges(images: torch.Tensor, low_threshold: float = 10.0,
                blur_size: int = 5, blur_sigma: float = 1.0,
                eps: float = 1e-12) -> CannyOutputs:
    """The fixed-weight Canny pipeline on (B, H, W, C) or (B, H, W) images
    (values in any range; the reference feeds 0-255 RGB)."""
    if images.ndim == 3:
        images = images[..., None]
    blurred = gaussian_blur(images, blur_size, blur_sigma, normalize=False)

    sobel = sobel_taps(images.device)
    gx = _conv2d_same(blurred, sobel)          # (B, H, W, C) per channel
    gy = _conv2d_same(blurred, sobel.T)

    # Sum of per-channel magnitudes; orientation from the summed gradients
    # with the reference's +180 shift and 45-degree rounding (and its
    # 3.14159 pi).
    mag = torch.sqrt(gx * gx + gy * gy + eps).sum(-1)
    orient = (torch.atan2(gy.sum(-1), gx.sum(-1)) * (180.0 / 3.14159)
              + 180.0)
    orient = torch.round(orient / 45.0) * 45.0

    # NMS: keep iff mag strictly exceeds both neighbours along the
    # orientation axis.
    sector = torch.round(orient / 45.0).to(torch.int32) % 8
    is_max = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    for s, (dy, dx) in enumerate(_NEIGHBOR_SHIFTS):
        nb_pos = _neighbor(mag, dy, dx)
        nb_neg = _neighbor(mag, -dy, -dx)
        keep = (mag - nb_pos > 0.0) & (mag - nb_neg > 0.0)
        is_max = torch.where(sector == s, keep, is_max)

    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    thin = torch.where(is_max, mag, zero)
    thresholded = torch.where(thin < low_threshold, zero, thin)
    early = torch.where(mag < low_threshold, zero, mag)
    return CannyOutputs(blurred=blurred, grad_magnitude=mag,
                        grad_orientation=orient, thin_edges=thin,
                        thresholded=thresholded, early_threshold=early)
