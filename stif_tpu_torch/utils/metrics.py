"""Evaluation metrics and colour conversions, MATLAB conventions (the
port's own copy of ``stif_tpu/utils/metrics.py``; numpy and scipy only).

PSNR and SSIM on [0, 255] images as the Vid4 / Adobe eval protocols use
them (Y-channel PSNR/SSIM), a second, replicate-padded SSIM family, and the
MATLAB ``rgb2ycbcr`` conversions.
"""

from __future__ import annotations

import math

import numpy as np


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0, 255] images (any shape)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two 2-D [0,255] images: 11x11 gaussian window (sigma 1.5),
    valid convolution, MATLAB constants."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)

    # 11x11 gaussian kernel, sigma=1.5 (cv2.getGaussianKernel equivalent)
    r = np.arange(11) - 5
    g = np.exp(-(r ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()
    window = np.outer(g, g)

    def filt(x):
        # 'valid' 2-D correlation with the separable gaussian
        from numpy.lib.stride_tricks import sliding_window_view

        v = sliding_window_view(x, (11, 11))
        return np.einsum("ijkl,kl->ij", v, window)

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 ** 2) - mu1_sq
    sigma2_sq = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM on [0,255] images; 2-D or HxWxC (channel-averaged), like the
    reference ``calculate_ssim`` (``utils/util.py:176-196``)."""
    if img1.shape != img2.shape:
        raise ValueError("input images must have the same dimensions")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([
                _ssim_single(img1[..., c], img2[..., c]) for c in range(3)
            ]))
        if img1.shape[2] == 1:
            return _ssim_single(img1[..., 0], img2[..., 0])
    raise ValueError("wrong input image dimensions")


# ---------------------------------------------------- torch-convention SSIM
#
# The reference carries a second family of SSIM implementations in
# ``codes/myutils.py:47-187`` (torch, replicate-padded convolutions) used by
# several of its eval harnesses. NumPy equivalents via separable
# correlations; ``scipy.ndimage.correlate1d(mode="nearest")`` reproduces
# replicate padding + valid convolution exactly.


def _gauss1d(n: int, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(n) - n // 2) ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _val_range(img1: np.ndarray) -> float:
    """Auto value range like ``myutils.ssim`` (``:49-59``)."""
    max_val = 255.0 if img1.max() > 128 else 1.0
    min_val = -1.0 if img1.min() < -0.5 else 0.0
    return max_val - min_val


def _to_chw(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        return img[None]
    return np.moveaxis(img, -1, 0)  # HWC -> CHW


def ssim_torch(img1: np.ndarray, img2: np.ndarray, window_size: int = 11,
               val_range=None, full: bool = False):
    """Replicate-padded per-channel windowed SSIM — the torch ``ssim`` of
    ``codes/myutils.py:47-102``. Inputs (H, W[, C]) floats.

    The reference pads by 5 regardless of window size and shrinks the window
    to ``min(11, H, W)``; both quirks are preserved.
    """
    from scipy.ndimage import correlate1d

    x = _to_chw(img1)
    y = _to_chw(img2)
    L = val_range if val_range is not None else _val_range(x)
    C, H, W = x.shape
    n = min(window_size, H, W)
    g = _gauss1d(n)
    pad = 5  # fixed in the reference even when the window shrinks

    def filt(z):
        # replicate-pad 5 on H/W, then valid-correlate the n-tap gaussian
        z = np.pad(z, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
        z = correlate1d(z, g, axis=1, mode="constant")
        z = correlate1d(z, g, axis=2, mode="constant")
        a = n // 2
        b = n - 1 - a
        return z[:, a: z.shape[1] - b, a: z.shape[2] - b]

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu1_mu2
    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1 = 2.0 * s12 + C2
    v2 = s1 + s2 + C2
    cs = float(np.mean(v1 / v2))
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    ret = float(ssim_map.mean())
    return (ret, cs) if full else ret


def ssim_matlab(img1: np.ndarray, img2: np.ndarray, window_size: int = 11,
                val_range: float = 1.0) -> float:
    """MATLAB-style volumetric SSIM — ``codes/myutils.py:105-158``: the
    (C, H, W) image is treated as a 3-D volume and windowed with an
    11x11x11 separable gaussian, replicate padding 5 on all three axes
    (including channels)."""
    x = _to_chw(img1)
    y = _to_chw(img2)
    L = val_range if val_range is not None else _val_range(x)
    C, H, W = x.shape
    n = min(window_size, H, W)  # reference checks H/W only, not C
    g = _gauss1d(n)
    pad = 5

    def filt(z):
        z = np.pad(z, pad, mode="edge")
        for ax in range(3):
            from scipy.ndimage import correlate1d

            z = correlate1d(z, g, axis=ax, mode="constant")
        a = n // 2
        b = n - 1 - a
        return z[a: z.shape[0] - b, a: z.shape[1] - b, a: z.shape[2] - b]

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu1_mu2
    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1 = 2.0 * s12 + C2
    v2 = s1 + s2 + C2
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return float(ssim_map.mean())


def msssim(img1: np.ndarray, img2: np.ndarray, window_size: int = 11,
           val_range=None, normalize: bool = False) -> float:
    """Multi-scale SSIM — ``codes/myutils.py:161-187``, including its quirky
    final product ``prod(pow1[:-1] * pow2[-1])`` (the top-level SSIM term is
    broadcast into all four lower-level factors)."""
    weights = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    x = _to_chw(img1)
    y = _to_chw(img2)
    mssim, mcs = [], []
    for _ in range(len(weights)):
        s, cs = ssim_torch(np.moveaxis(x, 0, -1), np.moveaxis(y, 0, -1),
                           window_size=window_size, val_range=val_range,
                           full=True)
        mssim.append(s)
        mcs.append(cs)
        # avg_pool2d 2x2, stride 2, floor
        Hh, Ww = (x.shape[1] // 2) * 2, (x.shape[2] // 2) * 2
        x = x[:, :Hh, :Ww].reshape(x.shape[0], Hh // 2, 2, Ww // 2, 2).mean((2, 4))
        y = y[:, :Hh, :Ww].reshape(y.shape[0], Hh // 2, 2, Ww // 2, 2).mean((2, 4))
    mssim = np.array(mssim)
    mcs = np.array(mcs)
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    pow1 = mcs ** weights
    pow2 = mssim ** weights
    return float(np.prod(pow1[:-1] * pow2[-1]))


# ------------------------------------------------------------------- color

_YCBCR_W = np.array(
    [[65.481, -37.797, 112.0],
     [128.553, -74.203, -93.786],
     [24.966, 112.0, -18.214]]
)
_YCBCR_B = np.array([16.0, 128.0, 128.0])


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr. Input HxWx3 RGB, [0,1] float or [0,255] uint8;
    output same range/dtype convention as the reference."""
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img *= 255.0
    if only_y:
        out = img @ np.array([65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = img @ (_YCBCR_W / 255.0) + _YCBCR_B
    if in_type == np.uint8:
        out = out.round()
    else:
        out /= 255.0
    return out.astype(in_type)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """Same as rgb2ycbcr but for BGR channel order (the cv2 convention the
    reference's eval harness uses, ``data/util.py:190-222``)."""
    return rgb2ycbcr(img[..., ::-1], only_y=only_y)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb (float [0,1] or uint8)."""
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img *= 255.0
    inv = np.linalg.inv(_YCBCR_W / 255.0)
    out = (img - _YCBCR_B) @ inv
    if in_type == np.uint8:
        out = out.round().clip(0, 255)
    else:
        out = out / 255.0
    return out.astype(in_type)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale (``data/util.py:225-238``)."""
    if img.ndim == 2:
        h, w = img.shape
        return img[: h - h % scale, : w - w % scale]
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def tensor2img(t, min_max=(0, 1)) -> np.ndarray:
    """[0,1] float array (H, W, C) -> uint8 image (``utils/util.py:105-129``)."""
    t = np.asarray(t, dtype=np.float64)
    t = (t - min_max[0]) / (min_max[1] - min_max[0])
    t = np.clip(t, 0, 1)
    return (t * 255.0).round().astype(np.uint8)
