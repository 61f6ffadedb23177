"""Cross-bilateral (joint) denoiser guided by the AOV feature buffers.

Port of ``raytrace_tpu/denoising.py``. Each pixel averages its (2r+1)^2
neighbourhood with weights that decay over spatial distance and over
differences in the AOV features - depth, shading normal and albedo - so
the filter smooths within surfaces but stops at silhouettes, creases and
texture edges. With a variance map (``render_adaptive(...,
return_variance=True)``) an SVGF-style radiance term judges luminance
differences against the local Monte Carlo noise; ``passes > 1`` runs
a-trous B3-spline passes with the variance re-estimated after each.

The neighbourhood is a loop of ``torch.roll`` shifts of the whole image,
with an explicit inside-frame mask for the wrapped rows and columns:
every step is an elementwise torch operation on the device. The JAX
package computes this outside any Pallas kernel; a fused CUDA kernel is
later performance work (ROADMAP).

Typical pipeline:
    img, spp = render_adaptive(scene, width=W, height=H, ...)
    aovs     = render_aovs(scene, width=W, height=H)
    clean    = denoise(img, aovs)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import _device
from .ops import intersect

__all__ = ["denoise"]

_LUMA = (0.2126, 0.7152, 0.0722)

# B3-spline taps of the a-trous passes (SVGF's 5x5 separable kernel)
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _cross_bilateral(img, depth, normal, albedo, hit, variance, *,
                     radius: int, use_variance: bool, sigma_spatial,
                     sigma_depth, sigma_normal, sigma_albedo, sigma_lum,
                     stride: int = 1, b3: bool = False,
                     return_var: bool = False):
    """One filter pass over (H,W,3) ``img``; the sigmas are 0-d float32
    tensors on the image's device. Returns the filtered image, and with
    ``return_var`` also the variance of the weighted mean."""
    h, w, _ = img.shape
    dev = img.device
    inv2ss = 0.5 / (sigma_spatial * sigma_spatial)
    inv2sd = 0.5 / (sigma_depth * sigma_depth)
    inv2sa = 0.5 / (sigma_albedo * sigma_albedo)
    # depth differences are judged relative to the local depth
    dscale = 1.0 / torch.clamp(depth.abs(), min=1.0)
    n_exp = 1.0 / torch.clamp(sigma_normal, min=1e-3)
    if use_variance:
        luma = img @ torch.tensor(_LUMA, dtype=img.dtype, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]

    acc = torch.zeros_like(img)
    wacc = torch.zeros((h, w), dtype=img.dtype, device=dev)
    vacc = torch.zeros((h, w), dtype=img.dtype, device=dev)
    for dy0 in range(-radius, radius + 1):
        for dx0 in range(-radius, radius + 1):
            dy, dx = dy0 * stride, dx0 * stride

            def sh(a):
                return torch.roll(a, shifts=(dy, dx), dims=(0, 1))

            # roll wraps around the frame: mask the wrapped rows/columns
            inside = (((ys - dy >= 0) & (ys - dy < h))
                      & ((xs - dx >= 0) & (xs - dx < w)))
            if b3:
                w_sp = _B3[dy0 + radius] * _B3[dx0 + radius]
            else:
                w_sp = torch.exp(-(dy0 * dy0 + dx0 * dx0) * inv2ss)
            dz = (sh(depth) - depth) * dscale
            w_z = torch.exp(-(dz * dz) * inv2sd)
            ndot = torch.clamp((sh(normal) * normal).sum(-1), 0.0, 1.0)
            # normal weight: a cosine falloff sharpened by sigma_normal
            w_n = ndot ** n_exp
            da2 = ((sh(albedo) - albedo) ** 2).sum(-1)
            w_a = torch.exp(-da2 * inv2sa)
            # hit pixels blend with hit pixels only, misses with misses
            same = sh(hit) == hit
            wgt = w_sp * w_z * w_n * w_a
            if use_variance:
                dl = sh(luma) - luma
                den = (sigma_lum * sigma_lum * (sh(variance) + variance)
                       + 1e-10)
                wgt = wgt * torch.exp(-(dl * dl) / den)
            wgt = torch.where(inside & same, wgt, 0.0)
            acc = acc + sh(img) * wgt[..., None]
            wacc = wacc + wgt
            if return_var:
                # variance of the weighted mean: sum(w^2 var) / (sum w)^2
                vacc = vacc + wgt * wgt * sh(variance)
    out = acc / torch.clamp(wacc, min=1e-8)[..., None]
    # miss pixels pass through unfiltered: at low spp their radiance is
    # partial silhouette coverage, real signal the flat features would
    # smear across the background
    out = torch.where(hit[..., None], out, img)
    if return_var:
        var_out = vacc / torch.clamp(wacc * wacc, min=1e-16)
        return out, torch.where(hit, var_out, variance)
    return out


def _on(x, dev, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def denoise(img, aovs: Dict, *, variance=None, radius: int = 3,
            passes: int = 1, sigma_spatial: float = 2.0,
            sigma_depth: float = 0.05, sigma_normal: float = 0.1,
            sigma_albedo: float = 0.1, sigma_lum: float = 4.0,
            as_numpy: Optional[bool] = None, device=None):
    """Feature-guided cross-bilateral filter over a linear radiance image.

    img: (H,W,3) linear radiance (numpy or a tensor). aovs: the dict of
    ``render_aovs`` (depth, normal, albedo and hit are used). variance:
    optional (H,W) variance of the mean luminance, which adds the
    radiance edge-stopping term. Sigmas: spatial in pixels; depth relative
    to the local depth; normal as cosine sharpness (smaller is stricter);
    albedo in linear colour distance; lum in noise standard deviations.

    passes=1 runs one dense (2·radius+1)^2 filter; passes>1 runs a-trous
    passes of the 5x5 B3-spline kernel at stride 2^i, the variance map
    re-estimated after each (sum w^2 var / (sum w)^2) when given.

    Runs on ``device`` (default CUDA; raises without a GPU unless
    ``device="cpu"``). Returns the filtered (H,W,3) float32 image: numpy
    if the input was numpy, or as ``as_numpy`` says.
    """
    dev = _device.resolve(device)
    was_numpy = isinstance(img, np.ndarray)
    x = _on(img, dev, torch.float32)
    # cap the miss sentinel so the depth arithmetic stays finite
    depth = torch.clamp(_on(aovs["depth"], dev, x.dtype),
                        max=intersect.BIG)
    use_var = variance is not None
    var = (_on(variance, dev, x.dtype) if use_var
           else torch.zeros(x.shape[:2], dtype=x.dtype, device=dev))
    normal = _on(aovs["normal"], dev, x.dtype)
    albedo = _on(aovs["albedo"], dev, x.dtype)
    hit = _on(aovs["hit"], dev, torch.bool)
    sig = {k: torch.tensor(v, dtype=x.dtype, device=dev) for k, v in (
        ("sigma_spatial", sigma_spatial), ("sigma_depth", sigma_depth),
        ("sigma_normal", sigma_normal), ("sigma_albedo", sigma_albedo),
        ("sigma_lum", sigma_lum))}
    if passes <= 1:
        out = _cross_bilateral(x, depth, normal, albedo, hit, var,
                               radius=radius, use_variance=use_var, **sig)
    else:
        out = x
        for i in range(passes):
            res = _cross_bilateral(
                out, depth, normal, albedo, hit, var, radius=2,
                use_variance=use_var, stride=1 << i, b3=True,
                return_var=use_var, **sig)
            out, var = res if use_var else (res, var)
    if as_numpy is None:
        as_numpy = was_numpy
    return out.cpu().numpy() if as_numpy else out
