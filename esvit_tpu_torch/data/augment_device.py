"""DINO photometric augmentation on the device, batched (port of
esvit_tpu/data/augment_device.py).

The host does decode and RandomResizedCrop (data/augment_host.py); the
device does everything photometric: flip, colour jitter, grayscale,
Gaussian blur, solarize and the ImageNet normalisation, in fp32, over a
whole view batch. Drawing is separate from applying: ``draw_view_params``
draws each sample's masks and factors from a ``torch.Generator`` on the
device, and ``apply_view_params`` is a plain function of (images, drawn
parameters), each transform a function of (x, parameters, apply mask).
So the transforms can be held to esvit_tpu's on the parameters that
``jax.random`` drew, which torch cannot reproduce.

Semantics are esvit_tpu's, with its two documented deviations from
torchvision/PIL: the jitter sub-ops run in a fixed order (brightness,
contrast, saturation, hue), and the blur is a true separable Gaussian
with edge padding (PIL's is a 3-box-pass approximation).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# ITU-R 601 luma, like PIL convert('L').
_LUMA = (0.299, 0.587, 0.114)

BLUR_TAPS = 13  # covers sigma up to 2.0 (radius 3 sigma)
BLUR_SIGMA = (0.1, 2.0)
# The jitter's strengths (brightness, contrast, saturation, hue) and the
# probabilities of flip, jitter and grayscale, as esvit_tpu draws them.
JITTER = (0.4, 0.4, 0.2, 0.1)
FLIP_P, JITTER_P, GRAY_P = 0.5, 0.8, 0.2
# The asymmetric multi-crop policy: (blur_p, solarize_p) of global view 1,
# global view 2 and the locals.
VIEW_POLICY = {"g1": (1.0, 0.0), "g2": (0.1, 0.2), "local": (0.5, 0.0)}


def _per_sample(x, f):
    """Broadcast a per-sample (N,) value over the image dims, as x's dtype."""
    return f.reshape(-1, 1, 1, 1).to(x.dtype)


def _blend(x, y, mask):
    m = _per_sample(x, mask)
    return x * (1 - m) + y * m


def gray(x):
    """(N, H, W, 3) -> (N, H, W, 1) luma."""
    wr, wg, wb = _LUMA
    return (x[..., 0] * wr + x[..., 1] * wg + x[..., 2] * wb)[..., None]


def rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, ((g - b) / safe_d) % 6,
                    torch.where(mx == g, (b - r) / safe_d + 2,
                                (r - g) / safe_d + 4)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.to(torch.int32) % 6

    def select(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, by_sector[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def color_jitter(x, fb, fc, fs, fh, mask):
    """Brightness, contrast, saturation, hue by the per-sample factors,
    where ``mask``; the others pass through."""
    y = torch.clamp(x * _per_sample(x, fb), 0, 1)
    mean_gray = gray(y).mean(dim=(1, 2, 3), keepdim=True)
    y = torch.clamp(mean_gray + (y - mean_gray) * _per_sample(y, fc), 0, 1)
    g = gray(y)
    y = torch.clamp(g + (y - g) * _per_sample(y, fs), 0, 1)
    h, s, v = rgb_to_hsv(y)
    y = hsv_to_rgb((h + fh.reshape(-1, 1, 1).to(h.dtype)) % 1.0, s, v)
    return _blend(x, y, mask)


def grayscale(x, mask):
    return _blend(x, gray(x).expand_as(x), mask)


def blur_weights(sigma):
    """(N, BLUR_TAPS) normalised Gaussian taps of each sample's sigma."""
    r = BLUR_TAPS // 2
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]) ** 2)
    return w / w.sum(dim=1, keepdim=True)


def gaussian_blur(x, sigma, mask):
    """Separable Gaussian of each sample's sigma with edge padding, where
    ``mask``."""
    w = blur_weights(sigma).to(x.dtype)
    r = BLUR_TAPS // 2

    def blur_axis(y, axis):
        n = y.shape[axis]
        idx = torch.arange(-r, n + r, device=y.device).clamp_(0, n - 1)
        yp = y.index_select(axis, idx)                       # edge padding
        out = None
        for k in range(BLUR_TAPS):
            term = yp.narrow(axis, k, n) * _per_sample(y, w[:, k])
            out = term if out is None else out + term
        return out

    return _blend(x, blur_axis(blur_axis(x, 1), 2), mask)


def solarize(x, mask):
    return _blend(x, torch.where(x >= 0.5, 1.0 - x, x), mask)


def hflip(x, mask):
    return torch.where(_per_sample(x, mask) > 0, x.flip(2), x)


def normalize(x):
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def draw_view_params(n: int, generator: torch.Generator, blur_p: float,
                     solarize_p: float = 0.0) -> dict:
    """One view batch's draws, on the generator's device: the masks
    ``flip`` (p 0.5), ``jitter`` (0.8), ``gray`` (0.2), ``blur``
    (``blur_p``) and ``solarize`` (``solarize_p``), and the factors
    ``brightness`` / ``contrast`` in [0.6, 1.4], ``saturation`` in
    [0.8, 1.2], ``hue`` in [-0.1, 0.1] and ``sigma`` in [0.1, 2.0]. Every
    draw is made whatever the probabilities, so the stream does not depend
    on them; ``blur_p`` and ``solarize_p`` ride along, as esvit_tpu skips
    a transform whose probability is 0."""
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)

    b, c, s, h = JITTER
    params = {"flip": u() < FLIP_P, "jitter": u() < JITTER_P,
              "brightness": u(1 - b, 1 + b), "contrast": u(1 - c, 1 + c),
              "saturation": u(1 - s, 1 + s), "hue": u(-h, h),
              "gray": u() < GRAY_P}
    blur, sigma, sol = u() < blur_p, u(*BLUR_SIGMA), u() < solarize_p
    params.update(blur=blur, sigma=sigma, solarize=sol, blur_p=blur_p,
                  solarize_p=solarize_p)
    return params


def concat_params(*parts: dict) -> dict:
    """Draws of several view batches as one batch's (row order kept): a
    transform runs where any part's probability is above 0."""
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]
           if k not in ("blur_p", "solarize_p")}
    out["blur_p"] = max(p["blur_p"] for p in parts)
    out["solarize_p"] = max(p["solarize_p"] for p in parts)
    return out


def apply_view_params(images, params: dict, out_dtype=torch.float32):
    """esvit_tpu ``augment_view_batch`` on given draws. images: (N, S, S,
    3) uint8, or float in [0, 1]; returns (N, S, S, 3) normalised, as
    ``out_dtype``; computed in fp32 on the images' device."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    x = hflip(x, params["flip"])
    x = color_jitter(x, params["brightness"], params["contrast"],
                     params["saturation"], params["hue"], params["jitter"])
    x = grayscale(x, params["gray"])
    if params["blur_p"] > 0:
        x = gaussian_blur(x, params["sigma"], params["blur"])
    if params["solarize_p"] > 0:
        x = solarize(x, params["solarize"])
    return normalize(x).to(out_dtype)


def augment_view_batch(images, generator: torch.Generator, *, blur_p: float,
                       solarize_p: float = 0.0, out_dtype=torch.float32):
    """Photometric DINO augmentation of one view batch, drawn from
    ``generator`` (on the images' device)."""
    params = draw_view_params(images.shape[0], generator, blur_p, solarize_p)
    return apply_view_params(images, params, out_dtype)


def draw_multicrop_params(B: int, n_local: int,
                          generator: torch.Generator) -> tuple[dict, dict]:
    """(global, local) draws of one multi-crop batch, global rows [view 1;
    view 2], with esvit_tpu's asymmetric policy (``VIEW_POLICY``)."""
    g1 = draw_view_params(B, generator, *VIEW_POLICY["g1"])
    g2 = draw_view_params(B, generator, *VIEW_POLICY["g2"])
    loc = draw_view_params(n_local, generator, *VIEW_POLICY["local"])
    return concat_params(g1, g2), loc


def augment_multicrop(global_u8, local_u8, generator: torch.Generator,
                      out_dtype=torch.float32):
    """The full DINO multi-crop device augmentation (esvit_tpu
    ``augment_multicrop``). global_u8: (2B, Sg, Sg, 3), rows [g1 batch; g2
    batch] view-major; local_u8: (L*B, Sl, Sl, 3). View 1 blurs with p
    1.0; view 2 blurs with p 0.1 and solarizes with p 0.2; the locals blur
    with p 0.5. Both view 1 and 2 are applied as one batch: a transform
    whose mask is 0 leaves a row as it is, bit for bit."""
    gp, lp = draw_multicrop_params(global_u8.shape[0] // 2,
                                   local_u8.shape[0], generator)
    return (apply_view_params(global_u8, gp, out_dtype),
            apply_view_params(local_u8, lp, out_dtype))
