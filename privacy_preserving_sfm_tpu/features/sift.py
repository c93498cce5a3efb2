"""SIFT feature extraction as fixed-shape XLA kernels.

Functional replacement for the reference's VLFeat CPU path
(``src/feature/sift.cc:399-545``, ``lib/VLFeat/vl/sift.c``) and SiftGPU,
re-designed for an accelerator:

  * Gaussian pyramid: separable depthwise convolutions (static kernel sizes
    from the static sigma schedule), octave downsampling by strided slice;
  * DoG extrema: one vectorized 26-neighbor comparison per octave, then
    ``top_k`` over |DoG| to a fixed per-octave candidate budget (replaces
    the data-dependent detection loop — XLA-friendly shapes, masked
    invalid slots);
  * subpixel refinement: batched 3x3 quadratic fits (closed-form solves),
    peak/edge gating as in VLFeat (peak_threshold, edge_threshold);
  * orientation: 36-bin Gaussian-weighted gradient histogram over a fixed
    sample grid, smoothed, up to ``max_num_orientations`` parabolic peaks;
  * descriptor: 4x4x8 trilinear soft-assignment over a fixed 16x16 rotated
    sample grid with bilinear gradient lookups, L2->clamp(0.2)->L2, then
    the reference's L1-root normalization and 512x uint8 quantization
    (``feature.cc:52-77``).

Results are floating-point approximations of VLFeat (sampling grids replace
exhaustive pixel loops); parity is behavioral (matching quality), not
bitwise — the matcher and all downstream geometry consume them identically.
Defaults follow ``SiftExtractionOptions`` (``sift.h:45-114``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import linalg


class SiftOptions(NamedTuple):
    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    candidates_per_octave: int = 2048
    # Halve the padded candidate budget per octave (each octave has 4x
    # fewer pixels, so real detections fall off steeply — measured 980 /
    # 300 / 108 / 24 on a textured 640x480).  The per-keypoint stages
    # cost by the PADDED budget, so this ~2x-es extraction throughput;
    # top-k keeps the strongest |DoG| candidates if a budget saturates.
    octave_budget_decay: bool = True
    min_candidates_per_octave: int = 256
    sigma0: float = 1.6
    nominal_sigma: float = 0.5
    # Feature selection under max_num_features: "scale" keeps the largest
    # sigmas (reference ExtractTopScaleFeatures, feature.cc:79-114);
    # "response" keeps the strongest |DoG| peaks.
    selection: str = "scale"
    # Domain-size pooling (DSP-SIFT, sift.cc:677-726): average the
    # descriptor over dsp_num_scales spatial extents in
    # [dsp_min_scale, dsp_max_scale] x sigma before normalization.
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # Affine shape adaptation (covariant detector,
    # ExtractCovariantSiftFeaturesCPU via vl_covdet, sift.cc:575-745):
    # iterate the second-moment matrix to an isotropic frame; orientation
    # and descriptor then sample the affine-normalized patch.
    estimate_affine_shape: bool = False
    affine_iterations: int = 10
    # Per-keypoint stage backend.
    #   "dense"  — accelerator-first: orientation histograms and descriptor
    #     spatial bins are computed DENSELY per gaussian level as
    #     channelized convolutions (36 soft-binned gradient channels *
    #     Gaussian window; 8 channels * tent at the descriptor bin
    #     pitch), then each keypoint samples a handful of positions —
    #     ~25x fewer random gathers than "gather" (the memory-latency-bound
    #     stage), at the cost of level-quantized window sigmas and an
    #     axis-aligned (unrotated) spatial tent.  Repeatability/matching
    #     parity is gated by tools/frontend_eval.py.
    #   "gather" — per-keypoint sampled bilinear gathers (VLFeat-faithful
    #     windows); required for estimate_affine_shape / DSP.
    descriptor_mode: str = "dense"
    # Dense-stage memory-traffic diet (the stage is bandwidth-bound).
    #   dense_half_res — 2x2 average-pool the 36+8 soft-binned gradient
    #     channels BEFORE the window filters and sample keypoints from
    #     the half-resolution filtered fields.  Legit because the fields
    #     are then convolved with windows of sigma >= 1.5 px (orientation
    #     Gaussian 1.5*sigma_l >= 3 px, descriptor tent pitch
    #     3*sigma_l >= 6 px): the pool adds a 2x2 box (variance ~0.25
    #     px^2) to windows of variance >= 9 px^2 and quarters channel
    #     traffic.  Accuracy neutrality gated by tools/frontend_eval.py.
    #   dense_bf16 — run the channel filters in bf16 (f32 accumulate),
    #     halving conv memory traffic; descriptors quantize to uint8/512
    #     (~0.2 % steps) so bf16's 0.4 % rounding is at the noise floor.
    dense_half_res: bool = True
    dense_bf16: bool = True


class SiftFeatures(NamedTuple):
    keypoints: jax.Array  # (K, 4): x, y, scale (sigma in image px), angle
    descriptors: jax.Array  # (K, 128) uint8
    valid: jax.Array  # (K,) bool
    scores: jax.Array  # (K,) |DoG| response


def _gauss_kernel1d(sigma: float, dtype) -> jnp.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur with SAME edge clamping."""
    if sigma < 1e-6:
        return img
    k = _gauss_kernel1d(sigma, img.dtype)
    r = (k.shape[0] - 1) // 2
    # Horizontal then vertical 1D convolutions via conv_general_dilated.
    x = img[None, None]  # NCHW
    pad = [(0, 0), (r, r)]
    x = jax.lax.conv_general_dilated(
        x, k[None, None, None, :], (1, 1), [(0, 0), (r, r)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(
        x, k[None, None, :, None], (1, 1), [(r, r), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return x[0, 0]


def _upsample2(img: jax.Array) -> jax.Array:
    h, w = img.shape
    return jax.image.resize(img, (2 * h, 2 * w), method="bilinear")


def _downsample2(img: jax.Array) -> jax.Array:
    return img[::2, ::2]


def _octave_pyramid(octave_img: jax.Array, opts: SiftOptions):
    """Gaussian stack of one octave: (S+3, H, W) and its DoG (S+2, H, W)."""
    S = opts.octave_resolution
    sigma0 = opts.sigma0
    n_levels = S + 3
    # sigma_s = sigma0 * 2^(s/S); incremental blurs.
    levels = [octave_img]
    for s in range(1, n_levels):
        sig_prev = sigma0 * 2.0 ** ((s - 1) / S)
        sig_cur = sigma0 * 2.0 ** (s / S)
        inc = math.sqrt(max(sig_cur ** 2 - sig_prev ** 2, 1e-8))
        levels.append(_blur(levels[-1], inc))
    gauss = jnp.stack(levels)  # (S+3, H, W)
    dog = gauss[1:] - gauss[:-1]  # (S+2, H, W)
    return gauss, dog


def _octave_budget(opts: SiftOptions, octave_idx: int) -> int:
    if not opts.octave_budget_decay:
        return opts.candidates_per_octave
    return max(opts.candidates_per_octave >> octave_idx,
               min(opts.min_candidates_per_octave,
                   opts.candidates_per_octave))


def _octave_candidates(dog: jax.Array, opts: SiftOptions, dtype,
                       budget: int):
    """DoG extrema + subpixel refinement of one octave.

    Returns (xr, yr, sr, sigma, peak_val, valid) fixed-size candidate
    arrays in octave coordinates (sr = refined DoG level).
    """
    S = opts.octave_resolution
    sigma0 = opts.sigma0
    h, w = dog.shape[1:]

    # --- Extrema detection on DoG levels 1..S --------------------------
    # 3x3x3 neighborhood max/min via one reduce_window each (instead of
    # materializing 26 shifted copies): a strict extremum equals the
    # windowed extremum AND beats the second-best in the window, which we
    # get by comparing against the windowed extremum of the OTHER sign
    # after masking the center... simpler: center equals window max and is
    # strictly greater than the 26-neighbor max, computed as
    # max(window) where the center was replaced by -inf.
    center = dog[1:S + 1]  # (S, H, W)
    neg_inf = jnp.asarray(-jnp.inf, dog.dtype)
    pos_inf = jnp.asarray(jnp.inf, dog.dtype)

    def window_reduce(x, init, op):
        return jax.lax.reduce_window(
            x, init, op, (3, 3, 3), (1, 1, 1),
            [(1, 1), (1, 1), (1, 1)])

    wmax = window_reduce(dog, neg_inf, jax.lax.max)[1:S + 1]
    wmin = window_reduce(dog, pos_inf, jax.lax.min)[1:S + 1]
    is_max = (center >= wmax)
    is_min = (center <= wmin)
    # Tie-break: require the center to strictly beat the 8 same-level
    # neighbors (cheap 2D reduce) — removes plateau duplicates.
    wmax2d = jax.lax.reduce_window(
        center, neg_inf, jax.lax.max, (1, 3, 3), (1, 1, 1),
        [(0, 0), (1, 1), (1, 1)])
    wmin2d = jax.lax.reduce_window(
        center, pos_inf, jax.lax.min, (1, 3, 3), (1, 1, 1),
        [(0, 0), (1, 1), (1, 1)])
    # Shifted-center comparison: center strictly greater than the max of
    # its 2D neighbors is implied by center == wmax2d when no tie exists;
    # ties are rare in float DoG and are dropped by top-k dedup anyway.
    is_max = is_max & (center == wmax2d)
    is_min = is_min & (center == wmin2d)
    # 0.8x pre-interpolation threshold (VLFeat behavior).
    strong = jnp.abs(center) > 0.8 * opts.peak_threshold
    border = 5
    yy = jnp.arange(h)[None, :, None]
    xx = jnp.arange(w)[None, None, :]
    inside = ((yy >= border) & (yy < h - border)
              & (xx >= border) & (xx < w - border))
    cand = (is_max | is_min) & strong & inside
    score = jnp.where(cand, jnp.abs(center), 0.0)

    flat_score = score.reshape(-1)
    # Tiny octaves of small images can hold fewer pixels than the budget.
    K = min(budget, flat_score.shape[0])
    top_scores, top_idx = jax.lax.top_k(flat_score, K)
    valid = top_scores > 0.0
    lev = top_idx // (h * w) + 1  # DoG level index (1..S)
    rem = top_idx % (h * w)
    py = rem // w
    px = rem % w

    # --- Subpixel refinement (2 Newton steps on the 3D quadratic) ------
    dflat = dog.reshape(-1)

    def dog_at(l, y, x):
        return jnp.take(dflat, (l * h + y) * w + x)

    def refine(l, y, x):
        def step(carry):
            y, x = carry
            g = jnp.stack([
                0.5 * (dog_at(l, y, x + 1) - dog_at(l, y, x - 1)),
                0.5 * (dog_at(l, y + 1, x) - dog_at(l, y - 1, x)),
                0.5 * (dog_at(l + 1, y, x) - dog_at(l - 1, y, x)),
            ])
            v = dog_at(l, y, x)
            Dxx = dog_at(l, y, x + 1) + dog_at(l, y, x - 1) - 2 * v
            Dyy = dog_at(l, y + 1, x) + dog_at(l, y - 1, x) - 2 * v
            Dss = dog_at(l + 1, y, x) + dog_at(l - 1, y, x) - 2 * v
            Dxy = 0.25 * (dog_at(l, y + 1, x + 1) - dog_at(l, y + 1, x - 1)
                          - dog_at(l, y - 1, x + 1) + dog_at(l, y - 1, x - 1))
            Dxs = 0.25 * (dog_at(l + 1, y, x + 1) - dog_at(l + 1, y, x - 1)
                          - dog_at(l - 1, y, x + 1) + dog_at(l - 1, y, x - 1))
            Dys = 0.25 * (dog_at(l + 1, y + 1, x) - dog_at(l + 1, y - 1, x)
                          - dog_at(l - 1, y + 1, x) + dog_at(l - 1, y - 1, x))
            H = jnp.asarray([[Dxx, Dxy, Dxs], [Dxy, Dyy, Dys],
                             [Dxs, Dys, Dss]])
            off = -linalg.solve3(H, g)
            off = jnp.where(jnp.isfinite(off), off, 0.0)
            return g, v, off

        g, v, off = step((y, x))
        # One re-centering move when the offset leaves the pixel.
        y2 = jnp.clip(y + jnp.round(off[1]).astype(jnp.int32), 1, h - 2)
        x2 = jnp.clip(x + jnp.round(off[0]).astype(jnp.int32), 1, w - 2)
        moved = (jnp.abs(off[0]) > 0.6) | (jnp.abs(off[1]) > 0.6)
        y = jnp.where(moved, y2, y)
        x = jnp.where(moved, x2, x)
        g, v, off = step((y, x))

        peak = v + 0.5 * jnp.dot(g, off)
        # Edge response on the spatial 2x2 Hessian.
        vv = dog_at(l, y, x)
        Dxx = dog_at(l, y, x + 1) + dog_at(l, y, x - 1) - 2 * vv
        Dyy = dog_at(l, y + 1, x) + dog_at(l, y - 1, x) - 2 * vv
        Dxy = 0.25 * (dog_at(l, y + 1, x + 1) - dog_at(l, y + 1, x - 1)
                      - dog_at(l, y - 1, x + 1) + dog_at(l, y - 1, x - 1))
        tr = Dxx + Dyy
        det = Dxx * Dyy - Dxy * Dxy
        r = opts.edge_threshold
        edge_ok = (det > 0) & (tr * tr / jnp.where(det == 0, 1e-30, det)
                               < (r + 1.0) ** 2 / r)
        good = ((jnp.abs(peak) > opts.peak_threshold)
                & edge_ok
                & (jnp.abs(off[0]) < 1.5) & (jnp.abs(off[1]) < 1.5)
                & (jnp.abs(off[2]) < 1.5))
        xr = x.astype(dtype) + off[0]
        yr = y.astype(dtype) + off[1]
        sr = l.astype(dtype) + off[2]  # refined DoG level
        return xr, yr, sr, jnp.abs(peak), good

    xr, yr, sr, peak_val, good = jax.vmap(refine)(lev, py, px)
    valid = valid & good
    sigma = sigma0 * 2.0 ** (sr / S)  # octave-pixel units
    return xr, yr, sr, sigma, peak_val, valid


def _orientation_peaks(hists: jax.Array, opts: SiftOptions, dtype):
    """Smooth 36-bin histograms, pick up to max_num_orientations peaks.

    hists: (K, 36) raw histograms.  Returns (theta (K, n_ori),
    ori_valid (K, n_ori)) — VLFeat peak rule: local maxima >= 0.8 * max,
    parabolic bin refinement.
    """
    NB = hists.shape[-1]
    # Smooth 6x with a circular [1,1,1]/3 kernel (VLFeat).
    for _ in range(6):
        hists = (jnp.roll(hists, 1, axis=-1) + hists
                 + jnp.roll(hists, -1, axis=-1)) / 3.0
    hmax = jnp.max(hists, axis=-1, keepdims=True)
    left = jnp.roll(hists, 1, axis=-1)
    right = jnp.roll(hists, -1, axis=-1)
    is_peak = (hists > left) & (hists > right) & (hists >= 0.8 * hmax)
    peak_score = jnp.where(is_peak, hists, -1.0)
    n_ori = opts.max_num_orientations
    top_h, top_b = jax.lax.top_k(peak_score, n_ori)  # (K, n_ori)
    lb = jnp.take_along_axis(left, top_b, axis=-1)
    rb = jnp.take_along_axis(right, top_b, axis=-1)
    denom = lb - 2 * top_h + rb
    dbin = 0.5 * (lb - rb) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    theta = ((top_b.astype(dtype) + dbin + 0.5) / NB) * 2 * jnp.pi - jnp.pi
    ori_valid = top_h > 0.0
    return theta, ori_valid


def _tent_kernel1d(radius: float, dtype) -> jnp.ndarray:
    """Unnormalized 1D tent max(0, 1 - |t|/radius) (descriptor bin pitch)."""
    r = max(1, int(math.ceil(radius)) - 1)
    t = jnp.arange(-r, r + 1, dtype=dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(t) / radius)


def _channel_filter(ch: jax.Array, k: jax.Array,
                    bf16: bool = False) -> jax.Array:
    """Separable 2D filter of a channel stack (C, H, W), channels=batch.

    ``bf16`` runs both 1D convs with bfloat16 operands and f32
    accumulation — half the memory traffic on the bandwidth-bound dense
    stage for ~0.4 % rounding on channel masses (below the descriptor's
    uint8 quantization step).
    """
    out_dtype = ch.dtype
    r = (k.shape[0] - 1) // 2
    if bf16:
        ch = ch.astype(jnp.bfloat16)
        k = k.astype(jnp.bfloat16)
    x = ch[:, None]  # (C, 1, H, W)
    x = jax.lax.conv_general_dilated(
        x, k[None, None, None, :], (1, 1), [(0, 0), (r, r)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32 if bf16 else None)
    if bf16:
        x = x.astype(jnp.bfloat16)
    x = jax.lax.conv_general_dilated(
        x, k[None, None, :, None], (1, 1), [(r, r), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32 if bf16 else None)
    return x[:, 0].astype(out_dtype)


def _soft_bins(mag: jax.Array, ang: jax.Array, nbins: int, dtype):
    """(H, W) gradients -> (nbins, H, W) soft-binned magnitude channels."""
    binf = (ang * (nbins / (2.0 * math.pi))) % nbins
    b0 = jnp.floor(binf)
    fb = (binf - b0).astype(dtype)
    chans = []
    for b in range(nbins):
        wgt = jnp.where(b0 == b, 1.0 - fb, 0.0) \
            + jnp.where((b0 + 1.0) % nbins == b, fb, 0.0)
        chans.append(mag * wgt)
    return jnp.stack(chans)


def _bilinear_flat(flat: jax.Array, ch_idx: jax.Array, ys: jax.Array,
                   xs: jax.Array, h: int, w: int):
    """Bilinear sample of a flattened (C*H*W) channel stack.

    ch_idx int32 (...,) selects the channel per sample; ys/xs float.
    """
    xs = jnp.clip(xs, 0.0, w - 1.001)
    ys = jnp.clip(ys, 0.0, h - 1.001)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y0 = jnp.floor(ys).astype(jnp.int32)
    fx = xs - x0
    fy = ys - y0
    base = ch_idx * (h * w)

    def take(yy, xx):
        # Plain gather indexing, NOT jnp.take: the jnp.take ufunc
        # dispatch path (jax ufunc_api) segfaulted inside jaxlib during
        # tracing of this function under x64 in round 4's test runs
        # (tests/test_features.py::test_shift_repeatability, 3/3 crashes
        # per-file).  Indices are in-bounds by construction (xs/ys are
        # clipped above, so x0+1 <= w-1), so the semantics are identical.
        return flat[base + yy * w + xx]

    return ((1 - fy) * (1 - fx) * take(y0, x0)
            + (1 - fy) * fx * take(y0, x0 + 1)
            + fy * (1 - fx) * take(y0 + 1, x0)
            + fy * fx * take(y0 + 1, x0 + 1))


def _dense_stage(gauss, glev, xr, yr, sigma, peak_val, valid,
                 opts: SiftOptions, dtype):
    """Dense-conv orientation + descriptor (see ``descriptor_mode``).

    gauss: (S+3, H, W) gaussian levels of one octave; per-candidate
    arrays in octave pixels.  Returns the expanded per-orientation
    feature tuple of ``_octave_features``.
    """
    S = opts.octave_resolution
    NB = 36
    NBO = 8
    NBP = 4
    h, w = gauss.shape[1:]
    K = xr.shape[0]
    glev_c = jnp.clip(glev, 1, S)

    # Half-resolution channel plan (see SiftOptions.dense_half_res): the
    # soft-binned gradient channels are 2x2 average-pooled before the
    # window filters, so all channel conv/sample traffic runs on a
    # quarter of the pixels; kernels shrink by 2x to match.  Half-res
    # pixel (i, j) is centered at full-res (2i + 0.5, 2j + 0.5), so a
    # full-res sample coordinate x maps to (x - 0.5) / 2.
    half = opts.dense_half_res
    hs, ws = ((h + 1) // 2, (w + 1) // 2) if half else (h, w)
    ksc = 0.5 if half else 1.0

    def _pool2(ch):
        # reduce_window, NOT pad+reshape+mean: the 5-D reshape forces a
        # transposed device-memory copy under the batch vmap (22.6 GB at
        # B=8 on the upsampled first octave: a compile-time OOM).
        # Pool in bf16 when enabled: the pooled stack is the largest
        # channel tensor this stage materializes.
        if opts.dense_bf16:
            ch = ch.astype(jnp.bfloat16)
        chp = jnp.pad(ch, ((0, 0), (0, 2 * hs - h), (0, 2 * ws - w)),
                      mode="edge")
        s = jax.lax.reduce_window(chp, jnp.asarray(0, chp.dtype),
                                  jax.lax.add, (1, 2, 2), (1, 2, 2),
                                  "VALID")
        return s * 0.25

    def _coord(v):
        return (v - 0.5) * 0.5 if half else v

    hists = jnp.zeros((K, NB), dtype)
    desc_levels = []
    for l in range(1, S + 1):
        g = gauss[l]
        dx = 0.5 * (jnp.roll(g, -1, axis=1) - jnp.roll(g, 1, axis=1))
        dy = 0.5 * (jnp.roll(g, -1, axis=0) - jnp.roll(g, 1, axis=0))
        mag = jnp.sqrt(dx * dx + dy * dy)
        ang = jnp.arctan2(dy, dx)
        sigl = opts.sigma0 * 2.0 ** (l / S)

        # Orientation: Gaussian-window histogram == Gaussian filter of the
        # soft-binned magnitude channels, evaluated at the keypoint.
        ch36 = _soft_bins(mag, ang, NB, dtype)
        if half:
            ch36 = _pool2(ch36)
        ch36 = _channel_filter(ch36,
                               _gauss_kernel1d(1.5 * sigl * ksc, dtype),
                               bf16=opts.dense_bf16)
        flat36 = ch36.reshape(-1)
        bins = jnp.arange(NB, dtype=jnp.int32)
        hist_l = _bilinear_flat(
            flat36, jnp.broadcast_to(bins, (K, NB)),
            jnp.broadcast_to(_coord(yr)[:, None], (K, NB)),
            jnp.broadcast_to(_coord(xr)[:, None], (K, NB)), hs, ws)
        hists = hists + jnp.where((glev_c == l)[:, None], hist_l, 0.0)

        # Descriptor: spatial-bin pooling == tent filter at the bin pitch
        # (3 sigma_l px) of the 8 soft-binned channels.
        ch8 = _soft_bins(mag, ang, NBO, dtype)
        if half:
            ch8 = _pool2(ch8)
        desc_levels.append(
            _channel_filter(ch8, _tent_kernel1d(3.0 * sigl * ksc, dtype),
                            bf16=opts.dense_bf16))
    dstack = jnp.stack(desc_levels).reshape(-1)  # (S*NBO*hs*ws,)

    theta, ori_valid = _orientation_peaks(hists, opts, dtype)

    n_ori = opts.max_num_orientations
    Ke = K * n_ori
    lev_e = jnp.repeat(glev_c, n_ori)
    xr_e = jnp.repeat(xr, n_ori)
    yr_e = jnp.repeat(yr, n_ori)
    sig_e = jnp.repeat(sigma, n_ori)
    th_e = theta.reshape(-1)
    val_e = jnp.repeat(valid, n_ori) & ori_valid.reshape(-1)
    peak_e = jnp.repeat(peak_val, n_ori)

    # 16 rotated bin-center positions x 8 channels per keypoint.
    centers = jnp.asarray([b - (NBP - 1) / 2.0 for b in range(NBP)], dtype)
    cj, ci = jnp.meshgrid(centers, centers, indexing="ij")  # y-major
    ci = ci.reshape(-1)  # (16,) x bin coords
    cj = cj.reshape(-1)
    gw = jnp.exp(-0.5 * (ci * ci + cj * cj) / (NBP / 2.0) ** 2)  # (16,)
    ct, st = jnp.cos(th_e), jnp.sin(th_e)
    delta = 3.0 * sig_e  # bin pitch in octave px (magnif = 3)
    u = (ct[:, None] * ci - st[:, None] * cj) * delta[:, None]  # (Ke, 16)
    v = (st[:, None] * ci + ct[:, None] * cj) * delta[:, None]
    ch_off = ((lev_e - 1) * NBO)[:, None, None] + jnp.arange(
        NBO, dtype=jnp.int32)  # (Ke, 1, 8)
    s = _bilinear_flat(
        dstack,
        jnp.broadcast_to(ch_off, (Ke, 16, NBO)),
        jnp.broadcast_to(_coord(yr_e[:, None] + v)[:, :, None],
                         (Ke, 16, NBO)),
        jnp.broadcast_to(_coord(xr_e[:, None] + u)[:, :, None],
                         (Ke, 16, NBO)),
        hs, ws)  # (Ke, 16, 8) absolute-orientation bin masses

    # Rotate the orientation channels by theta (circular linear interp).
    rot = (th_e * (NBO / (2.0 * math.pi))) % NBO
    ob0 = jnp.floor(rot)
    fo = (rot - ob0).astype(dtype)
    o_idx = (jnp.arange(NBO, dtype=jnp.int32)[None, :]
             + ob0.astype(jnp.int32)[:, None])  # (Ke, 8)
    s0 = jnp.take_along_axis(
        s, jnp.broadcast_to((o_idx % NBO)[:, None, :], (Ke, 16, NBO)),
        axis=2)
    s1 = jnp.take_along_axis(
        s, jnp.broadcast_to(((o_idx + 1) % NBO)[:, None, :], (Ke, 16, NBO)),
        axis=2)
    d = (1.0 - fo)[:, None, None] * s0 + fo[:, None, None] * s1
    d = d * gw[None, :, None]  # Gaussian window at bin centers
    d = d.reshape(Ke, 128)
    # VLFeat post-processing: L2 -> clamp 0.2 -> L2.
    nrm = jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    d = jnp.minimum(d / nrm, 0.2)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return xr_e, yr_e, sig_e, th_e, d, val_e, peak_e


def _octave_features(octave_img: jax.Array, octave_idx: int,
                     opts: SiftOptions, dtype):
    """Detect/refine/describe keypoints in one octave.

    octave_img: (H, W), already blurred to sigma(s=0) in octave pixels.
    Returns fixed-size per-octave feature arrays in *octave* coordinates
    plus validity; the caller rescales to image coordinates.

    The per-keypoint orientation/descriptor stages are vmapped bilinear
    gathers over flat gradient tensors.  (A patch-copy kernel variant, with
    per-keypoint windows sized for the octave's max sigma, wasted nearly
    all of its copies and arithmetic and was removed; see git history.)
    """
    S = opts.octave_resolution
    sigma0 = opts.sigma0
    n_levels = S + 3
    gauss, dog = _octave_pyramid(octave_img, opts)
    h, w = octave_img.shape
    xr, yr, sr, sigma, peak_val, valid = _octave_candidates(
        dog, opts, dtype, _octave_budget(opts, octave_idx))

    if (opts.descriptor_mode == "dense" and not opts.estimate_affine_shape
            and not opts.domain_size_pooling):
        glev = jnp.clip(jnp.round(sr).astype(jnp.int32), 0, n_levels - 1)
        return _dense_stage(gauss, glev, xr, yr, sigma, peak_val, valid,
                            opts, dtype)

    # --- Gradients per gaussian level ---------------------------------
    dx = 0.5 * (jnp.roll(gauss, -1, axis=2) - jnp.roll(gauss, 1, axis=2))
    dy = 0.5 * (jnp.roll(gauss, -1, axis=1) - jnp.roll(gauss, 1, axis=1))
    glev = jnp.clip(jnp.round(sr).astype(jnp.int32), 0, n_levels - 1)
    dxf = dx.reshape(-1)  # flat (n_levels * H * W): flat gathers only —
    dyf = dy.reshape(-1)  # per-level slicing under vmap would materialize
    # a full image copy per keypoint.

    def grad_lookup(level, ys, xs):
        """Bilinear gradient at (ys, xs) on a given gaussian level."""
        xs = jnp.clip(xs, 0.0, w - 1.001)
        ys = jnp.clip(ys, 0.0, h - 1.001)
        x0 = jnp.floor(xs).astype(jnp.int32)
        y0 = jnp.floor(ys).astype(jnp.int32)
        fx = xs - x0
        fy = ys - y0
        off = level * (h * w)

        def take(f, yy, xx):
            return jnp.take(f, off + yy * w + xx)

        def bil(f):
            return ((1 - fy) * (1 - fx) * take(f, y0, x0)
                    + (1 - fy) * fx * take(f, y0, x0 + 1)
                    + fy * (1 - fx) * take(f, y0 + 1, x0)
                    + fy * fx * take(f, y0 + 1, x0 + 1))

        return bil(dxf), bil(dyf)

    # --- Orientation histograms ----------------------------------------
    NB = 36
    G = 12  # orientation sample grid (G x G)
    gy, gx = jnp.meshgrid(jnp.linspace(-1.0, 1.0, G),
                          jnp.linspace(-1.0, 1.0, G), indexing="ij")
    gy = gy.reshape(-1).astype(dtype)
    gx = gx.reshape(-1).astype(dtype)

    def orientation(level, xc, yc, sig):
        win = 3.0 * 1.5 * sig
        sx = xc + gx * win
        sy = yc + gy * win
        gdx, gdy = grad_lookup(level, sy, sx)
        mag = jnp.sqrt(gdx * gdx + gdy * gdy)
        wgt = jnp.exp(-0.5 * ((gx * win) ** 2 + (gy * win) ** 2)
                      / (1.5 * sig) ** 2)
        ang = jnp.arctan2(gdy, gdx)  # [-pi, pi]
        bin_f = (ang / (2 * jnp.pi) * NB) % NB
        b0 = jnp.floor(bin_f).astype(jnp.int32) % NB
        fb = bin_f - jnp.floor(bin_f)
        hist = (jnp.zeros((NB,), dtype)
                .at[b0].add(mag * wgt * (1 - fb))
                .at[(b0 + 1) % NB].add(mag * wgt * fb))
        return hist

    # --- Affine shape adaptation (optional) ----------------------------
    if opts.estimate_affine_shape:
        agy, agx = gy, gx  # reuse the orientation sample grid

        def affine_shape(level, xc, yc, sig):
            """Iterate A until the second-moment matrix is isotropic
            (vl_covdet_extract_affine_shape semantics, unit determinant)."""
            win = 3.0 * sig

            def body(_, A):
                # Sample the warped window x = c + A u * win.
                sx = xc + (A[0, 0] * agx + A[0, 1] * agy) * win
                sy = yc + (A[1, 0] * agx + A[1, 1] * agy) * win
                gdx, gdy = grad_lookup(level, sy, sx)
                # Gradient in the warped frame: g' = A^T g.
                gu = A[0, 0] * gdx + A[1, 0] * gdy
                gv = A[0, 1] * gdx + A[1, 1] * gdy
                wgt = jnp.exp(-0.5 * (agx * agx + agy * agy) / (0.5 ** 2))
                m00 = jnp.sum(wgt * gu * gu)
                m01 = jnp.sum(wgt * gu * gv)
                m11 = jnp.sum(wgt * gv * gv)
                tr = m00 + m11 + 1e-20
                m00, m01, m11 = m00 / tr, m01 / tr, m11 / tr
                # Closed-form inverse square root of the 2x2 SPD matrix.
                det = jnp.maximum(m00 * m11 - m01 * m01, 1e-12)
                sdet = jnp.sqrt(det)
                # M^{-1/2} = (M + sqrt(det) I) / sqrt(tr(M) + 2 sqrt(det))
                # ... inverted: use W = inv(M)^{1/2} = adj(M)^{1/2}/sqrt..
                # Direct: inv(M) = adj(M)/det; sqrt of SPD 2x2 via the
                # same (X + sqrt(det X) I)/sqrt(tr X + 2 sqrt(det X)).
                i00, i01, i11 = m11 / det, -m01 / det, m00 / det
                idet = jnp.sqrt(jnp.maximum(i00 * i11 - i01 * i01, 1e-12))
                denom = jnp.sqrt(jnp.maximum(i00 + i11 + 2 * idet, 1e-12))
                w00 = (i00 + idet) / denom
                w01 = i01 / denom
                w11 = (i11 + idet) / denom
                A_new = A @ jnp.asarray([[w00, w01], [w01, w11]], A.dtype)
                # Renormalize to unit determinant (pure shape, no scale).
                d = jnp.sqrt(jnp.maximum(jnp.abs(
                    A_new[0, 0] * A_new[1, 1] - A_new[0, 1] * A_new[1, 0]),
                    1e-12))
                return A_new / d

            A0 = jnp.eye(2, dtype=dtype)
            return jax.lax.fori_loop(0, opts.affine_iterations, body, A0)

        Ashape = jax.vmap(affine_shape)(glev, xr, yr, sigma)  # (K, 2, 2)
    else:
        Ashape = jnp.broadcast_to(jnp.eye(2, dtype=dtype),
                                  (xr.shape[0], 2, 2))

    def orientation_affine(level, xc, yc, sig, A):
        win = 3.0 * 1.5 * sig
        sx = xc + (A[0, 0] * gx + A[0, 1] * gy) * win
        sy = yc + (A[1, 0] * gx + A[1, 1] * gy) * win
        gdx, gdy = grad_lookup(level, sy, sx)
        mag = jnp.sqrt(gdx * gdx + gdy * gdy)
        wgt = jnp.exp(-0.5 * ((gx * win) ** 2 + (gy * win) ** 2)
                      / (1.5 * sig) ** 2)
        ang = jnp.arctan2(gdy, gdx)
        bin_f = (ang / (2 * jnp.pi) * NB) % NB
        b0 = jnp.floor(bin_f).astype(jnp.int32) % NB
        fb = bin_f - jnp.floor(bin_f)
        hist = (jnp.zeros((NB,), dtype)
                .at[b0].add(mag * wgt * (1 - fb))
                .at[(b0 + 1) % NB].add(mag * wgt * fb))
        return hist

    if opts.estimate_affine_shape:
        hists = jax.vmap(orientation_affine)(glev, xr, yr, sigma, Ashape)
    else:
        hists = jax.vmap(orientation)(glev, xr, yr, sigma)  # (K, 36)

    n_ori = opts.max_num_orientations
    theta, ori_valid = _orientation_peaks(hists, opts, dtype)

    # --- Descriptors ----------------------------------------------------
    D = 16  # sample grid
    NBO = 8
    NBP = 4
    dgy, dgx = jnp.meshgrid(jnp.linspace(-1.0, 1.0, D),
                            jnp.linspace(-1.0, 1.0, D), indexing="ij")
    dgy = dgy.reshape(-1).astype(dtype)  # in window units [-1, 1]
    dgx = dgx.reshape(-1).astype(dtype)

    def descriptor(level, xc, yc, sig, th, A):
        magnif = 3.0
        win = magnif * sig * (NBP + 1) / 2.0  # sampling radius, octave px
        ct, st = jnp.cos(th), jnp.sin(th)
        # Rotated (and affine-warped, when shape-adapted) sample positions.
        ux_r = (ct * dgx - st * dgy) * win
        uy_r = (st * dgx + ct * dgy) * win
        rx = A[0, 0] * ux_r + A[0, 1] * uy_r
        ry = A[1, 0] * ux_r + A[1, 1] * uy_r
        gdx, gdy = grad_lookup(level, yc + ry, xc + rx)
        mag = jnp.sqrt(gdx * gdx + gdy * gdy)
        ang = jnp.arctan2(gdy, gdx) - th
        ux = dgx * (NBP + 1) / 2.0  # descriptor-frame coords in bin units
        uy = dgy * (NBP + 1) / 2.0
        wgt = jnp.exp(-0.5 * (ux * ux + uy * uy) / (NBP / 2.0) ** 2)
        bx = ux + (NBP - 1) / 2.0
        by = uy + (NBP - 1) / 2.0
        ob = (ang / (2 * jnp.pi) * NBO) % NBO
        x0 = jnp.floor(bx).astype(jnp.int32)
        y0 = jnp.floor(by).astype(jnp.int32)
        o0 = jnp.floor(ob).astype(jnp.int32) % NBO
        fx = bx - jnp.floor(bx)
        fy = by - jnp.floor(by)
        fo = ob - jnp.floor(ob)
        desc = jnp.zeros((NBP, NBP, NBO), dtype)
        contrib = mag * wgt
        for di in (0, 1):
            for dj in (0, 1):
                for do in (0, 1):
                    wx = fx if di else (1 - fx)
                    wy = fy if dj else (1 - fy)
                    wo = fo if do else (1 - fo)
                    xi = x0 + di
                    yi = y0 + dj
                    oi = (o0 + do) % NBO
                    ok = (xi >= 0) & (xi < NBP) & (yi >= 0) & (yi < NBP)
                    xi_c = jnp.clip(xi, 0, NBP - 1)
                    yi_c = jnp.clip(yi, 0, NBP - 1)
                    val = contrib * wx * wy * wo * ok.astype(dtype)
                    desc = desc.at[yi_c, xi_c, oi].add(val)
        d = desc.reshape(-1)
        # VLFeat post-processing: L2 -> clamp 0.2 -> L2.
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        d = jnp.minimum(d, 0.2)
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        return d

    # Expand keypoints over orientations: (K, n_ori) -> (K * n_ori,).
    lev_e = jnp.repeat(glev, n_ori)
    xr_e = jnp.repeat(xr, n_ori)
    yr_e = jnp.repeat(yr, n_ori)
    sig_e = jnp.repeat(sigma, n_ori)
    A_e = jnp.repeat(Ashape, n_ori, axis=0)
    th_e = theta.reshape(-1)
    val_e = jnp.repeat(valid, n_ori) & ori_valid.reshape(-1)
    peak_e = jnp.repeat(peak_val, n_ori)

    if opts.domain_size_pooling:
        # DSP-SIFT: mean of descriptors over pooled domain sizes (the
        # reference scales the measurement frame, sift.cc:698-726).
        step = (opts.dsp_max_scale - opts.dsp_min_scale) / opts.dsp_num_scales
        pooled = [
            jax.vmap(descriptor)(lev_e, xr_e, yr_e,
                                 sig_e * (opts.dsp_min_scale + si * step),
                                 th_e, A_e)
            for si in range(opts.dsp_num_scales)]
        descs = jnp.mean(jnp.stack(pooled), axis=0)
    else:
        descs = jax.vmap(descriptor)(lev_e, xr_e, yr_e, sig_e, th_e, A_e)

    return xr_e, yr_e, sig_e, th_e, descs, val_e, peak_e


def extract_sift(image: jax.Array, opts: SiftOptions = SiftOptions()):
    """Extract SIFT features from a grayscale image (H, W) float in [0, 1].

    Returns ``SiftFeatures`` with fixed K = max_num_features rows; keypoint
    x/y/scale are in input image pixels.  When more than K candidates
    survive the gates, ``opts.selection`` picks which ones stay: "scale"
    keeps the largest sigmas (the reference's ExtractTopScaleFeatures,
    ``feature.cc:79-114``) and "response" keeps the strongest |DoG| peaks.
    """
    # SIFT runs f32 regardless of the process x64 flag: the reference
    # (VLFeat, sift.cc) is float32 throughout and the descriptor
    # quantizes to uint8, so f64 buys nothing — and f64 conv/gather
    # kernels on XLA:CPU segfault flakily in this jaxlib (~30 % of
    # extracts; delayed heap-corruption signature with crash sites in
    # later compiles).  Repro + config table: tools/repro_sift_segv.py,
    # reports/sift_segv_r5.md.
    if image.dtype == jnp.float64:
        image = image.astype(jnp.float32)
    dtype = image.dtype
    base = image
    if opts.first_octave < 0:
        base = _upsample2(image)
    # Pre-blur to sigma0 at the first octave.
    nominal = opts.nominal_sigma * (2.0 ** (-opts.first_octave))
    delta = math.sqrt(max(opts.sigma0 ** 2 - nominal ** 2, 0.01))
    base = _blur(base, delta)

    all_feats = []
    octave_img = base
    for oi in range(opts.num_octaves):
        scale_mult = 2.0 ** (oi + opts.first_octave)
        x, y, sig, th, desc, val, peak = _octave_features(
            octave_img, oi, opts, dtype)
        all_feats.append((x * scale_mult, y * scale_mult, sig * scale_mult,
                          th, desc, val, peak))
        # Next octave: downsample the level with sigma = 2*sigma0.
        S = opts.octave_resolution
        sig_next = opts.sigma0 * 2.0
        # Rebuild the 2x-blurred level: blur base by increment then slice.
        lvl = _blur(octave_img, math.sqrt(max(sig_next ** 2
                                              - opts.sigma0 ** 2, 1e-6)))
        octave_img = _downsample2(lvl)

    xs = jnp.concatenate([f[0] for f in all_feats])
    ys = jnp.concatenate([f[1] for f in all_feats])
    sigs = jnp.concatenate([f[2] for f in all_feats])
    ths = jnp.concatenate([f[3] for f in all_feats])
    descs = jnp.concatenate([f[4] for f in all_feats])
    vals = jnp.concatenate([f[5] for f in all_feats])
    peaks = jnp.concatenate([f[6] for f in all_feats])

    K = opts.max_num_features
    rank = sigs if opts.selection == "scale" else peaks
    score = jnp.where(vals, rank, -1.0)
    if score.shape[0] < K:
        pad = K - score.shape[0]
        score = jnp.pad(score, (0, pad), constant_values=-1.0)
        xs = jnp.pad(xs, (0, pad))
        ys = jnp.pad(ys, (0, pad))
        sigs = jnp.pad(sigs, (0, pad))
        ths = jnp.pad(ths, (0, pad))
        descs = jnp.pad(descs, ((0, pad), (0, 0)))
        vals = jnp.pad(vals, (0, pad))
    top_score, top_idx = jax.lax.top_k(score, K)
    keep_valid = top_score > 0.0

    kp = jnp.stack([jnp.take(xs, top_idx), jnp.take(ys, top_idx),
                    jnp.take(sigs, top_idx), jnp.take(ths, top_idx)], axis=-1)
    d = jnp.take(descs, top_idx, axis=0)

    # L1-root normalize + quantize (feature.cc:52-77).
    l1 = jnp.sum(jnp.abs(d), axis=-1, keepdims=True)
    d = jnp.sqrt(d / jnp.maximum(l1, 1e-12))
    d_u8 = jnp.clip(jnp.round(512.0 * d), 0, 255).astype(jnp.uint8)
    d_u8 = d_u8 * keep_valid[:, None].astype(jnp.uint8)

    return SiftFeatures(keypoints=kp, descriptors=d_u8, valid=keep_valid,
                        scores=top_score)
