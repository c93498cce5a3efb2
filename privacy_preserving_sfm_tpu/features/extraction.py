"""Feature extraction pipeline: image -> SIFT -> privacy line lift.

Twin of the reference's extraction pipeline + ``LineFeatureWriterThread``
(``src/feature/extraction.cc``): read image (+ per-image ``.gravity.txt``
and ``.camera_model.txt``, ``image_reader.cc:206-247``), resize to
``max_image_size``, extract SIFT, keep the top-scale ``max_num_features``,
pick exactly ``aligned_line_ratio`` of the keypoints as gravity-aligned
(shuffled split, ``extraction.cc:453-458``), lift every keypoint to a line
through its *normalized* image point (``extraction.cc:476-504``), and
discard the keypoint positions (privacy property — only descriptors, lines,
aligned flags and gravity survive).

Host-side IO stays in Python; the compute path (SIFT + lift) is jitted.
PNG is decoded by ``utils/png`` (zlib + numpy); other formats need PIL.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.features import sift as sift_mod
from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
from privacy_preserving_sfm_tpu.ops import lines as line_ops
from privacy_preserving_sfm_tpu.utils import png


class LiftedFeatures(NamedTuple):
    """Per-image privacy-preserving feature set (the DB row contents)."""

    descriptors: jax.Array  # (K, 128) uint8
    lines: jax.Array  # (K, 3) normalized lines
    aligned: jax.Array  # (K,) bool
    valid: jax.Array  # (K,) bool
    gravity: jax.Array  # (3,)


def load_image_grayscale(path: str) -> np.ndarray:
    """Read an image file to float32 grayscale in [0, 1] (FreeImage twin)."""
    return load_image_grayscale_u8(path).astype(np.float32) / 255.0


def load_image_grayscale_u8(path: str) -> np.ndarray:
    """Grayscale uint8 (device upload stays 1 byte/px; the jitted
    front-end normalizes on device).

    8-bit PNGs decode with ``utils/png`` alone; any other file needs PIL.
    """
    if png.is_png(path):
        try:
            return png.to_gray(png.read_png(path))
        except png.PNGError:
            pass  # e.g. 16-bit or palette PNG: PIL below
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: only 8-bit PNG images can be read without PIL "
            "(the Pillow package); install it to read this file") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def read_gravity_file(image_path: str) -> Optional[np.ndarray]:
    """Read ``<image>.gravity.txt`` (3 whitespace-separated floats).

    Mirrors ``image_reader.cc:206-216``; returns None when absent.
    """
    path = image_path + ".gravity.txt"
    if not os.path.exists(path):
        return None
    vals = np.loadtxt(path).reshape(-1)
    assert vals.shape[0] == 3, f"bad gravity file {path}"
    return vals.astype(np.float64)


def read_camera_model_file(image_path: str):
    """Read ``<image>.camera_model.txt``: model name + comma-sep params.

    Mirrors ``image_reader.cc:236-247``; returns (model_name, params) or
    None when absent.
    """
    path = image_path + ".camera_model.txt"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        content = f.read().strip()
    parts = [p.strip() for p in content.replace("\n", ",").split(",")
             if p.strip()]
    name = parts[0].upper()
    params = np.asarray([float(p) for p in parts[1:]], dtype=np.float64)
    return name, params


def read_exif_gps(image_path: str) -> Optional[np.ndarray]:
    """EXIF GPS position (lat deg, lon deg, alt m) of an image, or None.

    Mirror of ``Bitmap::ExifLatitude/Longitude/Altitude`` feeding the image
    prior position (``image_reader.cc:252-259``).  A ``<image>.gps.txt``
    sidecar (same 3 numbers) takes precedence — rendered datasets carry no
    EXIF.
    """
    sidecar = image_path + ".gps.txt"
    if os.path.exists(sidecar):
        vals = np.loadtxt(sidecar).reshape(-1)
        assert vals.shape[0] == 3, f"bad gps file {sidecar}"
        return vals.astype(np.float64)
    try:
        from PIL import ExifTags, Image

        with Image.open(image_path) as im:
            exif = im.getexif()
            gps = exif.get_ifd(ExifTags.IFD.GPSInfo)
    except Exception:
        return None
    if not gps:
        return None

    def dms(vals, ref, neg_ref):
        d = float(vals[0]) + float(vals[1]) / 60 + float(vals[2]) / 3600
        return -d if ref == neg_ref else d

    try:
        lat = dms(gps[2], gps.get(1, "N"), "S")
        lon = dms(gps[4], gps.get(3, "E"), "W")
        alt = float(gps.get(6, 0.0))
        if gps.get(5, 0) == 1:  # below sea level
            alt = -alt
        return np.asarray([lat, lon, alt], np.float64)
    except (KeyError, IndexError, TypeError):
        return None


def read_mask(image_path: str) -> Optional[np.ndarray]:
    """Per-image feature mask ``<image>.mask.png`` (bool, True = keep).

    Reference semantics (``image_reader.cc:42-50``): zero-valued mask
    pixels discard the features extracted there.
    """
    path = image_path + ".mask.png"
    if not os.path.exists(path):
        return None
    return load_image_grayscale_u8(path) > 0


def resize_to_max(image: np.ndarray, max_size: int):
    """Downscale so max(H, W) <= max_size; returns (image, scale factor).

    Camera parameters must be scaled by the same factor (the reference
    rescales the camera after resizing, ``extraction.cc:187-210``).
    """
    h, w = image.shape
    if max(h, w) <= max_size:
        return image, 1.0
    scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.asarray(jax.image.resize(
        jnp.asarray(image, jnp.float32), (nh, nw), "bilinear"))
    if image.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out, scale


def aligned_split_mask(key: jax.Array, valid: jax.Array,
                       ratio: float = 0.5) -> jax.Array:
    """Exactly ``floor(ratio * num_valid)`` aligned keypoints, shuffled.

    Matches the shuffled-prefix split of ``extraction.cc:453-458`` (not an
    iid Bernoulli draw).
    """
    n = valid.shape[0]
    r = jax.random.uniform(key, (n,))
    r = jnp.where(valid, r, 2.0)  # padding sorts last
    order = jnp.argsort(r)
    rank = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    num_aligned = (ratio * jnp.sum(valid)).astype(jnp.int32)
    return (rank < num_aligned) & valid


def lift_features(
    key: jax.Array,
    feats: sift_mod.SiftFeatures,
    camera_model: str,
    camera_params: jax.Array,
    gravity: jax.Array,
    aligned_ratio: float = 0.5,
) -> LiftedFeatures:
    """Lift extracted keypoints to privacy-preserving lines.

    The keypoint positions exist only inside this function; the output
    contains descriptors + lines + aligned flags + gravity, like the DB
    write in ``extraction.cc:507-524``.
    """
    k_split, k_lift = jax.random.split(key)
    aligned = aligned_split_mask(k_split, feats.valid, aligned_ratio)
    xy_norm = cam_ops.image_to_world(camera_model, camera_params,
                                     feats.keypoints[:, :2])
    lines = line_ops.lift_keypoints_to_lines(
        k_lift, xy_norm, gravity.astype(xy_norm.dtype), aligned)
    return LiftedFeatures(descriptors=feats.descriptors, lines=lines,
                          aligned=aligned, valid=feats.valid,
                          gravity=gravity)


def extract_and_lift(
    key: jax.Array,
    image: jax.Array,
    camera_model: str,
    camera_params: jax.Array,
    gravity: jax.Array,
    sift_options: sift_mod.SiftOptions = sift_mod.SiftOptions(),
    aligned_ratio: float = 0.5,
    mask: Optional[jax.Array] = None,
) -> LiftedFeatures:
    """Full per-image front-end: SIFT + aligned split + line lift (jittable).

    ``mask`` (H, W) bool, resized to the working image: keypoints on False
    pixels are dropped (``image_reader.cc:42-50`` semantics).
    """
    k_sift, k_lift = jax.random.split(key)
    if jnp.issubdtype(image.dtype, jnp.integer):
        # Accept uint8 uploads (4x less host->device traffic than f32)
        # and normalize on device.
        image = image.astype(jnp.float32) / 255.0
    feats = sift_mod.extract_sift(image, sift_options)
    if mask is not None:
        h, w = image.shape
        xi = jnp.clip(jnp.round(feats.keypoints[:, 0]).astype(jnp.int32),
                      0, w - 1)
        yi = jnp.clip(jnp.round(feats.keypoints[:, 1]).astype(jnp.int32),
                      0, h - 1)
        feats = feats._replace(valid=feats.valid & mask[yi, xi])
    return lift_features(k_lift, feats, camera_model, camera_params, gravity,
                         aligned_ratio)


_JIT_FRONTEND = {}


_JIT_FRONTEND_BATCH: dict = {}


def extract_and_lift_batch_jit(keys, images, camera_model: str,
                               camera_params, gravities,
                               sift_options: sift_mod.SiftOptions
                               = sift_mod.SiftOptions(),
                               aligned_ratio: float = 0.5,
                               masks=None) -> LiftedFeatures:
    """Vmapped ``extract_and_lift`` over a batch of same-shape images.

    One device call and one transfer per B images instead of per image.
    keys (B, 2) uint32, images (B, H, W), camera_params
    (B, Pr), gravities (B, 3); returns LiftedFeatures with leading B.
    """
    import jax as _jax

    ck = (images.shape, str(images.dtype), camera_model,
          tuple(camera_params.shape), sift_options, float(aligned_ratio),
          masks is not None)
    if ck not in _JIT_FRONTEND_BATCH:
        def one(k, im, par, g, m):
            return extract_and_lift(k, im, camera_model, par, g,
                                    sift_options, aligned_ratio, m)

        _JIT_FRONTEND_BATCH[ck] = _jax.jit(_jax.vmap(one))
    if masks is None:
        import jax.numpy as _jnp

        masks_in = _jnp.ones(
            (images.shape[0],) + images.shape[1:3], bool)
        # vmap needs a concrete argument; extract_and_lift treats an
        # all-True mask identically to None.
        return _JIT_FRONTEND_BATCH[ck](keys, images, camera_params,
                                       gravities, masks_in)
    return _JIT_FRONTEND_BATCH[ck](keys, images, camera_params,
                                   gravities, masks)


def extract_and_lift_jit(key, image, camera_model: str, camera_params,
                         gravity,
                         sift_options: sift_mod.SiftOptions
                         = sift_mod.SiftOptions(),
                         aligned_ratio: float = 0.5,
                         mask=None) -> LiftedFeatures:
    """``extract_and_lift`` compiled once per (image shape, model, opts).

    Run eagerly, the SIFT octave pipeline dispatches ~5500 individual XLA
    ops per image (measured 5.1 s/image of pure dispatch overhead on
    CPU).  Jitted, the whole front-end is one device call; the one-time
    compile persists in the XLA compile cache.
    """
    import jax as _jax

    ck = (image.shape, str(image.dtype), camera_model,
          tuple(camera_params.shape), sift_options, float(aligned_ratio),
          mask is not None)
    if ck not in _JIT_FRONTEND:
        _JIT_FRONTEND[ck] = _jax.jit(
            lambda k, im, par, g, m: extract_and_lift(
                k, im, camera_model, par, g, sift_options, aligned_ratio,
                m))
    if mask is None:
        return _JIT_FRONTEND[ck](key, image, camera_params, gravity, None)
    return _JIT_FRONTEND[ck](key, image, camera_params, gravity, mask)
