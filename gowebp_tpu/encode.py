"""Top-level encode API.

Equivalent surface: /root/reference/encode.go + pkg/libwebp/enc (the
libwebp WebPEncode pipeline catalogued in SURVEY.md §2.5/§3.1).
"""

from __future__ import annotations

import numpy as np

from .config import EncoderConfig
from .constants import CHUNK_VP8L
from .container.riff import Chunk, assemble_simple
from .errors import EncodeError


def encode_rgba(
    rgba: np.ndarray,
    *,
    lossless: bool = False,
    quality: float = 75.0,
    method: int = 4,
    config: EncoderConfig | None = None,
    stats=None,
) -> bytes:
    """Encode an (H, W, 3|4) uint8 array into a .webp byte string.

    Defaults to lossy VP8 at quality 75, matching the reference's
    WebPEncodeRGBA defaults (webp/encode.go: lossless off by default).

    Pass an EncodeStats instance as ``stats`` to collect WebPAuxStats-style
    diagnostics for the encode.
    """
    if config is None:
        config = EncoderConfig(lossless=lossless, quality=quality, method=method)
    config.validate()
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise EncodeError("expected uint8 pixels")
    if (not config.exact and rgba.ndim == 3 and rgba.shape[2] == 4
            and bool((rgba[..., 3] == 0).any())):
        rgba = _cleanup_transparent_area(rgba)

    _progress(config, 0)
    if config.lossless:
        from .models.vp8l.encoder import encode_vp8l

        if config.near_lossless < 100:
            from .models.vp8l.near_lossless import apply_near_lossless

            if rgba.shape[2] == 3:
                rgba = np.concatenate(
                    [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)],
                    axis=-1,
                )
            rgba = apply_near_lossless(rgba, config.near_lossless)

        payload = encode_vp8l(rgba, quality=int(config.quality),
                              method=config.method, stats=stats,
                              hint=int(config.image_hint))
        out = assemble_simple(Chunk(CHUNK_VP8L, payload))
        if stats is not None:
            stats.coded_size = len(out)
            stats.lossless_size = len(payload)
        _progress(config, 100)
        return out

    from .models.vp8.encoder import encode_vp8_webp

    out = encode_vp8_webp(rgba, config, stats=stats)
    if stats is not None:
        stats.coded_size = len(out)
    _progress(config, 100)
    return out


def encode_yuv(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    *,
    alpha: np.ndarray | None = None,
    quality: float = 75.0,
    method: int = 4,
    config: EncoderConfig | None = None,
    stats=None,
) -> bytes:
    """Encode pre-converted YUV420 planes into a lossy .webp byte string.

    The reference Picture container accepts YUV420(A) planes directly
    (pkg/picture picture.go:33-105, WebPPictureAllocYUVA) — this is that
    input path: no RGB conversion happens, the planes go straight to the
    VP8 coder.  y is (H, W); u and v are (ceil(H/2), ceil(W/2)); alpha,
    if given, is (H, W) and produces an ALPH chunk + VP8X container.
    """
    from .constants import CHUNK_VP8
    from .models.vp8.encoder import _pad_to_mb, encode_vp8_frame

    if config is None:
        config = EncoderConfig(lossless=False, quality=quality, method=method)
    config.validate()
    y = np.asarray(y)
    u = np.asarray(u)
    v = np.asarray(v)
    if y.dtype != np.uint8 or u.dtype != np.uint8 or v.dtype != np.uint8:
        raise EncodeError("expected uint8 planes")
    h, w = y.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if u.shape != (ch, cw) or v.shape != (ch, cw):
        raise EncodeError("u/v planes must be (ceil(H/2), ceil(W/2))")

    _progress(config, 0)
    yp = _pad_to_mb(y, 16)
    up = _pad_to_mb(u, 8)
    vp = _pad_to_mb(v, 8)
    payload = encode_vp8_frame(yp, up, vp, w, h, config, stats=stats)
    if alpha is None:
        out = assemble_simple(Chunk(CHUNK_VP8, payload))
    else:
        from .constants import CHUNK_ALPHA
        from .container.riff import assemble, build_vp8x
        from .models.vp8.alpha import encode_alpha

        alpha = np.asarray(alpha)
        if alpha.shape != (h, w):
            raise EncodeError("alpha plane must match luma shape")
        alpha_payload = encode_alpha(
            alpha,
            method=config.alpha_compression,
            quality=config.alpha_quality,
            filtering_level=config.alpha_filtering,
        )
        out = assemble([
            build_vp8x(w, h, has_alpha=True),
            Chunk(CHUNK_ALPHA, alpha_payload),
            Chunk(CHUNK_VP8, payload),
        ])
    if stats is not None:
        stats.coded_size = len(out)
    _progress(config, 100)
    return out


def encode_rgba_batch(
    images: list,
    *,
    quality: float = 75.0,
    threads: int = 0,
    use_device: bool = True,
    engine: str = "hybrid",
) -> list:
    """Lossy-encode a batch of same-shaped images (full-quality path).

    Thin wrapper over the pipelined engine (ops/encode_pipeline.py) —
    segmentation, i4 mode search, per-segment quantizers, overlapped
    h2d/device/d2h/emit stages.  ``engine`` picks the dense encoder:
    "hybrid" (default: parallel mode search + exact fixed-mode
    closed-loop wavefront), "wavefront" (full in-loop RD search,
    bit-identical to ``encode_rgba(im)`` with plane_backend="jax"), or
    "openloop" (fastest, prediction drift).  Encodes per image on the
    host when ``use_device`` is False, when the native entropy emitter
    is not built, or when shapes differ.  Errors raised on the device
    path (out of memory, a failed compile) propagate.
    """
    import numpy as np

    from .entropy.native_loader import available as native_available

    if not images:
        return []
    shape = np.asarray(images[0]).shape
    config = EncoderConfig(lossless=False, quality=quality)
    if (not use_device or not native_available()
            or any(np.asarray(im).shape != shape for im in images)):
        return [encode_rgba(im, config=config) for im in images]
    from .ops.encode_pipeline import encode_rgba_batch_pipelined

    return encode_rgba_batch_pipelined(
        images, quality=quality,
        threads=(threads if threads > 0 else min(8, len(images))),
        chunk=min(16, len(images)), engine=engine, config=config)


def _cleanup_transparent_area(rgba: np.ndarray) -> np.ndarray:
    """Flatten RGB under fully-transparent pixels for compressibility.

    Reference WebPCleanupTransparentArea (picture_tools_enc.c.go,
    SURVEY.md §2.5): unless ``exact`` is set, invisible pixels are free
    — per 16x16 block, partially-transparent blocks replace invisible
    RGB with the block's visible average; fully-transparent blocks
    propagate the previous flat color so runs compress to nothing.
    """
    out = rgba.copy()
    h, w = rgba.shape[:2]
    alpha = rgba[..., 3]
    flat = np.zeros(3, np.uint8)
    for by in range(0, h, 16):
        for bx in range(0, w, 16):
            a = alpha[by : by + 16, bx : bx + 16]
            vis = a > 0
            n_vis = int(vis.sum())
            blk = out[by : by + 16, bx : bx + 16, :3]
            if n_vis == 0:
                blk[:] = flat
            elif n_vis < a.size:
                mean = blk[vis].mean(axis=0).astype(np.uint8)
                blk[~vis] = mean
                flat = mean
            else:
                flat = blk[-1, -1]
    return out


def _progress(config: EncoderConfig, percent: int) -> None:
    hook = getattr(config, "progress_hook", None)
    if hook is not None and hook(percent) is False:
        raise EncodeError("encoding aborted by progress hook")


__all__ = ["encode_rgba", "encode_rgba_batch", "encode_yuv"]
