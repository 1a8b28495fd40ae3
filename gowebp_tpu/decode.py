"""Top-level decode API.

Equivalent surface: libwebp's WebPDecode/WebPDecodeRGBA family with
WebPDecoderOptions (catalogued from the reference in SURVEY.md §2.4/§3.3;
/root/reference/decode.go itself panics).
"""

from __future__ import annotations

import numpy as np

from .constants import CHUNK_ALPHA, CHUNK_VP8, CHUNK_VP8L
from .container.riff import WebPFeatures, get_features, parse_riff
from .decode_options import DecoderConfig, apply_output_options
from .errors import BitstreamError

_MODE_PERMUTE = {
    "RGBA": (0, 1, 2, 3),
    "BGRA": (2, 1, 0, 3),
    "ARGB": (3, 0, 1, 2),
    "RGB": (0, 1, 2),
    "BGR": (2, 1, 0),
}
# Premultiplied variants (reference MODE_rgbA/bgrA/Argb) share the
# channel orders; the premultiply runs first.
_MODE_PREMULT = {"rgbA": "RGBA", "bgrA": "BGRA", "Argb": "ARGB",
                 "rgbA_4444": "RGBA_4444"}
_MODE_PACKED = ("RGB_565", "RGBA_4444")


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """8-bit approximate premultiply: (c * a * 32897) >> 23.

    Matches the reference's alpha_processing MULTIPLIER idiom
    (alpha_processing.go:100-163) rather than exact c*a/255.
    """
    out = rgba.copy()
    a = rgba[..., 3].astype(np.uint32)
    for c in range(3):
        out[..., c] = ((rgba[..., c].astype(np.uint32) * a * 32897)
                       >> 23).astype(np.uint8)
    return out


def _pack_16bit(rgba: np.ndarray, mode: str) -> np.ndarray:
    """(H, W, 4) → (H, W, 2) uint8 packed rows (reference MODE_RGB_565 /
    MODE_RGBA_4444 byte order)."""
    r = rgba[..., 0].astype(np.uint16)
    g = rgba[..., 1].astype(np.uint16)
    b = rgba[..., 2].astype(np.uint16)
    out = np.empty(rgba.shape[:2] + (2,), np.uint8)
    if mode == "RGB_565":
        out[..., 0] = ((r & 0xF8) | (g >> 5)).astype(np.uint8)
        out[..., 1] = (((g << 3) & 0xE0) | (b >> 3)).astype(np.uint8)
    else:  # RGBA_4444
        a = rgba[..., 3].astype(np.uint16)
        out[..., 0] = ((r & 0xF0) | (g >> 4)).astype(np.uint8)
        out[..., 1] = ((b & 0xF0) | (a >> 4)).astype(np.uint8)
    return out


def decode(data: bytes, config: DecoderConfig | None = None,
           mode: str = "RGBA") -> np.ndarray:
    """Decode a .webp file with options → (H, W, C) uint8 array.

    ``mode`` accepts the reference's colorspace set: RGBA/BGRA/ARGB/
    RGB/BGR, premultiplied rgbA/bgrA/Argb/rgbA_4444, and the packed
    RGB_565/RGBA_4444 (returned as (H, W, 2) byte pairs).
    """
    premult = mode in _MODE_PREMULT
    if premult:
        mode = _MODE_PREMULT[mode]
    if mode not in _MODE_PERMUTE and mode not in _MODE_PACKED:
        raise ValueError(
            f"bad mode {mode!r} (use {sorted(_MODE_PERMUTE) + list(_MODE_PACKED) + sorted(_MODE_PREMULT)})"
        )
    config = config or DecoderConfig()
    parsed = parse_riff(data)
    vp8l = parsed.find(CHUNK_VP8L)
    if vp8l is not None:
        from .models.vp8l.decoder import decode_vp8l

        rgba = decode_vp8l(vp8l.payload)
    else:
        vp8 = parsed.find(CHUNK_VP8)
        if vp8 is None:
            raise BitstreamError("no decodable image chunk found")
        try:
            from .models.vp8.decoder import decode_vp8_rgba
        except ImportError as exc:  # pragma: no cover
            from .errors import UnsupportedFeature

            raise UnsupportedFeature("VP8 lossy decode not built") from exc
        alpha_chunk = parsed.find(CHUNK_ALPHA)
        rgba = decode_vp8_rgba(
            vp8.payload,
            alpha_payload=alpha_chunk.payload if alpha_chunk else None,
            fancy_upsampling=not config.no_fancy_upsampling,
            bypass_filtering=config.bypass_filtering,
            dithering_strength=config.dithering_strength,
        )
    if (config.alpha_dithering_strength > 0 and rgba.shape[2] == 4
            and bool((rgba[..., 3] != 255).any())):
        # Alpha dithering (reference alpha_dithering_strength option):
        # deterministic triangular dither over the smoothed alpha plane.
        amp = 8 * config.alpha_dithering_strength // 100
        if amp > 0:
            rng = np.random.default_rng(0xA1FA)
            sh = rgba.shape[:2]
            noise = (rng.integers(0, amp + 1, sh)
                     + rng.integers(0, amp + 1, sh) - amp).astype(np.int32)
            a = np.clip(rgba[..., 3].astype(np.int32) + noise // 2, 0, 255)
            rgba = rgba.copy()
            rgba[..., 3] = a.astype(np.uint8)
    rgba = apply_output_options(rgba, config)
    if premult:
        rgba = _premultiply(rgba)
    if mode in _MODE_PACKED:
        return _pack_16bit(rgba, mode)
    perm = _MODE_PERMUTE[mode]
    if perm == tuple(range(rgba.shape[2])):
        return rgba          # identity permute: no copy
    return np.ascontiguousarray(rgba[..., list(perm)])


def decode_rgba(data: bytes, config: DecoderConfig | None = None) -> np.ndarray:
    """Decode a .webp file (still image) to an (H, W, 4) uint8 RGBA array."""
    return decode(data, config, "RGBA")


_MODE_CHANNELS = {"RGBA": 4, "BGRA": 4, "ARGB": 4, "RGB": 3, "BGR": 3,
                  "rgbA": 4, "bgrA": 4, "Argb": 4,
                  "RGB_565": 2, "RGBA_4444": 2, "rgbA_4444": 2}


def decode_into(data: bytes, out: np.ndarray,
                config: DecoderConfig | None = None,
                mode: str | None = None) -> np.ndarray:
    """Decode into a caller-owned (possibly strided) output buffer.

    Equivalent surface: external-memory WebPDecBuffer decode
    (/root/reference/pkg/libwebp/decoder/buffer_dec.c.go:195
    ``WebPAllocateDecBuffer`` with is_external_memory, and the
    WebPDecodeRGBAInto family): the caller provides the destination —
    any uint8 array view works, including a window into a larger frame
    buffer (arbitrary row stride), so a zero-copy ML-ingest pipeline
    can decode straight into its batch tensor slot.

    ``out`` must be (H, W, C) uint8 with H/W matching the decoded
    output under ``config`` (after any crop/scale) and C matching
    ``mode`` (default: RGBA for C=4, RGB for C=3).  Returns ``out``.
    """
    out = np.asanyarray(out)
    if out.dtype != np.uint8 or out.ndim != 3:
        raise ValueError("out must be an (H, W, C) uint8 array")
    if mode is None:
        if out.shape[2] == 4:
            mode = "RGBA"
        elif out.shape[2] == 3:
            mode = "RGB"
        else:
            raise ValueError("packed modes need an explicit mode=")
    want_c = _MODE_CHANNELS.get(mode)
    if want_c is None:
        raise ValueError(f"bad mode {mode!r}")
    if out.shape[2] != want_c:
        raise ValueError(
            f"out has {out.shape[2]} channels, mode {mode} needs {want_c}")
    result = decode(data, config, mode)
    if result.shape != out.shape:
        raise ValueError(
            f"out shape {out.shape} != decoded shape {result.shape}")
    np.copyto(out, result)
    return out


def decode_rgb(data: bytes, config: DecoderConfig | None = None) -> np.ndarray:
    return decode(data, config, "RGB")


def decode_yuv(data: bytes):
    """Decode to raw Y/U/V planes (lossy files only)."""
    parsed = parse_riff(data)
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is None:
        raise BitstreamError("YUV output requires a lossy (VP8) file")
    from .models.vp8.decoder import decode_vp8_yuv

    return decode_vp8_yuv(vp8.payload)


def decode_yuva(data: bytes, config: DecoderConfig | None = None):
    """Decode a lossy file to raw Y/U/V(/A) planes with output options.

    The reference's MODE_YUV/MODE_YUVA output path with crop →
    per-plane fixed-point rescale → flip (io_dec.c.go:232-520
    EmitRescaledYUV/ExportYUVA, buffer_dec.c.go WebPDecodeYUV).
    Returns ``(y, u, v, a)`` uint8 arrays; ``a`` is None for files
    without an ALPH chunk.  Crop offsets snap down to even for chroma
    alignment, like the reference's crop validation.
    """
    from .decode_options import _rescale

    config = config or DecoderConfig()
    parsed = parse_riff(data)
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is None:
        raise BitstreamError("YUV output requires a lossy (VP8) file")
    from .models.vp8.decoder import decode_vp8_yuv

    y, u, v = decode_vp8_yuv(
        vp8.payload,
        bypass_filtering=config.bypass_filtering,
        dithering_strength=config.dithering_strength)
    H, W = y.shape
    config.validate(W, H)
    alpha_chunk = parsed.find(CHUNK_ALPHA)
    a = None
    if alpha_chunk is not None:
        from .models.vp8.alpha import decode_alpha

        a = decode_alpha(alpha_chunk.payload, W, H)

    if config.use_cropping:
        left, top = config.crop_left & ~1, config.crop_top & ~1
        cw, ch = config.crop_width, config.crop_height
        y = y[top:top + ch, left:left + cw]
        u = u[top // 2:(top + ch + 1) // 2,
              left // 2:(left + cw + 1) // 2]
        v = v[top // 2:(top + ch + 1) // 2,
              left // 2:(left + cw + 1) // 2]
        if a is not None:
            a = a[top:top + ch, left:left + cw]
    if config.use_scaling:
        sw, sh = config.resolve_scale(y.shape[1], y.shape[0])

        def rs(p, w2, h2):
            return _rescale(p[..., None], w2, h2)[..., 0]

        y, u, v = (rs(y, sw, sh),
                   rs(u, (sw + 1) // 2, (sh + 1) // 2),
                   rs(v, (sw + 1) // 2, (sh + 1) // 2))
        if a is not None:
            a = rs(a, sw, sh)
    if config.flip:
        y, u, v = y[::-1], u[::-1], v[::-1]
        if a is not None:
            a = a[::-1]
    cc = np.ascontiguousarray
    return cc(y), cc(u), cc(v), (cc(a) if a is not None else None)


def decode_rgba_batch(datas: list, use_device: bool = True,
                      threads: int = 0, recon_backend: str = "jax",
                      device_out: bool = False) -> list:
    """Decode many .webp files with the pixel-rate phases on the device.

    Host threads run the sequential entropy decode (the C++ layer
    releases the GIL); all dense work — dequant+iDCT, the intra
    reconstruction wavefront, the loop filter, chroma upsample and
    YUV→RGBA — runs as batched jit calls, one launch per
    (width, height, filter_type) group.

    recon_backend: "jax" reconstructs on-device
    (ops/vp8_recon_jax.recon_frame); "host" runs the whole pipeline on
    the host (native C++ recon + fused fancy-upsample/YUV→RGBA) with
    no accelerator round trip.  Outputs are bit-identical either way.

    device_out=True returns per-image jax device arrays instead of
    NumPy — for ML-ingestion pipelines the decoded pixels stay on the
    device (no device→host copy); images that fell back to the host
    decoder are device_put.

    use_device=False decodes every file with the per-image host decoder.
    """
    import concurrent.futures as cf

    from .models.vp8.decoder import (decode_vp8_symbols,
                                     decode_vp8_symbols_batch,
                                     decode_vp8_yuv, vp8_filter_params)

    use_jax_recon = use_device and recon_backend == "jax"

    def classify(i, data):
        """Cheap container probe: route each file to its host engine."""
        parsed = parse_riff(data)
        vp8 = parsed.find(CHUNK_VP8)
        if not use_device:
            return ("full", i, data, None)
        if vp8 is None:
            vp8l = parsed.find(CHUNK_VP8L)
            if vp8l is None:
                return ("full", i, data, None)
            return ("vp8l", i, vp8l.payload, None)
        alpha = parsed.find(CHUNK_ALPHA)
        # Both recon backends ride the interleaved symbol engine; they
        # differ only in where the pixel-rate phases run (vp8_group vs
        # vp8_host_group below).
        return ("vp8", i, vp8.payload, alpha.payload if alpha else None)

    routed = [classify(i, d) for i, d in enumerate(datas)]
    vp8_items = [(i, p, a) for kind, i, p, a in routed if kind == "vp8"]
    other = [(kind, i, p) for kind, i, p, _ in routed if kind != "vp8"]

    workers = threads if threads > 0 else min(8, max(1, len(datas)))

    def other_one(item):
        kind, i, payload = item
        if kind == "full":
            return (i, "full", decode_rgba(payload))
        if kind == "vp8l":
            # VP8L: the sequential Huffman + inverse-transform phases run
            # here (native, GIL-released, parallel across images); only
            # the embarrassingly-parallel ARGB→RGBA conversion batches
            # on device.  The predictor inverse is a per-pixel raster
            # recurrence (SURVEY §7 hard part #2) — host C++ is the
            # right engine for it.
            from .models.vp8l.decoder import decode_vp8l

            return (i, "rgba", decode_vp8l(payload))
        return (i, "planes", decode_vp8_yuv(payload))

    def vp8_group(items):
        """One interleaved-engine call decodes a whole group of VP8
        streams in a single thread (the engine overlaps their bitstream
        chains itself), then DISPATCHES the batched device recon without
        awaiting it — JAX dispatch is async, so while this group's
        reconstruction runs on the device, the other threads' symbol
        phases keep the host cores busy (host/device overlap)."""
        import numpy as np

        from .models.vp8.alpha import decode_alpha
        from .ops.coeff_pack import pack_coeffs, recon_frame_packed
        from .ops.yuv_jax import batch_yuv_to_rgba

        syms = decode_vp8_symbols_batch([p for _, p, _ in items])
        per = []
        for (i, _, ap), (st, coeffs, modes) in zip(items, syms):
            alpha_plane = (decode_alpha(ap, st.width, st.height)
                           if ap is not None else None)
            per.append((i, st, coeffs, modes,
                        vp8_filter_params(st, modes), alpha_plane))
        shape_groups = {}
        for rec in per:
            st = rec[1]
            key = (st.width, st.height, st.filter_type, rec[5] is not None)
            shape_groups.setdefault(key, []).append(rec)
        out = []
        for (W, H, ftype, has_alpha), recs in shape_groups.items():
            st0 = recs[0][1]
            coeffs = np.stack([r[2] for r in recs])
            modes = np.stack([r[3] for r in recs])
            fps = np.stack([r[4] for r in recs])
            # Sparse wire layout: int8 levels + exceptions instead of
            # the dense int16 coefficients — 3-4x fewer upload bytes;
            # the device re-dequantizes fused into the recon program
            # (ops/coeff_pack.py), bit-identical to the dense path.
            qmat = np.stack([
                np.array([[m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac,
                           m.uv_dc, m.uv_ac] for m in r[1].dqm], np.int32)
                for r in recs])
            packed, K, _cap = pack_coeffs(
                coeffs, modes[:, :, 2], modes[:, :, 0], qmat)
            Y, U, V = recon_frame_packed(
                packed, modes[:, :, 0], modes[:, :, 5:21],
                modes[:, :, 1], fps.astype(np.int16), K=K,
                mb_w=st0.mb_w, mb_h=st0.mb_h, filter_type=ftype)
            h2, w2 = (H + 1) // 2, (W + 1) // 2
            rgba = batch_yuv_to_rgba(
                Y[:, :H, :W].astype("int32"),
                U[:, :h2, :w2].astype("int32"),
                V[:, :h2, :w2].astype("int32"))
            if has_alpha:
                rgba = _set_alpha_batch(
                    rgba, np.stack([r[5] for r in recs]))
            for k, r in enumerate(recs):
                out.append((r[0], "rgba_dev", (rgba, k)))
        return out

    def vp8_host_group(items):
        """recon_backend="host": the ENTIRE pipeline stays on the host —
        interleaved symbol engine → native array-driven recon + loop
        filter → fused fancy-upsample/YUV→RGBA C++ — so nothing ever
        crosses the accelerator link.  The path for pixels wanted in
        host memory; bit-identical to the device path."""
        from .models.vp8.alpha import decode_alpha
        from .models.vp8.decoder import (decode_vp8_rgba, recon_vp8_yuv_host,
                                         yuv_planes_to_rgba)

        syms = decode_vp8_symbols_batch([p for _, p, _ in items])
        out = []
        for (i, p, ap), (st, coeffs, modes) in zip(items, syms):
            planes = recon_vp8_yuv_host(st, coeffs, modes)
            if planes is None:                 # no native layer
                out.append((i, "rgba", decode_vp8_rgba(p, ap)))
                continue
            rgba = yuv_planes_to_rgba(*planes)
            if ap is not None:
                rgba[..., 3] = decode_alpha(ap, st.width, st.height)
            out.append((i, "rgba", rgba))
        return out

    group_fn = vp8_group if use_jax_recon else vp8_host_group

    host = []
    # One engine call per thread (32 interleave lanes each); each
    # group's device recon overlaps the next group's symbol phase.
    ng = min(workers, max(1, -(-len(vp8_items) // 32)))
    if workers <= 1 or (ng <= 1 and not other):
        if vp8_items:
            host.extend(group_fn(vp8_items))
        host.extend(other_one(it) for it in other)
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            groups = [vp8_items[g::ng] for g in range(ng)] if vp8_items else []
            futs = [pool.submit(group_fn, g) for g in groups]
            other_res = list(pool.map(other_one, other))
            for f in futs:
                host.extend(f.result())
            host.extend(other_res)

    results = [None] * len(datas)
    planes_groups = {}
    rgba_groups = {}
    dev_batches = []                      # [(dev_batch, [(i, k), ...])]
    for i, kind, val in host:
        if kind == "full":
            results[i] = val
        elif kind == "rgba":
            rgba_groups.setdefault(val.shape, []).append((i, val))
        elif kind == "planes":
            planes_groups.setdefault(val[0].shape, []).append((i, val))
        else:                             # "rgba_dev"
            dev, k = val
            for db, lst in dev_batches:
                if db is dev:
                    lst.append((i, k))
                    break
            else:
                dev_batches.append((dev, [(i, k)]))

    import numpy as np

    if planes_groups:
        from .ops.yuv_jax import batch_yuv_to_rgba

    if device_out:
        import jax

        for i, r in enumerate(results):
            if r is not None:
                results[i] = jax.device_put(r)

    def materialize(dev_batch, items):
        out = dev_batch if device_out else np.asarray(dev_batch)
        for k, (i, _) in enumerate(items):
            results[i] = out[k]

    for shape, items in rgba_groups.items():
        if device_out:
            import jax

            dev = jax.device_put(np.stack([r for _, r in items]))
            for k, (i, _) in enumerate(items):
                results[i] = dev[k]
        else:
            for i, r in items:
                results[i] = r

    for shape, items in planes_groups.items():
        y = np.stack([p[0] for _, p in items]).astype(np.int32)
        u = np.stack([p[1] for _, p in items]).astype(np.int32)
        v = np.stack([p[2] for _, p in items]).astype(np.int32)
        materialize(batch_yuv_to_rgba(y, u, v), items)

    # rgba_dev batches were dispatched inside the symbol threads; only
    # materialize (or slice) them here.
    for dev, lst in dev_batches:
        out = dev if device_out else np.asarray(dev)
        for i, k in lst:
            results[i] = out[k]
    return results


def _set_alpha_batch(rgba, alpha):
    """(B, H, W, 4) device RGBA + (B, H, W) uint8 alpha planes → merged."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _merge(rgba, alpha):
        return jnp.concatenate(
            [rgba[..., :3], alpha[..., None].astype(jnp.uint8)], axis=-1)

    return _merge(rgba, jax.device_put(alpha))


def features(data: bytes) -> WebPFeatures:
    return get_features(data)


__all__ = [
    "decode",
    "decode_into",
    "decode_rgba",
    "decode_rgb",
    "decode_yuv",
    "features",
    "DecoderConfig",
]
