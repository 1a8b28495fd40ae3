"""Smoke run of the codec's device path on one GPU, at real image sizes.

    python chip_smoke.py               # one card: phases 0-5 below
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Drives the main path through the entry points a user calls
(`encode_rgba_batch`, `encode_rgba`, `decode_rgba_batch`) on 1024x1024
photographic images and checks every result with the repository's own
references: the native host encoder and decoder, which the CPU test
suite pins to libwebp.  When Pillow is importable the libwebp checks run
as well.

Every comparison is bit-exact.  The codec is integer arithmetic from end
to end, so a device result either equals its reference or the device
path is wrong; no tolerance applies.  The one window (phase 2: size and
PSNR of the hybrid engine against the exact engine, and against libwebp)
compares two different encoders, not a device with a reference.

Phases (one card):
  0. preflight: GPU backend, native host layer, card name and power limit
  1. integer exactness of the one-hot f32 matmul selects on the card
  2. hybrid batch lossy encode, 16 x 1024x1024, the hybrid core on the
     GPU against the same core on the CPU backend, and XLA's memory
     analysis of the core at B=16
  3. exact wavefront encode == host encoder, byte for byte
  4. batch decode on the device == host decoder (also device_out=True)
  5. lossless encode at 1 MP with the predictor chooser on the device

Exits non-zero, printing no result, when JAX finds no GPU or any check
fails.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

SIZE = 1024          # image side of the one-card phases
BATCH = 16           # hybrid encode batch (one pipeline chunk)
N_DECODE = 64        # host-encoded files in the batch decode phase
QUALITY = 75.0


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    from gowebp_tpu.utils.metrics import psnr

    return psnr(a[..., :3], b[..., :3])


def _host_encode(images) -> list:
    """The host closed-loop encoder (plane_backend="numpy").  Its files
    equal the exact device engine's byte for byte (phase 3 checks that
    at full width), so it serves as the exact-engine reference."""
    import concurrent.futures as cf

    from gowebp_tpu.config import EncoderConfig
    from gowebp_tpu.encode import encode_rgba

    cfg = EncoderConfig(lossless=False, quality=QUALITY)
    with cf.ThreadPoolExecutor(8) as ex:
        return list(ex.map(lambda im: encode_rgba(im, config=cfg), images))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _same_leaves(a, b) -> bool:
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _on(device, fn, *args):
    """Run jitted ``fn`` with its array arguments committed to ``device``."""
    import jax

    args = jax.device_put(args, device)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


# ---------------------------------------------------------------------------
# Phase 1: integer exactness of the one-hot matmul selects
# ---------------------------------------------------------------------------

def probe_exactness(gpu, cpu, *, ctx_size: int = 256) -> None:
    """Each one-hot f32 matmul select of the device path, at its real
    value range, on ``gpu``: equal to a NumPy reference or to the same
    program on the CPU backend, bit for bit."""
    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config, make_quants, quality_to_q)
    from gowebp_tpu.ops import dct_jax, encode_wavefront_jax as wf
    from gowebp_tpu.ops.lossless_jax import chosen_histogram
    from gowebp_tpu.ops.vp8_recon_jax import _pred_luma4_all

    rng = np.random.default_rng(0)

    # zigzag permutations: dequantized coefficients reach +-2^19
    x = rng.integers(-(2 ** 19), 2 ** 19, (4096, 16)).astype(np.int32)
    zz, back = _on(gpu, lambda a: (dct_jax.zigzag_fwd(a),
                                   dct_jax.zigzag_inv(dct_jax.zigzag_fwd(a))),
                   x)
    check(np.array_equal(zz, x[:, dct_jax._ZIGZAG]), "zigzag_fwd at 2^19")
    check(np.array_equal(back, x), "zigzag_inv(zigzag_fwd) at 2^19")

    # B-mode prediction features (_B4_SEL): pixels 0..255
    n = 8192
    ctx = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((1, n), (1, n, 4), (1, n, 4), (1, n, 4))]
    check(_same_leaves(_on(gpu, _pred_luma4_all, *ctx),
                       _on(cpu, _pred_luma4_all, *ctx)),
          "_pred_luma4_all GPU != CPU")

    # top-k candidate selects: pixels, mode ids 0..9, mode bits <= 1024
    preds = rng.integers(0, 256, (1, n, 10, 4, 4)).astype(np.int32)
    src = rng.integers(0, 256, (1, n, 1, 4, 4)).astype(np.int32)
    got = _on(gpu, lambda p, s: wf._i4_candidates(p, s, 4), preds, src)
    sse = ((src - preds) ** 2).sum(axis=(-1, -2))
    order = np.argsort(sse, axis=-1, kind="stable")[..., :4]
    want = (np.take_along_axis(preds, order[..., None, None], axis=2),
            order.astype(np.int32), wf._MODE4_BITS256[order])
    check(_same_leaves(got, want), "_i4_candidates top-4 selects")

    # khot mode select of the parallel i4 search (plus the whole search)
    q = make_quants(quality_to_q(QUALITY))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    s = ctx_size
    planes = (rng.integers(0, 256, (1, s, s)).astype(np.int32),
              rng.integers(0, 256, (1, s // 2, s // 2)).astype(np.int32),
              rng.integers(0, 256, (1, s // 2, s // 2)).astype(np.int32),
              np.zeros((1, s // 16, s // 16), np.int32),
              np.broadcast_to(row, (1, 4, 6)).copy())
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    _, pen = _i4_config(q.y1_ac.q, 4, 0)

    def search(y, u, v, seg, qs):
        return wf.openloop_mode_search(y, u, v, seg, qs, tables,
                                       try_i4=True, i4_penalty=pen,
                                       i4_parallel=True)

    check(_same_leaves(_on(gpu, search, *planes), _on(cpu, search, *planes)),
          "parallel i4 search GPU != CPU")

    # VP8L chosen-residual histogram: counts up to a 64x64 tile's 4096
    T = 256
    hist = rng.integers(0, 4097, (14, T, 4, 256)).astype(np.float32)
    modes = rng.integers(0, 14, T)
    onehot = np.eye(14, dtype=np.float32)[modes]
    got = _on(gpu, chosen_histogram, onehot, hist)
    want = hist.astype(np.int64)[modes, np.arange(T)].sum(axis=0)
    check(np.array_equal(got.astype(np.int64), want), "chosen_histogram")


# ---------------------------------------------------------------------------
# Phase 2: hybrid batch encode
# ---------------------------------------------------------------------------

def _hybrid_core_inputs(images):
    """Planes, segment maps, per-segment quantizers and RD lambdas of a
    batch, prepared as the batch pipeline prepares them."""
    from gowebp_tpu.config import EncoderConfig
    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config_seg, analyze_segments, make_quants,
        quality_to_q, rgb_to_yuv420)

    cfg = EncoderConfig(lossless=False, quality=QUALITY)
    base_q = quality_to_q(cfg.quality)
    ys, us, vs, segs, qss, pens = [], [], [], [], [], []
    for im in images:
        y, u, v = rgb_to_yuv420(im)
        mh, mw = y.shape[0] // 16, y.shape[1] // 16
        seg, deltas = analyze_segments(y, mw, mh, cfg.segments,
                                       cfg.sns_strength, base_q)
        qs = np.array([[s.y1_dc.q, s.y1_ac.q, s.y2_dc.q, s.y2_ac.q,
                        s.uv_dc.q, s.uv_ac.q] for s in
                       (make_quants(max(0, min(127, base_q + d)))
                        for d in deltas)], np.int32)
        _, pen = _i4_config_seg(qs, cfg.method, cfg.partition_limit)
        ys.append(y)
        us.append(u)
        vs.append(v)
        segs.append(np.asarray(seg).reshape(mh, mw))
        qss.append(qs)
        pens.append(pen)
    stack = lambda a: np.stack(a).astype(np.int32)
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    return (stack(ys), stack(us), stack(vs), stack(segs), stack(qss),
            stack(pens)), tables


def hybrid_core_gpu_vs_cpu(images, gpu, cpu) -> None:
    """The production hybrid core on ``gpu`` and on ``cpu``: equal."""
    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    args, tables = _hybrid_core_inputs(images)

    def core(y, u, v, seg, qs, pen):
        return encode_hybrid_core(y, u, v, seg, qs, tables, try_i4=True,
                                  i4_penalty=pen, refine=1, i4_parallel=True,
                                  cold="i16")

    g, tg = _timed(lambda: _on(gpu, core, *args))
    c, tc = _timed(lambda: _on(cpu, core, *args))
    log(f"  hybrid core x{len(images)}: GPU {tg:.1f} s, CPU {tc:.1f} s "
        "(compile included, smoke timing)")
    check(_same_leaves(g, c), "hybrid core GPU != CPU backend")


def hybrid_core_memory(images, device) -> None:
    """Print XLA's memory analysis of the hybrid core compiled for
    ``device`` at this batch size."""
    import jax

    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    args, tables = _hybrid_core_inputs(images)

    def core(y, u, v, seg, qs, pen):
        return encode_hybrid_core(y, u, v, seg, qs, tables, try_i4=True,
                                  i4_penalty=pen, refine=1, i4_parallel=True,
                                  cold="i16")

    compiled, t = _timed(lambda: jax.jit(core).lower(
        *jax.device_put(args, device)).compile())
    ma = compiled.memory_analysis()
    mib = lambda n: f"{n / 2 ** 20:.1f} MiB"
    log(f"  hybrid core B={len(images)} memory_analysis: arguments "
        f"{mib(ma.argument_size_in_bytes)}, outputs "
        f"{mib(ma.output_size_in_bytes)}, temporaries "
        f"{mib(ma.temp_size_in_bytes)}, code "
        f"{mib(ma.generated_code_size_in_bytes)} (compiled in {t:.1f} s)")


def hybrid_batch_encode(images, exact_files, *, Image=None) -> list:
    """encode_rgba_batch(engine="hybrid") on the batch, checked against
    the exact engine's files (``exact_files``) and, with Pillow, libwebp.
    Returns the hybrid files."""
    from gowebp_tpu.decode import decode_rgba_batch
    from gowebp_tpu.encode import encode_rgba_batch

    imgs = list(images)
    mp = len(imgs) * imgs[0].shape[0] * imgs[0].shape[1] / 1e6
    out, cold = _timed(lambda: encode_rgba_batch(imgs, quality=QUALITY,
                                                 engine="hybrid"))
    again, warm = _timed(lambda: encode_rgba_batch(imgs, quality=QUALITY,
                                                   engine="hybrid"))
    log(f"  encode_rgba_batch hybrid x{len(imgs)}: first call {cold:.1f} s "
        f"(compile included), second {warm:.2f} s = {mp / warm:.2f} MP/s "
        "(smoke timing)")
    check(out == again, "hybrid batch encode not deterministic")

    dec = decode_rgba_batch(out, recon_backend="host")
    ref = decode_rgba_batch(exact_files, recon_backend="host")
    for k, (im, h, e) in enumerate(zip(imgs, dec, ref)):
        p_h, p_e = _psnr(h, im), _psnr(e, im)
        check(p_h > p_e - 0.3,
              f"image {k}: hybrid PSNR {p_h:.3f} <= exact {p_e:.3f} - 0.3")
        check(len(out[k]) < 1.12 * len(exact_files[k]),
              f"image {k}: hybrid {len(out[k])} B >= 1.12 x exact "
              f"{len(exact_files[k])} B")
    size_ratio = sum(map(len, out)) / sum(map(len, exact_files))
    log(f"  hybrid vs exact engine: size {size_ratio:.4f}x, PSNR "
        f"{np.mean([_psnr(h, im) for h, im in zip(dec, imgs)]):.3f} vs "
        f"{np.mean([_psnr(e, im) for e, im in zip(ref, imgs)]):.3f} dB")

    if Image is not None:
        lw_sizes, lw_psnr = [], []
        for im in imgs:
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, "WEBP", quality=75, method=4)
            lw_sizes.append(buf.tell())
            lw_psnr.append(_psnr(np.asarray(Image.open(buf).convert("RGB")),
                                 im))
        ratio = sum(map(len, out)) / sum(lw_sizes)
        dpsnr = (np.mean([_psnr(h, im) for h, im in zip(dec, imgs)])
                 - np.mean(lw_psnr))
        log(f"  hybrid vs libwebp q75/m4: size {ratio:.4f}x, "
            f"dPSNR {dpsnr:+.3f} dB")
        check(ratio <= 1.02 and dpsnr >= -0.25,
              f"libwebp window: size {ratio:.4f}x, dPSNR {dpsnr:+.3f} dB")
        for k, (data, h) in enumerate(zip(out, dec)):
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
            check(np.array_equal(pil, h), f"image {k}: libwebp decode != ours")
    return out


# ---------------------------------------------------------------------------
# Phase 3: exact wavefront == host encoder
# ---------------------------------------------------------------------------

def exact_wavefront_encode(image) -> None:
    from gowebp_tpu.config import EncoderConfig
    from gowebp_tpu.encode import encode_rgba

    kw = dict(lossless=False, quality=QUALITY, method=4, segments=4)
    host = encode_rgba(image, config=EncoderConfig(**kw))
    dev, t = _timed(lambda: encode_rgba(
        image, config=EncoderConfig(**kw, plane_backend="jax")))
    log(f"  exact wavefront {image.shape[1]}x{image.shape[0]}: {t:.1f} s "
        "(compile included, smoke timing)")
    check(dev == host, "exact wavefront file != host encoder file")


# ---------------------------------------------------------------------------
# Phase 4: batch decode on the device
# ---------------------------------------------------------------------------

def batch_decode(files, what: str, *, Image=None) -> None:
    """decode_rgba_batch on the device == the host decoder (and libwebp),
    for host pixels and for device-resident pixels."""
    import jax

    from gowebp_tpu.decode import decode_rgba_batch

    host = decode_rgba_batch(files, recon_backend="host")
    dev, cold = _timed(lambda: decode_rgba_batch(files, recon_backend="jax"))
    _, warm = _timed(lambda: decode_rgba_batch(files, recon_backend="jax"))
    mp = sum(h.shape[0] * h.shape[1] for h in host) / 1e6
    log(f"  decode {what} x{len(files)}: first {cold:.1f} s, second "
        f"{warm:.2f} s = {mp / warm:.1f} MP/s (smoke timing)")
    for k, (h, d) in enumerate(zip(host, dev)):
        check(np.array_equal(h, d), f"{what} {k}: device decode != host")
        if Image is not None:
            pil = np.asarray(Image.open(io.BytesIO(files[k])).convert("RGBA"))
            check(np.array_equal(pil, h), f"{what} {k}: libwebp != host")

    resident = decode_rgba_batch(files, recon_backend="jax", device_out=True)
    platform = jax.default_backend()
    for k, r in enumerate(resident):
        check(isinstance(r, jax.Array)
              and {d.platform for d in r.devices()} == {platform},
              f"{what} {k}: device_out result is not on the {platform}")
    for k, (h, r) in enumerate(zip(host, resident)):
        check(np.array_equal(h, np.asarray(r)),
              f"{what} {k}: device_out decode != host")


# ---------------------------------------------------------------------------
# Phase 5: lossless encode with the device predictor chooser
# ---------------------------------------------------------------------------

def lossless_encode(image, *, device_chooser=None) -> None:
    """Lossless encode; the predictor chooser must run on the device and
    the file must decode to the input exactly.  ``device_chooser=None``
    goes through encode_rgba and lets the encoder decide, as a user call
    does; True forces the device chooser (small images)."""
    from gowebp_tpu import decode_rgba, encode_rgba
    from gowebp_tpu.constants import CHUNK_VP8L
    from gowebp_tpu.container.riff import Chunk, assemble_simple
    from gowebp_tpu.models.vp8l.encoder import encode_vp8l
    from gowebp_tpu.stats import EncodeStats

    stats = EncodeStats()
    if device_chooser is None:
        data, t = _timed(lambda: encode_rgba(image, lossless=True,
                                             stats=stats))
    else:
        data, t = _timed(lambda: assemble_simple(Chunk(CHUNK_VP8L, encode_vp8l(
            image, stats=stats, device_chooser=device_chooser))))
    log(f"  lossless {image.shape[1]}x{image.shape[0]}: {t:.1f} s, "
        f"{len(data)} B, predictor chooser on the {stats.predictor_chooser} "
        "(smoke timing)")
    check(stats.predictor_chooser == "device",
          f"predictor chooser ran on the {stats.predictor_chooser!r}")
    back = decode_rgba(data)
    check(np.array_equal(back[..., :3], image[..., :3])
          and bool((back[..., 3] == 255).all()),
          "lossless round trip not exact")


# ---------------------------------------------------------------------------
# Four cards: the sharded paths
# ---------------------------------------------------------------------------

def _distinct_devices(arr, n: int, what: str) -> None:
    devs = {s.device for s in arr.addressable_shards}
    check(len(devs) == n, f"{what}: shards on {len(devs)} devices, not {n}")


def four_card_hybrid(mesh, images, ref_device) -> None:
    """Data-sharded hybrid encode (batch over every card) == one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    args, tables = _hybrid_core_inputs(images)
    kw = dict(try_i4=True, refine=1, i4_parallel=True, cold="i16")
    one = jax.device_put(args, ref_device)
    want, t1 = _timed(lambda: jax.tree.map(np.asarray, encode_hybrid_core(
        *one[:5], tables, i4_penalty=one[5], **kw)))
    sh = NamedSharding(mesh, P(tuple(mesh.axis_names)))
    many = jax.device_put(args, sh)
    n = mesh.devices.size
    _distinct_devices(many[0], n, "hybrid input")
    got, tn = _timed(lambda: encode_hybrid_core(
        *many[:5], tables, i4_penalty=many[5], **kw))
    _distinct_devices(got["y_levels"], n, "hybrid output")
    log(f"  data-sharded hybrid x{len(images)} on {n} cards: {tn:.1f} s, one "
        f"card {t1:.1f} s (compile included, smoke timing)")
    check(_same_leaves(want, got), "data-sharded hybrid != one card")


def four_card_recon(mesh, frames, ref_device) -> None:
    """Tile-sharded recon + loop filter (MB rows over 'tile', frames
    over 'data') == single-card recon_frame."""
    import jax

    from gowebp_tpu.container.riff import parse_riff
    from gowebp_tpu.constants import CHUNK_VP8
    from gowebp_tpu.models.vp8.decoder import (decode_vp8_symbols,
                                               vp8_filter_params)
    from gowebp_tpu.ops.vp8_recon_jax import recon_frame
    from gowebp_tpu.parallel.shard import sharded_recon_frame

    syms = [decode_vp8_symbols(parse_riff(f).find(CHUNK_VP8).payload)
            for f in frames]
    st = syms[0][0]
    check(all((s.mb_w, s.mb_h, s.filter_type) == (st.mb_w, st.mb_h,
                                                  st.filter_type)
              for s, _, _ in syms), "frames differ in shape or filter")
    coeffs = np.stack([c for _, c, _ in syms])
    modes = np.stack([m for _, _, m in syms])
    fps = np.stack([vp8_filter_params(s, m) for s, _, m in syms])
    args = (coeffs, modes[:, :, 0].astype(np.int32),
            modes[:, :, 5:21].astype(np.int32),
            modes[:, :, 1].astype(np.int32), fps)
    kw = dict(mb_w=st.mb_w, mb_h=st.mb_h, filter_type=st.filter_type)
    want, t1 = _timed(lambda: jax.tree.map(np.asarray, recon_frame(
        *jax.device_put(args, ref_device), **kw)))
    got, tn = _timed(lambda: sharded_recon_frame(mesh, *args, **kw))
    n = mesh.devices.size
    _distinct_devices(got[0], n, "tile-sharded recon output")
    log(f"  tile-sharded recon {st.width}x{st.height} x{len(frames)} on {n} "
        f"cards: {tn:.1f} s, one card {t1:.1f} s (compile included, smoke "
        "timing)")
    check(_same_leaves(want, got), "tile-sharded recon != one card")


def four_card_wavefront(mesh, images, ref_device) -> None:
    """Tile-sharded exact wavefront (MB rows over 'tile') == one card."""
    import jax

    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core
    from gowebp_tpu.parallel.shard import sharded_wavefront_encode

    args, tables = _hybrid_core_inputs(images)
    y, u, v, seg, qs, pen = args
    one = jax.device_put(args, ref_device)
    want, t1 = _timed(lambda: jax.tree.map(np.asarray, encode_wavefront_core(
        *one[:5], tables, try_i4=True, i4_penalty=one[5], use_derr=True)))
    got, tn = _timed(lambda: sharded_wavefront_encode(
        mesh, y, u, v, seg, qs, tables, try_i4=True, i4_penalty=pen,
        use_derr=True))
    _distinct_devices(got["y_levels"], mesh.devices.size,
                      "tile-sharded wavefront output")
    log(f"  tile-sharded exact wavefront x{len(images)} "
        f"{y.shape[2]}x{y.shape[1]} on {mesh.devices.size} cards: "
        f"{tn:.1f} s, one card {t1:.1f} s (compile included, smoke timing)")
    check(_same_leaves(want, got), "tile-sharded wavefront != one card")


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _preflight(jax) -> None:
    from gowebp_tpu.entropy import native_loader
    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    log(f"compile cache: {enable_compile_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"device_kind: {jax.devices()[0].device_kind}, "
        f"{len(jax.devices())} device(s)")
    check(native_loader.available(), "native host layer did not build")


def run_one_card(jax) -> None:
    from gowebp_tpu.utils.corpus import natural_images

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    Image = _pil()
    log(f"libwebp checks through Pillow: "
        f"{'on' if Image is not None else 'off (Pillow not installed)'}")

    log("phase 1: integer exactness of the one-hot selects")
    _, t = _timed(lambda: probe_exactness(gpu, cpu))
    log(f"  ok ({t:.1f} s)")

    log(f"phase 2: hybrid batch encode {BATCH} x {SIZE}x{SIZE}")
    imgs, t = _timed(lambda: natural_images(N_DECODE, SIZE, SIZE, seed=7))
    exact_files = _host_encode(imgs)
    log(f"  corpus + host encode of {N_DECODE} images: {t:.1f} s")
    hybrid_files = hybrid_batch_encode(imgs[:BATCH], exact_files[:BATCH],
                                       Image=Image)
    batch_decode(hybrid_files, "hybrid files", Image=Image)
    hybrid_core_gpu_vs_cpu(imgs[:2], gpu, cpu)
    hybrid_core_memory(imgs[:BATCH], gpu)
    log("  ok")

    log("phase 3: exact wavefront encode == host encoder")
    exact_wavefront_encode(imgs[0])
    log("  ok")

    log("phase 4: batch decode on the device == host decoder")
    batch_decode(exact_files, "host-encoded files", Image=Image)
    alpha = np.concatenate([imgs[:4], np.broadcast_to(
        (np.arange(SIZE)[None, :, None] % 255 + 1).astype(np.uint8),
        (4, SIZE, SIZE, 1))], axis=-1)
    batch_decode(_host_encode(alpha), "alpha files", Image=Image)
    odd = natural_images(1, 767, 1023, seed=8)
    batch_decode(_host_encode(odd), "1023x767 file", Image=Image)
    row = natural_images(1, 16, SIZE, seed=9)
    batch_decode(_host_encode(row), f"{SIZE}x16 file (one MB row)",
                 Image=Image)
    if Image is not None:
        lw = []
        for im in imgs[:8]:
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, "WEBP", quality=75, method=4)
            lw.append(buf.getvalue())
        batch_decode(lw, "libwebp files", Image=Image)
    log("  ok")

    log(f"phase 5: lossless encode {SIZE}x{SIZE}")
    lossless_encode(imgs[0])
    log("  ok")


def run_four_cards(jax) -> None:
    from gowebp_tpu.parallel.mesh import make_mesh
    from gowebp_tpu.utils.corpus import natural_images

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    mesh = make_mesh(4)
    log(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    ref = jax.devices()[0]
    imgs = natural_images(BATCH, SIZE, SIZE, seed=7)
    log(f"data-sharded hybrid encode, {BATCH} x {SIZE}x{SIZE}")
    four_card_hybrid(mesh, imgs, ref)
    log("tile-sharded recon, 3840x2160 frames")
    frames = _host_encode(natural_images(mesh.devices.shape[0], 2160, 3840,
                                         seed=10))
    four_card_recon(mesh, frames, ref)
    log(f"tile-sharded exact wavefront, {SIZE}x{SIZE}")
    four_card_wavefront(mesh, imgs[:mesh.devices.shape[0]], ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded paths across four cards")
    args = ap.parse_args(argv)

    # Phases 1-2 compare the GPU with the CPU backend of the same process.
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax

    t0 = time.perf_counter()
    _preflight(jax)
    if args.devices == 4:
        run_four_cards(jax)
    else:
        run_one_card(jax)
    log(f"total {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
