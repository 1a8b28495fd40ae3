"""Headline benchmark: end-to-end batch lossy encode vs libwebp.

Headline metric: **end-to-end lossy encode throughput of the HYBRID
engine** — uint8 RGB pixels in, complete .webp byte strings out —
via `encode_rgba_batch_pipelined(engine="hybrid")`: host YUV +
segmentation (thread pool) → one fused h2d buffer → device parallel
mode search (i16/uv/i4 Gauss-Seidel) + fixed-mode exact closed-loop
wavefront + G4PACKv2 → one fused d2h buffer → host entropy emission
(C++ tokenizer, thread pool).

The hybrid engine owns BOTH the throughput claim and the quality
claim: its PSNR/size vs libwebp on the same images rides in "extra"
and is a GATE — if it leaves the parity window (size ≤1.02x,
PSNR ≥ -0.25 dB) the benchmark prints "quality_ok": false and exits
nonzero.  The libwebp baselines come through Pillow; without Pillow
they are null, the gate is not evaluated, and the decode inputs come
from this codec's own host encoder.

Extras:
  - device_breakdown: the hybrid core's steady-state time (slope of a
    k-rep on-device loop), its per-call time, XLA's cost-analysis
    FLOPs/bytes, and a profiler trace of one call reduced to device
    busy time, kernel count and the top device ops.
  - vp8_decode_mps_host + decode_breakdown: batch decode to host
    pixels (interleaved-engine symbols -> native array-driven recon ->
    fused fancy-upsample C++, no accelerator round trip), the host
    symbol phase timed alone, and decode to device-resident pixels.
  - vp8_e2e_exact_search_mps: the exact in-loop-search wavefront.
    Role: **verification oracle** (bit-identical to the sequential
    host encoder; pins the hybrid engine down) — not a production
    path, and not expected to be fast.
  - vp8l_analysis_ms: the device VP8L predictor-entropy chooser on a
    1 MP image (the host chooser's time alongside).

Every timed device phase ends in `jax.block_until_ready` (or fetches
the bytes it produces).  Every result names the device it ran on.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""

import io
import json
import sys
import time

import numpy as np


def make_images(batch: int, size: int) -> np.ndarray:
    """Benchmark corpus: deterministic natural-statistics images.

    Round 5 switched from sinusoid+noise to the dead-leaves + 1/f
    generator (gowebp_tpu/utils/corpus.py) so every ratio/PSNR claim
    rides photographic statistics.  The libwebp
    baselines are measured on the same images in the same run, so the
    comparison stays apples-to-apples across corpus changes.
    """
    from gowebp_tpu.utils.corpus import natural_images

    return natural_images(batch, size, size, seed=7)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(255.0 ** 2 / np.mean(d * d))


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def libwebp_encode_mps(img: np.ndarray) -> float:
    """Single-core libwebp full-encode megapixels/s (Pillow)."""
    from PIL import Image

    pil = Image.fromarray(img)
    buf = io.BytesIO()
    pil.save(buf, "WEBP", quality=75, method=4)
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        buf = io.BytesIO()
        pil.save(buf, "WEBP", quality=75, method=4)
    dt = time.perf_counter() - t0
    return n * img.shape[0] * img.shape[1] / 1e6 / dt


def libwebp_decode_mps(datas: list, size: int) -> float:
    from PIL import Image

    np.asarray(Image.open(io.BytesIO(datas[0])).convert("RGB"))
    t0 = time.perf_counter()
    for d in datas:
        np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
    dt = time.perf_counter() - t0
    return len(datas) * size * size / 1e6 / dt


def _busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_trace_summary(xplane_path: str, top_n: int = 8):
    """Reduce a jax.profiler trace to device busy time and kernel counts.

    Reads the ``.xplane.pb`` file with ``jax.profiler.ProfileData``.  The
    device planes are the ``/device:GPU:<n>`` planes; their ``Stream``
    lines carry one event per kernel or copy the device ran, so busy time
    is the union of those intervals and ``kernels`` their count.  Top ops
    come from the ``XLA Ops`` line where present, else from the kernel
    names on the stream lines.
    Returns None when the trace holds no device plane (a CPU run).
    """
    import re
    from collections import defaultdict

    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    spans, ops = [], defaultdict(lambda: [0, 0])
    kern = defaultdict(list)
    lines_seen = set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            events = list(line.events)
            if line.name.startswith("Stream"):
                spans.extend((e.start_ns, e.end_ns) for e in events)
                for e in events:
                    kern[re.sub(r"[.\d]+$", "", e.name)].append(
                        e.duration_ns)
            elif line.name == "XLA Ops":
                for e in events:
                    k = re.sub(r"[.\d]+$", "", e.name)
                    ops[k][0] += e.duration_ns
                    ops[k][1] += 1
    if not spans:
        return None
    t0 = min(s for s, _ in spans)
    t1 = max(e for _, e in spans)
    busy = _busy_ns(spans)
    if not ops:              # no XLA Ops line: name ops by their kernels
        ops = {k: [sum(v), len(v)] for k, v in kern.items()}
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {
        "device_busy_ms": busy / 1e6,
        "device_span_ms": (t1 - t0) / 1e6,
        "busy_fraction_of_span": busy / max(t1 - t0, 1),
        "kernels": len(spans),
        "top_ops_ms_count": {k: [v[0] / 1e6, v[1]] for k, v in top},
        "device_lines": sorted(lines_seen),
    }


def device_trace(run_once, trace_dir: str):
    """Trace one already-compiled call of ``run_once`` into ``trace_dir``
    and reduce it (see device_trace_summary)."""
    import glob

    import jax

    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(run_once())
    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    return device_trace_summary(files[-1]) if files else None


def _cost_analysis(fn, *args):
    """XLA's own flops/bytes estimate for a jitted call, or None."""
    try:
        import jax

        compiled = jax.jit(fn).lower(*args).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return {"flops": float(ca.get("flops", 0.0)),
                "bytes": float(ca.get("bytes accessed", 0.0))}
    except Exception:
        return None


def _card() -> str | None:
    """`name, power.limit` of the first GPU as nvidia-smi reports it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main() -> None:
    import os
    import tempfile

    import jax

    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    Image = _pil()

    from gowebp_tpu.decode import decode_rgba, decode_rgba_batch
    from gowebp_tpu.models.vp8.decoder import decode_vp8_symbols_batch
    from gowebp_tpu.container.riff import parse_riff
    from gowebp_tpu.constants import CHUNK_VP8
    from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined

    smoke = os.environ.get("GOWEBP_BENCH_SMOKE") == "1"

    # On-device integer-exactness probe: the one-hot zigzag selects are
    # f32 matmuls, exact only at full precision (a GPU may run them in
    # TF32).  A regression flips the flag in extras.
    def _device_exactness_probe():
        import jax.numpy as jnp

        from gowebp_tpu.ops.dct_jax import zigzag_fwd, zigzag_inv

        x = (np.random.default_rng(0)
             .integers(-(2 ** 19), 2 ** 19, (256, 16)).astype(np.int32))
        got = np.asarray(jax.jit(
            lambda a: zigzag_inv(zigzag_fwd(a)))(jnp.asarray(x)))
        return bool(np.array_equal(got, x))

    device_exact = _device_exactness_probe()
    size, chunk = (128, 4) if smoke else (1024, 32)
    n_e2e = 8 if smoke else 64
    imgs = make_images(n_e2e, size)
    lst = [imgs[i] for i in range(n_e2e)]
    mp = size * size / 1e6

    def best_of(fn, mps_for, reps=2):
        """Max throughput over reps; fn's result is fully materialized."""
        best, out = 0.0, None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            best = max(best, mps_for / (time.perf_counter() - t0))
        return best, out

    def rgb_of(data: bytes) -> np.ndarray:
        return decode_rgba(data)[..., :3]

    # --- libwebp baselines + per-image quality on a subset ---
    nq = 4 if smoke else 8
    n_dec = 8 if smoke else 64   # fills the interleaved decoder's 32 lanes x2
    lw_sizes, lw_psnr = [], []
    if Image is not None:
        enc_base = libwebp_encode_mps(imgs[0])
        datas = []
        for b in range(n_dec):
            buf = io.BytesIO()
            Image.fromarray(imgs[b]).save(buf, "WEBP", quality=75, method=4)
            datas.append(buf.getvalue())
            if b < nq:
                lw_sizes.append(buf.tell())
                lw_psnr.append(psnr(rgb_of(buf.getvalue()), imgs[b]))
    else:
        from gowebp_tpu.config import EncoderConfig
        from gowebp_tpu.encode import encode_rgba

        enc_base = None
        cfg = EncoderConfig(lossless=False, quality=75.0)
        datas = [encode_rgba(imgs[b], config=cfg) for b in range(n_dec)]

    # --- decode: host symbol phase alone (the wall), then full batch
    # decode to host pixels and to device-resident pixels. ---
    payloads = [parse_riff(d).find(CHUNK_VP8).payload for d in datas]
    decode_vp8_symbols_batch(payloads)         # warm (incl. native build)
    sym_1t = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        decode_vp8_symbols_batch(payloads)
        sym_1t = max(sym_1t, n_dec * mp / (time.perf_counter() - t0))
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as pool:
        sym_2t = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            list(pool.map(decode_vp8_symbols_batch,
                          [payloads[0::2], payloads[1::2]]))
            sym_2t = max(sym_2t, n_dec * mp / (time.perf_counter() - t0))

    # Full batch decode to HOST pixels — the apples-to-apples number
    # (libwebp decodes to host memory too): native recon + fused
    # fancy-upsample/YUV→RGBA, no accelerator round trip.  Ours and the
    # libwebp baseline alternate rep by rep, so both bests come from
    # the same host load.
    decode_rgba_batch(datas[:4], recon_backend="host")  # warm
    dec = 0.0
    dec_base = 0.0 if Image is not None else None
    for _ in range(3):
        t0 = time.perf_counter()
        decode_rgba_batch(datas, recon_backend="host", threads=4)
        dec = max(dec, len(datas) * mp / (time.perf_counter() - t0))
        if Image is not None:
            dec_base = max(dec_base, libwebp_decode_mps(datas, size))

    # Decode to DEVICE-resident pixels (sparse int8-level upload,
    # ops/coeff_pack.py), synced with block_until_ready.
    def dec_dev():
        return decode_rgba_batch(datas, device_out=True)

    jax.block_until_ready(dec_dev())  # warm
    dec_dev_mps, _ = best_of(dec_dev, len(datas) * mp, reps=2)

    # packed-upload byte telemetry (same pack the decode path uses)
    from gowebp_tpu.ops.coeff_pack import pack_coeffs, packed_nbytes

    syms = decode_vp8_symbols_batch(payloads[:8])
    cstack = np.stack([s[1] for s in syms])
    mstack = np.stack([s[2] for s in syms])
    qm = np.stack([np.array(
        [[m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac, m.uv_dc, m.uv_ac]
         for m in s[0].dqm], np.int32) for s in syms])
    pk, K, _ = pack_coeffs(cstack, mstack[:, :, 2], mstack[:, :, 0], qm)
    packed_mb_per_mp = round(packed_nbytes(pk) / (8 * mp) / 1e6, 3)
    dense_mb_per_mp = round(cstack.astype(np.int16).nbytes
                            / (8 * mp) / 1e6, 3)

    # Single-image decode (a foreign single-partition file, the case
    # the reference's 2-thread pipeline covers): sequential vs the r5
    # overlapped parse/recon band pipeline (wtpu_vp8_decode_frame_mt).
    from gowebp_tpu.decode import decode_rgba as _dec_one

    single_mps = {}
    for flag, key in (("0", "seq"), ("1", "overlap")):
        os.environ["GOWEBP_DECODE_OVERLAP"] = flag
        _dec_one(datas[0])  # warm
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            for d in datas[:4]:
                _dec_one(d)
            best = max(best, 4 * mp / (time.perf_counter() - t0))
        single_mps[key] = round(best, 1)
    os.environ.pop("GOWEBP_DECODE_OVERLAP", None)

    # VP8L (lossless) batch decode to host pixels vs libwebp 1-core.
    n_ll = 2 if smoke else 8
    ll_datas = []
    for b in range(n_ll):
        if Image is not None:
            buf = io.BytesIO()
            Image.fromarray(imgs[b]).save(buf, "WEBP", lossless=True)
            ll_datas.append(buf.getvalue())
        else:
            from gowebp_tpu.encode import encode_rgba

            ll_datas.append(encode_rgba(imgs[b], lossless=True))
    decode_rgba_batch(ll_datas[:2], recon_backend="host")  # warm
    dec_ll = 0.0
    ll_base = 0.0 if Image is not None else None
    for _ in range(2):                      # alternate: see decode above
        t0 = time.perf_counter()
        decode_rgba_batch(ll_datas, recon_backend="host", threads=4)
        dec_ll = max(dec_ll, n_ll * mp / (time.perf_counter() - t0))
        if Image is not None:
            ll_base = max(ll_base, libwebp_decode_mps(ll_datas, size))

    # --- headline: end-to-end batch encode, HYBRID engine ---
    # (cold="i16" matches the device section's HYBRID_KW: the round-5
    # production configuration)
    encode_rgba_batch_pipelined(lst[:chunk], quality=75.0, threads=8,
                                chunk=chunk, engine="hybrid",
                                cold="i16")  # warm
    timings = {}
    e2e_hybrid, outs = best_of(
        lambda: encode_rgba_batch_pipelined(
            lst, quality=75.0, threads=8, chunk=chunk, depth=3,
            engine="hybrid", timings=timings, cold="i16"),
        n_e2e * mp)
    if Image is not None:
        # re-sampled adjacent to the e2e phase (host load drifts)
        enc_base = max(enc_base, libwebp_encode_mps(imgs[0]))
    hy_sizes = [len(outs[b]) for b in range(nq)]
    hy_psnr = [psnr(rgb_of(outs[b]), imgs[b]) for b in range(nq)]

    # --- quality GATE for the benched engine (needs libwebp) ---
    if Image is not None:
        size_ratio = sum(hy_sizes) / sum(lw_sizes)
        dpsnr = float(np.mean(hy_psnr)) - float(np.mean(lw_psnr))
        quality_ok = bool(size_ratio <= 1.02 and dpsnr >= -0.25)
    else:
        size_ratio = dpsnr = quality_ok = None

    # --- extra: exact in-loop-search engine e2e (verification oracle) ---
    n_wf = 2 if smoke else 16
    encode_rgba_batch_pipelined(lst[:n_wf], quality=75.0, threads=8,
                                chunk=n_wf, engine="wavefront")  # warm
    e2e_exact, _ = best_of(
        lambda: encode_rgba_batch_pipelined(
            lst[:n_wf], quality=75.0, threads=8, chunk=n_wf,
            engine="wavefront"),
        n_wf * mp, reps=1)

    # --- extra: open-loop drift penalty (r2's headline engine) ---
    fast = encode_rgba_batch_pipelined(lst[:nq], quality=75.0, threads=8,
                                       chunk=nq, engine="openloop")
    ol_psnr = [psnr(rgb_of(fast[b]), imgs[b]) for b in range(nq)]

    # --- device-phase throughput: loop-amortized steady state (the
    # slope of a k-rep on-device fori loop, whose carry perturbs the
    # input so XLA cannot hoist the body), the per-call time, and a
    # jax.profiler trace of one call reduced to device busy time and
    # kernel counts. ---
    import jax.numpy as jnp
    from jax import lax

    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config, make_quants, quality_to_q,
        rgb_to_yuv420)
    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    # Production hybrid config: i16-only cold start + one Gauss-Seidel
    # refinement round (the refine round re-decides every i4 mode, so a
    # dense i4 cold search reaches the same fixed point at more cost).
    HYBRID_KW = dict(try_i4=True, refine=1, i4_parallel=True,
                     cold="i16")

    nb = 2 if smoke else 16
    pl = [rgb_to_yuv420(imgs[b]) for b in range(nb)]
    y = jax.device_put(np.stack([p[0] for p in pl]).astype(np.int32))
    u = jax.device_put(np.stack([p[1] for p in pl]).astype(np.int32))
    v = jax.device_put(np.stack([p[2] for p in pl]).astype(np.int32))
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qsb = jax.device_put(np.broadcast_to(row, (nb, 4, 6)).copy())
    segb = jax.device_put(np.zeros((nb, size // 16, size // 16), np.int32))
    tables = tuple(jax.device_put(t.astype(np.int32))
                   for t in _default_cost_tables())
    _, pen = _i4_config(q.y1_ac.q, 4, 0)

    def steady_runner(y_, u_, v_, seg_, qs_):
        def runner(k, y0, u0, v0, s0, q0, tb0, tb1, tb2):
            def body(i, carry):
                acc, yy = carry
                out = encode_hybrid_core(yy, u0, v0, s0, q0,
                                         (tb0, tb1, tb2),
                                         i4_penalty=pen, **HYBRID_KW)
                s = out["y_levels"].reshape(-1)[0].astype(jnp.int32)
                return acc + s, y0 + (s & 1)

            acc, _ = lax.fori_loop(0, k, body, (jnp.int32(0), y0))
            return acc

        r = jax.jit(runner)

        def measure(mp_batch, k2=3, tries=3):
            jax.block_until_ready(r(1, y_, u_, v_, seg_, qs_, *tables))
            best = 1e9
            for _ in range(tries):
                t0 = time.perf_counter()
                jax.block_until_ready(r(1, y_, u_, v_, seg_, qs_, *tables))
                t1 = time.perf_counter()
                jax.block_until_ready(r(k2, y_, u_, v_, seg_, qs_, *tables))
                t2 = time.perf_counter()
                best = min(best, ((t2 - t1) - (t1 - t0)) / (k2 - 1))
            return mp_batch / best

        return measure

    dev_mps = steady_runner(y, u, v, segb, qsb)(nb * mp)

    # per-call number (includes launch and sync)
    def run_dev():
        return encode_hybrid_core(y, u, v, segb, qsb, tables,
                                  i4_penalty=pen, **HYBRID_KW)

    jax.block_until_ready(run_dev())
    dev_mps_call, _ = best_of(run_dev, nb * mp, reps=3)

    # batch-amortization point at B=32
    nb2 = 4 if smoke else 32
    pl2 = [rgb_to_yuv420(imgs[b]) for b in range(nb, nb2)] \
        if nb2 > nb else []
    y2 = jax.device_put(np.stack(
        [p[0] for p in pl] + [p[0] for p in pl2]).astype(np.int32))
    u2 = jax.device_put(np.stack(
        [p[1] for p in pl] + [p[1] for p in pl2]).astype(np.int32))
    v2 = jax.device_put(np.stack(
        [p[2] for p in pl] + [p[2] for p in pl2]).astype(np.int32))
    qsb2 = jax.device_put(np.broadcast_to(row, (nb2, 4, 6)).copy())
    segb2 = jax.device_put(np.zeros((nb2, size // 16, size // 16),
                                    np.int32))
    dev_mps2 = steady_runner(y2, u2, v2, segb2, qsb2)(nb2 * mp)

    breakdown = {
        "hybrid_steady_ms": round(nb * mp / dev_mps * 1000, 1),
        "hybrid_per_call_ms": round(nb * mp / max(dev_mps_call, 1e-9)
                                    * 1000, 1),
    }
    with tempfile.TemporaryDirectory() as td:
        trace = device_trace(run_dev, td)
    if trace:
        breakdown["trace"] = trace
    ca = _cost_analysis(
        lambda *a: encode_hybrid_core(*a, tables, i4_penalty=pen,
                                      **HYBRID_KW),
        y, u, v, segb, qsb)
    if ca:
        dt_total = nb * mp / dev_mps
        # Cost-analysis bytes count fusion-internal traffic, so the GB/s
        # figure is an UPPER BOUND on real device-memory traffic.
        breakdown["xla_flops"] = ca["flops"]
        breakdown["xla_bytes_upper_bound"] = ca["bytes"]
        breakdown["hbm_gbps_upper_bound"] = round(
            ca["bytes"] / dt_total / 1e9, 1)

    # --- extra: device VP8L analysis kernel vs host chooser at 1 MP ---
    from gowebp_tpu.models.vp8l.encoder import _choose_predictors
    from gowebp_tpu.ops.lossless_jax import predictor_search_entropy

    argb = ((0xFF000000
             | (imgs[0][..., 0].astype(np.uint32) << 16)
             | (imgs[0][..., 1].astype(np.uint32) << 8)
             | imgs[0][..., 2]).astype(np.uint32))
    dev_argb = jax.device_put(argb)
    np.asarray(predictor_search_entropy(dev_argb, 4))          # warm
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(predictor_search_entropy(dev_argb, 4))
        best = min(best, time.perf_counter() - t0)
    vp8l_ms = {"device_ms": round(best * 1000, 1)}
    t0 = time.perf_counter()
    _choose_predictors(argb, 4)
    vp8l_ms["host_ms"] = round((time.perf_counter() - t0) * 1000, 1)

    # Host parallelism telemetry: sym_2t/sym_1t ~2.0 when the host gave
    # the run two free cores; ~1.0 means the multi-threaded host figures
    # rode on about one core.
    scaling = round(sym_2t / max(sym_1t, 1e-9), 2)

    rnd = lambda v, n: None if v is None else round(v, n)
    dev0 = jax.devices()[0]
    result = {
        "metric": "vp8_e2e_encode_throughput_hybrid",
        "value": round(e2e_hybrid, 2),
        "unit": "megapixels/s",
        "vs_baseline": (None if enc_base is None
                        else round(e2e_hybrid / enc_base, 2)),
        "extra": {
            "device": {"platform": dev0.platform,
                       "kind": dev0.device_kind,
                       "count": len(jax.devices())},
            "card": _card(),
            "host_cores": os.cpu_count(),
            "device_integer_exactness_ok": device_exact,
            "host_parallel_scaling_2t": scaling,
            "libwebp_encode_mps_1core": rnd(enc_base, 2),
            "hybrid_psnr_db": round(float(np.mean(hy_psnr)), 3),
            "libwebp_psnr_db": (round(float(np.mean(lw_psnr)), 3)
                                if lw_psnr else None),
            "hybrid_size_ratio_vs_libwebp": rnd(size_ratio, 4),
            "quality_ok": quality_ok,
            "openloop_psnr_db": round(float(np.mean(ol_psnr)), 3),
            "vp8_e2e_exact_search_mps": round(e2e_exact, 2),
            "exact_engine_role": "verification oracle",
            "vp8_hybrid_device_mps": round(dev_mps, 2),
            "vp8_hybrid_device_mps_per_call": round(dev_mps_call, 2),
            "vp8_hybrid_device_mps_b32": round(dev_mps2, 2),
            "device_breakdown": breakdown,
            "vp8_decode_mps_host": round(dec, 2),   # 4 threads
            "libwebp_decode_mps_1core": rnd(dec_base, 2),
            "decode_vs_baseline": (None if dec_base is None
                                   else round(dec / dec_base, 2)),
            "decode_breakdown": {
                "symbols_host_1t_mps": round(sym_1t, 1),
                "symbols_host_2t_mps": round(sym_2t, 1),
                "vp8l_host_mps": round(dec_ll, 2),
                "vp8l_libwebp_mps_1core": rnd(ll_base, 2),
                "to_device_mps": round(dec_dev_mps, 2),
                "upload_mb_per_mp_packed": packed_mb_per_mp,
                "upload_mb_per_mp_dense": dense_mb_per_mp,
                "single_image_host_mps": single_mps,
            },
            "vp8l_analysis_ms": vp8l_ms,
            "stage_seconds": {k: round(v, 2) for k, v in timings.items()},
        },
    }
    print(json.dumps(result))
    if quality_ok is False:
        print(f"QUALITY GATE FAILED: size_ratio={size_ratio:.4f} "
              f"dPSNR={dpsnr:.3f}", file=sys.stderr)
        # Smoke mode is a plumbing check on a 128px corpus where the
        # size ratio is dominated by per-file header effects; the gate
        # binds (exits nonzero) on the full-size run only.
        if not smoke:
            sys.exit(1)


if __name__ == "__main__":
    main()
