"""Quality + loop-amortized device speed of hybrid cold/refine variants.

Usage: python benchmarks/dev_hybrid_variants.py [--smoke]
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variants", default="dense1,i16_1,gs1,i16_2")
    args = ap.parse_args()
    if args.smoke:
        os.environ["JAX_PLATFORMS"] = "cpu"

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    import jax.numpy as jnp
    from jax import lax

    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from PIL import Image

    from bench import make_images, psnr
    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config, make_quants, quality_to_q,
        rgb_to_yuv420)
    from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined
    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    size = 128 if args.smoke else 1024
    nb = 2 if args.smoke else 16
    imgs = make_images(nb, size)
    lst = [imgs[i] for i in range(nb)]
    mp = nb * size * size / 1e6

    lw_sizes, lw_psnr = [], []
    for b in range(nb):
        buf = io.BytesIO()
        Image.fromarray(imgs[b]).save(buf, "WEBP", quality=75, method=4)
        lw_sizes.append(buf.tell())
        lw_psnr.append(psnr(np.asarray(
            Image.open(io.BytesIO(buf.getvalue())).convert("RGB")),
            imgs[b]))

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

    def timed_reps(core_kwargs):
        def runner(k, y_, u_, v_, seg_, qs_, tb0, tb1, tb2):
            def body(i, carry):
                acc, yy = carry
                out = encode_hybrid_core(yy, u_, v_, seg_, qs_,
                                         (tb0, tb1, tb2), try_i4=True,
                                         i4_penalty=pen, **core_kwargs)
                s = out["y_levels"].reshape(-1)[0].astype(jnp.int32)
                return acc + s, y_ + (s & 1)

            acc, _ = lax.fori_loop(0, k, body, (jnp.int32(0), y_))
            return acc

        return jax.jit(runner)

    VAR = {
        "dense1": dict(refine=1, i4_parallel=True, cold="dense"),
        "i16_1": dict(refine=1, i4_parallel=True, cold="i16"),
        "gs1": dict(refine=1, i4_parallel=False, cold="dense"),
        "i16_2": dict(refine=2, i4_parallel=True, cold="i16"),
        "dense1_k4": dict(refine=1, i4_parallel=True, cold="dense",
                          i4_topk=4),
        "i16_1_k4": dict(refine=1, i4_parallel=True, cold="i16",
                         i4_topk=4),
        "gs1_k4": dict(refine=1, i4_parallel=False, cold="dense",
                       i4_topk=4),
        "i16_2_k4": dict(refine=2, i4_parallel=True, cold="i16",
                         i4_topk=4),
    }
    k1, k2 = (1, 2) if args.smoke else (1, 4)
    for name in args.variants.split(","):
        kw = VAR[name]
        r = timed_reps(kw)
        int(np.asarray(r(k1, y, u, v, segb, qsb, *tables)))
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            int(np.asarray(r(k1, y, u, v, segb, qsb, *tables)))
            t1 = time.perf_counter()
            int(np.asarray(r(k2, y, u, v, segb, qsb, *tables)))
            t2 = time.perf_counter()
            best = min(best, ((t2 - t1) - (t1 - t0)) / (k2 - k1))
        # e2e quality through the real pipeline
        outs = encode_rgba_batch_pipelined(
            lst, quality=75.0, threads=8, chunk=nb, engine="hybrid",
            refine=kw["refine"], cold=kw["cold"],
            i4_topk=kw.get("i4_topk"))
        sizes = [len(o) for o in outs]
        psnrs = [psnr(np.asarray(
            Image.open(io.BytesIO(outs[b])).convert("RGB")), imgs[b])
            for b in range(nb)]
        ratio = sum(sizes) / sum(lw_sizes)
        dpsnr = float(np.mean(psnrs)) - float(np.mean(lw_psnr))
        print(f"{name:8s} dev {best * 1e3:7.1f} ms/rep = {mp / best:6.1f} "
              f"MP/s | size x{ratio:.4f} dPSNR {dpsnr:+.3f} dB")


if __name__ == "__main__":
    main()
