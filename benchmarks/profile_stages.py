"""Per-stage profile of the pipelined batch encoder.

Measures, on the bench config (1024x1024, q75), wall time of each stage
run in isolation:
  yuv      host RGB->YUV420 conversion (native kernel, per image)
  h2d      device_put of the uint8 planes
  device   dense encode + pack (openloop and wavefront engines)
  d2h      fused packed export fetch
  unpack   G4PACKv2 -> dense int16 levels
  tokenize native token_stats pass
  emit     native header+mode+token emission
Also reports raw host<->device bandwidth (h2d/d2h of a flat buffer).

Usage:  python benchmarks/profile_stages.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def t(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from bench import make_images
    from gowebp_tpu.config import EncoderConfig
    from gowebp_tpu.models.vp8.encoder import (
        emit_frame_arrays, make_quants, quality_to_q,
        rgb_to_yuv420 as host_yuv, _native_tokenizer_arrays,
    )
    from gowebp_tpu.ops.encode_pipeline import (
        _plan, planes_packed_step, planes_wavefront_packed_step,
        _export_packed_v2, unpack_g4v2,
    )

    size, B = 1024, 8
    mp = B * size * size / 1e6
    imgs = make_images(B, size)
    config = EncoderConfig(lossless=False, quality=75.0)
    base_q = quality_to_q(75.0)
    q = make_quants(base_q)
    quants = dict(y1_dc=q.y1_dc.q, y1_ac=q.y1_ac.q, y2_dc=q.y2_dc.q,
                  y2_ac=q.y2_ac.q, uv_dc=q.uv_dc.q, uv_ac=q.uv_ac.q)
    plan = _plan(size, size)
    cap_s = plan["n_group_pad"] // 2
    cap_b = plan["n_group_pad"] // 4

    # --- raw host<->device bandwidth ---
    buf = np.zeros(32 << 20, np.uint8)
    d = jax.device_put(buf); jax.block_until_ready(d)
    dt = t(lambda: jax.block_until_ready(jax.device_put(buf)), 3)
    print(f"h2d raw: {32 / dt:.1f} MB/s")
    dt = t(lambda: np.asarray(d), 3)
    print(f"d2h raw: {32 / dt:.1f} MB/s")

    # --- yuv (single thread; pipeline divides by threads) ---
    dt = t(lambda: [host_yuv(imgs[i]) for i in range(B)])
    print(f"yuv host (1 thread): {dt*1000:.0f} ms/chunk -> {mp/dt:.1f} MP/s")

    planes = [host_yuv(imgs[i]) for i in range(B)]
    y = np.stack([p[0] for p in planes]).astype(np.uint8)
    u = np.stack([p[1] for p in planes]).astype(np.uint8)
    v = np.stack([p[2] for p in planes]).astype(np.uint8)

    nbytes = y.nbytes + u.nbytes + v.nbytes
    def h2d():
        return [jax.device_put(a) for a in (y, u, v)]
    r = h2d(); jax.block_until_ready(r)
    dt = t(lambda: jax.block_until_ready(h2d()))
    print(f"h2d planes: {dt*1000:.0f} ms ({nbytes/2**20/dt:.1f} MB/s) "
          f"-> {mp/dt:.1f} MP/s")
    yd, ud, vd = r

    # --- device step (openloop) ---
    out = planes_packed_step(yd, ud, vd, cap_s=cap_s, cap_b=cap_b, **quants)
    jax.block_until_ready(out)
    dt = t(lambda: jax.block_until_ready(
        planes_packed_step(yd, ud, vd, cap_s=cap_s, cap_b=cap_b, **quants)))
    print(f"device openloop: {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")

    # --- d2h packed ---
    ks = kb = 4096
    while ks < int(np.asarray(out["hdr"])[:, 0].max()):
        ks *= 2
    while kb < int(np.asarray(out["hdr"])[:, 1].max()):
        kb *= 2
    ks, kb = min(ks, cap_s), min(kb, cap_b)
    buf2 = _export_packed_v2(out, ks=ks, kb=kb, with_i4=False)
    jax.block_until_ready(buf2)
    nb = np.asarray(buf2).nbytes
    dt = t(lambda: np.asarray(_export_packed_v2(out, ks=ks, kb=kb,
                                                with_i4=False)))
    print(f"d2h packed: {dt*1000:.0f} ms ({nb/2**20:.1f} MB, "
          f"{nb/2**20/dt:.1f} MB/s) -> {mp/dt:.1f} MP/s")

    # --- device step (wavefront, i16-only quick config) ---
    from gowebp_tpu.models.vp8.encoder import (
        I4_LAMBDA_MULT, _default_cost_tables, _i4_penalty_scale)
    tp0, tp1, tval = _default_cost_tables()
    tables = tuple(jnp.asarray(x.astype(np.int32)) for x in (tp0, tp1, tval))
    scale = _i4_penalty_scale(config.partition_limit)
    i4_pen = int(I4_LAMBDA_MULT * q.y1_ac.q * q.y1_ac.q * (scale or 1.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = jax.device_put(np.broadcast_to(row, (B, 4, 6)).copy())
    segm = jax.device_put(np.zeros((B, plan["mb_h"], plan["mb_w"]), np.int32))
    wf = planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=True, i4_penalty=i4_pen)
    jax.block_until_ready(wf)
    dt = t(lambda: jax.block_until_ready(planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=True, i4_penalty=i4_pen)), reps=2)
    print(f"device wavefront(i4): {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")
    wfni = planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=False, i4_penalty=i4_pen)
    jax.block_until_ready(wfni)
    dt = t(lambda: jax.block_until_ready(planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=False, i4_penalty=i4_pen)), reps=2)
    print(f"device wavefront(i16): {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")
    hb = planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=True, i4_penalty=i4_pen, search="open")
    jax.block_until_ready(hb)
    dt = t(lambda: jax.block_until_ready(planes_wavefront_packed_step(
        yd, ud, vd, segm, qs, tables, cap_s=cap_s, cap_b=cap_b,
        try_i4=True, i4_penalty=i4_pen, search="open")), reps=2)
    print(f"device hybrid: {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")

    # --- host unpack + tokenize + emit (per image, single thread) ---
    hdr = np.asarray(out["hdr"])
    buf_np = np.asarray(buf2)
    n_mask = plan["n_group_pad"] // 4
    o = 12
    mask2 = buf_np[:, o:o + n_mask]; o += n_mask
    small = buf_np[:, o:o + ks * 2].reshape(B, ks, 2); o += ks * 2
    big = buf_np[:, o:o + kb * 4].view(np.int8).reshape(B, kb, 4); o += kb * 4
    ymode = buf_np[:, o:o + plan["total"]]; o += plan["total"]
    uvmode = buf_np[:, o:o + plan["total"]]

    def unpack_all():
        return [unpack_g4v2(mask2[j], small[j], big[j], int(hdr[j, 0]),
                            int(hdr[j, 1]), plan) for j in range(B)]
    dense = unpack_all()
    dt = t(unpack_all)
    print(f"unpack (1 thread): {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")

    def tok_all():
        return [_native_tokenizer_arrays(
            dense[j][0], dense[j][1], dense[j][2],
            np.zeros(plan["total"], np.uint8),
            plan["mb_w"], plan["mb_h"]) for j in range(B)]
    toks = tok_all()
    dt = t(tok_all)
    print(f"tokenize/stats (1 thread): {dt*1000:.0f} ms -> {mp/dt:.1f} MP/s")

    def emit_all():
        return [emit_frame_arrays(
            dense[j][0], dense[j][1], dense[j][2],
            np.zeros(plan["total"], np.uint8), ymode[j], uvmode[j],
            plan["mb_w"], plan["mb_h"], size, size, base_q, config)
            for j in range(B)]
    emit_all()
    dt = t(emit_all)
    print(f"full emit incl stats (1 thread): {dt*1000:.0f} ms "
          f"-> {mp/dt:.1f} MP/s")


if __name__ == "__main__":
    main()
