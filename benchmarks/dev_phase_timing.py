"""Per-phase device timing for the hybrid encoder.

Each phase is wrapped in ONE jitted `lax.fori_loop` with a *traced* rep
count: run k1 and k2 reps of the same executable and take the slope
(t2 - t1) / (k2 - k1), which cancels launch and sync overhead.  The
loop carry perturbs the input by (acc & 1) so XLA cannot hoist the
loop-invariant body, and every run ends in `block_until_ready`.

With --trace, one call of the fixed-mode wavefront (the hybrid's phase
2) is traced with jax.profiler, and the device kernels it ran are
counted per diagonal step.

Usage:  python benchmarks/dev_phase_timing.py [--smoke] [--trace]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="CPU-sized run")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--phases", default="", help="comma list to filter")
    ap.add_argument("--trace", action="store_true",
                    help="count device kernels per wavefront step")
    args = ap.parse_args()
    if args.smoke:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax
    import jax.numpy as jnp
    from jax import lax

    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from bench import device_trace, make_images
    from gowebp_tpu.models.vp8.encoder import (
        _default_cost_tables, _i4_config, make_quants, quality_to_q,
        rgb_to_yuv420)
    from gowebp_tpu.ops.encode_wavefront_jax import (
        encode_hybrid_core, encode_wavefront_core, openloop_mode_search)

    size = 128 if args.smoke else 1024
    nb = 2 if args.smoke else 16
    imgs = make_images(nb, size)
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
    mp = nb * size * size / 1e6

    # recon context for the refine-search variants: one fixed-mode pass
    cold = jax.jit(lambda *a: openloop_mode_search(
        *a, try_i4=True, i4_penalty=pen, i4_parallel=True))(
        y, u, v, segb, qsb, tables)
    modes_t = tuple(cold[k] for k in ("ymode", "uvmode", "is_i4", "imodes"))
    wf1 = encode_wavefront_core(y, u, v, segb, qsb, tables, try_i4=True,
                                i4_penalty=pen, modes=modes_t,
                                want_recon=True)
    ctx = tuple(jax.device_put(np.asarray(wf1[k]))
                for k in ("recon_y", "recon_u", "recon_v"))
    modes_dev = tuple(jax.device_put(np.asarray(m)) for m in modes_t)

    def timed(fn):
        """fn(y, ...) -> pytree.  Returns k-rep jitted runner."""

        def runner(k, y_, u_, v_, seg_, qs_, tb0, tb1, tb2):
            def body(i, carry):
                acc, yy = carry
                out = fn(yy, u_, v_, seg_, qs_, (tb0, tb1, tb2))
                leaf = jax.tree_util.tree_leaves(out)[0]
                s = leaf.reshape(-1)[0].astype(jnp.int32)
                # data-dependent perturbation: defeats loop hoisting,
                # never changes magnitude enough to alter timing
                return acc + s, y_ + (s & 1)

            acc, _ = lax.fori_loop(0, k, body, (jnp.int32(0), y_))
            return acc

        return jax.jit(runner)

    phases = {
        "hybrid_r1_par": lambda yy, u_, v_, s_, q_, tb: encode_hybrid_core(
            yy, u_, v_, s_, q_, tb, try_i4=True, i4_penalty=pen,
            refine=1, i4_parallel=True),
        "search_cold_par": lambda yy, u_, v_, s_, q_, tb: (
            openloop_mode_search(yy, u_, v_, s_, q_, tb, try_i4=True,
                                 i4_penalty=pen, i4_parallel=True)),
        "search_refine_gs": lambda yy, u_, v_, s_, q_, tb: (
            openloop_mode_search(yy, u_, v_, s_, q_, tb, try_i4=True,
                                 i4_penalty=pen, ctx=ctx)),
        "search_refine_par": lambda yy, u_, v_, s_, q_, tb: (
            openloop_mode_search(yy, u_, v_, s_, q_, tb, try_i4=True,
                                 i4_penalty=pen, ctx=ctx,
                                 i4_parallel=True)),
        "search_i16only": lambda yy, u_, v_, s_, q_, tb: (
            openloop_mode_search(yy, u_, v_, s_, q_, tb, try_i4=False)),
        "wf_fixed_recon": lambda yy, u_, v_, s_, q_, tb: (
            encode_wavefront_core(yy, u_, v_, s_, q_, tb, try_i4=True,
                                  i4_penalty=pen, modes=modes_dev,
                                  want_recon=True)),
        "wf_fixed": lambda yy, u_, v_, s_, q_, tb: (
            encode_wavefront_core(yy, u_, v_, s_, q_, tb, try_i4=True,
                                  i4_penalty=pen, modes=modes_dev)),
    }
    if args.phases:
        keep = set(args.phases.split(","))
        phases = {k: v for k, v in phases.items() if k in keep}

    k1, k2 = (1, 2) if args.smoke else (1, args.reps)
    print(f"{'phase':20s} {'ms/rep':>9s} {'MP/s':>8s}  (k1={k1}, k2={k2})")
    results = {}
    for name, fn in phases.items():
        r = timed(fn)
        t_compile0 = time.perf_counter()
        jax.block_until_ready(r(k1, y, u, v, segb, qsb, *tables))
        compile_s = time.perf_counter() - t_compile0
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(r(k1, y, u, v, segb, qsb, *tables))
            t1 = time.perf_counter()
            jax.block_until_ready(r(k2, y, u, v, segb, qsb, *tables))
            t2 = time.perf_counter()
            slope = ((t2 - t1) - (t1 - t0)) / (k2 - k1)
            best = min(best, slope)
        results[name] = best
        print(f"{name:20s} {best * 1e3:9.1f} {mp / best:8.1f}"
              f"   [compile+warm {compile_s:.0f}s]")

    # production structure (cold="i16", refine=1): i16 search, fixed
    # wavefront with recon, Gauss-Seidel refine search, fixed wavefront
    prod = ("search_i16only", "wf_fixed_recon", "search_refine_gs",
            "wf_fixed")
    if set(prod) <= results.keys():
        search = results["search_i16only"] + results["search_refine_gs"]
        wave = results["wf_fixed_recon"] + results["wf_fixed"]
        print(f"\nproduction: mode search {search * 1e3:.1f} ms + "
              f"wavefront {wave * 1e3:.1f} ms = "
              f"{(search + wave) * 1e3:.1f} ms "
              f"({mp / (search + wave):.1f} MP/s)")

    if args.trace:
        import tempfile

        from gowebp_tpu.ops.vp8_recon_jax import num_diagonals

        T = num_diagonals(size // 16, size // 16)

        def wave_once():
            return encode_wavefront_core(y, u, v, segb, qsb, tables,
                                         try_i4=True, i4_penalty=pen,
                                         modes=modes_dev)

        search_jit = jax.jit(
            lambda yy, uu, vv, ss, qq, tb, c: openloop_mode_search(
                yy, uu, vv, ss, qq, tb, try_i4=True, i4_penalty=pen, ctx=c))

        def search_once():
            return search_jit(y, u, v, segb, qsb, tables, ctx)

        for name, fn in (("wf_fixed", wave_once),
                         ("search_refine_gs", search_once)):
            jax.block_until_ready(fn())
            with tempfile.TemporaryDirectory() as td:
                tr = device_trace(fn, td)
            if tr is None:
                print(f"trace {name}: no device plane (CPU run)")
                continue
            per = f", {tr['kernels'] / T:.1f} per diagonal step (T={T})" \
                if name == "wf_fixed" else ""
            print(f"trace {name}: {tr['kernels']} device kernels{per}; "
                  f"busy {tr['device_busy_ms']:.2f} ms of "
                  f"{tr['device_span_ms']:.2f} ms span")
            print(f"  top ops: {tr['top_ops_ms_count']}")
            print(f"  device lines: {tr['device_lines']}")


if __name__ == "__main__":
    main()
