"""Properties of the device programs that hold on any backend.

- Every float `dot_general` on the device path runs at
  Precision.HIGHEST: the one-hot selects are exact only at full f32
  precision, and a GPU may otherwise run them in TF32.
- The persistent compilation cache sits where JAX_COMPILATION_CACHE_DIR
  says, or at the fixed <repo>/.jax_cache.
- Device errors propagate out of the batch encoder and the VP8L
  predictor chooser instead of turning into a host result.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
from jax import lax

from gowebp_tpu.models.vp8.encoder import (
    _default_cost_tables, _i4_config, make_quants, quality_to_q)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
RNG = np.random.default_rng(7)


def _float_dots(jaxpr):
    """Every dot_general with float operands in a jaxpr, sub-jaxprs of
    pjit/while/cond/scan/custom calls included."""
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "dot_general"
                and jax.numpy.issubdtype(eqn.invars[0].aval.dtype,
                                         jax.numpy.floating)):
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    sub = sub.jaxpr
                if hasattr(sub, "eqns"):
                    yield from _float_dots(sub)


def _encoder_args(B=1, H=32, W=48):
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    y = RNG.integers(0, 256, (B, H, W)).astype(np.int32)
    u = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = RNG.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    seg = np.zeros((B, H // 16, W // 16), np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    _, pen = _i4_config(q.y1_ac.q, 4, 0)
    return (y, u, v, seg, qs, tables), pen


def _prog_zigzag():
    from gowebp_tpu.ops import dct_jax

    x = np.zeros((8, 16), np.int32)
    return jax.make_jaxpr(
        lambda a: dct_jax.zigzag_inv(dct_jax.zigzag_fwd(a)))(x)


def _prog_b4_predictions():
    from gowebp_tpu.ops.vp8_recon_jax import _pred_luma4_all

    return jax.make_jaxpr(_pred_luma4_all)(
        np.zeros((1, 4), np.int32), *[np.zeros((1, 4, 4), np.int32)] * 3)


def _prog_topk_candidates():
    from gowebp_tpu.ops.encode_wavefront_jax import _i4_candidates

    return jax.make_jaxpr(lambda p, s: _i4_candidates(p, s, 4))(
        np.zeros((1, 4, 10, 4, 4), np.int32),
        np.zeros((1, 4, 1, 4, 4), np.int32))


def _prog_parallel_i4_search():
    from gowebp_tpu.ops.encode_wavefront_jax import openloop_mode_search

    args, pen = _encoder_args()
    return jax.make_jaxpr(lambda *a: openloop_mode_search(
        *a, try_i4=True, i4_penalty=pen, i4_parallel=True))(*args)


def _prog_hybrid_core():
    from gowebp_tpu.ops.encode_wavefront_jax import encode_hybrid_core

    args, pen = _encoder_args()
    return jax.make_jaxpr(lambda *a: encode_hybrid_core(
        *a, try_i4=True, i4_penalty=pen, refine=1, i4_parallel=True,
        cold="i16"))(*args)


def _prog_exact_wavefront():
    from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core

    args, pen = _encoder_args()
    return jax.make_jaxpr(lambda *a: encode_wavefront_core(
        *a, try_i4=True, i4_penalty=pen))(*args)


def _prog_recon_frame():
    from gowebp_tpu.ops.vp8_recon_jax import recon_frame

    N = 6
    return jax.make_jaxpr(lambda *a: recon_frame(
        *a, mb_w=3, mb_h=2, filter_type=2))(
        np.zeros((1, N, 24, 16), np.int32), np.zeros((1, N), np.int32),
        np.zeros((1, N, 16), np.int32), np.zeros((1, N), np.int32),
        np.zeros((1, 2, 3, 4), np.int32))


def _prog_vp8l_chooser():
    from gowebp_tpu.ops.lossless_jax import predictor_search_entropy

    return jax.make_jaxpr(lambda a: predictor_search_entropy(a, 2))(
        np.zeros((16, 16), np.uint32))


PROGRAMS = {
    "zigzag": _prog_zigzag,
    "b4_predictions": _prog_b4_predictions,
    "topk_candidates": _prog_topk_candidates,
    "parallel_i4_search": _prog_parallel_i4_search,
    "hybrid_core": _prog_hybrid_core,
    "exact_wavefront": _prog_exact_wavefront,
    "recon_frame": _prog_recon_frame,
    "vp8l_chooser": _prog_vp8l_chooser,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_float_dots_run_at_highest_precision(name):
    dots = list(_float_dots(PROGRAMS[name]().jaxpr))
    assert dots, f"{name}: no float dot_general found (walker broken?)"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == lax.Precision.HIGHEST for p in prec), (name, prec)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from gowebp_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _batch(n=2, h=32, w=32):
    return [RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


def test_batch_encode_propagates_device_errors(monkeypatch):
    import gowebp_tpu.ops.encode_pipeline as pipe
    from gowebp_tpu.encode import encode_rgba_batch

    def oom(*a, **k):
        raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(pipe, "encode_rgba_batch_pipelined", oom)
    with pytest.raises(jax.errors.JaxRuntimeError):
        encode_rgba_batch(_batch())


def test_batch_encode_without_native_layer_encodes_on_host(monkeypatch):
    import gowebp_tpu.entropy.native_loader as nl
    import gowebp_tpu.ops.encode_pipeline as pipe
    from gowebp_tpu.config import EncoderConfig
    from gowebp_tpu.encode import encode_rgba, encode_rgba_batch

    def never(*a, **k):
        raise AssertionError("device pipeline used without native emitter")

    imgs = _batch()
    monkeypatch.setattr(nl, "available", lambda: False)
    monkeypatch.setattr(pipe, "encode_rgba_batch_pipelined", never)
    got = encode_rgba_batch(imgs)
    cfg = EncoderConfig(lossless=False, quality=75.0)
    assert got == [encode_rgba(im, config=cfg) for im in imgs]


def test_vp8l_chooser_propagates_device_errors(monkeypatch):
    import gowebp_tpu.ops.lossless_jax as lj
    from gowebp_tpu.models.vp8l.encoder import _choose_predictors_auto

    def fail(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: compile failed")

    monkeypatch.setattr(lj, "predictor_search_entropy", fail)
    argb = RNG.integers(0, 2 ** 32, (32, 32), dtype=np.uint64).astype(
        np.uint32)
    with pytest.raises(jax.errors.JaxRuntimeError):
        _choose_predictors_auto(argb, 3, 2, device=True)


def test_vp8l_chooser_routing():
    """None decides from the input: small images, or a CPU backend, stay
    on the host; the stats record the side that ran."""
    from gowebp_tpu.models.vp8l.encoder import (_choose_predictors,
                                                _choose_predictors_auto)
    from gowebp_tpu.stats import EncodeStats

    argb = RNG.integers(0, 2 ** 32, (40, 48), dtype=np.uint64).astype(
        np.uint32)
    stats = EncodeStats()
    got = _choose_predictors_auto(argb, 3, 2, stats=stats)
    assert stats.predictor_chooser == "host"
    np.testing.assert_array_equal(got, _choose_predictors(argb, 3, 2))
    _choose_predictors_auto(argb, 3, 2, device=True, stats=stats)
    assert stats.predictor_chooser == "device"


def test_trace_busy_time_is_the_union_of_intervals():
    from bench import _busy_ns

    assert _busy_ns([]) == 0
    assert _busy_ns([(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]) == 27
    assert _busy_ns([(5, 6), (0, 10)]) == 10


def test_trace_summary_without_a_device_plane(tmp_path):
    """A CPU run's trace holds no GPU plane: the summary is None."""
    import jax.numpy as jnp

    from bench import device_trace

    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    assert device_trace(lambda: f(x), str(tmp_path)) is None
