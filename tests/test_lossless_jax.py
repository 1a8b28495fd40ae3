"""JAX VP8L transform ops vs NumPy golden references."""

import numpy as np
import jax.numpy as jnp

from gowebp_tpu.models.vp8l import transforms_np as tnp
from gowebp_tpu.ops import lossless_jax as lj

RNG = np.random.default_rng(77)


def rand_argb(h, w):
    return RNG.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32)


class TestElementwise:
    def test_green(self):
        x = rand_argb(16, 23)
        np.testing.assert_array_equal(
            np.asarray(lj.add_green_inverse(jnp.array(x))),
            tnp.add_green_inverse(x),
        )
        np.testing.assert_array_equal(
            np.asarray(lj.subtract_green_forward(jnp.array(x))),
            tnp.subtract_green_forward(x),
        )

    def test_color_transform(self):
        x = rand_argb(19, 31)
        timg = rand_argb(5, 8)
        bits = 2
        np.testing.assert_array_equal(
            np.asarray(lj.color_transform_inverse(jnp.array(x), jnp.array(timg), bits)),
            tnp.color_transform_inverse(x, timg, bits),
        )
        np.testing.assert_array_equal(
            np.asarray(lj.color_transform_forward(jnp.array(x), jnp.array(timg), bits)),
            tnp.color_transform_forward(x, timg, bits),
        )


class TestPredictors:
    def test_predict_plane_matches_encoder(self):
        from gowebp_tpu.models.vp8l import encoder as E

        x = rand_argb(17, 21)
        for mode in range(14):
            ref = E._predict_plane(x, mode)
            got = np.asarray(lj.predict_plane(jnp.array(x), mode))
            np.testing.assert_array_equal(got, ref, err_msg=f"mode {mode}")

    def test_search_and_inverse_roundtrip(self):
        x = rand_argb(33, 29)
        bits = 3
        mode_img, residual = lj.predictor_search(jnp.array(x), bits)
        back = tnp.predictor_inverse(
            np.asarray(residual), np.asarray(mode_img), bits
        )
        np.testing.assert_array_equal(back, x)

    def test_jax_inverse_matches_numpy(self):
        x = rand_argb(25, 18)
        bits = 2
        th = tnp.subsample_size(25, bits)
        tw = tnp.subsample_size(18, bits)
        modes = RNG.integers(0, 14, (th, tw)).astype(np.uint32)
        mode_img = (0xFF000000 | (modes << 8)).astype(np.uint32)
        residual = tnp.predictor_forward(x, mode_img, bits)
        ref = tnp.predictor_inverse(residual, mode_img, bits)
        np.testing.assert_array_equal(ref, x)  # sanity: np fwd/inv agree
        got = np.asarray(
            lj.predictor_inverse(jnp.array(residual), jnp.array(mode_img), bits)
        )
        np.testing.assert_array_equal(got, x)


class TestPredictorEntropySearch:
    """Device entropy chooser == host chooser (modes near-identical,
    output size at parity)."""

    def _image(self, h=160, w=192, seed=2):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        r = (120 + 60 * np.sin(xx / 23) + rng.normal(0, 6, (h, w)))
        g = (100 + 50 * np.cos(yy / 17) + 20 * np.sin((xx + yy) / 31))
        b = (xx // 3 + yy // 5) % 256
        argb = (0xFF000000
                | (np.clip(r, 0, 255).astype(np.uint32) << 16)
                | (np.clip(g, 0, 255).astype(np.uint32) << 8)
                | b.astype(np.uint32))
        return argb.astype(np.uint32)

    def test_modes_agree_with_host_chooser(self):
        from gowebp_tpu.models.vp8l.encoder import _choose_predictors
        from gowebp_tpu.ops.lossless_jax import predictor_search_entropy

        argb = self._image()
        for bits in (4, 5):
            host = _choose_predictors(argb, bits, refine_iters=4)
            host_modes = (host >> 8) & 0xFF
            got = np.asarray(predictor_search_entropy(argb, bits,
                                                      refine_iters=4))
            agree = (got == host_modes).mean()
            assert agree >= 0.95, (
                f"bits={bits}: only {agree:.1%} tile agreement")

    def test_size_parity_when_forced(self):
        import io

        from PIL import Image

        from gowebp_tpu.constants import CHUNK_VP8L
        from gowebp_tpu.container.riff import Chunk, assemble_simple
        from gowebp_tpu.models.vp8l.encoder import encode_vp8l
        from gowebp_tpu.stats import EncodeStats

        rng = np.random.default_rng(5)
        h, w = 144, 176
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = np.clip(130 + 50 * np.sin(xx / 19)
                              + rng.normal(0, 4, (h, w)), 0, 255)
        img[..., 1] = np.clip(110 + 45 * np.cos(yy / 23), 0, 255)
        img[..., 2] = ((xx + 2 * yy) // 4) % 256

        base_stats, forced_stats = EncodeStats(), EncodeStats()
        base = assemble_simple(Chunk(CHUNK_VP8L, encode_vp8l(
            img, quality=75, stats=base_stats)))
        forced = assemble_simple(Chunk(CHUNK_VP8L, encode_vp8l(
            img, quality=75, stats=forced_stats, device_chooser=True)))
        assert base_stats.predictor_chooser == "host"
        assert forced_stats.predictor_chooser == "device"
        # both must round-trip and price within a fraction of a percent
        assert np.array_equal(
            np.asarray(Image.open(io.BytesIO(forced)).convert("RGB")), img)
        assert len(forced) <= 1.005 * len(base), (len(forced), len(base))
