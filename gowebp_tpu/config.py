"""Encoder configuration: knobs, presets, and validation.

Feature parity target: /root/reference/pkg/config/config.go:8-268
(Config struct, defaults, presets, Validate) — same surface, Python
dataclass idiom.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from .errors import InvalidConfig


class Preset(IntEnum):
    DEFAULT = 0
    PICTURE = 1     # portraits, inner shots
    PHOTO = 2       # outdoor, natural light
    DRAWING = 3     # line drawings, high-contrast details
    ICON = 4        # small colorful images
    TEXT = 5


class ImageHint(IntEnum):
    DEFAULT = 0
    PICTURE = 1
    PHOTO = 2
    GRAPH = 3


@dataclass
class EncoderConfig:
    lossless: bool = False
    quality: float = 75.0          # 0 (smallest) .. 100 (best)
    method: int = 4                # 0 (fastest) .. 6 (slowest/best)
    image_hint: ImageHint = ImageHint.DEFAULT

    target_size: int = 0           # target size in bytes (0 = off)
    target_psnr: float = 0.0       # target PSNR in dB (0 = off)
    segments: int = 4              # 1..4
    sns_strength: int = 50         # spatial noise shaping 0..100
    filter_strength: int = 60      # 0..100
    filter_sharpness: int = 0      # 0..7
    filter_type: int = 1           # 0 = simple, 1 = strong/complex
    autofilter: bool = False
    alpha_compression: int = 1     # 0 = none, 1 = lossless (VP8L)
    alpha_filtering: int = 1       # 0 = none, 1 = fast, 2 = best
    alpha_quality: int = 100       # 0..100
    passes: int = 1                # 1..10 (rate-control passes)
    show_compressed: bool = False
    preprocessing: int = 0         # 1 = segment-smooth, 2 = pseudo-random dither
    partitions: int = 0            # log2(token partitions): 0..3
    partition_limit: int = 0       # 0..100 (quality degradation cap)
    emulate_jpeg_size: bool = False
    thread_level: int = 0
    low_memory: bool = False
    near_lossless: int = 100       # 0..100 (100 = off)
    exact: bool = False            # preserve RGB under transparent pixels
    use_sharp_yuv: bool = False
    qmin: int = 0
    qmax: int = 100
    # Dense-phase backend: "numpy" = host path (C++/NumPy closed loop);
    # "jax" = exact closed-loop device wavefront engine (bit-identical
    # output, batched over the mesh); "jax-openloop" = fully-parallel
    # open-loop engine (maximum throughput, slight quality drift).
    plane_backend: str = "numpy"
    # Optional progress callback: hook(percent:int)->bool; returning False
    # aborts the encode (reference: Picture.progress_hook + USER_ABORT,
    # picture.go:253-265).
    progress_hook: object = None

    def validate(self) -> None:
        checks = [
            (0 <= self.quality <= 100, "quality in [0,100]"),
            (0 <= self.method <= 6, "method in [0,6]"),
            (1 <= self.segments <= 4, "segments in [1,4]"),
            (0 <= self.sns_strength <= 100, "sns_strength in [0,100]"),
            (0 <= self.filter_strength <= 100, "filter_strength in [0,100]"),
            (0 <= self.filter_sharpness <= 7, "filter_sharpness in [0,7]"),
            (0 <= self.filter_type <= 1, "filter_type in [0,1]"),
            (0 <= self.alpha_compression <= 1, "alpha_compression in [0,1]"),
            (0 <= self.alpha_filtering <= 2, "alpha_filtering in [0,2]"),
            (0 <= self.alpha_quality <= 100, "alpha_quality in [0,100]"),
            (1 <= self.passes <= 10, "passes in [1,10]"),
            (0 <= self.preprocessing <= 2, "preprocessing in [0,2]"),
            (0 <= self.partitions <= 3, "partitions in [0,3]"),
            (0 <= self.partition_limit <= 100, "partition_limit in [0,100]"),
            (0 <= self.near_lossless <= 100, "near_lossless in [0,100]"),
            (self.target_size >= 0, "target_size >= 0"),
            (self.target_psnr >= 0, "target_psnr >= 0"),
            (0 <= self.qmin <= self.qmax <= 100, "0 <= qmin <= qmax <= 100"),
        ]
        for ok, msg in checks:
            if not ok:
                raise InvalidConfig(msg)

    @classmethod
    def from_preset(cls, preset: Preset, quality: float = 75.0) -> "EncoderConfig":
        cfg = cls(quality=quality)
        if preset == Preset.PICTURE:
            cfg.image_hint = ImageHint.PICTURE
            cfg.sns_strength = 80
            cfg.filter_sharpness = 4
            cfg.filter_strength = 35
            cfg.preprocessing &= ~2
        elif preset == Preset.PHOTO:
            cfg.image_hint = ImageHint.PHOTO
            cfg.sns_strength = 80
            cfg.filter_sharpness = 3
            cfg.filter_strength = 30
            cfg.preprocessing |= 2
        elif preset == Preset.DRAWING:
            cfg.image_hint = ImageHint.GRAPH
            cfg.sns_strength = 25
            cfg.filter_sharpness = 6
            cfg.filter_strength = 10
        elif preset == Preset.ICON:
            cfg.sns_strength = 25
            cfg.filter_strength = 10
            cfg.preprocessing &= ~2
        elif preset == Preset.TEXT:
            cfg.sns_strength = 0
            cfg.filter_strength = 0
            cfg.preprocessing &= ~2
            cfg.segments = 2
        return cfg


__all__ = ["EncoderConfig", "Preset", "ImageHint"]
