"""Encoder statistics — WebPAuxStats equivalent.

Feature parity target: /root/reference/pkg/libwebp/webp/stats.go:3-39
(coded size, PSNR, block counts, byte breakdown, lossless features).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EncodeStats:
    coded_size: int = 0               # final file size in bytes
    # Lossy:
    psnr: dict = field(default_factory=dict)      # y/u/v/all in dB
    block_count_skipped: int = 0
    block_count_i16: int = 0
    block_count_i4: int = 0
    header_bytes: int = 0             # partition 0 size
    residual_bytes: int = 0           # token partition bytes
    quantizer: int = 0                # base quantizer index
    filter_level: int = 0
    num_partitions: int = 1
    alpha_data_size: int = 0
    # Per-segment arrays (stats.go:13-20 segment_quant/segment_size):
    segment_quant: list = field(default_factory=lambda: [0, 0, 0, 0])
    segment_block_i4: list = field(default_factory=lambda: [0, 0, 0, 0])
    segment_block_i16: list = field(default_factory=lambda: [0, 0, 0, 0])
    segment_block_skipped: list = field(
        default_factory=lambda: [0, 0, 0, 0])
    # Lossless:
    lossless_size: int = 0
    palette_size: int = 0
    cache_bits: int = 0
    transforms: list = field(default_factory=list)   # names applied
    num_huffman_groups: int = 1
    predictor_chooser: str = ""       # "device" or "host" when analysed


__all__ = ["EncodeStats"]
