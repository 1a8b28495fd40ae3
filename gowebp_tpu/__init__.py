"""gowebp_tpu — a WebP codec whose dense phases run on an accelerator
through JAX/XLA.

Built from scratch to cover the capability surface of libwebp (as
catalogued from the DaanV2/go-webp reference in SURVEY.md): VP8 lossy,
VP8L lossless, alpha, RIFF container, mux/demux, animation.

Design: dense pixel math (transforms, prediction, filtering, histograms)
runs on the accelerator as JAX programs; sequential entropy coding runs on the
host (Python reference path + native C++ fast path) over tensorized
symbol streams.
"""

from .config import EncoderConfig
from .decode import (
    decode,
    decode_into,
    decode_rgb,
    decode_rgba,
    decode_rgba_batch,
    decode_yuv,
    decode_yuva,
    features,
)
from .decode_options import DecoderConfig
from .encode import encode_rgba, encode_rgba_batch, encode_yuv
from .idec import IncrementalDecoder
from .picture import picture_crop, picture_rescale, picture_view
from .errors import (
    BitstreamError,
    EncodeError,
    InvalidConfig,
    NotEnoughData,
    UnsupportedFeature,
    WebPError,
)

__version__ = "0.1.0"

__all__ = [
    "decode",
    "decode_into",
    "decode_rgba",
    "decode_rgb",
    "decode_yuv",
    "decode_yuva",
    "decode_rgba_batch",
    "encode_rgba",
    "encode_rgba_batch",
    "encode_yuv",
    "features",
    "picture_crop",
    "picture_rescale",
    "picture_view",
    "IncrementalDecoder",
    "EncoderConfig",
    "DecoderConfig",
    "WebPError",
    "BitstreamError",
    "NotEnoughData",
    "UnsupportedFeature",
    "InvalidConfig",
    "EncodeError",
    "__version__",
]
