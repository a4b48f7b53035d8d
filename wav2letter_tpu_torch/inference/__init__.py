"""Chunked streaming inference (wav2letter@anywhere): the streaming
featurizer and network, and the checkpoint -> bundle converter."""

from .streaming import StreamingFeaturizer, StreamingNetwork
from .convert import (
    build_streaming_network,
    convert_checkpoint,
    load_streaming_bundle,
)

__all__ = [
    "StreamingFeaturizer",
    "StreamingNetwork",
    "build_streaming_network",
    "convert_checkpoint",
    "load_streaming_bundle",
]
