from .dictionary import (
    Dictionary,
    Lexicon,
    pack_replabels,
    unpack_replabels,
    make_token_dict,
    make_word_dict,
)
from .listfile import ListSample, read_list_file, write_list_file
from .targets import TargetOptions, encode_transcript, tokens_to_words
from .batching import LengthBucketer, make_batches, pad_batch
from .dataset import AsrDataset, PrefetchIterator

__all__ = [
    "Dictionary",
    "Lexicon",
    "pack_replabels",
    "unpack_replabels",
    "make_token_dict",
    "make_word_dict",
    "ListSample",
    "read_list_file",
    "write_list_file",
    "TargetOptions",
    "encode_transcript",
    "tokens_to_words",
    "LengthBucketer",
    "make_batches",
    "pad_batch",
    "AsrDataset",
    "PrefetchIterator",
]
