"""Multilingual CTC acoustic model with a language-ID head — the port of
``recipes/mls/mling_plugin.py`` (the reference's ``recipes/mling_pl/
mling_large.cpp``: a transformer AM with an auxiliary LID classifier).

``--arch=recipes/mls/mling_plugin.py`` loads this module in the port
(``models/plugin.py``). Parameters keep the flax names and shapes:
``encoder.seq.*`` as an ``ArchModel`` of ``ENCODER_LINES`` names them,
``ctc_head`` and ``lid_head`` as ``Dense`` (``kernel`` (in, out), ``bias``),
so a JAX checkpoint converts by renaming paths. The heads run in fp32.

The flax plugin ``sow``s the LID logits (masked mean-pool of the encoder
states, then ``lid_head``) into ``intermediates``; here the last forward's
are kept as ``lid_logits``. Neither package trains them (no loss reads them).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from ..criterions.seq2seq import Dense
from ..kernels import KERNELS
from ..models.arch import build_arch_from_lines

N_LANGS = 60
ENC_DIM = 256

ENCODER_LINES = [
    "V -1 1 {nfeat} 0",
    "WN 3 C {nfeat} 512 3 1 -1",
    "GLU 2",
    "DO 0.1",
    "M 1 1 2 1",
    "RO 2 0 3 1",
    "TR 256 1024 4 240 0.1 0.05",
    "TR 256 1024 4 240 0.1 0.05",
    "TR 256 1024 4 240 0.1 0.05",
    "TR 256 1024 4 240 0.1 0.05",
]


class MultilingualAM(nn.Module):
    def __init__(self, n_feat: int, n_label: int, n_langs: int = N_LANGS,
                 ops: SimpleNamespace = KERNELS):
        super().__init__()
        lines = [line.format(nfeat=n_feat) for line in ENCODER_LINES]
        self.encoder = build_arch_from_lines(lines, ENC_DIM, ops=ops)
        self.ctc_head = Dense(ENC_DIM, n_label)
        self.lid_head = Dense(ENC_DIM, n_langs)
        self.lid_logits: Optional[torch.Tensor] = None

    def forward(self, feats: torch.Tensor, feat_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h, hlen = self.encoder(feats, feat_len, generator=generator)
        em = self.ctc_head(h.float())
        t = torch.arange(h.shape[1], device=h.device)[None, :, None]
        m = (t < hlen[:, None, None]).to(h.dtype)
        pooled = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        self.lid_logits = self.lid_head(pooled.float())
        return em, hlen


def create_module(n_feat: int, n_label: int) -> MultilingualAM:
    return MultilingualAM(n_feat, n_label)
