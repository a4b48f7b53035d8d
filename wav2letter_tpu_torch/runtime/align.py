"""Align executor — the port of ``wav2letter_tpu/runtime/align.py`` (the
reference's ``tools/Align`` binary, used by the sota/2019 lm_analysis
segmentation experiment, whose filter/shuffle scripts parse per-word ``begin
length word`` entries with ``$`` silence rows).

Loads an AM checkpoint through ``Evaluator`` (CTC or ASG), forced-aligns each
utterance's transcript to its emissions on the device (``ops/align.py``) and
writes one line per sample: ``audio_path\\t<entries>``, the entries joined by
a literal ``\\n`` (backslash, n) as the JAX package writes them, each
``k k begin_s length_s word``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data import AsrDataset, PrefetchIterator
from ..ops.align import asg_forced_align, ctc_forced_align, path_to_word_segments
from .test import Evaluator


def run_align(cfg: Config, output_path: str, device: str = "cuda") -> int:
    """Writes ``output_path``; returns the number of utterances aligned."""
    ev = Evaluator(cfg, device=device)
    ecfg = ev.cfg
    ds = AsrDataset(ecfg.test, ev.token_dict, ev.lexicon, ecfg, batch_size=ecfg.batchsize)
    blank = None if ev.transitions is not None else ev.n_classes - 1
    sr = ecfg.samplerate
    n = 0
    it = PrefetchIterator(ds, ds.batch_specs(), num_threads=max(1, ecfg.nthread))
    with open(output_path, "w") as out:
        for batch in it:
            em, elen = ev.emissions(batch)
            tgt = torch.from_numpy(np.asarray(batch["target"])).to(em.device)
            tl = torch.from_numpy(np.asarray(batch["target_len"])).to(em.device)
            if ev.transitions is not None:
                path, _ = asg_forced_align(em, ev.transitions, tgt, elen, tl)
            else:
                path, _ = ctc_forced_align(em, tgt, elen, tl, blank=blank)
            path, elen_np = path.cpu().numpy(), elen.cpu().numpy()
            for i in range(path.shape[0]):
                si = int(batch["sample_idx"][i])
                if si < 0:
                    continue
                T_i = int(elen_np[i])
                # seconds per emission frame = audio duration / n frames
                frame_sec = float(batch["audio_len"][i]) / float(sr) / max(1, T_i)
                segs = path_to_word_segments(path[i][:T_i], ev.token_dict, frame_sec,
                                             wordsep=ecfg.wordseparator, blank=blank)
                entries = "\\n".join(
                    f"{k} {k} {b:.3f} {l:.3f} {w}" for k, (b, l, w) in enumerate(segs))
                out.write(f"{ds.samples[si].audio_path}\t{entries}\n")
                n += 1
    print(f"[Align] wrote {n} alignments to {output_path}")
    return n
