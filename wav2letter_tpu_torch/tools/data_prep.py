"""Dataset preparation: corpus directory trees -> ``.lst`` + tokens + lexicon.

The port's copy of ``wav2letter_tpu/tools/data_prep.py``, with the same
functions and outputs; where that imports its package it imports the port's
``data/listfile.py`` and ``data/audio.py``.

Covers the reference's data layer (SURVEY.md §2.5): LibriSpeech
(``data/librispeech/prepare.py``), TIMIT, WSJ, MLS, AMI, Fisher,
Switchboard, plus the recipe-level char-token/letter-lexicon generation
(``recipes/conv_glu/librispeech/prepare.py:61-84``).

Output formats (SURVEY.md Appendix B):
  * ``.lst``:   ``sample_id  abs_path  duration_ms  transcript`` per line,
    ids prefixed with the split name (``data/librispeech/prepare.py:121``).
  * tokens:     one per line (``|``, ``'``, a-z for letter systems).
  * lexicon:    ``word \t t o k e n s |`` (one or more spellings per word).

Audio downloads are the user's responsibility; these functions operate on
extracted corpus trees.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import wave
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..data.listfile import ListSample, write_list_file


def audio_duration_ms(path: str, default_sr: int = 16000) -> float:
    """Duration from the container header (wav native; flac via STREAMINFO)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        with wave.open(path, "rb") as w:
            return 1000.0 * w.getnframes() / w.getframerate()
    if ext == ".flac":
        with open(path, "rb") as f:
            if f.read(4) != b"fLaC":
                raise ValueError(f"{path}: not a flac file")
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                last = hdr[0] & 0x80
                btype = hdr[0] & 0x7F
                size = int.from_bytes(hdr[1:4], "big")
                data = f.read(size)
                if btype == 0:  # STREAMINFO
                    sr = (int.from_bytes(data[10:13], "big") >> 4) & 0xFFFFF
                    total = (
                        (data[13] & 0x0F) << 32
                    ) | int.from_bytes(data[14:18], "big")
                    return 1000.0 * total / sr
                if last:
                    break
        raise ValueError(f"{path}: no STREAMINFO")
    if ext == ".npy":
        import numpy as np

        return 1000.0 * len(np.load(path, mmap_mode="r")) / default_sr
    raise ValueError(f"unsupported audio file: {path}")


def normalize_transcript(text: str) -> str:
    return " ".join(text.strip().lower().split())


# ---------------------------------------------------------------------------
# LibriSpeech / MLS (flac + per-chapter .txt transcript files)
# ---------------------------------------------------------------------------
def prepare_librispeech_split(corpus_dir: str, split: str, out_lst: str) -> int:
    """``corpus_dir/<split>/<spk>/<chap>/<spk>-<chap>.trans.txt`` + flacs ->
    .lst with ids ``<split>-<utt_id>`` (reference utils.py:36-46)."""
    samples: List[ListSample] = []
    split_dir = os.path.join(corpus_dir, split)
    for trans in sorted(
        glob.glob(os.path.join(split_dir, "*", "*", "*.trans.txt"))
    ) + sorted(glob.glob(os.path.join(split_dir, "*", "*.trans.txt"))):
        base = os.path.dirname(trans)
        with open(trans) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                uid, text = line.split(" ", 1)
                apath = os.path.join(base, uid + ".flac")
                if not os.path.exists(apath):
                    for ext in (".wav", ".npy"):
                        if os.path.exists(os.path.join(base, uid + ext)):
                            apath = os.path.join(base, uid + ext)
                            break
                dur = audio_duration_ms(apath)
                samples.append(
                    ListSample(f"{split}-{uid}", os.path.abspath(apath), dur,
                               normalize_transcript(text))
                )
    write_list_file(out_lst, samples)
    return len(samples)


def prepare_mls_split(corpus_dir: str, lang: str, split: str, out_lst: str) -> int:
    """MLS layout: ``<lang>/<split>/transcripts.txt`` (utt \t text) + audio
    under ``audio/<spk>/<book>/<utt>.flac`` (reference data/mls/prepare.py)."""
    samples = []
    base = os.path.join(corpus_dir, lang, split)
    with open(os.path.join(base, "transcripts.txt")) as f:
        for line in f:
            uid, text = line.rstrip("\n").split("\t", 1)
            spk, book, _ = uid.split("_", 2)
            apath = None
            for ext in (".flac", ".wav", ".npy"):
                p = os.path.join(base, "audio", spk, book, uid + ext)
                if os.path.exists(p):
                    apath = p
                    break
            if apath is None:
                continue
            dur = audio_duration_ms(apath)
            samples.append(
                ListSample(f"{split}-{uid}", os.path.abspath(apath), dur,
                           normalize_transcript(text))
            )
    write_list_file(out_lst, samples)
    return len(samples)


# ---------------------------------------------------------------------------
# TIMIT (61->39 phone folding; reference data/timit/prepare.py)
# ---------------------------------------------------------------------------
PHONE_MAP_61_39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n", "eng": "ng",
    "zh": "sh", "ux": "uw", "pcl": "h#", "tcl": "h#", "kcl": "h#",
    "bcl": "h#", "dcl": "h#", "gcl": "h#", "pau": "h#", "epi": "h#",
    "q": "",
}


def fold_phones(phones: Sequence[str]) -> List[str]:
    out = []
    for p in phones:
        p = PHONE_MAP_61_39.get(p, p)
        if p:
            out.append(p)
    return out


def prepare_timit_split(corpus_dir: str, split: str, out_lst: str,
                        fold: bool = True) -> int:
    """TIMIT tree: ``<split>/<dr>/<spk>/<utt>.{wav,phn}``."""
    samples = []
    for phn in sorted(
        glob.glob(os.path.join(corpus_dir, split, "*", "*", "*.phn"))
        + glob.glob(os.path.join(corpus_dir, split.upper(), "*", "*", "*.PHN"))
    ):
        base = os.path.splitext(phn)[0]
        apath = None
        for ext in (".wav", ".WAV", ".npy"):
            if os.path.exists(base + ext):
                apath = base + ext
                break
        if apath is None:
            continue
        phones = []
        with open(phn) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    phones.append(parts[2].lower())
        if fold:
            phones = fold_phones(phones)
        spk = os.path.basename(os.path.dirname(base))
        uid = f"{split}-{spk}-{os.path.basename(base)}"
        dur = audio_duration_ms(apath)
        samples.append(
            ListSample(uid, os.path.abspath(apath), dur, " ".join(phones))
        )
    write_list_file(out_lst, samples)
    return len(samples)


# ---------------------------------------------------------------------------
# WSJ (ndx file lists + .dot transcripts; reference data/wsj/utils.py)
# ---------------------------------------------------------------------------
_WSJ_NOISE = re.compile(r"\[[^\]]*\]|<[^>]*>")


def wsj_normalize_word(w: str) -> str:
    """Word normalization (reference utils.py:16): drop noise markers,
    verbalized punctuation, and non-lexical tokens."""
    w = w.lower()
    if w in (".", "~", "--dash--"):
        return ""
    if w.startswith("*") or w.startswith("%") or w.startswith("~"):
        return ""
    w = _WSJ_NOISE.sub("", w)
    w = w.replace("\\", "")
    if w.startswith("(") and w.endswith(")"):
        return ""
    w = re.sub(r"^\(([^)]*)\)$", r"\1", w)
    w = w.replace(":", "").replace(";", "").replace("!", "")
    return w


def parse_wsj_dot_file(path: str) -> Dict[str, str]:
    """``.dot`` transcript: ``text words (utt_id)`` lines (utils.py:73)."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"^(.*)\((\S+)\)\s*$", line.strip())
            if not m:
                continue
            text, uid = m.group(1), m.group(2)
            words = [wsj_normalize_word(w) for w in text.split()]
            out[uid.lower()] = " ".join(w for w in words if w)
    return out


def parse_wsj_ndx(path: str) -> List[str]:
    """``.ndx`` index file: ``disk:path`` entries (``data/wsj/utils.py:73``);
    returns corpus-relative audio paths, comments/``;``-lines skipped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            # "11_2_1:wsj0/si_tr_s/01v/01vc0207.wv1" or plain path
            rel = line.split(":", 1)[1] if ":" in line else line
            rel = rel.strip().lstrip("/")
            out.append(rel)
    return out


def prepare_wsj_split(
    corpus_dir: str, ndx_path: str, split: str, out_lst: str,
    audio_ext: str = ".wav",
) -> int:
    """Full WSJ prep: ndx index -> audio paths; transcripts from the ``.dot``
    files next to the audio (one per speaker-session)."""
    rels = parse_wsj_ndx(ndx_path)
    transcripts: Dict[str, str] = {}
    audio: Dict[str, str] = {}
    dot_dirs = set()
    for rel in rels:
        base = os.path.splitext(rel)[0]
        uid = os.path.basename(base)
        apath = os.path.join(corpus_dir, base + audio_ext)
        if not os.path.exists(apath):
            for ext in (".wav", ".wv1", ".npy"):
                if os.path.exists(os.path.join(corpus_dir, base + ext)):
                    apath = os.path.join(corpus_dir, base + ext)
                    break
        if os.path.exists(apath):
            audio[uid] = apath
            dot_dirs.add(os.path.dirname(apath))
    for d in dot_dirs:
        for dot in glob.glob(os.path.join(d, "*.dot")):
            transcripts.update(parse_wsj_dot_file(dot))
    return prepare_wsj_from_lists(audio, transcripts, split, out_lst)


def prepare_wsj_from_lists(
    audio_files: Dict[str, str], transcripts: Dict[str, str], split: str,
    out_lst: str,
) -> int:
    samples = []
    for uid, apath in sorted(audio_files.items()):
        text = transcripts.get(uid.lower())
        if text is None:
            continue
        dur = audio_duration_ms(apath)
        samples.append(ListSample(f"{split}-{uid}", os.path.abspath(apath), dur, text))
    write_list_file(out_lst, samples)
    return len(samples)


# ---------------------------------------------------------------------------
# AMI (XML word annotations -> segments; reference data/ami/* incl.
# ami_split_segments.pl / ami_xml2text.sh)
# ---------------------------------------------------------------------------
def parse_ami_words_xml(path: str) -> List[Tuple[float, float, str]]:
    """``<w starttime=.. endtime=..>word</w>`` entries -> (start, end, word)."""
    import xml.etree.ElementTree as ET

    out = []
    root = ET.parse(path).getroot()
    for w in root.iter():
        if not w.tag.endswith("w"):
            continue
        st, en = w.get("starttime"), w.get("endtime")
        if st is None or en is None or not (w.text or "").strip():
            continue
        out.append((float(st), float(en), w.text.strip().lower()))
    return sorted(out)


def ami_split_segments(
    words: List[Tuple[float, float, str]],
    max_gap_s: float = 0.5,
    max_len_s: float = 30.0,
) -> List[Tuple[float, float, List[str]]]:
    """Group word timings into utterance segments at pauses (the reference's
    perl segmenter's behavior: break on silence gaps / length cap)."""
    segs = []
    cur: List[Tuple[float, float, str]] = []
    for w in words:
        if cur and (
            w[0] - cur[-1][1] > max_gap_s or w[1] - cur[0][0] > max_len_s
        ):
            segs.append((cur[0][0], cur[-1][1], [x[2] for x in cur]))
            cur = []
        cur.append(w)
    if cur:
        segs.append((cur[0][0], cur[-1][1], [x[2] for x in cur]))
    return segs


def prepare_ami_meeting(
    words_xml: str, audio_path: str, meeting_id: str, out_dir: str,
) -> List[ListSample]:
    """Segment one AMI meeting: slices audio per segment into ``out_dir`` and
    returns the list samples."""
    import numpy as np

    from ..data.audio import load_audio

    words = parse_ami_words_xml(words_xml)
    segs = ami_split_segments(words)
    audio = load_audio(audio_path, expected_sr=0)
    sr = 16000
    os.makedirs(out_dir, exist_ok=True)
    samples = []
    for i, (st, en, ws) in enumerate(segs):
        clip = audio[int(st * sr) : int(en * sr)]
        if len(clip) == 0:
            continue
        p = os.path.join(out_dir, f"{meeting_id}_{i:04d}.npy")
        np.save(p, clip.astype(np.float32))
        samples.append(
            ListSample(
                f"ami-{meeting_id}-{i:04d}", os.path.abspath(p),
                1000.0 * len(clip) / sr, " ".join(ws),
            )
        )
    return samples


# ---------------------------------------------------------------------------
# Fisher / Switchboard (conversational; reference recipes/data/{fisher,
# switchboard}/prepare.py + word maps)
# ---------------------------------------------------------------------------
_SWBD_MAP = {
    "[laughter]": "", "[noise]": "", "[vocalized-noise]": "",
    "[silence]": "", "uh-huh": "uh-huh", "um-hum": "um-hum",
}


def swbd_normalize_word(w: str) -> str:
    """Switchboard word normalization (reference word maps): strip partial-
    word markers, bracketed noises, and alternate-pronunciation suffixes."""
    w = w.lower().strip()
    if w in _SWBD_MAP:
        return _SWBD_MAP[w]
    # laughter-prefixed words: [laughter-word] -> word (before bracket rule)
    m = re.match(r"^\[laughter-(.+)\]$", w)
    if m:
        w = m.group(1)
    elif w.startswith("[") and w.endswith("]"):
        return ""
    if w.startswith("<") and w.endswith(">"):
        return ""
    # alternate pronunciation: word_1 -> word
    w = re.sub(r"_\d+$", "", w)
    # partial words: w[ord]- / -[wo]rd stay partial markers -> strip brackets
    w = w.replace("[", "").replace("]", "")
    w = w.replace("{", "").replace("}", "")
    return w


def parse_swbd_transcript(path: str) -> List[Tuple[str, float, float, str]]:
    """``sw2001A-ms98-a-trans.text`` lines: ``utt_id start end text``."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split(None, 3)
            if len(parts) < 4:
                continue
            uid, st, en, text = parts
            words = [swbd_normalize_word(w) for w in text.split()]
            words = [w for w in words if w]
            if words:
                out.append((uid, float(st), float(en), " ".join(words)))
    return out


def parse_fisher_transcript(path: str) -> List[Tuple[float, float, str, str]]:
    """Fisher ``.txt``: ``start end channel: text`` lines (# comments)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"^([\d.]+)\s+([\d.]+)\s+([AB]):\s*(.*)$", line)
            if not m:
                continue
            st, en, ch, text = m.groups()
            words = [swbd_normalize_word(w) for w in text.split()]
            words = [w for w in words if w]
            if words:
                out.append((float(st), float(en), ch, " ".join(words)))
    return out


# ---------------------------------------------------------------------------
# token/lexicon generation (recipe-level prep)
# ---------------------------------------------------------------------------
def make_letter_tokens(out_path: str, extra: Sequence[str] = ("'",)) -> List[str]:
    """Char token set ``| ' a-z`` (conv_glu prepare.py:61-66)."""
    toks = ["|"] + list(extra) + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    with open(out_path, "w") as f:
        f.write("\n".join(toks) + "\n")
    return toks


def make_letter_lexicon(
    lst_files: Sequence[str], out_path: str, word_separator: str = "|"
) -> int:
    """Letter lexicon from transcripts: ``word \t w o r d |``
    (conv_glu prepare.py:79-84)."""
    from ..data.listfile import read_list_file

    words = set()
    for lst in lst_files:
        for s in read_list_file(lst):
            words.update(s.words)
    with open(out_path, "w") as f:
        for w in sorted(words):
            spelled = " ".join(list(w) + [word_separator])
            f.write(f"{w}\t{spelled}\n")
    return len(words)


def make_token_lexicon_from_corpus(
    lst_files: Sequence[str], tokens_out: str, lexicon_out: str
) -> Tuple[List[str], int]:
    """Derive the observed token set + letter lexicon from list files
    (used by recipes on corpora with non a-z alphabets)."""
    from ..data.listfile import read_list_file

    chars = set()
    words = set()
    for lst in lst_files:
        for s in read_list_file(lst):
            for w in s.words:
                words.add(w)
                chars.update(w)
    toks = ["|"] + sorted(chars)
    with open(tokens_out, "w") as f:
        f.write("\n".join(toks) + "\n")
    with open(lexicon_out, "w") as f:
        for w in sorted(words):
            f.write(f"{w}\t{' '.join(list(w))} |\n")
    return toks, len(words)


# ---------------------------------------------------------------------------
# CommonVoice / VoxPopuli (joint_training_vox_populi/prepare_data/*.py)
# ---------------------------------------------------------------------------

# punctuation stripped from CommonVoice sentences
# (common_voice_to_wav2letter.py:17-18)
CV_PUNCTUATION = (
    "!\"#$%&()*+,./:;<=>?@[\\]^_`{|}~" + "¡¿"  # string.punctuation sans ' -
    + "–…»“«·—’”„"
)
# characters mapped before tokenization (get_tokens.py REPLACE_SET)
CV_REPLACE = {"–": "-", "`": "'", "’": "'"}


def cv_norm_text(
    text: str,
    char_set: Optional[Iterable[str]] = None,
    replace_set: Optional[Dict[str, str]] = None,
    del_set: str = CV_PUNCTUATION,
) -> Tuple[str, bool]:
    """Normalize a CommonVoice sentence (norm_text,
    common_voice_to_wav2letter.py:59-81): lowercase, apply replacements,
    delete punctuation; invalid if any remaining char is outside
    ``char_set``."""
    text = text.lower()
    for c, v in (replace_set or {}).items():
        text = text.replace(c, v)
    for c in del_set or "":
        text = text.replace(c, "")
    valid = True
    if char_set is not None:
        cs = set(char_set)
        valid = all(c in cs for c in text.replace(" ", ""))
    return text, valid


def read_commonvoice_tsv(path_tsv: str) -> List[Dict[str, str]]:
    """CommonVoice ``.tsv`` rows -> [{speaker_id, local_path, text}]
    (get_base_data_from_csv, common_voice_to_wav2letter.py:47-57)."""
    import csv

    out = []
    with open(path_tsv, encoding="utf-8") as f:
        for row in csv.DictReader(f, dialect="excel-tab"):
            out.append({
                "speaker_id": row["client_id"],
                "local_path": row["path"],
                "text": row["sentence"],
            })
    return out


def convert_to_w2l_audio(in_path: str, out_path: str, target_sr: int = 16000):
    """Mono 16 kHz conversion (to_wav2letterFormat,
    common_voice_to_wav2letter.py:32-45): mean-downmix, polyphase
    resample, clamp to [-1, 1]. Writes 16-bit WAV (sox-free; the
    reference emits FLAC via torchaudio)."""
    import numpy as np

    from ..data.audio import load_audio_with_sr

    sr, data = load_audio_with_sr(in_path)
    if sr != target_sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(sr), int(target_sr))
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    data = np.clip(data, -1.0, 1.0)
    from scipy.io import wavfile

    wavfile.write(out_path, target_sr, (data * 32767.0).astype(np.int16))


def prepare_commonvoice_split(
    path_tsv: str,
    audio_dir: str,
    out_lst: str,
    tokens: Optional[Sequence[str]] = None,
    filter_ids: Optional[Iterable[str]] = None,
    convert_dir: Optional[str] = None,
    file_extension: Optional[str] = None,
) -> int:
    """CommonVoice TSV + clips dir -> ``.lst``
    (common_voice_to_wav2letter.py main flow :178-199): normalize text
    against the token set, optionally keep only ``filter_ids``, optionally
    convert audio to mono-16k into ``convert_dir``. Returns #utterances."""
    rows = read_commonvoice_tsv(path_tsv)
    keep = set(filter_ids) if filter_ids is not None else None
    samples = []
    for r in rows:
        p = os.path.join(audio_dir, r["local_path"])
        if file_extension:
            p = os.path.splitext(p)[0] + file_extension
        if not os.path.isfile(p):
            continue
        sid = os.path.splitext(os.path.basename(p))[0]
        if keep is not None and sid not in keep:
            continue
        text, valid = cv_norm_text(r["text"], char_set=tokens,
                                   replace_set=CV_REPLACE)
        if tokens is not None and not valid:
            continue
        if convert_dir:
            os.makedirs(convert_dir, exist_ok=True)
            outp = os.path.join(convert_dir, sid + ".wav")
            convert_to_w2l_audio(p, outp)
            p = outp
        samples.append(ListSample(sid, os.path.abspath(p),
                                  audio_duration_ms(p), text))
    write_list_file(out_lst, samples)
    return len(samples)


def make_grapheme_tokens(
    texts: Iterable[str], out_path: str, eow_token: str = "|"
) -> List[str]:
    """Grapheme token inventory from raw sentences (get_tokens.py:36-44):
    lowercase, apply CV_REPLACE, drop punctuation/digits, one char per
    line + the end-of-word token."""
    chars: set = set()
    for t in texts:
        t, _ = cv_norm_text(t, replace_set=CV_REPLACE, del_set="")
        chars.update(t.replace(" ", ""))
    remove = set(CV_PUNCTUATION + "…»" + "1234567890–")
    toks = sorted(chars - remove)
    with open(out_path, "w") as f:
        for t in toks:
            f.write(t + "\n")
        f.write(eow_token + "\n")
    return toks + [eow_token]


def lexicon_from_lst(
    input_path: str,
    tokens_path: str,
    out_path: str,
    n_best: int = 10000,
    min_occ: int = 0,
    eow_token: str = "|",
    old_lexicon: Optional[str] = None,
    raw_text: bool = False,
) -> int:
    """Frequency-ranked grapheme lexicon from a ``.lst`` (or raw-text)
    file (make_lexicon.py:93-110): keep the ``n_best`` most frequent
    words with >= ``min_occ`` occurrences whose chars are all in the
    token set; spell ``word -> c h a r s |``. Merges ``old_lexicon``
    words if given. Returns #entries written."""
    with open(tokens_path) as f:
        toks = {x.strip() for x in f if x.strip() and x.strip() != eow_token}
    counts: Dict[str, int] = {}
    with open(input_path) as f:
        for line in f:
            words = line.split() if raw_text else line.split()[3:]
            for w in words:
                counts[w] = counts.get(w, 0) + 1
    ranked = sorted(
        ((w, c) for w, c in counts.items() if c >= min_occ),
        key=lambda x: x[1], reverse=True,
    )
    words = {w for w, _ in ranked[:n_best]}
    if old_lexicon:
        with open(old_lexicon) as f:
            words |= {line.split()[0] for line in f if line.strip()}
    n = 0
    with open(out_path, "w") as f:
        for w in sorted(words):
            if all(c in toks for c in w):
                f.write(f"{w} {' '.join(list(w))} {eow_token} \n")
                n += 1
    return n


# ---------------------------------------------------------------------------
# Kaldi data directory -> list file (data/utils/kaldi_to_listfile.py)
# ---------------------------------------------------------------------------

_SOX_REMIX_RE = None


def _resolve_wav_scp_entry(wav_handle: str, tmp_dir: str) -> Tuple[str, Optional[tuple]]:
    """One wav.scp RHS -> (wav_path, pending_command).

    Two cases, as in the reference (kaldi_to_listfile.py:66-87): a plain
    audio path, or a sox pipe script ("sox in.wav -t wav - remix 1 |").
    Pipe scripts resolve to a deterministic temp wav; the actual
    materialization happens in ``prepare_kaldi_dir`` (sox binary when
    present, else a native parse of the common trim/remix pipelines)."""
    import re

    wav_handle = wav_handle.strip()
    if not wav_handle.startswith("sox"):
        return wav_handle, None
    hsh = re.sub("[^0-9a-zA-Z]+", "", wav_handle)
    out = os.path.join(tmp_dir, f"{hsh}.wav")
    return out, (wav_handle, out)


def _materialize_sox_native(script: str, out: str):
    """Execute the common kaldi wav.scp sox pipelines without sox:
    ``sox IN -t wav - [remix K] [trim S D] |``. Raises on anything else."""
    import re

    import numpy as np

    toks = script.rstrip("|").split()
    assert toks[0] == "sox"
    toks = toks[1:]
    # strip the output spec "-t wav -"
    src = None
    ops: List[List[str]] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "-t":
            i += 2
            continue
        if t == "-":
            i += 1
            continue
        if t in ("remix", "trim"):
            op = [t]
            i += 1
            while i < len(toks) and re.fullmatch(r"[-0-9.:]+", toks[i]):
                op.append(toks[i])
                i += 1
            ops.append(op)
            continue
        if src is None and not t.startswith("-"):
            src = t
            i += 1
            continue
        raise ValueError(f"unsupported sox script (install sox): {script!r}")
    if src is None:
        raise ValueError(f"no input file in sox script: {script!r}")
    # read channels-preserved (load_audio_with_sr downmixes, which would
    # break remix channel selection)
    if src.lower().endswith(".wav"):
        from scipy.io import wavfile

        sr, data = wavfile.read(src)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        else:
            data = data.astype(np.float32)
    else:
        from ..data.audio import load_audio_with_sr

        sr, data = load_audio_with_sr(src)
    for op in ops:
        if op[0] == "remix":
            # channel select/mix; mono data ignores it
            if data.ndim > 1:
                chans = [int(c) - 1 for c in op[1:]]
                data = data[:, chans].mean(axis=1)
        elif op[0] == "trim":
            start = float(op[1])
            data = data[int(start * sr):]
            if len(op) > 2:
                dur = float(op[2])
                data = data[: int(dur * sr)]
    from scipy.io import wavfile

    wavfile.write(out, sr, (np.clip(data, -1, 1) * 32767.0).astype(np.int16))


def prepare_kaldi_dir(src: str, dst: str, name: str = "data.lst",
                      n_process: int = 8) -> int:
    """Package a kaldi data directory (``text`` + ``segments`` + ``wav.scp``)
    into segmented audio + a w2l list file — the
    ``data/utils/kaldi_to_listfile.py`` counterpart.

    Differences from the reference (sox-free, host only): segments
    are cut natively from the decoded source audio and written as 16-bit
    WAV (the reference shells out to sox per segment and emits FLAC —
    thousands of process spawns); sox pipe scripts in ``wav.scp`` use the
    sox binary when installed, else a native parse of trim/remix pipelines.
    List-file rows are ``uid path duration_ms transcript`` exactly like the
    reference (duration printed with 2 decimals, ms).

    Returns the number of list rows written."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy.io import wavfile

    from ..data.audio import load_audio_with_sr

    os.makedirs(dst, exist_ok=True)
    audio_dir = os.path.join(dst, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    tmp_dir = os.path.join(dst, "_scp_tmp")
    os.makedirs(tmp_dir, exist_ok=True)

    wav_files: Dict[str, str] = {}
    pending: Dict[str, tuple] = {}
    with open(os.path.join(src, "wav.scp")) as f:
        for line in f:
            if not line.strip():
                continue
            wid, handle = line.strip().split(" ", 1)
            path, cmd = _resolve_wav_scp_entry(handle, tmp_dir)
            wav_files[wid] = path
            if cmd and cmd[1] not in pending:
                pending[cmd[1]] = cmd

    have_sox = shutil.which("sox") is not None
    for script, out in pending.values():
        if os.path.exists(out):
            continue
        if have_sox:
            import subprocess

            cmd = script.rstrip().rstrip("|").replace(" - ", f" {out} ", 1)
            subprocess.run(cmd, shell=True, check=True)
        else:
            _materialize_sox_native(script, out)

    transcripts: Dict[str, str] = {}
    with open(os.path.join(src, "text")) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                transcripts[parts[0]] = " ".join(parts[1:])

    segments: List[tuple] = []
    with open(os.path.join(src, "segments")) as f:
        for line in f:
            if not line.strip():
                continue
            uid, wid, s, e = line.strip().split(" ", 3)
            segments.append((uid, wav_files[wid], float(s), float(e)))

    # cut segments grouped by source file: decode each source ONCE, slice
    # all its segments from memory (the reference re-opens the source per
    # segment via a sox process)
    by_src: Dict[str, List[tuple]] = {}
    for uid, path, s, e in segments:
        by_src.setdefault(path, []).append((uid, s, e))

    def cut_one_source(path):
        sr, data = load_audio_with_sr(path)
        pcm = (np.clip(data, -1, 1) * 32767.0).astype(np.int16)
        for uid, s, e in by_src[path]:
            wavfile.write(
                os.path.join(audio_dir, f"{uid}.wav"), sr,
                pcm[int(s * sr): int(e * sr)],
            )

    with ThreadPoolExecutor(max_workers=max(1, n_process)) as ex:
        list(ex.map(cut_one_source, by_src))

    n = 0
    with open(os.path.join(dst, name), "w") as fo:
        for uid, _, s, e in segments:
            dur_ms = f"{(e - s) * 1000:.2f}"
            out = os.path.join(audio_dir, f"{uid}.wav")
            fo.write("\t".join([uid, out, dur_ms, transcripts[uid]]) + "\n")
            n += 1
    return n
