"""Flag/config system — the port's own copy of ``wav2letter_tpu/config.py``.

Same flag table (``_f`` entries), ``.cfg`` format, precedence
(CLI > ``--flagsfile`` > checkpoint-serialized flags > defaults) and
serialization as the JAX package, so checkpoints and recipe files written for
either package parse in both. The only difference: ``--enable_distributed``
joins a ``torch.distributed`` group (``parallel/distributed.py``, when the
trainer starts on its device) instead of a JAX coordinator.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["FlagDef", "FLAG_DEFS", "Config", "parse_cfg_file", "parse_argv"]


@dataclasses.dataclass(frozen=True)
class FlagDef:
    name: str
    type: type
    default: Any
    help: str = ""
    deprecated_alias: Optional[str] = None


def _f(name, typ, default, help="", alias=None):
    return FlagDef(name, typ, default, help, alias)


# ---------------------------------------------------------------------------
# Flag registry. Names follow the reference (SURVEY.md Appendix A) so existing
# .cfg recipe files parse unchanged.
# ---------------------------------------------------------------------------
_DEFS: List[FlagDef] = [
    # --- run/management ---
    _f("runname", str, ""),
    _f("rundir", str, ""),
    _f("flagsfile", str, ""),
    _f("seed", int, 0),
    _f("reportiters", int, 0, "log/val cadence in updates; 0 = every epoch"),
    _f("iter", int, 1000000, "total number of updates"),
    _f("logtostderr", bool, True),
    _f("minloglevel", int, 0),
    # --- data ---
    _f("datadir", str, ""),
    _f("train", str, ""),
    _f("train2", str, "", "second (e.g. unsupervised) train list"),
    _f("valid", str, "", "comma list of tag:path validation lists"),
    _f("test", str, ""),
    _f("batchsize", int, 1),
    _f("validbatchsize", int, -1, "-1 = use batchsize"),
    _f("batching_strategy", str, "none", "none|dynamic"),
    _f("batching_max_duration", float, 0.0, "seconds per dynamic batch"),
    _f("dataorder", str, "input", "input|input_spiral|output_spiral"),
    _f("inputbinsize", int, 100, "ms per input-length bucket"),
    _f("outputbinsize", int, 5),
    _f("nthread", int, 1, "prefetch threads"),
    _f("minisz", float, 0.0, "min input size (ms) filter"),
    _f("maxisz", float, 1e9, "max input size (ms) filter"),
    _f("mintsz", float, 0.0, "min target size filter"),
    _f("maxtsz", float, 1e9, "max target size filter"),
    _f("max_load", int, -1, "max samples to load per list (-1 = all)"),
    _f("sfx_config", str, "", "JSON sound-effect chain config path"),
    _f("pad_multiple", int, 128, "TPU: pad batch time dim to a multiple (static shapes)"),
    _f("s2s_batch_decode", int, 1,
       "cross-utterance batched s2s beam decode: N utterances' beams "
       "advance through one jitted decoder-step device call (native only)"),
    _f("features_device", str, "host",
       "'host', given explicitly (command line or flagsfile): the trainer "
       "featurizes in the data threads and ships the features, bf16 under "
       "--compute_dtype=bfloat16 (reference W2lDataset placement). Otherwise the "
       "card featurizes inside the update (kernel K1): the port's default, where "
       "the JAX package's default 'host' featurizes on the host"),
    # --- features ---
    _f("mfsc", bool, False),
    _f("mfcc", bool, False),
    _f("pow", bool, False),
    _f("features_type", str, "", "mfsc|mfcc|raw|pow (overrides bool flags)"),
    _f("filterbanks", int, 80),
    _f("mfcccoeffs", int, 13),
    _f("samplerate", int, 16000),
    _f("framesizems", float, 25.0),
    _f("framestridems", float, 10.0),
    _f("melfloor", float, 1.0),
    _f("devwin", int, 0, "delta window size; 0 = no deltas"),
    _f("channels", int, 1),
    _f("lowfreqfilterbank", float, 0.0),
    _f("highfreqfilterbank", float, -1.0, "-1 = nyquist"),
    _f("localnrmlleftctx", int, 0, "local CMVN left context frames"),
    _f("localnrmlrightctx", int, 0),
    # --- tokens/targets ---
    _f("tokensdir", str, ""),
    _f("tokens", str, ""),
    _f("lexicon", str, ""),
    _f("wordseparator", str, "|"),
    _f("usewordpiece", bool, False),
    _f("surround", str, "", "token to surround targets with (e.g. |)"),
    _f("replabel", int, 0, "number of ASG repetition labels"),
    _f("sampletarget", float, 0.0, "prob of sampling a random lexicon spelling"),
    _f("maxword", int, -1),
    # --- model ---
    _f("archdir", str, ""),
    _f("arch", str, "", ".arch file or python plugin module path"),
    _f("encoderdim", int, 0),
    # --- criterion ---
    _f("criterion", str, "ctc", "ctc|asg|seq2seq|transformer|cpc"),
    _f("onorm", str, "none", "loss scale: none|target|input"),
    _f("sqnorm", bool, False, "sqrt the scale divisor"),
    _f("labelsmooth", float, 0.0),
    _f("eostoken", bool, False),
    _f("pctteacherforcing", float, 100.0),
    _f("maxdecoderoutputlen", int, 200),
    _f("linseg", int, 0, "ASG linear-segmentation init updates"),
    _f("transdiag", float, 0.0, "ASG transition diagonal init value"),
    _f("attention", str, "content", "content|keyvalue|location|multi..."),
    _f("attnWindow", str, "no", "no|median|step|soft|softPretrain"),
    _f("attnconvchannel", int, 0),
    _f("attndim", int, 0),
    _f("numattnhead", int, 8),
    _f("softwstd", float, 0.0),
    _f("softwoffset", float, 10.0),
    _f("softwrate", float, 5.0),
    _f("pretrainWindow", int, 0),
    _f("trainWithWindow", bool, False),
    _f("leftWindowSize", int, 50),
    _f("rightWindowSize", int, 50),
    _f("minsil", int, 0),
    _f("maxsil", int, 50),
    _f("minrate", float, 3.0),
    _f("maxrate", float, 10.0),
    _f("samplingstrategy", str, "rand", "rand|model"),
    _f("gumbeltemperature", float, 1.0),
    _f("decoderrnnlayer", int, 1),
    _f("decoderattnround", int, 1),
    _f("decoderdropout", float, 0.0),
    _f("am_decoder_tr_layers", int, 1),
    _f("am_decoder_tr_dropout", float, 0.0),
    _f("am_decoder_tr_layerdrop", float, 0.0),
    # --- optimization ---
    _f("lr", float, 1.0),
    _f("lrcrit", float, 0.0),
    _f("netoptim", str, "sgd", "sgd|adam|adadelta|adagrad|amsgrad|novograd|rmsprop"),
    _f("critoptim", str, "sgd"),
    _f("momentum", float, 0.0),
    _f("weightdecay", float, 0.0),
    _f("adambeta1", float, 0.9),
    _f("adambeta2", float, 0.999),
    _f("optimrho", float, 0.9),
    _f("optimepsilon", float, 1e-8),
    _f("maxgradnorm", float, 0.0, "0 = no clipping"),
    _f("warmup", int, 0, "linear LR warmup updates"),
    _f("hold", int, 0, "hold LR flat after warmup for this many updates"),
    _f("lr_sched", str, "constant", "constant|linear|inv_sqrt|step|cosine|custom"),
    _f("lr_decay", int, 0, "epoch at which to start halving (reference lr_decay)"),
    _f("lr_decay_step", int, 1000000, "halve every this many epochs after lr_decay"),
    _f("lr_ld_final", float, 0.0, "final lr for linear decay"),
    _f("lr_step_decay", int, 0, "inv_sqrt/step: decay interval in updates"),
    _f("stepsize", int, 1000000, "multiply lr by gamma every stepsize updates"),
    _f("gamma", float, 1.0),
    _f("lrcosine", bool, False),
    _f("pcttraineval", float, 100.0, "pct of train set used for train-WER meter"),
    # --- SpecAugment ---
    _f("saug_start_update", int, -1, "-1 = no flag-driven SpecAugment"),
    _f("saug_fmaskf", int, 27),
    _f("saug_fmaskn", int, 2),
    _f("saug_tmaskt", int, 100),
    _f("saug_tmaskp", float, 1.0),
    _f("saug_tmaskn", int, 2),
    # --- precision / AMP ---
    _f("fl_amp_use_mixed_precision", bool, False),
    _f("fl_amp_scale_factor", float, 65536.0),
    _f("fl_amp_scale_factor_update_interval", int, 2000),
    _f("fl_amp_max_scale_factor", float, 65536.0),
    _f("fl_optim_mode", str, "", "O1 etc; on TPU maps to bf16 compute"),
    _f("compute_dtype", str, "bfloat16", "TPU compute dtype: bfloat16|float32"),
    _f("remat", bool, False, "rematerialize the model forward in backward (saves HBM)"),
    # --- distributed ---
    _f("enable_distributed", bool, False),
    _f("world_rank", int, 0),
    _f("world_size", int, 1),
    _f("max_devices_per_node", int, 8),
    _f("rndv_filepath", str, "", "unused: ranks meet through torchrun's env:// variables"),
    _f("dp_axis", int, -1, "-1: all devices data-parallel"),
    _f("mp_axis", int, 1, "model-parallel mesh dim"),
    # --- decoding ---
    _f("am", str, ""),
    _f("emission_dir", str, ""),
    _f("lm", str, ""),
    _f("lmtype", str, "kenlm", "kenlm|convlm"),
    _f("lm_vocab", str, ""),
    _f("lm_memory", int, 5000),
    _f("lmdict", str, ""),
    _f("decodertype", str, "wrd", "wrd|tkn"),
    _f("uselexicon", bool, True),
    _f("beamsize", int, 2500),
    _f("beamsizetoken", int, 250000),
    _f("beamthreshold", float, 25.0),
    _f("lmweight", float, 0.0),
    _f("wordscore", float, 0.0),
    _f("silscore", float, 0.0),
    _f("unkscore", float, float("-inf")),
    _f("eosscore", float, 0.0),
    _f("logadd", bool, False),
    _f("smearing", str, "none", "none|max|logadd"),
    _f("smoothingtemperature", float, 1.0),
    _f("attentionthreshold", float, float("inf")),
    # TDS-era s2s candidate pruning (seq2seq_tds decode cfgs:18-19)
    _f("hardselection", float, float("inf")),
    _f("softselection", float, float("inf")),
    _f("nthread_decoder", int, 1),
    _f("nthread_decoder_am_forward", int, 1),
    _f("emission_queue_size", int, 3000),
    _f("isbeamdump", bool, False),
    _f("use_completed_hyp", bool, False,
       "s2s beam dump: keep only EOS-completed hypotheses (sota/2019 "
       "rescoring cfgs)"),
    _f("sclite", str, ""),
    _f("show", bool, False),
    _f("showletters", bool, False),
    _f("lmweight_low", float, 0.0),
    _f("lmweight_high", float, 4.0),
    _f("lmweight_step", float, 0.2),
]

# deprecated aliases (reference handleDeprecatedFlags, cpc/Train.cpp:331)
_DEPRECATED = {
    "silweight": "silscore",
    "sil_weight": "silscore",
    "smoothing_temperature": "smoothingtemperature",
    "listdata": None,  # accepted, ignored
    "memstepsize": None,
    "fftcachesize": None,
    "wnorm": None,
    "fl_benchmark_mode": None,  # ArrayFire dynamic-benchmark toggle; no TPU analog
    # target-unit type (ltr|tkn|wrd): implied by the tokens/lexicon files in
    # this framework (the reference's W2lDataset-era flag; seq2seq_tds etc.
    # set --target=ltr)
    "target": None,
}

FLAG_DEFS: Dict[str, FlagDef] = {d.name: d for d in _DEFS}


def _coerce(d: FlagDef, raw: Any) -> Any:
    if isinstance(raw, str):
        if d.type is bool:
            return raw.strip().lower() in ("true", "1", "yes", "y", "")
        if d.type is int:
            return int(float(raw))
        if d.type is float:
            return float(raw)
        return raw
    return d.type(raw) if not isinstance(raw, d.type) else raw


def parse_cfg_file(path: str) -> Dict[str, str]:
    """Parse a reference-format .cfg flagsfile: ``--name=value`` lines."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.update(_parse_one(line))
    return out


def _parse_one(tok: str) -> Dict[str, str]:
    if not tok.startswith("--"):
        raise ValueError(f"bad flag token: {tok!r}")
    body = tok[2:]
    if "=" in body:
        k, v = body.split("=", 1)
    else:
        k, v = body, "true"
        if k.startswith("no") and k[2:] in FLAG_DEFS:
            k, v = k[2:], "false"
    return {k: v}


def parse_argv(argv: Iterable[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in argv:
        out.update(_parse_one(tok))
    return out


class Config:
    """Attribute-accessible flag snapshot with reference precedence rules."""

    def __init__(self, **overrides: Any):
        self._values: Dict[str, Any] = {d.name: d.default for d in _DEFS}
        # keys the caller actually SET (vs. defaults) — continue-mode flag
        # re-injection must override stored checkpoint flags with only
        # these, never with process defaults (reference gflags semantics:
        # a re-run `fl_asr_train continue` keeps stored values unless the
        # flag is explicitly re-passed)
        self._explicit: set = set()
        self.update(overrides)

    # -- mutation ----------------------------------------------------------
    def update(self, kv: Dict[str, Any]) -> "Config":
        for k, v in kv.items():
            k = self._canonical(k)
            if k is None:
                continue
            d = FLAG_DEFS[k]
            self._values[k] = _coerce(d, v)
            self._explicit.add(k)
        return self

    def explicit_dict(self) -> Dict[str, Any]:
        """Only the flags explicitly set on this Config (CLI/flagsfile/
        programmatic update), excluding untouched defaults."""
        return {k: self._values[k] for k in self._explicit if k in self._values}

    def _canonical(self, k: str) -> Optional[str]:
        if k in FLAG_DEFS:
            return k
        if k in _DEPRECATED:
            return _DEPRECATED[k]  # may be None (ignored)
        raise KeyError(f"unknown flag: --{k}")

    # -- access ------------------------------------------------------------
    def __getattr__(self, k: str) -> Any:
        vals = object.__getattribute__(self, "_values")
        if k in vals:
            return vals[k]
        raise AttributeError(k)

    def __getitem__(self, k: str) -> Any:
        return self._values[k]

    def get(self, k: str, default: Any = None) -> Any:
        return self._values.get(k, default)

    def asdict(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- build sequence ----------------------------------------------------
    @classmethod
    def from_sources(
        cls,
        argv: Optional[Iterable[str]] = None,
        flagsfile: Optional[str] = None,
        checkpoint_cfg: Optional[Dict[str, Any]] = None,
    ) -> "Config":
        """Apply reference precedence: defaults < checkpoint < flagsfile < CLI."""
        cfg = cls()
        if checkpoint_cfg:
            cfg.update(
                {k: v for k, v in checkpoint_cfg.items() if not k.startswith("__")}
            )
        cli = parse_argv(argv) if argv else {}
        ff = flagsfile or cli.get("flagsfile", "")
        if ff:
            cfg.update(parse_cfg_file(ff))
        if cli:
            cfg.update(cli)
        cfg.apply_runtime_flags()
        return cfg

    def apply_runtime_flags(self) -> None:
        """Honor process-level flags at CLI entry (gflags/glog parity):
        --minloglevel/--logtostderr set the Python logging config
        (glog levels: 0=INFO 1=WARNING 2=ERROR 3=FATAL)."""
        import logging
        import sys as _sys

        level = [logging.INFO, logging.WARNING, logging.ERROR, logging.FATAL][
            min(max(int(self.minloglevel), 0), 3)
        ]
        h = logging.StreamHandler(_sys.stderr if self.logtostderr else None)
        logging.basicConfig(level=level, handlers=[h], force=True)

    # -- serialization (checkpoint self-description) -----------------------
    def serialize(self) -> str:
        vals = {
            k: ("__-inf__" if v == float("-inf") else "__inf__" if v == float("inf") else v)
            for k, v in self._values.items()
        }
        return json.dumps(vals, sort_keys=True)

    @classmethod
    def deserialize(cls, blob: str) -> "Config":
        raw = json.loads(blob)
        fixed = {
            k: (float("-inf") if v == "__-inf__" else float("inf") if v == "__inf__" else v)
            for k, v in raw.items()
        }
        cfg = cls()
        # tolerate flags added/removed across versions
        for k, v in fixed.items():
            try:
                cfg.update({k: v})
            except KeyError:
                pass
        return cfg

    # -- derived helpers ---------------------------------------------------
    def feature_type(self) -> str:
        if self.features_type:
            return self.features_type
        if self.mfsc:
            return "mfsc"
        if self.mfcc:
            return "mfcc"
        if self.pow:
            return "pow"
        return "raw"

    def num_features(self) -> int:
        ft = self.feature_type()
        if ft == "mfsc":
            base = self.filterbanks
        elif ft == "mfcc":
            base = self.mfcccoeffs
        elif ft == "pow":
            # one-sided power spectrum bins for the fft size implied by frame
            from .features.frontend import n_fft_for

            base = n_fft_for(int(self.samplerate * self.framesizems / 1000)) // 2 + 1
        else:
            return self.channels
        mult = 1 + (2 if self.devwin > 0 and ft in ("mfsc", "mfcc") else 0)
        return base * mult

    def valid_sets(self) -> List[Tuple[str, str]]:
        """Parse --valid 'tag:path,tag2:path2' (reference cpc/Train.cpp:387-397)."""
        out = []
        if not self.valid:
            return out
        for part in self.valid.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                tag, path = part.split(":", 1)
            else:
                tag, path = part, part
            out.append((tag, path))
        return out
