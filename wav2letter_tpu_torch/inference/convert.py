"""Training checkpoint -> streaming inference bundle — the port of
``wav2letter_tpu/inference/convert.py``.

The reference converter (``StreamingTDSModelConverter.cpp``) walks the
`.arch` lines (C2/PD/R/LN/L/TDS; skips V/RO/DO/SAUG) and maps each module's
params into streaming modules. Here the same walk gives the stream layers
(``build_streaming_layers``, each holding a batch layer of the port built on
the meta device) and the map from a model's state dict to the flat streaming
param dict of the JAX package (``map_params``: OIHW conv weights with weight
norm folded, C-major TDS linears), which ``StreamingNetwork`` copies into the
layers.

The port's bundle is ``BUNDLE_MAGIC`` then a ``torch.save`` payload of {arch
lines, n_feat, params, feature config, tokens, criterion, replabel,
wordseparator[, transitions]}; ``load_streaming_bundle`` also reads the JAX
package's ``W2LSTRM1`` bundles (a flax msgpack payload of the same fields).
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..features.frontend import FeatureParams
from ..models import layers as L
from ..models.arch import parse_arch_file
from .streaming import StreamConv, StreamLayer, StreamPointwise, StreamTDS, StreamingNetwork

BUNDLE_MAGIC = b"W2LSTRT1"  # the port's bundle: a torch.save payload
JAX_BUNDLE_MAGIC = b"W2LSTRM1"  # the JAX package's: a flax msgpack payload
_CHILD_KIND = {"C": "C", "C1": "C", "C2": "C2", "AC": "AC", "TDS": "TDS", "LN": "LN",
               "L": "L", "WNL": "WNL"}


def _unstreamable(kind: str, line: str) -> ValueError:
    return ValueError(
        f"layer {kind!r} is not streamable (reference converter supports "
        f"C/C2/PD/R/LN/L/TDS): {line}")


def build_streaming_layers(lines: List[str], n_feat: int
                           ) -> Tuple[List[StreamLayer], List[Tuple[str, str]]]:
    """Arch lines -> stream layers and (stream name, model child name) pairs
    for ``map_params``, by the reference converter's dispatch. The layers'
    modules are on the meta device until ``StreamingNetwork`` fills them."""
    layers: List[StreamLayer] = []
    pmap: List[Tuple[str, str]] = []
    pending_pad = (0, 0)
    freq_dim = n_feat
    with torch.device("meta"):
        for i, line in enumerate(lines):
            toks = line.split()
            kind = toks[0]
            if kind == "WN":  # weight norm is folded into the weight by map_params
                toks = toks[2:]
                kind = "WNL" if toks[0] == "L" else toks[0]
            child = f"{i:02d}_{_CHILD_KIND.get(kind, kind)}"
            if kind in ("V", "RO", "DO", "SAUG"):
                continue
            if kind == "PD":
                vals = [int(x) for x in toks[2:]]
                if float(toks[1]) != 0 or any(vals[2:]):
                    raise ValueError(f"streaming PD pads time with zeros only: {line}")
                pending_pad = (vals[0], vals[1] if len(vals) > 1 else 0)
                continue
            if kind in ("C", "C1", "C2", "AC"):
                conv, left, right, freq_in = _conv(kind, toks, line, freq_dim)
                name = f"l{i}_conv"
                layers.append(StreamConv(name, conv, pending_pad[0] + left,
                                         pending_pad[1] + right, freq_in))
                pmap.append((name, child))
                if kind == "C2":
                    freq_dim = (freq_dim + 2 * conv.py - conv.wy) // conv.sy + 1
                pending_pad = (0, 0)
                continue
            if kind == "TDS":
                c, w, f = int(toks[1]), int(toks[2]), int(toks[3])
                inner = int(toks[5]) if len(toks) >= 6 else 0
                rpad = int(toks[6]) if len(toks) >= 7 else -1
                lnt = not (len(toks) >= 8 and int(toks[7]) == 0)
                name = f"l{i}_tds"
                layers.append(StreamTDS(name, L.TDSBlock(c, w, f, 0.0, inner, rpad, lnt)))
                pmap.append((name, child))
                continue
            if kind == "R":
                layers.append(StreamPointwise(f"l{i}_relu", "relu"))
                continue
            if kind == "LN":
                dims = tuple(int(x) for x in toks[1:])
                if sorted(dims) != [1, 2]:
                    raise ValueError(f"streaming LN normalizes each frame over AF dims 1 "
                                     f"and 2: {line}")
                name = f"l{i}_ln"
                layers.append(StreamPointwise(name, "ln", L.LayerNorm(dims)))
                pmap.append((name, child))
                continue
            if kind in ("L", "WNL"):
                bias = not (len(toks) == 4 and toks[3] == "0")
                name = f"l{i}_lin"
                layers.append(StreamPointwise(name, "linear",
                                              L.Linear(int(toks[1]), int(toks[2]), bias)))
                pmap.append((name, child))
                continue
            raise _unstreamable(kind, line)
    return layers, pmap


def _conv(kind: str, toks: List[str], line: str, freq_dim: int):
    """(the stream conv's ``Conv2D`` without pads or weight norm, its own
    (left, right) time pads, its input's frequency extent) of a C, C1, C2
    or AC line."""
    ci, co = int(toks[1]), int(toks[2])
    if kind == "C2":
        kw, kh, sx, sy = (int(x) for x in toks[3:7])
        px = int(toks[7]) if len(toks) >= 8 else 0
        py = int(toks[8]) if len(toks) >= 9 else 0
        dil = [int(x) for x in toks[9:11]]
        conv = L.Conv2D(ci, co, kw, kh, sx, sy, 0, py)
        left = right = px
    else:
        kw, sx = int(toks[3]), int(toks[4])
        px = int(toks[5]) if len(toks) >= 6 else 0
        if kind == "AC":
            fpx = float(toks[6]) if len(toks) >= 7 else 1.0
            dil = [int(x) for x in toks[7:8]]
            left, right = L.asymmetric_pads(kw, px, fpx)
            conv = L.Conv2D(ci, co, kw, 1, sx)
        else:
            dil = [int(x) for x in toks[6:7]]
            bias = bool(int(toks[7])) if len(toks) >= 8 else True
            groups = int(toks[8]) if len(toks) >= 9 else 1
            conv = L.Conv2D(ci, co, kw, 1, sx, groups=groups, use_bias=bias)
            left = right = px
        freq_dim = 1
    if any(d != 1 for d in dil):
        raise ValueError(f"streaming {kind} with dilation unsupported: {line}")
    if px < 0 and kind != "AC":
        raise ValueError(f"streaming {kind} needs explicit time pads, not SAME: {line}")
    return conv, left, right, freq_dim


def _np(v: Any) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def map_params(pmap: List[Tuple[str, str]], state_dict: Dict[str, Any]
               ) -> Dict[str, np.ndarray]:
    """A port ``ArchModel`` state dict (``seq.03_C2.weight``, or without
    ``seq.``) -> the flat streaming param dict, as the JAX ``map_params``
    makes it from the flax tree."""
    sd = {(k[4:] if k.startswith("seq.") else k): v for k, v in state_dict.items()}
    out: Dict[str, np.ndarray] = {}

    def get(child: str, name: str) -> np.ndarray:
        return _np(sd[f"{child}.{name}"])

    for sname, child in pmap:
        if sname.endswith("_conv"):
            if any(k.startswith(f"{child}.conv.") for k in sd):  # AC wraps a Conv2D
                child = f"{child}.conv"
            if f"{child}.v" in sd:  # weight-normed conv
                v, g = get(child, "v"), get(child, "g")
                nrm = np.sqrt((v ** 2).sum(axis=(1, 2, 3), keepdims=True) + 1e-12)
                out[f"{sname}_w"] = (g * v / nrm).astype(np.float32)
            else:
                out[f"{sname}_w"] = get(child, "weight")
            if f"{child}.bias" in sd:
                out[f"{sname}_b"] = get(child, "bias")
        elif sname.endswith("_tds"):
            for key, attr in StreamTDS.PARAMS:
                out[f"{sname}_{key}"] = get(child, attr)
        elif sname.endswith("_ln"):
            out[f"{sname}_w"] = get(child, "weight")
            out[f"{sname}_b"] = get(child, "bias")
        elif sname.endswith("_lin"):
            if f"{child}.v" in sd:
                v, g = get(child, "v"), get(child, "g")
                nrm = np.sqrt((v ** 2).sum(axis=0, keepdims=True) + 1e-12)
                out[f"{sname}_w"] = (v / nrm * g[None, :]).astype(np.float32)
            else:
                out[f"{sname}_w"] = get(child, "weight")
            if f"{child}.bias" in sd:
                out[f"{sname}_b"] = get(child, "bias")
    return out


def build_streaming_network(lines: List[str], n_feat: int, state_dict: Dict[str, Any],
                            device: str = "cuda") -> StreamingNetwork:
    layers, pmap = build_streaming_layers(lines, n_feat)
    return StreamingNetwork(layers, map_params(pmap, state_dict), device)


def convert_checkpoint(ckpt_path: str, out_path: str) -> str:
    """A training checkpoint (the port's, or a JAX ``W2LTPU01``) -> the
    port's streaming bundle file."""
    from ..data.dictionary import make_token_dict
    from ..runtime.checkpoint import load_checkpoint

    ckpt = load_checkpoint(ckpt_path)
    cfg = Config.deserialize(ckpt.config)
    arch_path = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
    n_feat = cfg.num_features()
    tokens_path = os.path.join(cfg.tokensdir, cfg.tokens) if cfg.tokensdir else cfg.tokens
    tok = make_token_dict(tokens_path, cfg.criterion, cfg.replabel, cfg.eostoken)
    lines = parse_arch_file(arch_path, n_feat, len(tok))
    _, pmap = build_streaming_layers(lines, n_feat)
    params = map_params(pmap, ckpt.state_dict)
    payload = {
        "arch_lines": lines,
        "n_feat": n_feat,
        "params": {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()},
        "feature_cfg": {
            "sample_rate": cfg.samplerate,
            "frame_size_ms": cfg.framesizems,
            "frame_stride_ms": cfg.framestridems,
            "n_filterbanks": cfg.filterbanks,
            "local_norm_left": cfg.localnrmlleftctx,
            "local_norm_right": cfg.localnrmlrightctx,
        },
        "tokens": tok.entries(),
        "criterion": cfg.criterion,
        "replabel": cfg.replabel,
        "wordseparator": cfg.wordseparator,
    }
    if cfg.criterion == "asg" and "transitions" in ckpt.crit_state_dict:
        payload["transitions"] = ckpt.crit_state_dict["transitions"].float()
    buf = io.BytesIO()
    torch.save(payload, buf)
    with open(out_path, "wb") as f:
        f.write(BUNDLE_MAGIC)
        f.write(buf.getvalue())
    return out_path


def load_streaming_bundle(path: str, device: str = "cuda"
                          ) -> Tuple[StreamingNetwork, FeatureParams, Dict[str, Any]]:
    """(network on ``device``, feature params, payload) of a port bundle or
    a JAX ``W2LSTRM1`` bundle."""
    with open(path, "rb") as f:
        magic = f.read(len(BUNDLE_MAGIC))
        blob = f.read()
    if magic == BUNDLE_MAGIC:
        payload = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    elif magic == JAX_BUNDLE_MAGIC:
        from ..runtime.checkpoint import unpack_flax_msgpack

        payload = unpack_flax_msgpack(blob)
    else:
        raise ValueError(f"{path}: not a streaming bundle")
    layers, _ = build_streaming_layers([str(l) for l in payload["arch_lines"]],
                                       int(payload["n_feat"]))
    net = StreamingNetwork(layers, payload["params"], device)
    fp = payload["feature_cfg"]
    feat = FeatureParams(
        sample_rate=int(fp["sample_rate"]),
        frame_size_ms=float(fp["frame_size_ms"]),
        frame_stride_ms=float(fp["frame_stride_ms"]),
        n_filterbanks=int(fp["n_filterbanks"]),
        local_norm_left=int(fp["local_norm_left"]),
        local_norm_right=int(fp["local_norm_right"]),
    )
    return net, feat, payload
