"""`.arch` DSL parser -> nn.Module graph — the port of
``wav2letter_tpu/models/arch.py`` for the mnemonics of the streaming-convnets,
transformer, conformer, ResNet, conv-GLU, TIMIT and learnable-frontend recipes
and of streaming, and of the LM archs: every mnemonic of the JAX DSL, V RO PD C
C1 C2 AC WN (of a conv or an L) TDS L LN BN DO M A SAUG TR CFR RES (with SKIP,
SKIPL), the embeddings E ADAPTIVEE POSEMB SINPOSEMB, PC, RNN GRU LSTM and the
activations R R6 ELU LG HT T SH GLU LSM PR.

Grammar: one layer per line, ``#`` comments, NFEAT/NLABEL substitution
(reference ``buildSequentialModule``). The model takes features (B, T, C)
plus valid lengths, enters the stored AF-reversed layout (B, 1, C, T), runs
the layers, and returns emissions (B, T_out, NLABEL) with lengths scaled by
the valid fraction of the input.

Layer i is named ``f"{i:02d}_{kind}"``, as in the JAX package (kind ``C`` also
for a weight-normed conv, ``WNL`` for a weight-normed linear, ``POOL`` for
``M``/``A``), so the flax param tree ``seq/03_C2/weight`` is the state-dict key
``seq.03_C2.weight``. A residual block ``05_RES`` nests its layers (``l{k}``)
and projections (``s{i}.p{k}``), where flax keeps them beside it
(``seq/05_RES_l0``, ``seq/05_RES_s0p1``); ``runtime/checkpoint.py`` maps the
two. ``TR`` and
``CFR`` layers get the (B, T) mask of valid frames, built from the valid
fraction of the input at whatever length the stack has reached.
A ``PD`` that only pads time with zeros right before a time-only ``C2`` is
folded into that conv's in-kernel pads and stays as an ``Identity``, as the
JAX chain pass does (``arch.py:412-423``). The JAX layout passes
(``_fuse_chain_tconv``, ``_fuse_tds_layouts``) are TPU layout tricks and are
not ported: parameters do not depend on layout.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels import KERNELS
from . import layers as L
from .transformer import ConformerLayer, TransformerLayer


@dataclasses.dataclass
class LayerSpec:
    kind: str
    module_fn: Callable[[SimpleNamespace], nn.Module]  # ops -> module
    line: str = ""


def _num(s: str) -> float:
    return float(s)


def parse_arch_file(path: str, n_feat: int, n_label: int) -> List[str]:
    with open(path) as f:
        raw = f.readlines()
    lines = []
    for l in raw:
        l = l.strip().replace("NFEAT", str(n_feat)).replace("NLABEL", str(n_label))
        if not l or l.startswith("#"):
            continue
        lines.append(l)
    return lines


def _parse_one(p: List[str], line: str) -> LayerSpec:
    op = p[0]
    if op in ("V", "RO"):
        dims = tuple(int(x) for x in p[1:5])
        if op == "V":
            return LayerSpec("V", lambda ops: L.View(dims), line)
        return LayerSpec("RO", lambda ops: L.Reorder(dims), line)
    if op == "PD":
        val = _num(p[1])
        rest = [int(x) for x in p[2:]] + [0] * (8 - len(p[2:]))
        pads = tuple((rest[2 * i], rest[2 * i + 1]) for i in range(4))
        return LayerSpec("PD", lambda ops: L.Padding(val, pads), line)
    if op == "WN":
        wdim, child = int(p[1]), p[2:]
        if child[0] == "L":
            li, lo = int(child[1]), int(child[2])
            bias = not (len(child) == 4 and child[3] == "0")
            return LayerSpec("WNL", lambda ops: L.WNLinear(li, lo, bias, wdim), line)
        if child[0] not in ("C", "C1", "C2", "AC"):
            raise ValueError(f"WN wrapping unsupported child: {line}")
        return _parse_conv(child, line, wdim)
    if op in ("C", "C1", "C2", "AC"):
        return _parse_conv(p, line, -1)
    if op == "TR":
        md, mlp, nh, csz = int(p[1]), int(p[2]), int(p[3]), int(p[4])
        do = _num(p[5])
        ld = _num(p[6]) if len(p) >= 7 else 0.0
        preln = bool(int(p[7])) if len(p) >= 8 else False
        fmask = bool(int(p[8])) if len(p) >= 9 else False
        return LayerSpec(
            "TR", lambda ops: TransformerLayer(md, mlp, nh, csz, do, ld, preln, fmask, ops=ops),
            line)
    if op == "CFR":
        md, mlp, nh, csz, kern = (int(v) for v in p[1:6])
        do = _num(p[6])
        ld = _num(p[7]) if len(p) >= 8 else 0.0
        cn = p[8].lower() if len(p) >= 9 else "ln"
        if cn not in ("ln", "bn", "layernorm", "batchnorm"):
            raise ValueError(f"CFR conv norm must be LN or BN, got {p[8]!r}: {line}")
        cn = {"ln": "layernorm", "bn": "batchnorm"}.get(cn, cn)
        return LayerSpec(
            "CFR", lambda ops: ConformerLayer(md, mlp, nh, csz, kern, do, ld, cn, ops=ops),
            line)
    if op in ("M", "A"):
        wx, wy, sx, sy = int(p[1]), int(p[2]), int(p[3]), int(p[4])
        px = int(p[5]) if len(p) > 5 else 0
        py = int(p[6]) if len(p) > 6 else 0
        mode = "avg" if op == "A" else "max"
        return LayerSpec("POOL", lambda ops: L.Pool2D(wx, wy, sx, sy, px, py, mode), line)
    if op in ("ELU", "R", "R6", "LG", "HT", "T"):
        return LayerSpec(op, lambda ops: L.Activation(op), line)
    if op == "PR":
        npar = int(p[1]) if len(p) > 1 else 1
        iv = _num(p[2]) if len(p) > 2 else 0.25
        return LayerSpec("PR", lambda ops: L.PReLU(npar, iv), line)
    if op in ("GLU", "LSM"):
        dim = int(p[1])
        return LayerSpec(op, lambda ops: L.Activation(op, dim), line)
    if op == "SH":
        beta = _num(p[1]) if len(p) > 1 else 1.0
        return LayerSpec("SH", lambda ops: L.Activation("SH", beta=beta), line)
    if op == "TDS":
        ci, wx, fdim = int(p[1]), int(p[2]), int(p[3])
        do = _num(p[4]) if len(p) >= 5 else 0.0
        l2 = int(p[5]) if len(p) >= 6 else 0
        rpad = int(p[6]) if len(p) >= 7 else -1
        lnt = not (len(p) >= 8 and int(p[7]) == 0)
        return LayerSpec(
            "TDS", lambda ops: L.TDSBlock(ci, wx, fdim, do, l2, rpad, lnt, ops=ops), line)
    if op == "L":
        li, lo = int(p[1]), int(p[2])
        bias = not (len(p) == 4 and p[3] == "0")
        return LayerSpec("L", lambda ops: L.Linear(li, lo, bias), line)
    if op == "LN":
        fdims = tuple(int(x) for x in p[1:])
        return LayerSpec("LN", lambda ops: L.LayerNorm(fdims), line)
    if op == "DO":
        return LayerSpec("DO", lambda ops: L.Dropout(_num(p[1])), line)
    if op == "SAUG":
        f, mf, t = int(p[1]), int(p[2]), int(p[3])
        tt, tp, mt = int(p[4]), _num(p[5]), int(p[6])
        return LayerSpec("SAUG", lambda ops: L.SpecAugmentLayer(f, mf, tt, tp, mt), line)
    if op == "E":
        return LayerSpec("E", lambda ops: L.Embedding(int(p[1]), int(p[2])), line)
    if op == "ADAPTIVEE":
        cutoffs = tuple(int(c) for c in p[2].split(","))
        if list(cutoffs) != sorted(set(cutoffs)):
            raise ValueError(f"cutoffs must be strictly ascending: {line}")
        return LayerSpec("ADAPTIVEE", lambda ops: L.AdaptiveEmbedding(int(p[1]), cutoffs), line)
    if op == "POSEMB":
        do = _num(p[3]) if len(p) >= 4 else 0.0
        return LayerSpec("POSEMB", lambda ops: L.PositionEmbedding(int(p[1]), int(p[2]), do),
                         line)
    if op == "SINPOSEMB":
        sc = _num(p[2]) if len(p) >= 3 else 1.0
        return LayerSpec("SINPOSEMB", lambda ops: L.SinusoidalPositionEmbedding(int(p[1]), sc),
                         line)
    if op == "BN":
        fdims = tuple(int(x) for x in p[2:])
        return LayerSpec("BN", lambda ops: L.BatchNorm(fdims, int(p[1])), line)
    if op == "PC":
        if p[1] not in L.PC_DTYPES:
            raise ValueError(f"unknown dtype {p[1]}")
        dt = L.PC_DTYPES[p[1]]
        return LayerSpec("PC", lambda ops: L.PrecisionCast(dt), line)
    if op in ("RNN", "GRU", "LSTM"):
        mode = {"RNN": "relu", "GRU": "gru", "LSTM": "lstm"}[op]
        isz, osz = int(p[1]), int(p[2])
        nl = int(p[3]) if len(p) > 3 else 1
        bidir = (int(p[4]) > 0) if len(p) > 4 else False
        do = _num(p[5]) if len(p) > 5 else 0.0
        return LayerSpec(op, lambda ops: L.RNN(isz, osz, nl, mode, bidir, do), line)
    raise ValueError(f"cannot parse arch line: {line!r}")


def _parse_conv(p: List[str], line: str, wn_dim: int) -> LayerSpec:
    """``C``/``C1`` (time-only), ``AC`` (time-only, asymmetric pads) or
    ``C2``, possibly under ``WN wn_dim``."""
    if p[0] == "AC":
        ci, co, wx, sx = int(p[1]), int(p[2]), int(p[3]), int(p[4])
        px = int(p[5]) if len(p) >= 6 else 0
        fpx = _num(p[6]) if len(p) >= 7 else 1.0
        dx = int(p[7]) if len(p) >= 8 else 1
        return LayerSpec(
            "AC", lambda ops: L.AsymmetricConv1D(ci, co, wx, sx, px, fpx, dx, wn_dim, ops=ops),
            line)
    if p[0] == "C2":
        ci, co = int(p[1]), int(p[2])
        wx, wy, sx, sy = int(p[3]), int(p[4]), int(p[5]), int(p[6])
        px = int(p[7]) if len(p) >= 8 else 0
        py = int(p[8]) if len(p) >= 9 else 0
        dx = int(p[9]) if len(p) >= 10 else 1
        dy = int(p[10]) if len(p) >= 11 else 1
        return LayerSpec(
            "C2", lambda ops: L.Conv2D(ci, co, wx, wy, sx, sy, px, py, dx, dy,
                                       wn_dim=wn_dim, ops=ops), line)
    ci, co, wx, sx = int(p[1]), int(p[2]), int(p[3]), int(p[4])
    px = int(p[5]) if len(p) >= 6 else 0
    dx = int(p[6]) if len(p) >= 7 else 1
    cb = bool(int(p[7])) if len(p) >= 8 else True
    cg = int(p[8]) if len(p) >= 9 else 1
    return LayerSpec(
        "C", lambda ops: L.Conv2D(ci, co, wx, 1, sx, 1, px, 0, dx, 1, cg, cb, wn_dim, ops=ops),
        line)


def _time_pads(spec: LayerSpec) -> Optional[Tuple[int, int]]:
    """The (left, right) time pads of a zero ``PD`` that pads only AF dim 0."""
    t = spec.line.split()
    rest = [int(x) for x in t[2:]] + [0] * 8
    if _num(t[1]) == 0 and all(v == 0 for v in rest[2:8]):
        return rest[0], rest[1]
    return None


def _fold_pads(specs: List[LayerSpec]) -> List[LayerSpec]:
    out = list(specs)
    for i in range(len(out) - 1):
        if out[i].kind != "PD" or not out[i + 1].line.startswith("C2 "):
            continue
        pads = _time_pads(out[i])
        t = out[i + 1].line.split()
        wy, sy = int(t[4]), int(t[6])
        px, py, dx, dy = ([int(v) for v in t[7:11]] + [0, 0, 1, 1][len(t[7:11]):])
        if pads is None or (wy, sy, py, dx, dy) != (1, 1, 0, 1, 1) or px < 0:
            continue
        ci, co, wx, sx = int(t[1]), int(t[2]), int(t[3]), int(t[5])
        folded = (pads[0] + px, pads[1] + px)
        out[i] = LayerSpec("PD", lambda ops: L.Identity(), out[i].line)
        out[i + 1] = LayerSpec(
            "C2",
            lambda ops, ci=ci, co=co, wx=wx, sx=sx, folded=folded:
                L.Conv2D(ci, co, wx, 1, sx, 1, folded, 0, ops=ops),
            out[i + 1].line)
    return out


def _parse_res_block(lines: List[str], idx: int, n_res: int, n_skip: int
                     ) -> Tuple[LayerSpec, int]:
    """The block of a ``RES n_res n_skip`` line at ``idx`` (reference
    ``SequentialBuilder.cpp:525-599``): ``n_res`` layer lines and ``n_skip``
    ``SKIP from to [scale]`` / ``SKIPL from to n_proj [scale]`` lines, each
    ``SKIPL`` followed by its ``n_proj`` projection lines. Returns the spec
    and the number of lines it took after ``idx``."""
    layer_specs: List[LayerSpec] = []
    shortcuts = []  # (from, to, projection specs or None)
    scales = {}
    n_proj = 0
    for i in range(1, n_res + n_skip + 1):
        line = lines[idx + i + n_proj]
        toks = line.split()
        if toks[0] == "SKIP":
            f, t = int(toks[1]), int(toks[2])
            shortcuts.append((f, t, None))
            if len(toks) == 4:
                scales[t] = float(toks[3])
        elif toks[0] == "SKIPL":
            f, t, npl = int(toks[1]), int(toks[2]), int(toks[3])
            proj = [_parse_one(lines[idx + i + n_proj + j].split(),
                               lines[idx + i + n_proj + j]) for j in range(1, npl + 1)]
            shortcuts.append((f, t, proj))
            if len(toks) == 5:
                scales[t] = float(toks[4])
            n_proj += npl
        else:
            layer_specs.append(_parse_one(toks, line))

    def make(ops):  # new modules at each call: a repeated block has its own params
        return L.ResidualBlock(
            [s.module_fn(ops) for s in layer_specs],
            [(f, t, None if proj is None else [s.module_fn(ops) for s in proj])
             for f, t, proj in shortcuts],
            scales)

    return LayerSpec("RES", make, lines[idx]), n_res + n_skip + n_proj


def parse_arch_lines(lines: List[str]) -> List[LayerSpec]:
    """All lines, a ``RES n_res n_skip [n_blocks]`` block repeated
    ``n_blocks`` times (each repeat a layer of its own)."""
    specs: List[LayerSpec] = []
    i = 0
    while i < len(lines):
        tokens = lines[i].split()
        if tokens[0] == "RES":
            n_blocks = int(tokens[3]) if len(tokens) == 4 else 1
            spec, consumed = _parse_res_block(lines, i, int(tokens[1]), int(tokens[2]))
            specs.extend([spec] * max(1, n_blocks))
            i += consumed + 1
        else:
            specs.append(_parse_one(tokens, lines[i]))
            i += 1
    return _fold_pads(specs)


class ArchSequential(nn.Module):
    """The layer stack; children are named ``f"{i:02d}_{kind}"``."""

    def __init__(self, specs: Sequence[LayerSpec], ops: SimpleNamespace = KERNELS):
        super().__init__()
        for i, spec in enumerate(specs):
            self.add_module(f"{i:02d}_{spec.kind}", spec.module_fn(ops))

    def forward(self, x: torch.Tensor, pad_frac: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x stored 4-d, (B, 1, C, T) at entry; pad_frac (B,) the valid
        fraction of each row's frames."""
        for mod in self.children():
            if not getattr(mod, "needs_mask", False):
                x = mod(x)
                continue
            mask = None
            if pad_frac is not None:
                T = x.shape[-2]  # transformer layout (..., T, C)
                valid = torch.ceil(pad_frac * T).to(torch.int32)
                mask = torch.arange(T, device=x.device)[None, :] < valid[:, None]  # (B, T)
                # archs reach TR as (1, B, T, C) (RO 2 0 3 1); a (B, 1, T, C)
                # view puts the batch first instead
                if x.dim() == 4:
                    mask = mask[:, None] if x.shape[1] == 1 else mask[None]
            x = mod(x, mask)
        return x


class ArchModel(nn.Module):
    """Acoustic model: features (B, T, C) -> emissions (B, T_out, N) and
    their lengths ``ceil(pad_frac * T_out)``, pad_frac = feat_len / T."""

    def __init__(self, specs: Sequence[LayerSpec], n_label: int,
                 force_label_dim: bool = True, ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.n_label = n_label
        self.force_label_dim = force_label_dim
        self.seq = ArchSequential(specs, ops)

    def forward(self, feats: torch.Tensor, feat_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``generator`` feeds the SpecAugment layers in training mode; dropout
        draws from the device's global generator."""
        B, T, C = feats.shape
        for mod in self.seq.children():
            if isinstance(mod, L.SpecAugmentLayer):
                mod.generator = generator
        if feat_len is None:
            feat_len = torch.full((B,), T, dtype=torch.int32, device=feats.device)
        # a true division on the card as on the CPU: CUDA divides by a host
        # scalar as a product with its reciprocal, up to an ulp off, which
        # can move ceil(pad_frac * T_out) by a frame
        pad_frac = feat_len.float() / torch.full_like(feat_len, T, dtype=torch.float32)
        # (B, T, C) -> AF (T, C, 1, B) == stored (B, 1, C, T)
        y = self.seq(feats.transpose(1, 2)[:, None], pad_frac)
        # canonicalize to (B, T_out, N), anchored on B (see the JAX ArchModel)
        sq = [d for d in y.shape if d != 1]
        if len(sq) == 3 and sq[0] == B:
            y = y.reshape(sq)
        elif len(sq) == 2 and B == 1:
            y = y.reshape((1,) + tuple(sq))
        else:
            y = y.reshape((B, -1, self.n_label))
        if y.shape[0] != B:
            raise ValueError(f"unexpected arch output shape {tuple(y.shape)}")
        if self.force_label_dim and y.shape[-1] != self.n_label:
            y = y.reshape((B, -1, self.n_label))
        out_len = torch.ceil(pad_frac * y.shape[1]).to(torch.int32)
        return y, out_len


def build_arch_module(arch_path: str, n_feat: int, n_label: int,
                      force_label_dim: bool = True,
                      ops: SimpleNamespace = KERNELS) -> ArchModel:
    lines = parse_arch_file(arch_path, n_feat, n_label)
    return ArchModel(parse_arch_lines(lines), n_label, force_label_dim, ops)


def output_width(arch_path: str, n_feat: int, n_label: int, frames: int = 512) -> int:
    """The width of what the arch emits for ``frames`` frames (its last axis,
    the label dim left as the arch makes it), from a forward on the meta
    device: flax infers a consumer's input width from it the same way."""
    from ..kernels import PLAIN

    with torch.device("meta"):
        model = build_arch_module(arch_path, n_feat, n_label, force_label_dim=False, ops=PLAIN)
        return int(model.eval()(torch.zeros(1, frames, n_feat))[0].shape[-1])


def build_arch_from_lines(lines: Sequence[str], n_label: int,
                          ops: SimpleNamespace = KERNELS) -> ArchModel:
    return ArchModel(parse_arch_lines(list(lines)), n_label, ops=ops)
