"""The acoustic models of the configurations, from their arch lines, in plain
PyTorch.

The arch language is flashlight's (``SequentialBuilder``). Supported here are
the lines the configurations use: ``V``, ``SAUG``, ``PD`` (before a ``C2``),
``C2``, ``WN 3 C``, ``R``, ``GLU``, ``DO``, ``LN``, ``M``, ``TDS``, ``RO``,
``L`` and ``TR``. Activations are held as (B, T, F, C): flashlight's
(T, F, C, B) array. After ``RO`` they are (B, T, D), D = F * C with C
fastest.

Layers, as the published descriptions have them:
  * ``SAUG tWarpW fMaskF nFMask tMaskT tMaskP nTMask``: SpecAugment over the
    whole padded length, in training only; time warping is not applied.
  * ``C2 in out wx wy sx sy px py``: a convolution over time, ``PD`` pads
    (left, right) folded in; weight (out, in, 1, wx).
  * ``WN 3 C in out wx sx px``: that convolution with the weight
    ``g * v / |v|`` (norm per output channel); ``px = -1`` pads SAME.
  * ``LN 1 2``: LayerNorm over (F, C) of each frame, one scalar gain and bias,
    eps 1e-5.
  * ``TDS c w f dropout inner rpad 0`` (Hannun et al. 2019): x = LN(x +
    DO(ReLU(conv_time(x)))), then x = LN(x + DO(W2 DO(ReLU(W1 x)))), each LN
    per frame; the linears read and write the channel-major (c * F + f)
    order of their weights; ``rpad`` right pad of the conv (w - 1 - rpad
    left).
  * ``TR d mlp heads bptt dropout layerdrop`` (post-LN, Vaswani et al. with
    relative positions): h = LN(x + f * DO(MHSA(x))), out = LN(h + f *
    DO(W2 ReLU(W1 h))), f = 0 with probability ``layerdrop``; scores q.k / sqrt(Dh)
    plus q.P[j - i + bptt] / sqrt(Dh), padded keys masked, dropout on the
    probabilities.

Dropout draws: a training step replays the random draws of the program's
step from its seed through the same library calls (``F.dropout`` on tensors
of the program's compute dtype, shape and memory layout, ``torch.rand`` for
layerdrop, ``torch.randint`` for the attention's mask seed, in the program's
order), and the attention's keep mask from its documented counter hash. So
both sides drop the same units. The layouts: a ``DO`` line's input is held
channels last, (B, C, F, T) over memory (B, T, F, C) (the program's time
convs write that order, and a library convolution keeps it from its
input); a TDS block's and a TR layer's dropouts take contiguous tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .numerics import EXACT, Precision

NEG = -1e30
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Layer:
    index: int
    kind: str
    a: tuple  # the line's arguments, as parsed

    @property
    def prefix(self) -> str:
        """The program's parameter prefix for this line."""
        return f"seq.{self.index:02d}_{self.kind}"


def _num(s: str):
    v = float(s)
    return int(v) if v.is_integer() and "." not in s else v


def parse_arch(lines: List[str], n_feat: int, n_label: int) -> List[Layer]:
    """Arch lines (comments and blanks dropped, NFEAT/NLABEL substituted)."""
    body = []
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if line:
            body.append(line.replace("NFEAT", str(n_feat)).replace("NLABEL", str(n_label)))
    layers = []
    for i, line in enumerate(body):
        t = line.split()
        if t[0] == "WN":
            layers.append(Layer(i, t[2], ("wn", int(t[1])) + tuple(_num(x) for x in t[3:])))
        else:
            layers.append(Layer(i, t[0], tuple(_num(x) for x in t[1:])))
    return layers


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max(0, (out - 1) * s + k - n)
    return total // 2, total - total // 2


@dataclasses.dataclass
class Site:
    """One random draw of the program's step, in order: ``dropout`` (the
    program's tensor: logical ``size``, made as ``torch.ones(memory)``
    permuted by ``perm``), ``layerdrop`` or ``seed``."""
    kind: str
    rate: float = 0.0
    memory: Tuple[int, ...] = ()
    perm: Optional[Tuple[int, ...]] = None
    to_mine: Optional[Tuple[int, ...]] = None  # the mask's permutation into my layout
    shape: Tuple[int, ...] = ()  # the mask as the reference applies it


class Model:
    """An arch's forward (and, under autograd, backward) on the parameter
    dict ``params`` (the program's names; the linears' weights (in, out))."""

    def __init__(self, lines: List[str], n_feat: int, n_label: int):
        self.layers = parse_arch(lines, n_feat, n_label)
        self.n_label = n_label
        self.n_feat = n_feat
        # a ``C2`` right after a ``PD`` takes its time pads
        self.pads: Dict[int, Tuple[int, int]] = {}
        for a, b in zip(self.layers, self.layers[1:]):
            if a.kind == "PD" and b.kind == "C2":
                value, lp, rp = a.a[0], a.a[1], a.a[2]
                if value != 0 or any(a.a[3:]):
                    raise ValueError(f"PD {a.a}: only zero time pads before a C2")
                self.pads[b.index] = (lp, rp)

    # ------------------------------------------------------------------
    # shapes and the random draws of a step
    # ------------------------------------------------------------------
    def _conv_out(self, lay: Layer, T: int) -> Tuple[int, int, Tuple[int, int]]:
        if lay.kind == "C2":
            ci, co, wx, wy, sx, sy, px = lay.a[:7]
            py = lay.a[7] if len(lay.a) > 7 else 0
            if (wy, sy, py) != (1, 1, 0) or len(lay.a) > 8 and tuple(lay.a[8:]) != (1, 1):
                raise ValueError(f"C2 {lay.a}: a conv over time only")
            lp, rp = self.pads.get(lay.index, (0, 0))
            pads = _same(T, wx, sx) if px == -1 else (lp + px, rp + px)
        else:  # WN 3 C in out wx sx px
            _, _, ci, co, wx, sx, px = lay.a
            pads = _same(T, wx, sx) if px == -1 else (px, px)
        return co, (T + pads[0] + pads[1] - wx) // sx + 1, pads

    def sites(self, B: int, T: int, training: bool) -> List[Site]:
        """The program's random draws of one training forward, in order, for
        a batch of B rows and T feature frames."""
        out: List[Site] = []
        if not training:
            return out
        F_, C = self.n_feat, 1
        layout = "tfc"
        D = 0
        for lay in self.layers:
            k = lay.kind
            if k == "V" and layout == "tfc":
                F_, C = lay.a[1], lay.a[2]
            elif k in ("C2", "C"):
                C, T, _ = self._conv_out(lay, T)
            elif k == "GLU":
                C //= 2
            elif k == "M":
                T = -(-T // lay.a[2])
            elif k == "DO":  # (B, C, F, T) over memory (B, T, F, C): channels last
                out.append(Site("dropout", lay.a[0], (B, T, F_, C), (0, 3, 2, 1),
                                (0, 3, 2, 1), (B, T, F_, C)))
            elif k == "TDS":
                c, w, f, rate = lay.a[:4]
                inner = (lay.a[4] if len(lay.a) > 4 else 0) or c * f
                Dm = c * f
                out += [Site("dropout", rate, (B, T, Dm), None, None, (B, T, f, c)),
                        Site("dropout", rate, (B * T, inner), None, None, (B, T, inner)),
                        Site("dropout", rate, (B * T, Dm), None, None, (B, T, f, c))]
            elif k == "RO":
                layout, D = "btd", F_ * C
            elif k == "L" and layout == "btd":
                D = lay.a[1]
            elif k == "TR":
                d, _, _, _, rate = lay.a[:5]
                ld = lay.a[5] if len(lay.a) > 5 else 0.0
                if ld > 0:
                    out.append(Site("layerdrop", ld))
                if rate > 0:
                    out.append(Site("seed", rate))
                    out += [Site("dropout", rate, (1, B, T, d), None, None, (B, T, d))] * 2
        return out

    def draw(self, sites: List[Site], seed: int, dtype: torch.dtype, device) -> list:
        """The draws of ``sites`` after ``torch.manual_seed(seed)``, as the
        program's step makes them: keep masks (bool, in this module's layout),
        layerdrop scales, attention seeds."""
        torch.manual_seed(seed)
        out = []
        for s in sites:
            if s.kind == "dropout":
                t = torch.ones(s.memory, dtype=dtype, device=device)
                if s.perm is not None:
                    t = t.permute(s.perm)
                keep = F.dropout(t, s.rate, True) != 0
                del t
                if s.to_mine is not None:
                    keep = keep.permute(s.to_mine)
                out.append(keep.reshape(s.shape).contiguous())
            elif s.kind == "layerdrop":
                out.append(float(torch.rand((), device=device) >= s.rate))
            else:
                out.append(int(torch.randint(0, 2 ** 31 - 1, (1,))))
        return out

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params: Dict[str, torch.Tensor], feats: torch.Tensor,
                flen: torch.Tensor, T_full: int, rows: slice, draws: Optional[list] = None,
                saug_gen: Optional[torch.Generator] = None, training: bool = False,
                prec: Precision = EXACT):
        """feats (b, T, n_feat) float32 of the batch's ``rows`` (a slice of
        the full batch, whose padded length is ``T_full`` = T), flen (b,).
        ``draws``: the step's draws for the full batch (training); the
        SpecAugment layer's keep mask comes from ``saug_gen`` drawn for the
        full batch beforehand (``saug_keep``). Returns (emissions (b, T', N)
        float32, lengths (b,))."""
        x = feats[..., None]  # (b, T, F=n_feat, C=1)
        b = x.shape[0]
        pad_frac = flen.float() / torch.full_like(flen, T_full, dtype=torch.float32)
        di = iter(draws or [])
        layout = "tfc"
        for lay in self.layers:
            k, p = lay.kind, lay.prefix
            if k == "V":
                if layout == "tfc":
                    x = x.reshape(b, x.shape[1], lay.a[1], lay.a[2])
            elif k == "SAUG":
                if training:
                    keep = self.saug_keep_rows[rows]
                    x = x * keep.to(x.device).reshape(x.shape).to(x.dtype)
            elif k == "PD":
                pass  # folded into the next C2
            elif k in ("C2", "C"):
                x = self._conv(lay, params, x, prec)
            elif k == "R":
                x = torch.relu(x)
            elif k == "GLU":
                c = x.shape[-1] // 2
                x = x[..., :c] * torch.sigmoid(x[..., c:])
            elif k == "DO":
                x = _apply(x, next(di), lay.a[0], rows) if training else x
            elif k == "LN":
                x = _ln(x, (2, 3), params[p + ".weight"], params[p + ".bias"])
            elif k == "M":
                wx, wy, sx, sy = lay.a[:4]
                if (wx, wy, sy) != (1, 1, 1):
                    raise ValueError(f"M {lay.a}: only a stride over time")
                x = x[:, ::sx]
            elif k == "TDS":
                x = self._tds(lay, params, x, di, rows, training, prec)
            elif k == "RO":
                if tuple(lay.a) not in ((2, 1, 0, 3), (2, 0, 3, 1)):
                    raise ValueError(f"RO {lay.a}: not a reorder these archs use")
                x = x.reshape(b, x.shape[1], -1)
                layout = "btd"
            elif k == "L":
                x = prec.mm(x, params[p + ".weight"]) + params[p + ".bias"]
            elif k == "TR":
                valid = torch.ceil(pad_frac * x.shape[1]).long()
                mask = torch.arange(x.shape[1], device=x.device)[None, :] < valid[:, None]
                x = self._tr(lay, params, x, mask, di, rows, training, prec)
            else:
                raise ValueError(f"arch line {k} is not in the reference")
        if layout != "btd":
            raise ValueError("the arch never reached (B, T, D)")
        return x, torch.ceil(pad_frac * x.shape[1]).long()

    def saug_keep(self, B: int, T: int, generator: torch.Generator) -> None:
        """Draw the arch's SpecAugment masks for the full batch (B, T, n_feat),
        after the flag-driven SpecAugment drew from the same generator."""
        self.saug_keep_rows = None
        for lay in self.layers:
            if lay.kind != "SAUG":
                continue
            from .frontend import specaugment_keep
            a = lay.a  # tWarpW fMaskF nFMask tMaskT tMaskP nTMask, as flashlight reads them
            f_width, n_f, t_width, t_share, n_t = a[1], a[2], a[3], a[4], a[5]
            self.saug_keep_rows = specaugment_keep(B, T, self.n_feat, generator, n_f,
                                                   f_width, n_t, t_width, t_share)

    def _conv(self, lay: Layer, params, x, prec: Precision):
        p = lay.prefix
        co, _, pads = self._conv_out(lay, x.shape[1])
        if lay.kind == "C2":
            w = params[p + ".weight"]
            sx = lay.a[4]
        else:
            v, g = params[p + ".v"], params[p + ".g"]
            w = g * v / torch.sqrt((v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
            sx = lay.a[5]
        xn = F.pad(x.permute(0, 3, 2, 1), (pads[0], pads[1]))  # (b, C, F, T + pads)
        y = prec.conv2d(xn, w, params[p + ".bias"], stride=(1, sx))
        return y.permute(0, 3, 2, 1)

    def _tds(self, lay: Layer, params, x, di, rows, training, prec: Precision):
        c, w, f, rate = lay.a[:4]
        rpad = lay.a[5] if len(lay.a) > 5 else -1
        if len(lay.a) > 6 and lay.a[6]:
            raise ValueError("TDS: LayerNorm over time is not in the reference")
        p = lay.prefix
        pads = (w - 1 - rpad, rpad) if rpad >= 0 else ((w - 1) // 2, w - 1 - (w - 1) // 2)
        b, T = x.shape[:2]
        xn = F.pad(x.permute(0, 3, 2, 1), pads)
        y = torch.relu(prec.conv2d(xn, params[p + ".conv.weight"], params[p + ".conv.bias"]))
        y = y.permute(0, 3, 2, 1)
        if training:
            y = _apply(y, next(di), rate, rows)
        z = _ln(x + y, (2, 3), params[p + ".ln1.weight"], params[p + ".ln1.bias"])
        zc = z.permute(0, 1, 3, 2).reshape(b, T, c * f)  # channel-major
        h = torch.relu(prec.mm(zc, params[p + ".lin1.weight"]) + params[p + ".lin1.bias"])
        if training:
            h = _apply(h, next(di), rate, rows)
        h = prec.mm(h, params[p + ".lin2.weight"]) + params[p + ".lin2.bias"]
        h = h.reshape(b, T, c, f).permute(0, 1, 3, 2)
        if training:
            h = _apply(h, next(di), rate, rows)
        return _ln(z + h, (2, 3), params[p + ".ln2.weight"], params[p + ".ln2.bias"])

    def _tr(self, lay: Layer, params, x, mask, di, rows, training, prec: Precision):
        d, _, H, bptt, rate = lay.a[:5]
        ld = lay.a[5] if len(lay.a) > 5 else 0.0
        p = lay.prefix
        f = next(di) if training and ld > 0 else 1.0
        seed = next(di) if training and rate > 0 else None
        b, T, _ = x.shape
        Dh = d // H
        if T > bptt:
            raise ValueError("TR: T beyond the relative-position window")

        def lin(name, a):
            return prec.mm(a, params[f"{p}.{name}.weight"]) + params[f"{p}.{name}.bias"]

        q = (lin("attn.wq", x) / math.sqrt(Dh)).reshape(b, T, H, Dh)
        kk = lin("attn.wk", x).reshape(b, T, H, Dh)
        v = lin("attn.wv", x).reshape(b, T, H, Dh)
        win = params[p + ".attn.pos_emb"][bptt - T + 1: bptt + T]  # offsets -(T-1)..T-1
        scores = prec.einsum("bthd,bshd->bhts", q, kk)
        qp = prec.einsum("bthd,rd->bhtr", q, win)
        ar = torch.arange(T, device=x.device)
        idx = (ar[None, :] - ar[:, None] + T - 1).expand(b, H, T, T)
        scores = scores + qp.gather(-1, idx)
        scores = scores.masked_fill(~mask[:, None, None, :], NEG)
        pr = torch.softmax(scores, dim=-1)
        if training and rate > 0:
            keep = attention_keep(seed, torch.arange(rows.start, rows.start + b,
                                                     device=x.device), H, T, rate)
            pr = torch.where(keep, pr / (1.0 - rate), torch.zeros((), device=x.device))
        a = lin("attn.wf", prec.einsum("bhts,bshd->bthd", pr, v).reshape(b, T, d))
        if training and rate > 0:
            a = _apply(a, next(di), rate, rows)
        h = _ln(x + f * a, (2,), params[p + ".norm1.weight"], params[p + ".norm1.bias"])
        m = lin("w2", torch.relu(lin("w1", h)))
        if training and rate > 0:
            m = _apply(m, next(di), rate, rows)
        return _ln(h + f * m, (2,), params[p + ".norm2.weight"], params[p + ".norm2.bias"])


def _apply(x: torch.Tensor, keep: torch.Tensor, rate: float, rows: slice) -> torch.Tensor:
    k = keep[rows].to(x.device).reshape(x.shape)
    return torch.where(k, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _ln(x: torch.Tensor, dims, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * w + b


def attention_keep(seed: int, batch_rows: torch.Tensor, H: int, T: int,
                   rate: float) -> torch.Tensor:
    """The attention dropout's keep mask (b, H, T, T) for the batch rows
    ``batch_rows``: a murmur3 finalizer of the counter i * R + j (R = T
    rounded up to 16) plus the seed's and the (row, head)'s mix, kept where
    the 32-bit hash is under (1 - rate) * 2^32."""
    dev = batch_rows.device
    R = -(-max(T, 16) // 16) * 16
    prog = (batch_rows[:, None] * H + torch.arange(H, device=dev)[None, :]).long()
    mix = ((int(seed) & _M32) * 0x9E3779B9 & _M32) + (prog * 0x85EBCA6B & _M32)
    i = torch.arange(T, device=dev, dtype=torch.int64)[:, None]
    j = torch.arange(T, device=dev, dtype=torch.int64)[None, :]
    x = (i * R + j)[None, None] + mix[:, :, None, None]
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x < min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
