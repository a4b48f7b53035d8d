"""Chunked streaming inference of the PyTorch port (``wav2letter_tpu_torch.
inference``) on the CPU, against the JAX package's (``wav2letter_tpu.
inference``) and against the port's own batch forward.

The same seeded numpy inputs go through both packages. Weights are made by a
seeded port ``ArchModel``; the JAX streaming network takes them as a flax
tree (``params_to_jax_tree``), and the port's takes the JAX network's flat
streaming params, the function that carries weights across. Archs: the JAX
test's ``STREAM_ARCH``, the flagship's structure narrowed (its PD/C2/TDS/LN/
RO/V/L lines at 16 frequencies, 30 labels) and an ``AC`` arch.

Tolerances: port against JAX 1e-5 per layer and per network (fp32 sums in
another order on both sides); port streaming against port batch 1e-4, the
bound the JAX package holds itself to (``tests/test_streaming.py``); the
CLIs' printed lines identical.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import LETTERS
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.features.frontend import FeatureParams as JaxFeatureParams
from wav2letter_tpu.inference import convert_checkpoint as jax_convert
from wav2letter_tpu.inference import load_streaming_bundle as jax_load_bundle
from wav2letter_tpu.inference.convert import build_streaming_layers as jax_layers
from wav2letter_tpu.inference.convert import build_streaming_network as jax_network
from wav2letter_tpu.inference.streaming import StreamingFeaturizer as JaxFeaturizer
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.features import FeatureParams
from wav2letter_tpu_torch.inference import (StreamingFeaturizer, StreamingNetwork,
                                            build_streaming_network, convert_checkpoint,
                                            load_streaming_bundle)
from wav2letter_tpu_torch.inference.convert import build_streaming_layers, map_params
from wav2letter_tpu_torch.models import build_arch_from_lines
from wav2letter_tpu_torch.runtime.checkpoint import (Checkpoint, params_to_jax_tree,
                                                     save_checkpoint)
from wav2letter_tpu_torch.tools.ngram_lm import train_ngram_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT = 16
NLABEL = 8
TOL_JAX = dict(rtol=1e-5, atol=1e-5)
TOL_BATCH = dict(rtol=1e-4, atol=1e-4)

STREAM_ARCH = [
    f"V -1 {NFEAT} 1 0",
    "PD 0 5 3",
    "C2 1 6 10 1 2 1 0 0",
    "R",
    "LN 1 2",
    f"TDS 6 7 {NFEAT} 0.0 0 2 0",
    f"TDS 6 7 {NFEAT} 0.0 0 2 0",
    "RO 2 1 0 3",
    f"V {6 * NFEAT} -1 1 0",
    f"L {6 * NFEAT} {NLABEL}",
    f"V {NLABEL} 0 -1 1",
]
FLAGSHIP_NLABEL = 30


def _flagship_lines():
    """``recipes/streaming_convnets/network.arch`` without SAUG, its TDS
    frequency width and NFEAT at 16: 4 PD/C2 stages (stride 8), 11 TDS
    blocks with right pads 1 and 0, LN, RO, V and L."""
    with open(os.path.join(REPO, "recipes/streaming_convnets/network.arch")) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    return [l.replace(" 80 ", f" {NFEAT} ").replace("2240", str(28 * NFEAT))
            .replace("NFEAT", str(NFEAT)).replace("NLABEL", str(FLAGSHIP_NLABEL))
            for l in lines if not l.startswith("SAUG")]


AC_NFEAT, AC_NLABEL = 12, 6
AC_ARCH = [
    f"V -1 1 {AC_NFEAT} 0",
    f"AC {AC_NFEAT} 10 5 1 -1 0.25",
    "R",
    "AC 10 10 3 1 1 0.5",
    "RO 2 0 3 1",
    f"L 10 {AC_NLABEL}",
    f"V {AC_NLABEL} 0 -1 1",
]
# arch -> (lines, n_feat, n_label, frames, features (F, C) of a chunk)
ARCHS = {
    "stream": (STREAM_ARCH, NFEAT, NLABEL, 100, "freq"),
    "flagship": (_flagship_lines(), NFEAT, FLAGSHIP_NLABEL, 144, "freq"),
    "ac": (AC_ARCH, AC_NFEAT, AC_NLABEL, 40, "chan"),
}


@pytest.fixture(scope="module")
def nets():
    """arch -> (port batch model, JAX streaming network, port streaming
    network on the CPU, features (1, T, n_feat))."""
    out = {}
    for i, (name, (lines, n_feat, n_label, T, _)) in enumerate(ARCHS.items()):
        torch.manual_seed(40 + i)
        model = build_arch_from_lines(lines, n_label).eval()
        jnet = jax_network(lines, n_feat, params_to_jax_tree(model.state_dict()))
        layers, _ = build_streaming_layers(lines, n_feat)
        net = StreamingNetwork(layers, {k: np.asarray(v) for k, v in jnet.params.items()},
                               device="cpu")
        feats = np.random.RandomState(3 + i).randn(1, T, n_feat).astype(np.float32)
        out[name] = (model, jnet, net, feats)
    return out


def _chunk(feats, layout):
    """(1, n, n_feat) -> the network's (1, n, F, C): features are the
    frequencies of one channel, or (AC) the channels of one frequency."""
    return feats[..., None] if layout == "freq" else feats[:, :, None, :]


def _stream(net, feats, chunk, layout, jax_side=False):
    """Emissions (T_out, N) of ``net`` on feats streamed ``chunk`` frames at
    a time, then ``finish``."""
    states = net.start(1)
    outs = []
    for s in range(0, feats.shape[1], chunk):
        x = _chunk(feats[:, s:s + chunk], layout)
        states, y = net.run(states, jnp.asarray(x) if jax_side else x)
        if y.shape[1]:
            outs.append(np.asarray(y))
    states, y = net.finish(states)
    if y is not None and y.shape[1]:
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)[0, :, 0, :]


def _batch(model, feats):
    with torch.no_grad():
        return model(torch.from_numpy(feats))[0][0].numpy()


# JAX streaming compiles every shape signature of the chain, which costs
# seconds a chunk size at the flagship's depth: the full set of chunk sizes
# runs on the two small archs, one of them on the narrowed flagship, whose
# every layer kind is held to JAX's below and whose stream is held to the
# port's batch forward at every chunk size
@pytest.mark.parametrize("arch,chunk", [("stream", 8), ("stream", 16), ("stream", 37),
                                        ("stream", 50), ("ac", 8), ("ac", 16), ("ac", 37),
                                        ("ac", 50), ("flagship", 50)])
def test_streaming_network_matches_jax(nets, arch, chunk):
    model, jnet, net, feats = nets[arch]
    layout = ARCHS[arch][4]
    want = _stream(jnet, feats, chunk, layout, jax_side=True)
    got = _stream(net, feats, chunk, layout)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL_JAX)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("chunk", [8, 16, 37, 50])
def test_streaming_equals_batch(nets, arch, chunk):
    """The port's stream against the port's batch forward of the same
    weights, as the JAX package holds its own (1e-4)."""
    model, _, net, feats = nets[arch]
    got = _stream(net, feats, chunk, ARCHS[arch][4])
    want = _batch(model, feats)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL_BATCH)


def _layer_cases():
    """(arch, layer index) of each stream layer kind: the first conv (C = 1,
    stride 2), a conv 16 -> 20, the stride-1 conv, TDS blocks with right
    pads 1 and 0, relu, ln, linear, and both AC convs."""
    fl = [l for l in _flagship_lines() if l.split()[0] not in ("V", "RO", "DO", "PD")]
    pick = {"C2 1 16": 0, "C2 16 20": 0, "C2 24 28": 0, "TDS 16": 0, "TDS 28": 0, "R": 0,
            "LN": 0, "L ": 0}
    cases = []
    for i, line in enumerate(fl):
        for key in pick:
            if line.startswith(key) and not pick[key]:
                pick[key] = 1
                cases.append(("flagship", i))
    return cases + [("ac", 0), ("ac", 2)]


@pytest.mark.parametrize("arch,index", _layer_cases())
def test_stream_layer_matches_jax(nets, arch, index):
    """One step of each layer kind on a seeded state and chunk, JAX's layer
    (un-jitted) against the port's: outputs and carried states at 1e-5."""
    _, jnet, net, _ = nets[arch]
    jl, layer = jax_layers(ARCHS[arch][0], ARCHS[arch][1])[0][index], net.layers[index]
    assert type(jl).__name__ == type(layer).__name__
    rng = np.random.RandomState(index)
    # the layer's input (F, C): from its state, or where it has none, the
    # (F, C) the previous layer emits, found by streaming a chunk up to it
    states = net.start(1)
    x = _chunk(np.zeros((1, 60, ARCHS[arch][1]), np.float32), ARCHS[arch][4])
    x = torch.from_numpy(x)
    for i in range(index):
        states[i], x = net.layers[i].step(states[i], x)
    shape = (1, 13) + tuple(x.shape[2:])
    chunk = rng.randn(*shape).astype(np.float32)
    state = None
    if states[index] is not None:
        state = rng.randn(*states[index].shape).astype(np.float32)
    js, jy = jl.step(jnet.params, None if state is None else jnp.asarray(state),
                     jnp.asarray(chunk))
    ps, py = layer.step(None if state is None else torch.from_numpy(state),
                        torch.from_numpy(chunk))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL_JAX)
    if state is not None:
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_map_params_matches_jax(nets):
    """The flat streaming params from a port state dict (``map_params``)
    equal the JAX package's from the same weights as a flax tree, weight
    norm folded alike."""
    model, jnet, net, feats = nets["flagship"]
    _, pmap = build_streaming_layers(ARCHS["flagship"][0], NFEAT)
    got = map_params(pmap, model.state_dict())
    assert sorted(got) == sorted(jnet.params)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(jnet.params[k]))
    direct = build_streaming_network(ARCHS["flagship"][0], NFEAT, model.state_dict(), "cpu")
    np.testing.assert_array_equal(_stream(direct, feats, 37, "freq"),
                                  _stream(net, feats, 37, "freq"))
    # a weight-normed conv: v and g folded as the JAX map_params folds them
    from wav2letter_tpu.inference.convert import map_params as jax_map_params

    lines = [f"V -1 {NFEAT} 1 0", "WN 3 C2 1 4 5 1 1 1 2 0", "R", "RO 2 1 0 3",
             f"V {4 * NFEAT} -1 1 0", f"L {4 * NFEAT} {NLABEL}", f"V {NLABEL} 0 -1 1"]
    torch.manual_seed(1)
    sd = build_arch_from_lines(lines, NLABEL).state_dict()
    _, pmap = build_streaming_layers(lines, NFEAT)
    got = map_params(pmap, sd)
    want = jax_map_params([("l1_conv", "01_C2"), ("l5_lin", "05_L")],
                          params_to_jax_tree(sd)["seq"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wn", [False, True])
def test_ac_layer_matches_jax(wn):
    """The ``AC`` line (``AsymmetricConv1D``, plain and under ``WN``) in the
    port's batch model against the JAX ArchModel with the same weights: the
    (left, right) pad split of both forms, params ``conv.weight`` (or
    ``conv.v``/``conv.g``) and ``conv.bias`` as in JAX; fp32 at 1e-5."""
    import jax

    from wav2letter_tpu.models.arch import build_arch_from_lines as jax_build

    lines = [l if not (wn and l.startswith("AC ")) else "WN 0 " + l for l in AC_ARCH]
    torch.manual_seed(3)
    model = build_arch_from_lines(lines, AC_NLABEL).eval()
    if wn:
        assert {"seq.01_AC.conv.v", "seq.01_AC.conv.g"} <= set(model.state_dict())
    layers = dict(model.seq.named_children())
    # round(0.5) is 0 in Python, as in the JAX layer: pads (2, 0), not (1, 1)
    assert layers["01_AC"].time_pads == (3, 1) and layers["03_AC"].time_pads == (2, 0)
    feats = np.random.RandomState(9).randn(2, 30, AC_NFEAT).astype(np.float32)
    want, _ = jax.jit(jax_build(lines, AC_NLABEL).apply)(
        {"params": params_to_jax_tree(model.state_dict())}, jnp.asarray(feats),
        jnp.asarray([30, 30]))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX)


# ---------------------------------------------------------------------------
# the featurizer
# ---------------------------------------------------------------------------
# Features of the first frames whose local-CMVN window holds only a few
# frames: dividing by their small std amplifies rounding (``ROADMAP.md``
# queue 3), so that there the two packages agree to 2e-3, the bound of
# ``tests/test_streaming.py`` for streaming against batch features
HEAD_FRAMES = 8


@pytest.mark.parametrize("left", [0, 300])
def test_streaming_featurizer_matches_jax(left):
    p = dict(n_filterbanks=40, local_norm_left=left)
    rng = np.random.RandomState(4 + left)
    n = 3 * 16000 + 777
    env = np.interp(np.arange(n), np.linspace(0, n, 12), rng.uniform(0.3, 1.0, 12))
    audio = (0.5 * env * rng.randn(n)).astype(np.float32)
    jf, pf = JaxFeaturizer(JaxFeatureParams(**p)), StreamingFeaturizer(FeatureParams(**p),
                                                                        device="cpu")
    js, ps = jf.start(), pf.start()
    got, want = [], []
    for s in range(0, n, 8000):  # 500 ms chunks
        js, f = jf.run(js, audio[s:s + 8000])
        want.append(f)
        ps, g = pf.run(ps, audio[s:s + 8000])
        got.append(g.numpy())
        assert g.shape == f.shape and g.dtype == torch.float32
    got, want = np.concatenate(got), np.concatenate(want)
    assert len(got) == 1 + (n - 400) // 160
    head = HEAD_FRAMES if left else 0
    np.testing.assert_allclose(got[head:], want[head:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:head], want[:head], rtol=2e-3, atol=2e-3)


def test_streaming_featurizer_equals_batch_featurizer():
    """Chunks of 500 ms against the batch featurizer (K1's plain version on
    the CPU) on the whole utterance, with the flagship's left context."""
    from wav2letter_tpu_torch.features import Featurizer

    p = FeatureParams(n_filterbanks=80, local_norm_left=300)
    audio = (0.3 * np.random.RandomState(5).randn(4 * 16000)).astype(np.float32)
    want = Featurizer(p)(torch.from_numpy(audio)[None])[0][0].numpy()
    sf = StreamingFeaturizer(p, device="cpu")
    st, got = sf.start(), []
    for s in range(0, len(audio), 8000):
        st, f = sf.run(st, audio[s:s + 8000])
        got.append(f.numpy())
    got = np.concatenate(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[HEAD_FRAMES:], want[HEAD_FRAMES:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:HEAD_FRAMES], want[:HEAD_FRAMES], rtol=2e-3, atol=2e-3)


def test_right_context_local_norm_raises():
    with pytest.raises(ValueError, match="local_norm_right"):
        StreamingFeaturizer(FeatureParams(local_norm_left=300, local_norm_right=10),
                            device="cpu")


def test_unstreamable_lines_raise():
    with pytest.raises(ValueError, match="not streamable"):
        build_streaming_layers(["V -1 16 1 0", "GLU 0"], NFEAT)
    with pytest.raises(ValueError, match="dilation"):
        build_streaming_layers(["AC 16 8 3 1 1 0.5 2"], NFEAT)


# ---------------------------------------------------------------------------
# checkpoints, bundles and the CLIs
# ---------------------------------------------------------------------------
BUNDLE_ARCH = f"""V -1 NFEAT 1 0
SAUG NFEAT 4 2 20 1.0 2
PD 0 5 3
C2 1 3 10 1 2 1 0 0
R
DO 0.1
LN 1 2
TDS 3 9 NFEAT 0.1 0 1 0
TDS 3 9 NFEAT 0.1 0 0 0
RO 2 1 0 3
V {3 * NFEAT} -1 1 0
L {3 * NFEAT} NLABEL
V NLABEL 0 -1 1
"""


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One set of seeded weights as a JAX ``W2LTPU01`` checkpoint and a port
    checkpoint; the JAX bundle of the first, the port's bundles of both; two
    utterances, a letter lexicon and a 2-gram ARPA."""
    root = str(tmp_path_factory.mktemp("stream"))
    tokens = os.path.join(root, "tokens.txt")
    with open(tokens, "w") as f:
        f.write("|\n" + "\n".join(LETTERS) + "\n")
    lexicon = os.path.join(root, "lexicon.txt")
    words = [LETTERS[i] + LETTERS[j] for i in range(4) for j in range(4)]
    with open(lexicon, "w") as f:
        f.writelines(f"{w}\t{' '.join(w)} |\n" for w in words)
    rng = np.random.RandomState(21)
    corpus = os.path.join(root, "corpus.txt")
    with open(corpus, "w") as f:
        f.writelines(" ".join(rng.choice(words, 5)) + "\n" for _ in range(40))
    lm = os.path.join(root, "lm.arpa")
    train_ngram_lm(corpus, lm, order=2)
    arch = os.path.join(root, "stream.arch")
    with open(arch, "w") as f:
        f.write(BUNDLE_ARCH)
    flags = dict(arch=arch, tokens=tokens, lexicon=lexicon, criterion="ctc", mfsc=True,
                 filterbanks=NFEAT, localnrmlleftctx=300, compute_dtype="float32")
    n_label = len(LETTERS) + 2  # the separator, the letters and the CTC blank
    torch.manual_seed(8)
    model = build_arch_from_lines(
        [l for l in BUNDLE_ARCH.replace("NFEAT", str(NFEAT)).replace(
            "NLABEL", str(n_label)).splitlines() if l], n_label)
    sd = model.state_dict()
    jax_am = os.path.join(root, "jax_model.bin")
    jax_save(jax_am, JaxCheckpoint(
        config=JaxConfig(**flags).serialize(), epoch=1, updates=10,
        model_params=params_to_jax_tree(sd),
        model_state={}, crit_params={}, opt_state={}, crit_opt_state={}, extra={}))
    port_am = os.path.join(root, "port_model.pt")
    save_checkpoint(port_am, Checkpoint(Config(**flags).serialize(), 1, 10, sd))
    paths = dict(root=root, lexicon=lexicon, lm=lm, jax_am=jax_am, port_am=port_am,
                 jax_bundle=jax_convert(jax_am, os.path.join(root, "jax.stream")),
                 port_from_jax=convert_checkpoint(jax_am, os.path.join(root, "pj.stream")),
                 port_from_port=convert_checkpoint(port_am, os.path.join(root, "pp.stream")))
    audio = []
    for i, secs in enumerate((2.3, 1.7)):
        n = int(16000 * secs)
        env = np.interp(np.arange(n), np.linspace(0, n, 8), rng.uniform(0.4, 1.0, 8))
        path = os.path.join(root, f"utt{i}.npy")
        np.save(path, (0.5 * env * rng.randn(n)).astype(np.float32))
        audio.append(path)
    paths["audio"] = audio
    return paths


def _stream_audio(net, featp, path, featurizer_cls, device=None):
    from wav2letter_tpu_torch.data.audio import load_audio

    audio = load_audio(path, 16000)
    sf = featurizer_cls(featp) if device is None else featurizer_cls(featp, device)
    fs, states, outs = sf.start(), net.start(1), []
    for s in range(0, len(audio), 8000):
        fs, feats = sf.run(fs, audio[s:s + 8000])
        if len(feats):
            x = feats[None, :, :, None]
            states, y = net.run(states, jnp.asarray(x) if device is None else x)
            if y.shape[1]:
                outs.append(np.asarray(y))
    states, y = net.finish(states)
    if y is not None and y.shape[1]:
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)[0, :, 0, :]


def test_jax_bundle_gives_jax_emissions(bundles):
    """A JAX ``W2LSTRM1`` bundle loaded by the port streams the JAX
    package's emissions (features and network, 500 ms chunks)."""
    jnet, jfeat, jmeta = jax_load_bundle(bundles["jax_bundle"])
    net, feat, meta = load_streaming_bundle(bundles["jax_bundle"], device="cpu")
    assert dataclass_fields(feat) == dataclass_fields(jfeat)
    assert [str(t) for t in meta["tokens"]] == [str(t) for t in jmeta["tokens"]]
    for path in bundles["audio"]:
        want = _stream_audio(jnet, jfeat, path, JaxFeaturizer)
        got = _stream_audio(net, feat, path, StreamingFeaturizer, "cpu")
        assert got.shape == want.shape
        # the first output frames see the first features, whose short
        # local-CMVN windows amplify rounding (HEAD_FRAMES features, a
        # receptive field of ~20 frames after the stride-2 conv)
        np.testing.assert_allclose(got[12:], want[12:], **TOL_JAX)
        np.testing.assert_allclose(got[:12], want[:12], rtol=2e-3, atol=2e-3)


def dataclass_fields(fp):
    return (fp.sample_rate, fp.frame_size_ms, fp.frame_stride_ms, fp.n_filterbanks,
            fp.local_norm_left, fp.local_norm_right)


def test_convert_jax_and_port_checkpoints_stream_alike(bundles):
    """``convert_checkpoint`` of the JAX ``W2LTPU01`` file and of the port's
    checkpoint of the same weights: the same bundle contents, equal streams,
    and those of the JAX bundle."""
    nets = {k: load_streaming_bundle(bundles[k], device="cpu")
            for k in ("port_from_jax", "port_from_port", "jax_bundle")}
    (a, fa, ma), (b, fb, mb) = nets["port_from_jax"], nets["port_from_port"]
    assert ma["arch_lines"] == mb["arch_lines"] and ma["tokens"] == mb["tokens"]
    assert sorted(ma["params"]) == sorted(mb["params"])
    for k in ma["params"]:
        torch.testing.assert_close(ma["params"][k], mb["params"][k], rtol=0, atol=0)
    path = bundles["audio"][0]
    ya = _stream_audio(a, fa, path, StreamingFeaturizer, "cpu")
    yb = _stream_audio(b, fb, path, StreamingFeaturizer, "cpu")
    yj = _stream_audio(*nets["jax_bundle"][:2], path, StreamingFeaturizer, "cpu")
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(ya, yj)


def _cli_args(bundles, bundle, audio):
    opts = os.path.join(bundles["root"], "opts.json")
    with open(opts, "w") as f:
        f.write('{"beamSize": 20, "beamSizeToken": 5, "beamThreshold": 25, '
                '"lmWeight": 1.0, "wordScore": 0.5}')
    return [f"--bundle={bundle}", f"--input_audio_file={audio}",
            f"--lexicon_file={bundles['lexicon']}", f"--language_model_file={bundles['lm']}",
            f"--decoder_options_file={opts}"]


def test_streaming_asr_cli_prints_the_jax_lines(bundles, capsys, monkeypatch):
    """``cli.streaming_asr --device=cpu`` prints the lines of the JAX
    ``cli/streaming_asr.py`` (run here, in this process) on the same bundle
    and audio, with no JAX module loaded in the port's process."""
    import runpy

    args = _cli_args(bundles, bundles["jax_bundle"], bundles["audio"][1])
    monkeypatch.setattr(sys, "argv", ["streaming_asr.py", *args])
    runpy.run_path(os.path.join(REPO, "cli", "streaming_asr.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    code = ("import runpy, sys; sys.argv = ['streaming_asr'] + sys.argv[1:]; "
            "runpy.run_module('wav2letter_tpu_torch.cli.streaming_asr', run_name='__main__');"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'wav2letter_tpu'));"
            "assert not bad, bad")
    got = subprocess.run([sys.executable, "-c", code, *args, "--device=cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    lines = got.stdout.splitlines()
    assert lines == want
    # a chunk that decodes no new word leaves its line open for the next
    assert "[final]" in lines[-1] and lines[-1].split("[final]")[1].split()


def test_streaming_asr_cli_needs_a_card_by_default(bundles):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from wav2letter_tpu_torch.cli.streaming_asr import main

    with pytest.raises(RuntimeError, match="--device=cpu"):
        main(_cli_args(bundles, bundles["port_from_port"], bundles["audio"][0]))


def test_multi_cli_matches_single_streams(bundles, capsys):
    """``cli.streaming_asr_multi`` with 2 threads on 3 files prints, for each,
    the words of a single thread streaming it alone."""
    from wav2letter_tpu_torch.cli import streaming_asr_multi

    files = bundles["audio"] + bundles["audio"][:1]
    base = [f"--bundle={bundles['port_from_port']}", f"--lexicon_file={bundles['lexicon']}",
            f"--language_model_file={bundles['lm']}", "--beam_size=20",
            "--lm_weight=1", "--word_score=0.5", "--device=cpu"]
    out = {}
    for n in (1, 2):
        streaming_asr_multi.main(base + [f"--input_files={','.join(files)}",
                                         f"--max_num_threads={n}"])
        out[n] = sorted(capsys.readouterr().out.splitlines())
    assert len(out[1]) == 3 and out[2] == out[1]
    for path in bundles["audio"]:
        streaming_asr_multi.main(base + [f"--input_files={path}", "--max_num_threads=1"])
        single = capsys.readouterr().out.splitlines()
        assert single and all(line in out[2] for line in single)


def test_interactive_cli_prints_the_words_of_streaming_asr(bundles, capsys):
    """``cli.streaming_asr_interactive`` on PCM16 from stdin prints, chunk by
    chunk, the new words ``cli.streaming_asr`` prints for the same samples
    with the same decoder (both prune to 250 ms), then the final ones."""
    import io

    from wav2letter_tpu_torch.cli import streaming_asr, streaming_asr_interactive

    audio = np.clip(np.load(bundles["audio"][0]), -1, 1)
    pcm = (audio * 32767).astype(np.int16)
    path = os.path.join(bundles["root"], "pcm.npy")
    np.save(path, pcm.astype(np.float32) / 32768.0)
    streaming_asr_interactive.main(
        [f"--bundle={bundles['port_from_port']}", f"--lexicon_file={bundles['lexicon']}",
         f"--language_model_file={bundles['lm']}", "--beam_size=20", "--beam_threshold=25",
         "--lm_weight=1", "--word_score=0.5", "--device=cpu"],
        stdin=io.BytesIO(pcm.tobytes()))
    got = capsys.readouterr().out.splitlines()
    opts = os.path.join(bundles["root"], "opts_interactive.json")
    with open(opts, "w") as f:
        f.write('{"beamSize": 20, "beamThreshold": 25, "lmWeight": 1.0, "wordScore": 0.5}')
    streaming_asr.main(
        [f"--bundle={bundles['port_from_port']}", f"--input_audio_file={path}",
         f"--lexicon_file={bundles['lexicon']}", f"--language_model_file={bundles['lm']}",
         f"--decoder_options_file={opts}", "--device=cpu"])
    out = capsys.readouterr().out
    chunks, final = out.split("[final]")
    # each chunk prints "[t0 .. t1 ms] " and then its new words, if any
    want = [w.strip() for w in re.split(r"\[ *-?\d+ \.\. *-?\d+ ms\]", chunks) if w.strip()]
    final_words = final.split()
    printed = " ".join(want).split()
    want += [" ".join(final_words[len(printed):])] if final_words[len(printed):] else []
    assert got == want
