"""The flashlight (cereal) checkpoint reader of the PyTorch port
(``tools/flashlight_import.py`` and the third format of
``runtime/checkpoint.py::load_checkpoint``) against the JAX package's, on
files forged (``tests/util_torch_flashlight.py``) in the layout that
``tests/test_flashlight_import.py`` documents: the version string, a cfg map
holding the gflags, then the AF arrays in ``params()`` order with unknown
bytes interleaved.

* through both packages' ``load_checkpoint``: the port's state equals
  ``convert_jax_params`` of JAX's tree, the forward JAX's (1e-4), the config
  JAX's, and an ASG checkpoint's transitions the forged ones;
* through the CLI: ``cli.test --device=cpu --am=fl.bin`` gives JAX's
  ``run_test`` hypotheses and WER;
* an arch file with comments names its layers as the arch builder does;
* a file that is no checkpoint raises, naming its path;
* the byte-compat fixture skips, as JAX's test does, until one is committed.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import ARCH, NFEAT, _dataset, _hyps
from tests.util_torch_flashlight import forge_flashlight
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.runtime.checkpoint import load_checkpoint as jax_load
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.models.arch import build_arch_module
from wav2letter_tpu_torch.runtime.checkpoint import convert_jax_params, load_checkpoint
from wav2letter_tpu_torch.tools.flashlight_import import verify_fixture

N_LABEL = 6  # "|", a, b, c, d and the CTC blank (``_dataset``'s tokens)


@pytest.fixture(scope="module")
def forged(tmp_path_factory):
    """The slice's narrow streaming-convnets arch at JAX's seeded weights,
    forged as a flashlight checkpoint whose gflags name the arch, tokens and
    lexicon; and its data."""
    root = tmp_path_factory.mktemp("flashlight")
    lst, tokens, lexicon = _dataset(str(root / "data"), n_utts=6, seed=13)
    arch = root / "tiny.arch"
    arch.write_text(ARCH)
    model = jax_build(str(arch), NFEAT, N_LABEL)
    params = jax.device_get(jax.jit(model.init)(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 64, NFEAT)), jnp.asarray([64])))
    state = convert_jax_params(params["params"])
    gflags = {"ctc": "", "asg": ""}
    for crit in gflags:
        gflags[crit] = "\n".join([
            f"--criterion={crit}", "--mfsc=true", f"--filterbanks={NFEAT}",
            "--localnrmlleftctx=300", f"--arch={arch}", f"--tokens={tokens}",
            f"--lexicon={lexicon}", "--wordseparator=|", "--compute_dtype=float32",
            "--pad_multiple=16", "--nupdates=12", "--epoch=2"]) + "\n"
    trans = np.random.RandomState(4).randn(N_LABEL - 1, N_LABEL - 1).astype(np.float32)
    forge_flashlight(root / "ctc.bin", state, str(arch), gflags["ctc"])
    forge_flashlight(root / "asg.bin", state, str(arch), gflags["asg"], extra=[trans])
    return dict(root=root, arch=str(arch), lst=lst, state=state, trans=trans)


@pytest.mark.parametrize("crit", ["ctc", "asg"])
def test_load_checkpoint_matches_jax(forged, crit):
    path = str(forged["root"] / f"{crit}.bin")
    want = jax_load(path)
    got = load_checkpoint(path)
    assert got.extra == {"flashlight_version": "0.3"} == want.extra
    assert (got.epoch, got.updates) == (want.epoch, want.updates) == (2, 12)
    ref = convert_jax_params(want.model_params)
    assert set(got.state_dict) == set(ref) == set(forged["state"])
    for k, v in ref.items():
        assert torch.equal(got.state_dict[k], v), k
    jcfg, cfg = JaxConfig.deserialize(want.config), Config.deserialize(got.config)
    for k in ("criterion", "filterbanks", "arch", "tokens", "compute_dtype", "pad_multiple"):
        assert cfg.get(k) == jcfg.get(k), k
    if crit == "asg":  # (JAX's reader drops them: it wants a 2-dim scanned array)
        assert set(got.crit_state_dict) == {"transitions"}
        np.testing.assert_array_equal(got.crit_state_dict["transitions"].numpy(),
                                      forged["trans"])
    else:
        assert got.crit_state_dict == {} and not want.crit_params

    x = np.random.RandomState(5).randn(2, 64, NFEAT).astype(np.float32)
    xl = np.asarray([64, 48])
    jmodel = jax_build(forged["arch"], NFEAT, N_LABEL)
    jy, jl = jmodel.apply({"params": want.model_params}, jnp.asarray(x), jnp.asarray(xl))
    model = build_arch_module(forged["arch"], NFEAT, N_LABEL)
    model.load_state_dict(got.state_dict, strict=True)
    model.eval()
    with torch.no_grad():
        y, yl = model(torch.from_numpy(x), torch.from_numpy(xl))
    assert yl.tolist() == np.asarray(jl).tolist()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)


def test_cli_test_matches_jax(forged):
    """``cli.test --device=cpu --am=fl.bin`` against JAX's ``run_test`` on
    the same file: the same hypotheses (but where the emissions' top two
    are within rounding, see ``test_torch_slice.py``) and WER."""
    from wav2letter_tpu_torch.cli.test import main

    root, am, lst = forged["root"], str(forged["root"] / "ctc.bin"), forged["lst"]
    jcfg = JaxConfig()
    jcfg.update(dict(am=am, test=lst, sclite=str(root / "jax"),
                     emission_dir=str(root / "jax_em")))
    jres = jax_run_test(jcfg)
    tres = main([f"--am={am}", f"--test={lst}", f"--sclite={root / 'torch'}",
                 f"--emission_dir={root / 'torch_em'}", "--device=cpu"])
    ties = set()
    for name in os.listdir(root / "jax_em"):
        want = np.load(root / "jax_em" / name)["emission"]
        got = np.load(root / "torch_em" / name)["emission"]
        top2 = np.sort(want, axis=-1)[:, -2:]
        differ = want.argmax(-1) != got.argmax(-1)
        assert np.all(top2[differ, 1] - top2[differ, 0] < 2e-2)
        if differ.any():
            ties.add(name[:-4])
    got_h, want_h = _hyps(str(root / "torch"), lst), _hyps(str(root / "jax"), lst)
    assert sorted(got_h) == sorted(want_h) and len(ties) < len(want_h)
    assert {k: v for k, v in got_h.items() if k not in ties} == \
        {k: v for k, v in want_h.items() if k not in ties}
    if not ties:
        assert (tres["TER"], tres["WER"]) == (jres["TER"], jres["WER"])


def test_commented_arch_names_layers_as_the_builder(tmp_path):
    """The arch the gflags name has comment lines (as the streaming-convnets
    recipe's does): the layers keep the builder's names and the forward is
    the forged model's."""
    arch = tmp_path / "commented.arch"
    arch.write_text("# a narrow streaming stage\n" + ARCH.replace("R\n", "R\n# between\n"))
    torch.manual_seed(0)
    model = build_arch_module(str(arch), NFEAT, N_LABEL)
    path = tmp_path / "fl.bin"
    forge_flashlight(path, model.state_dict(), str(arch),
                     f"--criterion=ctc\n--arch={arch}\n--filterbanks={NFEAT}\n")
    got = load_checkpoint(str(path))
    assert set(got.state_dict) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict[k], v), k


@pytest.mark.parametrize("content", [b"not a checkpoint, but text\n", b"",
                                     struct.pack("<Q", 3) + b"0.3" + struct.pack("<Q", 1)])
def test_a_bad_file_raises_naming_its_path(tmp_path, content):
    path = tmp_path / "bad.bin"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=f"{path}: not a checkpoint"):
        load_checkpoint(str(path))


def test_real_flashlight_fixture():
    """Byte-compat against a real flashlight-saved checkpoint, through the
    port's ``verify_fixture``: skipped, as JAX's
    ``test_flashlight_import.py::test_real_flashlight_fixture`` is, until a
    fixture made by ``FIXTURE_GENERATOR_CPP`` with a flashlight build is
    committed under ``tests/data/flashlight_fixture/``."""
    fixture = os.path.join(os.path.dirname(__file__), "data", "flashlight_fixture")
    if not os.path.exists(os.path.join(fixture, "fixture.bin")):
        pytest.skip("no real flashlight fixture (it needs a flashlight build to make); "
                    "generate with tools/flashlight_import.py")
    verify_fixture(fixture)
