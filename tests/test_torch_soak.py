"""The port's convergence soak (``wav2letter_tpu_torch/tools/soak.py``) on
the CPU: its parsers against the top-level JAX ``tools/soak.py`` (loaded by
path) on fixtures of log lines and sclite files, and the driver end to end
at ``--fast`` sizes cut further (a 2-minute corpus, 4 updates): every phase
writes its marker and ``RESULTS.json`` holds the JAX soak's keys."""

import importlib.util
import json
import os

import pytest

from wav2letter_tpu_torch.runtime.meters import TrainMeters, get_log_string
from wav2letter_tpu_torch.tools import soak as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# two report lines in the JAX package's format, a run-2 line without a
# validation set, and noise
JAX_LINES = [
    "epoch:        3 | nupdates:          250 | lr: 00.167333 | lrcriterion: 00.167333 | "
    "runtime: 412.10s | bch(ms): 1600.21 | smp(ms): 0.00 | fwd(ms): 0.00 | "
    "crit-fwd(ms): 0.00 | bwd(ms): 0.00 | optim(ms): 0.00 | loss:   17.92791 | "
    "train-TER: 98.10 | train-WER: 100.00 | dev-loss:   17.10000 | dev-TER: 97.00 | "
    "dev-WER: 100.00 | avg-isz(audio-s/s): 00500.00",
    "epoch:        6 | nupdates:          500 | lr: 00.200000 | lrcriterion: 00.200000 | "
    "runtime: 801.00s | bch(ms): 1500.00 | smp(ms): 0.00 | fwd(ms): 0.00 | "
    "crit-fwd(ms): 0.00 | bwd(ms): 0.00 | optim(ms): 0.00 | loss:    4.21944 | "
    "train-TER:  3.10 | train-WER:  9.50 | dev-loss:    3.00000 | dev-TER:  1.20 | "
    "dev-WER:   3.20 | avg-isz(audio-s/s): 00510.00",
    "a line without counters",
]


def _jax_soak():
    spec = importlib.util.spec_from_file_location("jax_soak", os.path.join(REPO, "tools",
                                                                           "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("parsers")
    rundir = root / "run"
    rundir.mkdir()
    m = TrainMeters(["dev"])
    m.train.loss.add(0.5, 4)
    m.valid["dev"].wrd_edit.add(["a", "b"], ["a", "c"])
    port_line = get_log_string(m, 9, 750, 0.1, 0.1)  # runtime/meters.py's own line
    (rundir / "001_log").write_text("\n".join(JAX_LINES + [port_line]) + "\n")
    (rundir / "002_log").write_text(port_line.replace("750", "1000") + "\n")
    meta = root / "meta.json"
    meta.write_text(json.dumps({"pairs": [["kab", "qab"], ["lmo", "rso"]]}))
    (root / "x.hyp").write_text("qab cd lmo (u1)\nab (u2)\nkab kab ef (u3)\n")
    (root / "x.ref").write_text("kab cd lmo (u1)\nab gh (u2)\nkab ef (u3)\n")
    return root


def test_trajectory_and_wer_parsers_match_jax(fixtures):
    J = _jax_soak()
    rundir = str(fixtures / "run")
    got = P.Soak._trajectory(rundir)
    assert got == J.Soak._trajectory(rundir)
    assert [r["updates"] for r in got] == [250, 500, 750, 1000]
    assert [r["run"] for r in got] == [1, 1, 1, 2] and got[2]["dev_wer"] == 50.0
    texts = ["[Decode /a/test.lst] WER: 1.11%",
             "Test: loss 3.0, TER: 0.50%, WER: 1.50%",
             "[Decode d] WER: 0.65%\n[Decode d] WER: 0.59%\n[Sweep] best lmweight=0.25 WER=0.59%",
             "no rate here"]
    for text in texts:
        assert P.Soak._parse_wer(text) == J.Soak._parse_wer(text)


def test_slice_rates_match_jax(fixtures):
    J = _jax_soak()
    meta = str(fixtures / "meta.json")
    port, jax_ = object.__new__(P.Soak), object.__new__(J.Soak)
    port.paths = {"meta": meta}
    jax_.paths = {"meta": meta}
    base = str(fixtures / "x")
    got = port._slice_rates(base)
    assert got == jax_._slice_rates(base)
    # 1 substitution, 1 deletion, 1 insertion over 7 ref words; kab is wrong in u1
    assert got == {"wer": 42.86, "homophone_tokens": 3, "homophone_err_rate": 33.33}


def test_missing_keys():
    """Nested dicts, the first row of a list of dicts (an empty list lacks
    it), and grids, whose points need not match."""
    want = {"a": 1, "b": {"c": 2, "d": {"e": 3}}, "rows": [{"x": 1}],
            "lmweight_sweep_dev": {"0.5": 1.0}}
    got = {"a": 0, "b": {"c": 0, "d": {}}, "rows": [], "lmweight_sweep_dev": {"2.0": 1.0}}
    assert P.missing_keys(want, got) == ["b.d.e", "rows[0]"]
    got["rows"] = [{"y": 1}]
    assert P.missing_keys(want, got) == ["b.d.e", "rows[0].x"]
    assert P.missing_keys(want, {}) == ["a", "b", "rows", "lmweight_sweep_dev"]


def test_soak_end_to_end_on_the_cpu(tmp_path):
    s = P.Soak(str(tmp_path / "root"), fast=True, iters_b128=4, iters_b32=4, device="cpu",
               corpus=str(tmp_path / "corpus"),
               corpus_kw=dict(P.FAST_CORPUS_KW, train_hours=2 / 60, dev_minutes=0.5,
                              test_minutes=0.5),
               sizes=dict(sweep=(0.0, 1.0, 0.5), wordscores=(0.5,), homo_utts=3,
                          homo_sweep=(0.0, 1.0, 1.0), stream_utts=2))
    for phase in P.PHASES:
        getattr(s, f"phase_{phase}")()
        s.save()
    root = tmp_path / "root"
    for marker in ("corpus", "lm", "train_b128", "product", "train_b32"):
        assert (root / f".done_{marker}").exists(), marker
    assert not (root / ".done_profile_b128").exists()  # a step on the card only
    assert (root / "SUMMARY.md").exists() and (root / "b128" / "002_log").exists()
    with open(root / "RESULTS.json") as f:
        got = json.load(f)
    with open(os.path.join(REPO, "SOAK_RESULTS.json")) as f:
        want = json.load(f)
    assert P.missing_keys(want, got) == []
    prod = got["product"]
    assert prod["streaming"]["n_utts"] == 2 and prod["topk_vs_full"]["beamsizetoken"] == 8
    assert prod["streaming"]["max_abs_stream_vs_batch_on_stream_features"] < 1e-4
    assert got["train_b128"]["trajectory"][-1]["updates"] == 4


def test_cli_needs_a_card_without_device_cpu(tmp_path):
    """Nothing falls back to the CPU: on a machine without a card the
    default device stops a CLI of the chain with its own error."""
    s = P.Soak(str(tmp_path), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s._run_cli("test", [f"--am={tmp_path / 'missing.bin'}"], "viterbi")
    with pytest.raises(SystemExit, match="unknown phase"):
        P.main(["--phase=b64", f"--root={tmp_path}"])
