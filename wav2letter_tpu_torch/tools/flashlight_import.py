"""Flashlight (cereal) checkpoint importer — the port's copy of
``wav2letter_tpu/tools/flashlight_import.py``: reference model-zoo artifacts
into the JAX-layout param tree that ``runtime/checkpoint.py::
convert_jax_params`` turns into the port's state dict, so that
``load_checkpoint`` (and with it ``--am=`` of ``cli.test``, ``cli.decode``
and ``cli.convert_streaming``) reads them.

What a reference training checkpoint is (evidenced in-repo):
``fl::ext::Serializer::save(path, version, cfg, network, criterion)`` with a
``cereal::BinaryInputArchive`` — load call + the full arch-walk param
mapping at ``StreamingTDSModelConverter.cpp:148-284`` (version string, cfg
``unordered_map<string,string>`` holding the serialized gflags under
``kGflags``, then the polymorphic network/criterion modules whose
``params()`` vector is consumed IN ORDER by walking the ``.arch`` lines:
C2=2 params, LN=2, L=2, TDS=10 in order conv w/b, ln1 w/b, lin1 w/b,
lin2 w/b, ln2 w/b — ``:208-284`` and ``convertTDS :105-137``).

Reader design. cereal's BinaryArchive is headerless little-endian:
``std::string`` = u64 length + bytes; maps = u64 count + pairs. The
*polymorphic module* encoding (cereal type ids) and each module's extra
fields live in unmounted flashlight code, so instead of a full class-schema
walk this importer parses the header (version + cfg map) exactly and then
SCANS for ``af::array`` blobs: flashlight serializes an array as af::dim4
(4 x i64), dtype (u32), then the element bytes as a sized vector (u64
length), so a candidate offset is accepted only when
``nbytes == prod(dims) * sizeof(dtype)`` — an overwhelmingly selective
consistency check that is robust to the unknown interleaved scalar fields.
The ordered array list is then mapped by the same arch walk the reference
converter uses. One difference from the JAX copy: the arch file named by the
stored gflags is read without its comment lines, so layer ``i`` is named as
the arch builder names it (the JAX copy counts the comments and misnames the
layers of a commented arch, such as the streaming-convnets recipe's).

Byte-compat is fixture-gated like the kenlm reader
(``tools/kenlm_fixture.py`` pattern): ``FIXTURE_GENERATOR_CPP`` below
compiles against real flashlight to emit a tiny checkpoint + expected
values JSON; ``verify_fixture`` replays it and the test skips until a
fixture is committed (it needs a flashlight build to be made).
Layout assumptions that the fixture pins down: AF arrays are column-major,
so a blob with dims (d0..d3) is ``np.reshape(dims[::-1])``; fl Conv2D
weights are (wx, wy, cin/groups, cout) -> ours (cout, cin/g, kh, kw); fl
Linear weights are (out, in) -> ours (in, out).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# af::dtype numeric codes (ArrayFire public enum)
_AF_DTYPES = {
    0: np.float32, 2: np.float64, 4: np.int32, 5: np.uint32,
    6: np.uint8, 7: np.int64, 8: np.uint64, 9: np.int16, 10: np.uint16,
    12: np.float16,
}


def _read_u64(buf: bytes, off: int) -> Tuple[int, int]:
    return struct.unpack_from("<Q", buf, off)[0], off + 8


def _read_string(buf: bytes, off: int, max_len: int = 1 << 20) -> Tuple[str, int]:
    n, off = _read_u64(buf, off)
    if n > max_len or off + n > len(buf):
        raise ValueError(f"implausible cereal string length {n} at {off - 8}")
    return buf[off : off + n].decode("utf-8", "replace"), off + n


def read_header(buf: bytes) -> Tuple[str, Dict[str, str], int]:
    """Parse the Serializer::save header: version string + cfg string map.
    Returns (version, cfg, offset_after_header)."""
    version, off = _read_string(buf, 0, max_len=64)
    count, off = _read_u64(buf, off)
    if count > 10000:
        raise ValueError(f"implausible cfg map size {count}")
    cfg = {}
    for _ in range(count):
        k, off = _read_string(buf, off)
        v, off = _read_string(buf, off, max_len=1 << 24)
        cfg[k] = v
    return version, cfg, off


def scan_arrays(buf: bytes, start: int = 0,
                max_elems: int = 1 << 31) -> List[np.ndarray]:
    """Scan for serialized af::array blobs: 4 x i64 dims, u32 dtype,
    u64 byte-count that must equal prod(dims) * itemsize. Returns arrays
    in file order, reshaped to numpy C-order (dims reversed: AF is
    column-major)."""
    out = []
    off = start
    n = len(buf)
    while off + 44 <= n:
        dims = struct.unpack_from("<4q", buf, off)
        if all(1 <= d <= max_elems for d in dims):
            elems = dims[0] * dims[1] * dims[2] * dims[3]
            if 1 <= elems <= max_elems:
                dt_code = struct.unpack_from("<I", buf, off + 32)[0]
                dt = _AF_DTYPES.get(dt_code)
                if dt is not None:
                    nbytes = struct.unpack_from("<Q", buf, off + 36)[0]
                    if nbytes == elems * np.dtype(dt).itemsize and \
                            off + 44 + nbytes <= n:
                        data = np.frombuffer(
                            buf, dt, count=elems, offset=off + 44
                        )
                        shape = tuple(d for d in reversed(dims))
                        out.append(data.reshape(shape))
                        off += 44 + nbytes
                        continue
        off += 1
    return out


# -- arch-walk param mapping (converter :208-284 semantics) -----------------

def _squeeze_np(a: np.ndarray) -> np.ndarray:
    return np.asarray(a).squeeze()


def map_arch_params(arch_lines: List[str], arrays: List[np.ndarray],
                    n_feat: int, n_label: int) -> Dict[str, Dict]:
    """Walk the .arch lines, consuming ``arrays`` in order exactly like the
    reference converter consumes ``network->params()``, and produce this
    framework's param tree entries keyed by the ArchSequential layer names
    (``NN_<mnemonic>``). Scope matches the reference converter: streaming
    TDS family (C2 / LN / L / TDS; V/RO/DO/SAUG/PD skipped)."""
    tree: Dict[str, Dict] = {}
    ai = 0

    def take() -> np.ndarray:
        nonlocal ai
        if ai >= len(arrays):
            raise ValueError(
                f"checkpoint has {len(arrays)} arrays; arch needs more"
            )
        a = arrays[ai]
        ai += 1
        return a

    def conv_wb():
        # fl Conv2D weight AF dims (wx, wy, cin/g, cout) -> scanned C-order
        # (cout, cin/g, wy, wx) == our (cout, cin/g, kh, kw)
        w = np.asarray(take(), np.float32)
        while w.ndim < 4:
            w = w[np.newaxis]
        b = _squeeze_np(take()).astype(np.float32).reshape(-1)
        return w, b

    def lin_wb():
        # fl Linear weight AF dims (out, in) -> scanned (in, out) == ours
        w = np.asarray(take(), np.float32)
        w = w.reshape(w.shape[-2], w.shape[-1]) if w.ndim > 2 else w
        b = _squeeze_np(take()).astype(np.float32).reshape(-1)
        return w, b

    def ln_wb():
        w = _squeeze_np(take()).astype(np.float32).reshape(-1)
        b = _squeeze_np(take()).astype(np.float32).reshape(-1)
        return w, b

    for i, raw in enumerate(arch_lines):
        cols = raw.split()
        if not cols or cols[0].startswith("#"):
            continue
        t = cols[0]
        name = f"{i:02d}_{t}"
        if t == "C2":
            w, b = conv_wb()
            tree[name] = {"weight": w, "bias": b}
        elif t == "LN":
            w, b = ln_wb()
            tree[name] = {"weight": w, "bias": b}
        elif t == "L":
            w, b = lin_wb()
            tree[name] = {"weight": w, "bias": b}
        elif t == "TDS":
            cw, cb = conv_wb()
            l1w, l1b = ln_wb()
            i1w, i1b = lin_wb()
            i2w, i2b = lin_wb()
            l2w, l2b = ln_wb()
            tree[name] = {
                "conv": {"weight": cw, "bias": cb},
                "ln1": {"weight": l1w, "bias": l1b},
                "lin1": {"weight": i1w, "bias": i1b},
                "lin2": {"weight": i2w, "bias": i2b},
                "ln2": {"weight": l2w, "bias": l2b},
            }
        elif t in ("V", "RO", "DO", "SAUG", "PD", "R"):
            continue
        else:
            raise ValueError(
                f"flashlight import supports the streaming-TDS family "
                f"(C2/LN/L/TDS, converter scope); got {t!r}"
            )
    return tree


def gflags_to_cfg_updates(gflags_text: str) -> Dict[str, str]:
    """Serialized-gflags blob (``--key=value`` lines) -> config updates."""
    out = {}
    for line in gflags_text.replace(";", "\n").splitlines():
        line = line.strip()
        if line.startswith("--") and "=" in line:
            k, _, v = line[2:].partition("=")
            out[k.strip()] = v.strip()
    return out


def import_checkpoint(path: str, arch_lines: Optional[List[str]] = None,
                      n_feat: int = 80, n_label: int = 0):
    """Read a flashlight checkpoint -> (version, cfg map, param tree,
    leftover arrays). ``arch_lines`` default to the arch named in the
    stored gflags when resolvable."""
    with open(path, "rb") as f:
        buf = f.read()
    version, cfg, off = read_header(buf)
    arrays = scan_arrays(buf, off)
    flags = {}
    for k, v in cfg.items():
        if "--" in v:  # the kGflags entry
            flags = gflags_to_cfg_updates(v)
    if arch_lines is None:
        archdir = flags.get("archdir", "")
        arch = flags.get("arch", "")
        ap = os.path.join(archdir, arch) if archdir else arch
        if not ap or not os.path.exists(ap):
            raise ValueError(
                f"arch {ap!r} not resolvable from the checkpoint's gflags; pass arch_lines"
            )
        with open(ap) as f:  # numbered as the arch builder numbers them
            arch_lines = [l.strip() for l in f
                          if l.strip() and not l.strip().startswith("#")]
    tree = map_arch_params(arch_lines, arrays, n_feat, n_label)
    n_used = sum(len(tree_leaves(v)) for v in tree.values())
    return version, flags, tree, arrays[n_used:]


def tree_leaves(d):
    if isinstance(d, dict):
        out = []
        for v in d.values():
            out.extend(tree_leaves(v))
        return out
    return [d]


# -- fixture harness (kenlm_fixture pattern) --------------------------------

FIXTURE_GENERATOR_CPP = r"""// Compile against real flashlight (where available) to generate the
// byte-compat fixture for wav2letter_tpu's flashlight_import:
//   fixture.bin  — Serializer-saved tiny fl::Sequential + CTC criterion
//   fixture.json — expected param values/shapes in params() order
#include <fstream>
#include "flashlight/fl/flashlight.h"
#include "flashlight/ext/common/Serializer.h"
int main() {
  auto net = std::make_shared<fl::Sequential>();
  net->add(std::make_shared<fl::Conv2D>(1, 2, 3, 1, 2, 1, 1, 1));
  net->add(std::make_shared<fl::LayerNorm>(std::vector<int>{1, 2}));
  net->add(std::make_shared<fl::Linear>(4, 5));
  for (auto& p : net->params()) { /* params are randomly initialized */ }
  std::unordered_map<std::string, std::string> cfg{
      {"gflags", "--criterion=ctc\n--filterbanks=2\n"}};
  fl::ext::Serializer::save("fixture.bin", "0.3", cfg, net);
  std::ofstream js("fixture.json");
  js << "[";
  auto ps = net->params();
  for (size_t i = 0; i < ps.size(); ++i) {
    auto& p = ps[i];
    std::vector<float> host(p.elements());
    p.host(host.data());
    js << (i ? "," : "") << "{\"dims\":[" << p.dims(0) << "," << p.dims(1)
       << "," << p.dims(2) << "," << p.dims(3) << "],\"data\":[";
    for (size_t j = 0; j < host.size(); ++j)
      js << (j ? "," : "") << host[j];
    js << "]}";
  }
  js << "]";
  return 0;
}
"""


def write_fixture_generator(outdir: str) -> str:
    os.makedirs(outdir, exist_ok=True)
    p = os.path.join(outdir, "generate_fixture.cpp")
    with open(p, "w") as f:
        f.write(FIXTURE_GENERATOR_CPP)
    return p


def verify_fixture(fixture_dir: str) -> None:
    """Replay a committed fixture: header parses, every expected param is
    recovered at the right position with the right values."""
    with open(os.path.join(fixture_dir, "fixture.bin"), "rb") as f:
        buf = f.read()
    version, cfg, off = read_header(buf)
    assert version, "empty version string"
    assert any("--" in v for v in cfg.values()), "no gflags entry in cfg"
    arrays = scan_arrays(buf, off)
    with open(os.path.join(fixture_dir, "fixture.json")) as f:
        expected = json.load(f)
    assert len(arrays) >= len(expected), (
        f"scanned {len(arrays)} arrays, expected >= {len(expected)}"
    )
    for i, exp in enumerate(expected):
        got = np.asarray(arrays[i], np.float32).reshape(-1)
        want = np.asarray(exp["data"], np.float32)
        assert got.size == want.size, (i, got.size, want.size)
        np.testing.assert_allclose(got, want, rtol=1e-6)
