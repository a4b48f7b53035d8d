"""A forger of flashlight (cereal) training checkpoints for the port's tests,
in the layout that ``tests/test_flashlight_import.py`` documents: the version
string, a cfg map holding the gflags, then the AF arrays in the reference
converter's ``params()`` order with unknown bytes interleaved. Imports
neither JAX nor the JAX package."""

import struct

import numpy as np

# the reference converter's order of a layer's params (``map_arch_params``)
FL_PARTS = {"C2": ("",), "LN": ("",), "L": ("",),
            "TDS": ("conv.", "ln1.", "lin1.", "lin2.", "ln2.")}


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def forge_flashlight(path, state, arch_path, gflags, noise=b"\x07\x00xyz", extra=()):
    """Write ``state`` (the port's state dict of ``arch_path``) as a
    flashlight checkpoint: the header with ``gflags``, then each param as an
    AF array (dims reversed, column-major) after ``noise``, in the reference
    converter's order; ``extra`` arrays (an ASG criterion's) follow."""
    with open(arch_path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    arrays = []
    for i, line in enumerate(lines):
        kind = line.split()[0]
        for part in FL_PARTS.get(kind, ()):
            for leaf in ("weight", "bias"):
                arrays.append(state[f"seq.{i:02d}_{kind}.{part}{leaf}"])
    arrays += list(extra)
    with open(path, "wb") as f:
        f.write(_string("0.3") + struct.pack("<Q", 1) + _string("gflags") + _string(gflags))
        for a in arrays:
            a = np.ascontiguousarray(np.asarray(a, np.float32))
            dims = tuple(reversed(a.shape)) + (1,) * (4 - a.ndim)
            f.write(noise + struct.pack("<4q", *dims) + struct.pack("<I", 0)
                    + struct.pack("<Q", a.nbytes) + a.tobytes())
        f.write(noise)
