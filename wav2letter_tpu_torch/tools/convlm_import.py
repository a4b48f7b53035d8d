"""Import torch/fairseq ConvLM checkpoints: the port of
``wav2letter_tpu/tools/convlm_import.py``.

Reference: ``recipes/utilities/convlm_serializer/`` (``Serialize.cpp`` and
``save_pytorch_model.py``): a fairseq GCNN LM's tensors are saved plain and
packed into the model in a sequential walk. Here a torch state dict is mapped
onto an ``LMArchModel``'s parameters by shape, in the JAX package's order (the
flax paths sorted, component by component), so one ``.pt`` lands on the same
leaves in both packages; a matrix stored (out, in) matches an (in, out)
parameter transposed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..runtime.checkpoint import jax_param_name


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``torch.save`` state dict (or of its ``"model"``
    entry, fairseq's layout) as numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def jax_order(names) -> List[str]:
    """Parameter names in the JAX traversal order: by their flax paths."""
    return sorted(names, key=lambda n: tuple(jax_param_name(n).split("/")))


def import_convlm(torch_path: str, params: Dict[str, torch.Tensor],
                  transpose_linear: bool = True) -> Dict[str, torch.Tensor]:
    """``params`` (the LM's ``named_parameters`` as a dict) with each leaf
    replaced by the first unused tensor of the file of its shape (or, for a
    matrix with ``transpose_linear``, of its transposed shape). Raises if any
    leaf finds none."""
    src: List[Tuple[str, np.ndarray]] = list(load_torch_state_dict(torch_path).items())
    used = [False] * len(src)

    def match(shape):
        for i, (_, v) in enumerate(src):
            if used[i]:
                continue
            if v.shape == shape:
                used[i] = True
                return v
            if transpose_linear and len(shape) == 2 and v.ndim == 2 and v.T.shape == shape:
                used[i] = True
                return v.T
        return None

    out, unmatched = {}, []
    for name in jax_order(params):
        v = match(tuple(params[name].shape))
        if v is None:
            unmatched.append(jax_param_name(name))
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    if unmatched:
        extra = len(unmatched) - 5 if len(unmatched) > 5 else 0
        raise ValueError(f"unmatched LM params: {unmatched[:5]} (+{extra})")
    return out
