"""wav2letter_tpu_torch — the PyTorch/CUDA port of ``wav2letter_tpu`` for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package stays the reference; this package is written against it
module by module and never imports it or JAX. Module names mirror the JAX
package so each counterpart is easy to find:

  config      flag table and checkpoint self-description (own copy)
  data        .lst lists, dictionaries, lexicons, bucketing, prefetch (copies)
  features    MFSC/MFCC frontend; kernel K1 (``kernels/mfsc.py``)
  models      .arch DSL -> nn.Modules; kernels K2 and K3 in the TDS blocks
  ops         CTC loss/viterbi/collapse, edit distance
  runtime     test executor, checkpoints, meters
  cli         ``python -m wav2letter_tpu_torch.cli.test``
  kernels     wrappers and plain versions of the CUDA kernels in ``csrc/``

Layouts follow the JAX package: audio (B, S), features (B, T, C), emissions
(B, T, N), targets (B, U) padded with -1.
"""

__version__ = "0.1.0"
