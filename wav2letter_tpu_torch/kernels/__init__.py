"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with a
plain PyTorch version of the same function beside it.

A wrapper takes its plain version for a tensor on the CPU, and launches its
kernel for a tensor on the card or raises; it never falls back. ``KERNELS``
and ``PLAIN`` name the same functions; the model and the frontend take
``KERNELS`` unless a caller asks for ``PLAIN`` explicitly, which only the
on-card comparisons do; the CTC criterion takes ``ctc_loss`` from the same
namespaces. Under autograd ``KERNELS.time_conv``, ``KERNELS.residual_ln``,
``KERNELS.mhsa`` and ``KERNELS.ctc_loss`` reach their backward kernels by
themselves; the backward functions (and ``ctc``, the loss's forward) are
named here for the comparisons.
"""

from types import SimpleNamespace

from ._build import LAUNCHES, disable_tf32, library
from .attention import mhsa, mhsa_bwd, mhsa_bwd_plain, mhsa_plain
from .ctc import ctc_bwd, ctc_bwd_plain, ctc_fwd, ctc_fwd_plain, ctc_loss, ctc_loss_plain
from .layernorm import (residual_ln, residual_ln_bwd, residual_ln_bwd_plain,
                        residual_ln_plain)
from .mfsc import mfsc, mfsc_plain
from .tconv import (time_conv, time_conv_dgrad, time_conv_dgrad_plain, time_conv_plain,
                    time_conv_wgrad, time_conv_wgrad_plain)

KERNELS = SimpleNamespace(
    mfsc=mfsc, time_conv=time_conv, residual_ln=residual_ln,
    time_conv_dgrad=time_conv_dgrad, time_conv_wgrad=time_conv_wgrad,
    residual_ln_bwd=residual_ln_bwd, mhsa=mhsa, mhsa_bwd=mhsa_bwd, ctc=ctc_fwd,
    ctc_bwd=ctc_bwd, ctc_loss=ctc_loss)
PLAIN = SimpleNamespace(
    mfsc=mfsc_plain, time_conv=time_conv_plain, residual_ln=residual_ln_plain,
    time_conv_dgrad=time_conv_dgrad_plain, time_conv_wgrad=time_conv_wgrad_plain,
    residual_ln_bwd=residual_ln_bwd_plain, mhsa=mhsa_plain, mhsa_bwd=mhsa_bwd_plain,
    ctc=ctc_fwd_plain, ctc_bwd=ctc_bwd_plain, ctc_loss=ctc_loss_plain)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = [
    "KERNELS", "PLAIN", "LAUNCHES", "reset_launches", "disable_tf32", "library",
    "mfsc", "mfsc_plain", "time_conv", "time_conv_plain", "time_conv_dgrad",
    "time_conv_dgrad_plain", "time_conv_wgrad", "time_conv_wgrad_plain", "residual_ln",
    "residual_ln_plain", "residual_ln_bwd", "residual_ln_bwd_plain", "mhsa", "mhsa_plain",
    "mhsa_bwd", "mhsa_bwd_plain", "ctc_fwd", "ctc_fwd_plain", "ctc_bwd", "ctc_bwd_plain",
    "ctc_loss", "ctc_loss_plain",
]
