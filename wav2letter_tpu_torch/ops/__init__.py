from .ctc import ctc_collapse, ctc_loss, ctc_viterbi
from .editdistance import edit_distance

__all__ = ["ctc_collapse", "ctc_loss", "ctc_viterbi", "edit_distance"]
