from .base import DecodeResult
from .bposd import BPOSD
from .bp4 import BP4OSD
from .bpgd import BPGD
from .gdg import GDG
from .osd_window import OSDWindow


class BP(BPOSD):
    """Plain batched min-sum BP, no OSD (the reference's
    bp_history_decoder surface, bp_guessing_decoder.pyx:5-158): ``BPOSD``
    with ``osd_method="off"`` at the JAX package's defaults."""

    def __init__(self, pcm, channel_probs, *, max_iter=50, ms_scaling_factor=1.0,
                 clip=50.0, **kw):
        super().__init__(pcm, channel_probs, max_iter=max_iter,
                         ms_scaling_factor=ms_scaling_factor, clip=clip,
                         osd_method="off", **kw)
