from .base import DecodeResult
from .bposd import BPOSD
from .osd_window import OSDWindow
