from .base import DecodeResult
from .bposd import BPOSD
from .gdg import GDG
from .osd_window import OSDWindow
