from .base import DecodeResult
from .bposd import BPOSD
from .bpgd import BPGD
from .gdg import GDG
from .osd_window import OSDWindow
