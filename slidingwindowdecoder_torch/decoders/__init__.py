from .base import DecodeResult
from .bposd import BPOSD
from .bp4 import BP4OSD
from .bpgd import BPGD
from .gdg import GDG
from .osd_window import OSDWindow
