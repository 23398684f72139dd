from .base import DecodeResult
from .bposd import BPOSD
