from . import gf2
from .gf2 import rank, row_echelon, kernel, row_basis, inverse
