from .circuit_level import build_bb_window_experiment
from .depolarizing import depolarizing_decoding
from .phenomenological import decode_phenomenological
from .shyps import decode_shyps
