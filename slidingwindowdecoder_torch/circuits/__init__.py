from .circuit import Circuit, Instruction
from .dem import DemMatrices, compile_dem, propagate_single_fault
from .builders import build_bb_memory_circuit, build_phenomenological_circuit
from .sampler import PauliFrameSampler, sample_dem_numpy, make_dem_sampler
