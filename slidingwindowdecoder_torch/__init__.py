"""slidingwindowdecoder_torch — the sliding-window QLDPC decoder in PyTorch.

The PyTorch/CUDA port of the repository's JAX package, which stays beside
it as the reference; the layout follows it module for module. The hot kernels are hand-written CUDA C++ for Hopper under
``csrc/``: the min-sum check-node update (``ops.bp_cuda``) and the
reliability-ordered GF(2) Gauss-Jordan (``ops.gf2_cuda``). They are built
with ``nvcc`` at first use into ``build/``. Entry points take ``device=None``,
which means ``"cuda"``; pass ``device="cpu"`` to run the plain PyTorch
versions on the CPU.

This package imports torch and numpy only: nothing of JAX and nothing of
the JAX package.
"""

__version__ = "0.1.0"
