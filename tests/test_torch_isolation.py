"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points never drop to the CPU on their own."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import slidingwindowdecoder_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "slidingwindowdecoder_torch"
FORBIDDEN = ("import jax", "from jax", "slidingwindowdecoder_tpu")


def _submodules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            slidingwindowdecoder_torch.__path__, "slidingwindowdecoder_torch.")
    )


def test_import_leaves_jax_out():
    mods = ["slidingwindowdecoder_torch", *_submodules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k.startswith('slidingwindowdecoder_tpu'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=300,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(mods) > 20  # every module of the slice was imported


@pytest.mark.parametrize(
    "path",
    [p.relative_to(ROOT).as_posix() for p in sorted(PKG.rglob("*"))
     if p.suffix in (".py", ".cu", ".cuh")] + ["chip_smoke.py"],
)
def test_sources_name_no_jax(path):
    text = (ROOT / path).read_text()
    assert not [f for f in FORBIDDEN if f in text]


def test_entry_points_need_a_card_by_default(monkeypatch):
    from slidingwindowdecoder_torch.decoders import BPOSD, OSDWindow
    from slidingwindowdecoder_torch.harness.circuit_level import sliding_window_decoder
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.windows.pipeline import decode_sliding_window

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_tensors(compile_graph(H))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPOSD(H, np.full(3, 0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OSDWindow(H, np.full(3, 0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sliding_window_decoder(N=72, num_repeat=2, num_shots=4, W=2, shorten=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_sliding_window(None, np.zeros((1, 2), np.uint8), None)
    # explicit CPU is honoured
    assert graph_tensors(compile_graph(H), "cpu")["cn_valid_sm"].device.type == "cpu"


def test_wrappers_refuse_other_devices():
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key

    mv = torch.zeros((2, 32, 4), device="meta")
    for pinned in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            cn_update(mv, mv[:, :, 0].bool(), mv[0].int(), alpha=1.0, clip=50.0,
                      pinned=pinned)
    with pytest.raises(ValueError, match="unsupported device"):
        gauss_jordan_key(torch.zeros((2, 1), dtype=torch.int32, device="meta"),
                         torch.zeros((4, 2), device="meta"),
                         torch.zeros((4, 3), device="meta"), m=2, n=3, rank=2)
