"""The port stands alone and runs where it is asked to.

- Importing every ``repro_torch`` module loads neither ``jax`` nor any
  module of the JAX package ``repro``.
- Entry points that take host input default to the card and raise without
  CUDA; a kernel entry handed CPU tensors raises instead of launching.
- CPU runs go through the plain versions, so no kernel launch is counted.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import evaluate, pla
from repro_torch.data import synthetic
from repro_torch.kernels import build
from repro_torch.kernels.angle import angle_init_carry, launch_angle
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.kernels.reconstruct import launch_recon, launch_recon_err
from repro_torch.kernels.swing import launch_swing, swing_init_carry

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_no_jax_and_no_reference_imports():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.core.pla" in modules and len(modules) >= 14
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.zeros((2, 16), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.evaluate_batched("swing", "implicit", y, 1.0, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.make_batch("gps", 2, 16, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pla.init_state("angle", 2, 1.0)


def test_kernel_entries_refuse_cpu_tensors():
    y_t = torch.zeros((8, 3))
    eps = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_swing(y_t, eps, swing_init_carry(3), max_run=64, t_real=-1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_angle(y_t, eps, angle_init_carry(3), max_run=64, t_real=-1)
    brk = torch.zeros((8, 3), dtype=torch.int8)
    carry = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_recon(brk, y_t, y_t, carry)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_recon_err(brk, y_t, y_t, y_t, carry)
    assert not any(LAUNCHES.values())


def test_cpu_runs_count_no_launches():
    reset_launches()
    y = synthetic.make_batch("gps", 3, 200, np.random.default_rng(2),
                             device="cpu")
    for key in ("Sw", "A1", "A2", "A3"):
        method, proto = evaluate.COMBINATIONS[key]
        evaluate.evaluate_batched(method, proto, y, 10.0,
                                  reconstruct="kernel", device="cpu")
    state = pla.init_state("swing", 3, 10.0, device="cpu")
    state, _ = pla.step_chunk(state, y[:, :50])
    pla.flush(state)
    assert set(LAUNCHES) == {"swing", "angle", "recon", "recon_err"}
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def test_build_flags_and_key():
    """The kernels build for sm_90a with contraction off, keyed by source."""
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "-O3" in flags
    assert build.source_key() == build.source_key()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sources == ["angle.cu", "reconstruct.cu", "swing.cu"]
    for name in sources:
        text = (build.CSRC / name).read_text()
        assert "src/repro/kernels/" in text and "__fmaf_rn" in text
