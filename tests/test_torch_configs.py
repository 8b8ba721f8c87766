"""The port's configs against the reference's, and the port's import wall."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro_torch.configs import get_config, list_archs

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CASES = [(a, s) for a in ref_list_archs() for s in (False, True)]


def test_registry_lists_the_same_archs():
    assert list_archs() == ref_list_archs()
    assert len(CASES) == 20


@pytest.mark.parametrize("arch,smoke", CASES)
def test_config_equals_reference(arch, smoke):
    ours, ref = get_config(arch, smoke), ref_get_config(arch, smoke)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.head_dim_ == ref.head_dim_
    assert [ours.pattern_at(i) for i in range(ours.n_layers)] == \
        [ref.pattern_at(i) for i in range(ref.n_layers)]


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.runtime, repro_torch.launch.serve, "
            "repro_torch.models.convert, repro_torch.kernels.ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
                        re.MULTILINE)


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert files
    bad = [f"{p.relative_to(PORT)}: {m.group(0).strip()}"
           for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad
