"""The port stands alone: every ``repro_torch`` module imports with
``jax`` and ``repro`` blocked, no source of the port or of
``chip_smoke.py`` imports either, the device rule sends entry points to
CUDA unless the CPU is asked for, and the flat-vector helpers keep the
JAX package's leaf order."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.models import LSTMModel as JaxLSTM
from repro.utils.pytree import tree_to_vector as jax_tree_to_vector
from repro_torch.device import resolve_device
from repro_torch.models import params_from_numpy
from repro_torch.utils.pytree import tree_to_vector, vector_to_tree

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "loaded = [m for m, mod in sys.modules.items() if mod is not None]\n"
        "assert not [m for m in loaded if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(MODULES) >= 20
    assert {"repro_torch.nn.ssm", "repro_torch.nn.rglru", "repro_torch.arch.hybrid_lm",
            "repro_torch.nn.moe", "repro_torch.arch.ssm_lm",
            "repro_torch.arch.encdec", "repro_torch.core.gossip_dp"} <= set(MODULES)


# matches `import jax`, `from jax...`, `import repro` and `from repro...`
# (but not `repro_torch`), at the start of a line or after `;`
FORBIDDEN = re.compile(r"(^|;)\s*(import|from)\s+(jax|repro)(\s|\.|,|$)", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.serve import batcher")
    assert FORBIDDEN.search("x = 1; import repro")
    assert not FORBIDDEN.search("from repro_torch.serve import batcher")
    assert not FORBIDDEN.search("import repro_torch")


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


def test_params_from_numpy_copies_into_float32(monkeypatch):
    src = {"a": np.arange(6, dtype=np.float64).reshape(2, 3)}
    got = params_from_numpy(src, "cpu")
    assert got["a"].dtype == torch.float32 and got["a"].shape == (2, 3)
    src["a"][0, 0] = 99.0
    assert got["a"][0, 0] == 0.0  # owns its memory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        params_from_numpy(src)  # default device is CUDA


def test_tree_vector_roundtrip_in_jax_leaf_order():
    jparams = JaxLSTM(hidden=8).init(jax.random.PRNGKey(0))
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    vec = tree_to_vector(params)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jax_tree_to_vector(jparams)))
    back = vector_to_tree(vec, params)
    assert list(back) == ["b", "b_out", "w_out", "wh", "wx"]
    assert all(torch.equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="template"):
        vector_to_tree(vec[:-1], params)
