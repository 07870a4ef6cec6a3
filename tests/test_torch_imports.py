"""The port runs without JAX and without pyarrow: in a fresh process (this
test process has imported jax through conftest), import arrow_tpu_torch,
run both slices on the CPU, and check which modules got loaded. And the
default-device rule: an entry point given no device takes the card."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import arrow_tpu_torch
from arrow_tpu_torch.entry import entry, entry_generic
for make in (entry, entry_generic):
    step, args = make("cpu", 1024, 16, 0)
    out = step(*args)
    assert 0 < len(out) <= 16, len(out)
bad = sorted(m for m in ("jax", "jaxlib", "pyarrow", "arrow_tpu")
             if m in sys.modules)
print("LOADED", bad)
"""


def test_port_imports_neither_jax_nor_pyarrow():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_device_means_the_card():
    """The resolver every entry point and constructor passes ``device``
    through: none given -> cuda; a named device is kept."""
    import importlib
    import inspect

    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch import entry as entry_mod
    from arrow_tpu_torch.core import interop
    # (core/__init__ binds the names ``array`` and ``batch`` to functions)
    array_mod = importlib.import_module("arrow_tpu_torch.core.array")
    batch_mod = importlib.import_module("arrow_tpu_torch.core.batch")

    assert att.default_device() == torch.device("cuda")
    assert array_mod.resolve_device(None) == torch.device("cuda")
    assert array_mod.resolve_device("cpu") == torch.device("cpu")
    assert array_mod.resolve_device(torch.device("cuda:0")) == \
        torch.device("cuda:0")
    for fn in (entry_mod.entry, entry_mod.entry_generic,
               batch_mod.batch_from_numpy, batch_mod.batch,
               interop.batch_from_pyarrow, interop.array_from_pyarrow,
               att.array, att.array_from_numpy, att.nulls, att.full):
        assert inspect.signature(fn).parameters["device"].default is None, fn
