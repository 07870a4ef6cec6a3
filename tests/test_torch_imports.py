"""The port runs without JAX and without pyarrow: in a fresh process (this
test process has imported jax through conftest), import arrow_tpu_torch,
run the slices on the CPU (the distributed one on 8 logical shards, which
loads ``parallel/*`` and ``ops/hashing``), and check which modules got
loaded. And the default-device rule: an entry point given no device takes the card."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import arrow_tpu_torch
from arrow_tpu_torch.entry import entry, entry_distributed, entry_generic
for make in (entry, entry_generic):
    step, args = make("cpu", 1024, 16, 0)
    out = step(*args)
    assert 0 < len(out) <= 16, len(out)
step, args = entry_distributed("cpu", 8, 1024, 16, 64, 0)
table = step(*args)
assert 0 < table.num_rows <= 16, table
import arrow_tpu_torch.parallel.context, arrow_tpu_torch.parallel.dist_agg
import arrow_tpu_torch.parallel.shuffle, arrow_tpu_torch.ops.hashing
assert {"arrow_tpu_torch.parallel.shuffle", "arrow_tpu_torch.ops.hashing",
        "arrow_tpu_torch.parallel.dist_agg"} <= set(sys.modules)
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
               entry_mod.entry_distributed, batch_mod.empty_batch,
               batch_mod.batch_from_numpy, batch_mod.batch,
               interop.batch_from_pyarrow, interop.array_from_pyarrow,
               att.array, att.array_from_numpy, att.nulls, att.full):
        assert inspect.signature(fn).parameters["device"].default is None, fn


def test_port_sources_name_neither_jax_nor_the_jax_package():
    """No module of the port, the exchange and the hashing included,
    imports ``jax`` or ``arrow_tpu``."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|arrow_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "arrow_tpu_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"arrow_tpu_torch/parallel/__init__.py",
            "arrow_tpu_torch/parallel/context.py",
            "arrow_tpu_torch/parallel/dist_agg.py",
            "arrow_tpu_torch/parallel/shuffle.py",
            "arrow_tpu_torch/ops/hashing.py"} <= names
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f


def test_dist_context_without_devices_wants_a_card():
    """``DistContext()`` with no mesh takes the cards; where there is none
    it raises and does not quietly take the CPU."""
    import pytest
    import torch

    from arrow_tpu_torch.parallel import DistContext, Mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistContext()
    ctx = DistContext(mesh=Mesh(["cpu", "cpu"], axis="x"))
    assert (ctx.n, ctx.axis) == (2, "x")
    assert ctx.mesh.shape == {"x": 2}
