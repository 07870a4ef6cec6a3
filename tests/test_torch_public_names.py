"""The port's public names against the JAX package's (ROADMAP C33): the
package's top level, ``compute`` (its option classes and helpers, and every
registered function as a module attribute), ``parallel``, ``acero``,
``engine`` (the Substrait consumer and producer), ``to_table(lazy=)`` and
the methods of Array, Batch and Table. The names the port leaves out are the
JAX-only ones, listed here by name."""

import types

import numpy as np
import pytest

import arrow_tpu as jax_pkg
import arrow_tpu.acero as jacero
import arrow_tpu.compute as jcompute
import arrow_tpu.engine as jengine
import arrow_tpu.parallel as jparallel
import arrow_tpu_torch as port
import arrow_tpu_torch.acero as tacero
import arrow_tpu_torch.compute as tcompute
import arrow_tpu_torch.engine as tengine
import arrow_tpu_torch.parallel as tparallel

# JAX-only: placement on a JAX device and the pytree protocol
JAX_ONLY = {"Array": {"device_put", "tree_flatten", "tree_unflatten"},
            "Batch": {"device_put", "tree_flatten", "tree_unflatten"}}


def _public(obj) -> set:
    """Public names, modules that a module merely imports left out."""
    return {n for n in dir(obj) if not n.startswith("_") and
            not isinstance(getattr(obj, n, None), types.ModuleType)}


@pytest.mark.parametrize("jmod,tmod", [
    (jax_pkg, port), (jcompute, tcompute), (jparallel, tparallel),
    (jacero, tacero), (jengine, tengine)],
    ids=["package", "compute", "parallel", "acero", "engine"])
def test_modules_have_the_jax_packages_names(jmod, tmod):
    missing = {n for n in _public(jmod) if not hasattr(tmod, n)}
    assert not missing, sorted(missing)


def test_compute_lazy_names_resolve():
    missing = [n for n in jcompute._LAZY if n not in tcompute._LAZY]
    assert not missing, missing
    for name in tcompute._LAZY:
        assert getattr(tcompute, name) is not None, name


def test_every_registered_function_is_a_compute_attribute():
    names = tcompute.list_functions()
    assert set(names) == set(jcompute.list_functions())
    for name in names:
        fn = getattr(tcompute, name)
        assert callable(fn) and fn.__name__ == name
    a = port.array(np.array([1, 2, 3]), device="cpu")
    assert tcompute.add(a, a).to_pylist() == [2, 4, 6]
    with pytest.raises(AttributeError):
        tcompute.no_such_function


@pytest.mark.parametrize("cls", ["Array", "Batch", "Table"])
def test_classes_have_the_jax_packages_methods(cls):
    jnames = _public(getattr(jax_pkg, cls))
    missing = {n for n in jnames if not hasattr(getattr(port, cls), n)}
    assert missing == JAX_ONLY.get(cls, set()), sorted(missing)


def test_array_to_numpy_and_all_valid():
    a = port.array(np.array([1.5, 2.5]), device="cpu")
    assert a.all_valid
    np.testing.assert_array_equal(a.to_numpy(), [1.5, 2.5])
    b = port.array(np.array([1, 2]), validity=np.array([True, False]),
                   device="cpu")
    assert not b.all_valid
    assert port.array_from_json(port.int64, "[1, null]",
                                device="cpu").to_pylist() == \
        [1, None]
    assert str(port.decimal128(10, 2)) == "decimal128(10, 2)"


def test_plan_node_factories():
    """Every node factory of the JAX package, ``scan`` (over ``dataset/``,
    ROADMAP A9a) included."""
    import arrow_tpu.acero.nodes as jnodes
    import arrow_tpu_torch.acero.nodes as tnodes
    assert set(jnodes.FACTORIES) - set(tnodes.FACTORIES) == set()
    assert {"sorted_merge", "asofjoin", "tpch_gen"} <= set(tnodes.FACTORIES)


def test_to_table_takes_lazy():
    """``Declaration.to_table(stop_token=None, lazy=...)`` in both
    packages; the port takes the fused driver as an argument too (the JAX
    package reads ``ARROW_TPU_FUSE_PLAN`` and ``ARROW_TPU_LAZY_PLAN``),
    runs eager by default, and each driver gives the same rows."""
    import inspect
    jp = inspect.signature(jacero.Declaration.to_table).parameters
    tp = inspect.signature(tacero.Declaration.to_table).parameters
    assert list(jp) == ["self", "stop_token", "lazy"]
    assert list(tp) == ["self", "stop_token", "lazy", "fused"]
    assert tp["lazy"].default is False and tp["fused"].default is False
    t = port.table({"a": np.arange(4)}, device="cpu")
    src = tacero.Declaration("table_source",
                             tacero.TableSourceNodeOptions(t))
    decl = tacero.Declaration("filter", tacero.FilterNodeOptions(
        port.compute.field("a") > 1), [src])
    for kw in ({}, {"lazy": True}, {"fused": True}):
        assert decl.to_table(**kw).to_pydict() == {"a": [2, 3]}, kw
