"""Run a JAX-package test module's cases on the port, and the helper's
own tests.

``port_module`` reads tests/<name>.py, applies the given source edits
(each must match), renames ``koordinator_tpu.`` to ``koordinator_tpu_torch.``
and executes the result as a module of its own. ``export`` then puts its
test functions, test classes and fixtures into a port test module's
namespace, so pytest collects them there with their own fixtures and
parametrisations, under their reference names.

tests/test_torch_ref_<module>.py runs the JAX package's
tests/test_<module>.py this way, one file a module so that ``--dist
loadfile`` spreads them. Their edits are the smallest the cases allow
and come from here: ``on_cpu`` puts the port's entry points on the CPU
(the port never moves there on its own), TO_DEVICE and PortNumpy hand
the cases' numpy and jax.numpy arrays to the port's ops as the port's
tensors, PALLAS_FULL_CHAIN maps build_pallas_full_chain_step to the
port's device-aware selector, NATIVE_FLOOR builds the port's floor or
fails, ``injected`` raises an injected dispatch fault as the sim's
InjectedFault and ``cpu_devices`` splits the host into 8 virtual shard
devices for the mesh cases. What a case asserts of JAX alone is left
out, each with its reason and the port test that holds the property, in
the wrapper's docstring.

Four of the JAX package's test modules are not run here:
test_pallas_full_chain.py, test_pallas_step.py, test_vmem_fallback.py
and test_tpu_hardware.py test the Pallas kernels (interpret mode, VMEM
budgets, the TPU). The port's kernels stand for them: tests/test_torch_kernel.py,
test_torch_full_chain.py, test_torch_schedule.py and test_torch_explain.py
hold the plain versions against the JAX package on the CPU, and
chip_smoke.py holds each CUDA kernel against its plain version on the
card.
"""

from __future__ import annotations

import ast
import inspect
import os
import types
from typing import Iterable, Sequence, Tuple

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))


# the port's converter, for cases that hand a numpy batch to a round
TO_DEVICE = "from koordinator_tpu.models.convert import to_device\n"


def after_import(module: str, text: str) -> Tuple[str, str]:
    """An edit that puts ``text`` after the case module's own top-level
    ``import <module>``."""
    line = f"\nimport {module}\n"
    return (line, line + text)


# the port's ladder absorbs only a recognised device fault
# (scheduler/degrade.is_device_fault): a fault a case injects as a bare
# RuntimeError is raised as the sim's InjectedFault, a RuntimeError too
INJECTED_FAULT = "from koordinator_tpu.sim.faults import InjectedFault\n"


def injected(*messages: str):
    """Edits raising each ``RuntimeError(<message>`` as InjectedFault."""
    return [(f"RuntimeError({m}", f"InjectedFault({m}") for m in messages]


# build_pallas_full_chain_step -> the port's device-aware selector
# (models/full_chain.build_best_full_chain_step): the CUDA kernel for a
# batch on the card, the plain round for one on the CPU, as the CUDA
# step alone runs no batch off the card. Interpret mode has no
# counterpart.
PALLAS_FULL_CHAIN = [
    ("from koordinator_tpu.ops.pallas_full_chain import (\n"
     "        build_pallas_full_chain_step,\n    )",
     "from koordinator_tpu.models.full_chain import (\n"
     "        build_best_full_chain_step as build_pallas_full_chain_step)"),
    (", interpret=True)", ")"),
]

# the port's floor builds at first use and raises where it cannot: no
# case skips its comparison for want of a library
NATIVE_FLOOR = [("native_floor.available() or native_floor.build()",
                 "native_floor.load()")]


class PortNumpy:
    """The jax.numpy constructors the reference cases hand to the port's
    ops, as the port's converter (models/convert.as_tensor) on the CPU:
    booleans stay bool, floats become float32 and integers int32, the
    dtypes the reference's asarray gives with x64 off. The edit
    ``JNP`` binds it to the case's ``jnp``."""

    @staticmethod
    def asarray(value, dtype=None):
        from koordinator_tpu_torch.models.convert import as_tensor

        return as_tensor(value, "cpu")

    @classmethod
    def bool_(cls, value):
        return cls.asarray(np.bool_(value))

    @classmethod
    def int32(cls, value):
        return cls.asarray(np.int32(value))


JNP = ("import jax.numpy as jnp",
       "from test_torch_cases import PortNumpy as jnp")


def port_module(name: str, edits: Sequence[Tuple[str, str]] = (),
                on_cpu: Iterable[str] = ()) -> types.ModuleType:
    """``on_cpu`` names the port's entry points the cases call: every call
    of one of them (``Name(...)`` or ``x.Name(...)``) that passes no
    ``device`` gets ``device="cpu"``, or, where its first argument is a
    list (a command's argv), ``"--device", "cpu"`` at the list's end.
    ``function:Name`` names only the calls inside the case ``function``
    (a command's ``main`` is one name for every binary)."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        assert old in src, f"{name}: edit target not found: {old!r}"
        src = src.replace(old, new)
    src = src.replace("koordinator_tpu.", "koordinator_tpu_torch.")
    placer = _OnCpu(set(on_cpu))
    tree = ast.fix_missing_locations(placer.visit(ast.parse(src, path)))
    missing = placer.names - placer.seen
    assert not missing, f"{name}: no call of {sorted(missing)}"
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = path
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


class _OnCpu(ast.NodeTransformer):
    def __init__(self, names):
        self.names = names
        self.seen = set()
        self.scope = []

    def visit_FunctionDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        named = {name, *(f"{s}:{name}" for s in self.scope)} & self.names
        if not named:
            return node
        self.seen |= named
        argv = node.args[0] if node.args else None
        if isinstance(argv, ast.List):
            if not any(isinstance(a, ast.Constant) and a.value == "--device"
                       for a in argv.elts):
                argv.elts += [ast.Constant("--device"), ast.Constant("cpu")]
        elif not any(k.arg in ("device", None) for k in node.keywords):
            node.keywords.append(ast.copy_location(
                ast.keyword("device", ast.Constant("cpu")), node))
        return node


@pytest.fixture
def cpu_devices(monkeypatch):
    """The port's stand-in for the JAX conftest's 8 virtual CPU devices:
    the host split into 8 shard devices (KOORD_TORCH_VIRTUAL_DEVICES).
    A reference module that takes ``cpu_devices`` gets this one with
    ``cpu_devices = torch_cases.cpu_devices``."""
    from koordinator_tpu_torch.parallel.mesh import (
        VIRTUAL_DEVICES_ENV,
        visible_devices,
    )

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    return visible_devices("cpu")


def _is_fixture(obj) -> bool:
    return (hasattr(obj, "_fixture_function_marker")
            or type(obj).__name__ == "FixtureFunctionDefinition")


def export(mod: types.ModuleType, namespace: dict,
           leave_out: Iterable[str] = ()) -> None:
    """Put ``mod``'s tests and fixtures into ``namespace``. A name already
    there is an error, except a fixture defined by the same source."""
    leave_out = set(leave_out)
    for name, obj in vars(mod).items():
        if name in leave_out:
            continue
        test = ((name.startswith("test_") and inspect.isfunction(obj))
                or (name.startswith("Test") and inspect.isclass(obj)))
        if not (test or _is_fixture(obj)):
            continue
        if name in namespace:
            same = (_is_fixture(obj) and _is_fixture(namespace[name])
                    and _source(obj) == _source(namespace[name]))
            assert same, f"{mod.__name__}: {name} is already defined"
            continue
        namespace[name] = obj
    missing = leave_out - set(vars(mod))
    assert not missing, f"{mod.__name__}: no such case {sorted(missing)}"


def _source(fixture) -> str:
    fn = getattr(fixture, "_get_wrapped_function", None)
    fn = fn() if fn is not None else getattr(fixture, "__wrapped__", fixture)
    return inspect.getsource(fn)


# ---------------------------------------------------------------------------
# the helper itself
# ---------------------------------------------------------------------------


def test_port_module_renames_imports_and_applies_edits():
    import sys

    mod = port_module("test_native_perf", [("LIB_DIR =", "LIB_DIR_REF =")])
    assert mod.perf.__name__ == "koordinator_tpu_torch.native.perf"
    assert hasattr(mod, "LIB_DIR_REF") and not hasattr(mod, "LIB_DIR")
    assert mod.__file__.endswith("tests/test_native_perf.py")
    assert "port_test_native_perf" not in sys.modules


def test_an_edit_that_matches_nothing_is_an_error():
    with pytest.raises(AssertionError, match="edit target not found"):
        port_module("test_native_perf", [("no such text", "")])


def test_export_refuses_a_second_definition():
    mod = types.ModuleType("port_cases")

    def test_case():
        pass

    mod.test_case = test_case
    mod.helper = len
    namespace = {}
    export(mod, namespace)
    assert namespace == {"test_case": test_case}
    with pytest.raises(AssertionError, match="already defined"):
        export(mod, namespace)
    with pytest.raises(AssertionError, match="no such case"):
        export(mod, {}, leave_out=("test_missing",))


def test_on_cpu_passes_the_device_where_a_call_passes_none():
    placer = _OnCpu({"f"})
    tree = placer.visit(ast.parse("f(1)\nx.f(2, device='cuda')\ng(f)\n"
                                  "f(**kw)\n"))
    assert ast.unparse(tree).splitlines() == [
        "f(1, device='cpu')", "x.f(2, device='cuda')", "g(f)", "f(**kw)"]
    assert placer.seen == {"f"}
    placer = _OnCpu({"case:main"})
    tree = placer.visit(ast.parse(
        "main(['-x'])\ndef case():\n    main(['-x'])\n"
        "    main(['--device', 'cuda'])\n"))
    assert ast.unparse(tree).splitlines() == [
        "main(['-x'])", "", "def case():",
        "    main(['-x', '--device', 'cpu'])",
        "    main(['--device', 'cuda'])"]
    assert placer.seen == {"case:main"}
    with pytest.raises(AssertionError, match="no call of"):
        port_module("test_native_perf", on_cpu=("Scheduler",))


def test_port_numpy_gives_the_port_tensors():
    import torch

    assert PortNumpy.int32(3).shape == ()
    assert PortNumpy.int32(3).dtype == torch.int32
    assert PortNumpy.bool_(True).dtype == torch.bool
    arr = PortNumpy.asarray(np.arange(4.0), np.float32)
    assert arr.dtype == torch.float32 and arr.device.type == "cpu"
