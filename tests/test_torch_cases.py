"""Run a JAX-package test module's cases on the port, and the helper's
own tests.

``port_module`` reads tests/<name>.py, applies the given source edits
(each must match), renames ``koordinator_tpu.`` to ``koordinator_tpu_torch.``
and executes the result as a module of its own. ``export`` then puts its
test functions, test classes and fixtures into a port test module's
namespace, so pytest collects them there with their own fixtures and
parametrisations, under their reference names.
"""

from __future__ import annotations

import inspect
import os
import types
from typing import Iterable, Sequence, Tuple

TESTS = os.path.dirname(os.path.abspath(__file__))


def port_module(name: str, edits: Sequence[Tuple[str, str]] = (),
                ) -> types.ModuleType:
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        assert old in src, f"{name}: edit target not found: {old!r}"
        src = src.replace(old, new)
    src = src.replace("koordinator_tpu.", "koordinator_tpu_torch.")
    mod = types.ModuleType(f"port_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


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
    import pytest

    with pytest.raises(AssertionError, match="edit target not found"):
        port_module("test_native_perf", [("no such text", "")])


def test_export_refuses_a_second_definition():
    import pytest

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
