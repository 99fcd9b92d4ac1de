"""Run a reference test module's cases against either package.

`load_as(path, "dynamo_tpu_torch")` executes the test file's source with
every `dynamo_tpu.` module path (imports and the dotted strings given to
`monkeypatch.setattr`) pointed at the port, so one set of cases holds both
packages to the same assertions. `cases(module)` lists its test functions
and `Class.method` tests; `run(module, name, **fixtures)` calls one, handing
it the pytest fixtures it names.
"""

from __future__ import annotations

import asyncio
import inspect
import re
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
PACKAGES = ("dynamo_tpu", "dynamo_tpu_torch")


def load_as(path: Path, pkg: str) -> types.ModuleType:
    name = f"_{path.stem}__{pkg}"
    if name in sys.modules:
        return sys.modules[name]
    src = path.read_text()
    if pkg != "dynamo_tpu":
        src = re.sub(r"\bdynamo_tpu\.", f"{pkg}.", src)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    mod.__package__ = "tests"  # the file's own `from .utils import ...`
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


FIXTURES = {"monkeypatch", "tmp_path"}


def cases(mod: types.ModuleType) -> list:
    """Its test cases, less the slow-marked ones and those that need a
    fixture other than `monkeypatch` / `tmp_path` (a module's process
    cluster)."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            slow = any(m.name == "slow" for m in getattr(obj, "pytestmark", []))
            if not slow and set(inspect.signature(obj).parameters) <= FIXTURES:
                out.append(name)
        elif name.startswith("Test") and inspect.isclass(obj):
            out += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")]
    return out


def run(mod: types.ModuleType, case: str, **fixtures) -> None:
    if "." in case:
        cls, meth = case.split(".")
        fn = getattr(getattr(mod, cls)(), meth)
    else:
        fn = getattr(mod, case)
    params = inspect.signature(fn).parameters
    result = fn(**{p: fixtures[p] for p in params})
    if inspect.iscoroutine(result):
        asyncio.run(result)
