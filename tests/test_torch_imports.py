"""Import hygiene of the PyTorch/CUDA port.

`dynamo_tpu_torch` and `chip_smoke.py` import torch, numpy and the standard
library only: never jax, never anything of the JAX package `dynamo_tpu`,
never another third-party package (Triton, if ever used, only inside a
launching function). Importing the package on a machine without a CUDA
device or nvcc succeeds and builds nothing.
"""

import ast
import importlib
import pkgutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dynamo_tpu_torch"
ALLOWED_THIRD_PARTY = {"torch", "numpy"}
# serving-plane packages the reference uses that the machine with the card
# does not have: the port's runtime is written on the standard library
FORBIDDEN = {"msgpack", "aiohttp", "xxhash", "pydantic", "prometheus_client", "ml_dtypes",
             # checkpoint and tokenizer packages: the port reads safetensors,
             # GGUF and the HF hub cache with the standard library
             "safetensors", "huggingface_hub", "transformers", "tokenizers",
             # HTTP clients and KServe gRPC: the frontend serves HTTP on
             # asyncio streams and refuses --grpc-port
             "httpx", "grpc", "google"}
# allowed inside a function body, never at module level: triton where a
# kernel launches; jinja2 (a dependency of torch itself, on the card's
# machine as wherever torch is installed) where OpenAIPreprocessor compiles
# a chat template; scipy (on the card's machine) where the planner's
# interpolators build their cubic surfaces, as the reference's do
LAZY_ONLY = {"triton", "jinja2", "scipy"}
STDLIB = set(sys.stdlib_module_names)


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imports(tree):
    """(top-level module name, relative level, at module level?) per import."""
    out = []

    def visit(node, top):
        for child in ast.iter_child_nodes(node):
            inner = top and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], 0, top) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append(((child.module or "").split(".")[0], child.level, top))
            visit(child, inner)

    visit(tree, True)
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_only_torch_numpy_stdlib(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, level, at_top in _imports(tree):
        if level:  # relative import: stays inside dynamo_tpu_torch
            assert path != ROOT / "chip_smoke.py"
            continue
        assert name not in ("jax", "jaxlib", "flax"), f"{path}: imports {name}"
        assert name != "dynamo_tpu", f"{path}: imports the JAX package"
        assert name not in FORBIDDEN, (
            f"{path}: imports {name}, which the machine with the card does not "
            "have (the port's runtime uses the standard library instead)"
        )
        if name == "dynamo_tpu_torch" or name in STDLIB or name in ALLOWED_THIRD_PARTY:
            continue
        assert name in LAZY_ONLY and not at_top, f"{path}: imports {name}"


def test_no_source_names_the_reference_package_in_code():
    """String-built imports would dodge the AST walk: no `import_module` or
    `__import__` call in the port."""
    for path in _sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = getattr(fn, "id", None) or getattr(fn, "attr", None)
                assert name not in ("import_module", "__import__"), path


def test_importing_every_module_builds_nothing_and_pulls_no_jax():
    """Run in a fresh interpreter so this test file's own imports (and other
    tests' jax) do not mask what the package itself imports."""
    import subprocess

    code = (
        "import sys, importlib, pkgutil\n"
        "import dynamo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, 'dynamo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dynamo_tpu', 'triton', 'msgpack', 'ml_dtypes', 'safetensors', 'huggingface_hub', 'transformers', 'tokenizers', 'jinja2', 'aiohttp', 'pydantic', 'prometheus_client', 'httpx', 'scipy')]\n"
        "assert not bad, bad\n"
        "from dynamo_tpu_torch.ops import _build\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "print(len(names))\n"
    )
    before = set(p.name for p in (PKG / "build").glob("*")) if (PKG / "build").exists() else set()
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25
    after = set(p.name for p in (PKG / "build").glob("*")) if (PKG / "build").exists() else set()
    assert after == before


@pytest.mark.parametrize("module", ["kvbm.checkpoint", "llm.migration", "llm.guided",
                                    "engine.spec", "models.lora", "models.lora_pool",
                                    "llm.parsers.tool_calling", "gate.gate",
                                    "llm.kv_router.indexer", "llm.backend",
                                    "planner.profiler", "planner.perf_interpolation",
                                    "planner.load_predictor", "planner.planner_core",
                                    "planner.metrics_source", "planner.connector",
                                    "planner.soak", "planner.__init__", "planner.__main__",
                                    "llm.mocker.engine", "llm.mocker.kv_manager",
                                    "mocker.__main__", "llm.http.client"])
def test_copied_reference_modules_stand_alone(module):
    """The port's own copies of reference modules that hold no JAX: alone in
    a fresh interpreter they pull in neither jax nor the JAX package, nor
    aiohttp (the card's machine has none), nor scipy (the interpolators
    import it inside their constructors)."""
    import subprocess

    path = PKG / (module.replace(".", "/") + ".py")
    assert path in _sources()
    code = (
        "import sys, importlib\n"
        f"importlib.import_module('dynamo_tpu_torch.{module.removesuffix('.__init__')}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'dynamo_tpu', 'aiohttp', 'scipy')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_frontend_imports_no_torch():
    """The frontend shares the card with its workers and does no device
    work: its modules load neither torch nor jinja2 until a preprocessor is
    built, so it can never create a CUDA context."""
    import subprocess

    code = (
        "import sys\n"
        "import dynamo_tpu_torch.frontend.__main__ as m\n"
        "import dynamo_tpu_torch.llm.kv_router, dynamo_tpu_torch.gate\n"
        "m.parse_args(['--router-mode', 'kv'])\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('torch', 'jinja2', 'numpy')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_walk_finds_every_subpackage():
    names = {m.name for m in pkgutil.walk_packages([str(PKG)], "dynamo_tpu_torch.")}
    for expected in ("engine.engine", "engine.scheduler.policy", "ops.paged_attention",
                     "ops.hopper_ragged_attention", "models.llama", "llm.tokens",
                     "llm.protocols.common", "runtime.engine", "runtime.msgpack_lite",
                     "runtime.request_plane", "runtime.discovery", "llm.model_card",
                     "llm.kv_router.publisher", "worker.__main__", "llm.kv_transfer",
                     "llm.disagg", "worker.disagg_handler", "models.loader",
                     "models.safetensors_io", "llm.gguf", "kvbm.storage", "kvbm.manager",
                     "kvbm.distributed", "runtime.system_status", "runtime.health_check",
                     "kvbm.checkpoint", "llm.migration", "llm.guided", "engine.spec",
                     "models.lora", "models.lora_pool", "runtime.pipeline", "runtime.compute",
                     "llm.protocols.openai", "llm.parsers.jail", "llm.preprocessor",
                     "llm.backend", "llm.service", "llm.discovery", "llm.kv_router.indexer",
                     "llm.kv_router.scheduler", "gate.gate", "gate.signals", "llm.http.metrics",
                     "llm.http.server", "llm.http.service", "frontend.__main__",
                     "planner.profiler", "planner.perf_interpolation", "planner.load_predictor",
                     "planner.planner_core", "planner.metrics_source", "planner.connector",
                     "planner.soak", "planner.__main__", "llm.mocker.engine",
                     "mocker.__main__", "llm.http.client"):
        assert f"dynamo_tpu_torch.{expected}" in names
    importlib.import_module("dynamo_tpu_torch.ops._build")


def test_cuda_tensor_dispatch_has_no_cpu_fallback():
    """The dispatchers choose by the tensor's device alone; the kernel
    wrappers refuse CPU tensors instead of computing something else."""
    import torch

    from dynamo_tpu_torch.ops import hopper_paged_attention as hp

    q = torch.zeros(1, 4, 16)
    kv = torch.zeros(4, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        hp.paged_attention_decode_hopper(
            q, kv, kv, torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    assert hp.launch_count == 0
