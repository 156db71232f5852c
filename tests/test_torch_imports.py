"""paddle_tpu_torch stands alone: no module of the port, not the on-card
smoke script ``chip_smoke.py`` and not the card-only tests
``tests/test_torch_cuda.py`` import JAX or any module of the
JAX package ``paddle_tpu`` — checked statically (an AST scan of every
import statement) and at run time (a fresh interpreter imports every
module and inspects ``sys.modules``)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _sources():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    # chip_smoke.py and the card-only tests run where JAX is not installed
    return files + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py"]


def _modules():
    out = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] == len(_modules()) and res["bad"] == []
    for mod in ("paddle_tpu_torch.slim", "paddle_tpu_torch.slim.serving_export",
                "paddle_tpu_torch.ops.quantized_matmul",
                "paddle_tpu_torch.ops.flash_attention",
                "paddle_tpu_torch.ops.attention",
                "paddle_tpu_torch.nn.functional",
                "paddle_tpu_torch.nn.functional.loss",
                "paddle_tpu_torch.optimizer",
                "paddle_tpu_torch.optimizer.optimizer"):
        assert mod in _modules()


def test_chip_smoke_refuses_to_run_without_a_card():
    """Where torch sees no CUDA card the script exits nonzero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
