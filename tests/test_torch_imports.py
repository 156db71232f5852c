"""paddle_tpu_torch stands alone: no module of the port, not the on-card
smoke script ``chip_smoke.py`` and not the card-only tests
``tests/test_torch_cuda.py`` import JAX or any module of the
JAX package ``paddle_tpu`` (its ``distributed`` package included: the
port's mesh, collectives and parallel training are its own copies) — checked statically (an AST scan of every
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
    return files + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py",
                    ROOT / "tests/test_torch_cuda_declarative.py"]


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
                "paddle_tpu_torch.optimizer.optimizer",
                "paddle_tpu_torch.serving.spec_decode",
                "paddle_tpu_torch.ops.paged_attention",
                "paddle_tpu_torch.text.generation",
                "paddle_tpu_torch.distributed",
                "paddle_tpu_torch.distributed.mesh",
                "paddle_tpu_torch.distributed.lax",
                "paddle_tpu_torch.distributed.env",
                "paddle_tpu_torch.distributed.gloo",
                "paddle_tpu_torch.distributed.collective",
                "paddle_tpu_torch.distributed.parallel_layers",
                "paddle_tpu_torch.distributed.parallel",
                "paddle_tpu_torch.distributed.zero",
                "paddle_tpu_torch.distributed.ring_attention",
                "paddle_tpu_torch.distributed.pipeline",
                "paddle_tpu_torch.distributed.hybrid_step",
                "paddle_tpu_torch.distributed.spawn",
                "paddle_tpu_torch.distributed.launch",
                "paddle_tpu_torch.distributed.entry",
                "paddle_tpu_torch.tensor",
                "paddle_tpu_torch.autograd",
                "paddle_tpu_torch.amp.auto_cast",
                "paddle_tpu_torch.framework.place",
                "paddle_tpu_torch.framework.random",
                "paddle_tpu_torch.framework.flags",
                "paddle_tpu_torch.ops.dispatch",
                "paddle_tpu_torch.ops.scale_shift",
                "paddle_tpu_torch.nn.layer",
                "paddle_tpu_torch.utils.custom_op",
                "paddle_tpu_torch.vision.models.lenet",
                "paddle_tpu_torch.vision.datasets.mnist",
                "paddle_tpu_torch.framework.errors",
                "paddle_tpu_torch.framework.concurrency",
                "paddle_tpu_torch.framework.monitor",
                "paddle_tpu_torch.framework_io",
                "paddle_tpu_torch.io",
                "paddle_tpu_torch.io.checkpoint",
                "paddle_tpu_torch.profiler",
                "paddle_tpu_torch.profiler.flight_recorder",
                "paddle_tpu_torch.profiler.slo",
                "paddle_tpu_torch.profiler.exposition",
                "paddle_tpu_torch.serving.metrics",
                "paddle_tpu_torch.serving.router",
                "paddle_tpu_torch.serving.frontend",
                "paddle_tpu_torch.serving.http",
                "paddle_tpu_torch.serving.kv_transport",
                "paddle_tpu_torch.profiler.tracer",
                "paddle_tpu_torch.profiler.chrome_trace",
                "paddle_tpu_torch.utils.profiler",
                "paddle_tpu_torch.inference",
                "paddle_tpu_torch.inference.config",
                "paddle_tpu_torch.ops._helpers",
                "paddle_tpu_torch.ops.creation",
                "paddle_tpu_torch.ops.manipulation",
                "paddle_tpu_torch.nn.functional.activation",
                "paddle_tpu_torch.nn.functional.common",
                "paddle_tpu_torch.nn.common_layers",
                "paddle_tpu_torch.nn.container",
                "paddle_tpu_torch.nn.norm_layers",
                "paddle_tpu_torch.nn.rnn",
                "paddle_tpu_torch.nn.transformer",
                "paddle_tpu_torch.nn.decode",
                "paddle_tpu_torch.regularizer",
                "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.nn.clip_grad",
                "paddle_tpu_torch.nn.loss_layers",
                "paddle_tpu_torch.io.dataset",
                "paddle_tpu_torch.io.sampler",
                "paddle_tpu_torch.io.dataloader",
                "paddle_tpu_torch.metric",
                "paddle_tpu_torch.metric.metrics",
                "paddle_tpu_torch.hapi",
                "paddle_tpu_torch.hapi.callbacks",
                "paddle_tpu_torch.hapi.summary",
                "paddle_tpu_torch.hapi.model",
                "paddle_tpu_torch.hapi.checkpoint",
                "paddle_tpu_torch.hapi.anomaly",
                "paddle_tpu_torch.amp",
                "paddle_tpu_torch.amp.grad_scaler",
                "paddle_tpu_torch.testing.chaos",
                "paddle_tpu_torch.jit",
                "paddle_tpu_torch.jit.functional",
                "paddle_tpu_torch.ops.fused_norm",
                "paddle_tpu_torch.nn.functional.norm",
                "paddle_tpu_torch.nn.functional.conv",
                "paddle_tpu_torch.nn.functional.pooling",
                "paddle_tpu_torch.nn.conv_layers",
                "paddle_tpu_torch.nn.pool_layers",
                "paddle_tpu_torch.nn.activation_layers",
                "paddle_tpu_torch.vision.models",
                "paddle_tpu_torch.vision.models.resnet",
                "paddle_tpu_torch.vision.models.vgg",
                "paddle_tpu_torch.vision.models.mobilenet",
                "paddle_tpu_torch.text.models",
                "paddle_tpu_torch.compat",
                "paddle_tpu_torch.param_attr",
                "paddle_tpu_torch.framework.dtype",
                "paddle_tpu_torch.ops.math",
                "paddle_tpu_torch.ops.linalg",
                "paddle_tpu_torch.ops.logic",
                "paddle_tpu_torch.ops.search",
                "paddle_tpu_torch.ops.random_ops",
                "paddle_tpu_torch.utils.unique_name",
                "paddle_tpu_torch.text",
                "paddle_tpu_torch.vision",
                "paddle_tpu_torch.sparse_grad",
                "paddle_tpu_torch.nn.functional.extension",
                "paddle_tpu_torch.nn.layers_extra",
                "paddle_tpu_torch.framework._globals",
                "paddle_tpu_torch.framework.init",
                "paddle_tpu_torch.framework.op_version",
                "paddle_tpu_torch.framework.export_compat",
                "paddle_tpu_torch.static",
                "paddle_tpu_torch.static._mode",
                "paddle_tpu_torch.static.program",
                "paddle_tpu_torch.static.nn",
                "paddle_tpu_torch.static.compat",
                "paddle_tpu_torch.static.debugging",
                "paddle_tpu_torch.jit.control_flow",
                "paddle_tpu_torch.jit.dy2static",
                "paddle_tpu_torch.jit.to_static",
                "paddle_tpu_torch.jit.save_load",
                "paddle_tpu_torch.inference.predictor",
                "paddle_tpu_torch.onnx",
                "paddle_tpu_torch.onnx.export"):
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
