"""The port stands alone: neither ``parallax_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, by their source and
in a live interpreter where JAX cannot be imported at all."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "parallax_tpu")


def _sources():
    files = sorted((ROOT / "parallax_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'parallax_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import parallax_tpu_torch\n"
        "from parallax_tpu_torch import weights\n"
        "from parallax_tpu_torch.ops import flash_attention, "
        "paged_attention, _cuda\n"
        "from parallax_tpu_torch.serve import session, adapters\n"
        "from parallax_tpu_torch.ops import lstm, sampled_softmax, "
        "sparse_optim\n"
        "from parallax_tpu_torch.core import classify, engine, mesh, "
        "optim, specs\n"
        "from parallax_tpu_torch import runner\n"
        "from parallax_tpu_torch.models import lm1b\n"
        "from parallax_tpu_torch.models import cnn, cnn_zoo, resnet, "
        "simple, bert, nmt\n"
        "from parallax_tpu_torch.ops import tensor_parallel\n"
        "from parallax_tpu_torch.ops import ring_attention\n"
        "from parallax_tpu_torch.models import long_context\n"
        "from parallax_tpu_torch.serve.adapters import "
        "CausalLMDecodeProgram, standalone_greedy\n"
        "from parallax_tpu_torch.ops import moe\n"
        "from parallax_tpu_torch.models import moe_lm\n"
        "from parallax_tpu_torch.common import evaluation\n"
        "from parallax_tpu_torch.serve.adapters import "
        "MoeLMDecodeProgram\n"
        "assert parallax_tpu_torch.moe_lm is moe_lm\n"
        "assert parallax_tpu_torch.MoeLMDecodeProgram is "
        "MoeLMDecodeProgram\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location("
        "'chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert 'jax' not in [m for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
