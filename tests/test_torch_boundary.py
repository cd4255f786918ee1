"""The port's boundaries: no JAX inside it, and no silent fall back to the CPU.

* No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports ``jax``,
  the JAX package ``repro`` or ``ml_dtypes`` (an AST scan of every import;
  the machine with the card has no ``ml_dtypes``).
* ``import repro_torch`` works with ``jax`` blocked.
* Asking for the card where there is none raises; it never runs on the CPU.
* ``chip_smoke.py`` fails, and prints no result, without a card or without
  the repository beside it.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_works_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[name] = None  # any import of them now raises\n"
        "import repro_torch, repro_torch.kernels.ops, repro_torch.serving.engine\n"
        "import repro_torch.data.synthetic, repro_torch.kernels.ref\n"
        "import repro_torch.accounting, repro_torch.core.ivf, repro_torch.core.kmeans\n"
        "import repro_torch.kernels.rescore, repro_torch.kernels.ivf_scan\n"
        "import repro_torch.kernels.pq_scan, repro_torch.core.pq\n"
        "import repro_torch.serving.service, repro_torch.launch.serve\n"
        "import repro_torch.configs.two_tower, repro_torch.models.recsys\n"
        "import repro_torch.models.nn, repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.steps, repro_torch.train.optim\n"
        "import repro_torch.configs.registry, repro_torch.configs.base\n"
        "import repro_torch.models.gnn, repro_torch.data.graphs, repro_torch.launch.train\n"
        "import repro_torch.train.checkpoint, repro_torch.train.loop\n"
        "import repro_torch.models.attention, repro_torch.models.moe\n"
        "import repro_torch.models.transformer, repro_torch.configs.knn_paper\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_stats\n"
        "import repro_torch.train.compression\n"
        "from repro_torch.configs import registry\n"
        "for arch_id in registry.ASSIGNED:\n"
        "    registry.get(arch_id).abstract_params(registry.get(arch_id).full_config())\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_default_device_raises_without_cuda():
    from repro_torch.core.knn import knn_query
    from repro_torch.kernels._backend import resolve_device
    from repro_torch.serving.index import RetrievalIndex

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalIndex.build([1, 2], torch.ones(2, 8).numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # Tensor entry points follow the tensor: a CPU tensor stays on the CPU.
    x = torch.randn(6, 4)
    assert knn_query(x, x, 2).indices.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)  # alone, without the repository
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, env=env, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout and '"kernels"' not in proc.stdout
