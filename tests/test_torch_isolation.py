"""The PyTorch port stands alone: no file of sharkshark_tpu_torch/ and
not chip_smoke.py imports JAX (or optax, orbax), anything of the JAX
package or of its experiments/ (where K4's Pallas kernel lives), and
importing the port loads none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sharkshark_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "sharkshark_tpu", "experiments")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert path.exists()
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import sharkshark_tpu_torch.upscale, sharkshark_tpu_torch.ops.tsm_conv\n"
        "import sharkshark_tpu_torch.ops._build, sharkshark_tpu_torch.ops.warp\n"
        "import sharkshark_tpu_torch.pipeline, sharkshark_tpu_torch.main.upscaler\n"
        "import sharkshark_tpu_torch.models.egvsr, sharkshark_tpu_torch.stream\n"
        "import sharkshark_tpu_torch.ops.conv_stack, sharkshark_tpu_torch.upscale.tile\n"
        "import sharkshark_tpu_torch.models.srvgg, sharkshark_tpu_torch.models.bsvd\n"
        "import sharkshark_tpu_torch.image_server, sharkshark_tpu_torch.stream.youtube\n"
        "import sharkshark_tpu_torch.tools.load_test\n"
        "import sharkshark_tpu_torch.train, sharkshark_tpu_torch.train.driver\n"
        "import sharkshark_tpu_torch.tools.make_derived_dataset\n"
        "import sharkshark_tpu_torch.train.vsrgan, sharkshark_tpu_torch.train.discriminators\n"
        "import sharkshark_tpu_torch.train.vgg, sharkshark_tpu_torch.models.variants\n"
        "import sharkshark_tpu_torch.tools.export_torch_srvgg, sharkshark_tpu_torch.tools.export_torch_egvsr\n"
        "import sharkshark_tpu_torch.tools.export_torch_bsvd, sharkshark_tpu_torch.tools.quality_eval\n"
        "import sharkshark_tpu_torch.tools.export_model, sharkshark_tpu_torch.tools.bench_dispatch\n"
        "import sharkshark_tpu_torch.tools.warp_fidelity, sharkshark_tpu_torch.tools.ingest_weights\n"
        "import sharkshark_tpu_torch.tools.bench_matrix, sharkshark_tpu_torch.tools.mint_lpips\n"
        "import sharkshark_tpu_torch.parallel, sharkshark_tpu_torch.ops, sharkshark_tpu_torch.models\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
