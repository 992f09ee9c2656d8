"""No module of the harness imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import ast
from pathlib import Path

from portbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_forbidden_by_whole_top_level_name():
    assert forbidden_modules(["sharkshark_tpu_torch", "sharkshark_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "sharkshark_tpu",
                              "sharkshark_tpu.ops"]) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                                         "sharkshark_tpu", "sharkshark_tpu.ops"]


def test_no_harness_module_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not forbidden_modules(_imports(p)), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(p)}
        assert not tops & {"sharkshark_tpu_torch", "sharkshark_tpu", "jax", "jaxlib", "flax"}, p
