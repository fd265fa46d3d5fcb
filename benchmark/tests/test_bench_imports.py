"""Import hygiene: no module of the benchmark imports the JAX stack or
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's), and the reference imports nothing of the
program."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bayesian_cbf_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        names = set(_imports(f))
        assert "bayesian_cbf_tpu_torch" not in names, f
        assert names <= {"__future__", "math", "typing", "torch"}, (f, names)


def test_the_hygiene_check_compares_whole_names():
    from benchmark.harness import FORBIDDEN as RUNTIME
    assert set(RUNTIME) == FORBIDDEN
    assert "bayesian_cbf_tpu_torch".split(".")[0] not in FORBIDDEN
