"""What the benchmark loads: never JAX or the JAX package
``audiosourcesep_tpu`` (top-level names compared whole: the port's
``audiosourcesep_tpu_torch`` begins with it), and, in ``reference/``,
nothing of the port."""

import ast
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "audiosourcesep_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = ["import portbench.run, portbench.harness, portbench.calibrate",
            "from portbench import spec",
            "[spec.metric_reader(m) for m in spec.names('metrics')]",
            "[spec.arch(spec.cell(w).config['arch']) for w in "
            "spec.names('workloads')]",
            "import audiosourcesep_tpu_torch.separation, "
            "audiosourcesep_tpu_torch.models"]
    loaded = _loaded("\n".join(code))
    assert "audiosourcesep_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import portbench.reference.ncsn_v1, "
                     "portbench.reference.glow, portbench.reference.basis, "
                     "portbench.weights")
    assert not loaded & (FORBIDDEN | {"audiosourcesep_tpu_torch"})


@pytest.mark.parametrize("path", sorted(
    (spec.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_themselves(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops = {"." if node.level else node.module.split(".")[0]}
        else:
            continue
        assert tops <= {"torch", "numpy", "math", "typing", "contextlib",
                        "__future__", "."}, (path.name, tops)


def test_forbidden_names_compare_whole_top_level_names():
    from portbench import harness
    before = dict(sys.modules)
    try:
        sys.modules["audiosourcesep_tpu_torch_x"] = sys
        assert "audiosourcesep_tpu" not in harness.forbidden_modules()
        sys.modules["audiosourcesep_tpu.ops"] = sys
        assert "audiosourcesep_tpu" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
