"""No run loads JAX or the JAX package, and the reference imports nothing
of the program; module names are compared whole, by their top level."""

import ast
import subprocess
import sys

from portbench import harness


def test_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.serve.engine"]) == []
    assert harness.forbidden_modules(["reprox", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["repro.core.names", "torch"]) == ["repro"]
    assert harness.forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    """The shared reference imports nothing of the program, and a family
    module (whose blocks the reference runs) imports it only inside the
    functions that build or patch the port."""
    for name in ("reference.py", "yardstick.py", "weights.py", "gen.py"):
        tops = {m.split(".")[0] for m in _imports(harness.HERE / name)}
        assert "repro_torch" not in tops, name
    code = ("import sys; import portbench.reference, portbench.yardstick, portbench.weights, "
            "portbench.gen; from portbench import families; "
            "[families.named(f) for f in families.present()]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    """A small run on the CPU, in a process of its own: at its end no module
    of JAX or of the JAX package is loaded."""
    code = (
        "import sys, time; sys.path[:0] = ['.', 'src', 'portbench/tests']\n"
        "import torch; from portbench import harness; import small\n"
        "cell = harness.cell_of(harness.load_benchmark(),"
        " 'mistral-large-123b.l11.serve.chat')\n"
        "rec = harness.run_cell(cell, small.SEED, 0.5, False, torch.device('cpu'),"
        " time.perf_counter(), cfg=small.small_config('mistral-large-123b.l11'),"
        " traffic=small.small_traffic('serve.chat'))\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "mistral-large-123b.l11.serve.chat", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    import torch
    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout == ""
