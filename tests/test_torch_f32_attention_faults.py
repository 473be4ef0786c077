"""PyTorch port: the planted faults of ``scripts/attention_f32_faults.py``
still match the f32 attention sources they patch.

The script runs on a GPU only; here its constants are read as text
(``ast``), so nothing of it is imported.  Each patch's target must occur
exactly once in its source, or the script would plant nothing (or
something else) in the kernel under test.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "attention_f32_faults.py"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


class _Known(ast.NodeTransformer):
    """Replaces each name bound earlier to a literal by that literal."""

    def __init__(self, known):
        self.known = known

    def visit_Name(self, node):
        return ast.Constant(self.known[node.id]) if node.id in self.known else node


def _constants():
    """{name: value} of the script's top-level assignments of literals, and
    of names bound to literals (the faults name their source by constant)."""
    out = {}
    for node in ast.parse(SCRIPT.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name):
                try:
                    out[target.id] = ast.literal_eval(_Known(out).visit(node.value))
                except ValueError:
                    pass
    return out


CONSTANTS = _constants()
FAULTS = CONSTANTS["FAULTS"]


def test_faults_patch_both_f32_sources_beside_the_build():
    build = (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").read_text()
    sources = {CONSTANTS["FORWARD"], CONSTANTS["BACKWARD"], CONSTANTS["BACKWARD_ENTRY"]}
    assert sources == {"flash_attention.cu", "flash_attention_bwd.cu",
                       "flash_attention_bwd_sm90.cu"}
    for source in sources:
        assert (CSRC / source).is_file() and f'"{source}"' in build
    assert len(FAULTS) >= 5 and len({name for name, _, _ in FAULTS}) == len(FAULTS)
    assert {source for _, source, _ in FAULTS} == {CONSTANTS["FORWARD"], CONSTANTS["BACKWARD"]}


@pytest.mark.parametrize("name,source,patches", FAULTS, ids=[name for name, _, _ in FAULTS])
def test_each_f32_fault_target_occurs_once_in_its_source(name, source, patches):
    text = (CSRC / source).read_text()
    assert patches
    for old, new in patches:
        assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times"
        assert new != old
        text = text.replace(old, new)
