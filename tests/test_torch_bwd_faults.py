"""PyTorch port: the planted faults of ``scripts/attention_bwd_faults.py``,
``scripts/ssd_scan_bwd_faults.py`` and ``scripts/router_bwd_faults.py``
still match the kernel sources they patch, as does the reverse scan's path
choice that ``scripts/bwd_kernels_ab.py --scan-4-byte-path`` forces.

The scripts run on a GPU only; here their ``SOURCE`` and ``FAULTS`` are read
as text (``ast``), so nothing of them is imported.  Each patch's target
must occur exactly once in that source, or the script would plant nothing
(or something else) in the kernel under test.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "attention_bwd_faults.py"
SCAN_SCRIPT = ROOT / "scripts" / "ssd_scan_bwd_faults.py"
ROUTER_SCRIPT = ROOT / "scripts" / "router_bwd_faults.py"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def _constants(script=SCRIPT):
    """{name: value} of the script's top-level literal assignments."""
    out = {}
    for node in ast.parse(script.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name):
                try:
                    out[target.id] = ast.literal_eval(node.value)
                except ValueError:
                    pass
    return out


CONSTANTS = _constants()
FAULTS = CONSTANTS["FAULTS"]


def test_faults_patch_the_bf16_backward_source():
    source = CONSTANTS["SOURCE"]
    assert source == "flash_attention_bwd_sm90.cu"
    assert (CSRC / source).is_file()
    build = (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").read_text()
    assert f'"{source}"' in build and f'"{CONSTANTS["ENTRY"]}"' in build
    assert len(FAULTS) == 5 and len({name for name, _ in FAULTS}) == 5


@pytest.mark.parametrize("name,patches", FAULTS, ids=[name for name, _ in FAULTS])
def test_each_fault_target_occurs_once_in_the_source(name, patches):
    text = (CSRC / CONSTANTS["SOURCE"]).read_text()
    assert patches
    for old, new in patches:
        assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times"
        assert new != old
        text = text.replace(old, new)


SCAN_CONSTANTS = _constants(SCAN_SCRIPT)
SCAN_FAULTS = SCAN_CONSTANTS["FAULTS"]


def test_scan_faults_patch_the_reverse_scan_source():
    source = SCAN_CONSTANTS["SOURCE"]
    assert source == "ssd_scan_bwd.cu"
    build = (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").read_text()
    assert f'"{source}"' in build and (CSRC / source).is_file()
    assert [name for name, _ in SCAN_FAULTS] == [
        "the walk runs forwards", "a[c] dropped from the carry", "g_final ignored",
        "cluster rank 1's partial left out of d_decays",
        "a prefetch stage hands the walk the next step's chunk"]


def test_scan_fault_script_sizes_clusters_as_the_source():
    """The script's copy of the kernel's per-pass capacity (which decides
    the cases a cluster fault touches) is the source's."""
    text = (CSRC / SCAN_CONSTANTS["SOURCE"]).read_text()
    assert "constexpr int CAP = NTC * EPT;" in text
    assert "constexpr int NTC = 32 * CW;" in text
    cw = int(text.split("constexpr int CW = ")[1].split(";")[0])
    ept = int(text.split("constexpr int EPT = ")[1].split(";")[0])
    assert SCAN_CONSTANTS["CAP"] == 32 * cw * ept


@pytest.mark.parametrize("name,patches", SCAN_FAULTS, ids=[name for name, _ in SCAN_FAULTS])
def test_each_scan_fault_target_occurs_once_in_the_source(name, patches):
    text = (CSRC / SCAN_CONSTANTS["SOURCE"]).read_text()
    assert patches
    for old, new in patches:
        assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times"
        assert new != old
        text = text.replace(old, new)


ROUTER_CONSTANTS = _constants(ROUTER_SCRIPT)
ROUTER_FAULTS = ROUTER_CONSTANTS["FAULTS"]


def test_router_faults_patch_the_router_backward_source():
    source = ROUTER_CONSTANTS["SOURCE"]
    assert source == "moe_router_bwd.cu"
    build = (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").read_text()
    assert f'"{source}"' in build and (CSRC / source).is_file()
    assert [name for name, _ in ROUTER_FAULTS] == ["s_j taken from the wrong lane",
                                                   "ds never scattered", "gprobs ignored"]


@pytest.mark.parametrize("name,patches", ROUTER_FAULTS,
                         ids=[name for name, _ in ROUTER_FAULTS])
def test_each_router_fault_target_occurs_once_in_the_source(name, patches):
    text = (CSRC / ROUTER_CONSTANTS["SOURCE"]).read_text()
    assert patches
    for old, new in patches:
        assert text.count(old) == 1, f"{name}: {old!r} occurs {text.count(old)} times"
        assert new != old
        text = text.replace(old, new)


AB_CONSTANTS = _constants(ROOT / "scripts" / "bwd_kernels_ab.py")


def test_ab_script_forces_the_scan_onto_its_4_byte_path():
    """``bwd_kernels_ab.py --scan-4-byte-path`` patches the reverse scan's
    choice of path: its target occurs once in the source's C entry."""
    old, new = AB_CONSTANTS["TMA_CHOICE"], AB_CONSTANTS["NO_TMA"]
    text = (CSRC / "ssd_scan_bwd.cu").read_text()
    assert text.count(old) == 1 and new != old
    entry = text[text.index('extern "C" int ssd_scan_bwd('):]
    assert old in entry and "launch<true> : launch<false>" in entry
