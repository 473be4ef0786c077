"""The family seam: a configuration resolves to its family's module; the
dense family draws, counts and reads exactly what the benchmark did before
the seam (the values below were taken from the dense code before it moved
behind the seam); no module outside the dense family knows a dense leaf or
the port's dense model; and a cell of another family is added as new files
and entries alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import small
from portbench import families, harness, weights
from portbench.families import dense

CONFIGS = ("qwen3-1.7b", "mistral-large-123b.l11")
SEEDS = (small.SEED, 7)

# sha256 (first 16 hex digits) over each leaf's name and bf16 bytes, by group
DRAWS = {
    ("qwen3-1.7b", small.SEED): {-1: "954d1cfa4a3b5afa", 0: "748ed07740c61b8e",
                                 1: "ccb47fa86b9928a4"},
    ("qwen3-1.7b", 7): {-1: "0a562d402774d92e", 0: "fdb922a906eb229d", 1: "59187776803281a0"},
    ("mistral-large-123b.l11", small.SEED): {-1: "c7ad4d48b4b76f27", 0: "d28c48144a76b175",
                                             1: "e4d741bc5ab0d696"},
    ("mistral-large-123b.l11", 7): {-1: "57906b3335055380", 0: "85943096dc47a0e6",
                                    1: "d659e7830a3609bb"},
}


def _digest(leaves):
    h = hashlib.sha256()
    for name, t in leaves.items():
        h.update(name.encode())
        h.update(t.contiguous().view(torch.int16).numpy().tobytes())
    return h.hexdigest()[:16]


def test_a_configuration_resolves_to_its_family():
    cfg = harness.load_json(harness.HERE / "configs" / "qwen3-1.7b.json")
    assert families.of(cfg) is dense and "dense" in families.present()
    with pytest.raises(ValueError, match=r"names no \"family\".*'dense'"):
        families.of({k: v for k, v in cfg.items() if k != "family"})
    with pytest.raises(ValueError, match=r"no family 'sparse'.*'dense'"):
        families.of(dict(cfg, family="sparse"))


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_draws_are_unchanged(config, seed):
    cfg = small.small_config(config)
    fam = families.of(cfg)
    s = fam.spec_of(cfg)
    got = {g: _digest(weights.draw_group(fam, s, seed, g, torch.device("cpu")))
           for g in fam.groups(s)}
    assert got == DRAWS[(config, seed)]


def test_dense_counts_are_unchanged():
    q, m = (dense.spec_of(small.small_config(c)) for c in CONFIGS)
    assert [dense.prefill_counts(q, n) for n in (1, 17, 40)] == [
        {"flops": 180736.0, "bytes": 181248.0}, {"flops": 2617856.0, "bytes": 185344.0},
        {"flops": 6350848.0, "bytes": 191232.0}]
    assert [dense.prefill_counts(m, n) for n in (1, 17, 40)] == [
        {"flops": 180736.0, "bytes": 181248.0}, {"flops": 2617856.0, "bytes": 187392.0},
        {"flops": 6350848.0, "bytes": 196224.0}]
    assert dense.decode_step_counts(q, 3, 77, 4, 78) == {"flops": 580096.0, "bytes": 204032.0}
    assert dense.decode_step_counts(m, 3, 77, 4, 78) == {"flops": 580096.0, "bytes": 204416.0}
    assert dense.train_flops(q, 2, 64) == 75792384.0
    assert dense.train_flops(m, 2, 64) == 88326144.0
    fq, fm = (dense.spec_of(harness.load_json(harness.HERE / "configs" / f"{c}.json"))
              for c in CONFIGS)
    assert [dense.prefill_counts(fq, n) for n in (1, 1020, 2560)] == [
        {"flops": 3441131520.0, "bytes": 3441264640.0},
        {"flops": 2995004440576.0, "bytes": 3558131712.0},
        {"flops": 7968080265216.0, "bytes": 3734751232.0}]
    assert [dense.prefill_counts(fm, n) for n in (1, 1020, 2560)] == [
        {"flops": 31256494080.0, "bytes": 31256588288.0},
        {"flops": 31341998604288.0, "bytes": 31327543296.0},
        {"flops": 79726827798528.0, "bytes": 31434776576.0}]
    assert dense.decode_step_counts(fq, 200, 300000, 256, 300056) == {
        "flops": 756993228800.0, "bytes": 37942052864.0}
    assert dense.decode_step_counts(fm, 200, 300000, 256, 300056) == {
        "flops": 6413392281600.0, "bytes": 44932079616.0}
    assert dense.train_flops(fq, 2, 4096) == 96114573312000.0
    assert dense.train_flops(fm, 2, 4096) == 815164324577280.0


def _record():
    """Two window iterations, two traced ones and five training steps at
    the small qwen3 shape, with each traced op's device seconds."""
    it = lambda t, phase, prefills, active, pos, all_pos: {  # noqa: E731
        "t": t, "phase": phase, "prefills": prefills, "active": active, "active_pos": pos,
        "rows": 4, "all_pos": all_pos}
    return {"spec": dense.spec_of(small.small_config("qwen3-1.7b")), "family": "dense",
            "rows": 2, "seq": 64, "trace_steps": 3,
            "steps": [{"t": 0.1 * k, "loss": 1.0} for k in range(1, 6)],
            "window": {"open": 0.0, "close": 0.5, "seconds": 0.5},
            "iterations": [it(0.1, "window", [17, 40], 0, 0, 0), it(0.2, "window", [], 3, 77, 78),
                           it(0.3, "trace_ops", [23], 2, 50, 52),
                           it(0.4, "trace_ops", [], 4, 90, 90)],
            "trace_ops": {"op_device_s": {"repro_torch::flash_decode": 3e-5,
                                          "repro_torch::flash_attention_infer": 2e-5,
                                          "repro_torch::flash_attention": 4e-5,
                                          "repro_torch::flash_attention_bwd": 9e-5}}}


READINGS = {
    "mfu.serve": (3.466316417910448e-05, "mfu.serve: roofline bound 1.733158208955224e-07 s of "
                  "3 prefills and steps over 0.5 s"),
    "mfu.train": (7.66353731041456e-05, "mfu.train: 378961920.0 model FLOPs over 0.5 s at "
                  "989000000000000.0"),
    "flash_decode_roofline": (0.04024676616915423, "flash_decode_roofline: bound "
                              "1.2074029850746269e-08 s over device 3e-05 s"),
    "flash_attention_infer_roofline": (0.02636417910447761, "flash_attention_infer_roofline: "
                                       "bound 5.272835820895522e-09 s over device 2e-05 s"),
    "flash_attention_roofline": (0.2031540757749713, "flash_attention_roofline: 19169280.0 "
                                 "operations, bound 2.641002985074627e-07 s over device "
                                 "0.00013000000000000002 s"),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_count_and_roofline_readers_are_unchanged(name):
    rec = _record()
    assert harness.reader(name)(rec) == READINGS[name][0]
    assert rec["bases"] == [READINGS[name][1]]


def test_only_the_dense_family_knows_its_leaves_and_model():
    s = dense.spec_of(small.small_config("qwen3-1.7b"))
    leaves = {re.sub(r"^blocks\.\d+\.", "", n) for g in dense.groups(s)
              for n in weights.leaf_names(dense, s, g)}
    words = re.compile("|".join([re.escape(n) for n in sorted(leaves)]
                                + [r"\btransformer\b", "_write_cache", 'family="dense"']))
    for path in harness.HERE.rglob("*.py"):
        if path in (harness.HERE / "families" / "dense.py", Path(__file__).resolve()):
            continue
        found = words.findall(path.read_text())
        assert not found, (path, found)


# -- a cell of another family, added as new files and entries alone --------

PAIRED = '''"""The dense decoder drawn and checked two layers to a group."""

from portbench import weights
from portbench.families import dense
from portbench.families.dense import (MOVED_TWICE, arch_config, attention_layers,  # noqa: F401
                                      decode_step_counts, embed, final_logits, planted,
                                      prefill_counts, spec_of, train_flops)


def groups(s):
    return [weights.TOP] + list(range(s.layers // 2))


def leaves(s, group):
    if group == weights.TOP:
        return dense.leaves(s, group)
    return dense.leaves(s, 2 * group) + dense.leaves(s, 2 * group + 1)


def block(s, W, group, h, quant=None):
    for i in (2 * group, 2 * group + 1):
        h = dense.block(s, W, i, h, quant)
    return h


def small(cfg):
    return dict(dense.small(cfg), num_hidden_layers=4)
'''

CELL = "qwen3-1.7b.paired.serve.pairs"

RUN = '''
import json, sys, time
import torch
from portbench import harness
import small
bench = harness.load_benchmark()
cell = harness.cell_of(bench, {cell!r})
cfg, traffic = small.small_config(cell["config"]), small.small_traffic(cell["traffic"])
info = {{"platform": "cpu", "kind": "cpu", "count": 1}}
for fault in (None, "half_batch"):
    rec = harness.run_cell(cell, small.SEED, 1.0, False, torch.device("cpu"), time.perf_counter(),
                           fault=fault, cfg=cfg, traffic=traffic)
    out, _ = harness.result_line(bench, cell, rec, False, info, small.small_limits(cell["name"]))
    layer, _ = harness.result_line(bench, cell, rec, True, info, small.small_limits(cell["name"]))
    print(json.dumps({{"fault": fault, "correct": out["correct"], "checks": out["checks"],
                      "family": rec["family"], "metrics": sorted(out["metrics"]),
                      "per_layer": sorted(layer["metrics"]), "here": str(harness.HERE)}}))
'''


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root):
    """The new files and entries of a cell whose configuration names the
    ``paired`` family."""
    pb = root / "portbench"
    (pb / "families" / "paired.py").write_text(PAIRED)
    cfg = json.loads((pb / "configs" / "qwen3-1.7b.json").read_text())
    (pb / "configs" / "qwen3-1.7b.paired.json").write_text(json.dumps(dict(cfg, family="paired")))
    mix = json.loads((pb / "traffic" / "serve.chat.json").read_text())
    (pb / "traffic" / "serve.pairs.json").write_text(json.dumps(dict(mix, slots=64, clients=64)))
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": {"served_logit_gap": 0.3}}))
    (pb / "tests" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": {"served_logit_gap": 0.05}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "qwen3-1.7b.paired", "source": cfg["source"],
                             "file": "portbench/configs/qwen3-1.7b.paired.json", "reduced": [],
                             "why": "the dense decoder under a second family"})
    bench["workloads"].append({"name": CELL, "config": "qwen3-1.7b.paired",
                               "traffic": "serve.pairs", "chips": 1,
                               "why": "64 closed-loop clients of chat lengths"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mistral-large-123b.l11.serve.chat" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return bench


def test_a_cell_of_another_family_is_added_as_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    before = _hashes(root)
    old = json.loads((root / "BENCHMARK.json").read_text())
    bench = _add_cell(root)
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT / "src"))
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, {str(root / 'portbench' / 'tests')!r}]"
            + RUN.format(cell=CELL))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    sound, half = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert sound["here"] == str(root / "portbench") and sound["family"] == "paired"
    assert sound["correct"], sound["checks"]
    assert not half["correct"], half["checks"]
    assert sound["metrics"] == ["serve_tok_s", "setup_s"]
    assert "mfu.serve" in sound["per_layer"]

    # the copy's own form checks take the cell as it is
    tests = root / "portbench" / "tests"
    check = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                            str(tests / "test_portbench_names.py"),
                            f"{tests / 'test_portbench_correct.py'}::"
                            f"test_every_cell_has_small_limits"],
                           cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert check.returncode == 0, check.stdout[-3000:]

    after = _hashes(root)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == [Path("BENCHMARK.json")]
    # BENCHMARK.json only gained entries: taking them out gives the old file
    bench["configs"].pop()
    bench["workloads"].pop()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].remove(CELL)
    assert bench == old
