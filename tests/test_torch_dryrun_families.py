"""The port's dry run on the CPU, continued: cells of the vlm, hybrid and
encoder-decoder families across both meshes (``test_torch_dryrun.py`` has
the others), traced in one subprocess, each ``"status": "ok"`` with the
reference's artifact keys; and seamless-m4t-large-v2's prefill_32k, whose
useful ratio above 1 is the reference's ``model_flops`` counting the
decoder over every frame: the counter's FLOPs equal the work that prefill
runs, counted layer by layer from the config.
"""

import json
import subprocess
import sys

import pytest

from test_torch_dryrun import ENV, KEYS

CELLS = [("chameleon-34b", "prefill_32k", "multi"),         # vlm
         ("zamba2-2.7b", "long_500k", "multi"),              # hybrid
         ("seamless-m4t-large-v2", "train_4k", "single")]    # encdec
ENCDEC_PREFILL = ("seamless-m4t-large-v2", "prefill_32k", "single")

RUN = """
import json, sys, warnings
warnings.filterwarnings("ignore")
from repro_torch.launch import dryrun as D
print(json.dumps([D.run_cell(a, s, m, remat="full", quiet=True)
                  for a, s, m in json.loads(sys.argv[1])]))
"""


@pytest.fixture(scope="module")
def traced():
    out = subprocess.run([sys.executable, "-c", RUN, json.dumps(CELLS + [ENCDEC_PREFILL])],
                         capture_output=True, text=True, env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_cells_trace_with_the_reference_keys(traced, i):
    r = traced[i]
    arch, shape, mesh = CELLS[i]
    assert r["status"] == "ok", r.get("error")
    assert set(r) == KEYS
    assert (r["arch"], r["shape"]) == (arch, shape)
    assert r["chips"] == (512 if mesh == "multi" else 256)
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["argument_bytes"] > 0 and r["device_flops"] > 0
    assert 0 < r["useful_ratio"] <= 1.05


def _encdec_prefill_flops(cfg, B, F):
    """The matrix work of ``encdec.prefill`` on B x F frames and one token
    each: every encoder layer's projections and MLP over all B F frames and
    its attention over F x F; every decoder layer's projections and MLP
    over one token, its self-attention over one key, its cross K/V
    projected over all frames and its cross-attention of one query over F
    keys; the vocab projection of the last position."""
    D, ff, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    enc = 2 * (4 * D * D + 3 * D * ff) * B * F + 4 * B * H * F * F * hd
    dec = (2 * (4 * D * D + 2 * D * D + 3 * D * ff) * B + 4 * B * H * hd
           + 2 * (2 * D * D) * B * F + 4 * B * H * F * hd)
    return cfg.enc_layers * enc + cfg.dec_layers * dec + 2 * D * cfg.vocab * B


def test_encdec_prefill_ratio_above_one_is_the_model_flops_formula(traced):
    """The counter's FLOPs over all ranks are the work prefill runs; the
    reference's ``model_flops`` (the port's copy) is 2 N over every one of
    the B x 32768 positions for the decoder too, which runs over one token:
    that and nothing the counter misses is why the ratio is 1.54."""
    from repro_torch.configs.base import get_config, get_shape
    from repro_torch.models.model import model_flops
    r = traced[-1]
    assert r["status"] == "ok", r.get("error")
    cfg, shape = get_config(ENCDEC_PREFILL[0]), get_shape(ENCDEC_PREFILL[1])
    work = _encdec_prefill_flops(cfg, shape.global_batch, shape.seq_len)
    assert abs(r["hlo_total_flops"] / work - 1) < 1e-3
    assert r["model_flops"] == model_flops(cfg, shape)
    assert abs(r["useful_ratio"] - model_flops(cfg, shape) / work) < 1e-3
    assert r["useful_ratio"] > 1.5
