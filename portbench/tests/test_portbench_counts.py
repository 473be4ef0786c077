"""The dense family's and the yardstick's counts against hand counts at
both configurations' shapes."""

import math

import pytest

from portbench import harness, yardstick
from portbench.families import dense

QWEN = dense.spec_of(harness.load_json(harness.HERE / "configs" / "qwen3-1.7b.json"))
MISTRAL = dense.spec_of(
    harness.load_json(harness.HERE / "configs" / "mistral-large-123b.l11.json"))


def test_parameters():
    # qwen3-1.7b: 28 x (attention 12,582,912 + MLP 37,748,736 + norms 4,352)
    # + a tied table of 151,936 x 2,048 + the final norm
    assert dense.param_count(QWEN) == 28 * 50_336_000 + 311_164_928 + 2048 == 1_720_574_976
    # mistral-large, 11 full-width layers of 1,384,144,896, an embedding and
    # an untied head of 32,768 x 12,288 each
    assert dense.layer_params(MISTRAL) == 1_384_144_896
    assert dense.param_count(MISTRAL) == 16_030_912_512
    for s in (QWEN, MISTRAL):
        leaves = [leaf for g in dense.groups(s) for leaf in dense.leaves(s, g)]
        assert sum(math.prod(shape) for _, shape, _ in leaves) == dense.param_count(s)


def test_training_flops():
    # 6 N D + 12 L B H hd S^2 / 2 at 2 x 4,096: 96.1 TFLOP
    want = 6 * 1_720_574_976 * 8192 + 12 * 28 * 2 * 16 * 128 * 4096 ** 2 / 2
    assert dense.train_flops(QWEN, 2, 4096) == want
    assert want == pytest.approx(96.1e12, rel=1e-3)


def test_cache_bytes():
    # 2 (K, V) x 8 heads x 128 x 2 B x 28 layers = 114,688 B a position
    per_pos = 28 * yardstick.decode_attention_bytes(QWEN, 1, 0)
    assert per_pos == 114_688
    assert 128 * 4096 * per_pos == pytest.approx(60.13e9, rel=1e-3)
    # q and o of every row: 2 x rows x 16 heads x 128 x 2 B
    assert yardstick.decode_attention_bytes(QWEN, 1000, 4) == (2 * 1000 * 8 * 128 * 2
                                                              + 2 * 4 * 16 * 128 * 2)
    mistral_kv = 11 * yardstick.decode_attention_bytes(MISTRAL, 128 * 1024, 0)
    assert mistral_kv == pytest.approx(5.9e9, rel=0.02)


def test_step_counts():
    d = dense.decode_step_counts(QWEN, active=3, active_positions=3000, rows=4,
                                 all_positions=3001)
    matmul = 28 * (2048 * 32 * 128 + 16 * 128 * 2048 + 3 * 2048 * 6144) + 151_936 * 2048
    assert d["flops"] == 2 * matmul * 3 + 4 * 28 * 16 * 128 * 3000
    assert d["bytes"] == (1_720_574_976 * 2 + 2 * 4 * 28 * 8 * 128 * 2
                          + 28 * (2 * 3001 * 8 * 128 * 2 + 2 * 4 * 16 * 128 * 2))
    p = dense.prefill_counts(MISTRAL, 300)
    layer_mm = 12288 * (96 + 16) * 128 + 96 * 128 * 12288 + 3 * 12288 * 28672
    assert p["flops"] == (2 * 11 * layer_mm * 300 + 2 * 32768 * 12288
                          + 11 * 4 * (300 * 301 / 2) * 128 * 96)
    # an untied embedding is read only at the prompt's rows
    assert p["bytes"] == ((16_030_912_512 - 32768 * 12288 + 300 * 12288) * 2
                          + 2 * 300 * 11 * 8 * 128 * 2)
    assert yardstick.bound_s([p]) == max(p["flops"] / 989e12, p["bytes"] / 3.35e12)


def test_attention_counts():
    assert yardstick.attention_flops(QWEN, 4) == 4 * 10 * 128 * 16
    assert yardstick.attention_bytes(QWEN, 4) == 4 * (32 + 16) * 128 * 2
