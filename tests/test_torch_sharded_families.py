"""The port's sharded paths on real values, continued: the hybrid, xLSTM
and encoder-decoder families, and a dense model whose query heads do not
split over the model axis (``test_torch_sharded_numeric.py`` has the
method and the other cases).
"""

import pytest

from test_torch_sharded_numeric import check_case

CASES = [
    ("zamba2-2.7b", {}),                      # Mamba2 scan and the shared attention block
    ("xlstm-350m", {}),                       # the xLSTM's groups and sLSTM regions
    ("seamless-m4t-large-v2", {}),            # encoder, decoder, cross-attention over frames
    # 7 query heads, 1 KV head: the decode's head dim splits and both ranks
    # take the whole group, the output gathered
    ("qwen2-0.5b", {}),
]


@pytest.mark.parametrize("arch,overrides", CASES, ids=[a for a, _ in CASES])
def test_sharded_model_matches_one_device_and_jax(arch, overrides, tmp_path):
    check_case(arch, overrides, tmp_path)
