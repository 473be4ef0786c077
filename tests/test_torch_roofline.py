"""The port's roofline arithmetic (``repro_torch.roofline.analysis.
analyze_counts``) against the reference's ``analyze_compiled`` on the same
counts and the same rates: the reference reads a stub compiled module whose
HLO text is ``tests/test_roofline.py``'s ``SYNTH_HLO``, with a cost and a
memory analysis; the port is handed the counts the reference read from it
and the reference's TPU ``HW``.  Every field of the two reports is equal.
"""

from types import SimpleNamespace

import pytest

from repro.roofline.analysis import HW as TPU_HW
from repro.roofline.analysis import analyze_compiled
from repro.roofline.hloparse import analyze_hlo
from repro_torch.roofline.analysis import HW, analyze_counts
from test_roofline import SYNTH_HLO


class _Compiled:
    def __init__(self, flops, nbytes):
        self._cost = {"flops": flops, "bytes accessed": nbytes}

    def as_text(self):
        return SYNTH_HLO

    def cost_analysis(self):
        return self._cost

    def memory_analysis(self):
        return SimpleNamespace(argument_size_in_bytes=123_456, temp_size_in_bytes=7_890,
                               output_size_in_bytes=4_321)


@pytest.mark.parametrize("xla_flops,xla_bytes", [(0.0, 0.0), (1e12, 5e9)])
@pytest.mark.parametrize("model_flops", [1e6, 2 * 64 * 64 * 256 * 12 * 512.0])
def test_analyze_counts_equals_the_reference_field_by_field(xla_flops, xla_bytes, model_flops):
    ref = analyze_compiled(_Compiled(xla_flops, xla_bytes), arch="a", shape="s",
                           mesh_name="16x16", chips=256, model_flops=model_flops, notes="n")
    stats = analyze_hlo(SYNTH_HLO)
    assert ref.collectives_by_kind == {k: int(v) for k, v in
                                       stats.collectives_by_kind.items()}
    counts = SimpleNamespace(flops=ref.device_flops, hbm_bytes=ref.device_bytes,
                             collectives=dict(ref.collectives_by_kind),
                             argument_bytes=123_456, peak=7_890, output_bytes=4_321)
    # the reference's notes carry its XLA cost analysis; the port's are the caller's
    port = analyze_counts(counts, arch="a", shape="s", mesh_name="16x16", chips=256,
                          model_flops=model_flops, notes=ref.notes, hw=TPU_HW)
    assert port.to_json() == ref.to_json()


def test_h100_rates_are_the_data_sheets():
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    assert TPU_HW["peak_flops"] == 197e12      # the reference's own stays the TPU's
