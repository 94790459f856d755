"""The harness end to end on the card at a small size: the kernels build,
the trace reads the card's timeline, and the answers are correct."""

import pytest

from benchmark import run

SMALL = {"config": {"n_sequences": 65536, "sequence_length": 2000},
         "mix": {"prefetch_per_s": 2000, "warmup_requests": 64}}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_counts_cell_on_the_card(card, trace):
    result = run.run_cell("dense1m.counts", 99, 2.0, trace, card,
                          overrides=SMALL)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["vm_roofline_pct"]["value"] <= 100
        assert result["breakdown"]["device_ops"]
    else:
        assert result["metrics"]["card_us_per_query"]["value"] > 0
