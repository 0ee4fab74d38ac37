"""The numbers that no limit compares, read by ``tools/readings.py
--look`` and kept out of the cells' own runs: the service's start picks
and decoder against the reference's, and the link's SNR."""
from __future__ import annotations

import math

from gfdm_bench.tools.readings import look


def test_service_look_reads_the_picks_and_the_decoder(dry):
    got = dry("service.default.coded", look=look)
    assert "decode_mismatch" not in got["readings"]
    for side in ("program", "control"):
        seen = got["look"][side]
        assert set(seen) == {"detect_mismatch", "found_flips", "pick_loss_max",
                             "pick_loss_mean", "decode_mismatch"}
        assert all(v >= 0.0 for v in seen.values())
    assert got["look"]["program"]["decode_mismatch"] == 0.0


def test_link_look_reads_a_clean_loopbacks_snr(dry):
    seen = dry("link.default.b65536", look=look)["look"]
    assert math.isfinite(seen["snr_db_min"]) and seen["snr_db_min"] > 100.0
    # no noise: the reference's odd preamble bins are exactly zero
    assert seen["reference_snr_db_min"] == math.inf
    assert dry("link.largek512.b4096", look=look)["look"] == {}
