"""Smoke test for the randomized differential fuzz harness.

A short deterministic run of tools/fuzz_ref against the compiled
reference C: zero unattributed discrepancies (``bugs``), and the
attribution counters stay wired.  Seeds 5000.. include a known
fp-tie-heavy FET panel, so the deviation-7(b) classifier is exercised,
not just trivially zero.  Full sweeps (150+ trials) are run ad hoc —
see docs/FUZZ_LOG.md for the tally.
"""

import pytest

from divergence_tpu.tools.fuzz_ref import BASELINE, fuzz


def test_fuzz_ref_short_run():
    if not (BASELINE / "build" / "bench_ref_fet").exists():
        import subprocess

        r = subprocess.run(
            ["bash", str(BASELINE / "build.sh")], capture_output=True
        )
        if r.returncode != 0:
            pytest.skip("baseline build unavailable")
    stats = fuzz(trials=8, seed0=5000)
    assert stats["bugs"] == []
    assert stats["trials"] >= 7  # trial t4 has zero slots and is skipped
    # seed 5006 (trial t6) contains the documented fp-tie windows
    assert stats["fet_tie_windows"] >= 1
