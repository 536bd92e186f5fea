"""chip_smoke.py's phases at a tiny size on the CPU (kernel interpreted).

The script itself refuses to run without a GPU; its phase functions take
the scale and the scan mode, so the logic runs here end to end.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    n=40_000, learn=4000, nq=64, parts=8, ma=4, r=20, batches=(1, 32),
    adc_batch=16, flat_batch=32, coarse_iters=4, opq_iters=1, kmeans_iters=4,
    serve_requests=16, scan_part_pad=1024, scan_groups=4, scan_group=16,
)


@pytest.fixture(scope="module")
def built():
    return chip_smoke.build_sift1m(TINY)


def test_phase_a_tiny():
    recs = chip_smoke.phase_a(TINY, "interpret", time_it=False)
    assert [(r["m"], r["window"], r["exact"]) for r in recs] == [
        (16, 16, True), (32, 8, True)]


def test_phase_b_tiny(built):
    recs = chip_smoke.phase_b(TINY, built=built, interpret=True)
    assert recs["ivf_qadc_16x4_b1"]["route"] == "direct/xla"
    b32 = recs["ivf_qadc_16x4_b32"]
    assert b32["route"] == "grouped/interpret"
    assert b32["dominated"]
    assert b32["recall_direct"] - b32["recall"] <= 0.02
    assert recs["flat_qadc_16x4_b32"]["route"] == "window/interpret"
    assert recs["ivf_adc_8x8_b16"]["route"] == "grouped/xla"
    for rec in recs.values():
        assert 0.5 < rec["recall"] <= 1.0


def test_phase_c_tiny(built):
    """Four of the eight virtual CPU devices stand in for four GPUs."""
    chip_smoke.phase_c(TINY, 4, built=built, interpret=True)


def test_same_up_to_ties():
    d = np.array([[1.0, 2.0, 2.0, 3.0]])
    assert chip_smoke.same_up_to_ties(d, np.array([[5, 6, 7, 8]]), d,
                                      np.array([[5, 7, 6, 8]]))
    assert chip_smoke.same_up_to_ties(d, np.array([[5, 6, 7, 8]]), d,
                                      np.array([[5, 6, 9, 8]]))
    worse = np.array([[1.0, 2.0, 2.0, 3.5]])
    assert not chip_smoke.same_up_to_ties(d, np.array([[5, 6, 7, 8]]), worse,
                                          np.array([[5, 6, 7, 9]]))


def test_check_same_scan():
    d = np.array([[1.0, 2.0, 2.0 * (1 + 1e-7), 3.0]])
    chip_smoke.check_same_scan("tie", d, np.array([[5, 6, 7, 8]]), d,
                               np.array([[5, 7, 6, 8]]))
    with pytest.raises(AssertionError):
        chip_smoke.check_same_scan("fault", d, np.array([[5, 6, 7, 8]]),
                                   d + [[0, 0, 0, 0.5]], np.array([[5, 6, 7, 9]]))


def test_dominated():
    full = np.array([[1.0, 2.0, 3.0, np.inf]])
    assert chip_smoke.dominated(np.array([[1.0, 2.5, 3.0, np.inf]]), full)
    assert chip_smoke.dominated(full * (1 - 1e-7), full)       # summation order
    assert not chip_smoke.dominated(np.array([[1.0, 1.5, 3.0, np.inf]]), full)
    assert not chip_smoke.dominated(np.array([[1.0, 2.0, 3.0, 9.0]]), full)


def test_refuses_without_gpu():
    """No GPU: nonzero exit and no contract line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
