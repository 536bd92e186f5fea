"""Window-minimum scan (kernels/window_scan.py): the Pallas kernel run in
interpret mode and the plain-XLA twin against the scan_ref oracle.

Comparisons are EXACT: int8 tables accumulate in int32, so every
implementation must produce the same integers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qadc_tpu.kernels.scan_ref import adc_scan_int8
from qadc_tpu.kernels.window_scan import (
    SENTINEL_I32,
    window_min_scan,
    window_min_to_float,
)


def _problem(rng, m, parts=6, rows_per_group=1024, gcap=4, g=16, sizes=None):
    cb = m // 2
    cpr = 128 // cb
    codes = rng.integers(0, 256, size=(parts * rows_per_group // cpr, 128),
                         dtype=np.uint8)
    gp = rng.integers(0, parts, gcap).astype(np.int32)
    if sizes is None:
        sizes = rng.integers(1, rows_per_group + 1, gcap)
    gsz = np.asarray(sizes, np.int32)
    tabs = rng.integers(0, 128, size=(gcap * g, m * 16)).astype(np.int8)
    return codes, gp, gsz, tabs


def _oracle(codes, gp, gsz, tabs, m, rows_per_group, window):
    cb = m // 2
    flat = codes.reshape(-1, cb)
    g = tabs.shape[0] // len(gp)
    out = []
    for gi, p in enumerate(gp):
        pc = flat[p * rows_per_group : (p + 1) * rows_per_group]
        t = tabs[gi * g : (gi + 1) * g].reshape(g, m, 16)
        d = np.asarray(adc_scan_int8(pc, t, saturate=False))
        w = d.reshape(g, -1, window).min(-1)
        start = np.arange(w.shape[1]) * window
        out.append(np.where(start[None, :] < gsz[gi], w, SENTINEL_I32))
    return np.concatenate(out)


def _scan(args, m, rows_per_group, window, mode, **kw):
    codes, gp, gsz, tabs = map(jnp.asarray, args)
    return np.asarray(window_min_scan(
        codes, gp, gsz, tabs, code_size=m // 2, rows_per_group=rows_per_group,
        window=window, mode=mode, **kw,
    ))


@pytest.mark.parametrize(
    "m,window,block_n",
    [(16, 16, 1024), (32, 8, 1024), (16, 8, 256), (32, 4, 512), (16, 16, 128)],
)
def test_kernel_matches_reference(rng, m, window, block_n):
    """Interpreted kernel == scan_ref window minima at 16x4 and 32x4, over
    ragged partition sizes, several windows and block sizes."""
    args = _problem(rng, m)
    got = _scan(args, m, 1024, window, "interpret", block_n=block_n)
    np.testing.assert_array_equal(got, _oracle(*args, m, 1024, window))


@pytest.mark.parametrize("m,window", [(16, 16), (32, 8), (16, 4)])
def test_xla_scan_matches_reference(rng, m, window):
    """The plain-XLA scan is the same function as the kernel."""
    args = _problem(rng, m, rows_per_group=2048)
    got = _scan(args, m, 2048, window, "xla")
    np.testing.assert_array_equal(got, _oracle(*args, m, 2048, window))


@pytest.mark.parametrize("g", [16, 32, 64])
def test_kernel_group_widths(rng, g):
    """Every power-of-two group width from 16 up serves its own slots."""
    args = _problem(rng, 16, gcap=2, g=g)
    got = _scan(args, 16, 1024, 16, "interpret")
    np.testing.assert_array_equal(got, _oracle(*args, 16, 1024, 16))


def test_kernel_padding_edges(rng):
    """Partition sizes 0, 1, a block edge and the full pad: windows that
    start at or past the size are the sentinel, the straddling window holds
    the minimum of its real codes AND its padding (tail-repeat padding
    repeats the last real code, so it never beats it)."""
    sizes = [0, 1, 128, 1024]
    args = _problem(rng, 16, sizes=sizes)
    got = _scan(args, 16, 1024, 16, "interpret", block_n=256)
    np.testing.assert_array_equal(got, _oracle(*args, 16, 1024, 16))
    g = 16
    assert (got[:g] == SENTINEL_I32).all()                    # size 0: skipped
    assert (got[g : 2 * g, 1:] == SENTINEL_I32).all()         # size 1
    assert (got[g : 2 * g, 0] != SENTINEL_I32).all()
    assert (got[2 * g : 3 * g, 8:] == SENTINEL_I32).all()     # size 128 = 8 windows
    assert (got[3 * g :] != SENTINEL_I32).all()


def test_kernel_duplicate_partitions(rng):
    """Several groups on one partition (flat search: every group scans the
    same code range) each use their own tables."""
    codes, _, _, tabs = _problem(rng, 16, gcap=3)
    gp = np.zeros(3, np.int32)
    gsz = np.full(3, 1000, np.int32)
    args = (codes, gp, gsz, tabs)
    got = _scan(args, 16, 1024, 16, "interpret")
    np.testing.assert_array_equal(got, _oracle(*args, 16, 1024, 16))


def test_kernel_rejects_bad_shapes(rng):
    codes, gp, gsz, tabs = _problem(rng, 16, gcap=2, g=16)
    with pytest.raises(ValueError, match="group width"):
        _scan((codes, gp, gsz, tabs[:24]), 16, 1024, 16, "interpret")
    with pytest.raises(ValueError, match="int8"):
        _scan((codes, gp, gsz, tabs.astype(np.float32)), 16, 1024, 16,
              "interpret")
    with pytest.raises(ValueError, match="scan mode"):
        _scan((codes, gp, gsz, tabs), 16, 1024, 16, "cuda")


def test_window_min_to_float_saturate():
    v = jnp.asarray([[3, 200, SENTINEL_I32]], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(window_min_to_float(v)), [[3.0, 200.0, np.inf]]
    )
    np.testing.assert_array_equal(
        np.asarray(window_min_to_float(v, saturate=True)), [[3.0, 127.0, np.inf]]
    )
    f = jnp.asarray([[1.5, np.inf]], jnp.float32)
    np.testing.assert_array_equal(np.asarray(window_min_to_float(f)), [[1.5, np.inf]])


def test_flat_window_search_kernel_matches_xla(rng):
    """The flat caller (index.flat.window_search): interpreted kernel and
    plain-XLA scan give identical results, with the range holding fewer
    real codes than its pad."""
    from qadc_tpu.index.flat import window_search

    m, n_pad, q = 32, 2048, 20
    codes = jnp.asarray(rng.integers(0, 256, size=(n_pad // 8, 128), dtype=np.uint8))
    labels = jnp.arange(n_pad, dtype=jnp.int32)
    qt = jnp.asarray(rng.integers(0, 128, size=(q, m, 16)).astype(np.int8))
    rank = qt.astype(jnp.float32)
    kw = dict(part=0, range_codes=n_pad, size=1500, r=10, wq=10, window=8)
    d1, l1 = window_search(codes, labels, qt, rank, scan="interpret", **kw)
    d0, l0 = window_search(codes, labels, qt, rank, scan="xla", **kw)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))
    assert (np.asarray(l1) < 1500).all()


@pytest.mark.parametrize("m", [16, 32])
def test_flat_qadc_kernel_route_exact(rng, m):
    """flat.search_qadc on the window route (kernel interpreted), rerank
    off: EXACT top-r by quantized distance, equal to the plain loop route."""
    from qadc_tpu.index import flat
    from qadc_tpu.quantizers.pq import train_pq

    dim = 64
    base = rng.normal(size=(3000, dim)).astype(np.float32)
    queries = rng.normal(size=(12, dim)).astype(np.float32)
    pq = train_pq(jax.random.PRNGKey(0), base, m, 4, iters=4)
    index = flat.add(flat.FlatIndex.create(pq), base)
    kw = dict(r=20, keep=0.05, rerank=False)
    d1, _ = flat.search_qadc(index, queries, interpret=True, **kw)
    d0, _ = flat.search_qadc(index, queries, **kw)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))


@pytest.mark.gpu
def test_gpu_kernel_compiled_matches_reference(gpu):
    """On a card: the compiled kernel at the real widths == scan_ref
    (chip_smoke phase A in a child process without the CPU pin)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = (
        "import chip_smoke as c; "
        "c.phase_a(c.Sizes(), 'triton', time_it=False)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("== scan_ref: True") == 2, out.stdout
