"""Benchmark: Quick-ADC on one GPU — prints ONE JSON line.

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Headline metric: code-query pairs scanned per second by the scan that
flat.search_qadc runs on this device (index.route: the window-scan kernel on
a GPU) on the flagship config (SIFT1M-scale: 1M codes, 16x4 PQ = 8-byte
codes, 128-query batch, window-16 reduction). Baseline: the reference's AVX2
scan rate derived from its published IVF-256 SIFT1M numbers
(README.md:329-330): scan 86 us/query over ma=24 partitions of ~3906 codes
=> ~93,750 codes / 86 us = 1.09e9 cq pairs/s.

detail carries IVF-256 ma=24 r=100 end-to-end us/query at batch 128/32/1
(reference total: ~120 us/query), speed-of-light ratios against the peak
table below, recall@100 at 1M on the SIFT-moment-matched generator, and the
device (platform, kind, count, power limit).

Stages run independently: a crashing stage records {stage, error, tail}
under detail.stage_errors and every completed stage's numbers still emit.

Timing: host clock around block_until_ready, after an untimed compile call
(qadc_tpu/eval/timing.py). A run that finds no GPU fails.
"""

import json
import subprocess

import numpy as np

from qadc_tpu.eval.timing import median_seconds, percentiles

REFERENCE_SCAN_CQ_PER_S = 93_750 / 86e-6  # ~1.09e9, README.md:329-330

# Published dense peaks per device kind, from NVIDIA's H100 data sheet (SXM
# part, no sparsity). A device that is not listed is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "int8_tops": 1979.0},
}


def _peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}")
    return PEAKS[device_kind]


def _power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def _bench_kernel(rng):
    """Flat 4-bit scan: 1M codes x 128 queries, the scan search runs here."""
    import jax.numpy as jnp

    from qadc_tpu.index import route
    from qadc_tpu.kernels.window_scan import window_min_scan

    n, m, q = 1_048_576, 16, 128
    codes = jnp.asarray(rng.integers(0, 256, size=(n // 16, 128), dtype=np.uint8))
    qtables = jnp.asarray(rng.integers(0, 127, size=(q, m * 16)).astype(np.int8))
    zero = jnp.zeros((1,), jnp.int32)
    size = jnp.full((1,), n, jnp.int32)
    scan = route.scan_impl()

    def call():
        return window_min_scan(
            codes, zero, size, qtables, code_size=m // 2, rows_per_group=n,
            window=16, mode=scan,
        )

    return n, q, m, median_seconds(call, iters=20), scan


def _make_ivf(rng):
    import jax.numpy as jnp
    from qadc_tpu.index.ivf import IVFIndex
    from qadc_tpu.quantizers.pq import ProductQuantizer

    dim, parts, part_pad, m = 128, 256, 4096, 16
    pq = ProductQuantizer(
        centroids=jnp.asarray(rng.normal(size=(m, 16, dim // m)).astype(np.float32)),
        sq_bits=4,
    )
    return IVFIndex(
        pq=pq,
        coarse_centroids=jnp.asarray(rng.normal(size=(parts, dim)).astype(np.float32)),
        codes=jnp.asarray(
            rng.integers(0, 256, size=(parts, part_pad // 16, 128), dtype=np.uint8)
        ),
        labels=jnp.asarray(
            np.arange(parts * part_pad, dtype=np.int32).reshape(parts, part_pad)
        ),
        part_sizes=jnp.asarray(np.full((parts,), 3906, np.int32)),
        n=parts * 3906,
        max_part_size=3906,
    )


def _ivf_queries(rng, batch):
    import jax.numpy as jnp

    return jnp.asarray(rng.normal(size=(batch, 128)).astype(np.float32))


def _bench_ivf_e2e(rng, index, batch):
    """Full IVF Quick-ADC search us/query (SIFT1M geometry, given batch).

    Reference: IVF-256 SIFT1M OPQ 16x4 Quick ADC ma=24 totals ~120 us/query
    (index 7 + rotate 13 + table 14 + scan 86, README.md:329-330; batch 32).
    """
    from qadc_tpu.index import ivf

    qs = _ivf_queries(rng, batch)
    dt = median_seconds(
        lambda: ivf.search_qadc(index, qs, r=100, ma=24, keep=0.005), iters=20
    )
    return dt * 1e6 / batch


def _bench_ivf_percentiles(rng, index, batch, iters=50):
    """p50/p90/p99 us/query over single calls."""
    from qadc_tpu.index import ivf

    qs = _ivf_queries(rng, batch)
    pct = percentiles(
        lambda: ivf.search_qadc(index, qs, r=100, ma=24, keep=0.005), iters=iters
    )
    return {k: v * 1e6 / batch for k, v in pct.items()}


def _make_ivf8(rng):
    """Synthetic IVF with an 8x8 PQ (timing only — tables random)."""
    import jax.numpy as jnp
    from qadc_tpu.index.ivf import IVFIndex
    from qadc_tpu.quantizers.pq import ProductQuantizer

    dim, parts, part_pad, m = 128, 256, 4096, 8
    pq = ProductQuantizer(
        centroids=jnp.asarray(
            rng.normal(size=(m, 256, dim // m)).astype(np.float32)
        ),
        sq_bits=8,
    )
    return IVFIndex(
        pq=pq,
        coarse_centroids=jnp.asarray(rng.normal(size=(parts, dim)).astype(np.float32)),
        codes=jnp.asarray(
            rng.integers(0, 256, size=(parts, part_pad // 16, 128), dtype=np.uint8)
        ),
        labels=jnp.asarray(
            np.arange(parts * part_pad, dtype=np.int32).reshape(parts, part_pad)
        ),
        part_sizes=jnp.asarray(np.full((parts,), 3906, np.int32)),
        n=parts * 3906,
        max_part_size=3906,
    )


def _bench_ivf_adc(rng, index, batch):
    """Conventional (float) ADC IVF e2e us/query at SIFT1M geometry.

    Reference totals (README.md:277-301): IVF-256 OPQ 8x8 ADC ma=24 ~388
    us/query; 4-bit scan_4 has no published IVF total (compare vs 388 too).
    """
    from qadc_tpu.index import ivf

    qs = _ivf_queries(rng, batch)
    dt = median_seconds(lambda: ivf.search_adc(index, qs, r=100, ma=24), iters=10)
    return dt * 1e6 / batch


def _bench_recall_parity(rng):
    """Parity-grade recall at 1M: the reference's published table shape.

    SIFT-moment-matched generator (qadc_tpu/eval/synth.py — the same one
    benchmarks/recall_curves.py uses; the old latent-Gaussian synthetic sat
    at 0.59-0.72 recall, unreadable against the reference's 0.94 regime).
    Anchors (reference README.md:277-330, SIFT1M R=100, OPQ):
      flat 8x8 ADC 0.9419; IVF-256 8x8 ADC ma=24 0.9646;
      IVF-256 16x4 Quick-ADC ma=24 keep=0.213% 0.9426 (delta +0.022).
    Also returns QPS at b=128 on the trained 16x4 IVF index.
    """
    import jax
    import jax.numpy as jnp

    from qadc_tpu.eval.recall import recall_at_r
    from qadc_tpu.eval.synth import sift_moment_like
    from qadc_tpu.index import flat, ivf
    from qadc_tpu.ops.knn import assign_nearest, exact_knn
    from qadc_tpu.quantizers.opq import train_opq

    import os

    n = int(os.environ.get("QADC_BENCH_RECALL_N", "1000000"))
    nq, r, ma = 128, 100, 24
    base, queries = sift_moment_like(rng, n, nq=nq)
    learn = base[: min(100_000, n)]
    _, gt = exact_knn(queries, base, 1)
    gt = np.asarray(gt)

    def batched(search_fn, bs=32):
        outs = []
        for s in range(0, nq, bs):
            _, lab = search_fn(jnp.asarray(queries[s : s + bs]))
            outs.append(np.asarray(lab))
        return np.concatenate(outs)

    out = {}
    opq88 = train_opq(jax.random.PRNGKey(0), learn, 8, 8,
                      opq_iters=6, kmeans_iters=12)
    f88 = flat.add(flat.FlatIndex.create(opq88), base)
    out["recall_flat_8x8_adc"] = recall_at_r(
        batched(lambda q: flat.search_adc(f88, q, r=r)), gt
    )
    del f88

    coarse = ivf.train_coarse(jax.random.PRNGKey(2), learn, 256, iters=25,
                              balance_cap=3.0)
    a = np.asarray(assign_nearest(learn, coarse))
    residuals = learn - np.asarray(coarse)[a]
    r88 = train_opq(jax.random.PRNGKey(3), residuals, 8, 8,
                    opq_iters=6, kmeans_iters=12)
    r164 = train_opq(jax.random.PRNGKey(4), residuals, 16, 4,
                     opq_iters=6, kmeans_iters=12)
    i88 = ivf.add(ivf.IVFIndex.create(r88, coarse), base)
    out["recall_ivf256_8x8_adc_ma24"] = recall_at_r(
        batched(lambda q: ivf.search_adc(i88, q, r=r, ma=ma)), gt
    )
    del i88
    i164 = ivf.add(ivf.IVFIndex.create(r164, coarse), base)
    keep0 = 0.00213 * 4  # reference -k 0.213 is % of N; per-partition here
    out["recall_ivf256_16x4_qadc_ma24"] = recall_at_r(
        batched(lambda q: ivf.search_qadc(i164, q, r=r, ma=ma, keep=keep0)),
        gt,
    )
    out["recall_ivf256_16x4_qadc_ma24_norerank"] = recall_at_r(
        batched(
            lambda q: ivf.search_qadc(i164, q, r=r, ma=ma, keep=keep0,
                                      rerank=False)
        ),
        gt,
    )
    # The parity anchor is the reference's own published 4-bit cost:
    # 0.9646 - 0.9426 = +0.022 (README.md:300,329).
    out["recall_ivf_4bit_delta"] = (
        out["recall_ivf256_8x8_adc_ma24"]
        - out["recall_ivf256_16x4_qadc_ma24"]
    )
    out["recall_reference_4bit_delta"] = 0.022
    out["recall_base_n"] = n

    qd = jnp.asarray(queries)
    dt = median_seconds(
        lambda: ivf.search_qadc(i164, qd, r=r, ma=ma, keep=keep0), iters=10
    )
    out["trained_ivf_qps_b128"] = nq / dt
    return out


def main():
    import sys
    import time
    import traceback

    from qadc_tpu import compile_cache

    compile_cache.enable()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    peaks = _peaks(dev.device_kind)
    rng = np.random.default_rng(0)
    detail = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": _power_limit(),
        "timing": "host clock around block_until_ready, median of calls",
    }
    errors = {}

    def stage(name, fn):
        """Run one bench stage; a failure records {stage, error, tail} in
        detail["stage_errors"] instead of losing earlier stages' numbers."""
        t0 = time.time()
        try:
            out = fn()
            print(f"bench stage {name}: ok ({time.time() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
            return out
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            tail = traceback.format_exc().splitlines()[-3:]
            errors[name] = {
                "error": f"{type(e).__name__}: {str(e)[:300]}",
                "tail": tail,
            }
            print(f"bench stage {name}: FAIL {type(e).__name__} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
            return None

    cq_per_s = 0.0
    kr = stage("kernel", lambda: _bench_kernel(rng))
    if kr is not None:
        n, q, m, dt, scan = kr
        cq_per_s = n * q / dt
        # Speed-of-light ratios. Byte bound: the scan reads n*cb bytes once
        # per query batch. Formulation bound: the one-hot product needs
        # 2*16*cb int8 MACs (2 ops each) per code-query pair.
        sol_hbm_s = n * (m // 2) / (peaks["hbm_gbps"] * 1e9)
        sol_int8_s = 2.0 * n * q * (2 * 16 * (m // 2)) / (peaks["int8_tops"] * 1e12)
        detail.update({
            "scan": scan,
            "scan_ms_per_1M_codes_q128": dt * 1e3,
            "codes_GBps": n * (m // 2) / dt / 1e9,
            "pct_of_hbm_byte_SoL": 100.0 * sol_hbm_s / dt,
            "pct_of_int8_formulation_SoL": 100.0 * sol_int8_s / dt,
        })

    ivf_index = stage("make_ivf", lambda: _make_ivf(rng))
    if ivf_index is not None:
        for b in (128, 32, 1):
            r = stage(f"ivf_b{b}", lambda b=b: _bench_ivf_e2e(rng, ivf_index, b))
            if r is not None:
                detail[f"ivf256_ma24_r100_us_per_query_b{b}"] = r
        for b in (1, 32):
            r = stage(f"ivf_b{b}_pct",
                      lambda b=b: _bench_ivf_percentiles(rng, ivf_index, b))
            if r is not None:
                detail[f"ivf_b{b}_p50_us"] = r["p50"]
                detail[f"ivf_b{b}_p99_us"] = r["p99"]
        r = stage("adc4_b32", lambda: _bench_ivf_adc(rng, ivf_index, 32))
        if r is not None:
            detail["ivf256_ma24_adc4_us_per_query_b32"] = r
    r = stage("adc8_b32", lambda: _bench_ivf_adc(rng, _make_ivf8(rng), 32))
    if r is not None:
        detail["ivf256_ma24_adc8_us_per_query_b32"] = r

    r = stage("recall_parity_1M", lambda: _bench_recall_parity(
        np.random.default_rng(7)))
    if r is not None:
        detail.update(r)

    if errors:
        detail["stage_errors"] = errors
    print(
        json.dumps(
            {
                "metric": "qadc4_scan_throughput_1Mcodes_q128",
                "value": cq_per_s,
                "unit": "code-query pairs/s",
                "vs_baseline": cq_per_s / REFERENCE_SCAN_CQ_PER_S,
                "detail": detail,
            }
        )
    )
    if errors and not cq_per_s:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
