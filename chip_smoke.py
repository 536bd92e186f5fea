#!/usr/bin/env python3
"""On-card smoke test: the search system's main path on NVIDIA GPUs.

    python3 chip_smoke.py          one GPU: phases A and B
    python3 chip_smoke.py --four   four GPUs: phase C only

Phase A compiles the window-scan kernel (kernels/window_scan.py) at the real
widths (16x4 and 32x4 codes, part_pad 4096, G=128 query slots), prints its
compiled memory analysis, checks its window minima EXACTLY against minima
computed from kernels.scan_ref.adc_scan_int8, and times it against the
plain-XLA version of the same scan.

Phase B builds the reference's SIFT1M deployment (README of the reference,
"SIFT1M" tables) from a seed: 1M 128-d base vectors from
eval.synth.sift_moment_like, 100k learn vectors, 1024 queries; IVF-256 with
OPQ 16x4 for Quick ADC and OPQ 8x8 for float ADC; ma=24, r=100. It runs every
main route through the entry points a user calls — ivf.search_qadc at b=1,
32 and 128, ivf.search_adc 8x8 at b=32, flat.search_qadc over the 1M codes at
128 queries, a SearchServer answering requests, and the CLI's `query` on the
index saved with io.checkpoint — and prints, for each, the route
index.route chose, recall@100 against ops.knn.exact_knn (Precision.HIGHEST),
the time with the scan kernel beside the time with the plain-XLA scan where
a kernel runs, and peak device memory.

Phase C (--four) shards the 16x4 index's partitions over a 1-D mesh of four
GPUs and compares dist.sharded_ivf.search_qadc_ivf_sharded at b=32 and 128,
and dist.sharded.search_qadc_flat_sharded, with one-device search.

Every time is host clock around block_until_ready on the card named on the
`card:` line (name and power limit from nvidia-smi). The last line of
standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
With no GPU, or when any phase fails, the script exits nonzero and prints no
such line. Everything runs in one process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The deployment's scale; tests use a tiny copy."""

    n: int = 1_000_000
    learn: int = 100_000
    nq: int = 1024
    parts: int = 256
    ma: int = 24
    r: int = 100
    batches: tuple = (1, 32, 128)
    adc_batch: int = 32
    flat_batch: int = 128
    coarse_iters: int = 25
    opq_iters: int = 6
    kmeans_iters: int = 12
    serve_requests: int = 128
    # Phase A: real widths.
    scan_part_pad: int = 4096
    scan_groups: int = 160
    scan_group: int = 128
    seed: int = 0

    @property
    def keep(self) -> float:
        # The reference's -k 0.213 (percent of N) as a per-partition
        # fraction at ma=24, as in bench.py's parity stage.
        return 0.00213 * 4


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """Card name and power limit from nvidia-smi (a child that uses no JAX)."""
    out = subprocess.run(CARD_QUERY, capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def peak_bytes() -> int | None:
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def timed_batches(fn, queries, batch):
    """Run fn over all queries in fixed batches; returns (labels, median
    seconds per batch, distances). The first batch is run untimed first
    (compile)."""
    import jax
    import jax.numpy as jnp

    q = queries.shape[0] - queries.shape[0] % batch
    jax.block_until_ready(fn(jnp.asarray(queries[:batch])))
    dists, labels, times = [], [], []
    for s in range(0, q, batch):
        qs = jnp.asarray(queries[s : s + batch])
        t0 = time.perf_counter()
        d, lab = jax.block_until_ready(fn(qs))
        times.append(time.perf_counter() - t0)
        dists.append(np.asarray(d))
        labels.append(np.asarray(lab))
    return np.concatenate(labels), float(np.median(times)), np.concatenate(dists)


def dominated(d_sub, d_all, rtol=1e-5):
    """Per row, the i-th smallest distance of a search over a subset of the
    candidates is at least the i-th smallest over all of them (float ADC
    sums in another order: rtol)."""
    fin = np.where(np.isfinite(d_all), np.abs(d_all), 0.0)
    return bool(np.all(d_sub >= d_all - rtol * fin))


# ---------------------------------------------------------------- phase A


def scan_oracle(codes, group_part, group_sizes, tables, *, code_size,
                rows_per_group, window):
    """Window minima from kernels.scan_ref.adc_scan_int8 (int32, unsaturated)."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.kernels.scan_ref import adc_scan_int8
    from qadc_tpu.kernels.window_scan import SENTINEL_I32

    m = code_size * 2
    gcap = group_part.shape[0]
    g = tables.shape[0] // gcap
    c = rows_per_group // window
    parts = codes.reshape(-1, rows_per_group, code_size)

    def one(args):
        p, sz, t = args
        d = adc_scan_int8(parts[p], t.reshape(g, m, 16), saturate=False)
        w = d.reshape(g, c, window).min(-1)
        return jnp.where(jnp.arange(c)[None, :] * window < sz, w, SENTINEL_I32)

    out = jax.lax.map(
        one, (group_part, group_sizes, tables.reshape(gcap, g, m * 16)),
        batch_size=8,
    )
    return out.reshape(gcap * g, c)


def phase_a(sz: Sizes, mode: str, widths=((16, 16), (32, 8)), time_it=True,
            card=""):
    """Compile the scan kernel at each (sq_count, window), check it exactly
    against scan_ref, time it against the plain-XLA scan. Returns records."""
    import functools

    import jax
    import jax.numpy as jnp

    from qadc_tpu.eval.timing import median_seconds
    from qadc_tpu.kernels.window_scan import window_min_scan

    rng = np.random.default_rng(sz.seed)
    pp, gcap, g = sz.scan_part_pad, sz.scan_groups, sz.scan_group
    records = []
    for m, window in widths:
        cb = m // 2
        cpr = 128 // cb
        codes = jnp.asarray(
            rng.integers(0, 256, size=(sz.parts * pp // cpr, 128), dtype=np.uint8)
        )
        gp = jnp.asarray(rng.integers(0, sz.parts, gcap).astype(np.int32))
        sizes = rng.integers(pp // 2, pp + 1, gcap)
        sizes[: min(3, gcap)] = [0, 1, pp - 1][: min(3, gcap)]   # ragged edges
        gsz = jnp.asarray(sizes.astype(np.int32))
        tabs = jnp.asarray(rng.integers(0, 128, size=(gcap * g, m * 16)).astype(np.int8))
        args = (codes, gp, gsz, tabs)
        kw = dict(code_size=cb, rows_per_group=pp, window=window)
        kernel = jax.jit(functools.partial(window_min_scan, mode=mode, **kw))
        compiled = kernel.lower(*args).compile()
        say(f"phase A {m}x4 W={window}: memory_analysis {compiled.memory_analysis()}")
        got = compiled(*args)
        ref = jax.jit(functools.partial(scan_oracle, **kw))(*args)
        exact = bool(jnp.array_equal(got, ref))
        rec = {"m": m, "window": window, "exact": exact}
        if not exact:
            raise AssertionError(f"phase A {m}x4: kernel window minima differ from scan_ref")
        if time_it:
            plain = jax.jit(functools.partial(window_min_scan, mode="xla", **kw))
            rec["kernel_s"] = median_seconds(lambda: compiled(*args))
            rec["xla_s"] = median_seconds(lambda: plain(*args))
        say(f"phase A {m}x4 W={window} G={g} groups={gcap} part_pad={pp}: "
            f"window minima == scan_ref: {exact}"
            + (f"; kernel {rec['kernel_s'] * 1e3:.4f} ms, plain XLA "
               f"{rec['xla_s'] * 1e3:.4f} ms [{card}]" if time_it else ""))
        records.append(rec)
    return records


# ---------------------------------------------------------------- phase B


def build_sift1m(sz: Sizes, with_adc8=True):
    """Data, ground truth and the three indexes of the deployment."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.eval.synth import sift_moment_like
    from qadc_tpu.index import flat, ivf
    from qadc_tpu.ops.knn import assign_nearest, exact_knn
    from qadc_tpu.quantizers.opq import train_opq

    t0 = time.perf_counter()
    rng = np.random.default_rng(sz.seed)
    base, queries = sift_moment_like(rng, sz.n, nq=sz.nq)
    learn = base[: sz.learn]
    _, gt = exact_knn(jnp.asarray(queries), jnp.asarray(base), 1)
    gt = np.asarray(gt)
    key = jax.random.PRNGKey(sz.seed)
    coarse = ivf.train_coarse(jax.random.fold_in(key, 1), learn, sz.parts,
                              iters=sz.coarse_iters, balance_cap=3.0)
    a = np.asarray(assign_nearest(learn, coarse))
    residuals = learn - np.asarray(coarse)[a]
    opq_kw = dict(opq_iters=sz.opq_iters, kmeans_iters=sz.kmeans_iters)
    out = {"base": base, "queries": queries, "gt": gt}
    r164 = train_opq(jax.random.fold_in(key, 2), residuals, 16, 4, **opq_kw)
    out["ivf164"] = ivf.add(ivf.IVFIndex.create(r164, coarse), base)
    if with_adc8:
        r88 = train_opq(jax.random.fold_in(key, 3), residuals, 8, 8, **opq_kw)
        out["ivf88"] = ivf.add(ivf.IVFIndex.create(r88, coarse), base)
    f164 = train_opq(jax.random.fold_in(key, 4), learn, 16, 4, **opq_kw)
    out["flat164"] = flat.add(flat.FlatIndex.create(f164), base)
    ix = out["ivf164"]
    say(f"built: n={sz.n} dim={base.shape[1]} parts={sz.parts} "
        f"part_pad={ix.part_pad} max_part={ix.max_part_size} "
        f"in {time.perf_counter() - t0:.1f} s")
    return out


def check_same_scan(name, d_k, l_k, d_x, l_x):
    """The kernel and the plain-XLA scan give the same integer window minima,
    so both searches rerank the same codes. The float rerank is compiled
    into two programs and may round a distance differently by an ulp, which
    can swap labels whose distances are equal to float rounding. Anything
    else is a fault."""
    exact = bool(np.array_equal(l_k, l_x))
    ties = exact or same_up_to_ties(d_k, l_k, d_x, l_x)
    say(f"phase B {name}: labels with the kernel and with the plain-XLA scan "
        f"identical: {exact}; equal up to float ties: {ties}")
    if not ties:
        raise AssertionError(
            f"{name}: labels differ between the scan kernel and the plain-XLA "
            "scan beyond float ties")


def _grouped_plain(index, sz: Sizes):
    """ivf.search_qadc's grouped route with the plain-XLA scan in place of
    the kernel (the comparison the kernel must beat)."""
    from qadc_tpu.index import ivf
    from qadc_tpu.kernels.window_scan import DEFAULT_WINDOW

    prefix_pad = min(max(1, int(index.max_part_size * sz.keep)), index.part_pad)
    window = min(index.cpr, DEFAULT_WINDOW)

    def fn(qs):
        return ivf._search_qadc_grouped_impl(
            index, qs, sz.r, sz.ma, sz.keep, prefix_pad, True, 128, window, "xla"
        )

    return fn


def phase_b(sz: Sizes, built=None, interpret=False, card=""):
    """Every main route at the deployment's size. Returns records."""
    from qadc_tpu.eval.recall import recall_at_r
    from qadc_tpu.index import flat, ivf, route
    from qadc_tpu.serve import SearchServer

    b = built or build_sift1m(sz)
    queries, gt = b["queries"], b["gt"]
    ix = b["ivf164"]
    records = {}

    def report(name, rt, rec, t_kernel=None, t_plain=None, batch=None):
        line = f"phase B {name}: route={rt.path}/{rt.scan} recall@{sz.r}={rec:.4f}"
        if t_kernel is not None:
            line += f" time/batch({batch})={t_kernel * 1e3:.4f} ms"
        if t_plain is not None:
            line += f" plain-XLA-scan={t_plain * 1e3:.4f} ms"
        line += f" peak_bytes_in_use={peak_bytes()} [{card}]"
        say(line)
        records[name] = {"route": f"{rt.path}/{rt.scan}", "recall": rec,
                         "t": t_kernel, "t_plain": t_plain}

    def qadc(**kw):
        return lambda qs: ivf.search_qadc(ix, qs, r=sz.r, ma=sz.ma, keep=sz.keep,
                                          interpret=interpret, **kw)

    for bsz in sz.batches:
        rt = route.choose("ivf_qadc", ix, q=bsz, ma=sz.ma, interpret=interpret)
        lab, t, dist = timed_batches(qadc(), queries, bsz)
        t_plain = None
        if rt.path == "grouped" and rt.scan != "xla":
            lab_x, t_plain, dist_x = timed_batches(_grouped_plain(ix, sz),
                                                   queries, bsz)
            check_same_scan(f"ivf_qadc_16x4_b{bsz}", dist, lab, dist_x, lab_x)
        rec = recall_at_r(lab, gt[: lab.shape[0]])
        report(f"ivf_qadc_16x4_b{bsz}", rt, rec, t, t_plain, bsz)
        if rt.path == "grouped":
            # The direct route ranks every probed code by exact float ADC;
            # the grouped route ranks the codes its int8 screen keeps by the
            # same distances. So, per query, the grouped i-th distance is
            # never below the direct i-th. Recall has no such order: where
            # the screen drops codes that rank ahead of the true neighbour,
            # the neighbour can rise into the grouped top r.
            lab_d, _, dist_d = timed_batches(qadc(direct=True), queries, bsz)
            rec_d = recall_at_r(lab_d, gt[: lab_d.shape[0]])
            hit = (lab == gt[: lab.shape[0], :1]).any(1)
            hit_d = (lab_d == gt[: lab_d.shape[0], :1]).any(1)
            dom = dominated(dist, dist_d)
            say(f"phase B ivf_qadc_16x4_b{bsz}: direct-route recall@{sz.r}="
                f"{rec_d:.4f} (grouped {rec:.4f}; neighbour found by grouped "
                f"only {int((hit & ~hit_d).sum())}, by direct only "
                f"{int((hit_d & ~hit).sum())} queries); grouped distances "
                f">= direct per rank: {dom}")
            if not dom:
                raise AssertionError(
                    f"b={bsz}: a grouped distance is below the direct route's "
                    "at the same rank"
                )
            if rec_d - rec > 0.02:
                raise AssertionError(
                    f"b={bsz}: grouped recall {rec} more than 0.02 below the "
                    f"direct route's {rec_d}"
                )
            records[f"ivf_qadc_16x4_b{bsz}"].update(
                recall_direct=rec_d, dominated=dom)

    if "ivf88" in b:
        i88 = b["ivf88"]
        rt = route.choose("ivf_adc", i88, interpret=interpret)
        lab, t, _ = timed_batches(
            lambda qs: ivf.search_adc(i88, qs, r=sz.r, ma=sz.ma,
                                      interpret=interpret),
            queries, sz.adc_batch,
        )
        report(f"ivf_adc_8x8_b{sz.adc_batch}", rt, recall_at_r(lab, gt), t,
               None, sz.adc_batch)

    fx = b["flat164"]
    rt = route.choose("flat_qadc", fx, r=sz.r, interpret=interpret)
    lab, t, dist = timed_batches(
        lambda qs: flat.search_qadc(fx, qs, r=sz.r, keep=sz.keep,
                                    interpret=interpret),
        queries, sz.flat_batch,
    )
    t_plain = None
    if rt.path == "window" and rt.scan != "xla":
        lab_x, t_plain, dist_x = timed_batches(
            lambda qs: flat._search_qadc_impl(
                fx, qs, sz.r, sz.keep, True, False, None, "window", "xla"),
            queries, sz.flat_batch,
        )
        check_same_scan(f"flat_qadc_16x4_b{sz.flat_batch}", dist, lab, dist_x,
                        lab_x)
    report(f"flat_qadc_16x4_b{sz.flat_batch}", rt, recall_at_r(lab, gt), t,
           t_plain, sz.flat_batch)

    # SearchServer: concurrent requests batched into the server's buckets.
    nreq = min(sz.serve_requests, queries.shape[0])
    with SearchServer(ix, r=sz.r, ma=sz.ma, keep=sz.keep, batch_size=128) as srv:
        t0 = time.perf_counter()
        futs = [srv.submit(queries[i]) for i in range(nreq)]
        served = np.stack([np.asarray(f.result(timeout=900)[1]) for f in futs])
        t_serve = time.perf_counter() - t0
    rec_serve = recall_at_r(served, gt[:nreq])
    # Requests land in buckets of 1, 8 or 128 (direct or grouped route);
    # each served row must agree with the exact float ADC ranking of its
    # probed codes (the direct route) on most of its labels.
    _, exact = ivf.search_qadc(ix, queries[:nreq], r=sz.r, ma=sz.ma,
                               keep=sz.keep, direct=True)
    exact = np.asarray(exact)
    overlap = float(np.mean([len(set(served[i]) & set(exact[i])) / sz.r
                             for i in range(nreq)]))
    say(f"phase B serve: {nreq} requests in {t_serve:.3f} s (compiles "
        f"included) recall@{sz.r}={rec_serve:.4f} overlap with exact "
        f"ranking={overlap:.4f} peak_bytes_in_use={peak_bytes()} [{card}]")
    if served.shape != (nreq, sz.r) or overlap < 0.9:
        raise AssertionError("served results disagree with the direct route")
    records["serve"] = {"recall": rec_serve}

    # CLI `query` on the saved index, in this process.
    from qadc_tpu.cli.main import main as cli_main
    from qadc_tpu.io import save_index, save_vectors

    bq = sz.batches[1] if len(sz.batches) > 1 else sz.batches[0]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index")
        save_index(path, ix)
        qf, gf = os.path.join(tmp, "q.fvecs"), os.path.join(tmp, "gt.ivecs")
        save_vectors(qf, queries)
        save_vectors(gf, gt.astype(np.int32))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["query", path, qf, gf, "-r", str(sz.r), "-m", str(sz.ma),
                      "-k", repr(sz.keep * 100), "-b", str(bq)])
    rows = buf.getvalue().strip().splitlines()
    rec_cli = float(rows[-1].split(",")[1])
    say(f"phase B cli query (b={bq}): {rows[-1]}")
    # The CLI batches queries exactly as the b=bq route did; on the same
    # route it must find the same neighbours.
    same = records.get(f"ivf_qadc_16x4_b{bq}", {})
    rt_cli = route.choose("ivf_qadc", ix, q=bq, ma=sz.ma)
    if same.get("route") == f"{rt_cli.path}/{rt_cli.scan}" and rec_cli != same["recall"]:
        raise AssertionError(f"CLI recall {rec_cli} vs route recall {same['recall']}")
    records["cli"] = {"recall": rec_cli}
    return records


# ---------------------------------------------------------------- phase C


def same_up_to_ties(d_a, l_a, d_b, l_b, rtol=1e-5):
    """Result rows agree except for labels swapped at equal distances."""
    if not np.allclose(d_a, d_b, rtol=rtol, atol=1e-3):
        return False
    for i in range(l_a.shape[0]):
        only_a = set(l_a[i]) - set(l_b[i])
        only_b = set(l_b[i]) - set(l_a[i])
        if len(only_a) != len(only_b):
            return False
        da = {d_a[i][list(l_a[i]).index(x)] for x in only_a}
        db = {d_b[i][list(l_b[i]).index(x)] for x in only_b}
        if not all(np.isclose(v, list(db), rtol=rtol).any() for v in da):
            return False
    return True


def phase_c(sz: Sizes, n_devices=4, built=None, interpret=False, card=""):
    """Partition-sharded IVF and code-sharded flat search over n devices,
    against one-device search on the same index."""
    import jax
    import jax.numpy as jnp

    from qadc_tpu.dist.mesh import make_mesh
    from qadc_tpu.dist.sharded import search_qadc_flat_sharded, shard_flat_codes
    from qadc_tpu.dist.sharded_ivf import search_qadc_ivf_sharded, shard_ivf_partitions
    from qadc_tpu.eval.recall import recall_at_r
    from qadc_tpu.index import flat, ivf

    b = built or build_sift1m(sz, with_adc8=False)
    queries, gt = b["queries"], b["gt"]
    ix = b["ivf164"]
    mesh = make_mesh(n_devices)
    sh = shard_ivf_partitions(ix, mesh)
    devs = sorted({str(s.device) for s in sh.codes.addressable_shards})
    say(f"phase C ivf shards on: {devs}")
    if len(devs) != n_devices:
        raise AssertionError("partition shards do not cover every device")
    for bsz in [x for x in sz.batches if x > 1]:
        q = jnp.asarray(queries[: (queries.shape[0] // bsz) * bsz])
        single = lambda qs: ivf.search_qadc(  # noqa: E731
            ix, qs, r=sz.r, ma=sz.ma, keep=sz.keep, grouped=True, direct=False,
            interpret=interpret)
        sharded = lambda qs: search_qadc_ivf_sharded(  # noqa: E731
            sh, qs, r=sz.r, ma=sz.ma, keep=sz.keep, mesh=mesh, interpret=interpret)
        out = {}
        for name, fn in (("single", single), ("sharded", sharded)):
            ds, ls, ts = [], [], []
            jax.block_until_ready(fn(q[:bsz]))
            for s in range(0, q.shape[0], bsz):
                t0 = time.perf_counter()
                d, l = jax.block_until_ready(fn(q[s : s + bsz]))
                ts.append(time.perf_counter() - t0)
                ds.append(np.asarray(d))
                ls.append(np.asarray(l))
            out[name] = (np.concatenate(ds), np.concatenate(ls), float(np.median(ts)))
        (d1, l1, t1), (d4, l4, t4) = out["single"], out["sharded"]
        r1, r4 = recall_at_r(l1, gt[: l1.shape[0]]), recall_at_r(l4, gt[: l4.shape[0]])
        agree = same_up_to_ties(d1, l1, d4, l4)
        say(f"phase C ivf b={bsz}: recall@{sz.r} single={r1:.4f} "
            f"sharded={r4:.4f}; labels equal up to ties: {agree}; "
            f"time/batch single={t1 * 1e3:.4f} ms sharded={t4 * 1e3:.4f} ms "
            f"[{card}]")
        if not agree or r1 != r4:
            raise AssertionError(f"sharded IVF differs from one device at b={bsz}")

    fx = b["flat164"]
    fsh = shard_flat_codes(fx, mesh)
    say(f"phase C flat shards on: "
        f"{sorted({str(s.device) for s in fsh.codes.addressable_shards})}")
    q = jnp.asarray(queries[: sz.flat_batch])
    d1, l1 = flat.search_qadc(fx, q, r=sz.r, keep=sz.keep, interpret=interpret)
    d4, l4 = search_qadc_flat_sharded(fsh, q, r=sz.r, keep=sz.keep, mesh=mesh,
                                      interpret=interpret)
    d1, l1, d4, l4 = map(np.asarray, (d1, l1, d4, l4))
    r1 = recall_at_r(l1, gt[: q.shape[0]])
    r4 = recall_at_r(l4, gt[: q.shape[0]])
    say(f"phase C flat b={q.shape[0]}: recall@{sz.r} single={r1:.4f} "
        f"sharded={r4:.4f}")
    # The code-sharded search screens per shard (int8 bound from the global
    # prefix, top-2r per shard), so it is checked by recall, not label
    # identity.
    if abs(r1 - r4) > 0.01:
        raise AssertionError("sharded flat recall differs from one device")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four-GPU phase only (partition-sharded IVF)")
    args = ap.parse_args(argv)

    from qadc_tpu import compile_cache

    say(f"compile cache: {compile_cache.enable()}")
    import jax

    devices = jax.devices()
    dev = devices[0]
    say(f"jax {jax.__version__} devices: {devices}")
    say(f"platform={dev.platform} device_kind={dev.device_kind} count={len(devices)}")
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    card = card_line()
    say(f"card: {card}")
    card = card.splitlines()[0]
    sz = Sizes()
    if args.four:
        if len(devices) < 4:
            print("chip_smoke --four: needs four GPUs", file=sys.stderr)
            return 2
        phase_c(sz, 4, card=card)
    else:
        phase_a(sz, "triton", card=card)
        phase_b(sz, card=card)
    say(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
