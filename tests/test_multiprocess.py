"""2-process jax.distributed integration test (CPU, localhost coordinator).

All other dist tests run ONE process over 8 virtual devices, which cannot
catch process-boundary bugs (host-local arrays fed to shard_map, per-process
shard loading, coordinator setup). Here two real OS processes each own 2 CPU
devices, initialize a jax.distributed group through the QADC_* env-var path
of dist.mesh.maybe_init_distributed, load only their own checkpoint shard,
and run the sharded search over the global 4-device mesh; results must equal
a single-process 4-device mesh run on the same data.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

from qadc_tpu.dist.mesh import make_mesh
from qadc_tpu.dist.sharded_ivf import search_qadc_ivf_sharded, shard_ivf_partitions
from qadc_tpu.index import ivf
from qadc_tpu.io.checkpoint import save_index_sharded
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import train_pq

R, MA, KEEP = 20, 4, 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(21)
    dim, n = 16, 6000
    centers = rng.normal(scale=3.0, size=(8, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, dim))).astype(
        np.float32
    )
    queries = (centers[rng.integers(0, 8, 8)] + rng.normal(size=(8, dim))).astype(
        np.float32
    )
    coarse = ivf.train_coarse(jax.random.PRNGKey(0), base[:3000], 8, iters=8)
    a = np.asarray(assign_nearest(base[:3000], coarse))
    pq = train_pq(
        jax.random.PRNGKey(1), base[:3000] - np.asarray(coarse)[a], 16, 4, iters=8
    )
    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    ckpt = str(tmp / "ckpt")
    save_index_sharded(ckpt, index, num_shards=2)
    qfile = str(tmp / "queries.npz")
    np.savez(qfile, queries=queries, r=R, ma=MA, keep=KEEP)
    return index, queries, ckpt, qfile, tmp


def _spawn_workers(ckpt, qfile, tmp, port, tag, progress_dir=None):
    worker = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")
    procs, outs = [], []
    for i in range(2):
        out = str(tmp / f"out_{tag}_{i}.npz")
        outs.append(out)
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # EXTEND PYTHONPATH (overriding would drop the caller's entries).
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.update(
            QADC_COORDINATOR=f"127.0.0.1:{port}",
            QADC_NUM_PROCESSES="2",
            QADC_PROCESS_ID=str(i),
        )
        argv = [sys.executable, worker, ckpt, qfile, out]
        if progress_dir is not None:
            argv.append(str(progress_dir))
        procs.append(
            subprocess.Popen(
                argv,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    return procs, outs


def _join_workers(procs):
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"


def _expected(index, queries):
    mesh = make_mesh(4)
    sharded = shard_ivf_partitions(index, mesh)
    d_exp, l_exp = search_qadc_ivf_sharded(
        sharded, queries, r=R, ma=MA, keep=KEEP, mesh=mesh, interpret=True
    )
    return np.asarray(d_exp), np.asarray(l_exp)


def test_two_process_distributed_matches_single_process(built):
    index, queries, ckpt, qfile, tmp = built
    d_exp, l_exp = _expected(index, queries)

    procs, outs = _spawn_workers(ckpt, qfile, tmp, _free_port(), "eq")
    _join_workers(procs)

    for out in outs:  # every process saw the same replicated global result
        got = np.load(out)
        np.testing.assert_array_equal(got["l"], l_exp)
        np.testing.assert_allclose(got["d"], d_exp, rtol=1e-5, atol=1e-5)


def test_reshard_on_load_4_shards_2_processes(built):
    """A checkpoint written for 4 hosts restarts on 2 processes: each process
    re-slices two shard files' rows on load (SURVEY §5.3 elastic restart)."""
    index, queries, ckpt, qfile, tmp = built
    d_exp, l_exp = _expected(index, queries)

    ckpt4 = str(tmp / "ckpt4")
    save_index_sharded(ckpt4, index, num_shards=4)
    procs, outs = _spawn_workers(ckpt4, qfile, tmp, _free_port(), "rs")
    _join_workers(procs)
    for out in outs:
        got = np.load(out)
        np.testing.assert_array_equal(got["l"], l_exp)
        np.testing.assert_allclose(got["d"], d_exp, rtol=1e-5, atol=1e-5)


def test_kill_and_restart_bitmatches(built):
    """Failure injection: SIGKILL one worker after its first batch; the
    restarted group reloads only its shards and the full run bit-matches."""
    import time

    index, queries, ckpt, _, tmp = built
    rng = np.random.default_rng(7)
    q2 = np.stack([queries, queries + rng.normal(size=queries.shape).astype(np.float32) * 0.1])
    qfile2 = str(tmp / "queries2.npz")
    np.savez(qfile2, queries=q2, r=R, ma=MA, keep=KEEP)
    exp = [_expected(index, b) for b in q2]
    d_exp = np.concatenate([e[0] for e in exp])
    l_exp = np.concatenate([e[1] for e in exp])

    prog = tmp / "prog"
    prog.mkdir()
    procs, _ = _spawn_workers(ckpt, qfile2, tmp, _free_port(), "k1", prog)
    # Deterministic mid-run point: both processes finished batch 0.
    deadline = time.time() + 600
    while not (
        (prog / "p0_b0.done").exists() and (prog / "p1_b0.done").exists()
    ):
        if time.time() > deadline:
            for p in procs:
                p.kill()
            pytest.fail("workers never reached batch 0")
        for p in procs:
            assert p.poll() is None or p.returncode == 0, "worker died early"
        time.sleep(0.2)
    procs[1].kill()  # exact child PID — simulated host failure mid-run
    procs[1].wait()
    # The survivor cannot complete the batch-1 collective alone; tear it down
    # (a real launcher would do the same once the peer is declared dead).
    try:
        procs[0].wait(timeout=30)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].wait()

    # Elastic restart: fresh coordinator, same checkpoint, full run.
    for f in prog.iterdir():
        f.unlink()
    procs2, outs2 = _spawn_workers(ckpt, qfile2, tmp, _free_port(), "k2", prog)
    _join_workers(procs2)
    for out in outs2:
        got = np.load(out)
        np.testing.assert_array_equal(got["l"], l_exp)
        np.testing.assert_allclose(got["d"], d_exp, rtol=1e-5, atol=1e-5)


def test_load_sharded_index_single_process(built):
    """Single-process load paths: shards == processes (1), and reshard-on-load
    of a 2-shard checkpoint into one process."""
    from qadc_tpu.dist.sharded_ivf import load_sharded_index

    index, queries, ckpt, _, tmp = built
    mesh = make_mesh(4)

    # 2 shards, 1 process: resharded on load (previously rejected).
    loaded2 = load_sharded_index(ckpt, mesh)
    d_exp, l_exp = _expected(index, queries)
    d_got, l_got = search_qadc_ivf_sharded(
        loaded2, queries, r=R, ma=MA, keep=KEEP, mesh=mesh, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(l_got), l_exp)
    np.testing.assert_allclose(np.asarray(d_got), d_exp, rtol=1e-5, atol=1e-5)

    ckpt1 = str(tmp / "ckpt1")
    save_index_sharded(ckpt1, index, num_shards=1)
    loaded = load_sharded_index(ckpt1, mesh)
    assert loaded.n == index.n
    np.testing.assert_array_equal(
        np.asarray(loaded.part_sizes)[: index.part_count],
        np.asarray(index.part_sizes),
    )
