"""qadc CLI — the reference's executable surface, consolidated.

Reference executables (README.md:138-146) -> subcommands:
  flatdb_create            -> qadc create-flat
  indexdb_create1/2 +
    external PQ training   -> qadc create-index   (ONE step: coarse k-means AND
                              PQ/OPQ training on residuals are in-framework)
  indexdb_create2          -> qadc set-quantizer  (external-training round
                              trip: create-index --residuals-out -> train
                              externally -> set-quantizer -> add -> query)
  db_add                   -> qadc add            (streaming 1M-vector chunks)
  db_query                 -> qadc query --adc-type adc
  db_query_4               -> qadc query --adc-type qadc  (default)
  split_vecs               -> qadc split
  convert-quantizer.py     -> qadc convert-quantizer

Output contract for `query` matches the reference CSV
(db_query.cpp:117-120, db_query_4.cpp:387-390):
  r,recall,ma,adc_type[,keep],index_us,rotate_us,table_us,scan_us
"""

from __future__ import annotations

import argparse
import sys


def _parse_sq(spec: str):
    """'16x4' -> (16, 4)."""
    try:
        m, b = spec.lower().split("x")
        return int(m), int(b)
    except Exception:
        raise SystemExit(f"invalid --sq '{spec}', expected MxB like 16x4")


def cmd_create_flat(args):
    import jax
    from qadc_tpu.index.flat import FlatIndex
    from qadc_tpu.io import load_quantizer_file, load_vectors, save_index

    if args.quantizer:
        pq = load_quantizer_file(args.quantizer)
    else:
        if not args.train:
            raise SystemExit("need a quantizer file or --train LEARN_FILE")
        m, b = _parse_sq(args.sq)
        learn = load_vectors(args.train)
        key = jax.random.PRNGKey(args.seed)
        if args.opq:
            from qadc_tpu.quantizers.opq import train_opq

            pq = train_opq(key, learn, m, b)
        else:
            from qadc_tpu.quantizers.pq import train_pq

            pq = train_pq(key, learn, m, b)
    save_index(args.index, FlatIndex.create(pq))
    print(f"created flat index at {args.index}", file=sys.stderr)


def cmd_create_index(args):
    """One-step IVF creation: coarse k-means + PQ/OPQ on residuals.

    Replaces the reference's 3-step pipeline (indexdb_create1 -> external
    Quantizations training -> indexdb_create2, README.md:220-260).
    """
    import jax
    import numpy as np
    from qadc_tpu.index.ivf import IVFIndex, train_coarse
    from qadc_tpu.io import load_vectors, save_index
    from qadc_tpu.ops.knn import assign_nearest

    learn = load_vectors(args.learn)
    key = jax.random.PRNGKey(args.seed)
    k1, k2 = jax.random.split(key)
    coarse = train_coarse(k1, learn, args.parts,
                          balance_cap=args.balance_cap or None)
    print(f"coarse quantizer: {args.parts} cells", file=sys.stderr)
    assign = np.asarray(assign_nearest(learn, coarse))
    residuals = learn - np.asarray(coarse)[assign]
    # Self-check (reference: indexdb_create1 check_residuals to 1e-5).
    recon = np.asarray(coarse)[assign] + residuals
    err = np.abs(recon - learn).max()
    if err > 1e-5:
        raise SystemExit(f"residual check failed: {err}")
    if args.residuals_out:
        # Interop with external quantizer training (the reference's
        # indexdb_create1 residuals file, README.md:220-260).
        from qadc_tpu.io import save_vectors

        save_vectors(args.residuals_out, residuals)
        print(f"residuals written to {args.residuals_out}", file=sys.stderr)
    if args.quantizer:
        # Pre-trained (typically externally trained on a residuals file from
        # a previous --residuals-out run) — reference indexdb_create2.
        from qadc_tpu.io import load_quantizer_file

        pq = load_quantizer_file(args.quantizer)
        if pq.dim != learn.shape[1]:
            raise SystemExit(f"quantizer dim {pq.dim} != data dim {learn.shape[1]}")
    elif args.opq:
        from qadc_tpu.quantizers.opq import train_opq

        m, b = _parse_sq(args.sq)
        pq = train_opq(k2, residuals, m, b)
    else:
        from qadc_tpu.quantizers.pq import train_pq

        m, b = _parse_sq(args.sq)
        pq = train_pq(k2, residuals, m, b)
    save_index(args.index, IVFIndex.create(pq, coarse))
    print(f"created IVF index at {args.index}", file=sys.stderr)


def cmd_set_quantizer(args):
    """Swap an externally trained quantizer into an existing EMPTY index.

    Reference: indexdb_create2 (indexdb_create2.cpp:41-59) — step 2 of the
    external-training workflow: create-index --residuals-out R -> train
    PQ/OPQ on R externally -> set-quantizer -> add -> query.
    """
    from qadc_tpu.index import ivf
    from qadc_tpu.index.flat import FlatIndex
    from qadc_tpu.io import load_index, load_quantizer_file, save_index

    index = load_index(args.index)
    pq = load_quantizer_file(args.quantizer)
    if isinstance(index, FlatIndex):
        if index.n != 0:
            raise SystemExit(
                f"index is non-empty (n={index.n}); swap before adding vectors"
            )
        if pq.dim != index.pq.dim:
            raise SystemExit(f"quantizer dim {pq.dim} != index dim {index.pq.dim}")
        new = FlatIndex.create(pq)
    else:
        try:
            new = ivf.set_quantizer(index, pq)
        except ValueError as e:
            raise SystemExit(str(e))
    save_index(args.out or args.index, new)
    print(
        f"installed quantizer {args.quantizer} into {args.out or args.index}",
        file=sys.stderr,
    )


def cmd_add(args):
    from qadc_tpu.index.flat import FlatIndex
    from qadc_tpu.index.build import FlatBuilder, IVFBuilder
    from qadc_tpu.io import load_index, save_index
    from qadc_tpu.io.stream import VectorStream
    from qadc_tpu.eval.metrics import PhaseTimer

    index = load_index(args.index)
    builder = (
        FlatBuilder.from_index(index)
        if isinstance(index, FlatIndex)
        else IVFBuilder.from_index(index)
    )
    stream = VectorStream(args.base, chunk_size=args.chunk_size)
    timer = PhaseTimer()
    for off, chunk in stream:
        builder.add(chunk)
        print(
            f"added [{off}, {off+chunk.shape[0]}) in {timer.lap_us()/1e6:.1f}s",
            file=sys.stderr,
        )
    index = builder.finalize()
    save_index(args.index, index)
    print(f"index now holds {index.n} vectors", file=sys.stderr)


def cmd_query(args):
    import numpy as np
    from qadc_tpu.engine import QueryEngine
    from qadc_tpu.eval.recall import recall_at_r
    from qadc_tpu.io import load_index, load_vectors

    index = load_index(args.index)
    queries = load_vectors(args.queries)
    gt = load_vectors(args.groundtruth, to_float=False)
    keep = args.keep / 100.0  # reference -k flag is in percent (db_query_4.cpp:342)
    engine = QueryEngine(
        index,
        r=args.r,
        ma=args.ma,
        keep=keep,
        adc_type=args.adc_type,
        batch_size=args.batch,
        rerank=not args.no_rerank,
    )
    dists, labels, metrics = engine.run(queries, with_metrics=True)
    recall = recall_at_r(labels, np.asarray(gt))
    if args.adc_type == "qadc":
        print(f"r,recall,ma,adc_type,keep,{metrics.HEADER}")
        print(f"{args.r},{recall},{args.ma},qadc,{keep},{metrics.csv_row()}")
    else:
        print(f"r,recall,ma,adc_type,{metrics.HEADER}")
        print(f"{args.r},{recall},{args.ma},adc,{metrics.csv_row()}")


def cmd_info(args):
    """Describe an index (reference: base_db::print / operator<<)."""
    import numpy as np
    from qadc_tpu.index.ivf import IVFIndex
    from qadc_tpu.io import load_index
    from qadc_tpu.quantizers.opq import OPQQuantizer

    index = load_index(args.index)
    pq = index.pq
    kind = "opq" if isinstance(pq, OPQQuantizer) else "pq"
    print(f"type: {'ivf' if isinstance(index, IVFIndex) else 'flat'}")
    print(f"vectors: {index.n}")
    print(f"quantizer: {kind} (dim={pq.dim}, sq={pq.sq_count}x{pq.sq_bits}, "
          f"code_size={pq.code_size} bytes)")
    if isinstance(index, IVFIndex):
        sizes = np.asarray(index.part_sizes)
        nonempty = sizes[sizes > 0]
        print(f"partitions: {index.part_count} "
              f"(empty={int((sizes == 0).sum())}, "
              f"min={int(nonempty.min()) if nonempty.size else 0}, "
              f"mean={float(sizes.mean()):.0f}, max={int(sizes.max())}, "
              f"padded_to={index.part_pad})")


def cmd_tune(args):
    """Measure and record per-geometry kernel parameters for an IVF index.

    No reference analog (its scan blocks are fixed by SIMD register shape);
    here the right block is a measured property of geometry x compiler x
    device — see qadc_tpu/autotune.py. The recorded pick is consumed automatically by
    subsequent searches of any index with the same geometry (cache file:
    QADC_AUTOTUNE_CACHE, default ~/.cache/qadc_tpu/autotune.json).
    """
    import numpy as np

    from qadc_tpu import autotune
    from qadc_tpu.index.ivf import IVFIndex
    from qadc_tpu.io import load_index, load_vectors

    index = load_index(args.index)
    if not isinstance(index, IVFIndex):
        raise SystemExit("tune: only IVF indexes have tunable grouped scans")
    if args.queries:
        queries = np.asarray(load_vectors(args.queries))[: args.batch]
    else:
        rng = np.random.default_rng(0)
        queries = rng.normal(size=(args.batch, index.pq.dim)).astype(np.float32)
    pick = autotune.tune_ivf_qadc(
        index, queries, r=args.r, ma=args.ma, keep=args.keep / 100.0,
        verbose=True,
    )
    key = autotune.geometry_key(index, "ivf_qadc_grouped", queries.shape[0])
    print(f"recorded {pick} under {key}")


def cmd_split(args):
    from qadc_tpu.io import split_vecs

    split_vecs(args.input, args.output, args.chunk_id, args.chunk_size)


def cmd_convert_quantizer(args):
    """Convert pickled Quantizations codebooks to .pq.data/.opq.data
    (reference: convert-quantizer.py)."""
    import numpy as np
    import pickle

    from qadc_tpu.io import save_quantizer_file
    from qadc_tpu.quantizers.pq import ProductQuantizer
    from qadc_tpu.quantizers.opq import OPQQuantizer

    with open(args.input, "rb") as f:
        obj = pickle.load(f, encoding="latin1")
    if args.kind == "pq":
        codebooks = np.asarray(obj, np.float32)  # (m, k, dsq)
        pq = ProductQuantizer(
            centroids=codebooks, sq_bits=int(np.log2(codebooks.shape[1]))
        ).validate()
    else:
        codebooks, rotation = obj
        codebooks = np.asarray(codebooks, np.float32)
        pq = OPQQuantizer(
            centroids=codebooks,
            sq_bits=int(np.log2(codebooks.shape[1])),
            rotation=np.asarray(rotation, np.float32),
        ).validate()
    save_quantizer_file(args.output, pq)


def build_parser():
    p = argparse.ArgumentParser(prog="qadc", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create-flat", help="create an empty flat index")
    c.add_argument("quantizer", nargs="?", help=".pq.data/.opq.data file")
    c.add_argument("index", help="output index directory")
    c.add_argument("--train", help="train a quantizer on this .fvecs instead")
    c.add_argument("--sq", default="16x4", help="sub-quantizers MxB (default 16x4)")
    c.add_argument("--opq", action="store_true", help="train OPQ instead of PQ")
    c.add_argument("--seed", type=int, default=0)
    c.set_defaults(fn=cmd_create_flat)

    c = sub.add_parser("create-index", help="create an IVF index (one step)")
    c.add_argument("learn", help="learning set .fvecs")
    c.add_argument("index", help="output index directory")
    c.add_argument("--parts", type=int, default=256, help="IVF cells (default 256)")
    c.add_argument("--balance-cap", type=float, default=3.0,
                   help="bound the largest cell at this multiple of the "
                   "mean (splits oversized cells; static-shape padding "
                   "control — 0 disables; default 3.0)")
    c.add_argument("--sq", default="16x4")
    c.add_argument("--opq", action="store_true")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--residuals-out", help="also write residuals as .fvecs "
                   "(external-training interop, reference indexdb_create1)")
    c.add_argument("--quantizer", help="use this pre-trained .pq.data/"
                   ".opq.data instead of training in-framework "
                   "(reference indexdb_create2)")
    c.set_defaults(fn=cmd_create_index)

    c = sub.add_parser(
        "set-quantizer",
        help="swap an externally trained .pq.data/.opq.data into an "
             "existing empty index (reference indexdb_create2)",
    )
    c.add_argument("index")
    c.add_argument("quantizer", help=".pq.data/.opq.data file")
    c.add_argument("--out", help="write to a new index path instead of in place")
    c.set_defaults(fn=cmd_set_quantizer)

    c = sub.add_parser("info", help="describe an index")
    c.add_argument("index")
    c.set_defaults(fn=cmd_info)

    c = sub.add_parser("add", help="add base vectors to an index")
    c.add_argument("index")
    c.add_argument("base", help="base .fvecs/.bvecs")
    c.add_argument("--chunk-size", type=int, default=1_000_000)
    c.set_defaults(fn=cmd_add)

    c = sub.add_parser("query", help="query an index, print CSV metrics")
    c.add_argument("index")
    c.add_argument("queries", help="query .fvecs")
    c.add_argument("groundtruth", help="groundtruth .ivecs")
    c.add_argument("-r", type=int, default=100, dest="r")
    c.add_argument("-m", "--ma", type=int, default=1)
    c.add_argument("-k", "--keep", type=float, default=1.0, help="keep in PERCENT")
    c.add_argument("-b", "--batch", type=int, default=32)
    c.add_argument("--adc-type", choices=["adc", "qadc"], default="qadc")
    c.add_argument("--no-rerank", action="store_true",
                   help="reference-style ranking by quantized distance")
    c.set_defaults(fn=cmd_query)

    c = sub.add_parser(
        "tune", help="measure + record kernel parameters for this geometry"
    )
    c.add_argument("index")
    c.add_argument("--queries", default=None, help="fvecs/bvecs sample (default: synthetic)")
    c.add_argument("--batch", type=int, default=32)
    c.add_argument("-r", type=int, default=100, dest="r")
    c.add_argument("--ma", type=int, default=24)
    c.add_argument("--keep", type=float, default=0.213, help="percent, as in query")
    c.set_defaults(fn=cmd_tune)

    c = sub.add_parser("split", help="extract a chunk of a vecs file")
    c.add_argument("chunk_id", type=int)
    c.add_argument("chunk_size", type=int)
    c.add_argument("input")
    c.add_argument("output")
    c.set_defaults(fn=cmd_split)

    c = sub.add_parser("convert-quantizer", help="pickle -> .pq.data/.opq.data")
    c.add_argument("kind", choices=["pq", "opq"])
    c.add_argument("input")
    c.add_argument("output")
    c.set_defaults(fn=cmd_convert_quantizer)
    return p


def main(argv=None):
    from qadc_tpu import compile_cache

    args = build_parser().parse_args(argv)
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
