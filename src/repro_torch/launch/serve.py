"""Thin CLI over the port's serving engines (twin of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 2000 \
        --requests 64 --engine pipelined --mutate-every 8

Runs on the card unless ``--device cpu`` is given, and raises without one.
`--engine sync` serves through the blocking loop; `pipelined` (default)
overlaps batch N's products with completing batch N−depth and encoding
batch N+1, and commits mutations by shadow stage and publish.  Responses
are the same either way: only the timeline changes.  ``--shard N`` builds
and serves the index row-sharded over N shards (`launch.mesh.
make_local_mesh`: shard s on card s mod the card count, or N shards on the
CPU with ``--device cpu``); the responses are the unsharded run's.  The
run prints each request's top-k doc ids.  The fleet engine, shard-loss
injection and the generation stage are not ported yet: their flags exit
with an error naming the roadmap item that brings them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.serve.engine import PIRServeLoop, PipelinedServeLoop

#: flags of the JAX twin this port does not serve yet → the roadmap item
NOT_PORTED = {
    "engine fleet": "ROADMAP queue 1 item 5 (replica groups and recovery)",
    "shard-loss": "ROADMAP queue 1 item 5 (replica groups and recovery)",
    "generate": "ROADMAP queue 1 item 3 (the generation stage)",
    "gen-coalesce": "ROADMAP queue 1 item 3 (the generation stage)",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=50.0)
    ap.add_argument("--engine", choices=("sync", "pipelined", "fleet"),
                    default="pipelined",
                    help="blocking loop vs plan/dispatch/complete pipeline "
                         "(same responses); `fleet` is not ported yet")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipelined engine: max batches in flight")
    ap.add_argument("--mutate-every", type=int, default=0,
                    help="if >0, replace a random doc every N requests "
                         "(exercises the live-index delta path)")
    ap.add_argument("--multi-probe", type=int, default=1,
                    help="clusters fetched per query; >1 routes through "
                         "the batch-PIR subsystem (one bucketed pass)")
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                         "without a card)")
    ap.add_argument("--shard", type=int, default=0,
                    help="row-shard the index over this many shards (0 or "
                         "1: unsharded); on --device cpu they share the CPU")
    ap.add_argument("--shard-loss", metavar="TICK:DEV:TICKS", default=None,
                    help="the JAX twin's shard-loss injection (fleet "
                         "engine); not ported yet")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="export a Chrome trace of the run's spans")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry as JSON after the run")
    # the JAX twin's generation flags, not served yet (see NOT_PORTED)
    ap.add_argument("--generate", type=int, metavar="N", default=0)
    ap.add_argument("--gen-coalesce", type=int, default=None)
    args = ap.parse_args(argv)
    asked = {"engine fleet": args.engine == "fleet",
             "shard-loss": args.shard_loss is not None,
             "generate": args.generate > 0,
             "gen-coalesce": args.gen_coalesce is not None}
    for flag, on in asked.items():
        if on:
            ap.error(f"--{flag} is not ported yet: {NOT_PORTED[flag]}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.core import pipeline
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.obs import Obs
    from repro_torch.update import LiveIndex, journal

    build_kw = dict(n_clusters=24, device=args.device)
    if args.shard > 1:
        on_cpu = torch.device(args.device).type == "cpu"
        mesh = make_local_mesh(
            args.shard, devices=[args.device] * args.shard if on_cpu
            else None)
        print(mesh)
        build_kw["mesh"] = mesh

    corp = corpus_lib.make_corpus(0, args.docs, emb_dim=64, n_topics=24)
    rng = np.random.default_rng(0)
    loop_cls = (PipelinedServeLoop if args.engine == "pipelined"
                else PIRServeLoop)
    obs = Obs(trace=args.trace is not None)
    loop_kw = dict(max_batch=args.max_batch, deadline_ms=args.deadline_ms,
                   obs=obs)
    if args.engine == "pipelined":
        loop_kw["depth"] = args.depth
    live = None
    if args.mutate_every > 0:
        live = LiveIndex.build(corp.texts, corp.embeddings, **build_kw)
        loop = loop_cls(live, **loop_kw)
    else:
        system = pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                             **build_kw)
        loop = loop_cls(system, **loop_kw)
    if args.multi_probe > 1:
        loop.system.enable_batch(kappa=max(4, args.multi_probe))

    t0 = time.perf_counter()
    for rid in range(args.requests):
        q = corp.embeddings[rng.integers(0, args.docs)]
        loop.submit(rid, q, top_k=args.top_k, multi_probe=args.multi_probe)
        if live is not None and rid % args.mutate_every == 0:
            d = int(rng.integers(0, args.docs))
            loop.submit_mutation(journal.replace(
                d, f"refreshed doc {d}".encode(), corp.embeddings[d]))
        loop.tick()
    loop.drain()
    dt = time.perf_counter() - t0
    if not loop.responses:
        print(f"served 0 requests in {dt:.2f}s")
        return 0
    lat = [r.t_done - t0 for r in loop.responses]
    sizes = [r.batch_size for r in loop.responses]
    print(f"[{args.engine}] served {len(loop.responses)} requests "
          f"in {dt:.2f}s on {args.device}; mean batch {np.mean(sizes):.1f}; "
          f"p50/p99 completion {np.percentile(lat, 50):.2f}/"
          f"{np.percentile(lat, 99):.2f}s"
          + (f"; epoch {loop.epoch}; stale retries {loop.stale_retries}"
             if live is not None else ""))
    tops = {r.rid: [int(d) for d, _, _ in r.top] for r in loop.responses}
    print("top-k ids by request:",
          json.dumps([tops.get(rid) for rid in range(args.requests)]))
    if args.trace is not None:
        from repro_torch.obs import span_coverage
        obs.export_chrome(args.trace)
        cov = span_coverage(obs.tracer.spans)
        print(f"trace: {len(obs.tracer.spans)} spans + "
              f"{len(obs.tracer.instants)} instants -> {args.trace} "
              f"(root-span coverage {cov:.1%})")
    if args.metrics:
        print(json.dumps(obs.metrics_dict(), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
