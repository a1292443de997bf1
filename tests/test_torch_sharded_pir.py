"""The port's sharded PIR path against its own unsharded path, bitwise.

Every case builds the same corpus twice, once on one device and once
row-sharded over a `launch.mesh.DeviceMesh` of S shards (``["cpu"] * S``
here), and holds the two equal bit for bit: clustering, row shards, hint,
answers, decoded columns, top-k, live patches (delta and full rebuild),
shadow commits, batch-PIR buckets and their patches, keyed lookups, and the
serve CLI's responses.  Rows pad to a multiple of S (chunk size 90, so S = 4
pads), and the pad rows must stay zero.

The file imports no JAX: its one ``cuda`` case (a 2-shard build on the card)
runs where only the port is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_pir.py
"""
import collections
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch._common import u32_to_torch
from repro_torch.batchpir.partition import CuckooPartition
from repro_torch.batchpir.server import BatchPIRServer, bucket_rows
from repro_torch.core import pipeline, pir
from repro_torch.data import corpus
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve.epochs import ShadowCommitter
from repro_torch.update import LiveIndex, journal

SHARDS = (1, 2, 4)
BUILD = dict(n_clusters=8, kmeans_iters=4, chunk_size=90)


@pytest.fixture(scope="module")
def corp():
    return corpus.make_corpus(0, 160, emb_dim=8, n_topics=8)


def _mesh(shards):
    return make_local_mesh(shards, devices=["cpu"] * shards)


def _build(corp, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                       mesh=mesh, **BUILD, **kw)


def _live(corp, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return LiveIndex.build(corp.texts, corp.embeddings, mesh=mesh, **BUILD,
                           **kw)


@pytest.fixture(scope="module")
def base(corp):
    return _build(corp)


def _db_equal(sharded, flat):
    """The row shards hold ``flat``'s rows in order and zero pad rows."""
    m = flat.shape[0]
    full = torch.cat(sharded)
    assert torch.equal(full[:m], flat)
    assert not full[m:].any()


def _ids(tops):
    return [[(d, t) for d, _, t in top] for top in tops]


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_build_equals_unsharded(corp, base, shards):
    sys_s = _build(corp, _mesh(shards))
    np.testing.assert_array_equal(sys_s.centroids, base.centroids)
    np.testing.assert_array_equal(sys_s.assignment, base.assignment)
    np.testing.assert_array_equal(sys_s.db.matrix, base.db.matrix)
    assert len(sys_s.server.db) == shards
    assert sys_s.server._row_pad == (-base.db.m) % shards
    rows = (base.db.m + sys_s.server._row_pad) // shards
    assert all(tuple(d.shape) == (rows, base.db.n) for d in sys_s.server.db)
    _db_equal(sys_s.server.db, base.server.db)
    if shards > 1:
        for host, dev in zip(sys_s.db.row_shards, sys_s.server.db):
            np.testing.assert_array_equal(host, dev.numpy())
    assert torch.equal(sys_s.hint, base.hint)
    assert sys_s.device == torch.device("cpu")
    assert sys_s.mesh is not None and len(sys_s.mesh.devices) == shards


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_answers_decoded_columns_and_topk(corp, base, shards):
    sys_s = _build(corp, _mesh(shards))
    client = pir.PIRClient(base.cfg, base.hint)
    gen = torch.Generator().manual_seed(3)
    qs, secrets = client.query_batch(gen, [0, 3, 7, 3])
    ans = base.server.answer(qs)
    ans_s = sys_s.server.answer(qs)
    assert torch.equal(ans_s, ans)
    assert torch.equal(sys_s.server.answer(qs[:, 1]), ans[:, 1])
    cols = client.recover_batch(ans_s, secrets)
    assert torch.equal(cols, client.recover_batch(ans, secrets))
    np.testing.assert_array_equal(cols[:, 0].numpy(), base.db.matrix[:, 0])
    queries = corp.embeddings[[5, 50, 150, 159]]
    for probes in (1, 2):
        want = base.query_batch(queries, top_k=5, multi_probe=probes,
                                generator=torch.Generator().manual_seed(9))
        got = sys_s.query_batch(queries, top_k=5, multi_probe=probes,
                                generator=torch.Generator().manual_seed(9))
        assert _ids(got) == _ids(want)
    top, stats = sys_s.query(queries[0], top_k=5,
                             generator=torch.Generator().manual_seed(1))
    want, wstats = base.query(queries[0], top_k=5,
                              generator=torch.Generator().manual_seed(1))
    assert _ids([top]) == _ids([want])
    assert stats.downlink_bytes == wstats.downlink_bytes


@pytest.mark.parametrize("shards", SHARDS)
def test_stage_delta_and_scatter_per_shard(corp, base, shards):
    sys_s = _build(corp, _mesh(shards))
    rng = np.random.default_rng(shards)
    cols = torch.tensor([1, 6, 2])
    new = torch.from_numpy(rng.integers(0, 256, (base.db.m, 3),
                                        dtype=np.uint8))
    assert torch.equal(sys_s.server.stage_delta(cols, new),
                       base.server.stage_delta(cols, new))
    want = base.server.stage_scatter(cols, new)
    before = [d.clone() for d in sys_s.server.db]
    staged = sys_s.server.stage_scatter(cols, new)
    _db_equal(staged, want)
    for d, b in zip(sys_s.server.db, before):      # the live DB untouched
        assert torch.equal(d, b)
    donated = sys_s.server.stage_scatter(cols, new, donate=True)
    assert all(a is b for a, b in zip(donated, sys_s.server.db))
    _db_equal(sys_s.server.db, want)
    np.testing.assert_array_equal(sys_s.server.columns(cols, 7),
                                  want[:7, cols].numpy())
    with pytest.raises(ValueError, match="new_cols"):
        sys_s.server.stage_delta(cols, new[:-1])


def _mutate(live, corp):
    live.replace(5, b"rewritten five", corp.embeddings[5])
    live.delete(23)
    live.insert(10_000, b"brand new doc", corp.embeddings[50])


def _same_live(a, b):
    assert a.epoch == b.epoch
    assert torch.equal(a.system.hint, b.system.hint)
    _db_equal(b.system.server.db, a.system.server.db)
    np.testing.assert_array_equal(a.system.db.matrix, b.system.db.matrix)
    assert torch.equal(b.system.server.setup(), b.system.hint)


@pytest.mark.parametrize("shards", SHARDS)
def test_live_delta_commit_and_sharded_full_rebuild(corp, shards):
    a, b = _live(corp), _live(corp, _mesh(shards))
    for live in (a, b):
        _mutate(live, corp)
    pa, pb = a.commit(), b.commit()
    assert not pb.is_full
    np.testing.assert_array_equal(pb.cols, pa.cols)
    np.testing.assert_array_equal(pb.delta, pa.delta)
    _same_live(a, b)
    # host row shards alias the mirror, so the patch shows through them
    if shards > 1:
        np.testing.assert_array_equal(
            np.concatenate(b.system.db.row_shards)[:b.system.db.m],
            b.system.db.matrix)
    for live in (a, b):               # overflows a column: full rebuild
        live.insert(20_000, b"z" * (2 * a.system.db.m), corp.embeddings[9])
    pa, pb = a.commit(), b.commit()
    assert pa.is_full and pb.is_full
    assert b.system.mesh is not None and len(b.system.server.db) == shards
    np.testing.assert_array_equal(pb.full_hint, pa.full_hint)
    _same_live(a, b)
    q = corp.embeddings[[9, 77]]
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    assert _ids(b.query_batch(q, epoch=b.epoch, top_k=3,
                              generator=gens[0])) == \
        _ids(a.query_batch(q, epoch=a.epoch, top_k=3, generator=gens[1]))


@pytest.mark.parametrize("shards", SHARDS)
def test_shadow_committer_publishes_per_shard_buffers(corp, shards):
    a, b = _live(corp), _live(corp, _mesh(shards))
    shards_before = list(b.system.server.db)
    for live in (a, b):
        muts = collections.deque([
            journal.replace(11, b"again", corp.embeddings[11]),
            journal.insert(30_000, b"one more", corp.embeddings[70])])
        assert ShadowCommitter(live).commit(muts) is not None
    _same_live(a, b)
    # donated: the live shard tensors were written in place
    assert all(x is y for x, y in zip(shards_before, b.system.server.db))


@pytest.mark.parametrize("shards", SHARDS)
def test_batch_pir_buckets_answers_and_patches(corp, shards):
    a, b = _live(corp), _live(corp, _mesh(shards))
    for live in (a, b):
        live.system.enable_batch(kappa=2, seed=5)
    sa, sb = a.system.batch.server, b.system.batch.server
    heights = [d.shape[0] for d in sa.sub_dbs]
    order = collectives.balanced_bucket_order(heights, shards)
    per = len(order) // shards
    for slot, bucket in enumerate(order):
        if bucket < len(heights):
            assert sb.shard_of[bucket] == slot // per
    for x, y in zip(sa.sub_dbs, sb.sub_dbs):
        assert torch.equal(x, y)
    for x, y in zip(sa.hints, sb.hints):
        assert torch.equal(x, y)
    rng = np.random.default_rng(8)
    qs = u32_to_torch(rng.integers(0, 2**32, (len(heights), sa.partition.width,
                                              3), dtype=np.uint32), "cpu")
    for x, y in zip(sa.answer_batch(qs), sb.answer_batch(qs)):
        assert torch.equal(x, y)
    one = qs[:, :, 0]
    for x, y in zip(sa.answer_batch(one), sb.answer_batch(one)):
        assert torch.equal(x, y)
    queries = corp.embeddings[[1, 100, 140]]
    want = a.system.query_batch(queries, top_k=3, multi_probe=2,
                                generator=torch.Generator().manual_seed(2))
    got = b.system.query_batch(queries, top_k=3, multi_probe=2,
                               generator=torch.Generator().manual_seed(2))
    assert _ids(got) == _ids(want)
    for text in (b"short", b"y" * 3000):        # a delta, then an overflow
        for live in (a, b):
            live.replace(20, text, corp.embeddings[20])
            live.commit()
        for x, y in zip(a.system.batch.server.sub_dbs,
                        b.system.batch.server.sub_dbs):
            assert torch.equal(x, y)
        for x, y in zip(a.system.batch.server.hints,
                        b.system.batch.server.hints):
            assert torch.equal(x, y)
        assert all(torch.equal(x, y) for x, y in zip(
            b.system.batch.server.setup(), b.system.batch.server.hints))


@pytest.mark.parametrize("shards", (2, 4))
def test_sharded_bucket_server_from_the_host_mirror(corp, base, shards):
    """The sharded constructor `enable_batch` uses (sub-DBs gathered from
    the host mirror onto their owners) against the unsharded one (gathered
    from the served DB): the same sub-DBs, hints and answers."""
    part = CuckooPartition.build(base.db.n, 6, 3)
    flat = BatchPIRServer(base.server.db, base.db.used_bytes, part,
                          base.cfg.params)
    mesh = _mesh(shards)
    sharded = BatchPIRServer(torch.from_numpy(base.db.matrix),
                             base.db.used_bytes, part, base.cfg.params,
                             mesh=mesh)
    heights = bucket_rows(part, base.db.used_bytes, base.db.m)
    order = collectives.balanced_bucket_order(heights, shards)
    loads = collectives.shard_row_loads(heights, shards, order)
    assert loads.sum() == sum(heights)
    assert [sum(heights[b] for b in range(len(heights))
                if sharded.shard_of[b] == s) for s in range(shards)] == \
        loads.tolist()
    for x, y in zip(flat.sub_dbs, sharded.sub_dbs):
        assert torch.equal(x, y)
    for x, y in zip(flat.setup(), sharded.setup()):
        assert torch.equal(x, y)
    qs = u32_to_torch(np.random.default_rng(0).integers(
        0, 2**32, (6, part.width), dtype=np.uint32), "cpu")
    for x, y in zip(sharded.answer_batch(qs), flat.answer_batch(qs)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shards", SHARDS)
def test_keyed_lookups_on_a_sharded_index(shards):
    table = np.random.default_rng(4).standard_normal((96, 6)).astype(
        np.float32)
    kw = dict(kappa=2, chunk_size=90)
    a = LiveIndex.build_keyed(table, device="cpu", **kw)
    b = LiveIndex.build_keyed(table, mesh=_mesh(shards), **kw)
    assert torch.equal(a.system.hint, b.system.hint)
    _db_equal(b.system.server.db, a.system.server.db)
    ids = [3, 95, 3, 40]
    rows, stats = b.lookup(ids, epoch=0,
                           generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(rows, table[ids])
    assert stats.mode == "batch"
    got = b.lookup_batch([[1, 2], [90]], epoch=0,
                         generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(got[0], table[[1, 2]])
    new_row = np.full(6, 0.5, np.float32)
    for live in (a, b):
        live.replace_row(40, new_row)
        live.commit()
    _same_live(a, b)
    rows, _ = b.lookup([40, 41], epoch=1,
                       generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(rows[0], new_row)
    np.testing.assert_array_equal(rows[1], table[41])


def test_mesh_placement_axes_and_no_card():
    mesh = _mesh(3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.home == torch.device("cpu")
    assert "3 shards" in str(mesh) and "shards share a device" in str(mesh)
    with pytest.raises(ValueError):
        make_local_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_local_mesh(0, devices=[])


def test_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the no-card errors cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh(2)
    with pytest.raises(RuntimeError, match="device"):
        pipeline.PirRagSystem.build([b"x"] * 4, np.zeros((4, 8), np.float32),
                                    n_clusters=2, mesh=_mesh(2),
                                    device="cuda")


def test_serve_cli_shard_prints_the_unsharded_top_k():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--docs", "160",
           "--requests", "8", "--max-batch", "4", "--device", "cpu"]
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    outs = [subprocess.run(cmd + extra, capture_output=True, text=True,
                           timeout=300, env=env)
            for extra in ([], ["--shard", "2"])]
    for out in outs:
        assert out.returncode == 0, out.stderr[-2000:]

    def tops(out):
        return next(ln for ln in out.stdout.splitlines()
                    if ln.startswith("top-k ids by request:"))

    assert "shards share a device" in outs[1].stdout
    assert tops(outs[1]) == tops(outs[0])
    assert "null" not in tops(outs[0])
    lost = subprocess.run(cmd + ["--shard-loss", "1:0:2"],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert lost.returncode != 0
    assert "not ported yet: ROADMAP queue 1 item 5" in lost.stderr


@pytest.mark.cuda
def test_two_shard_build_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corp_ = corpus.make_corpus(0, 2000, emb_dim=32, n_topics=16)
    kw = dict(n_clusters=16, kmeans_iters=5)
    mesh = make_local_mesh(2)
    cards = torch.cuda.device_count()
    assert mesh.devices == tuple(torch.device("cuda", s % cards)
                                 for s in range(2))
    flat = pipeline.PirRagSystem.build(corp_.texts, corp_.embeddings, **kw)
    sharded = pipeline.PirRagSystem.build(corp_.texts, corp_.embeddings,
                                          mesh=mesh, **kw)
    np.testing.assert_array_equal(sharded.assignment, flat.assignment)
    _db_equal(sharded.server.db, flat.server.db)
    assert torch.equal(sharded.hint, flat.hint)
    queries = corp_.embeddings[:8]
    assert _ids(sharded.query_batch(
        queries, top_k=5, generator=torch.Generator("cuda").manual_seed(1))
    ) == _ids(flat.query_batch(
        queries, top_k=5, generator=torch.Generator("cuda").manual_seed(1)))


def test_chip_smoke_phase_m_and_p_sharded_rehearse():
    """`chip_smoke.py`'s phase M, its timing line and P sharded at the
    rehearsal size (two CPU shards) through the plain versions: every
    equality gate passes and each prints its line."""
    import pathlib
    import runpy
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    cs = runpy.run_path(str(path), run_name="chip_smoke")
    card, cfg = cs["Card"](True), cs["TINY"]
    assert cfg["m_shards"] == 2 and "M" in cs["PATH_KERNELS"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system, corp_, queries, _ = cs["phase_b"](card, cfg)
        m_sys, live, line, counts = cs["phase_m"](card, cfg, system, corp_,
                                                  queries)
        timing = cs["m_timing"](card, cfg, system, m_sys, queries)
        system.enable_batch(kappa=cfg["p_kappa"], seed=cs["P_SEED"])
        sharded = cs["p_sharded"](card, cfg, LiveIndex(
            system, corp_.texts, corp_.embeddings))
    finally:
        torch.set_num_threads(threads)
    assert line["phase"] == "M" and line["shards"] == 2
    for key in ("clustering_equal_b", "row_shards_equal_b", "hint_equal_b",
                "answers_equal_b", "columns_equal_b", "topk_equal_b",
                "patched_hint_equal_b_stage", "patched_db_equal_b_stage",
                "patched_hint_equals_setup"):
        assert line[key] is True, key
    assert line["commit_J"] >= 1 and "shards share a device" in line["mesh"]
    assert set(cs["PATH_KERNELS"]["M"]) <= set(counts)
    assert timing["phase"] == "timing M"
    assert timing["shard0_answer_max_abs_err"] == 0
    for op in ("answer", "hint", "delta"):
        assert timing[f"{op}_shard_bound_ms"] > 0
    assert sharded["answers_equal_unsharded"]
    assert sharded["sub_dbs_equal_unsharded"]
    assert sharded["hint_equal_unsharded"]
    assert sorted(set(sharded["owner"])) == [0, 1]
    assert sum(sharded["lpt_rows"]) == sum(sharded["sequential_rows"])
