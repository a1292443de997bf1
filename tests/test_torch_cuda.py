"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  On a machine with an H100 and nvcc::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer products must match bitwise; the k-means assignment within the
rule stated in `test_kmeans_assign_matches_plain`.  This file imports no
JAX, so it also runs where only the port's dependencies are installed.
"""
import numpy as np
import pytest
import torch

from repro_torch._common import u32_to_torch
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(rng, shape, dev):
    return u32_to_torch(rng.integers(0, 2**32, shape, dtype=np.uint32), dev)


@pytest.mark.parametrize("m,n,b", [
    (1, 1, 1), (100, 300, 1), (257, 513, 3), (31, 1025, 129),
    (128, 64, 64), (1000, 4096, 64),
])
@pytest.mark.parametrize("left", ["u8", "u32"])
def test_modmatmul_bitwise(cuda, m, n, b, left):
    rng = np.random.default_rng(m * 7 + n + b)
    if left == "u8":
        lhs = torch.from_numpy(rng.integers(0, 256, (m, n), dtype=np.uint8)
                               ).to(cuda)
    else:
        lhs = _u32(rng, (m, n), cuda)
    rhs = _u32(rng, (n, b), cuda)
    got = ops._matmul_u32(lhs, rhs, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ref.modmatmul_ref(lhs, rhs))


@pytest.mark.parametrize("left", ["u8", "u32"])
def test_modmatmul_wraparound(cuda, left):
    m, n, b = 300, 1100, 70
    lhs = (torch.full((m, n), 255, dtype=torch.uint8, device=cuda)
           if left == "u8" else
           torch.full((m, n), -1, dtype=torch.int32, device=cuda))
    rhs = torch.full((n, b), -1, dtype=torch.int32, device=cuda)
    got = ops._matmul_u32(lhs, rhs, "cuda")
    assert torch.equal(got, ref.modmatmul_ref(lhs, rhs))


def test_modmatmul_vector_and_counter(cuda):
    rng = np.random.default_rng(1)
    db = torch.from_numpy(rng.integers(0, 256, (77, 90), dtype=np.uint8)).to(cuda)
    q = _u32(rng, (90,), cuda)
    ops.reset_launch_counts()
    got = ops.modmatmul(db, q)
    assert got.shape == (77,)
    assert ops.launch_counts()["modmatmul_u8"] == 1
    assert torch.equal(got, ref.modmatmul_ref(db, q[:, None])[:, 0])


@pytest.mark.parametrize("n,k,d", [
    (256, 512, 64), (300, 700, 96), (64, 8, 32), (1000, 1024, 128),
    (129, 65, 768), (1, 1, 1),
])
def test_kmeans_assign_matches_plain(cuda, n, k, d):
    """min_d2 allclose(1e-5); assignments equal wherever the plain top-2
    gap exceeds 1e-5·(|x|² + |c|²)."""
    rng = np.random.default_rng(n + k + d)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)).to(cuda)
    got_a, got_d = ops.kmeans_assign(x, c, impl="cuda")
    want_a, want_d = ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
    full = (torch.sum(x * x, 1, keepdim=True) - 2.0 * (x @ c.T)
            + torch.sum(c * c, 1)[None, :])
    if k > 1:
        top2 = torch.topk(full, 2, dim=1, largest=False).values
        scale = torch.sum(x * x, 1) + torch.sum(c * c, 1)[want_a.long()]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * scale
    else:
        clear = torch.ones(n, dtype=torch.bool, device=cuda)
    assert torch.equal(got_a[clear], want_a[clear])


def test_kmeans_assign_earliest_tie(cuda):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((200, 8), dtype=np.float32)).to(cuda)
    c0 = torch.from_numpy(rng.standard_normal((40, 8), dtype=np.float32)).to(cuda)
    c = torch.cat([c0, c0, c0])              # exact duplicates across tiles
    got_a, _ = ops.kmeans_assign(x, c, impl="cuda")
    assert int(got_a.max()) < 40
    assert torch.equal(got_a, ops.kmeans_assign(x, c0, impl="cuda")[0])


def _u8(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("m,j,k", [
    (1, 1, 1), (100, 7, 33), (257, 51, 129), (31, 33, 1027),
    (1000, 256, 1024), (4099, 51, 1024),
])
def test_delta_gemm_bitwise(cuda, m, j, k):
    rng = np.random.default_rng(m + 3 * j + k)
    new, old, a_j = _u8(rng, (m, j), cuda), _u8(rng, (m, j), cuda), \
        _u32(rng, (j, k), cuda)
    ops.reset_launch_counts()
    got = ops.delta_gemm(new, old, a_j)
    torch.cuda.synchronize()
    assert ops.launch_counts()["delta_gemm"] == 1
    assert torch.equal(got, ref.delta_gemm_ref(new, old, a_j))


@pytest.mark.parametrize("new_val,old_val", [(255, 0), (0, 255)])
def test_delta_gemm_wraparound(cuda, new_val, old_val):
    m, j, k = 300, 70, 45
    new = torch.full((m, j), new_val, dtype=torch.uint8, device=cuda)
    old = torch.full((m, j), old_val, dtype=torch.uint8, device=cuda)
    a_j = torch.full((j, k), -1, dtype=torch.int32, device=cuda)
    got = ops.delta_gemm(new, old, a_j, impl="cuda")
    assert torch.equal(got, ref.delta_gemm_ref(new, old, a_j))


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_add_delta_bitwise(cuda, n, offset):
    """offset 1 starts both operands 4 bytes into their buffers, off the
    16-byte alignment the vector path needs."""
    rng = np.random.default_rng(n + offset)
    hint = _u32(rng, (n + offset,), cuda)[offset:]
    delta = _u32(rng, (n + offset,), cuda)[offset:]
    hint[0] = -1
    delta[0] = -1                                   # wraps
    want = ref.add_delta_ref(hint, delta)
    keep = hint.clone()
    ops.reset_launch_counts()
    got = ops.add_delta(hint, delta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["add_delta"] == 1
    assert got.data_ptr() == delta.data_ptr()
    assert torch.equal(got, want) and torch.equal(hint, keep)


@pytest.mark.parametrize("donate", [False, True])
def test_scatter_columns_on_the_card(cuda, donate):
    rng = np.random.default_rng(4)
    db = _u8(rng, (513, 40), cuda)
    before = db.clone()
    cols = torch.tensor([0, 7, 8, 39], device=cuda)
    new = _u8(rng, (513, 4), cuda)
    got = ops.scatter_columns(db, cols, new, donate=donate)
    want = before.clone()
    want[:, cols] = new
    assert torch.equal(got, want)
    assert torch.equal(db, want if donate else before)


def test_live_commit_on_the_card(cuda):
    """A small live index on the card: each delta epoch launches the
    delta-hint and add kernels, and its patched hint equals setup()."""
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.update import HintCache, LiveIndex
    corp = corpus_lib.make_corpus(0, 400, emb_dim=16, n_topics=6)
    live = LiveIndex.build(corp.texts, corp.embeddings, n_clusters=6,
                           kmeans_iters=5, device=cuda)
    cache = HintCache(live.system.hint, live.system.cfg)
    cents = live.system.centroids
    for step in range(3):
        ops.reset_launch_counts()
        # a replace at its own cluster's centroid with a shorter text, an
        # insert at the centroid of a column with room, and a delete: no
        # column can overflow, so the epoch is a delta
        live.replace(step, b"rev", cents[live._cluster_of[step]])
        room = [j for j in range(len(cents))
                if live.system.db.m - live._used[j] >= 16 + 16 + 3]
        live.insert(9000 + step, b"new", cents[room[step % len(room)]])
        live.delete(200 + step)
        assert not live.commit().is_full
        counts = ops.launch_counts()
        assert counts["delta_gemm"] == 1 and counts["add_delta"] == 1
        assert torch.equal(live.system.server.setup(), live.system.hint)
        assert np.array_equal(live.system.server.db.cpu().numpy(),
                              live.system.db.matrix)
        cache.sync(live.epochs)
        assert torch.equal(cache.hint, live.system.hint)


@pytest.mark.parametrize("heights,w,c", [
    ((1,), 1, 1), ((64, 1, 96), 32, 1), ((128, 256), 64, 3),
    ((300, 1, 129, 257), 7, 16), ((5, 0, 1000), 256, 17),
    ((4099, 2000, 130), 256, 64), ((1, 2, 3), 33, 65),
])
def test_bucketed_modmatmul_bitwise(cuda, heights, w, c):
    """Ragged heights (a bucket of 1 row, an empty one), W off the tile and
    off a multiple of 4, C = 1 and C > 16: one launch, bitwise."""
    rng = np.random.default_rng(sum(heights) + w + c)
    dbs = [_u8(rng, (m, w), cuda) for m in heights]
    qs = _u32(rng, (len(heights), w, c), cuda)
    ops.reset_launch_counts()
    got = ops.bucketed_modmatmul(dbs, qs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bucketed_modmatmul"] == 1
    for g, want in zip(got, ref.bucketed_modmatmul_ref(dbs, qs)):
        assert torch.equal(g, want)


def test_bucketed_modmatmul_wraparound_and_vector(cuda):
    dbs = [torch.full((m, 300), 255, dtype=torch.uint8, device=cuda)
           for m in (129, 3)]
    qs = torch.full((2, 300, 5), -1, dtype=torch.int32, device=cuda)
    for g, want in zip(ops.bucketed_modmatmul(dbs, qs, impl="cuda"),
                       ref.bucketed_modmatmul_ref(dbs, qs)):
        assert torch.equal(g, want)
    got = ops.bucketed_modmatmul(dbs, qs[:, :, 0], impl="cuda")
    assert [tuple(g.shape) for g in got] == [(129,), (3,)]
    assert torch.equal(got[1], ref.modmatmul_ref(dbs[1], qs[1, :, :1])[:, 0])


def test_dropped_live_index_frees_card_memory_without_gc(cuda):
    """A LiveIndex holds no reference cycle: deleting it returns its card
    tensors at once, with the cycle collector off."""
    import gc

    from repro_torch.data import corpus as corpus_lib
    from repro_torch.update import LiveIndex
    corp = corpus_lib.make_corpus(1, 400, emb_dim=16, n_topics=6)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gc.disable()
    try:
        live = LiveIndex.build(corp.texts, corp.embeddings, n_clusters=6,
                               kmeans_iters=5, device=cuda)
        live.replace(0, b"rev", corp.embeddings[0])
        live.commit()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        assert held > base
        del live
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
    finally:
        gc.enable()
