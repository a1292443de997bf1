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
    _kmeans_rule(x, c, got_a, got_d)


def _kmeans_rule(x, c, got_a, got_d):
    """The plain version's rule: min_d2 allclose(1e-5); assignments equal
    wherever the plain top-2 gap exceeds 1e-5·(|x|² + |c|²)."""
    want_a, want_d = ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
    if c.shape[0] == 1:
        assert torch.equal(got_a, want_a)
        return
    full = (torch.sum(x * x, 1, keepdim=True) - 2.0 * (x @ c.T)
            + torch.sum(c * c, 1)[None, :])
    top2 = torch.topk(full, 2, dim=1, largest=False).values
    scale = torch.sum(x * x, 1) + torch.sum(c * c, 1)[want_a.long()]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * scale
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


# the u8 limb kernel: widths on the main path take the TMA producer
_TMA_WIDTHS = (128, 256, 1024, 4096)


@pytest.mark.parametrize("m,n,b", [
    (1, 1, 1), (129, 300, 3), (1000, 513, 63), (257, 1024, 16),
    (1000, 4096, 64), (300, 1024, 65), (129, 128, 257), (1, 256, 1024),
    (4099, 1100, 9), (64, 4096, 33), (200, 2064, 8),
])
def test_modmatmul_u8_limb_kernel_bitwise(cuda, m, n, b):
    """Ragged n (the predicated producer), main-path n (TMA), every stacked
    width N = 32, 64, 128, 256 and b off the tile: one launch, bitwise."""
    from repro_torch.kernels import modmatmul
    rng = np.random.default_rng(m + 5 * n + b)
    db = _u8(rng, (m, n), cuda)
    q = _u32(rng, (n, b), cuda)
    ops.reset_launch_counts()
    got, _ = modmatmul.limb_product(db, q)
    torch.cuda.synchronize()
    assert ops.launch_counts()["modmatmul_u8"] == 1
    want = ("tma" if n % 16 == 0 else "predicated")
    assert modmatmul.u8_producer(db) == want
    if n in _TMA_WIDTHS:
        assert want == "tma"
    assert torch.equal(got, ref.modmatmul_ref(db, q))


@pytest.mark.parametrize("n", [33_100, 33_280])
def test_modmatmul_u8_limb_sums_past_two_to_the_31(cuda, n):
    """All-255 D and all-0xFFFFFFFF R: each limb sum over n is 255·255·n >
    2^31, so the kernel's contraction chunks must carry it (both producers)."""
    db = torch.full((64, n), 255, dtype=torch.uint8, device=cuda)
    q = torch.full((n, 8), -1, dtype=torch.int32, device=cuda)
    got = ops.modmatmul(db, q, impl="cuda")
    assert torch.equal(got, ref.modmatmul_ref(db, q))


@pytest.mark.parametrize("n,b", [(1, 1), (300, 3), (513, 63), (1024, 16),
                                 (4096, 65), (128, 1024)])
def test_modmatmul_u8_prep_planes_match_ref_limb_planes(cuda, n, b):
    """The prep kernel's stacked, transposed limb planes equal
    `ref.limb_planes`, padding rows and columns included."""
    from repro_torch.kernels import modmatmul
    rng = np.random.default_rng(n + b)
    db = _u8(rng, (3, n), cuda)
    q = _u32(rng, (n, b), cuda)
    _, planes = modmatmul.limb_product(db, q)
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.limb_planes(q))


@pytest.mark.parametrize("n", [(1 << 20) + 1, (1 << 20) + 2, (1 << 20) + 3])
def test_add_delta_vector_tail(cuda, n):
    """4k+1, 4k+2 and 4k+3 words: the vector pass leaves 1-3 tail words."""
    rng = np.random.default_rng(n)
    hint, delta = _u32(rng, (n,), cuda), _u32(rng, (n,), cuda)
    delta[-1] = -1
    hint[-1] = -1                                   # the last word wraps
    want = ref.add_delta_ref(hint, delta)
    got = ops.add_delta(hint, delta, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the u32 x u32 product on the limb tile: H read as bytes, R's shift planes
@pytest.mark.parametrize("m,k,b", [
    (1, 1, 1), (257, 3, 9), (1000, 1024, 1), (1000, 1024, 64),
    (4099, 1025, 63), (129, 256, 65), (300, 1024, 257), (64, 8193, 3),
])
def test_modmatmul_u32_shift_kernel_bitwise(cuda, m, k, b):
    """b = 1 and b = 64 at the LWE width (TMA), 4k off 16 bytes (the
    predicated producer), every stacked width, k past one 32,768-byte
    contraction chunk: one launch, bitwise."""
    from repro_torch.kernels import modmatmul
    rng = np.random.default_rng(m + 3 * k + b)
    h = _u32(rng, (m, k), cuda)
    s = _u32(rng, (k, b), cuda)
    ops.reset_launch_counts()
    got, _ = modmatmul.shift_product(h, s)
    torch.cuda.synchronize()
    assert ops.launch_counts()["modmatmul_u32"] == 1
    assert ops.launch_counts()["modmatmul_u8"] == 0
    assert modmatmul.u8_producer(h) == ("tma" if k % 4 == 0 else "predicated")
    assert torch.equal(got, ref.modmatmul_ref(h, s))


@pytest.mark.parametrize("k,b", [(1, 1), (3, 9), (1024, 1), (1024, 64),
                                 (1025, 65), (256, 1024)])
def test_modmatmul_u32_prep_planes_match_ref_shift_planes(cuda, k, b):
    """The prep kernel's shift planes equal `ref.shift_planes`, padding rows
    and columns included."""
    from repro_torch.kernels import modmatmul
    rng = np.random.default_rng(k + b)
    s = _u32(rng, (k, b), cuda)
    _, planes = modmatmul.shift_product(_u32(rng, (3, k), cuda), s)
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.shift_planes(s))


def test_modmatmul_u32_row_slice_off_alignment(cuda):
    """A contiguous view 4 bytes into its buffer: the row stride 4k is a
    multiple of 16 but the base is not 16-byte aligned, so the predicated
    producer reads H; bitwise, and so is an all-0xFFFFFFFF wraparound."""
    from repro_torch.kernels import modmatmul
    rng = np.random.default_rng(9)
    m, k = 1000, 1024
    h = _u32(rng, (m * k + 1,), cuda)[1:].view(m, k)
    s = _u32(rng, (k, 16), cuda)
    assert modmatmul.u8_producer(h) == "predicated"
    assert torch.equal(ops.mod_u32_matmul(h, s, impl="cuda"),
                       ref.modmatmul_ref(h, s))
    ones = torch.full((300, 8193), -1, dtype=torch.int32, device=cuda)
    allf = torch.full((8193, 5), -1, dtype=torch.int32, device=cuda)
    assert torch.equal(ops.mod_u32_matmul(ones, allf, impl="cuda"),
                       ref.modmatmul_ref(ones, allf))


@pytest.mark.parametrize("n,k,d", [
    (1000, 1000, 128), (129, 257, 64), (127, 129, 33), (257, 130, 384),
    (300, 200, 385), (300, 200, 768), (5000, 1, 128),
])
def test_kmeans_assign_tiles_and_feature_chunks(cuda, n, k, d):
    """N and K off the 128-point and 128-centroid tiles, d off 4 (scalar
    point loads), d = 384 (the last resident width) and d = 385, 768 (the
    feature axis walked in chunks): one launch, the plain version's rule."""
    rng = np.random.default_rng(n + 2 * k + d)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)).to(cuda)
    ops.reset_launch_counts()
    got_a, got_d = ops.kmeans_assign(x, c, impl="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["kmeans_assign"] == 1
    _kmeans_rule(x, c, got_a, got_d)


@pytest.mark.parametrize("d", [16, 768])
def test_kmeans_assign_ties_across_centroid_tiles(cuda, d):
    """Three exact copies of 100 centroids: copies sit in the same tile, in
    the next tile and across the 16 threads of a point; every point must
    take the first copy, with the same distance as against the originals."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((1000, d), dtype=np.float32)).to(cuda)
    c0 = torch.from_numpy(rng.standard_normal((100, d), dtype=np.float32)).to(cuda)
    got_a, got_d = ops.kmeans_assign(x, torch.cat([c0, c0, c0]), impl="cuda")
    want_a, want_d = ops.kmeans_assign(x, c0, impl="cuda")
    assert int(got_a.max()) < 100
    assert torch.equal(got_a, want_a) and torch.equal(got_d, want_d)


# delta_gemm on the limb tile: [new | old] . [A_J ; -A_J], packed or read in
# place by two tensor maps
@pytest.mark.parametrize("m,j,k,pack", [
    (9, 1, 70, True), (130, 51, 1024, True), (130, 64, 1024, True),
    (130, 64, 1024, False), (130, 65, 70, True), (257, 256, 1024, True),
    (257, 256, 1024, False), (3, 16_400, 5, True), (3, 16_400, 5, False),
])
def test_delta_gemm_limb_tile_bitwise(cuda, m, j, k, pack):
    """J off and on 16 and past one 128-byte stage, 2J past one 32,768-byte
    contraction chunk, both layouts of the left operand (two maps only
    where J % 16 == 0): one launch, bitwise against the plain version and
    the int64 emulation."""
    from repro_torch.kernels import delta_gemm
    rng = np.random.default_rng(m + 3 * j + k)
    new, old, a_j = _u8(rng, (m, j), cuda), _u8(rng, (m, j), cuda), \
        _u32(rng, (j, k), cuda)
    ops.reset_launch_counts()
    got, _, packed = delta_gemm.delta_product(new, old, a_j, pack=pack)
    torch.cuda.synchronize()
    assert ops.launch_counts()["delta_gemm"] == 1
    assert (packed is not None) == pack
    assert torch.equal(got, ref.delta_gemm_ref(new, old, a_j))
    # the int64 emulation on the CPU (torch has no int64 matmul on CUDA)
    emu = ref.delta_gemm_limbs_ref(new.cpu(), old.cpu(), a_j.cpu(),
                                   two_maps=not pack)
    assert torch.equal(got.cpu(), emu)


@pytest.mark.parametrize("new_val,old_val", [(255, 0), (0, 255)])
@pytest.mark.parametrize("j", [64, 51])
def test_delta_gemm_limb_tile_special_values(cuda, new_val, old_val, j):
    """new - old = +-255 against A_J of 0, 1, 0x80000000, 0xFFFFFFFF."""
    specials = torch.tensor([0, 1, -2**31, -1], dtype=torch.int32,
                            device=cuda)
    a_j = specials.repeat(j, 3)
    new = torch.full((300, j), new_val, dtype=torch.uint8, device=cuda)
    old = torch.full((300, j), old_val, dtype=torch.uint8, device=cuda)
    got = ops.delta_gemm(new, old, a_j, impl="cuda")
    assert torch.equal(got, ref.delta_gemm_ref(new, old, a_j))


@pytest.mark.parametrize("j,k,pack", [(1, 1, True), (51, 70, True),
                                      (64, 1024, True), (64, 1024, False),
                                      (256, 33, False)])
def test_delta_gemm_prep_planes_and_pack_match_ref(cuda, j, k, pack):
    """The prep's planes of [A_J ; -A_J] equal `ref.limb_planes` of
    `ref.delta_right`, and the pack (in the launch and alone) equals
    `ref.delta_pack`."""
    from repro_torch.kernels import delta_gemm
    rng = np.random.default_rng(j + k)
    new, old, a_j = _u8(rng, (5, j), cuda), _u8(rng, (5, j), cuda), \
        _u32(rng, (j, k), cuda)
    _, planes, packed = delta_gemm.delta_product(new, old, a_j, pack=pack)
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.limb_planes(
        ref.delta_right(a_j, two_maps=not pack)))
    if pack:
        assert torch.equal(packed, ref.delta_pack(new, old))
        assert torch.equal(delta_gemm.pack_cuda(new, old), packed)


# bucketed_modmatmul on the limb tile: every bucket in one pass
@pytest.mark.parametrize("heights", [(1, 130, 257), (64, 0, 200)])
@pytest.mark.parametrize("w", [128, 255, 256])
@pytest.mark.parametrize("c", [1, 16, 17])
def test_bucketed_limb_tile_bitwise(cuda, heights, w, c):
    """Heights off 128 with a one-row and an empty bucket, W on and off 16
    bytes (TMA or the predicated producer), C = 1, 16, 17: one launch,
    bitwise against the plain version and the int64 emulation."""
    from repro_torch.kernels import bucketed_modmatmul
    rng = np.random.default_rng(sum(heights) + w + c)
    dbs = [_u8(rng, (m, w), cuda) for m in heights]
    qs = _u32(rng, (len(heights), w, c), cuda)
    ops.reset_launch_counts()
    got, _, predicated = bucketed_modmatmul.grouped_product(dbs, qs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bucketed_modmatmul"] == 1
    busy = sum(1 for m in heights if m)
    assert predicated == (0 if w % 16 == 0 else busy)
    emus = ref.bucketed_modmatmul_limbs_ref([d.cpu() for d in dbs], qs.cpu())
    for g, want, emu in zip(got, ref.bucketed_modmatmul_ref(dbs, qs), emus):
        assert torch.equal(g, want) and torch.equal(g.cpu(), emu)


@pytest.mark.parametrize("w,c", [(33, 1), (256, 16), (128, 65)])
def test_bucketed_prep_planes_match_ref(cuda, w, c):
    """The prep's stacked scratch equals `ref.bucketed_planes`."""
    from repro_torch.kernels import bucketed_modmatmul
    rng = np.random.default_rng(w + c)
    dbs = [_u8(rng, (m, w), cuda) for m in (3, 1, 140)]
    qs = _u32(rng, (3, w, c), cuda)
    _, planes, _ = bucketed_modmatmul.grouped_product(dbs, qs)
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.bucketed_planes(qs))


def test_bucketed_twenty_four_buckets(cuda):
    """K's shape of pass: 24 buckets of width 128 with unequal heights."""
    rng = np.random.default_rng(24)
    heights = [int(h) for h in rng.integers(1, 3000, 24)]
    dbs = [_u8(rng, (m, 128), cuda) for m in heights]
    qs = _u32(rng, (24, 128, 16), cuda)
    ops.reset_launch_counts()
    got = ops.bucketed_modmatmul(dbs, qs, impl="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["bucketed_modmatmul"] == 1
    for g, want in zip(got, ref.bucketed_modmatmul_ref(dbs, qs)):
        assert torch.equal(g, want)


def test_bucketed_base_off_16_bytes_takes_predicated_producer(cuda):
    """A sub-DB whose base lies 4 bytes off 16-byte alignment (a view into
    a larger buffer) is read by the predicated producer beside buckets
    read by TMA, bitwise."""
    from repro_torch.kernels import bucketed_modmatmul
    rng = np.random.default_rng(4)
    w = 256
    whole = _u8(rng, (300 * w + 4,), cuda)
    off = whole[4:4 + 300 * w].view(300, w)
    assert off.data_ptr() % 16 == 4
    dbs = [_u8(rng, (129, w), cuda), off, _u8(rng, (7, w), cuda)]
    qs = _u32(rng, (3, w, 16), cuda)
    got, _, predicated = bucketed_modmatmul.grouped_product(dbs, qs)
    torch.cuda.synchronize()
    assert predicated == 1
    for g, want in zip(got, ref.bucketed_modmatmul_ref(dbs, qs)):
        assert torch.equal(g, want)
