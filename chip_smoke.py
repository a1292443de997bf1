#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # on a machine with an NVIDIA GPU and nvcc

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
one against its plain PyTorch version on the card, drives the port's main
path at full width and checks what comes out.  The phases, in order:

  device   the card's name and power limit, as nvidia-smi reports them
  build    one nvcc per kernel source, all started together
  kernels  every kernel against its plain version: the mod-2^32 products
           bitwise on ragged shapes, on all-255 x all-0xFFFFFFFF operands
           and on row slices of each main-path shape; k-means min-d2
           allclose (rtol 1e-5, atol 1e-5) and assignments equal wherever
           the plain top-2 gap exceeds 1e-5 * (|x|^2 + |c|^2)
  B        `PirRagSystem.build` at SIFT1M scale (1,000,000 docs, d = 128,
           1024 clusters), then `query` and `query_batch` of 16 requests
           perturbed from known anchor docs: every anchor in its top-10,
           decoded columns equal to the DB's
  C        the production PIR point (m = 2,097,152, n = 4096, k = 1024,
           q_switch = 2^16): `PIRServer.setup`, `answer` on 64 encrypted
           one-hots, `PIRClient.recover_batch`; all 64 columns exact
  timing   each kernel, its plain version and its bound at a main-path
           shape; the hint checked bitwise against the plain version

Launch counts are set to 0 just before phase B and read just after it, and
again around phase C; every kernel must have launched in one of the two.
Between them, phase B's k-means is run again and must repeat its
assignment exactly, and one query_batch is traced with torch.profiler for
the device's busy share.  Each output line is one JSON object,
except the nvidia-smi line.  The second-to-last line is the kernel table
(``{"kernels": [...]}``), the last ``{"ok": true, "device": {...}}``.  Any
mismatch raises, and the exit code is then not 0.  Without a CUDA device the
script exits 2 before it prints anything.

``--rehearse`` runs the same phases on the CPU at a tiny size through the
plain versions (nothing is built, nothing is timed on a card) and exits 3:
it checks the script's own logic, not the card.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import clustering, pipeline, pir, threefry  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

FULL = dict(docs=1_000_000, emb_dim=128, topics=1024, clusters=1024,
            queries=16, c_rows=2_097_152, c_cols=4096, c_batch=64,
            slice_rows=4096, plain_rows=131_072)
TINY = dict(docs=1200, emb_dim=64, topics=8, clusters=8, queries=4,
            c_rows=1000, c_cols=256, c_batch=8, slice_rows=64,
            plain_rows=256)

SOURCES = {
    "modmatmul_u8": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                     "src/repro/kernels/modmatmul.py:95"),
    "modmatmul_u32": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                      "src/repro/core/lwe.py:141"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:58"),
}
_NO_INT_MATMUL = ("torch has no integer matmul on CUDA, so no one call "
                  "computes a mod-2^32 product")
LIBRARY_NOTE = {
    "modmatmul_u8": _NO_INT_MATMUL,
    "modmatmul_u32": _NO_INT_MATMUL,
    "kmeans_assign": "torch has no single call for a fused distance + "
                     "argmin",
}


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


class Card:
    """Device, kernel route and clock for one run (card or CPU rehearsal)."""

    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.dev = torch.device("cpu" if rehearse else "cuda")
        self.impl = "torch" if rehearse else "cuda"

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def time_ms(self, fn, reps: int = 1, warmup: int = 1) -> float:
        """Mean milliseconds of ``fn()``: CUDA events on the card."""
        for _ in range(warmup):
            fn()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def once_ms(self, fn):
        """(``fn()``, its milliseconds) for one call, not warmed up."""
        out = []
        ms = self.time_ms(lambda: out.append(fn()), reps=1, warmup=0)
        return out[0], ms


# --------------------------------------------------------------------------
# plain versions and checks
# --------------------------------------------------------------------------

def _u8(gen, shape, dev, hi=256):
    return torch.randint(0, hi, shape, dtype=torch.uint8, generator=gen,
                         device=dev)


def _u32(gen, shape, dev):
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                         generator=gen, device=dev)


def plain_modmatmul(left, right, rows):
    """`ref.modmatmul_ref` over row blocks, so full-size inputs fit."""
    out = torch.empty((left.shape[0], right.shape[1]), dtype=torch.int32,
                      device=left.device)
    for r0 in range(0, left.shape[0], rows):
        out[r0:r0 + rows] = ref.modmatmul_ref(left[r0:r0 + rows], right)
    return out


def u32_max_abs_err(got, want) -> int:
    """Largest |got − want| of two int32-held u32 tensors, as u32 values."""
    return int(((got.to(torch.int64) & 0xFFFFFFFF)
                - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def check_mod(card, left, right, what):
    """The kernel against its plain version, bitwise."""
    if left.dtype == torch.uint8:
        got = ops.modmatmul(left, right, impl=card.impl)
    else:
        got = ops.mod_u32_matmul(left, right, impl=card.impl)
    want = ref.modmatmul_ref(left, right)
    if not torch.equal(got, want):
        raise AssertionError(f"modmatmul {what}: kernel != plain, max err "
                             f"{u32_max_abs_err(got, want)}")


def check_assign(card, x, c, what):
    """min_d2 allclose(1e-5, 1e-5); assignments equal where the plain
    top-2 gap exceeds 1e-5 · (|x|² + |c|²).  Returns max |Δ min_d2|."""
    got_a, got_d = ops.kmeans_assign(x, c, impl=card.impl)
    want_a, want_d = ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"kmeans_assign {what}: {m}")
    if c.shape[0] > 1:
        full = (torch.sum(x * x, 1, keepdim=True) - 2.0 * (x @ c.T)
                + torch.sum(c * c, 1)[None, :])
        top2 = torch.topk(full, 2, dim=1, largest=False).values
        scale = torch.sum(x * x, 1) + torch.sum(c * c, 1)[want_a.long()]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * scale
    else:
        clear = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    if not torch.equal(got_a[clear], want_a[clear]):
        bad = int((got_a[clear] != want_a[clear]).sum())
        raise AssertionError(f"kmeans_assign {what}: {bad} assignments differ")
    return float((got_d - want_d).abs().max())


def kernel_phase(card, cfg):
    gen = torch.Generator(device=card.dev).manual_seed(11)
    dev, rows = card.dev, cfg["slice_rows"]
    n_b, n_c, bc = cfg["clusters"], cfg["c_cols"], cfg["c_batch"]
    u8_cases = [(1, 1, 1), (100, 300, 1), (257, 513, 3), (31, 1025, 129),
                (rows, n_b, cfg["queries"]), (rows, n_b, 1024),
                (rows, n_c, bc), (rows, n_c, 1024)]
    for m, n, b in u8_cases:
        check_mod(card, _u8(gen, (m, n), dev), _u32(gen, (n, b), dev),
                  f"u8 {m}x{n}x{b}")
    u32_cases = [(1, 1, 1), (257, 513, 3), (n_b, 1024, cfg["queries"]),
                 (n_c, 1024, bc), (rows, 1024, cfg["queries"]),
                 (rows, 1024, bc)]
    for m, n, b in u32_cases:
        check_mod(card, _u32(gen, (m, n), dev), _u32(gen, (n, b), dev),
                  f"u32 {m}x{n}x{b}")
    ones = torch.full((300, 1100), 255, dtype=torch.uint8, device=dev)
    allf = torch.full((1100, 70), -1, dtype=torch.int32, device=dev)
    check_mod(card, ones, allf, "u8 wraparound")
    check_mod(card, torch.full((300, 1100), -1, dtype=torch.int32,
                               device=dev), allf, "u32 wraparound")

    def f32(shape):
        return torch.randn(shape, generator=gen, device=dev)

    per_call = -(-cfg["docs"] // 8)
    for n, k, d in [(300, 700, 96), (1, 1, 1), (129, 65, 768), (128, 5, 16),
                    (per_call, cfg["clusters"], cfg["emb_dim"])]:
        check_assign(card, f32((n, d)), f32((k, d)), f"{n}x{k}x{d}")
    c0 = f32((40, 8))
    x = f32((200, 8))
    a3, _ = ops.kmeans_assign(x, torch.cat([c0, c0, c0]), impl=card.impl)
    if not torch.equal(a3, ops.kmeans_assign(x, c0, impl=card.impl)[0]):
        raise AssertionError("kmeans_assign: ties do not go to the earliest")
    card.sync()
    emit(phase="kernels", passed=True, modmatmul_u8_cases=len(u8_cases) + 1,
         modmatmul_u32_cases=len(u32_cases) + 1, kmeans_assign_cases=6,
         rule="mod-2^32 products bitwise; kmeans min_d2 allclose(1e-5,1e-5), "
              "assignments equal where top-2 gap > 1e-5*(|x|^2+|c|^2)")


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def phase_b(card, cfg):
    t0 = time.perf_counter()
    corp = corpus_lib.make_corpus(0, cfg["docs"], emb_dim=cfg["emb_dim"],
                                  n_topics=cfg["topics"])
    corpus_s = time.perf_counter() - t0
    system = pipeline.PirRagSystem.build(
        corp.texts, corp.embeddings, n_clusters=cfg["clusters"],
        device=card.dev)
    rng = np.random.default_rng(3)
    anchors = rng.choice(cfg["docs"], cfg["queries"], replace=False)
    d = cfg["emb_dim"]
    queries = _unit(corp.embeddings[anchors] + 0.1 / math.sqrt(d)
                    * rng.standard_normal((len(anchors), d))
                    ).astype(np.float32)
    gen = torch.Generator(device=card.dev).manual_seed(1)

    top1, stats1 = system.query(queries[0], top_k=10, generator=gen)
    t1 = time.perf_counter()
    inflight = system.query_batch_async(queries, top_k=10, generator=gen)
    cols = inflight.pending[0]
    tops = inflight.complete()
    batch_ms = 1e3 * (time.perf_counter() - t1)

    if int(anchors[0]) not in [i for i, _, _ in top1]:
        raise AssertionError(f"query: anchor {anchors[0]} not in its top-10")
    for a, top in zip(anchors, tops):
        if int(a) not in [i for i, _, _ in top]:
            raise AssertionError(f"query_batch: anchor {a} not in its top-10")
    order = system._cluster_order(queries, 1)[:, 0]
    want = system.server.db[:, torch.as_tensor(order, device=card.dev)]
    if not torch.equal(cols, want):
        raise AssertionError("query_batch: decoded columns != DB columns")
    return system, corp, queries, dict(
        phase="B", docs=cfg["docs"], emb_dim=d, n_clusters=cfg["clusters"],
        m=system.db.m, n=system.db.n, db_bytes=system.db.m * system.db.n,
        hint_bytes=system.cfg.hint_bytes, pad_fraction=system.db.pad_fraction,
        max_cluster_docs=int(system.db.cluster_sizes.max()),
        corpus_seconds=corpus_s, setup_seconds=system.setup_seconds,
        index_seconds=system.index_seconds,
        kmeans_seconds=system.kmeans_seconds,
        pack_seconds=system.pack_seconds, hint_seconds=system.hint_seconds,
        query_server_ms=stats1.server_ms, query_client_ms=stats1.client_ms,
        batch=len(queries), batch_wall_ms=batch_ms, anchors_found=len(tops),
        columns_exact=True)


def traced_ms(card, fn):
    """(wall ms, device kernel ms, top kernels) of one ``fn()`` under
    torch.profiler; the device numbers are None off the card."""
    if card.dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0), None, []
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return wall, sum(ms for _, ms in rows), rows[:6]


def phase_b_breakdown(card, cfg, system, corp, queries):
    """Phase B's checks and trace once its launch counts are read: the
    build's k-means run again must repeat its assignment exactly, and one
    traced query_batch gives the device's busy share."""
    x = torch.from_numpy(corp.embeddings).to(card.dev)
    k_km, _ = pipeline._derive_build_streams(0)
    km = clustering.kmeans_fit(threefry.torch_generator(k_km, card.dev), x,
                               k=cfg["clusters"],
                               n_blocks=clustering.BUILD_BLOCKS)
    if not np.array_equal(km.assignment.cpu().numpy(), system.assignment):
        raise AssertionError("phase B: k-means did not repeat exactly")
    del km, x
    gen = torch.Generator(device=card.dev).manual_seed(4)
    wall, busy, top = traced_ms(
        card, lambda: system.query_batch(queries, top_k=10, generator=gen))
    return dict(
        phase="B breakdown", kmeans_repeats_exactly=True,
        traced_batch_wall_ms=wall, device_kernel_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms=top)


def phase_c(card, cfg):
    m, n, b = cfg["c_rows"], cfg["c_cols"], cfg["c_batch"]
    pcfg = pir.make_config(m, n, impl="auto")
    gen = torch.Generator(device=card.dev).manual_seed(2)
    db = _u8(gen, (m, n), card.dev, hi=pcfg.params.p)
    server = pir.PIRServer(pcfg, db)
    a_mat = server.a_matrix
    card.sync()
    t0 = time.perf_counter()
    hint = server.setup()
    card.sync()
    hint_s = time.perf_counter() - t0
    client = pir.PIRClient(pcfg, hint, a_mat=a_mat)
    idx = torch.randperm(n, generator=gen, device=card.dev)[:b].tolist()
    t1 = time.perf_counter()
    qs, secrets = client.query_batch(gen, idx)
    card.sync()
    t2 = time.perf_counter()
    ans = server.answer(qs)
    card.sync()
    t3 = time.perf_counter()
    cols = client.recover_batch(ans, secrets)
    card.sync()
    t4 = time.perf_counter()
    if not torch.equal(cols, db[:, idx]):
        bad = int((cols != db[:, idx]).any(0).sum())
        raise AssertionError(f"phase C: {bad} of {b} columns decode wrong")
    state = dict(db=db, hint=hint, qs=qs, secrets=secrets, a_mat=a_mat,
                 server=server)
    return state, dict(
        phase="C", m=m, n=n, k=pcfg.params.k, p=pcfg.params.p,
        q_switch=pcfg.params.q_switch, batch=b, db_bytes=m * n,
        hint_bytes=pcfg.hint_bytes, hint_seconds=hint_s,
        encrypt_ms=1e3 * (t2 - t1), server_ms=1e3 * (t3 - t2),
        decode_ms=1e3 * (t4 - t3), columns_exact=b)


# --------------------------------------------------------------------------
# timing at the main path's shapes
# --------------------------------------------------------------------------

def _bound(bytes_, ops_, rate):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops_ / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timing_phase(card, cfg, state, launches):
    rows = cfg["plain_rows"]
    db, hint, qs, secrets = (state["db"], state["hint"], state["qs"],
                             state["secrets"])
    m, n = db.shape
    b, k = qs.shape[1], hint.shape[1]
    table = []

    def entry(name, shape, ms, plain_ms, err, bytes_, ops_, rate, note):
        bound_ms, bound_by = _bound(bytes_, ops_, rate)
        src, replaces = SOURCES[name]
        table.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, library_note=LIBRARY_NOTE[name], shape=shape,
            bound_note=note))

    # the answer: D (m, n) u8 · Q (n, 64), phase C
    got = ops.modmatmul(db, qs, impl=card.impl)
    plain, plain_ms = card.once_ms(lambda: plain_modmatmul(db, qs, rows))
    err = u32_max_abs_err(got, plain)
    del plain
    ms = card.time_ms(lambda: ops.modmatmul(db, qs, impl=card.impl), reps=5)
    entry("modmatmul_u8", f"answer {m}x{n}x{b}", ms, plain_ms, err,
          m * n + 4 * n * b + 4 * m * b, 2 * m * n * b * 4, INT8_OPS_PER_S,
          "4 int8 limbs of each u32 query word on the int8 tensor cores")

    # the hint: D (m, n) u8 · A (n, k), checked bitwise in full
    a_mat = state["a_mat"]
    plain, hint_plain_ms = card.once_ms(
        lambda: plain_modmatmul(db, a_mat, rows))
    hint_err = u32_max_abs_err(hint, plain)
    del plain
    _, hint_ms = card.once_ms(lambda: ops.hint_gemm(db, a_mat,
                                                    impl=card.impl))
    hb, hby = _bound(m * n + 4 * n * k + 4 * m * k, 2 * m * n * k * 4,
                     INT8_OPS_PER_S)
    emit(phase="timing", op="hint", kernel="modmatmul_u8",
         shape=f"{m}x{n}x{k}", ms=hint_ms, plain_ms=hint_plain_ms,
         max_abs_err=hint_err, bound_ms=hb, bound_by=hby)
    if hint_err or err:
        raise AssertionError(f"modmatmul_u8 at full size: max err "
                             f"{max(hint_err, err)}")

    # the client's hint strip: H (m, k) · S (k, 64), u32 × u32
    got = ops.mod_u32_matmul(hint, secrets, impl=card.impl)
    plain, strip_plain_ms = card.once_ms(
        lambda: plain_modmatmul(hint, secrets, rows))
    err = u32_max_abs_err(got, plain)
    del plain, got
    if err:
        raise AssertionError(f"modmatmul_u32 at full size: max err {err}")
    ms = card.time_ms(lambda: ops.mod_u32_matmul(hint, secrets,
                                                 impl=card.impl), reps=5)
    entry("modmatmul_u32", f"hint strip {m}x{k}x{b}", ms, strip_plain_ms, err,
          4 * (m * k + k * b + m * b), 2 * m * k * b * 10, INT8_OPS_PER_S,
          "10 int8 limb products (i+j<4) of two u32 words on the int8 "
          "tensor cores")

    # one Lloyd block of phase B: (docs/8, d) points × (clusters, d)
    gen = torch.Generator(device=card.dev).manual_seed(5)
    pts = -(-cfg["docs"] // 8)
    x = torch.randn((pts, cfg["emb_dim"]), generator=gen, device=card.dev)
    c = torch.randn((cfg["clusters"], cfg["emb_dim"]), generator=gen,
                    device=card.dev)
    err = check_assign(card, x, c, "timing shape")
    ms = card.time_ms(lambda: ops.kmeans_assign(x, c, impl=card.impl),
                      reps=20)
    plain_ms = card.time_ms(lambda: ref.kmeans_assign_ref(x, c), reps=5)
    kk, d = c.shape
    entry("kmeans_assign", f"Lloyd block {pts}x{kk}x{d}", ms, plain_ms, err,
          4 * (pts * d + kk * d) + 8 * pts, 2 * pts * kk * d,
          FP32_FLOPS_PER_S, "fp32 FMA on the CUDA cores (no TF32)")
    return table


# --------------------------------------------------------------------------

def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU at a tiny size through "
                         "the plain versions, then exit 3")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = Card(args.rehearse)
    cfg = TINY if args.rehearse else FULL
    t_start = time.perf_counter()

    if not args.rehearse:
        print(device_line(), flush=True)
        emit(phase="device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda)
        emit(phase="build", seconds=_build.build_all(),
             sources=list(_build.SOURCES))
    kernel_phase(card, cfg)

    ops.reset_launch_counts()
    system, corp, queries, line_b = phase_b(card, cfg)
    launches_b = ops.launch_counts()
    emit(**line_b)
    emit(phase="launches B", **launches_b)
    emit(**phase_b_breakdown(card, cfg, system, corp, queries))
    del system, corp
    if card.dev.type == "cuda":
        torch.cuda.empty_cache()

    ops.reset_launch_counts()
    state, line_c = phase_c(card, cfg)
    launches_c = ops.launch_counts()
    emit(**line_c)
    emit(phase="launches C", **launches_c)
    launches = {k: launches_b[k] + launches_c[k] for k in launches_b}
    if not args.rehearse:
        # phase B runs every kernel; phase C every kernel but k-means
        for path, counts, need in (("B", launches_b, launches_b),
                                   ("C", launches_c, ("modmatmul_u8",
                                                      "modmatmul_u32"))):
            if not all(counts[k] > 0 for k in need):
                raise AssertionError(f"phase {path}: a kernel of the path "
                                     f"was not launched: {counts}")

    table = timing_phase(card, cfg, state, launches)
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    if args.rehearse:
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
