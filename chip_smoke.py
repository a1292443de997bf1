#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # on a machine with an NVIDIA GPU and nvcc

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
one against its plain PyTorch version on the card, drives the port's main
path at full width and checks what comes out.  The phases, in order:

  device   the card's name and power limit, as nvidia-smi reports them
  build    one nvcc per kernel source, all started together
  kernels  every kernel against its plain version: the mod-2^32 products
           (modmatmul, delta_gemm, bucketed_modmatmul) and the u32 add
           (add_delta) bitwise on ragged shapes (for the grouped product: a
           bucket of one row, unequal heights, C = 1 and C > 1, W off the
           tile), on wraparound operands, on u8 limb sums past 2^31 and
           on row slices of each main-path shape, with the producer the u8
           limb kernel read D by (TMA required at the main-path widths);
           the u32 products on the same limb tile at b = 1 at P's and K's
           bucket-hint heights, b off the column tiles, 4k past one
           contraction chunk, a view off 16-byte alignment (predicated
           producer required) and wraparound; delta_gemm's two layouts of
           [new | old] (packed, two tensor maps) at J off and on 16 and 2J
           past one contraction chunk, and A_J of 0, 1, 2^31, 2^32 - 1;
           the grouped tile at W on and off 16 bytes, C = 1, 16, 17, phase
           K's 24 buckets and a sub-DB off 16-byte alignment (predicated
           producer required for it alone);
           k-means min-d2 allclose (rtol 1e-5, atol 1e-5)
           and assignments equal wherever the plain top-2 gap exceeds
           1e-5 * (|x|^2 + |c|^2)
  B        `PirRagSystem.build` at SIFT1M scale (1,000,000 docs, d = 128,
           1024 clusters), then `query` and `query_batch` of 16 requests
           perturbed from known anchor docs: every anchor in its top-10,
           decoded columns equal to the DB's
  U        phase B's system wrapped as a `LiveIndex`, two delta epochs:
           replaces in 5% of the clusters, then replaces, inserts and
           deletes over 25%; after each, the patched hint equals a fresh
           `setup()` bitwise, the DB on the card equals the host mirror, a
           client `HintCache` synced through the epoch log equals the
           server's hint, every replaced or inserted doc is in its anchor
           query's top-10 and no deleted one is; then one full-rebuild
           epoch (an overflowing insert) on a smaller live index
  S        `PIRServeLoop` over phase U's index: 64 requests, batches of 16,
           a mutation batch every 2 ticks; served + failed == offered and
           every anchor in its top-10 at the epoch its response names
  P        batch-PIR on phase B's system: `enable_batch` at kappa = 4 (12
           buckets; the card memory is reckoned first), then the serve loop
           over phase U's live index with multi_probe = kappa queries, two
           bucket-routed commits and one insert that overflows a bucket's
           row budget and rebuilds it; after each commit every bucket hint
           equals a fresh setup() bitwise and the buckets' sub-DBs equal the
           host copy; served + failed == offered, every anchor in its
           top-10, one bucketed pass per served batch; then decoded columns
           equal the sub-DBs' bytes.  U's and S's live index is then dropped
           and its card memory must come back without the cycle collector
  K        keyed lookups at MIND's item-table width (1,000,000 rows of 64
           f32): `LiveIndex.build_keyed`, lookups through the serve loop's
           `submit_lookup`, one `replace_row` commit; rows equal table[ids]
           bitwise, bucket hints equal setup()
  C        the production PIR point (m = 2,097,152, n = 4096, k = 1024,
           q_switch = 2^16): `PIRServer.setup`, `answer` on 64 encrypted
           one-hots, `PIRClient.recover_batch`; all 64 columns exact
  timing   each kernel, its plain version and its bound at a main-path
           shape; the hint, decode's one-column H_b·s at P's tallest bucket
           and the phase-B-width delta checked bitwise against the plain
           versions; k-means at U's rebuild shape; yardstick lines (not the
           same functions, never called by the port) time torch._int_mm at
           the u8 limb kernel's stacked s8 shapes and cuBLAS fp32 x @ c.T
           (TF32 off) at the Lloyd block, and C's H·S is timed beside C's
           answer, the same byte shape on the same kernel; delta_gemm's
           pack is timed apart at U's shapes, and at J = 256 both layouts
           in turns; K's answer pass beside P's

Launch counts are set to 0 just before each of phases B, U, S, P, K and C
and read just after it; every kernel of a path must have launched in it.
Between them, phase B's k-means is run again and must repeat its
assignment exactly, and one query_batch is traced with torch.profiler for
the device's busy share (in P's traced tick, also the device ms of the
u32 products).  The ``sass`` lines must show GMMA in every width of the
limb tile in each of modmatmul.cu, delta_gemm.cu and bucketed_modmatmul.cu,
no IMAD GEMM left in any source, and kmeans_assign on FFMA with no HMMA.
Each output line is one JSON object, except the nvidia-smi line.  The second-to-last line is the kernel table
(``{"kernels": [...]}``), the last ``{"ok": true, "device": {...}}``.  Any
mismatch raises, and the exit code is then not 0.  Without a CUDA device the
script exits 2 before it prints anything.

``--rehearse`` runs the same phases on the CPU at a tiny size through the
plain versions (nothing is built, nothing is timed on a card), on one
intra-op thread, and exits 3: it checks the script's own logic, not the
card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import batchpir  # noqa: E402
from repro_torch.batchpir.server import bucket_rows  # noqa: E402
from repro_torch.core import (chunking, clustering, pipeline, pir,  # noqa: E402
                              threefry)
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.kernels import (_build, bucketed_modmatmul,  # noqa: E402
                                 delta_gemm, modmatmul, ops, ref)
from repro_torch.serve import PIRServeLoop  # noqa: E402
from repro_torch.update import (HintCache, LiveIndex, journal,  # noqa: E402
                                planner)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

FULL = dict(docs=1_000_000, emb_dim=128, topics=1024, clusters=1024,
            queries=16, c_rows=2_097_152, c_cols=4096, c_batch=64,
            slice_rows=4096, plain_rows=131_072, rebuild_docs=20_000,
            rebuild_clusters=64, s_requests=64, s_batch=16, p_kappa=4,
            p_requests=32, p_batch=16, k_rows=1_000_000, k_dim=64,
            k_kappa=8, k_requests=32, k_batch=16, yard_rows=262_144,
            p_hint_rows=902_656, k_hint_rows=336_128)
#: p_hint_rows, k_hint_rows: the tallest bucket hint of phases P and K at
#: these widths (902,656 and 336,128 rows), for the kernel phase's
#: one-column u32 cases, which run before those phases
TINY = dict(docs=100, emb_dim=64, topics=8, clusters=16, queries=4,
            c_rows=1000, c_cols=256, c_batch=8, slice_rows=64,
            plain_rows=256, rebuild_docs=60, rebuild_clusters=4,
            s_requests=8, s_batch=4, p_kappa=4, p_requests=8, p_batch=4,
            k_rows=300, k_dim=8, k_kappa=4, k_requests=8, k_batch=4,
            yard_rows=64, p_hint_rows=300, k_hint_rows=100)
#: the partition seed phase P's buckets are drawn from (enable_batch's default)
P_SEED = 101
#: shares of the clusters phase U's two delta epochs touch (update_bench's
#: sweep: 5%, then 25%)
U_SHARES = (0.05, 0.25)
#: DB widths of the main path (K's and P's buckets, B's clusters, C): the u8
#: limb kernel must read D there by TMA, not by its predicated byte loads
MAIN_WIDTHS = (128, 256, 1024, 4096)
#: the LWE dimension k: every A·S and H·S of the main path is a u32 left
#: operand of k words a row, which the limb kernel must read by TMA
LWE_K = 1024

SOURCES = {
    "modmatmul_u8": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                     "src/repro/kernels/modmatmul.py:95"),
    "modmatmul_u32": ("src/repro_torch/kernels/csrc/modmatmul.cu",
                      "src/repro/core/lwe.py:141"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:58"),
    "delta_gemm": ("src/repro_torch/kernels/csrc/delta_gemm.cu",
                   "src/repro/kernels/ops.py:204"),
    "add_delta": ("src/repro_torch/kernels/csrc/delta_gemm.cu",
                  "src/repro/kernels/ops.py:125"),
    "bucketed_modmatmul": ("src/repro_torch/kernels/csrc/"
                           "bucketed_modmatmul.cu",
                           "src/repro/kernels/ops.py:263"),
}
_NO_INT_MATMUL = ("torch has no integer matmul on CUDA, so no one call "
                  "computes a mod-2^32 product")
LIBRARY_NOTE = {
    "modmatmul_u8": _NO_INT_MATMUL,
    "modmatmul_u32": _NO_INT_MATMUL,
    "kmeans_assign": "torch has no single call for a fused distance + "
                     "argmin",
    "delta_gemm": _NO_INT_MATMUL,
    "add_delta": "torch.add on int32 tensors: the same bits, by signed "
                 "wraparound (timed only; the port never relies on it)",
    "bucketed_modmatmul": "torch has no integer matmul on CUDA and no "
                          "grouped product over ragged heights",
}
#: the kernels each path must launch
PATH_KERNELS = {
    "B": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign"),
    "U": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign", "delta_gemm",
          "add_delta"),
    "S": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta"),
    "P": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta",
          "bucketed_modmatmul"),
    "K": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta",
          "bucketed_modmatmul"),
    "C": ("modmatmul_u8", "modmatmul_u32"),
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
        """Mean milliseconds of ``fn()``: CUDA events on the card (one
        unwarmed host-clock call in a rehearsal, which times nothing)."""
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
        for _ in range(warmup):
            fn()
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


def plain_delta(new, old, a_j, rows):
    """`ref.delta_gemm_ref` over row blocks, so full-size inputs fit."""
    out = torch.empty((new.shape[0], a_j.shape[1]), dtype=torch.int32,
                      device=new.device)
    for r0 in range(0, new.shape[0], rows):
        out[r0:r0 + rows] = ref.delta_gemm_ref(new[r0:r0 + rows],
                                               old[r0:r0 + rows], a_j)
    return out


def plain_add(hint, delta, rows):
    """`ref.add_delta_ref` over row blocks (its int64 temporaries are 8
    bytes an element)."""
    out = torch.empty_like(delta)
    for r0 in range(0, hint.shape[0], rows):
        out[r0:r0 + rows] = ref.add_delta_ref(hint[r0:r0 + rows],
                                              delta[r0:r0 + rows])
    return out


def u32_max_abs_err(got, want, rows: int = 1 << 18) -> int:
    """Largest |got − want| of two int32-held u32 tensors, as u32 values
    (over row blocks: the int64 widening doubles the bytes)."""
    err = 0
    for r0 in range(0, got.shape[0], rows):
        g, w = got[r0:r0 + rows], want[r0:r0 + rows]
        err = max(err, int(((g.to(torch.int64) & 0xFFFFFFFF)
                            - (w.to(torch.int64) & 0xFFFFFFFF)).abs().max()))
    return err


def check_mod(card, left, right, what):
    """The kernel against its plain version (over row blocks, so bucket-
    hint heights fit), bitwise."""
    if left.dtype == torch.uint8:
        got = ops.modmatmul(left, right, impl=card.impl)
    else:
        got = ops.mod_u32_matmul(left, right, impl=card.impl)
    want = plain_modmatmul(left, right, 1 << 17)
    if not torch.equal(got, want):
        raise AssertionError(f"modmatmul {what}: kernel != plain, max err "
                             f"{u32_max_abs_err(got, want)}")


def u8_producer(card, left, m, n, b, aligned=True):
    """Which producer the limb kernel fills its ring with for ``left``
    (``"plain"`` in a rehearsal); TMA is asserted at the main-path widths
    (u8 D: n bytes; u32 L: k = LWE_K words) unless the case is a view off
    16-byte alignment on purpose."""
    how = "plain" if card.rehearse else modmatmul.u8_producer(left)
    main = (n in MAIN_WIDTHS if left.dtype == torch.uint8 else n == LWE_K)
    name = "modmatmul_u8" if left.dtype == torch.uint8 else "modmatmul_u32"
    if not card.rehearse and main and aligned and how != "tma":
        raise AssertionError(f"{name} {m}x{n}x{b}: a main-path width read "
                             f"by the {how} producer, not TMA")
    return dict(shape=f"{m}x{n}x{b}", producer=how)


def check_delta(card, new, old, a_j, what):
    """delta_gemm against its plain version, bitwise."""
    got = ops.delta_gemm(new, old, a_j, impl=card.impl)
    want = ref.delta_gemm_ref(new, old, a_j)
    if not torch.equal(got, want):
        raise AssertionError(f"delta_gemm {what}: kernel != plain, max err "
                             f"{u32_max_abs_err(got, want)}")


def check_add(card, hint, delta, what):
    """add_delta against its plain version, bitwise; the hint unwritten."""
    want = ref.add_delta_ref(hint, delta)
    keep = hint.clone()
    got = ops.add_delta(hint, delta, impl=card.impl)
    if not (torch.equal(got, want) and torch.equal(hint, keep)):
        raise AssertionError(f"add_delta {what}: kernel != plain")


def check_bucketed(card, dbs, qs, what):
    """bucketed_modmatmul against its plain version, bitwise."""
    got = ops.bucketed_modmatmul(dbs, qs, impl=card.impl)
    for b, want in enumerate(ref.bucketed_modmatmul_ref(dbs, qs)):
        if not torch.equal(got[b], want):
            raise AssertionError(f"bucketed_modmatmul {what}: bucket {b} "
                                 f"kernel != plain, max err "
                                 f"{u32_max_abs_err(got[b], want)}")


def check_delta_layout(card, new, old, a_j, pack, what):
    """delta_gemm with its left operand packed or read by two tensor maps
    (in a rehearsal, the int64 emulation of that layout) against its plain
    version, bitwise."""
    if card.rehearse:
        got = ref.delta_gemm_limbs_ref(new, old, a_j, two_maps=not pack)
    else:
        got, _, packed = delta_gemm.delta_product(new, old, a_j, pack=pack)
        if (packed is not None) != pack:
            raise AssertionError(f"delta_gemm {what}: wrong layout")
    want = ref.delta_gemm_ref(new, old, a_j)
    if not torch.equal(got, want):
        layout = "packed" if pack else "two maps"
        raise AssertionError(f"delta_gemm {what} ({layout}): kernel != "
                             f"plain, max err {u32_max_abs_err(got, want)}")


def check_bucketed_tile(card, dbs, qs, what):
    """The grouped limb tile (in a rehearsal, its int64 emulation) against
    the plain version, bitwise; returns how many buckets the predicated
    producer read (None in a rehearsal)."""
    if card.rehearse:
        got, predicated = ref.bucketed_modmatmul_limbs_ref(dbs, qs), None
    else:
        got, _, predicated = bucketed_modmatmul.grouped_product(dbs, qs)
    for b, want in enumerate(ref.bucketed_modmatmul_ref(dbs, qs)):
        if not torch.equal(got[b], want):
            raise AssertionError(f"bucketed_modmatmul {what}: bucket {b} "
                                 f"kernel != plain, max err "
                                 f"{u32_max_abs_err(got[b], want)}")
    return predicated


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
    p_width = 1 << max(0, (n_b // cfg["p_kappa"] - 1).bit_length())
    # the last seven: b off the limb kernel's column tiles, m = 1 at the
    # hint's width, the bucket widths of P and K
    u8_cases = [(1, 1, 1), (100, 300, 1), (257, 513, 3), (31, 1025, 129),
                (rows, n_b, cfg["queries"]), (rows, n_b, 1024),
                (rows, n_c, bc), (rows, n_c, 1024),
                (rows, n_b, 63), (rows, n_b, 65), (rows, n_b, 257),
                (1, n_c, 1024), (rows, p_width, 1024), (rows, 128, 1024),
                (rows, 128, cfg["k_batch"])]
    producers = []
    for m, n, b in u8_cases:
        left = _u8(gen, (m, n), dev)
        check_mod(card, left, _u32(gen, (n, b), dev), f"u8 {m}x{n}x{b}")
        producers.append(u8_producer(card, left, m, n, b))
    # limb sums past 2^31 (255 * 255 * n): the contraction's chunks carry
    # them, through the predicated producer (n % 16 != 0) and through TMA
    for n in (33_100, 33_280):
        left = torch.full((64, n), 255, dtype=torch.uint8, device=dev)
        check_mod(card, left,
                  torch.full((n, 8), -1, dtype=torch.int32, device=dev),
                  f"u8 limb sums past 2^31, 64x{n}x8")
        producers.append(u8_producer(card, left, 64, n, 8))
    # the u32 product reads L as bytes (4 a word) against R's shift planes:
    # b = 1 at P's and K's bucket-hint heights (decode's H_b·s), b off the
    # column tiles, 4k = 32,772 bytes past one contraction chunk
    u32_cases = [(1, 1, 1), (257, 513, 3), (n_b, 1024, cfg["queries"]),
                 (n_c, 1024, bc), (rows, 1024, cfg["queries"]),
                 (rows, 1024, bc), (cfg["p_hint_rows"], 1024, 1),
                 (cfg["k_hint_rows"], 1024, 1), (rows, 1024, 9),
                 (rows, 1024, 63), (rows, 1024, 65), (rows, 1024, 257),
                 (64, 8193, 3)]
    u32_producers = []
    for m, n, b in u32_cases:
        left = _u32(gen, (m, n), dev)
        check_mod(card, left, _u32(gen, (n, b), dev), f"u32 {m}x{n}x{b}")
        u32_producers.append(u8_producer(card, left, m, n, b))
        del left
    # a contiguous view 4 bytes into its buffer: off 16-byte alignment
    view = _u32(gen, (rows * 1024 + 1,), dev)[1:].view(rows, 1024)
    check_mod(card, view, _u32(gen, (1024, 16), dev),
              f"u32 row-slice view off 16 bytes {rows}x1024x16")
    u32_producers.append(dict(u8_producer(card, view, rows, 1024, 16,
                                          aligned=False), view="+4 bytes"))
    if not card.rehearse and u32_producers[-1]["producer"] != "predicated":
        raise AssertionError("modmatmul_u32: a base off 16 bytes went by TMA")
    emit(phase="kernels producers", modmatmul_u8=producers,
         modmatmul_u32=u32_producers, main_widths=list(MAIN_WIDTHS),
         lwe_k=LWE_K)
    ones = torch.full((300, 1100), 255, dtype=torch.uint8, device=dev)
    allf = torch.full((1100, 70), -1, dtype=torch.int32, device=dev)
    check_mod(card, ones, allf, "u8 wraparound")
    check_mod(card, torch.full((300, 1100), -1, dtype=torch.int32,
                               device=dev), allf, "u32 wraparound")
    check_mod(card, torch.full((64, 8193), -1, dtype=torch.int32,
                               device=dev),
              torch.full((8193, 3), -1, dtype=torch.int32, device=dev),
              "u32 wraparound past a contraction chunk")

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
    j1, j2 = (max(1, round(s * n_b)) for s in U_SHARES)
    delta_cases = [(1, 1, 1), (257, 51, 129), (31, 33, 1027), (100, 7, 33),
                   (rows, j1, 1024), (rows, j2, 1024)]
    for m, j, k in delta_cases:
        check_delta(card, _u8(gen, (m, j), dev), _u8(gen, (m, j), dev),
                    _u32(gen, (j, k), dev), f"{m}x{j}x{k}")
    for new_val, old_val in ((255, 0), (0, 255)):
        check_delta(card,
                    torch.full((300, 70), new_val, dtype=torch.uint8,
                               device=dev),
                    torch.full((300, 70), old_val, dtype=torch.uint8,
                               device=dev),
                    torch.full((70, 45), -1, dtype=torch.int32, device=dev),
                    f"wraparound {new_val}-{old_val}")
    # the limb tile's own cases: J off and on 16 and one 128-byte stage,
    # 2J past one contraction chunk, both layouts of [new | old]
    layout_cases = [(9, 1, 70), (130, 51, 1024), (130, 64, 1024),
                    (130, 65, 70), (257, 256, 1024), (3, 16_400, 5),
                    (rows, j2, 1024)]
    layouts = []
    for m, j, k in layout_cases:
        new, old = _u8(gen, (m, j), dev), _u8(gen, (m, j), dev)
        a_j = _u32(gen, (j, k), dev)
        for pack in (True, False) if j % 16 == 0 else (True,):
            check_delta_layout(card, new, old, a_j, pack, f"{m}x{j}x{k}")
            layouts.append(dict(shape=f"{m}x{j}x{k}",
                                left="packed" if pack else "two maps"))
    specials = torch.tensor([0, 1, -2**31, -1], dtype=torch.int32,
                            device=dev)
    for j in (51, 64):
        for new_val, old_val in ((255, 0), (0, 255)):
            check_delta(card,
                        torch.full((300, j), new_val, dtype=torch.uint8,
                                   device=dev),
                        torch.full((300, j), old_val, dtype=torch.uint8,
                                   device=dev),
                        specials.repeat(j, 3),
                        f"A_J of 0, 1, 2^31, 2^32-1, {new_val}-{old_val}")
    # the last three leave 1, 2 and 3 words past the 16-byte vectors
    add_cases = [(1,), (3,), (1023,), (rows, 1024), (rows * 1024 + 1,),
                 (rows * 1024 + 2,), (rows * 1024 + 3,)]
    for shape in add_cases:
        check_add(card, _u32(gen, shape, dev), _u32(gen, shape, dev),
                  f"{shape}")
    # 4 bytes into both buffers: off the 16-byte alignment of the vector path
    check_add(card, _u32(gen, (1001,), dev)[1:], _u32(gen, (1001,), dev)[1:],
              "misaligned")
    check_add(card, torch.full((5, 7), -1, dtype=torch.int32, device=dev),
              torch.full((5, 7), -1, dtype=torch.int32, device=dev),
              "wraparound")
    # the grouped product: (heights, W, C); the last two are row slices of
    # phase P's buckets (3 kappa of them, W = 3n / (3 kappa) to a power of 2)
    slices = tuple(max(1, rows - 37 * b) for b in range(3 * cfg["p_kappa"]))
    bucketed_cases = [((1,), 1, 1), ((64, 1, 96), 32, 1),
                      ((300, 1, 129, 257), 7, 16), ((5, 0, 1000), 256, 17),
                      ((4099, 2000, 130), 33, 64), ((1, 2, 3), 300, 65),
                      (slices, p_width, cfg["p_batch"]), (slices, p_width, 1)]
    for heights, w, c in bucketed_cases:
        check_bucketed(card, [_u8(gen, (m, w), dev) for m in heights],
                       _u32(gen, (len(heights), w, c), dev),
                       f"{len(heights)} buckets up to {max(heights)} rows, "
                       f"W {w}, C {c}")
    check_bucketed(card,
                   [torch.full((m, 300), 255, dtype=torch.uint8, device=dev)
                    for m in (129, 3)],
                   torch.full((2, 300, 5), -1, dtype=torch.int32, device=dev),
                   "wraparound")
    # the limb tile's own cases: heights off 128 with a one-row and an empty
    # bucket, W on and off 16 bytes, C = 1, 16, 17 (N = 32, 64, 128), phase
    # K's 24 buckets; TMA reads every non-empty bucket where W % 16 == 0
    tile_cases = [((1, 130, 0, 257), w, c) for w in (128, 255, 256)
                  for c in (1, 16, 17)]
    tile_cases.append((tuple(max(1, rows - 91 * b) for b in range(24)), 128,
                       cfg["k_batch"]))
    producers_b = []
    for heights, w, c in tile_cases:
        what = f"{len(heights)} buckets up to {max(heights)} rows, W {w}, C {c}"
        pred = check_bucketed_tile(
            card, [_u8(gen, (m, w), dev) for m in heights],
            _u32(gen, (len(heights), w, c), dev), what)
        want = 0 if w % 16 == 0 else sum(1 for m in heights if m)
        if pred is not None and pred != want:
            raise AssertionError(f"bucketed_modmatmul {what}: {pred} buckets "
                                 f"predicated, not {want}")
        producers_b.append(dict(buckets=len(heights), w=w, c=c,
                                predicated=pred))
    # a sub-DB 4 bytes off 16-byte alignment beside two read by TMA
    whole = _u8(gen, (rows * 256 + 4,), dev)
    off = whole[4:].view(rows, 256)
    pred = check_bucketed_tile(card, [_u8(gen, (129, 256), dev), off,
                                      _u8(gen, (7, 256), dev)],
                               _u32(gen, (3, 256, 16), dev),
                               "a base off 16 bytes")
    if pred is not None and pred != 1:
        raise AssertionError(f"bucketed_modmatmul: a base off 16 bytes gave "
                             f"{pred} predicated buckets, not 1")
    producers_b.append(dict(buckets=3, w=256, c=16, view="+4 bytes",
                            predicated=pred))
    emit(phase="kernels producers", delta_gemm=layouts,
         bucketed_modmatmul=producers_b)
    card.sync()
    emit(phase="kernels", passed=True, modmatmul_u8_cases=len(u8_cases) + 3,
         modmatmul_u32_cases=len(u32_cases) + 3, kmeans_assign_cases=6,
         delta_gemm_cases=len(delta_cases) + 2 + len(layouts) + 4,
         add_delta_cases=len(add_cases) + 2,
         bucketed_modmatmul_cases=len(bucketed_cases) + 1
         + len(producers_b),
         rule="mod-2^32 products and adds bitwise; kmeans min_d2 "
              "allclose(1e-5,1e-5), assignments equal where top-2 gap > "
              "1e-5*(|x|^2+|c|^2)")


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
    """(wall ms, device kernel ms, top kernels, every kernel) of one ``fn()``
    under torch.profiler; the device numbers are None off the card."""
    if card.dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0), None, [], []
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
    return wall, sum(ms for _, ms in rows), rows[:6], rows


#: the kernels a `modmatmul_u32` call runs (its prep and the limb tile,
#: which `modmatmul_u8` shares)
U32_KERNELS = re.compile(r"shift_planes_kernel|limb_gemm_kernel")


def u32_share(card, fn):
    """`traced_ms` of ``fn()`` with the device ms of its `modmatmul_u32`
    kernels and the launches it made.  The limb tile is shared with
    `modmatmul_u8`, so the share is given only where ``fn`` launched no
    `modmatmul_u8`."""
    before = ops.launch_counts()
    wall, busy, top, rows = traced_ms(card, fn)
    made = {k: v - before[k] for k, v in ops.launch_counts().items()}
    u32_ms = None
    if busy is not None and made["modmatmul_u8"] == 0:
        u32_ms = sum(ms for key, ms in rows if U32_KERNELS.search(key))
    return wall, busy, top, dict(traced_launches=made,
                                 traced_modmatmul_u32_ms=u32_ms)


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
    wall, busy, top, _ = traced_ms(
        card, lambda: system.query_batch(queries, top_k=10, generator=gen))
    return dict(
        phase="B breakdown", kmeans_repeats_exactly=True,
        traced_batch_wall_ms=wall, device_kernel_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms=top)


# --------------------------------------------------------------------------
# the live index (U) and the serve loop (S) on phase B's system
# --------------------------------------------------------------------------

def _stable_docs(live, corp, rng, n, *, skip=(), slack=0):
    """(doc, cluster) in ``n`` distinct clusters outside ``skip``: each doc
    unmutated so far, its nearest public centroid its own cluster (so a
    replace or a copy of its embedding stays there), and its column with
    ``slack`` free bytes."""
    system = live.system
    taken, out = set(skip), []
    for d in rng.permutation(len(corp.texts)):
        d = int(d)
        c = live._cluster_of.get(d)
        if (c is None or c in taken or corp.texts[d] != live._docs[d][0]
                or system.db.m - live._used[c] < slack):
            continue
        if planner.nearest_centroid(corp.embeddings[d],
                                    system.centroids) != c:
            continue
        taken.add(c)
        out.append((d, c))
        if len(out) == n:
            return out
    raise AssertionError(f"only {len(out)} of {n} clusters have a stable doc")


def _revised(text: bytes, tag: bytes) -> bytes:
    """``text`` with its head overwritten by ``tag``: same length, so the
    column cannot overflow."""
    return (tag + text[len(tag):])[:len(text)]


def _check_anchors(live, corp, want, gone, *, chunk=64):
    """Every (doc, text) in ``want`` in its own embedding's top-10 with that
    text; no doc of ``gone`` in its top-10.  Returns the count checked."""
    items = [(d, t) for d, t in want] + [(d, None) for d in gone]
    gen = torch.Generator(device=live.system.device).manual_seed(6)
    for i in range(0, len(items), chunk):
        part = items[i:i + chunk]
        embs = np.stack([live._docs[d][1] if t is not None
                         else corp.embeddings[d] for d, t in part])
        tops = live.query_batch(embs, epoch=live.epoch, top_k=10,
                                generator=gen)
        for (d, text), top in zip(part, tops):
            hit = [t for i_, _, t in top if i_ == d]
            if text is not None and hit != [text]:
                raise AssertionError(f"phase U: doc {d} not retrieved with "
                                     f"its new text at epoch {live.epoch}")
            if text is None and hit:
                raise AssertionError(f"phase U: deleted doc {d} retrieved")
    return len(items)


def _commit_epoch(card, live, corp, cache, want, gone, share):
    """Commit the pending batch as one delta epoch and check it."""
    card.sync()
    t0 = time.perf_counter()
    staged = live.stage()
    card.sync()
    t1 = time.perf_counter()
    patch = live.publish(staged)
    card.sync()
    t2 = time.perf_counter()
    st = live.commits[-1]
    if patch.is_full:
        raise AssertionError(f"phase U: epoch {live.epoch} was a rebuild "
                             f"({st.reason})")
    system = live.system
    if not torch.equal(system.server.setup(), system.hint):
        raise AssertionError(f"phase U: patched hint != setup() at epoch "
                             f"{live.epoch}")
    mirror = torch.from_numpy(system.db.matrix).to(card.dev)
    if not torch.equal(system.server.db, mirror):
        raise AssertionError("phase U: DB on the card != host mirror")
    del mirror
    sync_bytes = cache.sync(live.epochs)
    if cache.epoch != live.epoch or not torch.equal(cache.hint, system.hint):
        raise AssertionError("phase U: synced client hint != server hint")
    checked = _check_anchors(live, corp, want, gone)
    return dict(
        phase="U", epoch=live.epoch, share=share, mutations=st.n_mutations,
        J=len(patch.cols), m=system.db.m, k=system.cfg.params.k,
        patch_rows=int(patch.delta.shape[0]), patch_bytes=patch.wire_bytes,
        hint_bytes=system.cfg.hint_bytes,
        patch_over_hint=patch.wire_bytes / system.cfg.hint_bytes,
        commit_seconds=t2 - t0, plan_seconds=st.plan_seconds,
        repack_seconds=st.repack_seconds,
        delta_seconds=(t1 - t0) - st.plan_seconds - st.repack_seconds,
        publish_seconds=t2 - t1, hint_equals_setup=True,
        db_equals_mirror=True, client_sync_bytes=sync_bytes,
        client_hint_equal=True, anchors_checked=checked)


def phase_u(card, cfg, system, corp):
    t0 = time.perf_counter()
    live = LiveIndex(system, corp.texts, corp.embeddings)
    cache = HintCache(system.hint.clone(), system.cfg)
    wrap_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    n_b = system.db.n
    j1, j2 = (max(1, round(s * n_b)) for s in U_SHARES)
    lines = []

    first = _stable_docs(live, corp, rng, j1)
    want = []
    for d, _ in first:
        text = _revised(corp.texts[d], b"rev1:")
        live.replace(d, text, corp.embeddings[d])
        want.append((d, text))
    lines.append(_commit_epoch(card, live, corp, cache, want, [],
                               U_SHARES[0]))

    emb_dim = corp.embeddings.shape[1]
    ins_text = b"inserted document " * 4
    second = _stable_docs(live, corp, rng, j2, skip=[c for _, c in first],
                          slack=chunking.record_bytes(emb_dim, len(ins_text)))
    q = max(1, j2 // 4)
    reps, ins, dels = second[:j2 - 2 * q], second[j2 - 2 * q:j2 - q],         second[j2 - q:]
    want, gone = [], []
    for d, _ in reps:
        text = _revised(corp.texts[d], b"rev2:")
        live.replace(d, text, corp.embeddings[d])
        want.append((d, text))
    for i, (d, _) in enumerate(ins):
        new_id = len(corp.texts) + i
        live.insert(new_id, ins_text, corp.embeddings[d])
        want.append((new_id, ins_text))
    for d, _ in dels:
        live.delete(d)
        gone.append(d)
    lines.append(_commit_epoch(card, live, corp, cache, want, gone,
                               U_SHARES[1]))
    lines[0]["wrap_seconds"] = wrap_s
    del cache
    lines.append(_rebuild_epoch(card, cfg))
    return live, lines


def _rebuild_epoch(card, cfg):
    """One full-rebuild epoch (an insert that overflows its column) on a
    smaller live index: a full patch whose hint equals setup(), every live
    doc in the DB and retrievable, doc ids kept."""
    corp = corpus_lib.make_corpus(5, cfg["rebuild_docs"],
                                  emb_dim=cfg["emb_dim"],
                                  n_topics=cfg["rebuild_clusters"])
    live = LiveIndex.build(corp.texts, corp.embeddings,
                           n_clusters=cfg["rebuild_clusters"],
                           device=card.dev)
    m0 = live.system.db.m
    big_id = len(corp.texts) + 1
    live.insert(big_id, b"overflow " * (m0 // 9 + 1), corp.embeddings[0])
    live.delete(3)
    want = sorted((set(live.doc_ids()) - {3}) | {big_id})
    card.sync()
    t0 = time.perf_counter()
    patch = live.commit()
    card.sync()
    commit_s = time.perf_counter() - t0
    system = live.system
    if not (patch.is_full and live.commits[-1].reason == "overflow"):
        raise AssertionError("phase U rebuild: the overflow was not a "
                             "full rebuild")
    if not torch.equal(system.server.setup(), system.hint):
        raise AssertionError("phase U rebuild: hint != setup()")
    if not np.array_equal(patch.full_hint,
                          system.hint.cpu().numpy().view(np.uint32)):
        raise AssertionError("phase U rebuild: full patch != server hint")
    db = system.db
    in_db = sorted(i for j in range(db.n) for i, _, _ in
                   chunking.deserialize_docs(db.matrix[:, j], db.emb_dim))
    if not in_db == live.doc_ids() == want:
        raise AssertionError("phase U rebuild: doc ids not kept")
    rng = np.random.default_rng(8)
    sample = [int(d) for d in rng.choice(want[:-1], 15, replace=False)]
    gen = torch.Generator(device=card.dev).manual_seed(9)
    embs = np.stack([live._docs[d][1] for d in sample + [big_id]])
    tops = live.query_batch(embs, epoch=live.epoch, top_k=10, generator=gen)
    for d, top in zip(sample + [big_id], tops):
        if d not in [i for i, _, _ in top]:
            raise AssertionError(f"phase U rebuild: doc {d} not retrieved")
    return dict(phase="U rebuild", docs=len(want), n_clusters=db.n,
                m_before=m0, m_after=db.m, commit_seconds=commit_s,
                patch_bytes=patch.wire_bytes, hint_equals_setup=True,
                doc_ids_kept=True, anchors_found=len(sample) + 1)


def phase_s(card, cfg, live, corp):
    """The sync serve loop over phase U's live index, a mutation batch
    committed every 2 ticks."""
    per_tick = cfg["s_batch"] // 2
    n_ticks = cfg["s_requests"] // per_tick
    loop = PIRServeLoop(live, max_batch=cfg["s_batch"], deadline_ms=1e9,
                        seed=9)
    rng = np.random.default_rng(12)
    emb_dim = corp.embeddings.shape[1]
    ins_text = b"served insert " * 4
    n_batches = n_ticks // 2
    pool = _stable_docs(live, corp, rng, 4 * n_batches + per_tick,
                        slack=2 * chunking.record_bytes(emb_dim,
                                                        len(ins_text)))
    anchors = [d for d, _ in pool[:per_tick]]
    muts = [pool[per_tick + 4 * b:per_tick + 4 * b + 4]
            for b in range(n_batches)]
    inserted_at: dict[int, int] = {}
    anchor_of: dict[int, int] = {}
    offered = 0
    for t in range(n_ticks):
        fresh_ids = [i for i in inserted_at if i not in anchor_of.values()]
        for j in range(per_tick):
            d = fresh_ids.pop() if fresh_ids else anchors[j]
            loop.submit(offered, live._docs[d][1], top_k=10)
            anchor_of[offered] = d
            offered += 1
        new_id = None
        if t % 2 == 1:
            (r1, _), (r2, _), (ins, _), (dl, _) = muts[t // 2]
            for d in (r1, r2):
                loop.submit_mutation(journal.replace(
                    d, _revised(corp.texts[d], b"srv:"), corp.embeddings[d]))
            new_id = len(corp.texts) + 10_000 + t
            loop.submit_mutation(journal.insert(
                new_id, ins_text, corp.embeddings[ins]))
            loop.submit_mutation(journal.delete(dl))
        loop.tick()
        if new_id is not None:
            if live.journal.pending() or loop.mutations:
                raise AssertionError("phase S: a mutation batch did not "
                                     "commit on its tick")
            inserted_at[new_id] = live.epoch
    loop.drain()
    # one traced tick: a full batch served, no commit
    for j in range(cfg["s_batch"]):
        loop.submit(offered, live._docs[anchors[j % len(anchors)]][1],
                    top_k=10)
        anchor_of[offered] = anchors[j % len(anchors)]
        offered += 1
    wall, busy, top, _ = traced_ms(card, lambda: loop.tick(force=True))
    loop.drain()

    served = [r for r in loop.responses if not r.failed]
    if len(served) + loop.failed_requests != offered:
        raise AssertionError(f"phase S: {len(served)} served + "
                             f"{loop.failed_requests} failed != {offered}")
    for r in served:
        d = anchor_of[r.rid]
        if d not in [i for i, _, _ in r.top]:
            raise AssertionError(f"phase S: request {r.rid} (doc {d}) not "
                                 f"retrieved at epoch {r.epoch}")
        if r.epoch < inserted_at.get(d, 0):
            raise AssertionError(f"phase S: doc {d} served before its epoch")
    if not torch.equal(live.system.server.setup(), live.system.hint):
        raise AssertionError("phase S: patched hint != setup()")
    timings = list({id(r.timing): r.timing for r in served}.values())

    def med_ms(attr):
        return 1e3 * float(np.median([getattr(t, attr) for t in timings]))

    return dict(
        phase="S", offered=offered, served=len(served),
        failed=loop.failed_requests, stale_retries=loop.stale_retries,
        epochs=live.epoch, batches=len(timings),
        inserted_anchors=len(inserted_at), encode_ms_median=med_ms("encode_s"),
        gemm_ms_median=med_ms("gemm_s"), decode_ms_median=med_ms("decode_s"),
        traced_tick_wall_ms=wall, device_kernel_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms=top)


# --------------------------------------------------------------------------
# batch-PIR (P) on phase B's system, keyed lookups (K)
# --------------------------------------------------------------------------

def p_memory(cfg, system):
    """The card memory phase P holds, reckoned before `enable_batch`: the
    bucket hints are Σ m_b × k × 4 bytes, and a commit touching one cluster
    stages three new bucket hints beside the old ones, plus the flat one."""
    kappa = cfg["p_kappa"]
    part = batchpir.CuckooPartition.build(system.db.n, 3 * kappa, P_SEED)
    rows = bucket_rows(part, system.db.used_bytes, system.db.m)
    k = system.cfg.params.k
    resident = (system.db.m * system.db.n + 4 * system.db.m * k
                + sum(rows) * part.width + 4 * sum(rows) * k)
    staged = 3 * 4 * max(rows) * k + 4 * system.db.m * k
    return dict(phase="P memory", kappa=kappa, n_buckets=part.n_buckets,
                width=part.width, sum_rows=sum(rows), max_rows=max(rows),
                bucket_hint_bytes=4 * sum(rows) * k,
                sub_db_bytes=sum(rows) * part.width, resident_bytes=resident,
                staged_commit_bytes=staged, reckoned_peak_bytes=resident
                + staged)


def _bucket_checks(card, live, what):
    """Every bucket hint equals a fresh setup() of its sub-DB, each sub-DB
    equals its members' columns of the host mirror (through the card's flat
    DB, itself held equal to the mirror)."""
    system = live.system
    server, part = system.batch.server, system.batch.partition
    mirror = torch.from_numpy(system.db.matrix).to(card.dev)
    if not torch.equal(system.server.db, mirror):
        raise AssertionError(f"{what}: flat DB on the card != host mirror")
    for b in range(part.n_buckets):
        sub = server.sub_dbs[b]
        mem = torch.as_tensor(part.members[b], dtype=torch.int64,
                              device=card.dev)
        take = min(sub.shape[0], mirror.shape[0])
        host = torch.zeros_like(sub)
        host[:take, :len(mem)] = mirror[:take].index_select(1, mem)
        if not torch.equal(sub, host):
            raise AssertionError(f"{what}: bucket {b} sub-DB != host copy")
        fresh = ops.hint_gemm(sub, server.a_matrix(b), impl=card.impl)
        if not torch.equal(fresh, server.hints[b]):
            raise AssertionError(f"{what}: bucket {b} hint != setup()")
        del fresh, host
    return part.n_buckets


def _bucket_overflow(live, skip):
    """(cluster, insert text) growing one column past the shortest of its
    buckets' row budgets while it still fits the flat DB's m rows."""
    system = live.system
    server, part = system.batch.server, system.batch.partition
    best = None
    for j in range(system.db.n):
        if j in skip or planner.nearest_centroid(
                system.centroids[j], system.centroids) != j:
            continue
        rows = min(server.cfgs[b].m for b in part.buckets_of(j))
        grow = rows - live._used[j] + 64
        text_len = grow - chunking.record_bytes(system.db.emb_dim, 0)
        if text_len > 0 and live._used[j] + grow <= system.db.m and (
                best is None or text_len < best[1]):
            best = (j, text_len)
    if best is None:
        raise AssertionError("phase P: no column can overflow only a bucket")
    return best[0], b"o" * best[1]


def _p_commit(card, live, kind, cluster, t_tick):
    """Check the commit the loop's last tick published: every bucket hint
    equals setup(), sub-DBs equal the host copy; the split of its time."""
    st = live.commits[-1]
    part = live.system.batch.partition
    checked = _bucket_checks(card, live, f"phase {kind}")
    return dict(phase=kind, epoch=live.epoch, J=st.touched_clusters,
                cluster=cluster,
                touched_buckets=list(part.buckets_of(cluster)),
                rebuilt_buckets=[], tick_seconds=t_tick,
                commit_seconds=st.seconds, plan_seconds=st.plan_seconds,
                repack_seconds=st.repack_seconds,
                delta_and_publish_seconds=st.seconds - st.plan_seconds
                - st.repack_seconds, buckets_checked=checked,
                bucket_hints_equal_setup=True, sub_dbs_equal_host=True)


def phase_p(card, cfg, live, corp):
    """Batch-PIR over phase U's live index: multi-probe serving, two
    bucket-routed commits and one overflow-forced bucket rebuild."""
    system = live.system
    kappa = cfg["p_kappa"]
    lines = [p_memory(cfg, system)]
    if card.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    card.sync()
    t0 = time.perf_counter()
    bp = system.enable_batch(kappa=kappa, seed=P_SEED)
    card.sync()
    enable_s = time.perf_counter() - t0
    server, part = bp.server, bp.partition
    heights = [c.m for c in server.cfgs]
    loop = PIRServeLoop(live, max_batch=cfg["p_batch"], deadline_ms=1e9,
                        seed=13)
    rng = np.random.default_rng(14)
    per_tick = cfg["p_batch"] // 2
    pool = _stable_docs(live, corp, rng, per_tick + 2)
    anchors = [d for d, _ in pool[:per_tick]]
    movers = pool[per_tick:]
    expect: dict[int, tuple[int, bytes | None]] = {}   # rid → (doc, text)
    offered = 0

    def submit(doc, emb, text=None):
        nonlocal offered
        loop.submit(offered, emb, top_k=10, multi_probe=kappa)
        expect[offered] = (doc, text)
        offered += 1

    for t in range(cfg["p_requests"] // per_tick):
        for d in anchors:
            submit(d, live._docs[d][1])
        mover = None
        if t % 2 == 1:
            mover = movers[t // 2 % len(movers)]
            text = _revised(live._docs[mover[0]][0], b"bat:")
            loop.submit_mutation(journal.replace(mover[0], text,
                                                 live._docs[mover[0]][1]))
        epoch0 = live.epoch
        t1 = time.perf_counter()
        loop.tick()
        card.sync()
        if mover is not None:
            if live.epoch != epoch0 + 1:
                raise AssertionError("phase P: a commit did not land")
            lines.append(_p_commit(card, live, "P commit", mover[1],
                                   time.perf_counter() - t1))
            submit(mover[0], live._docs[mover[0]][1], text)
    # one insert that outgrows a bucket's row budget, not the flat DB's
    j, big = _bucket_overflow(live, {c for _, c in pool})
    before = [c.m for c in server.cfgs]
    new_id = len(corp.texts) + 20_000
    loop.submit_mutation(journal.insert(new_id, big, system.centroids[j]))
    t1 = time.perf_counter()
    loop.tick()
    card.sync()
    if live.epochs.epoch == 0 or live.commits[-1].full_rebuild:
        raise AssertionError("phase P: the overflow insert was not a delta "
                             "epoch")
    line = _p_commit(card, live, "P overflow", j,
                     time.perf_counter() - t1)
    line["rebuilt_buckets"] = [b for b in range(part.n_buckets)
                               if server.cfgs[b].m != before[b]]
    line["insert_bytes"] = len(big)
    if not line["rebuilt_buckets"]:
        raise AssertionError("phase P: the overflow insert rebuilt no bucket")
    lines.append(line)
    submit(new_id, system.centroids[j], big)
    loop.drain()
    # one traced tick: a full batch served, no commit
    for i in range(cfg["p_batch"]):
        d = anchors[i % len(anchors)]
        submit(d, live._docs[d][1])
    wall, busy, top, share = u32_share(card, lambda: loop.tick(force=True))
    loop.drain()

    served = [r for r in loop.responses if not r.failed]
    if len(served) + loop.failed_requests != offered:
        raise AssertionError(f"phase P: {len(served)} served + "
                             f"{loop.failed_requests} failed != {offered}")
    for r in served:
        d, text = expect[r.rid]
        hit = [t for i, _, t in r.top if i == d]
        if not hit or (text is not None and hit != [text]):
            raise AssertionError(f"phase P: request {r.rid} (doc {d}) not "
                                 f"retrieved at epoch {r.epoch}")
    timings = list({id(r.timing): r.timing for r in served}.values())

    def med_ms(attr):
        return 1e3 * float(np.median([getattr(t, attr) for t in timings]))

    lines.append(dict(
        phase="P", kappa=kappa, n_buckets=part.n_buckets, width=part.width,
        bucket_rows=heights, sum_rows=sum(heights),
        sub_db_bytes=server.stored_bytes, bucket_hint_bytes=server.hint_bytes,
        enable_seconds=enable_s, offered=offered, served=len(served),
        failed=loop.failed_requests, stale_retries=loop.stale_retries,
        multi_probe=kappa, batches=len(timings), epochs=live.epoch,
        encode_ms_median=med_ms("encode_s"), gemm_ms_median=med_ms("gemm_s"),
        decode_ms_median=med_ms("decode_s"), traced_tick_wall_ms=wall,
        device_kernel_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms=top, **share, max_memory_allocated=(
            torch.cuda.max_memory_allocated()
            if card.dev.type == "cuda" else None)))
    return lines


def p_decode_check(card, live, cfg):
    """One batched query outside the counted run: every placed bucket's
    decoded column equals the sub-DB's bytes."""
    bp = live.system.batch
    gen = torch.Generator(device=card.dev).manual_seed(15)
    probes = np.random.default_rng(16).choice(bp.partition.n_clusters,
                                              cfg["p_kappa"], replace=False)
    qs, st = bp.client.query(gen, probes.tolist())
    cols = bp.client.recover(bp.server.answer_batch(qs), st)
    for b, cl in st.placement.items():
        want = bp.server.sub_dbs[b][:, bp.partition.position(b, cl)]
        if not np.array_equal(cols[cl], want.cpu().numpy()):
            raise AssertionError(f"phase P: cluster {cl} decodes wrong from "
                                 f"bucket {b}")
    return dict(phase="P decode", probes=len(st.placement),
                columns_equal_sub_dbs=True)


def allocated(card):
    """Card bytes allocated now (None in a rehearsal)."""
    if card.dev.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def freed_line(phase, held, before, after):
    """The memory a dropped live index gave back; it must be all it held."""
    if before is not None and before - after < held:
        raise AssertionError(f"phase {phase}: dropping the live index freed "
                             f"{before - after} of its {held} card bytes")
    return dict(phase=f"{phase} freed", held_bytes=held,
                allocated_before=before, allocated_after=after,
                cycle_collector="off")


def held_bytes(system) -> int:
    """Card bytes a system holds: flat DB and hint, sub-DBs, bucket hints."""
    n = system.db.m * system.db.n + system.cfg.hint_bytes
    if system.batch is not None:
        n += system.batch.server.stored_bytes + system.batch.server.hint_bytes
    return n


def phase_k(card, cfg):
    """Keyed lookups at MIND's item-table width: served by `submit_lookup`
    before and after one `replace_row` commit."""
    rng = np.random.default_rng(16)
    v, d, kappa = cfg["k_rows"], cfg["k_dim"], cfg["k_kappa"]
    table = rng.standard_normal((v, d), dtype=np.float32)
    t0 = time.perf_counter()
    live = LiveIndex.build_keyed(table, kappa=kappa, device=card.dev)
    card.sync()
    build_s = time.perf_counter() - t0
    system, lay = live.system, live.system.keyed
    loop = PIRServeLoop(live, max_batch=cfg["k_batch"], deadline_ms=1e9,
                        seed=17)
    asks: dict[int, list[int]] = {}

    def serve(n):
        for _ in range(n):
            rid = len(asks)
            asks[rid] = ((rng.zipf(1.2, size=kappa) - 1) % v).tolist()
            loop.submit_lookup(rid, asks[rid])
            loop.tick()
        loop.drain()

    serve(cfg["k_requests"])
    # replace two rows in each of two groups: one delta epoch, J = 2
    new_table = table.copy()
    groups = rng.choice(lay.n_groups - 1, 2, replace=False)
    replaced = [int(g) * lay.group_size + i for g in groups for i in (0, 1)]
    for i in replaced:
        new_table[i] = rng.standard_normal(d, dtype=np.float32)
        live.replace_row(i, new_table[i])
    card.sync()
    t1 = time.perf_counter()
    patch = live.commit()
    card.sync()
    commit_s = time.perf_counter() - t1
    if patch.is_full:
        raise AssertionError("phase K: the replace_row commit was a rebuild")
    if not torch.equal(system.server.setup(), system.hint):
        raise AssertionError("phase K: patched hint != setup()")
    checked = _bucket_checks(card, live, "phase K")
    serve(cfg["k_requests"] // 2)
    last = len(asks)                      # a lookup of the replaced rows
    asks[last] = replaced
    loop.submit_lookup(last, replaced)
    loop.drain()
    served = [r for r in loop.responses if not r.failed]
    if len(served) + loop.failed_requests != len(asks):
        raise AssertionError("phase K: served + failed != offered")
    for r in served:
        want = (table if r.epoch == 0 else new_table)[asks[r.rid]]
        if not np.array_equal(r.top, want):
            raise AssertionError(f"phase K: lookup {r.rid} rows != table[ids] "
                                 f"at epoch {r.epoch}")
    if next(r.epoch for r in served if r.rid == last) != 1:
        raise AssertionError("phase K: the replaced rows were not served at "
                             "the new epoch")
    timings = list({id(r.timing): r.timing for r in served}.values())
    bp = system.batch
    line = dict(
        phase="K", rows=v, dim=d, group_size=lay.group_size,
        groups=lay.n_groups, m=system.db.m, kappa=kappa,
        n_buckets=bp.partition.n_buckets, width=bp.partition.width,
        bucket_rows=[c.m for c in bp.server.cfgs],
        sum_rows=sum(c.m for c in bp.server.cfgs),
        bucket_hint_bytes=bp.server.hint_bytes, build_seconds=build_s,
        offered=len(asks), served=len(served), failed=loop.failed_requests,
        stale_retries=loop.stale_retries, batches=len(timings),
        encode_ms_median=1e3 * float(np.median([t.encode_s
                                                for t in timings])),
        gemm_ms_median=1e3 * float(np.median([t.gemm_s for t in timings])),
        decode_ms_median=1e3 * float(np.median([t.decode_s
                                                for t in timings])),
        commit_seconds=commit_s, replaced_rows=len(replaced),
        patch_bytes=patch.wire_bytes, buckets_checked=checked,
        rows_equal_table=True, replaced_rows_equal=True,
        bucket_hints_equal_setup=True)
    return live, line


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


def yardstick(card, cfg, db, a_mat, qs):
    """`torch._int_mm` at the stacked s8 shapes of the hint and of C's
    answer, (rows, n) x (n, 4 b_pad), beside the limb kernel on the same row
    slice of D.  Not the same function (signed bytes, no limb
    recombination, no mod-2^32 sum) and never called by the port: it only
    says what rate the card's own int8 GEMM reaches at these shapes."""
    rows = min(cfg["yard_rows"], db.shape[0])
    d = db[:rows]
    n = d.shape[1]
    lines = []
    for op, right in (("hint", a_mat), ("answer", qs)):
        # (n, 4 b_pad) s8 in column-major order, the kernel's own planes
        b_s8 = ref.limb_planes(right)[:, :n].view(torch.int8).t()
        stacked = b_s8.shape[1]
        work = 2 * rows * n * stacked
        line = dict(phase="yardstick", op=op,
                    shape=f"{rows}x{n}x{stacked} s8",
                    note="torch._int_mm: not the same function; never "
                         "called by the port")
        try:
            lib_ms = card.time_ms(lambda: torch._int_mm(d.view(torch.int8),
                                                        b_s8), reps=5)
            line.update(int_mm_ms=lib_ms, int_mm_tops=work / lib_ms / 1e9)
        except RuntimeError as err:
            line.update(int_mm_ms=None, int_mm_error=str(err)[:200])
        ms = card.time_ms(lambda: ops.modmatmul(d, right, impl=card.impl),
                          reps=5)
        line.update(modmatmul_u8_ms=ms, modmatmul_u8_tops=work / ms / 1e9)
        lines.append(line)
    return lines


def hs_beside_answer(card, db, qs, hint, secrets):
    """C's H·S (u32 H read as 4k bytes a row) beside C's answer (u8 D of n
    = 4k bytes a row) at b = 64: one byte shape, one kernel, timed in turns
    (answer, H·S, H·S, answer)."""
    times = {"answer": [], "H·S": []}
    for op in ("answer", "H·S", "H·S", "answer"):
        fn = ((lambda: ops.modmatmul(db, qs, impl=card.impl))
              if op == "answer" else
              (lambda: ops.mod_u32_matmul(hint, secrets, impl=card.impl)))
        times[op].append(card.time_ms(fn, reps=5))
    ans, hs = (sum(v) / 2 for v in times.values())
    return dict(phase="yardstick", op="H·S beside the answer",
                answer_shape=f"{db.shape[0]}x{db.shape[1]}x{qs.shape[1]} u8",
                hs_shape=f"{hint.shape[0]}x{hint.shape[1]}x{secrets.shape[1]}"
                         " u32", answer_ms=ans, hs_ms=hs, hs_over_answer=hs / ans)


def cublas_beside_assign(card, x, c, assign_ms):
    """cuBLAS fp32 ``x @ c.T`` with TF32 off at the Lloyd block: the
    distance matrix's product only (no norms, no argmin, (N, K) written to
    memory).  Not the same function and never called by the port: it says
    what fp32 rate the card's own GEMM reaches at this shape."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_ms = card.time_ms(lambda: x @ c.T, reps=20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    flops = 2 * x.shape[0] * c.shape[0] * x.shape[1]
    return dict(phase="yardstick", op="Lloyd block x @ c.T",
                shape=f"{x.shape[0]}x{c.shape[0]}x{x.shape[1]} fp32, TF32 off",
                cublas_ms=lib_ms, cublas_tflops=flops / lib_ms / 1e9,
                kmeans_assign_ms=assign_ms,
                kmeans_assign_tflops=flops / assign_ms / 1e9,
                note="x @ c.T: not the same function; never called by the "
                     "port")


def delta_layouts(card, new, old, a_j, ms, epoch):
    """The pack alone, and (where J % 16 == 0) the delta kernel with its
    left operand packed beside it read by two tensor maps, in turns
    (packed, two maps, two maps, packed), at one of phase U's shapes; the
    default layout's time ``ms`` comes from the caller."""
    m, j = new.shape
    n2 = ref.delta_layout(j)[1]
    pack_ms = card.time_ms(lambda: delta_gemm.pack_cuda(new, old), reps=5)
    pb, pby = _bound(2 * m * j + m * n2, 0, INT8_OPS_PER_S)
    line = dict(phase="timing", op=f"delta epoch {epoch} layouts",
                shape=f"{m}x{j}x{a_j.shape[1]}", default_ms=ms,
                default="packed" if delta_gemm.packs(new, old)
                else "two maps", pack_ms=pack_ms, pack_bound_ms=pb,
                pack_bound_by=pby, pack_share=pack_ms / ms)
    if j % 16 == 0:
        times = {True: [], False: []}
        for pack in (True, False, False, True):
            times[pack].append(card.time_ms(
                lambda: delta_gemm.delta_product(new, old, a_j, pack=pack),
                reps=5))
        line.update(packed_ms=sum(times[True]) / 2,
                    two_maps_ms=sum(times[False]) / 2)
    return line


def bucketed_pass(card, heights, w, c, phase):
    """One batch-PIR answer pass at a phase's bucket heights and batch
    width, checked bitwise against the plain version and timed: (shape, ms,
    plain ms, max err, bytes, operations)."""
    gen = torch.Generator(device=card.dev).manual_seed(20)
    dbs = [_u8(gen, (m, w), card.dev) for m in heights]
    q3 = _u32(gen, (len(heights), w, c), card.dev)
    got = ops.bucketed_modmatmul(dbs, q3, impl=card.impl)
    want, plain_ms = card.once_ms(lambda: ref.bucketed_modmatmul_ref(dbs, q3))
    err = max(u32_max_abs_err(g, x) for g, x in zip(got, want))
    del got, want
    if err:
        raise AssertionError(f"bucketed_modmatmul at phase {phase}'s shape: "
                             f"max err {err}")
    ms = card.time_ms(lambda: ops.bucketed_modmatmul(dbs, q3,
                                                     impl=card.impl), reps=5)
    total = sum(heights)
    return (f"answer pass {len(heights)} buckets, {total}x{w}x{c}", ms,
            plain_ms, err, total * w + 4 * len(heights) * w * c + 4 * total * c,
            2 * total * w * c * 4)


def timing_phase(card, cfg, state, launches, u_epochs, line_p, line_k):
    rows = cfg["plain_rows"]
    db, hint, qs, secrets = (state["db"], state["hint"], state["qs"],
                             state["secrets"])
    m, n = db.shape
    b, k = qs.shape[1], hint.shape[1]
    table = []

    def entry(name, shape, ms, plain_ms, err, bytes_, ops_, rate, note,
              library_ms=None):
        bound_ms, bound_by = _bound(bytes_, ops_, rate)
        src, replaces = SOURCES[name]
        table.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, library_note=LIBRARY_NOTE[name],
            shape=shape, bound_note=note))

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
    for line in yardstick(card, cfg, db, a_mat, qs):
        emit(**line)

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
    emit(**hs_beside_answer(card, db, qs, hint, secrets))

    # decode's one-column H_b·s at phase P's tallest bucket
    mb = max(line_p["bucket_rows"])
    gen = torch.Generator(device=card.dev).manual_seed(18)
    hint_b = _u32(gen, (mb, k), card.dev)
    s_b = _u32(gen, (k, 1), card.dev)
    got = ops.mod_u32_matmul(hint_b, s_b, impl=card.impl)
    plain, col_plain_ms = card.once_ms(lambda: plain_modmatmul(hint_b, s_b,
                                                               rows))
    err = u32_max_abs_err(got, plain)
    del plain, got
    if err:
        raise AssertionError(f"modmatmul_u32 one-column H_b·s: max err {err}")
    col_ms = card.time_ms(lambda: ops.mod_u32_matmul(hint_b, s_b,
                                                     impl=card.impl), reps=10)
    cb, cby = _bound(4 * (mb * k + k + mb), 2 * mb * k * 10, INT8_OPS_PER_S)
    emit(phase="timing", op="one-column H_b·s", kernel="modmatmul_u32",
         shape=f"{mb}x{k}x1", ms=col_ms, plain_ms=col_plain_ms,
         max_abs_err=err, bound_ms=cb, bound_by=cby)
    del hint_b, s_b

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
    emit(**cublas_beside_assign(card, x, c, ms))
    del x, c
    # one Lloyd block of phase U's rebuild (rebuild_docs/8 points)
    pts_u = -(-cfg["rebuild_docs"] // 8)
    gen_u = torch.Generator(device=card.dev).manual_seed(19)
    x = torch.randn((pts_u, cfg["emb_dim"]), generator=gen_u, device=card.dev)
    c = torch.randn((cfg["rebuild_clusters"], cfg["emb_dim"]),
                    generator=gen_u, device=card.dev)
    err = check_assign(card, x, c, "rebuild shape")
    ms_u = card.time_ms(lambda: ops.kmeans_assign(x, c, impl=card.impl),
                        reps=20)
    ub, uby = _bound(4 * (pts_u * d + c.shape[0] * d) + 8 * pts_u,
                     2 * pts_u * c.shape[0] * d, FP32_FLOPS_PER_S)
    emit(phase="timing", op="U rebuild Lloyd block", kernel="kmeans_assign",
         shape=f"{pts_u}x{c.shape[0]}x{d}", ms=ms_u, max_abs_err=err,
         bound_ms=ub, bound_by=uby)
    del x, c

    # the delta-hint kernel at phase B's width and each phase-U epoch's J
    for i, u in enumerate(u_epochs):
        mb, j, kb = u["m"], u["J"], u["k"]
        new, old = _u8(gen, (mb, j), card.dev), _u8(gen, (mb, j), card.dev)
        a_j = _u32(gen, (j, kb), card.dev)
        got = ops.delta_gemm(new, old, a_j, impl=card.impl)
        plain, plain_ms = card.once_ms(lambda: plain_delta(new, old, a_j,
                                                           rows))
        err = u32_max_abs_err(got, plain)
        del plain, got
        if err:
            raise AssertionError(f"delta_gemm at {mb}x{j}x{kb}: max err {err}")
        ms = card.time_ms(lambda: ops.delta_gemm(new, old, a_j,
                                                 impl=card.impl), reps=5)
        args = (f"delta epoch {u['epoch']} {mb}x{j}x{kb}", ms, plain_ms, err,
                2 * mb * j + 4 * j * kb + 4 * mb * kb, 2 * mb * j * kb * 8,
                INT8_OPS_PER_S, "8 int8 limb MACs per MAC, as the TPU's two "
                "u8 x u32 products; dH written once")
        if i == 0:
            entry("delta_gemm", *args)
        else:
            bms, bby = _bound(*args[4:7])
            emit(phase="timing", op=f"delta epoch {u['epoch']}",
                 kernel="delta_gemm", shape=args[0], ms=ms, plain_ms=plain_ms,
                 max_abs_err=err, bound_ms=bms, bound_by=bby)
        if not card.rehearse:
            emit(**delta_layouts(card, new, old, a_j, ms, u["epoch"]))
        del new, old, a_j

    # folding dH into the hint at phase B's width
    u = u_epochs[0]
    hint_t = _u32(gen, (u["m"], u["k"]), card.dev)
    delta_t = _u32(gen, (u["m"], u["k"]), card.dev)
    want, plain_ms = card.once_ms(lambda: plain_add(hint_t, delta_t, rows))
    got = ops.add_delta(hint_t, delta_t.clone(), impl=card.impl)
    err = u32_max_abs_err(got, want)
    if err:
        raise AssertionError(f"add_delta at {tuple(hint_t.shape)}: max err "
                             f"{err}")
    lib = torch.add(hint_t, delta_t)
    lib_ms = None
    if torch.equal(lib, want):
        lib_ms = card.time_ms(lambda: torch.add(hint_t, delta_t,
                                                out=delta_t), reps=5)
    del got, want, lib
    ms = card.time_ms(lambda: ops.add_delta(hint_t, delta_t, impl=card.impl),
                      reps=5)
    words = hint_t.numel()
    entry("add_delta", f"hint fold {u['m']}x{u['k']}", ms, plain_ms, err,
          12 * words, words, FP32_FLOPS_PER_S,
          "one u32 add per word on the CUDA cores; two words read, one "
          "written", library_ms=lib_ms)
    del hint_t, delta_t

    # one batch-PIR answer pass at phase P's and phase K's bucket heights
    # and batch width
    shape, ms, plain_ms, err, bytes_, ops_ = bucketed_pass(
        card, line_p["bucket_rows"], line_p["width"], cfg["p_batch"], "P")
    entry("bucketed_modmatmul", shape, ms, plain_ms, err, bytes_, ops_,
          INT8_OPS_PER_S, "every sub-DB read once, or 4 int8 limb MACs per "
          "u8 x u32 MAC on the int8 tensor cores")
    shape, ms, plain_ms, err, bytes_, ops_ = bucketed_pass(
        card, line_k["bucket_rows"], line_k["width"], cfg["k_batch"], "K")
    bound, by = _bound(bytes_, ops_, INT8_OPS_PER_S)
    emit(phase="timing", op="K answer pass", kernel="bucketed_modmatmul",
         shape=shape, ms=ms, plain_ms=plain_ms, max_abs_err=err,
         bound_ms=bound, bound_by=by)
    return table


# --------------------------------------------------------------------------

def sass_line(source: str) -> dict:
    """The matrix instructions of each kernel in the built library of
    ``csrc/<source>.cu``, from ``cuobjdump -sass``: warpgroup MMA (``GMMA``),
    warp MMA (``IMMA``, ``HMMA``), fp32 FMA (``FFMA``) and 32-bit integer
    multiply-add (``IMAD``, which also counts the moves and index arithmetic
    it is used for)."""
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(_build._lib_path(source))],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ", 1)[1].strip()
            # the kernel's name and its template argument (a width or a
            # bool), if any
            hit = re.search(r"\d+([A-Za-z_]+_kernel)(?:IL[ib](\d+)E)?", fn)
            if hit:
                fn = hit.group(1) + (f"<{hit.group(2)}>" if hit.group(2)
                                     else "")
            counts[fn] = {"GMMA": 0, "IMMA": 0, "HMMA": 0, "FFMA": 0,
                          "IMAD": 0}
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in ln or f"{op}." in ln:
                    counts[fn][op] += 1
                    break
    return dict(phase="sass", source=f"csrc/{source}.cu", kernels=counts)


#: the IMAD GEMM kernels the limb tile replaced; none may be left
IMAD_GEMMS = ("modmatmul_kernel", "delta_gemm_kernel", "bucketed_kernel")


def check_sass(lines) -> None:
    """Each of the three mod-2^32 sources runs the limb tile, whose every
    width holds GMMA, beside its own prep (modmatmul.cu the shift planes too,
    delta_gemm.cu the pack), and no IMAD GEMM is left in any source;
    kmeans_assign runs on FFMA with no tensor-core MMA (no TF32)."""
    by_source = {ln["source"]: ln["kernels"] for ln in lines}
    preps = {"csrc/modmatmul.cu": ("limb_planes_kernel", "shift_planes_kernel"),
             "csrc/delta_gemm.cu": ("limb_planes_kernel",),
             "csrc/bucketed_modmatmul.cu": ("limb_planes_kernel",)}
    for source, kernels in by_source.items():
        if any(k.startswith(name) for k in kernels for name in IMAD_GEMMS):
            raise AssertionError(f"{source} sass: an IMAD GEMM is left: "
                                 f"{kernels}")
        if source not in preps:
            continue
        tiles = [k for k in kernels if k.startswith("limb_gemm_kernel<")]
        if (len(tiles) != 4 or any(kernels[k]["GMMA"] == 0 for k in tiles)
                or not all(p in kernels for p in preps[source])):
            raise AssertionError(f"{source} sass: {kernels}")
    if not any(k.startswith("delta_pack_kernel")
               for k in by_source["csrc/delta_gemm.cu"]):
        raise AssertionError("delta_gemm.cu sass: no delta_pack_kernel")
    km = by_source["csrc/kmeans_assign.cu"]
    assign = [v for k, v in km.items() if k.startswith("kmeans_assign_kernel")]
    if not assign or any(v["FFMA"] == 0 or v["HMMA"] or v["GMMA"]
                         for v in assign):
        raise AssertionError(f"kmeans_assign.cu sass: {km}")


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
    if args.rehearse:
        # tiny shapes gain nothing from intra-op threads, and on a CPU that
        # other processes share they stall on each other's barriers
        torch.set_num_threads(1)
    t_start = time.perf_counter()

    if not args.rehearse:
        print(device_line(), flush=True)
        emit(phase="device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda)
        t_build = time.perf_counter()
        nvcc_seconds = _build.build_all()
        emit(phase="build", seconds=time.perf_counter() - t_build,
             sources=list(_build.SOURCES), nvcc_seconds=nvcc_seconds)
        sass = [sass_line(src) for src in _build.SOURCES]
        for line in sass:
            emit(**line)
        check_sass(sass)
    kernel_phase(card, cfg)

    paths = {}
    ops.reset_launch_counts()
    system, corp, queries, line_b = phase_b(card, cfg)
    paths["B"] = ops.launch_counts()
    emit(**line_b)
    emit(phase="launches B", **paths["B"])
    emit(**phase_b_breakdown(card, cfg, system, corp, queries))

    ops.reset_launch_counts()
    live, lines_u = phase_u(card, cfg, system, corp)
    paths["U"] = ops.launch_counts()
    for line in lines_u:
        emit(**line)
    emit(phase="launches U", **paths["U"])
    u_epochs = [ln for ln in lines_u if ln["phase"] == "U"]

    ops.reset_launch_counts()
    line_s = phase_s(card, cfg, live, corp)
    paths["S"] = ops.launch_counts()
    emit(**line_s)
    emit(phase="launches S", **paths["S"])

    ops.reset_launch_counts()
    lines_p = phase_p(card, cfg, live, corp)
    paths["P"] = ops.launch_counts()
    for line in lines_p:
        emit(**line)
    emit(phase="launches P", **paths["P"])
    line_p = lines_p[-1]
    if not args.rehearse and paths["P"]["bucketed_modmatmul"] != \
            line_p["batches"]:
        raise AssertionError(f"phase P: {paths['P']['bucketed_modmatmul']} "
                             f"bucketed launches for {line_p['batches']} "
                             f"served batches")
    emit(**p_decode_check(card, live, cfg))
    # U's, S's and P's live index holds no reference cycle: dropping it
    # returns its card memory with the cycle collector off
    gc.disable()
    try:
        held, before = held_bytes(system), allocated(card)
        del system, corp, live
        after = allocated(card)
    finally:
        gc.enable()
    emit(**freed_line("P", held, before, after))

    ops.reset_launch_counts()
    live, line_k = phase_k(card, cfg)
    paths["K"] = ops.launch_counts()
    emit(**line_k)
    emit(phase="launches K", **paths["K"])
    gc.disable()
    try:
        held, before = held_bytes(live.system), allocated(card)
        del live
        after = allocated(card)
    finally:
        gc.enable()
    emit(**freed_line("K", held, before, after))
    if card.dev.type == "cuda":
        torch.cuda.empty_cache()     # C starts from an empty cache, as before

    ops.reset_launch_counts()
    state, line_c = phase_c(card, cfg)
    paths["C"] = ops.launch_counts()
    emit(**line_c)
    emit(phase="launches C", **paths["C"])
    launches = {k: sum(p[k] for p in paths.values()) for k in paths["B"]}
    if not args.rehearse:
        for path, counts in paths.items():
            if not all(counts[k] > 0 for k in PATH_KERNELS[path]):
                raise AssertionError(f"phase {path}: a kernel of the path "
                                     f"was not launched: {counts}")

    table = timing_phase(card, cfg, state, launches, u_epochs, line_p,
                         line_k)
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
