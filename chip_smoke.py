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
  M        the sharded path: B's corpus built again with
           `mesh=make_local_mesh(4)` (on one card the four shards share
           it); bitwise against B: centroids and assignment, each row shard
           against B's rows (pad rows zero), the hint, B's queries through
           the same encrypted one-hots (answers, decoded columns) and their
           top-k; the sharded plan tick makes no more synchronizing calls
           than B's; one 5% commit (J = 51) on a sharded `LiveIndex`
           against B's unsharded `stage_delta` / `stage_scatter` of the
           same swap (not published on B); then `timing M`: one shard's
           answer, hint and ΔH against their bounds, beside the four shards
           together and B's one launch.  B's side of each check runs
           outside M's launch counts.  M is freed before U
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
           equal the sub-DBs' bytes; `P sharded` builds P's bucket layout
           again over 4 shards from the host mirror and unsharded from the
           card's DB (no hint but the smallest bucket's): sub-DBs, that
           hint and one served batch's bucket answers equal, one grouped
           launch per shard, and the shards' useful rows max/mean for the
           sequential and the LPT layouts.  U's and S's live index is then
           dropped and its card memory must come back without the cycle
           collector
  K        keyed lookups at MIND's item-table width (1,000,000 rows of 64
           f32): `LiveIndex.build_keyed`, lookups through the serve loop's
           `submit_lookup`, one `replace_row` commit; rows equal table[ids]
           bitwise, bucket hints equal setup()
  G        the paper's Fig. 2 comparison at 700,000 docs (d = 128, 7,000
           topics, 800-1,600-byte texts, 418 clusters; the most a
           one-column-per-document PIR admits at p = 256): the content PIR
           both baselines owe for RAG, then PIR-RAG, Tiptoe-style and
           graph-PIR built and queried 8 times each (top-10; Tiptoe and
           graph-PIR then fetch their 10 documents); setup, median query
           and RAG-ready seconds, bytes and card memory per system.  Gates:
           Tiptoe's ids equal the plaintext quantized ranking, every
           decoded graph record equals its DB column, every fetched doc
           equals the corpus's (text, dequantized embedding), PIR-RAG finds
           each query's own doc, p = 256 for both baseline PIRs.  After
           the launch counts, each new shape (content and graph hints and
           answers, their A·S, Tiptoe's hint and score) is held bitwise
           against the plain version on sampled rows and timed beside its
           bound, and 1,000 rows of the k-NN graph are held against a
           float64 recompute (similarities within 1e-6)
  Q        the paper's Fig. 3 regime (5,000 docs, d = 384, 333 clusters,
           12 queries, 3 builds of PIR-RAG and Tiptoe): NDCG@10, P@10,
           R@50, retrieval and RAG-ready seconds per system; PIR-RAG's
           RAG-ready time must equal its retrieval time and both baselines
           must pay a fetch tail; the quality ordering is printed, not
           gated
  R        the RAG path end to end (`benchmarks/rag_bench.py`'s full
           shape): PIR-RAG over 4,000 docs (d = 48, 256 clusters), 16
           requests as two `query_batch` calls of 8, top-3; the retrieved
           texts packed into byte prompts of 160 tokens and a float32
           decoder at Qwen3-4B width (36 layers, d = 2560, vocab 151,936,
           seeded weights) prefilling them and decoding 16 tokens from its
           KV cache.  Gates: every retrieved text equals the corpus's;
           packed + dropped bytes equal the bytes offered, no prompt over
           160 tokens; prefill's and every decode step's logits within
           R_ATOL_PREFILL / R_ATOL_DECODE of one teacher-forced `forward`
           over prompt + generated tokens; each greedy token its argmax
           wherever the top-2 gap exceeds 2·atol (near-ties counted);
           `generate_nocache` and two rows generated alone (greedy, and
           sampled at temperature 0.8) equal the batch up to a first
           split at a near-tie (max |Δlogit| alone against batched
           printed).  Retrieval, prefill, decode-step, first-token ms,
           tokens/s and peak card memory beside the decode-step bound and
           the prefill bounds of the real tokens (causal attention) and of
           the padded grid; one traced decode step between two untraced
           runs of R_HOST_STEPS steps (host issue, step and device ms)
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

Launch counts are set to 0 just before each of phases B, M, U, S, P, K, G,
Q, R and C and read just after it (M's count leaves out the launches of
its unsharded comparisons on B); every kernel of a path must have launched in
it.
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
from repro_torch.batchpir.server import (BatchPIRServer,  # noqa: E402
                                         bucket_rows)
from repro_torch.configs import qwen3_4b  # noqa: E402
from repro_torch.core import (chunking, clustering, pipeline, pir,  # noqa: E402
                              threefry)
from repro_torch.core.baselines import common as baseline_common  # noqa: E402
from repro_torch.core.baselines import graph_pir, tiptoe  # noqa: E402
from repro_torch.data import corpus as corpus_lib  # noqa: E402
from repro_torch.data import metrics  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.kernels import (_build, bucketed_modmatmul,  # noqa: E402
                                 delta_gemm, modmatmul, ops, ref)
from repro_torch.fleet import faults as faults_lib  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.rag import generate as rag_generate  # noqa: E402
from repro_torch.rag import prompt as rag_prompt  # noqa: E402
from repro_torch.serve import PIRServeLoop, PipelinedServeLoop  # noqa: E402
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
            p_hint_rows=902_656, k_hint_rows=336_128, window_ticks=4,
            g_docs=700_000, g_emb_dim=128, g_topics=7_000,
            g_text=(800, 1600), g_queries=8, g_sample_rows=64,
            g_knn_rows=1000, q_docs=5000, q_emb_dim=384, q_text=(64, 256),
            q_queries=12, q_builds=3, r_docs=4000, r_emb_dim=48,
            r_topics=256, r_clusters=256, r_requests=16, r_batch=8,
            r_budget=160, r_new=16, r_model="qwen3-4b", m_shards=4)
#: p_hint_rows, k_hint_rows: the tallest bucket hint of phases P and K at
#: these widths (902,656 and 336,128 rows), for the kernel phase's
#: one-column u32 cases, which run before those phases.  g_docs: 700,000,
#: under the 716,800 columns above which a one-column-per-document PIR's
#: plaintext modulus drops below 256 (the baselines refuse that).
TINY = dict(docs=100, emb_dim=64, topics=8, clusters=16, queries=4,
            c_rows=1000, c_cols=256, c_batch=8, slice_rows=64,
            plain_rows=256, rebuild_docs=60, rebuild_clusters=4,
            s_requests=8, s_batch=4, p_kappa=4, p_requests=8, p_batch=4,
            k_rows=300, k_dim=8, k_kappa=4, k_requests=8, k_batch=4,
            yard_rows=64, p_hint_rows=300, k_hint_rows=100, window_ticks=2,
            g_docs=200, g_emb_dim=32, g_topics=6, g_text=(16, 48),
            g_queries=3, g_sample_rows=8, g_knn_rows=50, q_docs=240,
            q_emb_dim=48, q_text=(16, 48), q_queries=3, q_builds=1,
            r_docs=100, r_emb_dim=64, r_topics=8, r_clusters=16,
            r_requests=4, r_batch=2, r_budget=160, r_new=8, r_model="tiny",
            m_shards=2)
# r_*: phase R, `benchmarks/rag_bench.py`'s full shape (4,000 docs, d = 48,
# 256 clusters, top-3, prompts of 160 tokens, 16 new tokens, batches of 8)
# and the port's Qwen3-4B width; TINY keeps B's corpus and the tiny model.
# m_shards: phase M's and P sharded's shard count (on one card all share
# it; the rehearsal puts them on the CPU).

#: full ticks served before the traced window of phases S and SP
WINDOW_PRIME = 2
#: phase R's tolerances on logits against one teacher-forced forward
#: (float32 throughout; other GEMM shapes round differently, and decode's
#: one-shot softmax over the cache differs from the chunked one): the
#: first run at Qwen3-4B width on the H100 measured 1.7e-5 for both
R_ATOL_PREFILL = 1e-4
R_ATOL_DECODE = 1e-4
#: decode steps phase R times untraced, before and after its traced step
R_HOST_STEPS = 8
#: phase R's sampling temperature (alone against batched)
R_TEMPERATURE = 0.8
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
    "M": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign", "delta_gemm",
          "add_delta"),
    "U": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign", "delta_gemm",
          "add_delta"),
    "S": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta"),
    "SP": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta"),
    "P": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta",
          "bucketed_modmatmul"),
    "PP": ("modmatmul_u32", "delta_gemm", "add_delta", "bucketed_modmatmul"),
    "K": ("modmatmul_u8", "modmatmul_u32", "delta_gemm", "add_delta",
          "bucketed_modmatmul"),
    "C": ("modmatmul_u8", "modmatmul_u32"),
    "G": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign"),
    "Q": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign"),
    "R": ("modmatmul_u8", "modmatmul_u32", "kmeans_assign"),
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
    assign_cases = [(300, 700, 96), (1, 1, 1), (129, 65, 768), (128, 5, 16),
                    (per_call, cfg["clusters"], cfg["emb_dim"])]
    # G's and Q's: Tiptoe's one-block Lloyd, PIR-RAG's BUILD_BLOCKS blocks,
    # graph-PIR's entry k-means, and a query's cluster
    for n, k, d, n_entry in ((cfg["g_docs"], g_clusters(cfg),
                              cfg["g_emb_dim"], 8),
                             (cfg["q_docs"], q_clusters(cfg),
                              cfg["q_emb_dim"], 16)):
        assign_cases += [(n, k, d),
                         (-(-n // clustering.BUILD_BLOCKS), k, d),
                         (n, min(n_entry, n), d), (1, k, d)]
    # R's: PIR-RAG's build at rag_bench's shape, whole and one of its
    # BUILD_BLOCKS blocks (d = 48 pads the last 32-wide stage)
    n, k, d = cfg["r_docs"], cfg["r_clusters"], cfg["r_emb_dim"]
    assign_cases += [(n, k, d), (-(-n // clustering.BUILD_BLOCKS), k, d)]
    assign_errs = {}
    for n, k, d in assign_cases:
        assign_errs[f"{n}x{k}x{d}"] = check_assign(card, f32((n, d)),
                                                   f32((k, d)),
                                                   f"{n}x{k}x{d}")
    emit(phase="kernels assign", max_abs_err_min_d2=assign_errs)
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
# the sharded path (M) on phase B's corpus
# --------------------------------------------------------------------------

def m_mesh(card, cfg):
    """Phase M's mesh: ``m_shards`` shards over the visible cards (on one
    card they all share it), or on the CPU in a rehearsal."""
    n = cfg["m_shards"]
    return make_local_mesh(n, devices=["cpu"] * n if card.rehearse else None)


def _tops(tops):
    return [[(d, s_, t) for d, s_, t in top] for top in tops]


def phase_m(card, cfg, system, corp, queries):
    """B's corpus built again row-sharded over ``m_shards`` shards, held
    bitwise against B: clustering, row shards (pad rows zero), hint, B's
    queries' answers, decoded columns and top-k through the same encrypted
    queries, the plan's synchronizing calls, and one 5% commit on a
    sharded `LiveIndex` against the unsharded `stage_delta` and
    `stage_scatter` of the same swap on B's server (not published there).

    B's side of the comparisons comes first (the encrypted queries, B's
    answers, columns and plan tick); then the launch counts are set to 0,
    only M's sharded calls run, and the counts are read right after them;
    B's side of the swap and the `setup()` check come after the read.
    Returns (M's system, its live index, the M line, M's launch counts)."""
    mesh = m_mesh(card, cfg)
    order = system._cluster_order(queries, 1)[:, 0]
    client = pir.PIRClient(system.cfg, system.hint,
                           a_mat=system.server.a_matrix)
    qs, secrets = client.query_batch(_gen(card, 31), order.tolist())
    ans_b = system.server.answer(qs)
    want = client.recover_batch(ans_b, secrets)
    # one plan tick (encode, answer, decode queued; nothing retired) under
    # the sync counter, then completed
    inflight = []
    sync_b, _ = plan_sync_count(
        card, lambda: inflight.append(system.query_batch_async(
            queries, top_k=10, generator=_gen(card, 33))))
    tops_b = inflight.pop().complete()

    _reset_peak(card)
    ops.reset_launch_counts()
    m_sys = pipeline.PirRagSystem.build(
        corp.texts, corp.embeddings, n_clusters=cfg["clusters"], mesh=mesh)
    if not (np.array_equal(m_sys.centroids, system.centroids)
            and np.array_equal(m_sys.assignment, system.assignment)):
        raise AssertionError("phase M: sharded k-means != B's")
    rows = m_sys.server.db[0].shape[0]
    for s_, (part, dev) in enumerate(zip(m_sys.server.db, mesh.devices)):
        ref_rows = system.server.db[s_ * rows:(s_ + 1) * rows]
        if part.device != dev or not torch.equal(part[:ref_rows.shape[0]],
                                                 ref_rows):
            raise AssertionError(f"phase M: row shard {s_} != B's rows")
        if part[ref_rows.shape[0]:].any():
            raise AssertionError(f"phase M: row shard {s_} pad rows not 0")
    if not torch.equal(m_sys.hint, system.hint):
        raise AssertionError("phase M: sharded hint != B's")

    ans = m_sys.server.answer(qs)
    cols = pir.PIRClient(m_sys.cfg, m_sys.hint,
                         a_mat=m_sys.server.a_matrix).recover_batch(
                             ans, secrets)
    if not (torch.equal(ans, ans_b) and torch.equal(cols, want)):
        raise AssertionError("phase M: sharded answers or columns != B's")
    del ans_b, want, ans, cols
    sync_m, sites_m = plan_sync_count(
        card, lambda: inflight.append(m_sys.query_batch_async(
            queries, top_k=10, generator=_gen(card, 33))))
    if _tops(inflight.pop().complete()) != _tops(tops_b):
        raise AssertionError("phase M: sharded top-k != B's")
    if sync_b is not None and sync_m > sync_b:
        raise AssertionError(f"phase M: the sharded plan synchronized "
                             f"{sync_m} times, B's {sync_b}: {sites_m}")

    live = LiveIndex(m_sys, corp.texts, corp.embeddings)
    rng = np.random.default_rng(41)
    j1 = max(1, round(U_SHARES[0] * m_sys.db.n))
    for d, _ in _stable_docs(live, corp, rng, j1):
        live.replace(d, _revised(corp.texts[d], b"revM:"), corp.embeddings[d])
    card.sync()
    t0 = time.perf_counter()
    patch = live.commit()
    card.sync()
    commit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if patch.is_full:
        raise AssertionError("phase M: the 5% commit was a rebuild")

    cols_t = torch.from_numpy(patch.cols).to(card.dev)
    new_t = torch.from_numpy(
        np.ascontiguousarray(m_sys.db.matrix[:, patch.cols])).to(card.dev)
    hint_b = ops.add_delta(system.hint, system.server.stage_delta(
        cols_t, new_t), impl=card.impl)
    if not torch.equal(m_sys.hint, hint_b):
        raise AssertionError("phase M: sharded patched hint != B's stage")
    del hint_b
    db_b = system.server.stage_scatter(cols_t, new_t)
    for s_, part in enumerate(m_sys.server.db):
        ref_rows = db_b[s_ * rows:(s_ + 1) * rows]
        if not torch.equal(part[:ref_rows.shape[0]], ref_rows) or \
                part[ref_rows.shape[0]:].any():
            raise AssertionError(f"phase M: patched row shard {s_} != B's")
    del db_b
    if not torch.equal(m_sys.server.setup(), m_sys.hint):
        raise AssertionError("phase M: patched hint != sharded setup()")
    return m_sys, live, dict(
        phase="M", mesh=str(mesh), shards=len(mesh.devices),
        devices=[str(d) for d in mesh.devices], rows_per_shard=rows,
        row_pad=m_sys.server._row_pad, m=m_sys.db.m, n=m_sys.db.n,
        setup_seconds=m_sys.setup_seconds,
        index_seconds=m_sys.index_seconds,
        kmeans_seconds=m_sys.kmeans_seconds,
        pack_seconds=m_sys.pack_seconds, hint_seconds=m_sys.hint_seconds,
        clustering_equal_b=True, row_shards_equal_b=True,
        pad_rows_zero=True, hint_equal_b=True, answers_equal_b=True,
        columns_equal_b=True, topk_equal_b=True, queries=len(queries),
        plan_sync_calls=sync_m, plan_sync_calls_b=sync_b,
        plan_sync_sites=sites_m, commit_J=len(patch.cols),
        commit_seconds=commit_s, patched_hint_equal_b_stage=True,
        patched_db_equal_b_stage=True, patched_hint_equals_setup=True,
        peak_bytes=_peak(card), b_bytes=held_bytes(system)), counts


def m_timing(card, cfg, system, m_sys, queries):
    """Per-shard kernel times of M against their bounds, beside the four
    shards' launches together and B's one unsharded launch: the answer at
    B's 16 queries, the hint and the 5% delta.  Shard 0's answer is held
    bitwise against the plain version.  On one card the shards run one
    after another on its SMs: this shows placement, not scaling."""
    shards = m_sys.server.db
    rows, n = shards[0].shape
    k = system.cfg.params.k
    client = pir.PIRClient(system.cfg, system.hint,
                           a_mat=system.server.a_matrix)
    qs, _ = client.query_batch(_gen(card, 34), list(range(len(queries))))
    b = qs.shape[1]
    err = u32_max_abs_err(ops.modmatmul(shards[0], qs, impl=card.impl),
                          plain_modmatmul(shards[0], qs, cfg["plain_rows"]))
    if err:
        raise AssertionError(f"timing M: shard 0's answer, max err {err}")
    a_mat = system.server.a_matrix
    j = max(1, round(U_SHARES[0] * n))
    gen = _gen(card, 35)
    new, old = _u8(gen, (rows, j), card.dev), _u8(gen, (rows, j), card.dev)
    a_j = a_mat[:j]
    out = dict(phase="timing M", shards=len(shards), rows_per_shard=rows,
               device=(torch.cuda.get_device_name(0) if card.dev.type ==
                       "cuda" else "cpu"))
    for op, one, each, whole, bytes_, ops_ in (
            ("answer", lambda: ops.modmatmul(shards[0], qs, impl=card.impl),
             lambda: collectives.row_shard_gemm(shards, qs, impl=card.impl),
             lambda: ops.modmatmul(system.server.db, qs, impl=card.impl),
             rows * n + 4 * n * b + 4 * rows * b, 2 * rows * n * b * 4),
            ("hint", lambda: ops.hint_gemm(shards[0], a_mat, impl=card.impl),
             lambda: collectives.row_shard_gemm(shards, a_mat,
                                                impl=card.impl),
             lambda: ops.hint_gemm(system.server.db, a_mat, impl=card.impl),
             rows * n + 4 * n * k + 4 * rows * k, 2 * rows * n * k * 4),
            ("delta", lambda: ops.delta_gemm(new, old, a_j, impl=card.impl),
             lambda: collectives.row_shard_delta_gemm(
                 [new] * len(shards), [old] * len(shards), a_j,
                 impl=card.impl), None,
             2 * rows * j + 4 * j * k + 4 * rows * k, 2 * rows * j * k * 8)):
        reps = 2 if op == "hint" else 5
        bound, by = _bound(bytes_, ops_, INT8_OPS_PER_S)
        out[f"{op}_shard_ms"] = card.time_ms(one, reps=reps)
        out[f"{op}_all_shards_ms"] = card.time_ms(each, reps=reps)
        out[f"{op}_unsharded_ms"] = (None if whole is None
                                     else card.time_ms(whole, reps=reps))
        out[f"{op}_shard_bound_ms"] = bound
        out[f"{op}_shard_bound_by"] = by
    out.update(answer_shape=f"{rows}x{n}x{b}", hint_shape=f"{rows}x{n}x{k}",
               delta_shape=f"{rows}x{j}x{k}", shard0_answer_max_abs_err=err)
    return out


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
    loop = PIRServeLoop(live, max_batch=cfg["s_batch"], deadline_ms=1e9,
                        seed=9)
    return serve_script(card, cfg, loop, live, corp, "S")


def _signature(loop, epoch0=0):
    """Every response in order: rid, epoch (from ``epoch0``), retries,
    failure, and its top-k doc ids and texts."""
    return [(r.rid, r.epoch - epoch0, r.retries, r.failed,
             tuple((i, t) for i, _, t in r.top)) for r in loop.responses]


def serve_script(card, cfg, loop, live, corp, phase):
    """Phase S's requests and mutation batches through ``loop``, then one
    traced tick and a traced window of ``window_ticks`` full ticks (after
    `WINDOW_PRIME` untraced full ticks, so a pipelined engine of depth 2
    retires one batch a tick in it).  Returns (the phase line, the
    responses' signature)."""
    per_tick = cfg["s_batch"] // 2
    n_ticks = cfg["s_requests"] // per_tick
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
                raise AssertionError(f"phase {phase}: a mutation batch did "
                                     "not commit on its tick")
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

    def submit_batch():
        nonlocal offered
        for j in range(cfg["s_batch"]):
            d = anchors[j % len(anchors)]
            loop.submit(offered, live._docs[d][1], top_k=10)
            anchor_of[offered] = d
            offered += 1

    def window():
        for _ in range(cfg["window_ticks"]):
            submit_batch()
            loop.tick()

    depth = getattr(loop, "depth", 0)
    plan_syncs, sync_sites = None, []
    for i in range(WINDOW_PRIME):         # prime a pipeline of depth ≤ 2
        submit_batch()
        if i == 0 and depth:
            plan_syncs, sync_sites = plan_sync_count(card, loop.tick)
        else:
            loop.tick()
    w_wall, w_busy, _, _ = traced_ms(card, window)
    loop.drain()

    served = [r for r in loop.responses if not r.failed]
    if len(served) + loop.failed_requests != offered:
        raise AssertionError(f"phase {phase}: {len(served)} served + "
                             f"{loop.failed_requests} failed != {offered}")
    for r in served:
        d = anchor_of[r.rid]
        if d not in [i for i, _, _ in r.top]:
            raise AssertionError(f"phase {phase}: request {r.rid} (doc {d}) "
                                 f"not retrieved at epoch {r.epoch}")
        if r.epoch < inserted_at.get(d, 0):
            raise AssertionError(f"phase {phase}: doc {d} served before its "
                                 f"epoch")
    if not torch.equal(live.system.server.setup(), live.system.hint):
        raise AssertionError(f"phase {phase}: patched hint != setup()")
    timings = list({id(r.timing): r.timing for r in served}.values())

    def med_ms(attr):
        return 1e3 * float(np.median([getattr(t, attr) for t in timings]))

    line = dict(
        phase=phase, engine=loop.ENGINE, offered=offered, served=len(served),
        failed=loop.failed_requests, stale_retries=loop.stale_retries,
        epochs=live.epoch, batches=len(timings),
        inserted_anchors=len(inserted_at), encode_ms_median=med_ms("encode_s"),
        gemm_ms_median=med_ms("gemm_s"), decode_ms_median=med_ms("decode_s"),
        traced_tick_wall_ms=wall, device_kernel_ms=busy,
        device_idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms=top, window_ticks=cfg["window_ticks"],
        window_wall_ms=w_wall, window_device_kernel_ms=w_busy,
        window_idle_share=None if w_busy is None else 1.0 - w_busy / w_wall)
    if depth:
        line.update(depth=depth, plan_sync_warnings=plan_syncs,
                    plan_sync_sites=sync_sites)
    return line, _signature(loop)


def plan_sync_count(card, tick):
    """Run ``tick`` (a pipelined tick that plans and dispatches, retiring
    nothing) under ``torch.cuda.set_sync_debug_mode("warn")``: (the number
    of synchronizing calls it made, where each was made from); (None, [])
    off the card."""
    if card.dev.type != "cuda":
        tick()
        return None, []
    import traceback
    import warnings
    sites, armed = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if armed and "synchroniz" in str(message):
            stack = [f"{pathlib.Path(f.filename).name}:{f.lineno}"
                     for f in traceback.extract_stack()[:-1]
                     if "warnings" not in f.filename]
            sites.append(" < ".join(reversed(stack[-4:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        armed.append(True)                # the call above warns of itself
        try:
            tick()
        finally:
            armed.clear()
            torch.cuda.set_sync_debug_mode(0)
    return len(sites), sites


def phase_sp(card, cfg, live, corp, line_s, sig_s):
    """Phase S's script through `PipelinedServeLoop(depth=2)` on a clone of
    the index S started from: the same responses, epochs and retries as
    S."""
    loop = PipelinedServeLoop(live, max_batch=cfg["s_batch"], deadline_ms=1e9,
                              seed=9, depth=2)
    line, sig = serve_script(card, cfg, loop, live, corp, "SP")
    if sig != sig_s:
        bad = next(i for i, (a, b) in enumerate(zip(sig, sig_s)) if a != b) \
            if len(sig) == len(sig_s) else "count"
        raise AssertionError(f"phase SP: responses differ from S's ({bad})")
    for key in ("offered", "served", "failed", "stale_retries", "epochs"):
        if line[key] != line_s[key]:
            raise AssertionError(f"phase SP: {key} {line[key]} != S's "
                                 f"{line_s[key]}")
    sh = loop._shadow
    line.update(responses_equal_s=True, commits=sh.commits,
                stage_seconds=sh.stage_seconds, swap_seconds=sh.swap_seconds,
                s_window_idle_share=line_s["window_idle_share"],
                s_device_idle_share=line_s["device_idle_share"],
                s_encode_ms_median=line_s["encode_ms_median"],
                s_gemm_ms_median=line_s["gemm_ms_median"],
                s_decode_ms_median=line_s["decode_ms_median"])
    return line


def phase_sp_faults(card, cfg, live, corp):
    """One answer drop and one answer delay on the pipelined engine: the
    same responses as an unfaulted run, one retry charged per dropped
    request, none per delayed one."""
    n, n_batches = cfg["s_batch"], 4
    docs = [d for d, _ in _stable_docs(live, corp, np.random.default_rng(21),
                                       n)]

    def run(inj):
        loop = PipelinedServeLoop(live, max_batch=n, deadline_ms=1e9, seed=23,
                                  depth=2, faults=inj)
        for b in range(n_batches):
            for j, d in enumerate(docs):
                loop.submit(b * n + j, live._docs[d][1], top_k=10)
            loop.tick()
        loop.drain()
        live.faults = live.epochs.faults = None
        return loop

    def sig(loop):
        return sorted((r.rid, r.epoch, r.failed,
                       tuple((i, t) for i, _, t in r.top))
                      for r in loop.responses)

    clean = run(None)
    plan = faults_lib.FaultPlan((
        faults_lib.FaultEvent(faults_lib.SITE_ANSWER_DROP, at=0),
        faults_lib.FaultEvent(faults_lib.SITE_ANSWER_DELAY, at=1,
                              delay_s=0.02)))
    inj = plan.compile()
    t0 = time.perf_counter()
    faulted = run(inj)
    faulted_s = time.perf_counter() - t0
    metrics = faulted.obs.metrics_dict()
    charged = (sum(r.retries for r in faulted.responses)
               - sum(r.retries for r in clean.responses))
    if sig(faulted) != sig(clean):
        raise AssertionError("phase SP faults: responses differ from the "
                             "unfaulted run's")
    if len(inj.fired) != 2 or charged != n or \
            metrics.get("fleet.answer_drops") != n or \
            metrics.get("fleet.answer_delays") != n:
        raise AssertionError(f"phase SP faults: fired {len(inj.fired)}, "
                             f"charged {charged}, {metrics}")
    for r in faulted.responses:
        if docs[r.rid % n] not in [i for i, _, _ in r.top]:
            raise AssertionError(f"phase SP faults: request {r.rid} missed")
    return dict(phase="SP faults", offered=n * n_batches,
                served=sum(not r.failed for r in faulted.responses),
                dropped=metrics["fleet.answer_drops"],
                delayed=metrics["fleet.answer_delays"], delay_s=0.02,
                retries_charged=charged, faulted_run_seconds=faulted_s,
                responses_equal=True)


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


def phase_pp(card, cfg, live, corp, line_mem):
    """P's multi-probe requests and one routed one-cluster commit through
    the sync loop, then the same script through `PipelinedServeLoop(depth=2)`
    from the same state (each run ends by committing the mover's old text
    back): equal responses, epochs and retries, and after
    the pipelined commit every bucket hint equals setup()."""
    kappa, n = cfg["p_kappa"], cfg["p_batch"]
    pool = _stable_docs(live, corp, np.random.default_rng(24), n + 1)
    anchors, (mover, cluster) = [d for d, _ in pool[:n]], pool[n]
    original = live._docs[mover][0]
    revised = _revised(original, b"pp:")
    emb = live._docs[mover][1]

    def script(loop):
        e0, offered, expect = live.epoch, 0, {}

        def batch(extra=None):
            nonlocal offered
            for d in anchors + ([extra] if extra is not None else []):
                loop.submit(offered, live._docs[d][1], top_k=10,
                            multi_probe=kappa)
                expect[offered] = d
                offered += 1
            loop.tick()

        batch()
        loop.submit_mutation(journal.replace(mover, revised, emb))
        batch()
        batch(mover)
        batch()
        loop.drain()
        if live.epoch != e0 + 1 or live._docs[mover][0] != revised:
            raise AssertionError("phase PP: the routed commit did not land")
        checked = _bucket_checks(card, live, "phase PP")
        served = [r for r in loop.responses if not r.failed]
        if len(served) + loop.failed_requests != offered:
            raise AssertionError("phase PP: served + failed != offered")
        for r in served:
            hit = [t for i, _, t in r.top if i == expect[r.rid]]
            if not hit or (expect[r.rid] == mover and hit != [revised]):
                raise AssertionError(f"phase PP: request {r.rid} missed")
        timings = list({id(r.timing): r.timing for r in served}.values())
        sig = _signature(loop, e0)
        loop.submit_mutation(journal.replace(mover, original, emb))
        loop.tick()
        loop.drain()
        return sig, timings, offered, checked

    def med_ms(timings, attr):
        return 1e3 * float(np.median([getattr(t, attr) for t in timings]))

    sync = PIRServeLoop(live, max_batch=n, deadline_ms=1e9, seed=25)
    sig_s, t_s, offered, _ = script(sync)
    if card.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pipe = PipelinedServeLoop(live, max_batch=n, deadline_ms=1e9, seed=25,
                              depth=2)
    sig_p, t_p, _, checked = script(pipe)
    if sig_p != sig_s:
        raise AssertionError("phase PP: responses differ from the sync loop's")
    return dict(
        phase="PP", engine="pipelined", depth=2, kappa=kappa,
        offered=offered, served=sum(not r[3] for r in sig_p),
        failed=pipe.failed_requests, stale_retries=pipe.stale_retries,
        responses_equal_sync=True, batches=len(t_p), cluster=cluster,
        touched_buckets=list(live.system.batch.partition.buckets_of(cluster)),
        buckets_checked=checked, bucket_hints_equal_setup=True,
        sub_dbs_equal_host=True, commits=pipe._shadow.commits,
        stage_seconds=pipe._shadow.stage_seconds,
        swap_seconds=pipe._shadow.swap_seconds,
        encode_ms_median=med_ms(t_p, "encode_s"),
        gemm_ms_median=med_ms(t_p, "gemm_s"),
        decode_ms_median=med_ms(t_p, "decode_s"),
        sync_encode_ms_median=med_ms(t_s, "encode_s"),
        sync_gemm_ms_median=med_ms(t_s, "gemm_s"),
        sync_decode_ms_median=med_ms(t_s, "decode_s"),
        reckoned_peak_bytes=line_mem["reckoned_peak_bytes"],
        max_memory_allocated=(torch.cuda.max_memory_allocated()
                              if card.dev.type == "cuda" else None))


def p_stacked(card, cfg, live):
    """One batch of P's clients formed and decoded both ways from one seed:
    the per-client loop (`query` and `recover` per client: a GEMV per bucket
    per client, an H_b·s per placed bucket per client) and the stacked pass
    (`draw`, one A_b·S_b and one H_b·S_b per bucket).  Ciphertexts and
    columns must be bitwise equal, the columns equal to the sub-DBs';
    launches and ms of each way."""
    bp = live.system.batch
    n, kappa = cfg["p_batch"], cfg["p_kappa"]
    rng = np.random.default_rng(26)
    probes = [rng.choice(bp.partition.n_clusters, kappa,
                         replace=False).tolist() for _ in range(n)]

    def timed(fn):
        before = ops.launch_counts()
        card.sync()
        t0 = time.perf_counter()
        out = fn()
        card.sync()
        ms = 1e3 * (time.perf_counter() - t0)
        return out, ms, ops.launch_counts()["modmatmul_u32"] \
            - before["modmatmul_u32"]

    gen = torch.Generator(device=card.dev).manual_seed(27)
    per, enc_loop_ms, enc_loop = timed(
        lambda: [bp.client.query(gen, pr) for pr in probes])
    qs_loop = torch.stack([q for q, _ in per], dim=2)
    answers = bp.server.answer_batch(qs_loop)
    cols_loop, dec_loop_ms, dec_loop = timed(
        lambda: [bp.client.recover([a[:, c] for a in answers], st)
                 for c, (_, st) in enumerate(per)])
    gen = torch.Generator(device=card.dev).manual_seed(27)

    (qs, states), enc_ms, enc = timed(lambda: bp.client.encrypt(
        [bp.client.draw(gen, pr) for pr in probes]))
    decoded, dec_ms, dec = timed(lambda: bp.client.decode(answers, states))
    cols = decoded.columns()              # the stream has passed its copy
    if not torch.equal(qs, qs_loop):
        raise AssertionError("phase P: stacked ciphertexts != the loop's")
    for c, (_, st) in enumerate(per):
        if cols[c].keys() != cols_loop[c].keys():
            raise AssertionError("phase P: stacked decode placed otherwise")
        for b, cl in st.placement.items():
            want = bp.server.sub_dbs[b][:, bp.partition.position(b, cl)]
            if not (np.array_equal(cols[c][cl], cols_loop[c][cl])
                    and np.array_equal(cols[c][cl], want.cpu().numpy())):
                raise AssertionError(f"phase P: cluster {cl} decodes wrong "
                                     f"from bucket {b}")
    return dict(phase="P stacked", clients=n, n_buckets=bp.partition.n_buckets,
                placed=sum(len(st.placement) for _, st in per),
                loop_encode_u32_launches=enc_loop,
                loop_decode_u32_launches=dec_loop,
                stacked_encode_u32_launches=enc,
                stacked_decode_u32_launches=dec,
                loop_encode_ms=enc_loop_ms, loop_decode_ms=dec_loop_ms,
                stacked_encode_ms=enc_ms, stacked_decode_ms=dec_ms,
                ciphertexts_equal=True, columns_equal_loop=True,
                columns_equal_sub_dbs=True)


def p_sharded(card, cfg, live):
    """P's bucket layout (its partition, parameters and seeds) built again
    as `enable_batch` builds it: over ``m_shards`` shards with each sub-DB
    gathered from the host mirror onto the shard that owns it (LPT by
    bucket height), and unsharded from the flat DB on the card.  Of the
    bucket hints only the smallest bucket's is computed, through each
    server's own `_hint` (P's 40.6 GB are not rebuilt).  The sub-DBs, that
    hint and one served batch's bucket answers must be bitwise equal, with
    one grouped launch per shard that owns a bucket; the line gives the
    shards' useful rows max/mean for the sequential and the LPT layouts.
    A sharded server's bucket patches run in the CPU tests only."""
    system, bp = live.system, live.system.batch
    n, kappa, shards = cfg["p_batch"], cfg["p_kappa"], cfg["m_shards"]
    part = bp.partition
    kw = dict(a_seed=bp.server.a_seed, impl=bp.server.impl)
    rng = np.random.default_rng(28)
    gen = _gen(card, 29)
    qs, _ = bp.client.encrypt([bp.client.draw(
        gen, rng.choice(part.n_clusters, kappa,
                        replace=False).tolist()) for _ in range(n)])
    flat = BatchPIRServer(system.server.db, system.db.used_bytes, part,
                          bp.server.params, **kw)
    small = min(range(part.n_buckets), key=lambda b: flat.cfgs[b].m)
    want = flat.answer_batch(qs)
    hint_want = flat._hint(small, flat.sub_dbs[small])
    card.sync()
    t0 = time.perf_counter()
    server = BatchPIRServer(torch.from_numpy(system.db.matrix),
                            system.db.used_bytes, part, bp.server.params,
                            mesh=m_mesh(card, cfg), **kw)
    card.sync()
    build_s = time.perf_counter() - t0
    for b, (x, y) in enumerate(zip(server.sub_dbs, flat.sub_dbs)):
        if x.device != server.bucket_device(b) or not torch.equal(x, y):
            raise AssertionError(f"P sharded: bucket {b}'s sub-DB != the "
                                 f"unsharded build's")
    del flat
    if not torch.equal(server._hint(small, server.sub_dbs[small]),
                       hint_want):
        raise AssertionError(f"P sharded: bucket {small}'s hint on its "
                             f"owner != the unsharded one")
    del hint_want
    before = ops.launch_counts()["bucketed_modmatmul"]
    got = server.answer_batch(qs)
    launches = ops.launch_counts()["bucketed_modmatmul"] - before
    for b, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x, y):
            raise AssertionError(f"P sharded: bucket {b}'s answer != the "
                                 f"unsharded pass's")
    owners = sum(1 for s_ in range(shards) if s_ in server.shard_of)
    if card.impl == "cuda" and launches != owners:
        raise AssertionError(f"P sharded: {launches} grouped launches for "
                             f"{owners} shards")
    heights = [cfg_.m for cfg_ in server.cfgs]
    order = collectives.balanced_bucket_order(heights, shards)

    def imbalance(loads):
        return float(loads.max() / loads.mean())

    return dict(phase="P sharded", shards=shards,
                n_buckets=len(heights), clients=n, owner=server.shard_of,
                sharded_build_seconds=build_s, grouped_launches=launches,
                sub_dbs_equal_unsharded=True, hint_bucket=small,
                hint_equal_unsharded=True, answers_equal_unsharded=True,
                sequential_rows=collectives.shard_row_loads(
                    heights, shards).tolist(),
                lpt_rows=collectives.shard_row_loads(
                    heights, shards, order).tolist(),
                sequential_max_over_mean=imbalance(
                    collectives.shard_row_loads(heights, shards)),
                lpt_max_over_mean=imbalance(
                    collectives.shard_row_loads(heights, shards, order)))


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
    # one full batch alone in its tick: its modmatmul_u32 launches
    for _ in range(cfg["k_batch"]):
        rid = len(asks)
        asks[rid] = ((rng.zipf(1.2, size=kappa) - 1) % v).tolist()
        loop.submit_lookup(rid, asks[rid])
    before = ops.launch_counts()["modmatmul_u32"]
    loop.tick(force=True)
    u32_per_batch = ops.launch_counts()["modmatmul_u32"] - before
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
        u32_launches_per_batch=u32_per_batch,
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
# the paper's comparison: PIR-RAG, Tiptoe-style scoring and graph-PIR (G:
# Fig. 2's scale, Q: Fig. 3's quality regime)
# --------------------------------------------------------------------------

def _reset_peak(card):
    if card.dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(card):
    """Peak card bytes since `_reset_peak` (None in a rehearsal)."""
    if card.dev.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _free(card):
    """Return dropped systems' card memory to the device (nothing to do in a
    rehearsal)."""
    if card.dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def _gen(card, seed):
    return torch.Generator(device=card.dev).manual_seed(seed)


def g_reckon(corp, n_clusters, degree):
    """The card bytes each of G's systems holds, reckoned from the corpus
    before any build: DB, public matrix A (n, k) where the server holds
    one, and hints.  PIR-RAG's m is its largest cluster's bytes, known only
    after k-means, so it is reckoned at the mean column."""
    n, d = corp.embeddings.shape
    lens = np.fromiter(map(len, corp.texts), np.int64, n)
    k = LWE_K
    m_c = -(-(16 + d + int(lens.max())) // 64) * 64
    m_g = 8 + d + (degree + 4) * (4 + 8)
    mean_col = -(-(4 + int((16 + d + lens).sum()) // n_clusters) // 256) * 256
    return dict(content=m_c * n + 4 * n * k + 4 * m_c * k,
                graph=m_g * n + 4 * n * k + 4 * m_g * k,
                tiptoe=n * d + 4 * n * k + 4 * d * k,
                pir_rag_at_mean_column=mean_col * n_clusters
                + 4 * mean_col * k + 4 * n_clusters * k)


def _check_fetched(fetched, ids, corp, what):
    """Fetched (doc id, embedding, text) triples: the ids asked for, the
    corpus's text, and the dequantized original embedding, exactly."""
    if [f[0] for f in fetched] != [int(i) for i in ids]:
        raise AssertionError(f"{what}: fetched ids {[f[0] for f in fetched]}"
                             f" != {list(ids)}")
    for did, emb, text in fetched:
        want = chunking.dequantize_embedding(
            *chunking.quantize_embedding(corp.embeddings[did]))
        if text != corp.texts[did] or not np.array_equal(emb, want):
            raise AssertionError(f"{what}: doc {did} fetched wrong")


def g_clusters(cfg):
    """G's cluster count, `benchmarks/scalability.py`'s int(√n / 2)."""
    return max(4, int(np.sqrt(cfg["g_docs"]) / 2))


def q_clusters(cfg):
    """Q's cluster count, `benchmarks/quality.py`'s n // 15."""
    return max(8, cfg["q_docs"] // 15)


def _check_cluster(card, q, cents, got, what):
    """The query's cluster, as the kernel chose it, against a plain argmin
    of `clustering.pairwise_sqdist`: equal, unless the two distances lie
    within 1e-5 · (|q|² + |c|²) of each other (check_assign's tie rule)."""
    x = torch.as_tensor(np.asarray(q, np.float32), device=card.dev)[None]
    c = torch.as_tensor(np.asarray(cents, np.float32), device=card.dev)
    d2 = clustering.pairwise_sqdist(x, c)[0]
    want = int(torch.argmin(d2))
    if got != want:
        gap = float(d2[got] - d2[want])
        scale = float(torch.sum(x * x) + torch.sum(c[want] * c[want]))
        if gap > 1e-5 * scale:
            raise AssertionError(f"{what}: cluster {got} chosen, plain "
                                 f"argmin {want} (distance gap {gap})")


def _tiptoe_oracle(tsys, q, cl, top_k):
    """The ids the plaintext quantized products rank first in cluster cl."""
    dq = tsys.quant.unshift(tsys.cluster_mats[cl].cpu().numpy())
    qq = tsys.quant.unshift(tsys.quant.quantize(np.asarray(q, np.float32)))
    return tsys.cluster_doc_ids[cl][np.argsort(-(dq @ qq))[:top_k]]


def _record_fetches(gsys):
    """Wrap one graph system's per-hop fetch so every decoded record batch
    is kept beside the nodes asked for (for the gate against the DB)."""
    seen = []
    inner = gsys.fetch_records

    def recording(client, gen, nodes):
        cols, ms = inner(client, gen, nodes)
        seen.append((list(nodes), cols))
        return cols, ms

    gsys.fetch_records = recording
    return seen


def _check_records(card, gsys, seen, what):
    for nodes, cols in seen:
        want = gsys.server.db[:, torch.as_tensor(nodes, device=card.dev)]
        if not np.array_equal(cols, want.cpu().numpy()):
            raise AssertionError(f"{what}: a decoded graph record != its "
                                 f"plaintext column")
    return sum(len(nodes) for nodes, _ in seen)


def phase_g(card, cfg):
    """Fig. 2 at the largest corpus the baselines' byte PIR admits
    (`benchmarks/scalability.py`'s formulas): the content PIR both
    baselines owe for RAG, then PIR-RAG, Tiptoe-style and graph-PIR, each
    built, queried and gated.  PIR-RAG is dropped after its queries; the
    other three are returned for `g_timing` (launch counts are read
    first)."""
    t_phase = time.perf_counter()
    n, d, top_k = cfg["g_docs"], cfg["g_emb_dim"], 10
    t0 = time.perf_counter()
    corp = corpus_lib.make_corpus(0, n, emb_dim=d, n_topics=cfg["g_topics"],
                                  text_len=cfg["g_text"])
    corpus_s = time.perf_counter() - t0
    n_clusters = g_clusters(cfg)
    degree = 12
    picks = [qi * 7 for qi in range(cfg["g_queries"])]
    reckoned = g_reckon(corp, n_clusters, degree)
    lines = [dict(phase="G memory", docs=n, emb_dim=d, n_clusters=n_clusters,
                  reckoned_bytes=reckoned, corpus_seconds=corpus_s)]

    def system_line(name, held, qt, rt, **kw):
        return dict(phase="G system", system=name,
                    query_s=float(np.median(qt)),
                    rag_ready_s=float(np.median(rt)), queries=len(qt),
                    held_bytes=held, max_memory_allocated=_peak(card), **kw)

    _reset_peak(card)
    t0 = time.perf_counter()
    content = baseline_common.DocContentPIR.build(corp.texts, corp.embeddings,
                                                  device=card.dev)
    card.sync()
    content_s = time.perf_counter() - t0
    ccfg = content.cfg
    if ccfg.params.p != 256:
        raise AssertionError(f"phase G: content PIR p = {ccfg.params.p}")
    content_held = ccfg.m * ccfg.n + 4 * ccfg.n * LWE_K + ccfg.hint_bytes
    lines.append(dict(phase="G content", m=ccfg.m, n=ccfg.n, p=ccfg.params.p,
                      build_seconds=content_s,
                      per_fetch_uplink=content.per_fetch_uplink,
                      per_fetch_downlink=content.per_fetch_downlink,
                      held_bytes=content_held,
                      max_memory_allocated=_peak(card)))

    # PIR-RAG: content arrives with the retrieval
    _reset_peak(card)
    system = pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                         n_clusters=n_clusters, seed=0,
                                         device=card.dev)
    qt = []
    for qi, i in enumerate(picks):
        t0 = time.perf_counter()
        top, st = system.query(corp.embeddings[i], top_k=top_k,
                               generator=_gen(card, qi))
        qt.append(time.perf_counter() - t0)
        if i not in [doc for doc, _, _ in top]:
            raise AssertionError(f"phase G: PIR-RAG lost doc {i} from its "
                                 f"own query's top-{top_k}")
    lines.append(system_line(
        "pir_rag", held_bytes(system) + content_held, qt, qt,
        setup_s=system.setup_seconds, index_s=system.index_seconds,
        hint_s=system.hint_seconds, kmeans_s=system.kmeans_seconds,
        pack_s=system.pack_seconds, uplink=st.uplink_bytes,
        downlink=st.downlink_bytes, hint_bytes=st.hint_bytes, m=system.db.m,
        n=system.db.n, own_doc_in_top10=len(picks)))
    del system, top
    _free(card)

    # Tiptoe-style: scores, then K content fetches
    _reset_peak(card)
    tsys = tiptoe.TiptoeSystem.build(corp.embeddings, n_clusters=n_clusters,
                                     seed=0, device=card.dev)
    qt, rt = [], []
    for qi, i in enumerate(picks):
        q = corp.embeddings[i]
        t0 = time.perf_counter()
        ids, st = tsys.search(q, top_k=top_k, generator=_gen(card, qi))
        t1 = time.perf_counter()
        fetched = content.fetch_many(qi, ids[:top_k])
        t2 = time.perf_counter()
        qt.append(t1 - t0)
        rt.append(t2 - t0)
        _check_cluster(card, q, tsys.centroids, st.cluster_index,
                       f"phase G: Tiptoe query {qi}")
        if not np.array_equal(ids, _tiptoe_oracle(tsys, q, st.cluster_index,
                                                  top_k)):
            raise AssertionError(f"phase G: Tiptoe query {qi} ranks unlike "
                                 f"its plaintext quantized products")
        _check_fetched(fetched, ids[:top_k], corp, "phase G tiptoe")
    sizes = [len(ids) for ids in tsys.cluster_doc_ids]
    lines.append(system_line(
        "tiptoe", n * d + 4 * n * LWE_K + content_held, qt, rt,
        setup_s=tsys.setup_seconds, index_s=tsys.setup_seconds, hint_s=None,
        uplink=st.uplink_bytes, downlink=st.downlink_bytes,
        fetch_uplink=top_k * content.per_fetch_uplink,
        fetch_downlink=top_k * content.per_fetch_downlink,
        levels=tsys.quant.levels, max_cluster_docs=max(sizes),
        empty_clusters=sizes.count(0), clusters_equal_plain=len(picks),
        ids_equal_plaintext=len(picks)))

    # graph-PIR: a private walk, then K content fetches
    _reset_peak(card)
    gsys = graph_pir.GraphPIRSystem.build(corp.embeddings, degree=degree,
                                          seed=0, device=card.dev)
    if gsys.cfg.params.p != 256:
        raise AssertionError(f"phase G: graph PIR p = {gsys.cfg.params.p}")
    seen = _record_fetches(gsys)
    qt, rt, hops = [], [], []
    for qi, i in enumerate(picks):
        t0 = time.perf_counter()
        ids, st = gsys.search(corp.embeddings[i], top_k=top_k, beam=8,
                              max_hops=5, seed=qi)
        t1 = time.perf_counter()
        fetched = content.fetch_many(1000 + qi, ids[:top_k])
        t2 = time.perf_counter()
        qt.append(t1 - t0)
        rt.append(t2 - t0)
        hops.append(st.hops)
        _check_fetched(fetched, ids[:top_k], corp, "phase G graph")
    del gsys.fetch_records
    checked = _check_records(card, gsys, seen, "phase G")
    gcfg = gsys.cfg
    lines.append(system_line(
        "graph_pir", gcfg.m * gcfg.n + 4 * gcfg.n * LWE_K + gcfg.hint_bytes
        + content_held, qt, rt,
        setup_s=gsys.setup_seconds, index_s=gsys.index_seconds,
        hint_s=gsys.hint_seconds, uplink=st.uplink_bytes,
        downlink=st.downlink_bytes,
        fetch_uplink=top_k * content.per_fetch_uplink,
        fetch_downlink=top_k * content.per_fetch_downlink,
        m=gcfg.m, n=gcfg.n, p=gcfg.params.p, hops=hops,
        entry_points=len(gsys.entry_points), records_checked=checked))
    lines.append(dict(phase="G", seconds=time.perf_counter() - t_phase,
                      docs=n, systems=3, gates_passed=True))
    return lines, dict(corp=corp, content=content, tiptoe=tsys, graph=gsys)


def _mod_line(card, op, left, right, got, rows, reps):
    """One main-path product of phase G (``got``, the product the path
    made) held bitwise on ``rows`` random rows against the plain version,
    then the kernel timed at that shape beside its bound."""
    u8 = left.dtype == torch.uint8
    m, n = left.shape
    b = right.shape[1]
    gen = torch.Generator(device="cpu").manual_seed(m + n + b)
    idx = torch.randperm(m, generator=gen)[:rows].to(card.dev)
    want, plain_ms = card.once_ms(lambda: ref.modmatmul_ref(left[idx],
                                                            right))
    err = u32_max_abs_err(got[idx], want)
    if err:
        raise AssertionError(f"phase G {op}: kernel != plain on sampled "
                             f"rows (max err {err})")
    fn = ((lambda: ops.modmatmul(left, right, impl=card.impl)) if u8 else
          (lambda: ops.mod_u32_matmul(left, right, impl=card.impl)))
    ms = card.time_ms(fn, reps=reps)
    if u8:
        bytes_, ops_ = m * n + 4 * n * b + 4 * m * b, 2 * m * n * b * 4
    else:
        bytes_, ops_ = 4 * (m * n + n * b + m * b), 2 * m * n * b * 10
    bound, by = _bound(bytes_, ops_, INT8_OPS_PER_S)
    return dict(phase="timing G", op=op,
                kernel="modmatmul_u8" if u8 else "modmatmul_u32",
                shape=f"{m}x{n}x{b}", ms=ms, bound_ms=bound, bound_by=by,
                sample_rows=len(idx), plain_sample_ms=plain_ms,
                max_abs_err=err)


def knn_check(card, corp, gsys, rows):
    """The graph's k-NN neighbours of ``rows`` sampled nodes, read from
    their records on the card, against a float64 recompute of the
    similarities: the same similarity sequence within 1e-6, so any
    difference is a swap of near-ties."""
    deg, d = 12, gsys.emb_dim
    n = gsys.n_docs
    idx = np.random.default_rng(21).choice(n, min(rows, n), replace=False)
    recs = gsys.server.db[8 + d:8 + d + 4 * deg,
                          torch.as_tensor(idx, device=card.dev)]
    got = recs.t().contiguous().cpu().numpy().view("<u4").astype(np.int64)
    x = torch.from_numpy(corp.embeddings).to(card.dev, torch.float64)
    x = x / (x.norm(dim=1, keepdim=True) + 1e-12)
    sims = x[torch.as_tensor(idx, device=card.dev)] @ x.T
    sims[torch.arange(len(idx), device=card.dev),
         torch.as_tensor(idx, device=card.dev)] = -torch.inf
    want = torch.topk(sims, deg, dim=1).indices
    s_got = torch.gather(sims, 1, torch.as_tensor(got, device=card.dev))
    s_want = torch.gather(sims, 1, want)
    gap = float((s_got - s_want).abs().max())
    differ = int((torch.as_tensor(got, device=card.dev) != want).any(1).sum())
    if gap > 1e-6:
        raise AssertionError(f"phase G k-NN: similarity sequence off by "
                             f"{gap} against float64")
    return dict(phase="G knn", rows=len(idx), rows_differing=differ,
                max_similarity_gap=gap, tolerance=1e-6)


def g_timing(card, cfg, kept):
    """G's new shapes, after G's launch counts are read: every product the
    content and graph PIRs and Tiptoe ran, held on sampled rows against
    the plain version and timed; then the k-NN graph's check."""
    rows = cfg["g_sample_rows"]
    content, gsys, tsys = kept["content"], kept["graph"], kept["tiptoe"]
    lines = []
    for name, server, hint, b in (("content", content.server, content.hint,
                                   1),
                                  ("graph", gsys.server, gsys.hint, 8)):
        db, a_mat = server.db, server.a_matrix
        lines.append(_mod_line(card, f"{name} hint", db, a_mat, hint, rows,
                               reps=3))
        client = pir.PIRClient(server.cfg, hint, a_mat=a_mat)
        nodes = list(range(0, server.cfg.n, max(1, server.cfg.n // b)))[:b]
        qs, secrets = client.query_batch(_gen(card, 23), nodes)
        what = "fetch answer" if name == "content" else "hop answer"
        lines.append(_mod_line(card, f"{name} {what}", db, qs,
                               ops.modmatmul(db, qs, impl=card.impl), rows,
                               reps=10))
        lines.append(_mod_line(card, f"{name} query A·S", a_mat, secrets,
                               ops.mod_u32_matmul(a_mat, secrets,
                                                  impl=card.impl),
                               rows, reps=10))
        del qs, secrets
    big = max(range(len(tsys.cluster_mats)),
              key=lambda j: tsys.cluster_mats[j].shape[0])
    dmat = tsys.cluster_mats[big]
    lines.append(_mod_line(card, "tiptoe hint", dmat, tsys.a_mat,
                           tsys.hints[big], dmat.shape[0], reps=10))
    q = tsys.quant.quantize(kept["corp"].embeddings[0])
    ct, _ = baseline_common.encrypt_embedding(_gen(card, 24), q, tsys.params,
                                              tsys.a_mat, impl=card.impl)
    lines.append(_mod_line(card, "tiptoe score", dmat, ct[:, None],
                           ops.modmatmul(dmat, ct[:, None], impl=card.impl),
                           dmat.shape[0], reps=20))
    lines.append(knn_check(card, kept["corp"], gsys, cfg["g_knn_rows"]))
    return lines


def phase_q(card, cfg):
    """Fig. 3's regime (`benchmarks/quality.py`): NDCG@10, P@10, R@50,
    retrieval and RAG-ready seconds of the three systems on one corpus;
    PIR-RAG and Tiptoe averaged over builds, graph-PIR built once.
    PIR-RAG's RAG-ready time is its retrieval time by construction: its
    content comes with the ids.  Gated: each Tiptoe query's cluster equals
    a plain argmin and its ids the plaintext quantized ranking, both
    baselines pay a fetch tail, every fetched document is exact.  The
    quality ordering is printed, not gated."""
    t_phase = time.perf_counter()
    n, top_k = cfg["q_docs"], 10
    corp = corpus_lib.make_corpus(0, n, emb_dim=cfg["q_emb_dim"], n_topics=50,
                                  text_len=cfg["q_text"], topic_spread=1.0,
                                  encoder_noise=0.3)
    qs = corpus_lib.make_queries(1, corp, cfg["q_queries"], n_relevant=30,
                                 noise=0.4, topical=False)
    n_clusters = q_clusters(cfg)
    gsys = graph_pir.GraphPIRSystem.build(corp.embeddings, degree=24,
                                          n_entry=16, seed=0,
                                          device=card.dev)
    content = baseline_common.DocContentPIR.build(corp.texts, corp.embeddings,
                                                  device=card.dev)
    out = {s: dict(ndcg=[], p=[], r=[], t_ret=[], t_ready=[])
           for s in ("pir_rag", "tiptoe", "graph_pir")}

    def score(name, ids, qi, t_ret, t_ready):
        rel, gains = qs.relevant[qi], qs.gains[qi]
        d = out[name]
        d["ndcg"].append(metrics.ndcg_at_k(ids, rel, gains, top_k))
        d["p"].append(metrics.precision_at_k(ids, rel, top_k))
        d["r"].append(metrics.recall_at_k(ids, rel, 50))
        d["t_ret"].append(t_ret)
        d["t_ready"].append(t_ready)

    tiptoe_checked = 0
    for bi in range(cfg["q_builds"]):
        bseed = 100 * bi
        sysm = pipeline.PirRagSystem.build(corp.texts, corp.embeddings,
                                           n_clusters=n_clusters, seed=bseed,
                                           device=card.dev)
        tsys = tiptoe.TiptoeSystem.build(corp.embeddings,
                                         n_clusters=n_clusters, seed=bseed,
                                         device=card.dev)
        for qi in range(cfg["q_queries"]):
            q = qs.embeddings[qi]
            t0 = time.perf_counter()
            top, _ = sysm.query(q, top_k=top_k, generator=_gen(card, qi))
            t1 = time.perf_counter()
            score("pir_rag", np.array([doc for doc, _, _ in top]), qi,
                  t1 - t0, t1 - t0)        # the content came with the ids

            t0 = time.perf_counter()
            ids, st = tsys.search(q, top_k=top_k, generator=_gen(card, qi))
            t1 = time.perf_counter()
            fetched = content.fetch_many(qi, ids[:top_k])
            t2 = time.perf_counter()
            what = f"phase Q: Tiptoe build {bi} query {qi}"
            _check_cluster(card, q, tsys.centroids, st.cluster_index, what)
            if not np.array_equal(ids, _tiptoe_oracle(
                    tsys, q, st.cluster_index, top_k)):
                raise AssertionError(f"{what} ranks unlike its plaintext "
                                     f"quantized products")
            tiptoe_checked += 1
            _check_fetched(fetched, ids[:top_k], corp, "phase Q tiptoe")
            score("tiptoe", ids, qi, t1 - t0, t2 - t0)

            if bi > 0:
                continue      # graph-PIR has no cluster seed: built once
            t0 = time.perf_counter()
            ids, _ = gsys.search(q, top_k=top_k, beam=32, max_hops=12,
                                 seed=qi)
            t1 = time.perf_counter()
            fetched = content.fetch_many(1000 + qi, ids[:top_k])
            t2 = time.perf_counter()
            _check_fetched(fetched, ids[:top_k], corp, "phase Q graph")
            score("graph_pir", ids, qi, t1 - t0, t2 - t0)
        del sysm, tsys
    rows = {s: dict(ndcg10=float(np.mean(d["ndcg"])),
                    p10=float(np.mean(d["p"])), r50=float(np.mean(d["r"])),
                    t_retrieval_s=float(np.mean(d["t_ret"])),
                    t_rag_ready_s=float(np.mean(d["t_ready"])),
                    queries=len(d["ndcg"]))
            for s, d in out.items()}
    for s in ("tiptoe", "graph_pir"):
        if not all(b > a for a, b in zip(out[s]["t_ret"], out[s]["t_ready"])):
            raise AssertionError(f"phase Q: {s} paid no fetch tail")
    order = sorted(rows, key=lambda s: -rows[s]["ndcg10"])
    lines = [dict(phase="Q system", system=s, **r) for s, r in rows.items()]
    lines.append(dict(phase="Q", seconds=time.perf_counter() - t_phase,
                      docs=n, emb_dim=cfg["q_emb_dim"], n_clusters=n_clusters,
                      builds=cfg["q_builds"], queries=cfg["q_queries"],
                      ndcg10_order=order,
                      paper_order_holds=order == ["graph_pir", "pir_rag",
                                                  "tiptoe"],
                      tiptoe_clusters_and_ids_checked=tiptoe_checked))
    return lines


# --------------------------------------------------------------------------
# R: the RAG generation stage after a real retrieval
# --------------------------------------------------------------------------

def r_model_config(cfg):
    """R's decoder: the port's Qwen3-4B `FULL` width, or `Generator.tiny`'s
    widths in a rehearsal; float32 compute either way."""
    if cfg["r_model"] == "qwen3-4b":
        return qwen3_4b.FULL
    return rag_generate.tiny_config()


def _top2_gap(scores: torch.Tensor) -> np.ndarray:
    top = torch.topk(scores, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


def _per_step_agree(tokens, scores, tol, what):
    """Each token equals the argmax of its step's scores (B, N, V) wherever
    their top-2 gap exceeds 2·tol; returns (near-ties, tokens that differ
    at one)."""
    want = torch.argmax(scores, dim=-1).cpu().numpy()
    gap = _top2_gap(scores)
    differ = tokens != want
    if (differ & (gap > 2 * tol)).any():
        b, s = np.argwhere(differ & (gap > 2 * tol))[0]
        raise AssertionError(f"phase R: {what}: row {b} step {s} token "
                             f"{tokens[b, s]} != argmax {want[b, s]} (top-2 "
                             f"gap {gap[b, s]:.3g} > {2 * tol:.3g})")
    return int((gap <= 2 * tol).sum()), int(differ.sum())


def _first_split_agree(got, ref, gap, tol, what):
    """Token rows ``got`` and ``ref`` (B, N) agree up to a row's first
    difference, which must sit on a near-tie of the reference's scores
    (``gap`` (B, N) at most 2·tol).  Returns the rows equal throughout."""
    equal = 0
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b] != ref[b])
        if not diff.size:
            equal += 1
        elif gap[b, diff[0]] > 2 * tol:
            raise AssertionError(f"phase R: {what}: row {b} splits at step "
                                 f"{diff[0]} off a near-tie (top-2 gap "
                                 f"{gap[b, diff[0]]:.3g})")
    return equal


def _teacher_forced(gen, grid, lengths, tokens):
    """Prefill's logits and each decode step's, fed ``tokens`` (B, N):
    (B, N, V) float32 on the card."""
    state = gen.prefill(grid, lengths)
    cache, lens = state.cache, state.lengths
    toks = torch.as_tensor(tokens, device=gen.device).long()
    out = [state.logits]
    for s in range(1, gen.max_new_tokens):
        logits, cache = transformer.decode_step(
            gen.params, cache, toks[:, s - 1], lens + (s - 1), gen.cfg)
        out.append(logits)
    return torch.stack(out, dim=1)


def _forward_at_steps(gen, grid, lengths, tokens):
    """One teacher-forced `forward` over prompt + generated tokens
    (B, S + N): the logits (B, N, V) at each generation step's position."""
    B, S = grid.shape
    N = tokens.shape[1]
    full_grid = np.full((B, S + N), rag_prompt.PAD, np.int64)
    full_grid[:, :S] = grid
    for b in range(B):
        full_grid[b, lengths[b]:lengths[b] + N] = tokens[b]
    x, _ = transformer.forward(
        gen.params, torch.as_tensor(full_grid, device=gen.device), gen.cfg)
    logits = transformer.logits_from_hidden(gen.params, x, gen.cfg)
    pos = torch.as_tensor(lengths[:, None] - 1 + np.arange(N)[None],
                          dtype=torch.int64, device=gen.device)
    rows = torch.arange(B, device=gen.device)[:, None]
    return logits[rows, pos]


def _sampled_scores(gen, rid, logits):
    """The sampler's scores for one row: its Gumbel noise + logits / T,
    (N, V), from that row's logits (N, V)."""
    noise = torch.cat([rag_generate.gumbel_noise(
        gen._root_key, [rid], s, logits.shape[-1], gen.device)
        for s in range(gen.max_new_tokens)])
    return noise + logits / gen.temperature


def r_bounds(mcfg, params, lengths, budget, new):
    """Phase R's bounds on the H100 SXM peaks, each (ms, limit).

    Prefill of the real tokens: 2 FLOP per non-embedding weight per token
    of ``lengths``, causal attention over each row's own length (2·hd FLOP
    per (query, key) pair for the scores and as many for the values, per
    head and layer), the tied head at B rows; bytes: every weight read
    once and each token's K and V written.  The same over the padded
    (B, budget) grid with full budget × budget attention, as prefill runs
    it.  Decode step: every weight read once (the tied embedding as the
    head) and the cache up to the rows' mean length over the steps,
    against 2 FLOP per weight per row."""
    n_all = sum(t.numel() for t in _leaves(params))
    n_embed = mcfg.vocab * mcfg.d_model
    L, H, KV, hd = mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    lengths = np.asarray(lengths, np.int64)
    batch = len(lengths)

    def prefill(tokens, pairs):
        ops_ = (2 * (n_all - n_embed) * tokens + 4 * hd * H * L * pairs
                + 2 * n_embed * batch)
        return _bound(4 * n_all + 4 * tokens * (1 + 2 * KV * hd * L), ops_,
                      FP32_FLOPS_PER_S)

    real = prefill(int(lengths.sum()), int((lengths * (lengths + 1) // 2)
                                           .sum()))
    padded = prefill(batch * budget, batch * budget * budget)
    mean_ctx = float(np.mean(lengths)) + (new - 1) / 2
    cache_bytes = 4 * 2 * KV * hd * L * batch * mean_ctx
    step = _bound(4 * n_all + cache_bytes, 2 * n_all * batch,
                  FP32_FLOPS_PER_S)
    return real, padded, step


def _decode_steps_ms(card, gen, state, cur, n):
    """Host and device milliseconds a decode step over ``n`` steps from
    ``state``: the host's time to issue them, the time until the card has
    finished them, and CUDA events around them (None off the card)."""
    cache, lens = state.cache, state.lengths
    card.sync()
    events = None
    if card.dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    for s in range(n):
        transformer.decode_step(gen.params, cache, cur, lens + s, gen.cfg)
    t1 = time.perf_counter()
    if events:
        events[1].record()
    card.sync()
    t2 = time.perf_counter()
    return dict(issue_ms=1e3 * (t1 - t0) / n, step_ms=1e3 * (t2 - t0) / n,
                device_ms=events[0].elapsed_time(events[1]) / n
                if events else None)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_r(card, cfg):
    """The RAG path end to end: PIR-RAG retrieval (`rag_bench`'s full
    shape), the retrieved texts packed into byte prompts, and a float32
    decoder (Qwen3-4B width on the card) prefilling them and decoding from
    its KV cache.  Gates: texts equal the corpus's, packing accounts for
    every byte, prefill's and each decode step's logits agree with one
    teacher-forced `forward`, greedy tokens are its argmax off near-ties,
    `generate_nocache` gives the same tokens, and two rows generated alone
    (greedy and sampled) equal the same rows in the batch off near-ties."""
    t_phase = time.perf_counter()
    _reset_peak(card)
    n, B, new = cfg["r_docs"], cfg["r_batch"], cfg["r_new"]
    spec = rag_prompt.PromptSpec(cfg["r_budget"])
    corp = corpus_lib.make_corpus(0, n, emb_dim=cfg["r_emb_dim"],
                                  n_topics=cfg["r_topics"])
    system, build_ms = card.once_ms(lambda: pipeline.PirRagSystem.build(
        corp.texts, corp.embeddings, n_clusters=cfg["r_clusters"],
        device=card.dev))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, n, cfg["r_requests"])
    mcfg = r_model_config(cfg)
    params, init_ms = card.once_ms(lambda: transformer.init(
        _gen(card, 7), mcfg, device=card.dev))
    gen = rag_generate.Generator(params, mcfg, spec=spec,
                                 max_new_tokens=new, device=card.dev)
    n_params = sum(t.numel() for t in _leaves(params))
    retrieve_gen = _gen(card, 5)

    lines, batches = [], []
    for j in range(cfg["r_requests"] // B):
        rids = list(range(j * B, (j + 1) * B))
        tops, retrieve_ms = card.once_ms(lambda: system.query_batch(
            corp.embeddings[ids[rids]], top_k=3, generator=retrieve_gen))
        for top in tops:
            for did, _, text in top:
                if text != corp.texts[did]:
                    raise AssertionError(f"phase R: doc {did} retrieved "
                                         f"wrong")
        (grid, lengths, prompts), pack_ms = card.once_ms(
                                                     lambda: gen.pack(tops))
        for top, p in zip(tops, prompts):
            offered = sum(len(t) for _, _, t in top)
            if p.packed_bytes + p.dropped_bytes != offered or \
                    p.length > spec.context_budget:
                raise AssertionError("phase R: packing lost bytes or "
                                     "overran the budget")
        state, prefill_ms = card.once_ms(lambda: gen.prefill(grid,
                                                               lengths))
        tokens, decode_ms = card.once_ms(lambda: gen.decode(state, rids))
        batches.append((rids, tops, grid, lengths, tokens))
        lines.append(dict(
            phase="R batch", batch=j, requests=B, retrieve_ms=retrieve_ms,
            pack_ms=pack_ms, prefill_ms=prefill_ms, decode_ms=decode_ms,
            decode_step_ms=decode_ms / max(1, new - 1),
            ttft_ms=retrieve_ms + pack_ms + prefill_ms,
            tokens_per_s=B * new / (1e-3 * (prefill_ms + decode_ms)),
            prompt_tokens=int(lengths.sum()),
            docs_packed=sum(p.n_docs for p in prompts),
            docs_dropped=sum(p.n_docs_dropped for p in prompts)))

    # logits against one teacher-forced forward, tokens against its argmax
    err_pre = err_dec = 0.0
    near = differ = 0
    for rids, tops, grid, lengths, tokens in batches:
        forced = _teacher_forced(gen, grid, lengths, tokens)
        full = _forward_at_steps(gen, grid, lengths, tokens)
        err_pre = max(err_pre, float((forced[:, 0] - full[:, 0]).abs().max()))
        err_dec = max(err_dec, float((forced[:, 1:] - full[:, 1:])
                                     .abs().max()))
        nt, df = _per_step_agree(tokens, full, R_ATOL_DECODE, "greedy tokens")
        near, differ = near + nt, differ + df
    if err_pre > R_ATOL_PREFILL or err_dec > R_ATOL_DECODE:
        raise AssertionError(f"phase R: logits off the full forward by "
                             f"{err_pre:.3g} (prefill, atol "
                             f"{R_ATOL_PREFILL}) / {err_dec:.3g} (decode, "
                             f"atol {R_ATOL_DECODE})")

    # the cache-free path, and rows alone against the same rows batched
    rids, tops, grid, lengths, tokens = batches[0]
    full = _forward_at_steps(gen, grid, lengths, tokens)
    nocache, nocache_ms = card.once_ms(lambda: gen.generate_nocache(tops,
                                                                      rids))
    nocache_equal = _first_split_agree(nocache, tokens, _top2_gap(full),
                                       R_ATOL_DECODE, "generate_nocache")
    sampler = rag_generate.Generator(params, mcfg, spec=spec,
                                     max_new_tokens=new,
                                     temperature=R_TEMPERATURE, seed=11,
                                     device=card.dev)
    sampled = sampler.generate(tops, rids)
    forced = {"greedy": _teacher_forced(gen, grid, lengths, tokens),
              "sampled": _teacher_forced(sampler, grid, lengths, sampled)}
    alone = dict(greedy=dict(equal=0, dlogit=0.0),
                 sampled=dict(equal=0, dlogit=0.0))
    for r in sorted({0, B - 1}):
        one = slice(r, r + 1)
        for mode, g, batched in (("greedy", gen, tokens),
                                 ("sampled", sampler, sampled)):
            got = g.generate(tops[one], rids[one])
            solo = _teacher_forced(g, grid[one], lengths[one], batched[one])
            row = forced[mode][r]
            scores, tol = row[None], R_ATOL_DECODE
            if mode == "sampled":
                scores = _sampled_scores(g, rids[r], row)[None]
                tol = R_ATOL_DECODE / R_TEMPERATURE
                _per_step_agree(batched[one], scores, tol, "sampled tokens")
            alone[mode]["dlogit"] = max(alone[mode]["dlogit"], float(
                (solo[0] - row).abs().max()))
            alone[mode]["equal"] += _first_split_agree(
                got, batched[one], _top2_gap(scores), tol,
                f"row {r} alone ({mode})")
    peak = _peak(card)
    # one decode step of the last batch under the profiler, between two
    # untraced runs of R_HOST_STEPS steps: device time against wall time
    # says whether the step waits on the host, the two runs whether a
    # finished profiler session slows later launches
    rids, tops, grid, lengths, tokens = batches[-1]
    state = gen.prefill(grid, lengths)
    cur = torch.as_tensor(tokens[:, 0], device=card.dev)
    before = _decode_steps_ms(card, gen, state, cur, R_HOST_STEPS)
    step_wall, step_dev, step_top, _ = traced_ms(
        card, lambda: transformer.decode_step(gen.params, state.cache, cur,
                                              state.lengths, mcfg))
    after = _decode_steps_ms(card, gen, state, cur, R_HOST_STEPS)
    (pre_ms, pre_by), (pad_ms, pad_by), (step_ms, step_by) = r_bounds(
        mcfg, params, batches[-1][3], spec.context_budget, new)
    warm = lines[-1]
    lines.append(dict(
        phase="R", seconds=time.perf_counter() - t_phase,
        card=device_line() if card.dev.type == "cuda" else None,
        model=mcfg.name,
        n_layers=mcfg.n_layers, d_model=mcfg.d_model, vocab=mcfg.vocab,
        params=n_params, param_bytes=4 * n_params, docs=n,
        n_clusters=cfg["r_clusters"], requests=cfg["r_requests"], batch=B,
        context_budget=spec.context_budget, max_new_tokens=new,
        build_ms=build_ms, init_ms=init_ms,
        texts_checked=sum(len(t) for b in batches for t in b[1]),
        retrieve_ms=warm["retrieve_ms"], prefill_ms=warm["prefill_ms"],
        decode_step_ms=warm["decode_step_ms"], ttft_ms=warm["ttft_ms"],
        tokens_per_s=warm["tokens_per_s"],
        prompt_tokens=warm["prompt_tokens"],
        prefill_bound_ms=pre_ms, prefill_bound_by=pre_by,
        prefill_padded_bound_ms=pad_ms, prefill_padded_bound_by=pad_by,
        decode_step_bound_ms=step_ms, decode_step_bound_by=step_by,
        traced_step_wall_ms=step_wall, traced_step_device_ms=step_dev,
        traced_step_top=[(name[:72], ms) for name, ms in step_top],
        untraced_steps=R_HOST_STEPS, steps_before_trace=before,
        steps_after_trace=after,
        peak_card_bytes=peak, prefill_max_abs_err=err_pre,
        decode_max_abs_err=err_dec, atol_prefill=R_ATOL_PREFILL,
        atol_decode=R_ATOL_DECODE, greedy_near_ties=near,
        greedy_differ_at_near_ties=differ, nocache_ms=nocache_ms,
        nocache_rows_equal=nocache_equal, alone_rows=len({0, B - 1}),
        alone_greedy_rows_equal=alone["greedy"]["equal"],
        alone_greedy_max_dlogit=alone["greedy"]["dlogit"],
        alone_sampled_rows_equal=alone["sampled"]["equal"],
        alone_sampled_max_dlogit=alone["sampled"]["dlogit"],
        temperature=R_TEMPERATURE))
    return lines


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

    # phase M sets the counts to 0 and reads them around its own path
    m_sys, m_live, line_m, paths["M"] = phase_m(card, cfg, system, corp,
                                                queries)
    emit(**line_m)
    emit(phase="launches M", **paths["M"])
    emit(**m_timing(card, cfg, system, m_sys, queries))
    del m_sys, m_live
    _free(card)                           # M's card memory goes before U

    ops.reset_launch_counts()
    live, lines_u = phase_u(card, cfg, system, corp)
    paths["U"] = ops.launch_counts()
    for line in lines_u:
        emit(**line)
    emit(phase="launches U", **paths["U"])
    u_epochs = [ln for ln in lines_u if ln["phase"] == "U"]

    t0 = time.perf_counter()
    live_sp = live.clone()                # SP replays S from S's start
    clone_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    line_s, sig_s = phase_s(card, cfg, live, corp)
    paths["S"] = ops.launch_counts()
    emit(**line_s)
    emit(phase="launches S", **paths["S"])

    ops.reset_launch_counts()
    line_sp = phase_sp(card, cfg, live_sp, corp, line_s, sig_s)
    paths["SP"] = ops.launch_counts()
    line_sp["clone_seconds"] = clone_s
    emit(**line_sp)
    emit(phase="launches SP", **paths["SP"])
    emit(**phase_sp_faults(card, cfg, live_sp, corp))
    del live_sp
    gc.collect()                          # P needs the clone's card memory

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

    ops.reset_launch_counts()
    line_pp = phase_pp(card, cfg, live, corp, lines_p[0])
    paths["PP"] = ops.launch_counts()
    emit(**line_pp)
    emit(phase="launches PP", **paths["PP"])
    emit(**p_stacked(card, cfg, live))
    emit(**p_sharded(card, cfg, live))
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
    _free(card)

    ops.reset_launch_counts()
    lines_g, kept = phase_g(card, cfg)
    paths["G"] = ops.launch_counts()
    for line in lines_g:
        emit(**line)
    emit(phase="launches G", **paths["G"])
    for line in g_timing(card, cfg, kept):
        emit(**line)
    del kept
    _free(card)

    ops.reset_launch_counts()
    lines_q = phase_q(card, cfg)
    paths["Q"] = ops.launch_counts()
    for line in lines_q:
        emit(**line)
    emit(phase="launches Q", **paths["Q"])
    _free(card)

    ops.reset_launch_counts()
    lines_r = phase_r(card, cfg)
    paths["R"] = ops.launch_counts()
    for line in lines_r:
        emit(**line)
    emit(phase="launches R", **paths["R"])
    _free(card)                  # C starts from an empty cache, as before

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
