#!/usr/bin/env python3
"""Times of the port's mod-2^32 products at the main path's full shapes, on
one GPU.

    PYTHONPATH=src python3 scripts/limb_tile_times.py --label change [--reps 5]

It times, with CUDA events after a warm-up call, each product that the
limb tile of ``csrc/limb_tile.cuh`` serves: phase C's answer (2,097,152 ×
4096 × 64) and hint (× 1024) and H·S (2,097,152 × 1024 × 64), phase U's
two ΔH products (902,656 × 51 and × 256 × 1024), and one batch-PIR answer
pass at phase P's and phase K's bucket heights (the partitions of
``chip_smoke.py``'s phases P and K, whose heights are fixed by their seeds).
Each product is checked once against its plain version on a row slice.
It prints one JSON line a product, tagged with ``--label``, then the card's
name and power limit.  It calls only the ``ops`` entries the package has
had since its third slice, so the same script times an older checkout of
the package (put its ``src`` first on ``PYTHONPATH``); compare two trees in
one call, in turns (parent, change, change, parent).  It exits 2 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

#: bucket heights of chip_smoke.py's phase P (kappa 4, W 256) and phase K
#: (MIND's item table, kappa 8, W 128)
P_HEIGHTS = (898432, 902656, 875776, 885376, 629760, 898432, 624000, 898432,
             902656, 880384, 902656, 608768)
K_HEIGHTS = (336128,) * 24


def _ms(fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("limb_tile_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                             device=dev)

    def u32(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=gen, device=dev)

    def emit(op, shape, ms, ok):
        print(json.dumps(dict(label=args.label, op=op, shape=shape, ms=ms,
                              plain_equal_on_a_slice=ok)), flush=True)

    db, qs, a_mat = u8((2_097_152, 4096)), u32((4096, 64)), u32((4096, 1024))
    ok = torch.equal(ops.modmatmul(db[:512], qs),
                     ref.modmatmul_ref(db[:512], qs))
    emit("C answer", "2097152x4096x64",
         _ms(lambda: ops.modmatmul(db, qs), args.reps), ok)
    hint = ops.hint_gemm(db, a_mat)
    ok = torch.equal(hint[:256], ref.modmatmul_ref(db[:256], a_mat))
    emit("C hint", "2097152x4096x1024",
         _ms(lambda: ops.hint_gemm(db, a_mat), max(1, args.reps // 2)), ok)
    del db, qs, a_mat
    secrets = u32((1024, 64))
    ok = torch.equal(ops.mod_u32_matmul(hint[:512], secrets),
                     ref.modmatmul_ref(hint[:512], secrets))
    emit("C H·S", "2097152x1024x64",
         _ms(lambda: ops.mod_u32_matmul(hint, secrets), args.reps), ok)
    del hint, secrets

    for j in (51, 256):
        new, old, a_j = u8((902_656, j)), u8((902_656, j)), u32((j, 1024))
        ok = torch.equal(ops.delta_gemm(new[:512], old[:512], a_j),
                         ref.delta_gemm_ref(new[:512], old[:512], a_j))
        emit(f"U delta J = {j}", f"902656x{j}x1024",
             _ms(lambda: ops.delta_gemm(new, old, a_j), args.reps), ok)
        del new, old, a_j

    for phase, heights, w in (("P", P_HEIGHTS, 256), ("K", K_HEIGHTS, 128)):
        dbs = [u8((m, w)) for m in heights]
        q3 = u32((len(heights), w, 16))
        got = ops.bucketed_modmatmul(dbs, q3)
        ok = all(torch.equal(g[:300], want) for g, want in zip(
            got, ref.bucketed_modmatmul_ref([d[:300] for d in dbs], q3)))
        emit(f"{phase} answer pass",
             f"{len(heights)} buckets, {sum(heights)}x{w}x16",
             _ms(lambda: ops.bucketed_modmatmul(dbs, q3), args.reps), ok)
        del dbs, q3, got

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
