#!/usr/bin/env python3
"""Per-call cost of the port's u32 × u32 product at the LWE encryption's
small shapes, on one GPU.

    PYTHONPATH=src python3 scripts/u32_call_cost.py [--calls 400]

Batch PIR encrypts one query per bucket, A_b·s with A_b of (width, k) =
(256, 1024) in phase P and (128, 1024) in phase K of ``chip_smoke.py``, so
the serve loop's encode time is many small `ops.mod_u32_matmul` calls.  For
each shape this prints one JSON line: the host milliseconds per call to
enqueue it (``issue_ms``), per call once the card has finished
(``call_ms``), and the same for a whole `lwe.encrypt_vector`.  It uses only
the entry points that ``repro_torch`` has had since its first slice, so the
same script times an older checkout of the package (put its ``src`` first
on ``PYTHONPATH``).  It exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def _time(fn, calls: int) -> tuple[float, float]:
    """(host ms per call to enqueue, ms per call until the card is done)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e3 * (t1 - t0) / calls, 1e3 * (t2 - t0) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("u32_call_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import lwe
    from repro_torch.kernels import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for width in (256, 128):
        a_mat = torch.randint(-2**31, 2**31, (width, 1024), dtype=torch.int32,
                              generator=gen, device=dev)
        s = torch.randint(-2**31, 2**31, (1024,), dtype=torch.int32,
                          generator=gen, device=dev)
        msg = torch.zeros(width, dtype=torch.int32, device=dev)
        e = torch.zeros(width, dtype=torch.int32, device=dev)
        issue, call = _time(lambda: ops.mod_u32_matmul(a_mat, s), args.calls)
        enc_issue, enc_call = _time(
            lambda: lwe.encrypt_vector(s, a_mat, msg, 1 << 24, e),
            args.calls)
        print(json.dumps(dict(
            card=card, package=lwe.__file__, shape=f"{width}x1024x1",
            calls=args.calls, issue_ms=issue, call_ms=call,
            encrypt_issue_ms=enc_issue, encrypt_call_ms=enc_call)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
