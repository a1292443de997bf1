#!/usr/bin/env python3
"""Where the limb tile's time goes at ``delta_gemm``'s and
``bucketed_modmatmul``'s main-path shapes, on one GPU: the tile's epilogue
against variants of it, timed in turns in one process.

    PYTHONPATH=src python3 scripts/epilogue_ab.py

It copies ``csrc/limb_tile.cuh``, ``delta_gemm.cu`` and
``bucketed_modmatmul.cu`` into ``kernels/.build/epilogue_ab/`` (git-ignored),
edits the copies into variants, builds each with nvcc and loads it beside the
package's own build:

  built       the sources as they are
  direct      the outputs stored straight from the registers (STAGED false)
  staged      through shared memory as whole 16-byte words (STAGED true)
  no stores   direct, with the stores left out (the products kept alive)
  no products direct, with the wgmma products left out

It times ``delta_gemm`` at phase U's 902,656 × 51 and × 256 × 1024 (each
variant checked bitwise against the plain version on a row slice, except
the two that leave work out) and one batch-PIR pass at phase P's and phase
K's bucket heights (built, staged), in rounds of the variants in order and
reversed; then ``fill_`` of ΔH's 3.7 GB, the card's own write rate.  One
JSON line per shape, then the card's name and power limit.  Exits 2
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import torch

P_HEIGHTS = (898432, 902656, 875776, 885376, 629760, 898432, 624000, 898432,
             902656, 880384, 902656, 608768)
K_HEIGHTS = (336128,) * 24

_CALL_DELTA = "launch_tile<N, false, true>(map_d, map_d2, map_s, a, stream)"
_CALL_DIRECT = "launch_tile<N, false, false>(map_d, map_d2, map_s, a, stream)"
_CALL_GROUPED = "launch_tile<N, true, false>("
_FIRST_STORE = ("  constexpr int G = Cfg<N>::BNO / 8;                 "
                "// 8-column groups a limb\n  const bool pairs = (b % 2) == 0;")
_PRODUCTS = ("#pragma unroll\n        for (int kk = 0; kk < LBK / WK; ++kk) {\n"
             "          Wgmma<N>::run(acc, sw128_desc(sa + kk * WK), "
             "sw128_desc(sb + kk * WK),\n"
             "                        (fresh && kk == 0) ? 0 : 1);\n        }")


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"epilogue_ab: the sources changed; cannot find "
                           f"{old[:60]!r}")
    return text.replace(old, new)


def _variants():
    """{(source, variant): (tile header text, source text)}."""
    from repro_torch.kernels import _build
    tile = (_build.CSRC / "limb_tile.cuh").read_text()
    delta = (_build.CSRC / "delta_gemm.cu").read_text()
    grouped = (_build.CSRC / "bucketed_modmatmul.cu").read_text()
    direct = _edit(delta, f"return {_CALL_DELTA}", f"return {_CALL_DIRECT}")
    no_stores = _edit(tile, _FIRST_STORE, _FIRST_STORE + """
  {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x ^= acc[i];
    if (x == 0x9E3779B9u && row < m) C[row * b + col] = x;
    return;
  }""")
    no_products = _edit(tile, _PRODUCTS, "")
    return {
        ("delta_gemm", "built"): (tile, delta),
        ("delta_gemm", "direct"): (tile, direct),
        ("delta_gemm", "staged"): (tile, _edit(direct, f"return {_CALL_DIRECT}",
                                               f"return {_CALL_DELTA}")),
        ("delta_gemm", "no stores"): (no_stores, direct),
        ("delta_gemm", "no products"): (no_products, direct),
        ("bucketed_modmatmul", "built"): (tile, grouped),
        ("bucketed_modmatmul", "staged"): (
            tile, _edit(grouped, _CALL_GROUPED, "launch_tile<N, true, true>(")),
    }


def _build_all():
    from repro_torch.kernels import _build
    root = _build.BUILD_DIR / "epilogue_ab"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for i, ((source, variant), (tile, text)) in enumerate(_variants().items()):
        d = root / str(i)
        d.mkdir(parents=True)
        (d / "limb_tile.cuh").write_text(tile)
        (d / f"{source}.cu").write_text(text)
        out = d / f"{source}.so"
        procs[(source, variant)] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
             str(d / f"{source}.cu")], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    libs = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"epilogue_ab: nvcc failed for {key}:\n"
                               f"{err.decode(errors='replace')}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build._SIGNATURES[key[0]].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def _ms(fn, reps: int = 5) -> float:
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


def _in_turns(op, fns, rounds: int = 2) -> None:
    names = list(fns)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(_ms(fns[k]))
    print(json.dumps(dict(op=op, ms={k: v for k, v in times.items()},
                          median_ms={k: statistics.median(v)
                                     for k, v in times.items()})), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("epilogue_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, bucketed_modmatmul, delta_gemm, ref
    libs = _build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    m, k = 902_656, 1024
    for j in (51, 256):
        new = torch.randint(0, 256, (m, j), dtype=torch.uint8, generator=gen,
                            device=dev)
        old = torch.randint(0, 256, (m, j), dtype=torch.uint8, generator=gen,
                            device=dev)
        a_j = torch.randint(-2**31, 2**31, (j, k), dtype=torch.int32,
                            generator=gen, device=dev)
        pack = delta_gemm.packs(new, old)
        _, n = ref.delta_layout(j, two_maps=not pack)
        n_stacked, _, b_pad = ref.limb_plan(k)
        planes = torch.empty((4 * b_pad, -(-n // 16) * 16), dtype=torch.uint8,
                             device=dev)
        packed = (torch.empty((m, n), dtype=torch.uint8, device=dev) if pack
                  else None)
        out = torch.empty((m, k), dtype=torch.int32, device=dev)
        want = ref.delta_gemm_ref(new[:2048], old[:2048], a_j)
        fns = {}
        for (source, variant), lib in libs.items():
            if source != "delta_gemm":
                continue

            def call(lib=lib):
                code = lib.delta_gemm_u8(
                    new.data_ptr(), old.data_ptr(),
                    None if packed is None else packed.data_ptr(),
                    a_j.data_ptr(), planes.data_ptr(), out.data_ptr(), m, j,
                    k, n_stacked, stream)
                _build.check(code, f"delta_gemm {variant}")
            call()
            torch.cuda.synchronize()
            if not variant.startswith("no ") and not torch.equal(
                    out[:2048], want):
                raise AssertionError(f"epilogue_ab: delta {variant} != plain")
            fns[variant] = call
        _in_turns(f"delta {m}x{j}x{k} ({'packed' if pack else 'two maps'})",
                  fns)
        if j == 51:
            _in_turns(f"fill_ of ({m}, {k}) int32", {"fill_": lambda: out.fill_(7)})
        del new, old, a_j, planes, packed, out
    for phase, heights, w in (("P", P_HEIGHTS, 256), ("K", K_HEIGHTS, 128)):
        dbs = [torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=gen,
                             device=dev) for h in heights]
        q3 = torch.randint(-2**31, 2**31, (len(heights), w, 16),
                           dtype=torch.int32, generator=gen, device=dev)
        fns = {}
        for (source, variant), lib in libs.items():
            if source != "bucketed_modmatmul":
                continue

            def call(lib=lib):
                _build._LIBS["bucketed_modmatmul"] = lib
                return bucketed_modmatmul.grouped_product(dbs, q3)[0]
            got = call()
            for d, q, o in zip(dbs, q3, got):
                if not torch.equal(o[:500], ref.modmatmul_ref(d[:500], q)):
                    raise AssertionError(f"epilogue_ab: {phase} {variant} != "
                                         f"plain")
            fns[variant] = call
        _in_turns(f"{phase} answer pass, {len(heights)} buckets, "
                  f"{sum(heights)}x{w}x16", fns)
        _build._LIBS.pop("bucketed_modmatmul", None)
        del dbs, q3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
