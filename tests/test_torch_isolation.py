"""The port stands alone: no JAX, no ``repro``, no quiet fall back to the CPU.

Each check runs in a fresh interpreter with ``jax`` and ``repro`` blocked in
``sys.modules``, so any import of either fails there.
"""
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCK = ("import sys; sys.modules['jax'] = None; "
          "sys.modules['repro'] = None; sys.path.insert(0, %r); " %
          str(ROOT / "src"))


def _run(code, cwd=ROOT, timeout=120):
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def _modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_and_chip_smoke_import_without_jax():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 15
    code = ("import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
            "print('BAD', bad)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout


def test_entry_points_raise_without_a_card():
    code = ("import numpy as np, torch\n"
            "assert not torch.cuda.is_available()\n"
            "from repro_torch.core import pipeline\n"
            "from repro_torch import convert\n"
            "e = np.zeros((4, 8), np.float32); t = [b'x'] * 4\n"
            "for fn in (lambda: pipeline.PirRagSystem.build(t, e, n_clusters=2),\n"
            "           lambda: convert.system_from_state(t, e, centroids=e[:2],"
            " assignment=np.zeros(4, int), n_clusters=2, a_seed=1)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as err:\n"
            "        assert 'device' in str(err), err\n"
            "    else:\n"
            "        raise SystemExit('ran without a card')\n"
            "print('RAISED')")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode not in (0, None)
    assert '"ok": true' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env={"PATH": "/usr/bin:/bin"})
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout


def test_chip_smoke_rehearsal_runs_every_phase_without_jax():
    code = ("import runpy\n"
            f"sys.argv = [{str(ROOT / 'chip_smoke.py')!r}, '--rehearse']\n"
            f"runpy.run_path(sys.argv[0], run_name='__main__')")
    out = _run(code)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for phase in ('"kernels"', '"B"', '"launches B"', '"B breakdown"', '"C"',
                  '"launches C"', '"timing"'):
        assert any(f'"phase": {phase}' in ln for ln in lines), phase
    assert lines[-1].startswith('{"kernels": [')
    assert '"ok": true' not in out.stdout


def test_chip_smoke_rehearsal_runs_the_live_index_and_serve_phases():
    code = ("import runpy\n"
            f"sys.argv = [{str(ROOT / 'chip_smoke.py')!r}, '--rehearse']\n"
            f"runpy.run_path(sys.argv[0], run_name='__main__')")
    out = _run(code)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for phase in ('"U"', '"U rebuild"', '"launches U"', '"S"',
                  '"launches S"'):
        assert any(f'"phase": {phase}' in ln for ln in lines), phase
    table = json.loads(lines[-1])["kernels"]
    assert [k["name"] for k in table] == ["modmatmul_u8", "modmatmul_u32",
                                          "kmeans_assign", "delta_gemm",
                                          "add_delta", "bucketed_modmatmul"]
    for k in table:
        assert {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "replaces", "source"} <= set(k)
        assert (ROOT / k["source"]).exists()
    s = next(json.loads(ln) for ln in lines if '"phase": "S"' in ln)
    assert s["served"] + s["failed"] == s["offered"]


def test_live_entry_points_raise_without_a_card():
    code = ("import numpy as np, torch\n"
            "assert not torch.cuda.is_available()\n"
            "from repro_torch import convert\n"
            "from repro_torch.update import LiveIndex\n"
            "e = np.zeros((4, 8), np.float32); t = [b'x'] * 4\n"
            "for fn in (lambda: LiveIndex.build(t, e, n_clusters=2),\n"
            "           lambda: convert.live_from_state(t, e, centroids=e[:2],"
            " assignment=np.zeros(4, int), n_clusters=2, a_seed=1)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as err:\n"
            "        assert 'device' in str(err), err\n"
            "    else:\n"
            "        raise SystemExit('ran without a card')\n"
            "print('RAISED')")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout


def test_chip_smoke_rehearsal_runs_the_batch_pir_and_keyed_phases():
    code = ("import runpy\n"
            f"sys.argv = [{str(ROOT / 'chip_smoke.py')!r}, '--rehearse']\n"
            f"runpy.run_path(sys.argv[0], run_name='__main__')")
    out = _run(code)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for phase in ('"P"', '"P commit"', '"P overflow"', '"launches P"', '"K"',
                  '"launches K"'):
        assert any(f'"phase": {phase}' in ln for ln in lines), phase
    p = next(json.loads(ln) for ln in lines if '"phase": "P"' in ln)
    assert p["served"] + p["failed"] == p["offered"]
    for ln in lines:
        if '"phase": "P commit"' in ln or '"phase": "P overflow"' in ln:
            c = json.loads(ln)
            assert c["bucket_hints_equal_setup"] and c["sub_dbs_equal_host"]
    assert any(json.loads(ln).get("rebuilt_buckets") for ln in lines
               if '"phase": "P overflow"' in ln)
    k = next(json.loads(ln) for ln in lines if '"phase": "K"' in ln)
    assert k["rows_equal_table"] and k["replaced_rows_equal"]
    row = json.loads(lines[-1])["kernels"][-1]
    assert row["name"] == "bucketed_modmatmul" and row["route"] == "cuda"
    assert row["library_ms"] is None and row["library_note"]


def test_keyed_entry_points_raise_without_a_card():
    code = ("import numpy as np, torch\n"
            "assert not torch.cuda.is_available()\n"
            "from repro_torch.core import pipeline\n"
            "from repro_torch.update import LiveIndex\n"
            "t = np.zeros((16, 4), np.float32)\n"
            "for fn in (lambda: pipeline.PirRagSystem.build_keyed(t),\n"
            "           lambda: LiveIndex.build_keyed(t)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as err:\n"
            "        assert 'device' in str(err), err\n"
            "    else:\n"
            "        raise SystemExit('ran without a card')\n"
            "print('RAISED')")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout


def test_serving_modules_import_without_jax():
    """The pipelined engine, shadow commits, fault plans and the serve CLI
    import with jax and repro blocked."""
    code = ("import importlib\n"
            "for m in ('repro_torch.serve.epochs', 'repro_torch.fleet.faults',"
            " 'repro_torch.launch', 'repro_torch.launch.serve'):\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.serve import PipelinedServeLoop, ShadowCommitter\n"
            "from repro_torch.fleet.faults import FaultInjector, FaultPlan\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
            "print('BAD', bad)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout


def test_pipelined_entry_points_raise_without_a_card():
    code = ("import numpy as np, torch\n"
            "assert not torch.cuda.is_available()\n"
            "from repro_torch.core import pipeline\n"
            "from repro_torch.launch import serve\n"
            "from repro_torch.serve import PipelinedServeLoop\n"
            "from repro_torch.update import LiveIndex\n"
            "e = np.zeros((4, 8), np.float32); t = [b'x'] * 4\n"
            "for fn in (lambda: PipelinedServeLoop(\n"
            "               pipeline.PirRagSystem.build(t, e, n_clusters=2)),\n"
            "           lambda: PipelinedServeLoop(\n"
            "               LiveIndex.build(t, e, n_clusters=2)),\n"
            "           lambda: serve.main(['--docs', '40', '--requests', '2',"
            " '--engine', 'pipelined'])):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as err:\n"
            "        assert 'device' in str(err), err\n"
            "    else:\n"
            "        raise SystemExit('ran without a card')\n"
            "print('RAISED')")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout


def test_chip_smoke_rehearsal_runs_the_pipelined_phases():
    code = ("import runpy\n"
            f"sys.argv = [{str(ROOT / 'chip_smoke.py')!r}, '--rehearse']\n"
            f"runpy.run_path(sys.argv[0], run_name='__main__')")
    out = _run(code, timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    for phase in ('"SP"', '"launches SP"', '"SP faults"', '"PP"',
                  '"launches PP"', '"P stacked"'):
        assert any(f'"phase": {phase}' in ln for ln in lines), phase

    def line(phase):
        return next(json.loads(ln) for ln in lines
                    if f'"phase": "{phase}"' in ln)

    s, sp = line("S"), line("SP")
    assert sp["engine"] == "pipelined" and sp["responses_equal_s"]
    for key in ("offered", "served", "stale_retries", "epochs"):
        assert sp[key] == s[key]
    assert sp["served"] + sp["failed"] == sp["offered"]
    u_epoch = max(json.loads(ln)["epoch"] for ln in lines
                  if '"phase": "U"' in ln)
    assert sp["commits"] == sp["epochs"] - u_epoch > 0
    faults = line("SP faults")
    assert faults["responses_equal"] and faults["dropped"] == \
        faults["retries_charged"] > 0 and faults["delayed"] > 0
    pp = line("PP")
    assert pp["responses_equal_sync"] and pp["bucket_hints_equal_setup"]
    assert pp["served"] + pp["failed"] == pp["offered"]
    stacked = line("P stacked")
    assert stacked["ciphertexts_equal"] and stacked["columns_equal_sub_dbs"]
    assert "u32_launches_per_batch" in line("K")
