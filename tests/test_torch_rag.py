"""The port's RAG generation stage against the JAX package's, on the CPU.

The same inputs, made with numpy from fixed seeds, go through both
packages: byte prompts must be identical, converted weights bitwise equal,
logits of the decoder within a stated float32 tolerance, and the tokens a
`Generator` emits (greedy, and sampled through the port's threefry) equal.
Within the port, the KV-cache loop must give the cache-free loop's tokens
and a row's tokens must not depend on the rows that share its batch.
"""
import dataclasses
import pathlib
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_4b as ref_qwen
from repro.models import transformer as rtf
from repro.rag import Generator as RefGenerator
from repro.rag import prompt as rprompt
from repro_torch import convert
from repro_torch.configs import qwen3_4b
from repro_torch.models import transformer as ptf
from repro_torch.rag import generate as pgen
from repro_torch.rag import prompt as pprompt

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: float32 logits of the port against the reference's (other summation
#: orders in XLA's and torch's CPU products, through a few layers)
ATOL = 1e-4
#: float32 logits of one code path against another within the port
ATOL_PORT = 1e-5

_PORT_FIELDS = {f.name for f in dataclasses.fields(ptf.LMConfig)}


def _port_cfg(ref_cfg, **kw):
    """The port's `LMConfig` with the reference config's widths."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)
              if f.name in _PORT_FIELDS and not f.name.endswith("_dtype")}
    fields.update(kw)
    return ptf.LMConfig(**fields)


def _ref_cfg(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=128, attn_chunk_q=8,
                attn_chunk_kv=8, ce_chunk=8, remat=False,
                compute_dtype=jnp.float32)
    base.update(kw)
    return rtf.LMConfig(**base)


#: the reference test's `dense` and `qknorm_bias` widths
#: (tests/test_models_lm.py) and Qwen3's SMOKE, all in float32 compute
CFGS = {
    "dense": _ref_cfg(),
    "qknorm_bias": _ref_cfg(qk_norm=True, qkv_bias=True),
    "qwen3_smoke": dataclasses.replace(ref_qwen.SMOKE,
                                       compute_dtype=jnp.float32),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _docs(seed, n_req, k=3, lo=4, hi=60):
    """n_req ranked lists of k (id, score, text) triples of random bytes."""
    rng = np.random.default_rng(seed)
    return [[(int(rng.integers(10_000)), 0.0,
              rng.integers(0, 256, int(rng.integers(lo, hi)), np.uint8)
              .tobytes()) for _ in range(k)] for _ in range(n_req)]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# prompts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("budget", [2, 3, 24, 96, 160])
def test_pack_docs_and_batch_equal_the_reference(seed, budget):
    rng = np.random.default_rng(seed)
    spec_r, spec_p = rprompt.PromptSpec(budget), pprompt.PromptSpec(budget)
    lists = [[rng.integers(0, 256, int(rng.integers(0, 80)), np.uint8)
              .tobytes() for _ in range(int(rng.integers(0, 6)))]
             for _ in range(5)]
    ref = [rprompt.pack_docs(t, spec_r) for t in lists]
    port = [pprompt.pack_docs(t, spec_p) for t in lists]
    for r, p, texts in zip(ref, port, lists):
        assert p.tokens.dtype == np.int32
        np.testing.assert_array_equal(p.tokens, r.tokens)
        assert (p.n_docs, p.n_docs_dropped, p.packed_bytes,
                p.dropped_bytes) == (r.n_docs, r.n_docs_dropped,
                                     r.packed_bytes, r.dropped_bytes)
        assert p.packed_bytes + p.dropped_bytes == sum(map(len, texts))
        assert p.length <= budget
    grid_r, len_r = rprompt.pack_batch(ref, spec_r)
    grid_p, len_p = pprompt.pack_batch(port, spec_p)
    np.testing.assert_array_equal(grid_p, grid_r)
    np.testing.assert_array_equal(len_p, len_r)
    assert grid_p.dtype == np.int32 and grid_p.shape == (5, budget)


def test_long_doc_does_not_shadow_a_short_one_and_minimum_prompt():
    spec = pprompt.PromptSpec(16)
    p = pprompt.pack_docs([b"a" * 30, b"xyz", b"b" * 20], spec)
    r = rprompt.pack_docs([b"a" * 30, b"xyz", b"b" * 20],
                          rprompt.PromptSpec(16))
    np.testing.assert_array_equal(p.tokens, r.tokens)
    assert list(p.tokens) == [pprompt.BOS, *b"xyz", pprompt.SEP,
                              pprompt.GEN]
    assert (p.n_docs, p.n_docs_dropped, p.packed_bytes,
            p.dropped_bytes) == (1, 2, 3, 50)
    empty = pprompt.pack_docs([b"q" * 5], pprompt.PromptSpec(2))
    assert list(empty.tokens) == [pprompt.BOS, pprompt.GEN]
    assert (empty.n_docs, empty.dropped_bytes) == (0, 5)
    assert pprompt.decode_tokens(p.tokens) == b"xyz"
    assert (pprompt.PAD, pprompt.BOS, pprompt.SEP, pprompt.GEN,
            pprompt.VOCAB) == (rprompt.PAD, rprompt.BOS, rprompt.SEP,
                               rprompt.GEN, rprompt.VOCAB)


# ---------------------------------------------------------------------------
# weights and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_converted_weights_equal_the_reference_bitwise(name):
    rcfg = CFGS[name]
    rp = _np_tree(rtf.init(jax.random.PRNGKey(4), rcfg))
    pcfg = _port_cfg(rcfg)
    pp = convert.lm_params_from_state(rp, pcfg, "cpu")
    assert len(pp["layers"]) == rcfg.n_layers
    np.testing.assert_array_equal(pp["embed"]["table"].numpy(),
                                  rp["embed"]["table"])
    np.testing.assert_array_equal(pp["final_norm"]["g"].numpy(),
                                  rp["final_norm"]["g"])
    assert ("head" in pp) == ("head" in rp)
    if "head" in rp:
        np.testing.assert_array_equal(pp["head"]["w"].numpy(),
                                      rp["head"]["w"])
    stacked = rp["blocks"]["sub0"]

    def walk(port, ref, i, path=""):
        assert set(port) == set(ref), path
        for k in ref:
            if isinstance(ref[k], dict):
                walk(port[k], ref[k], i, f"{path}/{k}")
            else:
                np.testing.assert_array_equal(port[k].numpy(), ref[k][i],
                                              err_msg=f"{path}/{k}")
    for i, layer in enumerate(pp["layers"]):
        walk(layer, stacked, i)


@pytest.mark.parametrize("name", list(CFGS))
def test_port_init_has_the_reference_shapes_and_scales(name):
    rcfg, pcfg = CFGS[name], _port_cfg(CFGS[name])
    rp = _np_tree(rtf.init(jax.random.PRNGKey(0), rcfg))
    pp = ptf.init(torch.Generator().manual_seed(0), pcfg, device=CPU)
    want = convert.lm_params_from_state(rp, pcfg, "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(pp) == shapes(want)
    table = pp["embed"]["table"]
    assert abs(float(table.std()) - 0.02) < 0.004
    w = pp["layers"][0]["ffn"]["w_down"]["w"]
    assert abs(float(w.std()) * np.sqrt(pcfg.d_ff) - 1.0) < 0.1
    assert torch.equal(pp["layers"][0]["ln1"]["g"],
                       torch.ones(pcfg.d_model))


def test_moe_config_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 7"):
        ptf.LMConfig(name="m", n_layers=2, d_model=8, n_heads=2,
                     n_kv_heads=1, head_dim=4, d_ff=16, vocab=32,
                     moe=object())


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_prefill_and_decode_match_the_reference(name):
    """forward, prefill (ragged last positions) and two decode steps,
    within ATOL of the reference's at the same weights and tokens."""
    rcfg = CFGS[name]
    pcfg = _port_cfg(rcfg)
    rp = rtf.init(jax.random.PRNGKey(0), rcfg)
    pp = convert.lm_params_from_state(_np_tree(rp), pcfg, "cpu")
    B, S, S0 = 3, 21, 13
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)
                                             ).astype(np.int32)
    x_r, _ = rtf.forward(rp, jnp.asarray(toks), rcfg)
    full_r = np.asarray(rtf.logits_from_hidden(rp, x_r, rcfg))
    x_p, aux = ptf.forward(pp, _t(toks), pcfg)
    full_p = ptf.logits_from_hidden(pp, x_p, pcfg).numpy()
    assert float(aux) == 0.0
    np.testing.assert_allclose(full_p, full_r, atol=ATOL, rtol=0)

    last = np.array([S0 - 1, S0 - 4, S0 - 1], np.int32)
    cache_r = rtf.init_cache(rcfg, B, S, dtype=jnp.float32)
    lg_r, cache_r = rtf.prefill(rp, jnp.asarray(toks[:, :S0]), cache_r,
                                rcfg, last_pos=jnp.asarray(last))
    cache_p = ptf.init_cache(pcfg, B, S, device=CPU)
    lg_p, cache_p = ptf.prefill(pp, _t(toks[:, :S0]), cache_p, pcfg,
                                last_pos=_t(last))
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_r), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lg_p.numpy(), full_p[np.arange(B), last],
                               atol=ATOL_PORT, rtol=0)
    lens = np.full((B,), S0, np.int32)
    for t in range(2):
        lg_r, cache_r = rtf.decode_step(rp, cache_r,
                                        jnp.asarray(toks[:, S0 + t]),
                                        jnp.asarray(lens + t), rcfg)
        lg_p, cache_p = ptf.decode_step(pp, cache_p, _t(toks[:, S0 + t]),
                                        _t(lens + t), pcfg)
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_r),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(lg_p.numpy(), full_p[:, S0 + t],
                                   atol=ATOL_PORT, rtol=0)
    for i, cb in enumerate(cache_p):
        np.testing.assert_allclose(
            cb["k"].numpy()[:, :S0 + 2],
            np.asarray(cache_r["sub0"]["k"][i])[:, :S0 + 2], atol=ATOL,
            rtol=0)


def test_blockwise_attention_on_a_ragged_last_chunk():
    """21 positions over chunks of 8 (q) and 8 (kv): the port's chunked
    softmax equals the reference's and a one-shot softmax."""
    rcfg = _ref_cfg(attn_chunk_q=8, attn_chunk_kv=8)
    pcfg = _port_cfg(rcfg)
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 21, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    got = ptf.blockwise_attention(_t(q), _t(k), _t(v), pcfg).numpy()
    ref = np.asarray(rtf.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), rcfg))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    G = H // KV
    kk, vv = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bthd->bqht", q, kk) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((S, S), bool))[None, :, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bqht,bthd->bqhd", p, vv),
                               atol=2e-5, rtol=1e-5)
    full = ptf.blockwise_attention(_t(q), _t(k), _t(v), pcfg, causal=False)
    ref_full = rtf.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), rcfg, causal=False)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full),
                               atol=2e-6, rtol=0)


def test_rope_matches_the_reference_and_is_shift_invariant():
    """RoPE equals the reference's, and q·k after it depends only on the
    distance between positions."""
    rng = np.random.default_rng(2)
    hd = 16
    x = rng.standard_normal((1, 6, 2, hd)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    got = ptf._rope(_t(x), ptf.rope_tables(_t(pos), hd, 1e6)).numpy()
    ref = np.asarray(rtf._rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    q = rng.standard_normal((1, 1, 1, hd)).astype(np.float32)
    k = rng.standard_normal((1, 1, 1, hd)).astype(np.float32)

    def score(pq, pk):
        rq = ptf._rope(_t(q), ptf.rope_tables(torch.tensor([[pq]]), hd,
                                              10_000.0))
        rk = ptf._rope(_t(k), ptf.rope_tables(torch.tensor([[pk]]), hd,
                                              10_000.0))
        return float((rq * rk).sum())
    for shift in (1, 7, 100):
        assert score(5 + shift, 2 + shift) == pytest.approx(score(5, 2),
                                                            abs=1e-4)


# ---------------------------------------------------------------------------
# Generator: tokens
# ---------------------------------------------------------------------------

def _pair(seed, *, temperature=0.0, gen_seed=0):
    """The reference's `Generator.tiny` and the port's over its weights."""
    ref = RefGenerator.tiny(seed=seed, temperature=temperature)
    ref = RefGenerator(ref.params, ref.cfg, spec=ref.spec,
                       max_new_tokens=ref.max_new_tokens,
                       temperature=temperature, seed=gen_seed)
    port = convert.generator_from_state(
        _np_tree(ref.params), pgen.tiny_config(),
        spec=pprompt.PromptSpec(ref.spec.context_budget),
        max_new_tokens=ref.max_new_tokens, temperature=temperature,
        seed=gen_seed, device="cpu")
    return ref, port


def _ref_step_logits(ref, docs, tokens):
    """The reference's teacher-forced logits (B, N, V) at each step."""
    grid, lengths, _ = ref.pack(docs)
    B, S = grid.shape
    N = tokens.shape[1]
    full = np.full((B, S + N), rprompt.PAD, np.int32)
    full[:, :S] = grid
    for b in range(B):
        full[b, lengths[b]:lengths[b] + N] = tokens[b]
    x, _ = rtf.forward(ref.params, jnp.asarray(full), ref.cfg)
    logits = np.asarray(rtf.logits_from_hidden(ref.params, x, ref.cfg))
    pos = lengths[:, None] - 1 + np.arange(N)[None]
    return logits[np.arange(B)[:, None], pos]


def _top2_gaps(scores):
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_greedy_tokens_equal_the_reference(seed, batch):
    ref, port = _pair(seed)
    docs = _docs(100 * seed + batch, batch)
    rids = list(range(batch))
    want = ref.generate(docs, rids)
    # no near-tie in the fixture: a flip there would not be a port fault
    assert _top2_gaps(_ref_step_logits(ref, docs, want)).min() > 2 * ATOL
    got = port.generate(docs, rids)
    assert got.dtype == np.int32 and got.shape == (batch,
                                                   ref.max_new_tokens)
    np.testing.assert_array_equal(got, want)


def test_sampled_tokens_equal_the_reference():
    """Seeded sampling: the port's Gumbel draw from its own threefry gives
    the reference's tokens, and a row's tokens depend on (seed, rid, step)
    only."""
    ref, port = _pair(1, temperature=0.8, gen_seed=9)
    docs = _docs(7, 4)
    rids = [3, 11, 12, 40]
    want = ref.generate(docs, rids)
    got = port.generate(docs, rids)
    np.testing.assert_array_equal(got, want)
    alone = port.generate(docs[2:3], rids[2:3])
    np.testing.assert_array_equal(alone, got[2:3])
    moved = port.generate(docs[:1], [rids[1]])
    ref_moved = ref.generate(docs[:1], [rids[1]])
    np.testing.assert_array_equal(moved, ref_moved)


@pytest.mark.parametrize("step", [0, 5])
def test_gumbel_noise_equals_jax_random_gumbel(step):
    key = jax.random.PRNGKey(9)
    got = pgen.gumbel_noise((0, 9), [3, 77], step, 300, CPU).numpy()
    for row, rid in enumerate([3, 77]):
        k = jax.random.fold_in(jax.random.fold_in(key, rid), step)
        want = np.asarray(jax.random.gumbel(k, (300,), jnp.float32))
        np.testing.assert_allclose(got[row], want, rtol=1e-6, atol=1e-6)
        assert np.argmax(got[row]) == np.argmax(want)


def test_kv_cache_tokens_equal_generate_nocache():
    port = pgen.Generator.tiny(seed=5, max_new_tokens=12, device="cpu")
    docs = _docs(11, 4, hi=90)       # some prompts near the budget
    got = port.generate(docs, range(4))
    np.testing.assert_array_equal(port.generate_nocache(docs, range(4)),
                                  got)
    with pytest.raises(ValueError, match="greedy"):
        pgen.Generator.tiny(temperature=0.5, device="cpu"
                            ).generate_nocache(docs, range(4))


def test_groups_generated_apart_equal_the_same_groups_together():
    port = pgen.Generator.tiny(seed=2, max_new_tokens=8, device="cpu")
    sampler = pgen.Generator(port.params, port.cfg, spec=port.spec,
                             max_new_tokens=8, temperature=0.7, seed=4,
                             device="cpu")
    docs = _docs(13, 5)
    rids = [7, 8, 9, 10, 11]
    for g in (port, sampler):
        together = g.generate(docs, rids)
        apart = np.concatenate([g.generate(docs[:2], rids[:2]),
                                g.generate(docs[2:], rids[2:])])
        np.testing.assert_array_equal(apart, together)


def test_generator_validates_its_config():
    cfg = pgen.tiny_config()
    params = ptf.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    with pytest.raises(ValueError, match="float32"):
        pgen.Generator(params, dataclasses.replace(
            cfg, compute_dtype=torch.bfloat16), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        pgen.Generator(params, dataclasses.replace(cfg, vocab=100),
                       device="cpu")
    assert qwen3_4b.FULL.vocab == ref_qwen.FULL.vocab
    for f in _PORT_FIELDS - {"param_dtype", "compute_dtype", "moe"}:
        assert getattr(qwen3_4b.FULL, f) == getattr(ref_qwen.FULL, f), f
        assert getattr(qwen3_4b.SMOKE, f) == getattr(ref_qwen.SMOKE, f), f


def test_generator_without_a_card_raises():
    block = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['repro'] = None; sys.path.insert(0, %r)\n"
             % str(ROOT / "src"))
    code = block + (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from repro_torch.rag import Generator\n"
        "from repro_torch import convert\n"
        "from repro_torch.rag.generate import tiny_config\n"
        "for fn in (lambda: Generator.tiny(),\n"
        "           lambda: convert.lm_params_from_state({}, tiny_config())):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as err:\n"
        "        assert 'device' in str(err), err\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n"
        "print('RAISED')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout


# ---------------------------------------------------------------------------
# the chip check's phase R, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_phase_r_rehearses():
    """`chip_smoke.py`'s phase R at the rehearsal size, through the plain
    versions: every gate passes and the phase prints its numbers."""
    cs = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke")
    card, cfg = cs["Card"](True), cs["TINY"]
    assert cs["PATH_KERNELS"]["R"] == ("modmatmul_u8", "modmatmul_u32",
                                       "kmeans_assign")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = cs["phase_r"](card, cfg)
    finally:
        torch.set_num_threads(threads)
    batches = [ln for ln in lines if ln["phase"] == "R batch"]
    r = next(ln for ln in lines if ln["phase"] == "R")
    assert len(batches) == cfg["r_requests"] // cfg["r_batch"]
    assert r["texts_checked"] == 3 * cfg["r_requests"]
    assert r["prefill_max_abs_err"] <= r["atol_prefill"]
    assert r["decode_max_abs_err"] <= r["atol_decode"]
    assert r["nocache_rows_equal"] == cfg["r_batch"]
    assert r["alone_greedy_rows_equal"] == r["alone_rows"] == 2
    assert r["alone_sampled_rows_equal"] == 2
    assert r["greedy_differ_at_near_ties"] == 0
    assert r["model"] == "rag-tiny" and r["vocab"] == pprompt.VOCAB
    assert r["peak_card_bytes"] is None
    assert sum(b["docs_packed"] for b in batches) > 0
    for key in ("retrieve_ms", "prefill_ms", "decode_step_ms", "ttft_ms",
                "tokens_per_s", "prefill_bound_ms", "decode_step_bound_ms"):
        assert r[key] > 0, key
    # the real tokens' causal bound sits under the padded grid's
    assert r["prompt_tokens"] == batches[-1]["prompt_tokens"]
    assert r["prompt_tokens"] < cfg["r_batch"] * cfg["r_budget"]
    assert r["prefill_bound_ms"] < r["prefill_padded_bound_ms"]
    for key in ("steps_before_trace", "steps_after_trace"):
        assert r[key]["issue_ms"] > 0 and r[key]["device_ms"] is None, key
