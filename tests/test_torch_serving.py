"""The port's serving path (``SparseLM``, ``SparseDecoder``, ``LMServer``)
against the JAX package's, on the CPU, with the flax weights carried across
by ``bridge.lm_state_dict`` / ``transformer_state_dict``.

The port runs its kernels' plain versions; JAX its default CPU path (the
XLA oracle). Models are tiny (h = 32, 2 heads, 2 layers, V = 97, P = 16,
bk = 8) and fp32-cached. Tolerances: LM logits 1e-5; decoder activations
1e-4 (prefill + decode steps through two different attention
implementations); greedy tokens exactly equal. Sampling draws differ
between the packages (different random streams), so ``sample_logits`` is
checked by its properties, mirroring ``tests/test_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import LMServer as JServer
from sputnik_tpu.models import SparseLM as JLM
from sputnik_tpu.models.serving import SparseDecoder as JDecoder
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import (LMServer, SparseDecoder, SparseLM,
                                      SparseTransformer, sample_logits)

V, B, P = 97, 2, 16
CFG = dict(num_layers=2, hidden_size=32, num_heads=2, ffn_hidden_size=48,
           use_residual=True, use_layernorm=True, activation="gelu")


def _causal(b, s):
    return np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                           (b, s, s)).copy()


def _perturb(params, seed):
    """flax inits biases to 0 and LayerNorm scales to 1: give every leaf of
    those kinds values, so the comparison sees them."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
            elif k in ("bias", "scale"):
                base = 1.0 if k == "scale" else 0.0
                out[k] = (base + 0.1 * rng.randn(*np.shape(v))).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return walk(params)


def _lm_pair(tie=True, b=B, s=P, **kw):
    cfg = dict(CFG, **kw)
    toks = np.random.RandomState(0).randint(0, V, (b, s))
    jlm = JLM.from_masks(_causal(b, s), vocab_size=V, tie_embeddings=tie,
                         **cfg)
    params = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(toks)), 1)
    tlm = SparseLM.from_masks(_causal(b, s), vocab_size=V, tie_embeddings=tie,
                              **cfg)
    tlm.load_state_dict(bridge.lm_state_dict(params))
    return jlm, params, tlm


@pytest.fixture(scope="module")
def lm_pair():
    return _lm_pair()


@pytest.mark.parametrize("tie", [True, False])
def test_sparse_lm_matches_flax(tie):
    jlm, params, tlm = _lm_pair(tie)
    toks = np.random.RandomState(2).randint(0, V, (B, P))
    ref = np.asarray(jlm.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tlm(torch.from_numpy(toks)).numpy()
    assert got.shape == (B, P, V)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert ("lm_head.weight" in tlm.state_dict()) == (not tie)


def _decoder_pair(kv_heads, window, sinks):
    cfg = dict(CFG, num_kv_heads=kv_heads)
    x = np.random.RandomState(3).randn(B, P, 32).astype(np.float32)
    jm = JLM.from_masks(_causal(B, P), vocab_size=V, **cfg).core
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                       jnp.asarray(x)), 4)
    tm = SparseTransformer.from_masks(_causal(B, P), **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    kw = dict(s_max=P + 16, bk=8, window=window, sinks=sinks)
    return (JDecoder(jm, cache_dtype=jnp.float32, **kw), params,
            SparseDecoder(tm, cache_dtype=torch.float32, **kw), x)


def test_decoder_steps_match_jax():
    """prefill, decode_step, decode_step_ragged with a frozen slot,
    decode_multi and rollback, step by step, on a GQA model (2 heads, 1 KV
    head) with a sliding window and a sink block: activations 1e-4,
    lengths equal. (Full-causal MHA decoding is compared through
    ``generate`` below.)"""
    jd, params, td, x = _decoder_pair(1, 6, 1)
    prefill, step, ragged, multi = (jax.jit(f) for f in (
        jd.prefill, jd.decode_step, jd.decode_step_ragged, jd.decode_multi))
    rng = np.random.RandomState(5)
    tol = dict(atol=1e-4, rtol=1e-4)

    def check(jy, jc, ty, tc):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
        for j, t in zip(jc, tc):
            np.testing.assert_array_equal(t.kv_len.numpy(),
                                          np.asarray(j.kv_len))
            n = int(t.kv_len.min())
            np.testing.assert_allclose(t.k[:, :n].numpy(),
                                       np.asarray(j.k)[:, :n, :td.hd], **tol)

    jy, jc = prefill(params, jnp.asarray(x), jd.init_caches(B))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(B))
    check(jy, jc, ty, tc)
    for _ in range(2):
        xt = rng.randn(B, 1, 32).astype(np.float32)
        jy, jc = step(params, jnp.asarray(xt), jc)
        ty, tc = td.decode_step(torch.from_numpy(xt), tc)
        check(jy, jc, ty, tc)
    active = np.array([True, False])
    xt = rng.randn(B, 1, 32).astype(np.float32)
    jy, jc = ragged(params, jnp.asarray(xt), jc, jnp.asarray(active))
    ty, tc = td.decode_step_ragged(torch.from_numpy(xt), tc,
                                   torch.from_numpy(active))
    check(jy, jc, ty, tc)
    assert tc[0].kv_len.tolist() == [P + 3] * td.kv_heads + \
        [P + 2] * td.kv_heads

    # speculative verification from equal lengths, then rollback
    jy, jc = prefill(params, jnp.asarray(x), jd.init_caches(B))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(B))
    xq = rng.randn(B, 4, 32).astype(np.float32)
    jy, jc = multi(params, jnp.asarray(xq), jc)
    ty, tc = td.decode_multi(torch.from_numpy(xq), tc)
    check(jy, jc, ty, tc)
    jc, tc = jd.rollback(jc, 3), td.rollback(tc, 3)
    xt = rng.randn(B, 1, 32).astype(np.float32)
    jy, jc = step(params, jnp.asarray(xt), jc)
    ty, tc = td.decode_step(torch.from_numpy(xt), tc)
    check(jy, jc, ty, tc)
    assert tc[0].kv_len.tolist() == [P + 2] * (B * td.kv_heads)


def test_decode_multi_equals_sequential_steps():
    """Teacher-forced, q draft tokens at once equal q decode steps."""
    _, _, td, x = _decoder_pair(None, None, 0)
    xq = torch.from_numpy(
        np.random.RandomState(6).randn(B, 3, 32).astype(np.float32))
    _, c0 = td.prefill(torch.from_numpy(x), td.init_caches(B))
    ym, _ = td.decode_multi(xq, tuple(c.clone() for c in c0))
    ys = []
    caches = c0
    for i in range(3):
        y, caches = td.decode_step(xq[:, i:i + 1], caches)
        ys.append(y)
    torch.testing.assert_close(ym, torch.cat(ys, 1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["uniform", "prompt_lengths",
                                  "eos_penalty"])
def test_generate_greedy_tokens_equal_jax(lm_pair, case):
    jlm, params, tlm = lm_pair
    prompt = np.random.RandomState(7).randint(0, V, (B, P))
    n_new = 5
    kw, tkw = {}, {}
    if case == "prompt_lengths":
        lens = np.array([11, 16])
        prompt[0, 11:] = 0
        kw = dict(prompt_lengths=jnp.asarray(lens, jnp.int32))
        tkw = dict(prompt_lengths=torch.from_numpy(lens))
    js = JServer(jlm, s_max=P + n_new, bk=8, cache_dtype=jnp.float32)
    ts = LMServer(tlm, s_max=P + n_new, bk=8, cache_dtype=torch.float32)
    if case == "eos_penalty":
        free, _ = js.generate(params, jnp.asarray(prompt), n_new,
                              temperature=0.0, repetition_penalty=1.5)
        kw = tkw = dict(eos_id=int(np.asarray(free)[0, 1]), pad_id=3,
                        repetition_penalty=1.5)
    want, jc = js.generate(params, jnp.asarray(prompt), n_new,
                           temperature=0.0, **kw)
    got, tc = ts.generate(torch.from_numpy(prompt), n_new, **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                  np.asarray(jc[0].kv_len))
    if case == "eos_penalty":
        assert (got[0, 2:] == 3).all()


def test_unported_server_options_raise(lm_pair):
    tlm = lm_pair[2]
    with pytest.raises(NotImplementedError, match="A13"):
        LMServer(tlm, s_max=32, n_pages=8)
    with pytest.raises(NotImplementedError, match="A17"):
        LMServer(tlm, s_max=32, decoder=object())
    with pytest.raises(ValueError, match="generator"):
        LMServer(tlm, s_max=32, bk=8).generate(
            torch.zeros(B, P, dtype=torch.long), 2, temperature=0.5)


def test_sample_logits_properties():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(4, V).astype(np.float32) * 3)
    best = logits.argmax(-1)
    assert torch.equal(sample_logits(logits, temperature=0.0), best)
    g = torch.Generator().manual_seed(0)
    for _ in range(4):   # top_k = 1 and a tiny top_p collapse to argmax
        assert torch.equal(sample_logits(logits, g, top_k=1), best)
        assert torch.equal(sample_logits(logits, g, top_p=1e-9), best)
    draws = torch.stack([sample_logits(logits, g, top_k=5)
                         for _ in range(64)])
    top5 = torch.topk(logits, 5).indices
    for row in range(4):
        assert set(draws[:, row].tolist()) <= set(top5[row].tolist())

    def nucleus(probs, p):
        order = np.argsort(-probs)
        cum = np.cumsum(probs[order])
        return set(order[: int(np.searchsorted(cum, p) + 1)].tolist())

    probs = torch.softmax(logits, -1).numpy()
    draws = torch.stack([sample_logits(logits, g, top_p=0.5)
                         for _ in range(64)])
    for row in range(4):
        assert set(draws[:, row].tolist()) <= nucleus(probs[row], 0.5)
    # temperature applies before the nucleus: at T = 4 the p = 0.5 nucleus
    # of the flattened distribution is wider, and draws leave the T = 1 one
    probs_t = torch.softmax(logits / 4.0, -1).numpy()
    draws = torch.stack([sample_logits(logits, g, temperature=4.0,
                                       top_p=0.5) for _ in range(256)])
    for row in range(4):
        seen = set(draws[:, row].tolist())
        assert seen <= nucleus(probs_t[row], 0.5)
        assert seen - nucleus(probs[row], 0.5)
    # the same generator seed gives the same tokens
    a = sample_logits(logits, torch.Generator().manual_seed(9),
                      temperature=0.8, top_k=20)
    b = sample_logits(logits, torch.Generator().manual_seed(9),
                      temperature=0.8, top_k=20)
    assert torch.equal(a, b)


def test_sampled_generate_is_reproducible(lm_pair):
    tlm = lm_pair[2]
    prompt = torch.from_numpy(np.random.RandomState(8).randint(0, V, (B, P)))
    srv = LMServer(tlm, s_max=P + 4, bk=8, cache_dtype=torch.bfloat16)

    def run(seed):
        return srv.generate(prompt, 4, torch.Generator().manual_seed(seed),
                            temperature=0.8, top_k=5)[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and ((a >= 0) & (a < V)).all()
    assert not torch.equal(a, c)
