"""The port's tensor-parallel serving (``parallel.TPDecoder``,
``PagedTPDecoder``, ``TPLMServer``) on the one-device CPU mesh, against
JAX's on the conftest's 8-device CPU mesh and against the port's unsharded
decoders; and the hooks it rests on (``reduce_fn=``, ``LMServer(decoder=)``,
``write_prompt_pages`` with device page ids) against JAX's.

Weights cross through ``bridge``; inputs come from numpy seeds. Each JAX
reference runs once a module (fixtures) and several port routes are held
against it. Tolerances: TP on the one-device mesh against the port's
unsharded decoder atol = rtol = 1e-5 (JAX's own, ``tests/test_serving_tp
.py``); against JAX with an f32 cache 1e-4 (the port's decoder parity
tolerance); with a bf16 cache 2e-3; greedy tokens and lengths exactly.
The models are tiny: h = 32, 4 heads, 2 layers, ffn 64, V = 97.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sputnik_tpu.models import LMServer as JServer
from sputnik_tpu.models import SparseLM as JLM
from sputnik_tpu.models.serving import SparseDecoder as JDecoder
from sputnik_tpu.models.transformer import SparseTransformer as JST
from sputnik_tpu.ops import paged as jpg
from sputnik_tpu.parallel import PagedTPDecoder as JPagedTP
from sputnik_tpu.parallel import TPDecoder as JTP
from sputnik_tpu.parallel import TPLMServer as JTPLM
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.dryrun import dryrun_tp_serving
from sputnik_tpu_torch.examples import serve_tp
from sputnik_tpu_torch.models import (LMServer, PagedDecoder, SparseDecoder,
                                      SparseLM, SparseTransformer)
from sputnik_tpu_torch.ops import paged as tpg
from sputnik_tpu_torch.parallel import (Mesh, PagedTPDecoder, TPDecoder,
                                        TPLMServer)

V, H = 97, 32
CFG = dict(num_layers=2, hidden_size=H, num_heads=4, ffn_hidden_size=64,
           use_residual=True, use_layernorm=True, activation="gelu")
TOL_TP = dict(atol=1e-5, rtol=1e-5)
TOL_JAX = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=2e-3, rtol=2e-3)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _causal(b, s):
    return np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                           (b, s, s)).copy()


def _perturb(params, seed):
    """flax inits biases to 0 and LayerNorm scales to 1: give them values,
    so the comparison sees them (and the biases' division by tp)."""
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


def _init(cls, seed, x, **cfg):
    """Perturbed flax params of ``cls`` (a JAX SparseTransformer or
    SparseLM), initialised on a 16-token mask: the params' shapes do not
    depend on the masks', and the small init compiles fastest."""
    m = cls.from_masks(_causal(x.shape[0], 16), **cfg)
    return _perturb(jax.jit(m.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:, :16])), seed + 1)


def _pair(b, s, seed, kv=None):
    """A JAX SparseTransformer with its params and the port's with the same
    weights."""
    cfg = dict(CFG, num_kv_heads=kv)
    x = np.random.RandomState(seed).randn(b, 16, H).astype(np.float32)
    params = _init(JST, seed, x, **cfg)
    jm = JST.from_masks(_causal(b, s), **cfg)
    tm = SparseTransformer.from_masks(_causal(b, s), **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    return jm, params, tm


def _port_model(b, s, seed, kv=None):
    """The port's model alone (no JAX reference needed), its biases and
    LayerNorms moved away from 0 / 1 as ``_perturb`` moves JAX's."""
    tm = SparseTransformer.from_masks(
        _causal(b, s), **dict(CFG, num_kv_heads=kv),
        generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if "bias" in name or ".ln_" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return tm


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return JMesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                 tuple(axes))


def _inputs(b, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shape) * 0.3).astype(np.float32) for k, shape in
            (("x", (b, 16, H)), ("ragged", (b, 1, H)), ("multi", (b, 3, H)),
             ("after", (b, 1, H)))}


def _route(dec, inp, full=True):
    """prefill, two uniform steps (``decode_loop``), then (``full``) a
    ragged step freezing the last row, ``decode_multi`` q = 3, a rollback of
    1 and a step: the outputs and lengths of a port decoder."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    b = t["x"].shape[0]
    out = {}
    c = dec.init_caches(b)
    out["prefill"], c = dec.prefill(t["x"], c)
    out["steps"], c = dec.decode_loop(out["prefill"][:, -1:], c, 2)
    if full:
        act = torch.ones(b, dtype=torch.bool)
        act[-1] = False
        out["ragged"], c = dec.decode_step_ragged(t["ragged"], c, act)
        out["multi"], c = dec.decode_multi(t["multi"], c)
        c = dec.rollback(c, 1)
        out["after"], c = dec.decode_step(t["after"], c)
    out["kv_len"] = c[0].kv_len
    return out


def _jax_route(jt, params, inp, full=True):
    """``_route`` through a JAX TPDecoder (decode_step twice for the loop)."""
    x = {k: jnp.asarray(v) for k, v in inp.items()}
    b = x["x"].shape[0]
    sp = jt.shard_params(params)
    out = {}
    c = jt.init_caches(b)
    out["prefill"], c = jt.prefill(sp, x["x"], c)
    y1, c = jt.decode_step(sp, out["prefill"][:, -1:], c)
    y2, c = jt.decode_step(sp, y1, c)
    out["steps"] = jnp.stack([y1, y2])
    if full:
        act = np.ones(b, bool)
        act[-1] = False
        out["ragged"], c = jt.decode_step_ragged(sp, x["ragged"], c,
                                                 jnp.asarray(act))
        out["multi"], c = jt.decode_multi(sp, x["multi"], c)
        c = JDecoder.rollback(c, 1)
        out["after"], c = jt.decode_step(sp, x["after"], c)
    out["kv_len"] = c[0].kv_len
    return {k: np.asarray(v.astype(jnp.float32) if k != "kv_len" else v)
            for k, v in out.items()}


# (name, b, kv heads, mesh axes, cache, full route)
JAX_CASES = {
    "mha_tp2": (2, None, {"tp": 2}, "f32", True),
    "gqa_dp2_tp2_bf16": (4, 2, {"dp": 2, "tp": 2}, "bf16", False),
}


@pytest.fixture(scope="module")
def jax_refs():
    """Each JAX case once: ``{name: (port model, inputs, JAX outputs)}``."""
    out = {}
    for seed, (name, (b, kv, axes, cache, full)) in enumerate(
            JAX_CASES.items()):
        jm, params, tm = _pair(b, 16, 10 * seed, kv)
        inp = _inputs(b, 10 * seed + 5)
        jt = JTP(jm, _jmesh(axes), batch_axis="dp" if "dp" in axes else None,
                 s_max=24, bk=8, cache_dtype=DT[cache][0])
        out[name] = (tm, inp, _jax_route(jt, params, inp, full))
    return out


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_tp_decoder_matches_jax(jax_refs, name):
    """Every step's output of the port's TPDecoder within 1e-4 of JAX's
    (2e-3 with the bf16 cache): MHA at tp 2 on the whole route, GQA (2 KV
    heads) at dp 2 x tp 2; the shard-major lengths equal."""
    b, kv, axes, cache, full = JAX_CASES[name]
    tm, inp, want = jax_refs[name]
    tpd = TPDecoder(tm, Mesh(axes), batch_axis="dp" if "dp" in axes else
                    None, s_max=24, bk=8, cache_dtype=DT[cache][1])
    got = _route(tpd, inp, full)
    tol = TOL_BF16 if cache == "bf16" else TOL_JAX
    for k, w in want.items():
        g = got[k].numpy()
        if k == "kv_len":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("kv,axes", [
    (None, {"tp": 2}), (None, {"tp": 4}), (2, {"tp": 2}),
    (None, {"dp": 2, "tp": 2}), (2, {"dp": 2, "tp": 2})])
def test_tp_decoder_matches_unsharded(kv, axes):
    """The whole route (prefill, decode_loop, ragged with a frozen row,
    decode_multi + rollback + step) at 1e-5 of the port's unsharded
    SparseDecoder; the lengths are the unsharded ones in every shard."""
    b = 2 * axes.get("dp", 1)
    tm = _port_model(b, 16, 3, kv)
    inp = _inputs(b, 4)
    kw = dict(s_max=24, bk=8, cache_dtype=torch.float32)
    ref = _route(SparseDecoder(tm, **kw), inp)
    tpd = TPDecoder(tm, Mesh(axes), batch_axis="dp" if "dp" in axes else
                    None, **kw)
    got = _route(tpd, inp)
    for k in ("prefill", "steps", "ragged", "multi", "after"):
        torch.testing.assert_close(got[k], ref[k], msg=k, **TOL_TP)
    dp, tp, kvl = tpd.dp, tpd.tp, tpd.KV_l
    want = ref["kv_len"].reshape(dp, b // dp, tp, kvl).permute(
        0, 2, 1, 3).reshape(-1)                      # shard-major rows
    assert torch.equal(got["kv_len"], want)
    assert got["kv_len"].shape[0] == tpd.n_shards * (b // tpd.dp) * kvl


def _paged_route(dec, x, toks, jax_params=None):
    """prefill, reserve + step, release slot 1, share slot 0's prompt into
    it, reserve + step, per-slot rollback [0, 1], reserve + step: outputs,
    final lengths, tables and free pages (JAX: ``jax_params`` given)."""
    J = jax_params is not None
    sp = dec.shard_params(jax_params) if J else None
    P = x.shape[1]
    ys = []
    c = dec.init_caches(x.shape[0])
    y, c = (dec.prefill(sp, jnp.asarray(x), c) if J
            else dec.prefill(torch.from_numpy(x), c))
    ys.append(y[:, -1:])
    for i in range(3):
        if i == 1:
            c = dec.release(c, 1)
            c = dec.share_prefix(c, 0, 1, P)
        if i == 2:
            n = np.array([0, 1], np.int32)
            c = dec.rollback(c, jnp.asarray(n) if J else torch.from_numpy(n))
        c = dec.reserve(c, 1)
        t = toks[i]
        y, c = (dec.decode_step(sp, jnp.asarray(t), c) if J
                else dec.decode_step(torch.from_numpy(t), c))
        ys.append(y)
    f = (lambda a: np.asarray(a)) if J else (lambda a: a.numpy())
    return ([f(y) for y in ys], f(c[0].kv_len), f(c[1].page_table),
            dec.free_pages)


def test_paged_tp_decoder_matches_jax_and_unsharded():
    """PagedTPDecoder at tp 2: prefill, steps, release / share_prefix /
    per-slot rollback, each step within 1e-4 of JAX's PagedTPDecoder (its
    lengths, page tables and free pages equal) and within 1e-5 of the
    port's unsharded PagedDecoder."""
    b, P, n_pages = 2, 128, 12
    jm, params, tm = _pair(b, P, 7)
    rng = np.random.RandomState(8)
    x = (rng.randn(b, P, H) * 0.3).astype(np.float32)
    toks = (rng.randn(3, b, 1, H) * 0.3).astype(np.float32)
    kw = dict(n_pages=n_pages, s_max=2 * P, bk=P)
    jt = JPagedTP(jm, _jmesh({"tp": 2}), cache_dtype=jnp.float32, **kw)
    want = _paged_route(jt, x, toks, params)
    tpd = PagedTPDecoder(tm, Mesh({"tp": 2}), cache_dtype=torch.float32,
                         **kw)
    got = _paged_route(tpd, x, toks)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL_JAX)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    assert got[1].tolist() == ([P + 3] * 2 + [P + 1] * 2) * 2
    one = _paged_route(PagedDecoder(tm, cache_dtype=torch.float32,
                                    **dict(kw, n_pages=2 * n_pages)), x, toks)
    for i, (g, w) in enumerate(zip(got[0], one[0])):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL_TP)


@pytest.fixture(scope="module")
def lm_pair():
    """A JAX SparseLM (P = 128) and the port's, same weights."""
    b, P = 2, 128
    toks = np.random.RandomState(11).randint(0, V, (b, P))
    jlm = JLM.from_masks(_causal(b, P), vocab_size=V, **CFG)
    params = _init(JLM, 12, toks, vocab_size=V, **CFG)
    tlm = SparseLM.from_masks(_causal(b, P), vocab_size=V, **CFG)
    tlm.load_state_dict(bridge.lm_state_dict(params))
    return jlm, params, tlm, toks


@pytest.mark.parametrize("paged", [False, True])
def test_tplm_greedy_matches_jax(lm_pair, paged):
    """TPLMServer greedy at tp 2 (contiguous, paged): tokens equal to JAX's
    TPLMServer and to the port's unsharded LMServer; lengths equal JAX's;
    every shard's pool gave pages."""
    jlm, params, tlm, toks = lm_pair
    P, n_new = toks.shape[1], 4
    kw = dict(s_max=P + 128, bk=128)
    if paged:
        kw["n_pages"] = 10
    jsrv = JTPLM(jlm, _jmesh({"tp": 2}), cache_dtype=jnp.float32, **kw)
    want, jc = jsrv.generate(jsrv.shard_params(params), jnp.asarray(toks),
                             n_new)
    srv = TPLMServer(tlm, Mesh({"tp": 2}), cache_dtype=torch.float32, **kw)
    got, tc = srv.generate(torch.from_numpy(toks), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                  np.asarray(jc[0].kv_len))
    ref, _ = LMServer(tlm, s_max=P + 128, bk=128,
                      cache_dtype=torch.float32).generate(
        torch.from_numpy(toks), n_new)
    assert torch.equal(got, ref)
    if paged:
        assert srv.tpd.free_pages == jsrv.tpd.free_pages
        assert all(f < 10 for layer in srv.tpd.free_pages for f in layer)


def test_tplm_dp_sampling_deterministic_and_decorrelated():
    """dp 2 x tp 2, T = 1: the same generator seed gives the same tokens,
    and dp slices given the same prompt sample different tokens (each
    slice's generator seeded from the caller's); prompt_lengths and the
    other sampling options pass through."""
    b, P = 4, 16
    lm = SparseLM.from_masks(_causal(b, P), vocab_size=V, **CFG,
                             generator=torch.Generator().manual_seed(2))
    prompts = torch.from_numpy(np.tile(
        np.random.RandomState(2).randint(0, V, (1, P)), (b, 1)))
    srv = TPLMServer(lm, Mesh({"dp": 2, "tp": 2}), batch_axis="dp",
                     s_max=P + 8, bk=8, cache_dtype=torch.float32)

    def gen(seed, **kw):
        return srv.generate(prompts, 6, torch.Generator().manual_seed(seed),
                            temperature=1.0, **kw)[0]

    t1, t2 = gen(7), gen(7)
    assert torch.equal(t1, t2)
    assert t1.shape == (b, 6) and ((t1 >= 0) & (t1 < V)).all()
    assert not torch.equal(t1[:2], t1[2:])
    t3 = gen(7, top_k=5, top_p=0.9, repetition_penalty=1.3,
             prompt_lengths=[16, 12, 16, 12])
    assert torch.equal(t3, gen(7, top_k=5, top_p=0.9,
                               repetition_penalty=1.3,
                               prompt_lengths=[16, 12, 16, 12]))
    greedy = srv.generate(prompts, 6)[0]
    ref = LMServer(lm, s_max=P + 8, bk=8, cache_dtype=torch.float32)
    assert torch.equal(greedy, ref.generate(prompts, 6)[0])


def test_tp_validation_errors_match_jax():
    """JAX's errors, raised by both packages: heads, KV heads and ffn not
    divisible by tp; dp over distinct masks."""
    cases = [({"tp": 3}, {}, None, "num_heads 4 not divisible by tp 3"),
             ({"tp": 4}, dict(num_kv_heads=2), None,
              "num_kv_heads 2 not divisible by tp 4"),
             ({"tp": 4}, dict(ffn_hidden_size=66), None,
              "ffn_hidden_size 66 not divisible by tp 4")]
    masks = _causal(2, 16)
    masks[1, 0, 3] = 1.0
    for axes, extra, batch_axis, msg in cases:
        cfg = dict(CFG, **extra)
        jm = JST.from_masks(_causal(2, 16), **cfg)
        tm = SparseTransformer.from_masks(_causal(2, 16), **cfg)
        with pytest.raises(ValueError, match=msg):
            JTP(jm, _jmesh(axes), s_max=24, bk=8)
        with pytest.raises(ValueError, match=msg):
            TPDecoder(tm, Mesh(axes), s_max=24, bk=8)
    jm = JST.from_masks(masks, **CFG)
    tm = SparseTransformer.from_masks(masks, **CFG)
    with pytest.raises(ValueError, match="same mask"):
        JTP(jm, _jmesh({"dp": 2, "tp": 2}), batch_axis="dp", s_max=24, bk=8)
    with pytest.raises(ValueError, match="same mask"):
        TPDecoder(tm, Mesh({"dp": 2, "tp": 2}), batch_axis="dp", s_max=24,
                  bk=8)
    with pytest.raises(ValueError, match="neither axis nor batch_axis"):
        TPDecoder(tm, Mesh({"dp": 2, "tp": 2}), s_max=24, bk=8)


def test_reduce_fn_and_external_decoder_match_jax():
    """``reduce_fn=`` (a scaling stands in for the psum): the prefill within
    1e-4 of JAX's; ``decode_multi`` equal to sequential ``decode_step`` calls
    with the hook (every step takes it through the same ``run_steps``);
    ``LMServer(decoder=)`` and ``generate(reduce_fn=)`` greedy tokens equal
    to JAX's. The LM's core (one layer: both reduce points) is the
    decoders' model."""
    b, P = 2, 16
    cfg = dict(CFG, num_layers=1)
    toks = np.random.RandomState(22).randint(0, V, (b, P))
    jlm = JLM.from_masks(_causal(b, P), vocab_size=V, **cfg)
    lparams = _init(JLM, 23, toks, vocab_size=V, **cfg)
    tlm = SparseLM.from_masks(_causal(b, P), vocab_size=V, **cfg)
    tlm.load_state_dict(bridge.lm_state_dict(lparams))
    params = {"params": lparams["params"]["core"]}
    kw = dict(s_max=P + 8, bk=8)
    jd = JDecoder(jlm.core, cache_dtype=jnp.float32, **kw)
    td = SparseDecoder(tlm.core, cache_dtype=torch.float32, **kw)

    def red(t):
        return t * 0.75

    rng = np.random.RandomState(21)
    x = (rng.randn(b, P, H) * 0.3).astype(np.float32)
    drafts = torch.from_numpy((rng.randn(b, 3, H) * 0.3).astype(np.float32))
    jy, jc = jax.jit(lambda c: jd.prefill(params, jnp.asarray(x), c,
                                          reduce_fn=red))(jd.init_caches(b))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(b),
                        reduce_fn=red)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL_JAX)
    np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                  np.asarray(jc[0].kv_len))
    seq = tuple(c.clone() for c in tc)
    ym, _ = td.decode_multi(drafts, tc, reduce_fn=red)
    for i in range(3):
        y1, seq = td.decode_step(drafts[:, i:i + 1], seq, reduce_fn=red)
        torch.testing.assert_close(ym[:, i:i + 1], y1, **TOL_TP)

    jsrv = JServer(jlm, decoder=jd)
    tsrv = LMServer(tlm, decoder=td)
    want, _ = jax.jit(lambda p, t: jsrv.generate(
        p, t, 4, reduce_fn=red))(lparams, jnp.asarray(toks))
    got, _ = tsrv.generate(torch.from_numpy(toks), 4, reduce_fn=red)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_prompt_pages_device_ids_match_jax():
    """Device page ids (a torch tensor; JAX: a traced array): the same pool
    bytes and lengths as JAX's traced branch, an unallocated id written to
    the dump page; host ids with one still raise."""
    R, bk, hd, nb, n_pages = 3, 128, 8, 2, 6
    rng = np.random.RandomState(30)
    k = rng.randn(R, nb * bk, hd).astype(np.float32)
    v = rng.randn(R, nb * bk, hd).astype(np.float32)
    pages = np.array([[4, 1], [0, 5], [2, -1]], np.int32)
    lengths = np.array([256, 200, 130], np.int32)
    jc, _ = jpg.init_paged_cache(R, n_pages, bk, hd, nb, dtype=jnp.float32)
    tc, _ = tpg.init_paged_cache(R, n_pages, bk, hd, nb, dtype=torch.float32)
    jc = jax.jit(lambda c, p: jpg.write_prompt_pages(
        c, jnp.asarray(k), jnp.asarray(v), replica_pages=p,
        lengths=jnp.asarray(lengths)))(jc, jnp.asarray(pages))
    tc = tpg.write_prompt_pages(tc, torch.from_numpy(k), torch.from_numpy(v),
                                replica_pages=torch.from_numpy(pages),
                                lengths=torch.from_numpy(lengths))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy()[:n_pages],
            np.asarray(getattr(jc, name))[:n_pages, ..., :hd]
            if name in ("k", "v") else
            np.asarray(getattr(jc, name))[:n_pages], err_msg=name)
    np.testing.assert_array_equal(tc.kv_len.numpy(), np.asarray(jc.kv_len))
    dump = k[2, bk:].copy()
    dump[lengths[2] - bk:] = 0.0           # pad tokens are zeroed
    np.testing.assert_allclose(tc.k.numpy()[tc.dump_page], dump)
    with pytest.raises(ValueError, match="unallocated"):
        tpg.write_prompt_pages(tc, torch.from_numpy(k), torch.from_numpy(v),
                               replica_pages=pages)


@pytest.mark.parametrize("n", [3, 4])
def test_dryrun_tp_serving_matches_unsharded(n):
    """``dryrun_tp_serving`` (the twin of JAX's ``_dryrun_tp_serving`` and
    ``_dryrun_tp_serving_ragged_spec``) on the CPU: tp 3, then dp 2 x tp 2;
    every route within 1e-5 of the unsharded decoder."""
    diffs = dryrun_tp_serving(n, "cpu")
    assert len(diffs) == 8
    assert max(diffs.values()) < 1e-5


def test_serve_tp_example_small():
    """``examples/serve_tp.py --small`` on one CPU mesh (dp 2 x tp 2, paged):
    its check against a one-device mesh passes."""
    out = serve_tp.main(["--small", "--device", "cpu", "--dp", "2", "--tp",
                         "2", "--paged", "--check", "--tokens", "3"])
    assert out["check"] == "tokens equal to the one-device mesh's"
    assert out["rows"] == 4 and out["mesh"] == {"dp": 2, "tp": 2}
