"""The model and serving remainders of the port against the JAX package:
``SparseTransformer(remat=True)``, ``divide`` /
``split_tensor_along_last_dim``, ``flash_stream``, ``attention_layout=
"auto"`` and ``SparseDecoder.cast_params``, plus the continuous-batching
and speculative serving examples at ``--small``.

CPU only, tiny models (2 layers, h = 32, s <= 64). Weights cross from flax
through ``bridge``. Tolerances: remat and ``auto`` 1e-5 x max(1, max|ref|)
against JAX, bit-equal within the port; ``cast_params`` 1e-4 x max(1,
max|ref|) against JAX's cast route.
"""

import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import LMServer as JServer
from sputnik_tpu.models import SparseLM as JLM
from sputnik_tpu.models import transformer as jtr
from sputnik_tpu.models.serving import SparseDecoder as JDecoder
import sputnik_tpu_torch as stt
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.models import (LMServer, SparseDecoder, SparseLM,
                                      SparseTransformer)
from sputnik_tpu_torch.models import transformer as ttr

B, S, H = 2, 64, 32
CFG = dict(num_layers=2, hidden_size=H, num_heads=2, ffn_hidden_size=48,
           use_residual=True, use_layernorm=True, activation="gelu")


def _causal(b, s):
    return np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                           (b, s, s)).copy()


def _close(got, ref, rel):
    ref = np.asarray(ref, np.float64)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol)


def _perturb(params, seed):
    """flax inits biases to 0 and LayerNorm scales to 1: give them values."""
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


def _run(model, x, g):
    """Output and every gradient (parameters by name, then the input) of
    ``sum(model(x) * g)``."""
    model.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = model(xt)
    (y * torch.from_numpy(g)).sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return y.detach(), grads, xt.grad.clone()


def _port_pair(layout, **kw):
    """Two port models on the same weights: remat off and on."""
    masks = _causal(B, S)
    cfg = dict(CFG, attention_layout=layout, **kw)
    plain = SparseTransformer.from_masks(
        masks, generator=torch.Generator().manual_seed(0), **cfg)
    remat = SparseTransformer.from_masks(masks, remat=True, **cfg)
    remat.load_state_dict(plain.state_dict())
    return plain, remat


@pytest.mark.parametrize("layout", ["xla", "flash"])
def test_remat_equals_no_remat(layout):
    """remat recomputes the same layers: output and gradients bit-equal
    (the flash layout through its kernels' plain versions)."""
    plain, remat = _port_pair(layout)
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, H).astype(np.float32)
    g = rng.randn(B, S, H).astype(np.float32)
    y0, p0, x0 = _run(plain, x, g)
    y1, p1, x1 = _run(remat, x, g)
    assert torch.equal(y0, y1) and torch.equal(x0, x1)
    assert p0.keys() == p1.keys()
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    # no grad: the layers run plainly, with the same result
    with torch.no_grad():
        assert torch.equal(remat(torch.from_numpy(x)), y0)


def test_remat_matches_jax_remat():
    """The port's remat=True against flax SparseTransformer(remat=True) on
    the same weights (xla layout): output, parameter and input gradients
    within 1e-5 x max(1, max|ref|)."""
    s = 32
    masks = _causal(B, s)
    rng = np.random.RandomState(2)
    x = rng.randn(B, s, H).astype(np.float32)
    g = rng.randn(B, s, H).astype(np.float32)
    cfg = dict(CFG, attention_layout="xla")
    jm = jtr.SparseTransformer.from_masks(masks, remat=True, **cfg)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), x), 3)

    def loss(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * g), y

    (_, ref), (jg_p, jg_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    tm = SparseTransformer.from_masks(masks, remat=True, **cfg)
    tm.load_state_dict(bridge.transformer_state_dict(params))
    y, grads, gx = _run(tm, x, g)
    _close(y.numpy(), ref, 1e-5)
    _close(gx.numpy(), jg_x, 1e-5)
    want = bridge.transformer_state_dict(jg_p)
    assert set(want) == set(grads)
    for n, w in want.items():
        _close(grads[n].numpy(), w.numpy(), 1e-5)


def test_remat_keeps_the_moe_aux_loss_gradient():
    """A MoE layer under remat: the router's gradient through the task loss
    and the aux loss is bit-equal to the plain model's, and so are the aux
    loss and the routing the recompute leaves behind."""
    rng = np.random.RandomState(4)
    m_in = (rng.rand(48, H) < 0.4).astype(np.float32)
    m_out = (rng.rand(H, 48) < 0.4).astype(np.float32)
    moe = dict(topo_in=stt.SparseTopology.from_dense_mask(m_in),
               topo_out=stt.SparseTopology.from_dense_mask(m_out),
               num_experts=4, top_k=2)
    plain, remat = _port_pair("xla", moe=moe, moe_every=1)
    x = rng.randn(B, S, H).astype(np.float32)
    g = rng.randn(B, S, H).astype(np.float32)
    out = []
    for model in (plain, remat):
        model.zero_grad(set_to_none=True)
        y = model(torch.from_numpy(x))
        aux = model.aux_loss()
        ((y * torch.from_numpy(g)).sum() + 0.01 * aux).backward()
        out.append((aux.detach(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()},
                    [layer.mlp.last_experts.clone()
                     for layer in model.layers]))
    (a0, g0, e0), (a1, g1, e1) = out
    assert torch.equal(a0, a1) and a0 > 0
    routers = [n for n in g0 if "router" in n]
    assert len(routers) == 2
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert all(torch.equal(u, v) for u, v in zip(e0, e1))


def test_divide_and_split_match_jax():
    x = np.random.RandomState(5).randn(3, 4, 12).astype(np.float32)
    for parts in (1, 2, 3, 4, 6, 12):
        assert ttr.divide(12, parts) == jtr.divide(12, parts)
        got = ttr.split_tensor_along_last_dim(torch.from_numpy(x), parts)
        ref = jtr.split_tensor_along_last_dim(jnp.asarray(x), parts)
        assert len(got) == len(ref) == parts
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    t = torch.from_numpy(x)
    assert ttr.split_tensor_along_last_dim(t, 4)[1].data_ptr() == \
        t[..., 3:].data_ptr()                       # views, not copies
    for fn in (lambda m: m.divide(12, 5),
               lambda m: m.split_tensor_along_last_dim(
                   (torch if m is ttr else jnp).zeros((2, 12)), 5)):
        for mod in (ttr, jtr):
            with pytest.raises(ValueError, match="12 is not divisible by 5"):
                fn(mod)
    assert {"divide", "split_tensor_along_last_dim"} <= set(ttr.__all__)


@pytest.mark.parametrize("layout", ["flash", "xla"])
def test_flash_stream_changes_nothing(layout):
    """flash_stream="bf16" (a TPU-only switch in JAX) gives bit-equal
    outputs and gradients to None; the value is not validated."""
    masks = _causal(B, S)
    base = SparseTransformer.from_masks(
        masks, attention_layout=layout,
        generator=torch.Generator().manual_seed(6), **CFG)
    streamed = SparseTransformer.from_masks(
        masks, attention_layout=layout, flash_stream="bf16", **CFG)
    streamed.load_state_dict(base.state_dict())
    assert streamed.layers[0].self_attention.core.flash_stream == "bf16"
    SparseTransformer.from_masks(masks, flash_stream="anything", **CFG)
    rng = np.random.RandomState(7)
    x = rng.randn(B, S, H).astype(np.float32)
    g = rng.randn(B, S, H).astype(np.float32)
    y0, p0, x0 = _run(base, x, g)
    y1, p1, x1 = _run(streamed, x, g)
    assert torch.equal(y0, y1) and torch.equal(x0, x1)
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_auto_layout_on_both_sides_of_the_crossover(route, monkeypatch):
    """layout="auto" takes the xla layout below the port's crossover and
    the flash one at or above it (the constant moved to put s = 32 on
    either side); both equal the named layout's bits, and JAX's "auto" at
    the same s within 1e-5 x max(1, max|ref|)."""
    s = 32
    monkeypatch.setattr(ttr, "_XLA_FLASH_CROSSOVER",
                        s + 1 if route == "xla" else s)
    masks = _causal(B, s)
    rng = np.random.RandomState(8)
    x = rng.randn(B, s, H).astype(np.float32)
    jm = jtr.SparseTransformer.from_masks(masks, attention_layout="auto",
                                          **CFG)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(1), x), 9)
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    sd = bridge.transformer_state_dict(params)
    out = {}
    for layout in ("auto", route):
        tm = SparseTransformer.from_masks(masks, attention_layout=layout,
                                          **CFG)
        tm.load_state_dict(sd)
        with torch.no_grad():
            out[layout] = tm(torch.from_numpy(x))
    assert torch.equal(out["auto"], out[route])
    _close(out["auto"].numpy(), ref, 1e-5)


def _lm_pair(tie=True):
    toks = np.random.RandomState(10).randint(0, 97, (B, 16))
    cfg = dict(CFG, num_kv_heads=1)
    jlm = JLM.from_masks(_causal(B, 16), vocab_size=97, tie_embeddings=tie,
                         **cfg)
    params = _perturb(jax.jit(jlm.init)(jax.random.PRNGKey(2),
                                        jnp.asarray(toks)), 11)
    tlm = SparseLM.from_masks(_causal(B, 16), vocab_size=97,
                              tie_embeddings=tie, **cfg)
    tlm.load_state_dict(bridge.lm_state_dict(params))
    return jlm, params, tlm, toks


def _check_cast(module):
    for n, p in module.named_parameters():
        ln = any(part.startswith("ln_") for part in n.split("."))
        assert p.dtype == (torch.float32 if ln else torch.bfloat16), n


def test_cast_params_decoder_matches_jax():
    """prefill and 3 decode steps of a decoder over bf16-stored weights
    against JAX's SparseDecoder on cast_params of the same weights, f32
    activations and cache: 1e-4 x max(1, max|ref|); lengths equal."""
    jlm, params, tlm, _ = _lm_pair()
    jcore_p = {"params": params["params"]["core"]}
    jd = JDecoder(jlm.core, s_max=32, bk=8, cache_dtype=jnp.float32)
    td = SparseDecoder(tlm.core, s_max=32, bk=8, cache_dtype=torch.float32)
    assert SparseDecoder.cast_params(tlm.core) is tlm.core
    _check_cast(tlm.core)
    jp = JDecoder.cast_params(jcore_p)
    rng = np.random.RandomState(12)
    x = rng.randn(B, 16, H).astype(np.float32)
    jy, jc = jax.jit(jd.prefill)(jp, jnp.asarray(x), jd.init_caches(B))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(B))
    assert ty.dtype == torch.float32
    _close(ty.numpy(), jy, 1e-4)
    step = jax.jit(jd.decode_step)
    for _ in range(3):
        xt = rng.randn(B, 1, H).astype(np.float32)
        jy, jc = step(jp, jnp.asarray(xt), jc)
        ty, tc = td.decode_step(torch.from_numpy(xt), tc)
        _close(ty.numpy(), jy, 1e-4)
        np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                      np.asarray(jc[0].kv_len))


@pytest.mark.parametrize("cast", [False, True])
def test_decode_loop_matches_jax(cast):
    """decode_loop (the loop the card replays as a graph; eager here) against
    JAX's jitted scan, with a next_input between steps, on f32 and on
    cast weights: outputs 1e-4 x max(1, max|ref|), lengths equal."""
    jlm, params, tlm, _ = _lm_pair()
    jp = {"params": params["params"]["core"]}
    jd = JDecoder(jlm.core, s_max=32, bk=8, cache_dtype=jnp.float32)
    td = SparseDecoder(tlm.core, s_max=32, bk=8, cache_dtype=torch.float32)
    if cast:
        jp = JDecoder.cast_params(jp)
        SparseDecoder.cast_params(tlm.core)
    x = np.random.RandomState(13).randn(B, 16, H).astype(np.float32)
    jy, jc = jax.jit(jd.prefill)(jp, jnp.asarray(x), jd.init_caches(B))
    ty, tc = td.prefill(torch.from_numpy(x), td.init_caches(B))
    jys, jc = jax.jit(lambda p, t, c: jd.decode_loop(
        p, t, c, 5, next_input=lambda y: jnp.tanh(y) * 0.5))(
            jp, jy[:, -1:], jc)
    tys, tc = td.decode_loop(ty[:, -1:], tc, 5,
                             next_input=lambda y: torch.tanh(y) * 0.5)
    assert tys.shape == (5, B, 1, H)
    _close(tys.numpy(), jys, 1e-4)
    np.testing.assert_array_equal(tc[0].kv_len.numpy(),
                                  np.asarray(jc[0].kv_len))
    with pytest.raises(ValueError, match="n_tokens"):
        td.decode_loop(ty[:, -1:], tc, 0)


@pytest.mark.parametrize("tie", [True, False])
def test_cast_params_server_logits_match_jax(tie):
    """LMServer over a cast SparseLM (the bf16 embedding feeding the first
    LayerNorm and the residual, the head from bf16 weights): the prefill's
    and 3 decode steps' logits against JAX's LMServer on cast_params,
    1e-4 x max(1, max|ref|)."""
    jlm, params, tlm, toks = _lm_pair(tie)
    jsrv = JServer(jlm, s_max=32, bk=8, cache_dtype=jnp.float32)
    srv = LMServer(tlm, s_max=32, bk=8, cache_dtype=torch.float32)
    SparseDecoder.cast_params(tlm)
    _check_cast(tlm)
    assert tlm.embed.weight.dtype == torch.bfloat16
    jp = JDecoder.cast_params(params)
    jl, jc = jax.jit(jsrv.prefill)(jp, jnp.asarray(toks),
                                   jsrv.init_caches(B))
    tl, tc = srv.prefill(torch.from_numpy(toks), srv.init_caches(B))
    _close(tl.numpy(), jl, 1e-4)
    step = jax.jit(jsrv.decode_step)
    tok = np.asarray(jl[:, -1].argmax(-1))
    for _ in range(3):
        jl, jc = step(jp, jnp.asarray(tok), jc)
        tl, tc = srv.decode_step(torch.from_numpy(tok), tc)
        _close(tl.numpy(), jl, 1e-4)
        tok = np.asarray(jl.argmax(-1))


def test_cast_params_examples_and_modules():
    """The generate example's --bf16-params runs at --small; casting a
    transformer keeps its LayerNorms f32 and returns it."""
    from sputnik_tpu_torch.examples import generate

    t_prefill, dt = generate.main(["--small", "--device", "cpu",
                                   "--bf16-params", "--tokens", "4"])
    assert t_prefill > 0 and dt > 0
    tm = SparseTransformer.from_masks(_causal(1, 16), **CFG)
    SparseDecoder.cast_params(tm, torch.float16)
    assert tm.layers[1].mlp.to_h.weight.dtype == torch.float16
    assert tm.layers[1].ln_mlp.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["serve_continuous", "serve_speculative"])
def test_serving_example_runs_small(name, monkeypatch):
    """The example as a script at ``--small`` on the CPU, its self-checks
    raising on failure: every queued request completes; the speculative
    stream equals plain greedy decoding's (f32 cache) and the identical
    draft is fully accepted."""
    argv = [name, "--small", "--device", "cpu"]
    if name == "serve_speculative":
        argv += ["--reps", "1"]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_module(f"sputnik_tpu_torch.examples.{name}",
                     run_name="__main__")


def test_examples_refuse_a_missing_device(monkeypatch):
    from sputnik_tpu_torch.examples import serve_continuous, serve_speculative

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ex in (serve_continuous, serve_speculative):
        with pytest.raises(RuntimeError, match="no CUDA"):
            ex.main(["--small"])
