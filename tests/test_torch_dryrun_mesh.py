"""The dp x tp training step and the hierarchical mesh of the port's dry run
against the JAX package's ``__graft_entry__`` on the CPU.

  * ``dp_tp_step`` (what ``dryrun_dp_tp`` runs) on a (2, 2) one-device
    ``("dp", "tp")`` mesh against JAX's ``_dryrun_dp_tp`` train step on a
    (2, 2) mesh of the conftest's CPU devices, both from the flax weights of
    ``_build(4, 64, 64, 2, 1, 128)`` (biases and LayerNorms drawn away from
    0 / 1, carried by ``bridge``): the loss, every gradient and every
    parameter after one SGD step at lr 1e-3, within 1e-4 x max(1, |ref|);
  * ``dryrun_hier(4)`` against JAX's ``flash_attention_kv_sharded`` on a
    ``("host", "sp")`` 2 x 2 mesh on the same inputs (JAX's tiles bm 8, bk
    128; the port's 64): the loss and the q / k / v gradients within 1e-4 x
    max(1, max|ref|), and ``DRYRUN_COMM_HIER``'s numbers equal to the ones
    ``_dryrun_hier`` prints at 4 (the halo spans the band: the gather) and
    at 8 (the ragged exchange).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import __graft_entry__ as graft
from sputnik_tpu.parallel import RowPartition as JRowPartition
from sputnik_tpu.parallel.flash_sharded import (
    ShardedFlashSpec as JFlashSpec, flash_attention_kv_sharded as jkv)
from sputnik_tpu.patterns import local_window_topology as jwindow
from sputnik_tpu_torch import bridge
from sputnik_tpu_torch.dryrun import dp_tp_step, dryrun_hier
from sputnik_tpu_torch.models import SparseTransformer
from sputnik_tpu_torch.parallel import Mesh
from sputnik_tpu_torch.patterns import driver_masks


def _close(got, want, what, tol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def _perturbed(params, seed):
    """The flax params with biases and LayerNorm scales moved off 0 / 1."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + [k])
            elif k == "bias" or path[-1].startswith("ln"):
                out[k] = jnp.asarray(np.asarray(v) + 0.1 * rng.randn(
                    *np.shape(v)).astype(np.float32))
            else:
                out[k] = v
        return out

    return walk(params, [""])


def test_dp_tp_step_matches_jax_train_step():
    dp, tp = 2, 2
    b, s, h, heads, ffn = 2 * dp, 64, 32 * tp, tp, 64 * tp
    model, params, x = graft._build(b, s, h, heads, 1, ffn)
    params = _perturbed(params, 3)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(dp, tp), ("dp", "tp"))

    def shard_params(path, p):       # __graft_entry__._dryrun_dp_tp's rule
        names = [getattr(k, "key", str(k)) for k in path]
        if p.ndim == 2 and ("query_key_value" in names or "to_4h" in names):
            return NamedSharding(mesh, JP(None, "tp"))
        if p.ndim == 2 and ("to_h" in names or "dense" in names):
            return NamedSharding(mesh, JP("tp", None))
        return NamedSharding(mesh, JP())

    tx = optax.sgd(1e-3)
    jparams = jax.device_put(
        params, jax.tree_util.tree_map_with_path(shard_params, params))
    jx = jax.device_put(x, NamedSharding(mesh, JP("dp", None, None)))

    @jax.jit
    def train_step(p, xx):
        loss, grads = jax.value_and_grad(
            lambda q: jnp.mean(model.apply(q, xx) ** 2))(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates), grads, loss

    new_p, g_p, ref_loss = train_step(jparams, jx)

    tm = SparseTransformer.from_masks(
        driver_masks(b, s), num_layers=1, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
        activation="gelu")
    tm.load_state_dict(bridge.transformer_state_dict(params))
    loss, grads, new = dp_tp_step(tm, torch.from_numpy(np.array(x)),
                                  Mesh({"dp": dp, "tp": tp}))
    _close(loss[None], np.asarray(ref_loss)[None], "loss")
    for what, mine, ref in (("grad", grads, g_p), ("param", new, new_p)):
        ref = bridge.transformer_state_dict(jax.device_get(ref))
        assert set(mine) == set(ref)
        for k, v in ref.items():
            _close(mine[k].numpy(), v.numpy(), f"{what} {k}")
    # the step moved every parameter by lr x its gradient, none by 0
    assert all(float(g.abs().max()) > 0 for g in grads.values())


def test_dryrun_hier_matches_jax_kv_sharded_flash(capsys):
    hosts, sp, R, hd = 2, 2, 2, 32
    s = sp * 128
    got = dryrun_hier(4, "cpu")

    mesh = JMesh(np.array(jax.devices()[:4]).reshape(hosts, sp),
                 ("host", "sp"))
    bspec = JFlashSpec(JRowPartition(jwindow(s, window=96), sp, bm=8,
                                     balance=False), bm=8, bk=128,
                       mesh=mesh, axis="sp")
    n_loc = bspec.n_pad // sp
    rng = np.random.RandomState(7)
    q = rng.randn(sp, R, s // sp, hd).astype(np.float32)
    k = rng.randn(sp, R, n_loc, hd).astype(np.float32)
    sh = NamedSharding(mesh, JP(None, "host", None, None))
    jq, jk = jax.device_put(q, sh), jax.device_put(k, sh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda a, b, c: jnp.sum(jkv(bspec, a, b, c) ** 2),
        argnums=(0, 1, 2)))(jq, jk, jk)
    _close(np.float32(got["loss"])[None], np.asarray(loss)[None], "loss")
    for w, g, r in zip("qkv", got["grads"], grads):
        _close(g.numpy(), np.asarray(r), f"{w} grad")

    # the comm bill at 4 (the halo spans the band: gathered) and 8 (ragged)
    for n, comm in ((4, got["comm"]), (8, dryrun_hier(8, "cpu")["comm"])):
        capsys.readouterr()
        graft._dryrun_hier(n)
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("DRYRUN_COMM_HIER ")]
        ref = json.loads(line[-1].split(" ", 1)[1])
        assert set(comm) == set(ref)
        for key in ("halo_rows", "dcn_dp_grad_bytes_per_host",
                    "dcn_rowpart_boundary_bytes_per_host"):
            want = (tuple(ref[key]) if isinstance(ref[key], list)
                    else ref[key])
            assert comm[key] == want, (n, key)
