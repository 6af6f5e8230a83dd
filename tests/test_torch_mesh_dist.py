"""The process-group backend of ``parallel._mesh.Mesh`` over spawned gloo
worlds of 2 and 4 CPU processes, against the one-device backend.

One world of each size starts for the whole module (both at once, each
process a ``python`` running this file as a worker; ``init_method`` a file
in a temporary directory, a 60 s ``init_process_group`` timeout, and a
deadline after which every child is killed and the tests fail). Each rank
runs every case and saves its results; the tests compare them with the same
cases on the one-device mesh, run here:

  * ``psum``, ``all_gather``, ``psum_scatter`` and ``ppermute`` (a ring and
    a partial permutation) over each axis: equal to the one-device result
    of the rank's position (sums of a few exact values, so bit for bit);
  * ``TPLMServer`` greedy, contiguous and paged, at tp 2 (2 ranks) and at
    dp 2 x tp 2 (4 ranks), and sampled at dp 2 x tp 2: each rank's tokens
    are the one-device mesh's rows of its dp slice, and every rank's
    ``free_pages`` equal the one-device mesh's at its position;
  * the collectives' gradients (``psum``, ``pvary``, ``all_gather``,
    ``psum_scatter``, both ``ppermute``s) over each axis, against the
    one-device mesh's (integer operands and weights: bit for bit), so once
    and not ``n`` times;
  * ``pipeline_apply`` at pp 2 / pp 4 (panel layout, two microbatches a
    stage: the backward's ``ppermute``s meet on every rank) and
    ``SparseMoE`` at ep 2 / ep 4 through two Adam steps: each rank's output,
    loss and gradients within 1e-6 x max(1, max|ref|) of the one-device
    mesh's, every replicated parameter equal on every rank, a rank's
    bridge state dict its own experts (and RigL on a rank's expert slice
    raises);
  * every public function of the four sequence-parallel specs on
    ``Mesh({"sp": world}, distributed=True)`` (the sharded panel and
    compressed ops, the halo SpMM's three branches, replicated and
    kv-sharded flash attention in each branch, the ring natural and
    zigzag, GQA included), at tiny shapes: each rank's output and every
    operand's gradient within 1e-6 x max(1, max|ref|) of the one-device
    mesh's, a replicated operand's gradient the whole one on every rank
    (the check shown to fail on a zero and on a ``world``-fold gradient);
  * on 4 ranks, ``dryrun_dp_tp`` (dp 2 x tp 2: loss, gradients and
    updated parameters, a rank's its ``tp_slice`` share) and
    ``dryrun_hier`` (``{"host": 2, "sp": 2}``: loss and q / k / v
    gradients) against the one-device mesh.
"""

import datetime
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch.func import functional_call

from sputnik_tpu_torch import ManyMaskTopology, SparseTopology, bridge
from sputnik_tpu_torch import parallel as par
from sputnik_tpu_torch.dryrun import dryrun_dp_tp, dryrun_hier
from sputnik_tpu_torch.models import SparseLM, SparseMoE, TransformerLayer
from sputnik_tpu_torch.parallel import (PipelineSpec, TPLMServer,
                                        pipeline_apply, stack_stage_params)
from sputnik_tpu_torch.parallel._mesh import Mesh
from sputnik_tpu_torch.parallel.serving_tp import tp_slice
from sputnik_tpu_torch.patterns import causal_topology, local_window_topology
from sputnik_tpu_torch.training import rigl_update_moe

AXES = {2: {"tp": 2}, 4: {"dp": 2, "tp": 2}}
DEADLINE = 150           # seconds for both worlds, start-up included
V, B, P, N_NEW = 97, 4, 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small products, and under
    the suite's parallel workers more threads a worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operand(pos):
    """A position's [4, 6] operand: small integers, so every sum is exact."""
    base = 10 * sum(i * 7 ** k for k, i in enumerate(pos))
    return torch.arange(24, dtype=torch.float32).reshape(4, 6) + base


def _collectives(mesh, xs):
    out = {}
    for ax, n in mesh.shape.items():
        out[f"psum {ax}"] = mesh.psum(xs, ax)
        out[f"all_gather {ax}"] = mesh.all_gather(xs, ax, dim=1)
        out[f"psum_scatter {ax}"] = mesh.psum_scatter(xs, ax, dim=0)
        ring = [(i, (i + 1) % n) for i in range(n)]
        out[f"ppermute ring {ax}"] = mesh.ppermute(xs, ax, ring)
        out[f"ppermute partial {ax}"] = mesh.ppermute(xs, ax, [(0, n - 1)])
    return out


def _weight(pos, shape):
    """A position's cotangent weights: small integers, distinct a position."""
    k = 1 + sum(i * 3 ** j for j, i in enumerate(pos))
    return (torch.arange(math.prod(shape), dtype=torch.float32)
            .reshape(shape) % 5 + k)


def _collective_grads(mesh):
    """Each collective's operand gradients, one a local position: a psum's
    loss counts a line's sum once (it is invariant), the others' add every
    position's own weighted sum; pvary's operand is one tensor a line."""
    out = {}
    for ax, n in mesh.shape.items():
        a = mesh.names.index(ax)

        def line(p):
            return p[:a] + (0,) + p[a + 1:]

        for name, fn in (
                ("psum", lambda xs: mesh.psum(xs, ax)),
                ("pvary", lambda xs: mesh.pvary(xs, ax)),
                ("all_gather", lambda xs: mesh.all_gather(xs, ax, dim=1)),
                ("psum_scatter", lambda xs: mesh.psum_scatter(xs, ax, 0)),
                ("ppermute ring", lambda xs: mesh.ppermute(
                    xs, ax, [(i, (i + 1) % n) for i in range(n)])),
                ("ppermute partial", lambda xs: mesh.ppermute(
                    xs, ax, [(0, n - 1)]))):
            if name == "pvary":
                leaf = {line(p): _operand(line(p)).requires_grad_()
                        for p in mesh.positions}
                xs = [leaf[line(p)] for p in mesh.positions]
            else:
                xs = [_operand(p).requires_grad_() for p in mesh.positions]
            ys = fn(xs)
            if name == "psum":
                once = {line(p): (y * _weight(line(p), y.shape)).sum()
                        for p, y in zip(mesh.positions, ys)}
                loss = sum(once.values())
            else:
                loss = sum((y * _weight(p, y.shape)).sum()
                           for p, y in zip(mesh.positions, ys))
            loss.backward()
            # a position that sends nothing gets no gradient: zeros
            out[f"{name} {ax}"] = [torch.zeros_like(x) if x.grad is None
                                   else x.grad for x in xs]
    return out


def _moe_topos():
    rng = np.random.RandomState(8)
    return tuple(SparseTopology.from_dense_mask(
        (rng.rand(m, n) < 0.4).astype(np.float32)) for m, n in ((48, 32),
                                                                 (32, 48)))


def _training(world, mesh_of):
    """``pipeline_apply`` over pp = world and ``SparseMoE`` over ep = world
    (``mesh_of(axes)`` builds the mesh): their outputs, losses and
    gradients; the MoE's after two Adam steps. A rank's stacked stage and
    expert values are its own slice."""
    pp = mesh_of({"pp": world})
    mb, s, h = 2, 16, 32
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (mb, s, s)).copy()
    mt = ManyMaskTopology.from_dense_masks(masks)
    layers = [TransformerLayer(
        mt, h, 2, 48, activation="gelu", use_residual=True,
        use_layernorm=True, attention_layout="panel",
        generator=torch.Generator().manual_seed(20 + i))
        for i in range(world)]
    stacked = stack_stage_params([l.state_dict() for l in layers])
    held = pp.held("pp", world)
    stacked = {k: v[held.start:held.stop].clone().requires_grad_()
               for k, v in stacked.items()}
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2 * mb, s, h).astype(np.float32) * 0.3).requires_grad_()
    y = pipeline_apply(PipelineSpec(pp, n_micro=2),
                       lambda p, xm: functional_call(layers[0], p, (xm,)),
                       stacked, x)
    (y ** 2).mean().backward()
    res = {"pp out": y.detach(), "pp x grad": x.grad,
           "pp grads": {k: v.grad for k, v in stacked.items()}}

    ep = mesh_of({"ep": world})
    moe, full = (SparseMoE(*_moe_topos(), 2 * world, top_k=2, mesh=m,
                           bank_tiles=(16, 16),
                           generator=torch.Generator().manual_seed(10))
                 for m in (ep, None))
    # the bridge hands the rank its experts of the unsharded [E, ...] values
    sd = bridge.moe_state_dict(
        {"router": {"kernel": full.router.weight.detach().numpy().T},
         "w_in_values": full.w_in_values.detach().numpy(),
         "w_out_values": full.w_out_values.detach().numpy()}, moe)
    res["ep bridge"] = all(torch.equal(sd[k], v)
                           for k, v in moe.state_dict().items())
    opt = torch.optim.Adam(moe.parameters(), lr=1e-2)
    xm = torch.from_numpy(np.random.RandomState(11).randn(
        2, 16, h).astype(np.float32))
    losses = []
    for step in range(2):
        opt.zero_grad()
        loss = (moe(xm) ** 2).mean() + 0.01 * moe.aux_loss
        loss.backward()
        if step == 0:
            res["ep grads"] = {k: p.grad.clone()
                               for k, p in moe.named_parameters()}
        opt.step()
        losses.append(loss.detach())
    res["ep losses"] = torch.stack(losses)
    res["ep params"] = {k: v.detach().clone()
                        for k, v in moe.state_dict().items()}
    if ep.distributed:        # RigL's criteria need every expert's values
        try:
            rigl_update_moe(moe, np.ones((48, 32)), np.ones((32, 48)))
        except ValueError as e:
            res["ep rigl"] = str(e)
    return res


T8 = dict(bm=8, bk=8)     # tiny tiles: every path's plain version takes any


def _band_dense_row(m, n):
    mask = np.zeros((m, n), np.float32)
    for i in range(m):
        lo = max(0, i * n // m - 4)
        mask[i, lo: lo + 8] = 1
    mask[3] = 1
    return SparseTopology.from_dense_mask(mask)


def _seq_problems(world):
    """Every sequence-parallel spec's public functions at tiny shapes:
    ``{name: (make_spec(mesh), fn(spec, *operands), operands (whole,
    numpy), each operand sharded?, output sharded?)}``."""
    rng = np.random.RandomState(30 + world)

    def rand(*shape):
        return rng.randn(*shape).astype(np.float32)

    s, hd, q = 64, 8, 6
    m_loc = s // world
    causal = par.RowPartition(causal_topology(s), world, bm=8, balance=False)
    window = par.RowPartition(local_window_topology(s, 8), world, bm=8,
                            balance=False)
    ragged = par.RowPartition(local_window_topology(60, 8), world, bm=8,
                            balance=False)
    comp = par.RowPartition(_band_dense_row(s, 48), world, bm=8)
    zig = par.RowPartition(causal_topology(s), world, bm=8, zigzag=True)
    c_loc = comp.m_loc

    def panel(part):
        return lambda m: par.ShardedPanelSpec(part, mesh=m, axis="sp", **T8)

    def flash(part):
        return lambda m: par.ShardedFlashSpec(part, mesh=m, **T8)

    def ring(part):
        return lambda m: par.RingFlashSpec(part, mesh=m, **T8)

    def cspec(m):
        return par.ShardedCompressedSpec(comp, mesh=m, axis="sp", **T8)

    def values(make, part):
        return make(None).stack_values(rand(part.topo.nnz_pad))

    SR, SRR, SS = (True, False), (True, False, False), (True, True)
    out = {
        "spmm": (panel(causal), par.sharded_spmm,
                 [values(panel(causal), causal), rand(s, q)], SR, True),
        "spmm_t": (panel(causal), par.sharded_spmm_t,
                   [values(panel(causal), causal), rand(world, m_loc, q)],
                   SS, False),
        "sddmm": (panel(causal), par.sharded_sddmm,
                  [rand(world, m_loc, hd), rand(s, hd)], SR, True),
        "softmax": (panel(causal), par.sharded_softmax,
                    [values(panel(causal), causal)], (True,), True),
        "attention": (panel(causal), par.sparse_attention_sharded,
                      [rand(world, m_loc, hd), rand(s, hd), rand(s, hd)],
                      SRR, True),
        "spmm_c": (cspec, par.sharded_spmm_c,
                   [values(cspec, comp), rand(48, q)], SR, True),
        "spmm_t_c": (cspec, par.sharded_spmm_t_c,
                     [values(cspec, comp), rand(world, c_loc, q)], SS,
                     False),
        "sddmm_c": (cspec, par.sharded_sddmm_c,
                    [rand(world, c_loc, hd), rand(48, hd)], SR, True),
        "softmax_c": (cspec, par.sharded_softmax_c, [values(cspec, comp)],
                      (True,), True),
        "attention_c": (cspec, par.sparse_attention_sharded_c,
                        [rand(world, c_loc, hd), rand(48, hd),
                         rand(48, hd)], SRR, True),
    }
    for name, part, n_loc in (("halo split", window, m_loc),
                              ("halo ragged", ragged, 60 // world),
                              ("halo gathered", causal, m_loc)):
        out[name] = (panel(part), par.sharded_spmm_halo,
                     [values(panel(part), part), rand(world, n_loc, q)],
                     SS, True)
    for g in (1, 2):
        kv = [rand(4 // g, s, hd), rand(4 // g, s, hd)]
        out[f"flash replicated g{g}"] = (
            flash(causal), lambda sp, a, b, c, g=g:
            par.flash_attention_sharded(sp, a, b, c, group=g),
            [rand(world, 4, m_loc, hd)] + kv, SRR, True)
        for branch, part, ov in (("split", window, True),
                                 ("monolithic", window, False),
                                 ("gathered", causal, True)):
            out[f"flash kv {branch} g{g}"] = (
                flash(part), lambda sp, a, b, c, g=g, o=ov:
                par.flash_attention_kv_sharded(sp, a, b, c, group=g,
                                             overlap=o),
                [rand(world, 4, m_loc, hd), rand(world, 4 // g, m_loc, hd),
                 rand(world, 4 // g, m_loc, hd)], (True,) * 3, True)
        for order, part in (("natural", causal), ("zigzag", zig)):
            out[f"ring {order} g{g}"] = (
                ring(part), lambda sp, a, b, c, g=g:
                par.ring_flash_attention(sp, a, b, c, group=g),
                [rand(world, 4, m_loc, hd), rand(world, 4 // g, m_loc, hd),
                 rand(world, 4 // g, m_loc, hd)], (True,) * 3, True)
    return out


def _weight_of(out, here):
    """A fixed cotangent weight: of each shard's index and the position in
    it, so that a rank's is the one-device mesh's rows ``here`` (``None``:
    a replicated output, the same everywhere)."""
    shape = out.shape if here is None else out.shape[1:]
    base = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    if here is None:
        return torch.cos(0.37 * base)
    return torch.stack([torch.cos(0.37 * base + d) for d in here])


def _seq_cases(world, mesh):
    """Each problem's output and operand gradients on ``mesh``'s ``sp``
    axis (``None``: the one-device mesh): this process's shards of the
    sharded operands and outputs, the replicated ones whole."""
    res = {}
    for name, (make, fn, arrays, sharded, out_sharded) in \
            _seq_problems(world).items():
        spec = make(mesh)
        here = np.asarray(spec.here)
        xs = [torch.from_numpy(a[here] if sh else a).requires_grad_()
              for a, sh in zip(arrays, sharded)]
        y = fn(spec, *xs)
        (y * _weight_of(y, spec.here if out_sharded else None)
         ).sum().backward()
        res[name] = {"out": y.detach(), "grads": [x.grad for x in xs],
                     "sharded": sharded, "out_sharded": out_sharded}
    return res


def _lm():
    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (B, P, P)).copy()
    lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=2, hidden_size=32, num_heads=4,
        ffn_hidden_size=64, use_residual=True, use_layernorm=True,
        activation="gelu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():       # biases and LayerNorms away from 0 / 1
        g = torch.Generator().manual_seed(4)
        for name, p in lm.named_parameters():
            if "bias" in name or "ln" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return lm.eval()


def _serving(mesh):
    """Every TPLMServer case of a world on ``mesh``: tokens and free pages
    of this process's rows."""
    lm = _lm()
    prompts = torch.from_numpy(
        np.random.RandomState(5).randint(0, V, (B, P)))
    dp = "dp" if "dp" in mesh.shape else None
    kw = dict(batch_axis=dp, s_max=P + 128, bk=128,
              cache_dtype=torch.float32)
    out = {}
    srv = TPLMServer(lm, mesh, **kw)
    out["greedy"] = srv.generate(srv.rows(prompts), N_NEW)[0]
    paged = TPLMServer(lm, mesh, n_pages=20, **kw)
    out["paged"] = paged.generate(paged.rows(prompts), N_NEW)[0]
    out["free_pages"] = paged.tpd.free_pages
    if dp:
        same = srv.rows(prompts[:1].expand(B, P))   # every row one prompt
        out["sampled"] = srv.generate(
            same, N_NEW, torch.Generator().manual_seed(7),
            temperature=1.0)[0]
    return out


def _worker(rank: int, world: int, where: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{where}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = Mesh(AXES[world], distributed=True)
        res = {"positions": mesh.positions, "device": str(mesh.device),
               "coll": _collectives(mesh, [_operand(mesh.positions[0])])}

        class CudaLike:
            is_cuda = True

        try:
            mesh.psum([CudaLike()], "tp")
        except ValueError as e:
            res["cuda_on_gloo"] = str(e)
        res.update(_serving(mesh))
        res["coll grads"] = _collective_grads(mesh)
        res.update(_training(world, lambda axes: Mesh(axes,
                                                      distributed=True)))
        res["seq"] = _seq_cases(world, Mesh({"sp": world},
                                            distributed=True))
        if world == 4:
            res["dp_tp"] = dryrun_dp_tp(4, "cpu", mesh=Mesh(
                {"dp": 2, "tp": 2}, distributed=True))
            res["hier"] = dryrun_hier(4, "cpu", mesh=Mesh(
                {"host": 2, "sp": 2}, distributed=True))
        torch.save(res, os.path.join(where, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once; ``{world: [rank results]}``."""
    procs = []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    dirs = {}
    for world in AXES:
        where = tmp_path_factory.mktemp(f"world{world}")
        dirs[world] = where
        for rank in range(world):
            log = open(where / f"log{rank}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(world), str(where)], env=env, stdout=log,
                stderr=subprocess.STDOUT), where / f"log{rank}.txt", log))
    end = time.monotonic() + DEADLINE
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a gloo world ran past its {DEADLINE} s deadline")
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for p, path, _ in procs:
        if p.returncode != 0:
            pytest.fail(f"{path} exited {p.returncode}:\n"
                        f"{path.read_text()[-3000:]}")
    return {w: [torch.load(d / f"rank{r}.pt", weights_only=False)
                for r in range(w)] for w, d in dirs.items()}


@pytest.fixture(scope="module")
def one_device():
    """The same cases on the one-device mesh (every position here)."""
    out = {}
    for world, axes in AXES.items():
        mesh = Mesh(axes)
        out[world] = {
            "positions": mesh.positions,
            "coll": _collectives(mesh, [_operand(p)
                                        for p in mesh.positions]),
            "coll grads": _collective_grads(mesh),
            "seq": _seq_cases(world, None),
            **_training(world, Mesh),
            **_serving(mesh)}
    out[4]["dp_tp"] = dryrun_dp_tp(4, "cpu")
    out[4]["hier"] = dryrun_hier(4, "cpu")
    return out


def test_process_group_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh({"tp": 2}, distributed=True)


@pytest.mark.parametrize("world", sorted(AXES))
def test_collectives_match_one_device(worlds, one_device, world):
    ref = one_device[world]
    for rank, res in enumerate(worlds[world]):
        assert res["device"] == "cpu"
        assert "gloo" in res["cuda_on_gloo"]
        (pos,) = res["positions"]
        assert pos == ref["positions"][rank]      # rank = row-major position
        for name, got in res["coll"].items():
            (g,) = got
            torch.testing.assert_close(g, ref["coll"][name][rank],
                                       rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("world", sorted(AXES))
def test_collective_gradients_match_one_device(worlds, one_device, world):
    """Each rank's operand gradient is the one-device mesh's at its
    position, bit for bit: psum's cotangent once, pvary's summed over the
    line, all_gather / psum_scatter each other's transpose, ppermute's
    the inverse permutation."""
    ref = one_device[world]["coll grads"]
    for rank, res in enumerate(worlds[world]):
        for name, (g,) in res["coll grads"].items():
            torch.testing.assert_close(g, ref[name][rank], rtol=0, atol=0,
                                       msg=name)
    assert not torch.equal(ref["pvary tp"][0], ref["psum tp"][0])


def _close(got, ref, what):
    limit = 1e-6 * max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= limit, f"{what}: {err} > {limit}"


@pytest.mark.parametrize("world", sorted(AXES))
def test_pipeline_ranks_match_one_device(worlds, one_device, world):
    """pp = world: every rank gets the whole output, the input's gradient
    (the first stage's, entered by pvary) and its own stage's gradients,
    each the one-device mesh's."""
    ref = one_device[world]
    for rank, res in enumerate(worlds[world]):
        _close(res["pp out"], ref["pp out"], f"rank {rank} output")
        _close(res["pp x grad"], ref["pp x grad"], f"rank {rank} x grad")
        for k, g in res["pp grads"].items():
            assert g.shape[0] == 1
            _close(g, ref["pp grads"][k][rank:rank + 1], f"rank {rank} {k}")
    assert all(float(g.abs().max()) > 0 for g in ref["pp grads"].values())


@pytest.mark.parametrize("world", sorted(AXES))
def test_expert_parallel_ranks_match_one_device(worlds, one_device, world):
    """ep = world, 2 experts a rank, two Adam steps: losses, first-step
    gradients and final parameters the one-device mesh's (a rank's expert
    values its slice, which the bridge hands it from the unsharded
    values); the router equal on every rank."""
    ref = one_device[world]
    routers = []
    for rank, res in enumerate(worlds[world]):
        _close(res["ep losses"], ref["ep losses"], f"rank {rank} losses")
        for key in ("ep grads", "ep params"):
            for k, v in res[key].items():
                want = ref[key][k]
                if k.startswith("w_"):
                    assert v.shape[0] == 2
                    want = want[2 * rank: 2 * rank + 2]
                _close(v, want, f"rank {rank} {key} {k}")
        routers.append(res["ep params"]["router.weight"])
        assert "every expert" in res["ep rigl"]
        assert res["ep bridge"], rank
    assert all(torch.equal(r, routers[0]) for r in routers)


@pytest.mark.parametrize("world,case", [
    (2, "greedy"), (2, "paged"), (4, "greedy"), (4, "paged"),
    (4, "sampled")])
def test_tplm_ranks_match_one_device(worlds, one_device, world, case):
    """Each rank's tokens are the one-device mesh's rows of its dp slice,
    and its free pages the one-device mesh's at its position (sampling
    folds dp slices: dp 2 x tp 2 only)."""
    ref = one_device[world]
    dp = AXES[world].get("dp", 1)
    rows = B // dp
    for rank, res in enumerate(worlds[world]):
        d = res["positions"][0][0] if dp > 1 else 0
        want = ref[case][d * rows:(d + 1) * rows] if dp > 1 else ref[case]
        assert torch.equal(res[case], want), (rank, case)
        if case == "paged":
            assert res["free_pages"] == [[layer[rank]]
                                         for layer in ref["free_pages"]]
    if case == "sampled":     # the dp slices were given the same prompt
        assert not torch.equal(ref[case][:rows], ref[case][rows:])


def _replicated_close(got, ref, what, world):
    """A replicated operand's gradient is the one-device mesh's, summed
    over the axis once: the same check fails on a zero gradient (the psum
    left out) and on a ``world``-fold one (summed on every rank)."""
    _close(got, ref, what)
    for wrong in (torch.zeros_like(ref), world * ref):
        with pytest.raises(AssertionError):
            _close(wrong, ref, what)


@pytest.mark.parametrize("world", sorted(AXES))
def test_sequence_parallel_specs_on_ranks_match_one_device(worlds,
                                                           one_device,
                                                           world):
    """Every spec's public functions on ``{"sp": world}`` ranks: each
    rank's output and operand gradients are the one-device mesh's (its
    shard of the sharded ones; a replicated operand's whole gradient, not
    zero and not ``world`` times), in every halo / flash / ring branch."""
    ref = one_device[world]["seq"]
    for rank, res in enumerate(worlds[world]):
        assert set(res["seq"]) == set(ref)
        mine = slice(rank, rank + 1)
        for name, got in res["seq"].items():
            want = ref[name]
            _close(got["out"], want["out"][mine] if got["out_sharded"]
                   else want["out"], f"rank {rank} {name} output")
            for i, (g, r, sh) in enumerate(zip(got["grads"], want["grads"],
                                               got["sharded"])):
                what = f"rank {rank} {name} operand {i} gradient"
                if sh:
                    assert g.shape[0] == 1, what
                    _close(g, r[mine], what)
                else:
                    _replicated_close(g, r, what, world)


def test_dp_tp_step_and_hier_on_ranks_match_one_device(worlds, one_device):
    """4 ranks. The dp 2 x tp 2 SGD step: a rank's loss, gradients and
    updated parameters are its ``tp_slice`` share of the one-device mesh's
    (a replicated parameter's gradient whole: not zero, not 4-fold). The
    ("host", "sp") 2 x 2 kv-sharded flash attention: the loss, the q / k /
    v gradients of the rank's sp shard and host replica, and
    ``DRYRUN_COMM_HIER``'s numbers."""
    ref_tp, ref_h = one_device[4]["dp_tp"], one_device[4]["hier"]
    for rank, res in enumerate(worlds[4]):
        got = res["dp_tp"]
        _close(torch.tensor(got["loss"]), torch.tensor(ref_tp["loss"]),
               f"rank {rank} dp_tp loss")
        for key in ("grads", "params"):
            whole = {k[len("layers.0."):]: v for k, v in ref_tp[key].items()}
            share = tp_slice(whole, rank % 2, 2, 2, 2, 32)
            assert set(got[key]) == {f"layers.0.{k}" for k in share}
            for k, v in share.items():
                what = f"rank {rank} dp_tp {key} {k}"
                mine = got[key][f"layers.0.{k}"]
                if key == "grads" and v.shape == whole[k].shape:
                    _replicated_close(mine, v, what, 4)
                else:
                    _close(mine, v, what)
        got = res["hier"]
        h, sp = divmod(rank, 2)
        _close(torch.tensor(got["loss"]), torch.tensor(ref_h["loss"]),
               f"rank {rank} hier loss")
        for w, g, r in zip("qkv", got["grads"], ref_h["grads"]):
            assert g.shape[:2] == (1, 1)
            _close(g, r[sp:sp + 1, h:h + 1], f"rank {rank} hier {w} grad")
        assert got["comm"] == ref_h["comm"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
