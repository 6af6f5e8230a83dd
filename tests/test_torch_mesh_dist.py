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
    ``free_pages`` equal the one-device mesh's at its position.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sputnik_tpu_torch.models import SparseLM
from sputnik_tpu_torch.parallel import TPLMServer
from sputnik_tpu_torch.parallel._mesh import Mesh

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
            **_serving(mesh)}
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


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
