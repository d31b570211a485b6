"""One process of the port's mesh tests on the CPU
(``tests/test_torch_mesh_fmt.py``, ``tests/test_torch_mesh.py``).

    python torch_mesh_child.py <process_id> <processes> <host:port> <dir> <case>[,<case>]

Joins a gloo group through ``parallel/distributed.py``, builds the
meshes of each comma-separated case (``parallel/mesh.py``; every process
builds every mesh, in the same order) and writes what each case gives,
under its name, to ``<dir>/out_<process_id>.pt``:

- "fmt": the FMT of ``<dir>/weights.pt`` (the JAX model's weights, carried
  over by the parent through the bridge) on ``<dir>/inputs.pt``'s
  features, split at (2, 1, 2) and (1, 2, 2); then, at (2, 1, 2), the
  collective counts of one forward at B = 1, S = 4 and two token counts.
- "cascade": the cascade of ``<dir>/weights.pt`` in eval mode on
  ``<dir>/inputs.pt``'s V = 5 and V = 4 scenes at (1, 2, 2), and the V = 4
  scene on the three processes of (1, 1, 3) (D = 16 and 8 over 3:
  unequal slabs; process 3 outside), with the collective counts.
- "step": two SGD steps of ``train/step.py`` on the synthetic scene of
  ``tests/torch_ddp_child.py`` (global batch 2) at (1, 2, 2) with remat
  and at (2, 2, 1) without, from the same seeded weights; the state
  after, the scalars, the shard's indices and the collective counts.

Imports no JAX. ``spawn`` runs the processes of a case for a test and
loads what they wrote.
"""

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

NDEPTHS = (8, 8, 8)
DATA = dict(nviews=3, ndepths=48, num_samples=4, height=32, width=64)
SGD_LR = 1e-3
STEP_MESHES = {"1x2x2": ((1, 2, 2), True), "2x2x1": ((2, 2, 1), False)}  # (mesh, remat)


def _fmt(dirname, make_mesh, sharding, collectives, MeshConfig):
    from transmvsnet_tpu_torch.models.fmt import FMT

    weights = torch.load(os.path.join(dirname, "weights.pt"))
    fmt = FMT()
    fmt.load_state_dict({k.removeprefix("FMT_with_pathway.FMT."): v for k, v in weights.items()
                         if k.startswith("FMT_with_pathway.FMT.")})
    ref, src = torch.load(os.path.join(dirname, "inputs.pt"))
    out = {}
    for shape in ((2, 1, 2), (1, 2, 2)):
        mesh = make_mesh(MeshConfig(*shape))
        with torch.no_grad(), sharding.sharding_rules(mesh):
            out["x".join(map(str, shape))] = fmt(ref, src)
    mesh = make_mesh(MeshConfig(2, 1, 2))
    gen = torch.Generator().manual_seed(3)
    out["counts"] = {}
    for h, w in ((8, 16), (16, 24)):
        ref, src = torch.randn(1, 32, h, w, generator=gen), torch.randn(1, 4, 32, h, w, generator=gen)
        collectives.reset()
        with torch.no_grad(), sharding.sharding_rules(mesh):
            fmt(ref, src)
        out["counts"][h * w] = collectives.read()
    return out


def _cascade(dirname, make_mesh, sharding, collectives, MeshConfig):
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    model = TransMVSNet(ModelConfig(ndepths=(16, 8, 8)), device="cpu")
    model.load_state_dict(torch.load(os.path.join(dirname, "weights.pt")))
    model.eval()
    scenes = torch.load(os.path.join(dirname, "inputs.pt"))
    out = {}
    for name, shape, views in (("1x2x2", (1, 2, 2), (5, 4)), ("1x1x3", (1, 1, 3), (4,))):
        mesh = make_mesh(MeshConfig(*shape))
        if mesh.coords is None:
            continue
        for v in views:
            collectives.reset()
            with torch.no_grad(), sharding.sharding_rules(mesh):
                got = model(*scenes[v])
            out[f"{name}_V{v}"] = {s: {k: got[s][k] for k in ("prob_volume", "depth", "photo_confidence")}
                                   for s in ("stage1", "stage2", "stage3")}
            out[f"{name}_V{v}_counts"] = collectives.read()
    return out


def _step(make_mesh, sharding, collectives, MeshConfig):
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.loader import ShardedLoader
    from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    out = {}
    for name, (shape, remat) in STEP_MESHES.items():
        mesh = make_mesh(MeshConfig(*shape))
        data = mesh.size("data")
        loader = ShardedLoader(SyntheticDataset(**DATA), batch_size=2 // data, num_shards=data,
                               shard_id=mesh.index("data"), num_workers=0)
        model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, remat=remat), device="cpu",
                            generator=torch.Generator().manual_seed(0))
        optimizer = torch.optim.SGD(model.parameters(), lr=SGD_LR)
        state = TrainState(sharding.replicate(model), optimizer,
                           torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0))
        step = make_train_step()
        scalars = []
        collectives.reset()
        with sharding.sharding_rules(mesh):
            for raw in loader:
                state, s = step(state, to_device_batch(raw, torch.device("cpu")))
                scalars.append({k: v.item() for k, v in s.items() if not k.startswith("_")})
        out[name] = {"indices": loader._shard_indices().tolist(), "after": model.state_dict(),
                     "scalars": scalars, "counts": collectives.read(), "coords": mesh.coords}
    return out


def spawn(cases: str, processes: int, dirname, meanwhile=lambda: None) -> tuple[list[dict], object]:
    """Runs ``cases`` in ``processes`` processes and ``meanwhile()`` in
    this one; the processes' outputs by rank, and what ``meanwhile``
    returned."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coordinator = f"localhost:{sock.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "LOCAL_RANK", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen([sys.executable, __file__, str(pid), str(processes), coordinator, str(dirname), cases],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for pid in range(processes)]
    outs = []
    try:
        ours = meanwhile()
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(dirname, f"out_{pid}.pt"), weights_only=False) for pid in range(processes)], ours


def main():
    pid, processes, coordinator, dirname, case = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                                  sys.argv[5])
    torch.set_num_threads(1)
    from transmvsnet_tpu_torch.config import MeshConfig
    from transmvsnet_tpu_torch.parallel import collectives, distributed, sharding
    from transmvsnet_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(coordinator, processes, pid, device="cpu")
    try:
        args = (make_mesh, sharding, collectives, MeshConfig)
        cases = {"fmt": lambda: _fmt(dirname, *args), "cascade": lambda: _cascade(dirname, *args),
                 "step": lambda: _step(*args)}
        out = {c: cases[c]() for c in case.split(",")}
        torch.save(out, os.path.join(dirname, f"out_{pid}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
