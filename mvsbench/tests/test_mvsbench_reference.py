"""The plain reference against the port at a tiny shape on the CPU, where
the port takes its kernels' plain versions: the forward in eval mode, and
a train step's loss and gradients. (This test imports both; the
reference imports nothing of the port.)"""

import pytest
import torch

from mvsbench import scene, weights
from mvsbench.drivers.train import tree_to
from mvsbench.reference import model as ref
from mvsbench.reference import train as ref_train
from mvsbench.tests.tiny import tiny_cell
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.models.losses import cascade_loss
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, blended_confidence


def port_model(state, **kw):
    model = TransMVSNet(ModelConfig(**kw), device="cpu")
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_inference_agrees(seed):
    cell = tiny_cell("dtu_infer")
    model = weights.reference_model(cell.config, "cpu")
    s = tree_to(scene.pool(seed, 1, 1, cell.config["scene"], 3, 64, 96)[0], "cpu")
    x = (s["imgs"], s["proj_matrices"], s["depth_values"])
    state = weights.calibrated(model, weights.seeded_state_dict(model, seed, "cpu", 10.0), x)
    port = port_model(state).eval()
    with torch.no_grad():
        want = model(*x)
        got = port(*x)
        d_want, c_want = ref.blended(want)
        d_got, c_got = blended_confidence(got)
    for st in ("stage1", "stage2", "stage3"):
        assert (got[st]["prob_volume"] - want[st]["prob_volume"]).abs().max() < 2e-3
        assert (got[st]["depth"] == want[st]["depth"]).float().mean() > 0.99
        torch.testing.assert_close(got[st]["depth_values"], want[st]["depth_values"])
    assert (c_got - c_want).abs().max() < 1e-3
    assert (c_want > 0.01).float().mean() > 0.5, "calibrated weights give confident maps"


def test_train_step_agrees():
    cell = tiny_cell("dtu_train")
    model = weights.reference_model(cell.config, "cpu")
    state = weights.seeded_state_dict(model, 5, "cpu", 10.0)
    model.load_state_dict(state)
    b = tree_to(scene.pool(5, 1, 2, cell.config["scene"], 3, 64, 96, with_truth=True)[0], "cpu")
    out = ref_train.train_steps(model, [b], [1e-3])
    port = port_model(state, remat=True).train()
    loss = cascade_loss(port(b["imgs"], b["proj_matrices"], b["depth_values"]), b["depth"], b["mask"])[0]
    loss.backward()
    assert loss.item() == pytest.approx(out["losses"][0], rel=1e-5)
    norms = {k: g.norm() for k, g in out["first_grads"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, p in port.named_parameters():
        if norms[k] > 1e-3 * median:
            gap = (p.grad + 1e-4 * state[k] - out["first_grads"][k]).norm() / max(norms[k], median)
            assert gap < 0.1, k


class Tiny(torch.nn.Module):
    """A one-stage stand-in whose probability volume comes from a linear
    layer, so that ``train_steps`` drives Adam on known gradients."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 4)

    def forward(self, imgs, projs, depth_values):
        prob = torch.softmax(self.lin(imgs).permute(0, 3, 1, 2), 1)
        return {"stage1": {"prob_volume": prob, "depth_values": depth_values[:, :, None, None]}}


def test_adam_matches_torch():
    torch.manual_seed(0)
    model, twin = Tiny(), Tiny()
    twin.load_state_dict(model.state_dict())
    batches = [{"imgs": torch.randn(2, 5, 6, 3), "proj_matrices": {},
                "depth_values": torch.linspace(1, 4, 4)[None].expand(2, 4),
                "depth": {"stage1": torch.rand(2, 5, 6) * 3 + 1},
                "mask": {"stage1": (torch.rand(2, 5, 6) > 0.3).float()}} for _ in range(3)]
    lrs = [1e-3, 2e-3, 3e-3]
    out = ref_train.train_steps(model, batches, lrs, weight_decay=1e-4)
    opt = torch.optim.Adam(twin.parameters(), lr=1.0, weight_decay=1e-4)
    losses = []
    for b, lr in zip(batches, lrs):
        for g in opt.param_groups:
            g["lr"] = lr
        opt.zero_grad()
        loss = ref_train.cascade_loss(twin(b["imgs"], None, b["depth_values"]), b["depth"], b["mask"])
        loss.backward()
        losses.append(loss.item())
        opt.step()
    assert out["losses"] == pytest.approx(losses)
    for k, p in twin.named_parameters():
        torch.testing.assert_close(out["params"][k], p.detach())


def test_adam_continues_from_moments():
    """Steps taken from the moments and count of earlier ones land where
    the steps taken in one go do."""
    torch.manual_seed(1)
    model, twin = Tiny(), Tiny()
    twin.load_state_dict(model.state_dict())
    batches = [{"imgs": torch.randn(2, 5, 6, 3), "proj_matrices": {},
                "depth_values": torch.linspace(1, 4, 4)[None].expand(2, 4),
                "depth": {"stage1": torch.rand(2, 5, 6) * 3 + 1},
                "mask": {"stage1": (torch.rand(2, 5, 6) > 0.3).float()}} for _ in range(4)]
    lrs = [1e-3, 2e-3, 3e-3, 4e-3]
    whole = ref_train.train_steps(model, batches, lrs)
    opt = torch.optim.Adam(twin.parameters(), lr=1.0, weight_decay=1e-4)
    for b, lr in zip(batches[:3], lrs[:3]):
        for g in opt.param_groups:
            g["lr"] = lr
        opt.zero_grad()
        ref_train.cascade_loss(twin(b["imgs"], None, b["depth_values"]), b["depth"], b["mask"]).backward()
        opt.step()
    names = {id(p): k for k, p in twin.named_parameters()}
    moments = {m: {names[id(p)]: s[m] for p, s in opt.state.items()} for m in ("exp_avg", "exp_avg_sq")}
    last = ref_train.train_steps(twin, batches[3:], lrs[3:], moments=moments, start=3)
    assert last["losses"] == pytest.approx(whole["losses"][3:])
    for k in whole["params"]:
        torch.testing.assert_close(last["params"][k], whole["params"][k])


def test_learning_rates():
    assert ref_train.warmup_multistep(0, 1e-3, [100], 0.5) == pytest.approx(1e-3 / 3)
    assert ref_train.warmup_multistep(250, 1e-3, [1000], 0.5) == pytest.approx(1e-3 * (1 / 3 * 0.5 + 0.5))
    assert ref_train.warmup_multistep(600, 1e-3, [500], 0.5) == pytest.approx(0.5e-3)
