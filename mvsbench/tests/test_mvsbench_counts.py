"""The work counters against hand counts at a tiny shape: every conv and
linear of the plain reference counted from the shapes it really sees, by
forward hooks, plus linear attention's products and the deformable
contraction, which no module holds."""

import pytest
import torch
from torch import nn

from mvsbench import scene, weights
from mvsbench.counts import transmvsnet as work
from mvsbench.reference import model as ref
from mvsbench.tests.tiny import tiny_cell

B, V, H, W = 1, 3, 64, 96


def hooked_flops(model, run):
    """Operations of every conv and linear, by the top-level child the
    module lies in, from the shapes seen."""
    found = {}

    def hook(name):
        def count(m, args, out):
            x = args[0]
            if isinstance(m, nn.Linear):
                f = 2.0 * x.numel() // x.shape[-1] * m.in_features * m.out_features
            elif isinstance(m, nn.ConvTranspose3d):
                f = 2.0 * x.numel() * m.out_channels * m.weight[0, 0].numel()
            else:
                f = 2.0 * out.numel() * m.in_channels * m.weight[0, 0].numel()
            found[name] = found.get(name, 0.0) + f
        return count

    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        run()
    return found


@pytest.fixture(scope="module")
def counted():
    cell = tiny_cell("dtu_infer")
    model = weights.reference_model(cell.config, "cpu")
    model.load_state_dict(weights.seeded_state_dict(model, 1, "cpu", 10.0))
    model.eval()
    s = scene.pool(1, 1, B, cell.config["scene"], V, H, W)[0]
    x = (torch.from_numpy(s["imgs"]), {k: torch.from_numpy(v) for k, v in s["proj_matrices"].items()},
         torch.from_numpy(s["depth_values"]))
    return cell.config["model"], hooked_flops(model, lambda: model(*x)), s


def part(found, prefix):
    return sum(f for n, f in found.items() if n.startswith(prefix))


def test_feature_net(counted):
    model, found, _ = counted
    dcn_contraction = sum(2.0 * layer["pixels"] * 9 * layer["C"] * layer["C_out"]
                          for layer in work.dcn_layers(model, B * V, H, W))
    assert work.feature_flops(model, B * V, H, W) == pytest.approx(part(found, "feature.") + dcn_contraction)


def test_fmt(counted):
    model, found, _ = counted
    L, d, heads, S = (H // 4) * (W // 4), 32, 8, V - 1
    # Linear attention per sequence: K^T V and Q (K^T V), 2 L d d_head
    # each, and Q sum(K), 2 L d; eight layers, self on 1 + S sequences,
    # cross on S.
    attention = (4 * (1 + S) + 4 * S) * (4.0 * L * d * (d // heads) + 2.0 * L * d)
    assert work.fmt_flops(model, B, V, H, W) == pytest.approx(part(found, "FMT_with_pathway.") + attention)


def test_cost_reg(counted):
    model, found, _ = counted
    want = sum(work.cost_reg_flops(8, B, D, h, w) for D, h, w, _ in work.stage_shapes(model, H, W))
    assert want == pytest.approx(part(found, "cost_regularization."))


def test_pixelwise_in_sweep(counted):
    model, found, _ = counted
    D, h, w, _ = work.stage_shapes(model, H, W)[0]
    assert part(found, "DepthNet.") == pytest.approx(2.0 * B * (V - 1) * D * h * w * (16 + 16 * 8 + 8))


def test_in_bounds_share(counted):
    """The counted share against grid_sample's own zero padding: a sample of
    ones is 1 inside and partly 0 outside the image."""
    model, _, s = counted
    shares = work.in_bounds_shares({k: v[0] for k, v in s["proj_matrices"].items()}, s["depth_values"][0],
                                   model, H, W, step=1)
    D, h, w, _ = work.stage_shapes(model, H, W)[0]
    p = torch.from_numpy(s["proj_matrices"]["stage1"])
    planes = torch.linspace(float(s["depth_values"][0, 0]), float(s["depth_values"][0, -1]), D)
    planes = planes[None, :, None, None].expand(1, D, h, w).contiguous()
    fused = ref.fused_projection(p)
    inside = total = 0
    for v in range(1, V):
        ones = torch.ones(1, 1, h, w, dtype=torch.float64)
        got = ref.warp_correlation(ones, ones, fused[:, v].double(), fused[:, 0].double(), planes.double())
        inside += int((got > 1 - 1e-9).sum())
        total += got.numel()
    assert shares[0] == pytest.approx(inside / total, abs=0.02)
    assert 0.2 < shares[0] <= 1.0


def test_dcn_bytes_and_roofline():
    layer = {"pixels": 1000, "C": 32, "C_out": 8}
    w = work.dcn_work(layer, 4)
    assert w["flops"] == 2.0 * 1000 * 9 * 32 * (27 + 8)
    assert w["bytes"] == 4 * 1000 * (32 + 8) + 4 * (9 * 32 * 35 + 35)
    assert work.roofline_seconds(1e12, 1.0, 1e12, 1e12) == 1.0
    assert work.roofline_seconds(1.0, 2e12, 1e12, 1e12) == 2.0
