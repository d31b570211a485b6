"""The port's inference CLI on a materialised 64x64 synthetic scan, on the
CPU: it writes the reference's output contract, its PFM depth is the
in-memory forward's, and the JAX package's PFM reader reads it."""

import os

import numpy as np
import pytest
import torch

from transmvsnet_tpu.data.pfm import read_pfm as jax_pkg_read_pfm
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, blended_confidence
from transmvsnet_tpu_torch.tools import infer

NDEPTHS = (16, 8, 8)
NUM_HYP = 48
VIEWS = 3
SIMILARITY_GAIN = 1000.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once, and torch's intra-op threads
    then wait on one another at every op: the TnT CLI test took 103 s with
    the default threads beside six busy processes, 8 s with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    """A seeded model with non-zero DCN offset convs and peaked probability
    volumes, as a trained checkpoint would have: the cost regularisers'
    first conv amplifies the (tiny, at random weights) similarity, so many
    pixels keep a blended confidence above the 0.01 at which the CLI
    zeroes depth."""
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".conv_offset_mask." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
            elif name.startswith("cost_regularization.") and name.endswith("conv0.conv.weight"):
                p.mul_(SIMILARITY_GAIN)
    return model.eval()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    data, out = root / "data", root / "out"
    SyntheticDataset(nviews=VIEWS, num_samples=1, height=64, width=64,
                     ndepths=NUM_HYP).materialize(str(data), device="cpu")
    (root / "list.txt").write_text("synth0\n")
    ckpt = root / "model.ckpt"
    torch.save({"epoch": 0, "model": _model().state_dict()}, ckpt)
    infer.main([
        "--dataset", "general_eval", "--datapath", str(data), "--testlist", str(root / "list.txt"),
        "--outdir", str(out), "--loadckpt", str(ckpt), "--num_view", str(VIEWS),
        "--numdepth", str(NUM_HYP), "--max_h", "64", "--max_w", "64",
        "--ndepths", ",".join(map(str, NDEPTHS)), "--dtype", "float32", "--device", "cpu",
    ])
    return data, out / "synth0"


def test_writes_the_output_contract(run):
    _, scan = run
    for v in range(VIEWS):
        for rel in (f"depth_est/{v:08d}.pfm", f"confidence/{v:08d}.pfm",
                    f"cams/{v:08d}_cam.txt", f"images/{v:08d}.jpg"):
            assert (scan / rel).is_file(), rel
    assert (scan / "pair.txt").is_file()
    depth, _ = read_pfm(str(scan / "depth_est/00000000.pfm"))
    conf, _ = read_pfm(str(scan / "confidence/00000000.pfm"))
    assert depth.shape == conf.shape == (64, 64)
    assert np.isfinite(depth).all() and ((conf >= 0) & (conf <= 1)).all()
    # Depth is zeroed exactly where the blended confidence is below 0.01.
    np.testing.assert_array_equal(depth == 0, conf < 0.01)


def test_pfm_depth_is_the_in_memory_forward(run):
    data, scan = run
    sample = GeneralEvalDataset(str(data), ["synth0"], nviews=VIEWS, ndepths=NUM_HYP,
                                max_h=64, max_w=64, device="cpu")[0]
    with torch.no_grad():
        out = _model()(
            torch.from_numpy(sample["imgs"][None]),
            {k: torch.from_numpy(v[None]) for k, v in sample["proj_matrices"].items()},
            torch.from_numpy(sample["depth_values"][None]),
        )
        depth, conf = blended_confidence(out)
    # The same model and inputs on the same CPU kernels: float32 rounding
    # at most (the CLI ran in another call, possibly another thread split).
    got_depth, _ = read_pfm(str(scan / "depth_est/00000000.pfm"))
    got_conf, _ = read_pfm(str(scan / "confidence/00000000.pfm"))
    np.testing.assert_allclose(got_depth, depth[0].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_conf, conf[0].numpy(), rtol=1e-5, atol=1e-7)
    assert 0.2 < (got_depth > 0).mean() < 0.9  # both sides of the 0.01 cut


def test_jax_package_reads_the_pfm(run):
    _, scan = run
    for kind in ("depth_est", "confidence"):
        path = os.path.join(scan, kind, "00000001.pfm")
        ours, scale = read_pfm(path)
        theirs, their_scale = jax_pkg_read_pfm(path)
        np.testing.assert_array_equal(theirs, ours)
        assert scale == their_scale == 1.0
