"""The PyTorch port stands alone and defaults to the card.

An AST walk finds no import of jax, flax or the JAX package in
``transmvsnet_tpu_torch/`` or ``chip_smoke.py``; on a machine without CUDA
the entry points raise instead of quietly running on the CPU.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "transmvsnet_tpu")


def _port_files():
    return sorted((ROOT / "transmvsnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_no_top_level_cv2_or_pil():
    """The card's machine has neither; they are imported inside functions."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
                bad += [f"{path.name}: {n}" for n in names if n and n.split(".")[0] in ("cv2", "PIL")]
    assert not bad, bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_model_defaults_to_cuda(no_cuda):
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    with pytest.raises(RuntimeError, match="cuda"):
        TransMVSNet(ModelConfig())


def test_infer_cli_defaults_to_cuda(no_cuda, tmp_path):
    from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from transmvsnet_tpu_torch.tools import infer

    SyntheticDataset(nviews=3, num_samples=1, height=32, width=32).materialize(str(tmp_path))
    (tmp_path / "list.txt").write_text("synth0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(["--datapath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
                    "--outdir", str(tmp_path / "out"), "--num_view", "3"])


def test_kernel_build_needs_cuda(no_cuda):
    from transmvsnet_tpu_torch.ops.cuda import build

    with pytest.raises(RuntimeError, match="CUDA"):
        build.build_all()


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises rather than falling back."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    m = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dcn_fused(torch.empty(1, 8, 4, 4, device=m), torch.empty(27, 8, 3, 3, device=m),
                  torch.empty(27, device=m), torch.empty(9, 8, 8, device=m),
                  torch.empty(8, device=m))
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_correlate(torch.empty(1, 1, 8, 4, 4, device=m), torch.empty(1, 8, 4, 4, device=m),
                       torch.empty(1, 1, 4, 4, device=m), torch.empty(1, 4, 4, device=m),
                       torch.empty(1, 2, 4, 4, device=m))
