"""The PyTorch port stands alone and defaults to the card.

An AST walk finds no import of jax, flax or the JAX package in
``transmvsnet_tpu_torch/`` (the evaluation pipeline's image IO, fuser and
scorer included) or ``chip_smoke.py``, and no top-level cv2 or PIL; on a
machine without CUDA the entry points and the image readers raise instead
of quietly running on the CPU.
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


def test_the_walk_covers_the_evaluation_pipeline():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for rel in ("data/image_io.py", "fusion/dynamic.py", "fusion/native.py", "fusion/ply.py",
                "ops/native_fuse.py", "ops/cuda/native_fuse.py", "eval/dtu_eval.py", "tools/fuse.py",
                "tools/eval_dtu.py"):
        assert f"transmvsnet_tpu_torch/{rel}" in walked, rel


def test_the_walk_covers_the_training_side():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for rel in ("parallel/distributed.py", "parallel/sharding.py", "parallel/mesh.py", "parallel/collectives.py",
                "data/registry.py", "utils_vis.py", "tools/train.py", "tools/profile.py"):
        assert f"transmvsnet_tpu_torch/{rel}" in walked, rel


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

    SyntheticDataset(nviews=3, num_samples=1, height=32, width=32).materialize(
        str(tmp_path), device="cpu")
    (tmp_path / "list.txt").write_text("synth0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(["--datapath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
                    "--outdir", str(tmp_path / "out"), "--num_view", "3"])


def test_fuse_cli_defaults_to_cuda(no_cuda, tmp_path):
    from transmvsnet_tpu_torch.tools import fuse

    (tmp_path / "list.txt").write_text("scan1\n")
    with pytest.raises(RuntimeError, match="cuda"):
        fuse.main(["--testpath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
                   "--outdir", str(tmp_path / "plys")])


def test_native_fuser_defaults_to_cuda(no_cuda, tmp_path):
    """``native_fuse_scans``, ``native_fuse_scan`` and the CLI's native
    route raise before they write anything."""
    from transmvsnet_tpu_torch.fusion.native import native_fuse_scan, native_fuse_scans
    from transmvsnet_tpu_torch.tools import fuse

    (tmp_path / "list.txt").write_text("scan1\n")
    for call in (lambda: native_fuse_scans(str(tmp_path), ["scan1"], str(tmp_path / "plys")),
                 lambda: native_fuse_scan(str(tmp_path / "scan1"), str(tmp_path / "plys" / "a.ply")),
                 lambda: fuse.main(["--testpath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
                                    "--outdir", str(tmp_path / "plys"), "--filter_method", "native"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "plys").exists()


def test_image_readers_default_to_cuda(no_cuda, tmp_path):
    from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset, TnTEvalDataset
    from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset

    for make in (lambda: GeneralEvalDataset(str(tmp_path), []), lambda: TnTEvalDataset(str(tmp_path), []),
                 lambda: SyntheticDataset(nviews=2, num_samples=1, height=32, width=32).materialize(str(tmp_path))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert not any(tmp_path.iterdir())


def test_train_cli_defaults_to_cuda(no_cuda, tmp_path):
    from transmvsnet_tpu_torch.tools import train

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--dataset", "synthetic", "--epochs", "1", "--logdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # it raised before writing anything


def test_train_cli_defaults_to_remat():
    """As the JAX trainer: activations recomputed in the backward unless
    ``--no_remat``."""
    from transmvsnet_tpu_torch.tools import train

    args = train.parse_args([])
    assert not args.no_remat and train.model_config(args).remat
    assert not train.model_config(train.parse_args(["--no_remat"])).remat


def test_kernel_build_needs_cuda(no_cuda):
    from transmvsnet_tpu_torch.ops.cuda import build

    with pytest.raises(RuntimeError, match="CUDA"):
        build.build_all()


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises rather than falling back."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    m = torch.device("meta")
    off = torch.empty(1, 9, 4, 4, device=m)
    with pytest.raises(ValueError, match="cuda or cpu"):
        deform_conv2d(torch.empty(1, 8, 4, 4, device=m), off, off, off, torch.empty(9, 8, 8, device=m),
                      torch.empty(8, device=m))
    with pytest.raises(ValueError, match="cuda or cpu"):
        dcn_fused(torch.empty(1, 8, 4, 4, device=m), torch.empty(27, 8, 3, 3, device=m),
                  torch.empty(27, device=m), torch.empty(9, 8, 8, device=m),
                  torch.empty(8, device=m))
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_correlate(torch.empty(1, 1, 8, 4, 4, device=m), torch.empty(1, 8, 4, 4, device=m),
                       torch.empty(1, 1, 4, 4, device=m), torch.empty(1, 4, 4, device=m),
                       torch.empty(1, 2, 4, 4, device=m))


def test_backward_wrappers_refuse_other_devices():
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import warp_correlate_bwd

    m = torch.device("meta")
    off = torch.empty(1, 9, 4, 4, device=m)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dcn_bwd(torch.empty(1, 8, 4, 4, device=m), off, off, off, torch.empty(9, 8, 8, device=m),
                torch.empty(1, 8, 4, 4, device=m))
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_correlate_bwd(torch.empty(1, 1, 8, 4, 4, device=m), torch.empty(1, 8, 4, 4, device=m),
                           torch.empty(1, 1, 4, 4, device=m), torch.empty(1, 4, 4, device=m),
                           torch.empty(1, 2, 4, 4, device=m), torch.empty(1, 1, 2, 4, 4, device=m))


def test_view_sum_wrappers_refuse_other_devices():
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate_wsum
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import warp_correlate_wsum_bwd

    m = torch.device("meta")
    args = (torch.empty(1, 2, 8, 4, 4, device=m, dtype=torch.bfloat16),
            torch.empty(1, 8, 4, 4, device=m, dtype=torch.bfloat16), torch.empty(1, 2, 4, 4, device=m),
            torch.empty(1, 4, 4, device=m), torch.empty(1, 3, 4, 4, device=m),
            torch.empty(1, 2, 4, 4, device=m))
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_correlate_wsum(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_correlate_wsum_bwd(*args, torch.empty(1, 3, 4, 4, device=m))
