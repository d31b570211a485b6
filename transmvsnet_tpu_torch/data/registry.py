"""String-keyed dataset registry (reference datasets/__init__.py:5-8), the
JAX package's ``data/registry.py`` with the same names."""

from __future__ import annotations

from transmvsnet_tpu_torch.data.datasets import (
    BlendedTrainDataset,
    DTUTrainDataset,
    GeneralEvalDataset,
    TnTEvalDataset,
)
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset

DATASETS = {
    "dtu": DTUTrainDataset,
    "dtu_yao": DTUTrainDataset,
    "blended": BlendedTrainDataset,
    "bld_train": BlendedTrainDataset,
    "general_eval": GeneralEvalDataset,
    "dtu_eval": GeneralEvalDataset,
    "tnt": TnTEvalDataset,
    "tnt_eval": TnTEvalDataset,
    "synthetic": SyntheticDataset,
}
# The names each CLI takes: datasets with training targets, and those
# that give "filename" for the outputs.
TRAINING = ("dtu", "dtu_yao", "blended", "bld_train", "synthetic")
EVALUATION = ("general_eval", "dtu_eval", "tnt", "tnt_eval", "synthetic")


def get_dataset(name: str):
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}") from None
