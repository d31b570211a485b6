"""The port's visualisation helpers against the JAX package's and cv2's:
the numpy JET table, ``depth_to_gray``, ``depth_to_color`` and
``error_map``; ``log_depth_images`` and the training loop's image
summaries through a recording stand-in for TensorBoard's writer."""

import cv2
import numpy as np
import torch

from transmvsnet_tpu import utils_vis as jax_vis
from transmvsnet_tpu_torch import utils_vis
from transmvsnet_tpu_torch.train.loop import run_epoch


class Recorder:
    """Stands in for ``SummaryWriter``: keeps every image it is given."""

    def __init__(self):
        self.images = {}

    def add_image(self, tag, img, step):
        self.images[tag] = (np.asarray(img), step)


def _depths(seed=0, shape=(24, 32)):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(425.0, 935.0, shape).astype(np.float32)
    depth[0, :5] = 0.0  # invalid
    depth[1, :3] = np.nan
    return depth


def test_jet_table_is_cv2s():
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(utils_vis.jet_table(), want)


def test_depth_maps_as_the_jax_package_draws_them():
    depth = _depths()
    for lo, hi in ((None, None), (500.0, 800.0)):
        np.testing.assert_array_equal(utils_vis.depth_to_gray(depth, lo, hi), jax_vis.depth_to_gray(depth, lo, hi))
        np.testing.assert_array_equal(utils_vis.depth_to_color(depth, lo, hi), jax_vis.depth_to_color(depth, lo, hi))
    gt, mask = _depths(1), (np.random.RandomState(2).rand(24, 32) > 0.3).astype(np.float32)
    for cap in (20.0, 300.0):
        np.testing.assert_array_equal(utils_vis.error_map(depth, gt, mask, cap), jax_vis.error_map(depth, gt, mask, cap))


def test_log_depth_images_writes_four_images():
    est, conf = torch.from_numpy(_depths()[None]), torch.full((1, 24, 32), 0.5)
    gt, mask = torch.from_numpy(_depths(1)[None]), torch.ones(1, 24, 32)
    writer = Recorder()
    utils_vis.log_depth_images(writer, "train", est, conf, {"depth": {"stage3": gt}, "mask": {"stage3": mask}}, 7)
    assert sorted(writer.images) == ["train/confidence", "train/depth_est", "train/depth_gt", "train/error"]
    for img, step in writer.images.values():
        assert img.shape == (1, 24, 32) and img.dtype == np.uint8 and step == 7
    np.testing.assert_array_equal(writer.images["train/depth_est"][0][0], jax_vis.depth_to_gray(_depths()))
    assert (writer.images["train/confidence"][0] == 127).all()
    # Without ground truth (an evaluation batch of the inference data), two.
    writer = Recorder()
    utils_vis.log_depth_images(writer, "val", est, conf, {}, 1)
    assert sorted(writer.images) == ["val/confidence", "val/depth_est"]


class _Logger:
    """A main-process MetricsLogger with a recording writer."""

    enabled = True

    def __init__(self):
        self.records, self.writer = [], Recorder()

    def log(self, mode, scalars, step):
        self.records.append((mode, step))

    def log_images(self, mode, images, batch, step):
        utils_vis.log_depth_images(self.writer, mode, images["_depth_est"], images["_confidence"], batch, step)


def test_training_loop_logs_images_at_log_freq():
    class State:
        step = 0

    def step_fn(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(1.0), "_depth_est": batch["depth"]["stage3"] + state.step,
                       "_confidence": torch.full((1, 8, 8), 0.25)}

    batches = [{"depth": {"stage3": np.full((1, 8, 8), 500.0, np.float32)},
                "mask": {"stage3": np.ones((1, 8, 8), np.float32)}} for _ in range(5)]
    logger = _Logger()
    state, means = run_epoch(step_fn, State(), batches, torch.device("cpu"), logger=logger, log_freq=2)
    assert means == {"loss": 1.0}  # the "_" images are not averaged
    assert logger.records == [("train", 1), ("train", 3), ("train", 5)]
    assert sorted(logger.writer.images) == ["train/confidence", "train/depth_est", "train/depth_gt", "train/error"]
    assert logger.writer.images["train/error"][1] == 5
    assert (logger.writer.images["train/error"][0] == 63).all()  # 255 * |505 - 500| / 20 mm, truncated
