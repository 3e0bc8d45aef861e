"""The port's trajectory -> training-batch readers against the JAX
package's, on the trajectory fixture of tests/test_trajectory_data.py:
equal steps, examples and batches (numpy in both)."""

import numpy as np
import pytest

from omniparser_tpu.models.tokenizer import load_tokenizer as jload_tokenizer
from omniparser_tpu.train import trajectory_data as jtd
from omniparser_tpu_torch.models.tokenizer import load_tokenizer
from omniparser_tpu_torch.train import trajectory_data as ttd
from tests.test_trajectory_data import traj_dir  # noqa: F401  (the fixture)


def test_iter_steps_equal(traj_dir):  # noqa: F811
    got, want = list(ttd.iter_steps(traj_dir)), list(jtd.iter_steps(traj_dir))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["action"] == w["action"]
        assert g["elements"] == w["elements"]
        np.testing.assert_array_equal(g["image"], w["image"])


def test_detection_examples_and_batch_equal(traj_dir):  # noqa: F811
    got, want = list(ttd.detection_examples([traj_dir])), list(jtd.detection_examples([traj_dir]))
    assert len(got) == len(want)
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)
    gb, wb = ttd.make_detection_batch(got, 64, 8), jtd.make_detection_batch(want, 64, 8)
    assert set(gb) == set(wb)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_caption_examples_and_batch_equal(traj_dir):  # noqa: F811
    got = list(ttd.caption_examples([traj_dir], crop_size=32))
    want = list(jtd.caption_examples([traj_dir], crop_size=32))
    assert len(got) == len(want) == 2  # the sub-2px icon is skipped
    for (gc, gt), (wc, wt) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        assert gt == wt
    gb = ttd.make_caption_batch(got, load_tokenizer(None), max_len=12)
    wb = jtd.make_caption_batch(want, jload_tokenizer(None), max_len=12)
    for k in wb:
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_missing_trajectory_yields_nothing(tmp_path):
    assert list(ttd.iter_steps(str(tmp_path))) == []
    with pytest.raises(StopIteration):
        next(ttd.detection_examples([str(tmp_path)]))
