"""Training: detection and caption losses, the joint train step, and the
three synthetic-data trainers (``python -m
omniparser_tpu_torch.train.train_{detector,ocr,captioner}``)."""

from omniparser_tpu_torch.train.losses import caption_loss, detection_loss
from omniparser_tpu_torch.train.train_step import TrainState, make_train_state, train_step

__all__ = ["detection_loss", "caption_loss", "TrainState", "make_train_state", "train_step"]
