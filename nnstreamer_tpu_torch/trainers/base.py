"""TrainerFramework: the trainer-subplugin ABI.

Port of ``nnstreamer_tpu/trainers/base.py`` (≙ GstTensorTrainerFramework,
include/nnstreamer_plugin_api_trainer.h:31-72) — create/destroy/start/
stop/push_data/getStatus with epoch/loss/accuracy feedback and an event
notifier (EPOCH_COMPLETION, TRAINING_COMPLETION). The reference's
implementation is NNTrainer; the port's is PyTorch on the card
(torch_cuda_trainer.py).
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Callable, Dict, Sequence, Tuple


class TrainerEvent(enum.Enum):
    EPOCH_COMPLETION = "epoch_completion"
    TRAINING_COMPLETION = "training_completion"


@dataclasses.dataclass
class TrainerProperties:
    """(ref: GstTensorTrainerProperties struct in the trainer ABI)."""

    model_config: str = ""
    model_save_path: str = ""
    model_load_path: str = ""
    num_inputs: int = 1
    num_labels: int = 1
    num_training_samples: int = 0
    num_validation_samples: int = 0
    epochs: int = 1
    # multi-chip: "DxSxT" / "auto" device mesh + sharding rule table name
    # (this framework's extension — the reference delegates device
    # placement to the NNTrainer subplugin)
    mesh: str = ""
    rules: str = ""
    # the port's device choice (tensor_trainer's ``accelerator``, parsed
    # as tensor_filter parses it): empty = the card, CPU/NONE = the CPU
    accelerators: Tuple[Any, ...] = ()


@dataclasses.dataclass
class TrainerStatus:
    """(ref: epoch/loss/accuracy feedback fields)."""

    epoch: int = 0
    training_loss: float = 0.0
    training_accuracy: float = 0.0
    validation_loss: float = 0.0
    validation_accuracy: float = 0.0


class TrainerFramework:
    NAME = ""

    def create(self, props: TrainerProperties) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def push_data(self, tensors: Sequence[Any]) -> None:
        """One sample: num_inputs input tensors + num_labels label tensors.
        May block (pipeline backpressure, ≙ fw->push_data blocking,
        gsttensor_trainer.c:487-501)."""
        raise NotImplementedError

    def get_status(self) -> TrainerStatus:
        raise NotImplementedError

    def set_event_notifier(self,
                           notify: Callable[[TrainerEvent, TrainerStatus],
                                            None]) -> None:
        self._notify = notify

    def _emit(self, event: TrainerEvent, status: TrainerStatus) -> None:
        cb = getattr(self, "_notify", None)
        if cb is not None:
            cb(event, status)


_lock = threading.Lock()
_trainers: Dict[str, type] = {}


def register_trainer(cls: type) -> type:
    with _lock:
        _trainers[cls.NAME] = cls
    return cls


def find_trainer(name: str) -> type:
    with _lock:
        if name not in _trainers:
            raise ValueError(
                f"unknown trainer framework {name!r}; known: {sorted(_trainers)}")
        return _trainers[name]
