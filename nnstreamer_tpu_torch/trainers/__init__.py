"""Training subplugins and checkpointing (trainer backend layer).

Port of ``nnstreamer_tpu/trainers/`` (≙ the reference's trainer-subplugin
slot, GstTensorTrainerFramework, include/nnstreamer_plugin_api_trainer.h,
whose implementation there is NNTrainer): the port's trainer is PyTorch
on the card (torch_cuda_trainer.py, ``framework=torch-cuda``) with
``state_dict`` checkpoints (checkpoint.py).
"""
from .base import (TrainerEvent, TrainerFramework, TrainerProperties,
                   TrainerStatus, find_trainer, register_trainer)
from .checkpoint import restore_params, save_params
from . import torch_cuda_trainer  # noqa: F401 — registers torch-cuda

__all__ = ["restore_params", "save_params", "TrainerFramework",
           "TrainerProperties", "TrainerStatus", "TrainerEvent",
           "find_trainer", "register_trainer"]
