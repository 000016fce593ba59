"""tensor_trainer — in-pipeline training.

Port of ``nnstreamer_tpu/elements/trainer.py`` (≙ gst/nnstreamer/
elements/gsttensor_trainer.c): receives other/tensors samples, pushes
them into a trainer subplugin (push_data blocks -> natural
backpressure), emits per-epoch [training_loss, training_accuracy,
validation_loss, validation_accuracy] as a float64 tensor stream (pts =
the epoch) and a ``trainer-epoch`` bus message, waits for training to
complete at EOS, saves via model-save-path.

``accelerator`` is the port's device choice, parsed as tensor_filter
parses it: empty trains on ``cuda:0`` (start raises without CUDA),
``true:cpu`` or ``false`` on the CPU. The JAX element has no such
property: JAX places the trainer on its default device.

``mesh=DxSxT``/``rules=<table>`` train on a device mesh, the sharded
train step of trainers/mesh.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..filters.base import Accelerator
from ..pipeline.element import TransformElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig, TensorsInfo
from ..trainers.base import (TrainerEvent, TrainerProperties, TrainerStatus,
                             find_trainer)
from ..utils.log import logger


@register_element("tensor_trainer")
class TensorTrainer(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    RESTART_SAFE = False  # a restart would lose optimizer/step state
    CHECKPOINTABLE = ("completed-epoch counter + params (state_dict) + "
                      "optimizer moments")
    PROPS = {
        "framework": "torch-cuda",
        "model-config": "",
        "model-save-path": "",
        "model-load-path": "",
        "num-training-samples": 0,
        "num-validation-samples": 0,
        "epochs": 1,
        "num-inputs": 1,
        "num-labels": 1,
        "accelerator": "",
        # the sharded train step over a device mesh ("DxSxT"/"auto")
        # and its parameter rule table ("gpt")
        "mesh": "",
        "rules": "",
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.fw = None
        self._restore = None  # (state, snap_dir) stashed until start()

    def start(self) -> None:
        super().start()
        if self.fw is None:
            fw = find_trainer(self.framework)()
            fw.create(TrainerProperties(
                model_config=self.model_config,
                model_save_path=self.model_save_path,
                model_load_path=self.model_load_path,
                num_inputs=self.num_inputs,
                num_labels=self.num_labels,
                num_training_samples=self.num_training_samples,
                num_validation_samples=self.num_validation_samples,
                epochs=self.epochs,
                mesh=self.mesh,
                rules=self.rules,
                accelerators=(tuple(Accelerator.parse(self.accelerator))
                              if self.accelerator else ())))
            if self._restore is not None and hasattr(fw, "resume_from"):
                state, snap_dir = self._restore
                fw.resume_from(state, snap_dir)
                self._restore = None
            fw.set_event_notifier(self._on_trainer_event)
            self.fw = fw
            fw.start()

    def stop(self) -> None:
        if self.fw is not None:
            self.fw.stop()
            self.fw = None
        super().stop()

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        cfg = caps.to_config()
        out = TensorsConfig(TensorsInfo.make("float64", "4"),
                            rate_n=cfg.rate_n, rate_d=cfg.rate_d)
        self.set_src_caps(Caps.from_config(out))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        needed = self.num_inputs + self.num_labels
        if len(buf.chunks) != needed:
            raise ValueError(
                f"{self.name}: sample has {len(buf.chunks)} tensors, "
                f"expected num-inputs+num-labels = {needed}")
        self.fw.push_data([c.host() for c in buf.chunks])
        return None  # results flow via _on_trainer_event

    def _on_trainer_event(self, event: TrainerEvent,
                          status: TrainerStatus) -> None:
        arr = np.array([status.training_loss, status.training_accuracy,
                        status.validation_loss, status.validation_accuracy],
                       np.float64)
        self.push(Buffer([Chunk(arr)], pts=status.epoch))
        self.post_message("trainer-epoch", epoch=status.epoch,
                          training_loss=status.training_loss,
                          training_accuracy=status.training_accuracy,
                          validation_loss=status.validation_loss,
                          validation_accuracy=status.validation_accuracy)
        if event == TrainerEvent.TRAINING_COMPLETION:
            logger.info("%s: training complete at epoch %d",
                        self.name, status.epoch)

    def on_eos(self) -> None:
        """Wait for the training thread before forwarding EOS
        (≙ wait_for_epoch_completion, gsttensor_trainer.c:590)."""
        if self.fw is not None and hasattr(self.fw, "end_of_data"):
            self.fw.end_of_data()  # stop waiting on the sample queue
        if self.fw is not None and hasattr(self.fw, "wait_training_complete"):
            self.fw.wait_training_complete(timeout=600.0)

    # -- checkpoint/restore (checkpoint/) ----------------------------------
    def preempt(self) -> None:
        """Preemption pauses training at the step boundary; a regular
        drain must keep FINISHING the remaining epochs (on_eos waits for
        completion), so the default drain-delegating hook is wrong
        here."""
        if self.fw is not None and hasattr(self.fw, "pause"):
            self.fw.pause()

    def snapshot_state(self, snap_dir):
        if self.fw is None:
            # snapshotting a restored-but-never-started pipeline:
            # preserve the stashed state (and its params files) rather
            # than dropping it
            if self._restore is not None:
                import os
                import shutil
                state, old_dir = self._restore
                if os.path.isdir(old_dir):
                    shutil.copytree(old_dir, snap_dir, dirs_exist_ok=True)
                return state
            return None
        if hasattr(self.fw, "snapshot"):
            return self.fw.snapshot(snap_dir)
        return None

    def restore_state(self, state, snap_dir):
        self._restore = (state, snap_dir)
