"""The PyTorch trainer subplugin (``framework=torch-cuda``) — the port's
counterpart of ``nnstreamer_tpu/trainers/jax_trainer.py``.

model-config is a python file defining::

    def get_trainer():
        # returns (loss_fn, module, optimizer)
        # loss_fn(module, inputs: list[Tensor], labels: list[Tensor])
        #   -> (scalar loss, scalar accuracy)
        # optimizer: a torch.optim.Optimizer over module.parameters(),
        #   or a callable taking the parameters and returning one
        ...

or ``zoo://<name>?...`` for a zoo classifier trained with softmax
cross-entropy and Adam (``lr``, default 1e-3; ``torch.optim.Adam`` at
optax's defaults: b1 0.9, b2 0.999, eps 1e-8, the same update rule).
Samples pushed by tensor_trainer accumulate into batches on the
trainer's device; epochs run on a background thread that DRAINS the
queue each epoch (the streaming-training model of gsttensor_trainer.c:
the src replays the dataset per epoch, e.g. datareposrc epochs=N, and
the trainer consumes num-training-samples every epoch): one optimizer
step over the epoch's batch, then the validation loss with the updated
weights. If the stream ends early the last complete dataset is reused
for remaining epochs, and once training finishes further pushed samples
are discarded so EOS can propagate. Checkpoints are ``state_dict``
files (trainers/checkpoint.py).

Device: ``cuda:0`` unless ``accelerators`` opts out (tensor_trainer's
``accelerator=true:cpu`` or ``false``); asking for the card where CUDA is
missing raises at create. Randomness comes from explicit generators
(the zoo's seeded init); the loop itself draws none.

``mesh=DxSxT`` (or ``auto``) with ``rules=<table>`` trains on a device
mesh (trainers/mesh.py): the model is placed by the rule table, and a
step is one mesh command over every rank, the batch split over
``data``.

Refused at create, with :class:`~..pipeline.element.NotPortedError`:

* ``zoo://vit?attn=pallas``: the hand attention kernel has no backward.
  The JAX reference fails at its first step on its own device (no
  linearization of ``pallas_call``) and on the CPU trains through its
  plain attention; the port trains only the stock attention;
* a zoo model whose module keeps buffers (``mobilenet_v2`` and the
  detection models built on it: BatchNorm statistics). The JAX trainer
  hands Adam the whole ``variables`` dict, so it updates those
  statistics by gradient as if they were weights; the port keeps them
  as buffers, which no optimizer sees, and would train other leaves.

Step coherence: a step (gradient, optimizer update, status) runs under
``_step_lock`` and :meth:`snapshot` takes the same lock, so a snapshot
never pairs weights of step N with optimizer moments of step N-1.
"""
from __future__ import annotations

import os
import queue as _pyqueue
import threading
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.log import logger
from .base import (TrainerEvent, TrainerFramework, TrainerProperties,
                   TrainerStatus, register_trainer)

LossFn = Callable[[torch.nn.Module, List[torch.Tensor], List[torch.Tensor]],
                  Tuple[torch.Tensor, torch.Tensor]]


def _zoo_classifier_trainer(name: str, **kwargs):
    """A zoo model as (loss_fn, module, optimizer factory) for
    cross-entropy classification (labels = int class or one-hot)."""
    from ..models import zoo
    from ..pipeline.element import NotPortedError

    lr = float(kwargs.pop("lr", "1e-3"))  # trainer knob, not a model kwarg
    if name == "vit" and kwargs.get("attn") == "pallas":
        raise NotPortedError(
            "torch-cuda trainer: zoo://vit?attn=pallas — the hand "
            "attention kernel has no backward; train with attn=stock "
            "(or auto) and serve the checkpoint with attn=pallas")
    apply_fn, module, _, _ = zoo.build(name, **kwargs)
    buffers = [n for n, _ in module.named_buffers()]
    if buffers:
        raise NotPortedError(
            f"torch-cuda trainer: zoo://{name} keeps buffers "
            f"({', '.join(buffers[:3])}, ...) that the JAX trainer "
            "updates as parameters; training it is not ported")

    def loss_fn(m, inputs, labels):
        logits = apply_fn(m, inputs[0])  # zoo apply fns take a batch
        y = labels[0]
        if y.dim() > 1 and y.shape[-1] == logits.shape[-1]:
            targets = y.argmax(dim=-1)
        else:
            targets = y.reshape(-1).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[:, None]).mean()
        acc = (logits.argmax(dim=-1) == targets).float().mean()
        return nll, acc

    return loss_fn, module, lambda params: torch.optim.Adam(params, lr=lr)


def load_trainer_config(cfg: str):
    """``(loss_fn, module, optimizer)`` of a ``zoo://`` URI or a ``.py``
    model-config defining ``get_trainer()``."""
    if cfg.startswith("zoo://"):
        parsed = urllib.parse.urlparse(cfg)
        kwargs = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        name = parsed.netloc or parsed.path.lstrip("/")
        return _zoo_classifier_trainer(name, **kwargs)
    if cfg.endswith(".py"):
        ns: Dict[str, Any] = {}
        with open(cfg) as f:
            exec(compile(f.read(), cfg, "exec"), ns)  # noqa: S102 — user model config
        if "get_trainer" not in ns:
            raise ValueError(f"{cfg}: must define get_trainer()")
        return ns["get_trainer"]()
    raise ValueError(f"torch-cuda trainer cannot load model-config {cfg!r}")


@register_trainer
class TorchCudaTrainer(TrainerFramework):
    NAME = "torch-cuda"

    def __init__(self):
        self._props: Optional[TrainerProperties] = None
        self._queue: _pyqueue.Queue = _pyqueue.Queue(maxsize=256)
        self._thread: Optional[threading.Thread] = None
        self._status = TrainerStatus()
        self._status_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._done_evt = threading.Event()
        self._eos_evt = threading.Event()
        self.device: Optional[torch.device] = None
        self.module: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self._loss_fn: Optional[LossFn] = None
        # one step (backward, update, status) at a time against a
        # snapshot: the pair (weights, moments) is always step-coherent
        self._step_lock = threading.Lock()
        # epochs whose step is complete; training resumes after it
        self._epoch_done = 0
        # mesh mode (trainers/mesh.py): the mesh and the kept trainer
        self._mesh = None
        self._mesh_trainer = None

    # -- lifecycle --------------------------------------------------------
    def create(self, props: TrainerProperties) -> None:
        from ..filters.torch_cuda_backend import device_for, full_f32_numerics
        self._props = props
        if props.mesh:
            self._create_mesh(props)
            return
        self.device = device_for(props.accelerators)
        full_f32_numerics()
        cfg = props.model_config
        self._loss_fn, module, optimizer = load_trainer_config(cfg)
        if props.model_load_path:
            from .checkpoint import restore_params
            restore_params(props.model_load_path, module)
        # Module.to keeps the Parameter objects, so an optimizer built
        # over them before the move still steps the card's weights
        self.module = module.to(self.device)
        for p in self.module.parameters():
            p.requires_grad_(True)
        self.optimizer = optimizer if isinstance(
            optimizer, torch.optim.Optimizer) \
            else optimizer(list(self.module.parameters()))
        logger.info("torch-cuda trainer: %s on %s", cfg, self.device)

    def _create_mesh(self, props: TrainerProperties) -> None:
        """Mesh mode (trainers/mesh.py): the model opened and placed on
        every rank of the mesh."""
        from ..filters.torch_cuda_backend import device_for, full_f32_numerics
        from ..parallel import mesh as pmesh, sharding, world
        from . import mesh as tmesh
        # the card unless the caller opts out; raises without CUDA
        device = device_for(props.accelerators)
        mesh = pmesh.mesh_from_spec(str(props.mesh), device.type)
        rules = sharding.rules_by_name(str(props.rules or ""))
        world.retain(device.type)
        try:
            full_f32_numerics()
            self.device = world.local_device()
            self._mesh_trainer = world.run(
                tmesh.open_trainer, props.model_config,
                props.model_load_path or "", rules, mesh)
        except BaseException:
            world.release()
            raise
        self._mesh = mesh
        self.module = self._mesh_trainer.state.params
        self.optimizer = self._mesh_trainer.state.opt_state
        logger.info("torch-cuda trainer: %s on mesh %s", props.model_config,
                    pmesh.shape_of(mesh))

    def start(self) -> None:
        self._stop_evt.clear()
        self._done_evt.clear()
        self._eos_evt.clear()
        self._thread = threading.Thread(target=self._train_loop,
                                        name="torch-cuda-trainer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._join()
        if self._props and self._props.model_save_path and \
                self.module is not None:
            from .checkpoint import save_params
            save_params(self._props.model_save_path, self._whole_params())
            logger.info("torch-cuda trainer: saved model to %s",
                        self._props.model_save_path)

    def destroy(self) -> None:
        self._stop_evt.set()
        if self._mesh is not None:
            from ..parallel import world
            self._join()
            self._mesh = None
            self._mesh_trainer = None
            self.module = self.optimizer = None
            world.release()

    def _whole_params(self):
        """The module, or in mesh mode its whole ``state_dict`` gathered
        on rank 0."""
        if self._mesh is None:
            return self.module
        from ..parallel import world
        from . import mesh as tmesh
        return world.run(tmesh.gather_state, self._mesh_trainer, False)[0]

    def _join(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=60.0)
            if t.is_alive():
                logger.warning("torch-cuda trainer: the training thread "
                               "did not stop within 60 s")
        self._thread = None

    # -- preemption checkpoint/restore (checkpoint/) -----------------------
    def pause(self) -> None:
        """Preemption quiesce: stop at the next step boundary and join
        the training thread so :meth:`snapshot` reads settled state.
        Unlike ``stop()`` this saves nothing to model-save-path — the
        snapshot store owns persistence on this path."""
        self._join()

    def snapshot(self, snap_dir: str) -> Optional[Dict]:
        """The weights of the last completed step into
        ``snap_dir/params`` (trainers/checkpoint.py) and, in the returned
        blob, the optimizer's ``state_dict`` on the CPU, the epoch and
        the status. Epoch semantics: ``epoch`` steps are COMPLETE;
        resume runs ``epoch+1..epochs`` — never a repeated or skipped
        update."""
        if self.module is None:
            return None
        from .checkpoint import save_params
        with self._step_lock:
            if self._mesh is not None:
                from ..parallel import world
                from . import mesh as tmesh
                sd, opt_state = world.run(tmesh.gather_state,
                                          self._mesh_trainer, True)
                save_params(os.path.join(snap_dir, "params"), sd)
            else:
                save_params(os.path.join(snap_dir, "params"), self.module)
                opt_state = _to_cpu(self.optimizer.state_dict())
            epoch = self._epoch_done
        return {"epoch": int(epoch), "opt_state": opt_state,
                "status": vars(self.get_status())}

    def resume_from(self, state: Dict, snap_dir: str) -> None:
        """Apply a :meth:`snapshot` blob after :meth:`create` and before
        :meth:`start`: the weights reload into the module where it
        lives, the optimizer's moments and step counts come back, and
        the epoch counter resumes exactly after the recorded step."""
        from .checkpoint import restore_params
        if self.module is None:
            raise RuntimeError("resume_from requires create()")
        if self._mesh is not None:
            from ..parallel import world
            from . import mesh as tmesh
            world.run(tmesh.restore_state, self._mesh_trainer,
                      restore_params(os.path.join(snap_dir, "params")),
                      state.get("opt_state"))
        else:
            restore_params(os.path.join(snap_dir, "params"), self.module)
            if state.get("opt_state") is not None:
                self.optimizer.load_state_dict(state["opt_state"])
        self._epoch_done = int(state.get("epoch", 0))  # racecheck: ok(resume_from runs in the trainer element's start() before fw.start(): the training worker does not exist yet)
        st = state.get("status") or {}
        with self._status_lock:
            self._status = TrainerStatus(**st) if st else TrainerStatus(
                epoch=self._epoch_done)
        logger.info("torch-cuda trainer: resuming after epoch %d",
                    self._epoch_done)

    # -- data -------------------------------------------------------------
    def push_data(self, tensors: Sequence[Any]) -> None:
        # discard once training has finished so upstream never blocks on a
        # full queue after the last epoch (EOS must still propagate)
        while not self._stop_evt.is_set() and not self._done_evt.is_set():
            try:
                self._queue.put(list(tensors), timeout=0.5)
                return
            except _pyqueue.Full:
                continue

    def end_of_data(self) -> None:
        """Upstream EOS: no more samples will arrive. The training loop
        stops waiting on the queue and reuses the last complete dataset
        for any remaining epochs."""
        self._eos_evt.set()

    def get_status(self) -> TrainerStatus:
        with self._status_lock:
            return TrainerStatus(**vars(self._status))

    def wait_training_complete(self, timeout: Optional[float] = None) -> bool:
        return self._done_evt.wait(timeout)

    # -- training loop ----------------------------------------------------
    def _collect(self, n: int) -> Optional[List[List[np.ndarray]]]:
        samples: List[List[np.ndarray]] = []
        while len(samples) < n and not self._stop_evt.is_set():
            try:
                samples.append(self._queue.get(timeout=0.1))
            except _pyqueue.Empty:
                if self._eos_evt.is_set() and self._queue.empty():
                    break  # stream ended mid-epoch; caller reuses last set
        return samples if len(samples) == n else None

    def _batch_of(self, samples):
        """(inputs, labels): each column of the samples stacked into one
        tensor on the trainer's device."""
        cols = [torch.from_numpy(np.ascontiguousarray(np.stack(c)))
                .to(self.device) for c in zip(*samples)]
        n_in = self._props.num_inputs
        return cols[:n_in], cols[n_in:]

    def _step(self, inputs, labels) -> Tuple[float, float]:
        """One optimizer step on the batch; (loss, accuracy) before it."""
        if self._mesh is not None:
            from ..parallel import world
            from . import mesh as tmesh
            return world.run(tmesh.step, self._mesh_trainer, inputs, labels)
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self._loss_fn(self.module, inputs, labels)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach()), float(acc)

    def _train_loop(self) -> None:
        p = self._props
        try:
            train: Optional[List[List[np.ndarray]]] = None
            val: Optional[List[List[np.ndarray]]] = None
            for epoch in range(self._epoch_done + 1, p.epochs + 1):
                if self._stop_evt.is_set():
                    return
                # drain this epoch's samples from the stream; on a short
                # stream (src stopped replaying) reuse the previous epoch's
                t = self._collect(p.num_training_samples)
                if self._stop_evt.is_set():
                    return  # stop requested mid-collection: no extra step
                if t is not None:
                    train = t
                    if p.num_validation_samples:
                        v = self._collect(p.num_validation_samples)
                        if v is not None:
                            val = v
                if train is None:
                    logger.warning("torch-cuda trainer: stream ended "
                                   "before a full training set arrived; "
                                   "aborting")
                    return
                with self._step_lock:
                    loss, acc = self._step(*self._batch_of(train))
                    vloss = vacc = 0.0
                    if val and self._mesh is not None:
                        from ..parallel import world
                        from . import mesh as tmesh
                        vloss, vacc = world.run(tmesh.evaluate,
                                                self._mesh_trainer,
                                                *self._batch_of(val))
                    elif val:
                        with torch.no_grad():
                            vloss, vacc = (float(x) for x in self._loss_fn(
                                self.module, *self._batch_of(val)))
                    with self._status_lock:
                        self._status = TrainerStatus(epoch, loss, acc,
                                                     vloss, vacc)
                    self._epoch_done = epoch
                self._emit(TrainerEvent.EPOCH_COMPLETION, self.get_status())
            self._emit(TrainerEvent.TRAINING_COMPLETION, self.get_status())
        except Exception:  # noqa: BLE001 — the training thread's boundary
            logger.exception("torch-cuda trainer loop failed")
        finally:
            self._done_evt.set()


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU (an optimizer's
    ``state_dict`` for a snapshot blob)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
