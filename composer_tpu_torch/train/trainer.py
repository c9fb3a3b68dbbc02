"""The training loop: port of ``composer_tpu/train/trainer.py``, for both model families.

One eager train step: forward in training mode (dropout from an explicit
``torch.Generator``), f32 cross-entropy, backward (through the flash
kernels when the Transformer routes attention there), global-norm clipping
and Adam. Parameters and optimizer state stay float32; with
``mixed_precision`` on a CUDA device the model computes in bfloat16, as the
JAX package does on the TPU.

MusicRNN is stateful: its LSTM carry runs on from one batch to the next
through an epoch (reset at each epoch unless ``reset_rnn_state_each_epoch``
is False) and through ``evaluate``'s batches in dataset order, and is
detached after each step, so that no gradient crosses a batch. Its training
forward updates the BatchNorm running statistics in place; the checkpoint
holds them with the weights.

Optimizer parity with optax (``make_optimizer``): Adam with eps 1e-7,
``linear_schedule(0, lr, warmup)`` evaluated at the update count before the
update (lr 0 at the first update), and ``clip_by_global_norm``, which
rescales by ``max_norm / norm`` only when ``norm >= max_norm`` (unlike
``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm).

``Trainer.train(profile_dir=...)`` writes a ``torch.profiler`` trace (a
Chrome trace, with the card's kernels when the trainer runs on CUDA) of the
call's steps [2, 2 + profile_steps).

``Trainer(mesh=)`` trains on a ``(data, model)`` mesh of
``torch.distributed`` ranks (``parallel/mesh.py``), each rank a process
that runs this same loop. Every rank initialises the full model from
``seed`` and keeps its slice, so a mesh run starts at the single-device
weights. Each rank takes its data coordinate's rows of the global batch;
the Transformer is cut by heads and MLP units over the model axis
(``models/transformer.py``; MusicRNN is replicated there, data parallel
only, as in the JAX package). After the backward pass the gradients are
summed over the data group and divided by its degree, in one
``all_reduce``; the clipping norm is global (the squares of the sharded
gradients summed over the model group, the replicated ones counted once);
Adam runs elementwise on each rank's slices. Losses and accuracies are
averaged over the data group. Residual dropout draws from a generator
seeded by ``(seed, data coordinate)``, the same across a model group.
Checkpoints are gathered to the leader (rank (0, 0)) and written in the
single-device format, so a single-device ``restore`` and
``scripts/convert_checkpoint.py`` read them unchanged; ``restore`` on a
mesh slices the full file. Only the leader writes checkpoints and metrics.

Not ported: the TPU dropout-generator choice (``dropout_rng_impl``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from tqdm import tqdm

from composer_tpu_torch import ModelSaveFrequencyMode
from composer_tpu_torch.exceptions import CheckpointError
from composer_tpu_torch.models import ModelType
from composer_tpu_torch.models.music_rnn import init_state as rnn_init_state
from composer_tpu_torch.parallel import mesh as mesh_lib
from composer_tpu_torch.train.checkpoint import CheckpointManager
from composer_tpu_torch.train.metrics import MetricsWriter


@dataclasses.dataclass
class TrainState:
    """Counters (both start at 1, as in the JAX package) and the live model
    and optimizer, which the train step updates in place (MusicRNN's
    BatchNorm statistics are buffers of the model, so its ``state_dict``
    holds them)."""

    step: int
    epoch: int
    model: torch.nn.Module
    optimizer: "Adam"

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch,
                "params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict()}


def cross_entropy_and_accuracy(logits, labels):
    """Mean sparse cross-entropy (in float32) and argmax accuracy."""
    loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1))
    accuracy = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, accuracy


class Adam:
    """``optax.adam`` on a list of parameters, updated in place, with optax's
    order of operations: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
    bias corrections ``1 - b^t`` in float32, ``mu_hat / (sqrt(nu_hat) + eps)``
    scaled by ``-lr``. ``count`` is the number of updates made.

    ``torch.optim.Adam`` (eps 1e-7) computes the same update in another
    order (``lerp`` for mu, the step size ``lr / (1 - b1^t)`` in float64)
    and lands up to 1.7e-6 from optax after 6 updates at lr 0.1, outside
    the 1e-6 that ``test_make_optimizer_matches_optax`` holds."""

    def __init__(self, params, spec: "Optimizer"):
        self.params = list(params)
        self.spec = spec
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # grads -> their squared global norm; None sums them all here.
        self.squared_norm = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the gradients in ``.grad`` (missing ones are 0)."""
        b1, b2 = 0.9, 0.999
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        self.spec.clip_(grads, self.squared_norm)
        step_size = -self.spec.learning_rate_at(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        count = np.float32(self.count)
        mu_hat = torch._foreach_div(self.mu, float(np.float32(1) - np.float32(b1) ** count))
        nu_hat = torch._foreach_div(self.nu, float(np.float32(1) - np.float32(b2) ** count))
        updates = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.spec.eps))
        torch._foreach_mul_(updates, step_size)
        torch._foreach_add_(self.params, updates)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError("optimizer state does not match the parameters")
        for mine, saved in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if mine.shape != saved.shape:
                raise ValueError(f"optimizer state of shape {tuple(saved.shape)} does not "
                                 f"match a parameter of shape {tuple(mine.shape)}")
            mine.copy_(saved)
        self.count = int(state["count"])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam with optional linear warmup and global-norm clipping, with
    optax's definitions (see the module docstring)."""

    learning_rate: float
    eps: float = 1e-7
    warmup_steps: int = 0
    gradient_clip_norm: float = 0.0

    def init(self, params) -> Adam:
        return Adam(params, self)

    def learning_rate_at(self, count: int) -> float:
        """``optax.linear_schedule(0, lr, warmup)(count)``."""
        if self.warmup_steps <= 0:
            return self.learning_rate
        fraction = 1.0 - min(max(count, 0), self.warmup_steps) / self.warmup_steps
        return -self.learning_rate * fraction + self.learning_rate

    def clip_(self, grads, squared_norm=None) -> None:
        """``optax.clip_by_global_norm`` on the gradients, in place.
        ``squared_norm`` (grads -> a scalar tensor) forms the squared global
        norm where this rank holds slices of some of them."""
        if not self.gradient_clip_norm or self.gradient_clip_norm <= 0.0:
            return
        if squared_norm is None:
            norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
        else:
            norm = squared_norm(grads).sqrt()
        scaled = [g / norm * self.gradient_clip_norm for g in grads]
        keep = norm < self.gradient_clip_norm
        for g, s in zip(grads, scaled):
            torch.where(keep, g, s, out=g)


def make_optimizer(learning_rate: float, eps: float = 1e-7, warmup_steps: int = 0,
                   gradient_clip_norm: float = 0.0) -> Optimizer:
    """Adam, optionally with linear LR warmup and global-norm clipping."""
    return Optimizer(learning_rate, eps, warmup_steps, gradient_clip_norm)


class Trainer:
    """Shared train/evaluate loop for both model families. Runs on
    ``device``: the CUDA card unless the caller asks for ``"cpu"``. With a
    ``mesh`` (``parallel/mesh.py``), on the mesh's device, whose type must
    be ``device``'s; a Transformer is rebuilt in its tensor-parallel form
    (``ValueError`` where the model degree does not divide its heads)."""

    def __init__(self, model, model_type: ModelType, learning_rate: float, mesh=None,
                 seed: int = 0, warmup_steps: int = 0, gradient_clip_norm: float = 0.0,
                 device="cuda"):
        self.device = torch.device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, not on {self.device}")
            self.device = mesh.device
            if model_type == ModelType.TRANSFORMER:
                model = type(model)(dataclasses.replace(model.config, flash_mesh=mesh))
            else:
                for norm in model.batch_norms:
                    if norm is not None:
                        norm.mesh = mesh
        self.model = model
        self.model_type = model_type
        self.optimizer = make_optimizer(learning_rate, warmup_steps=warmup_steps,
                                        gradient_clip_norm=gradient_clip_norm)
        self.mesh = mesh
        self.seed = seed
        # Only the leader writes checkpoints, metrics and the progress bar.
        self.is_leader = mesh is None or mesh.rank == mesh.leader

    # ------------------------------------------------------------------ state
    def init_state(self, batch_size: int, window_size: int) -> TrainState:
        """Fresh parameters from ``seed`` (the Flax initializers; MusicRNN's
        running statistics 0 and 1) on the device, and a fresh optimizer.
        The batch shape is not needed to
        build a PyTorch module; it is kept for the JAX package's interface."""
        del batch_size, window_size
        self.model.reset_parameters(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        optimizer = self.optimizer.init(self.model.parameters())
        if self.mesh is not None:
            optimizer.squared_norm = self._squared_norm
        return TrainState(step=1, epoch=1, model=self.model, optimizer=optimizer)

    def make_dropout_generator(self) -> torch.Generator:
        """The dropout stream of one ``train`` call, seeded by ``seed + 1``
        (and on a mesh by the data coordinate, the same across a model
        group)."""
        seed = self.seed + 1
        if self.mesh is not None:
            seed += self.mesh.data_index * 1000003
        return torch.Generator(device=self.device).manual_seed(seed)

    def init_rnn_carry(self, batch_size: int):
        """Zeroed MusicRNN carries on the device (this rank's rows of a
        ``batch_size`` batch); None for the Transformer."""
        if self.model_type != ModelType.MUSIC_RNN:
            return None
        if self.mesh is not None:
            batch_size //= self.mesh.data
        return rnn_init_state(self.model.config, batch_size, device=self.device)

    # ------------------------------------------------------------------ mesh
    def _sharded_names(self) -> set:
        return {name for name, _ in self.model.named_parameters()
                if mesh_lib.is_sharded(name, self.mesh)}

    def _squared_norm(self, grads) -> torch.Tensor:
        """The squared global norm of ``grads`` (in ``model.parameters()``
        order): the sharded ones' squares summed over the model group, the
        replicated ones' counted once."""
        sharded = self._sharded_names()
        parts = {True: [], False: []}
        for (name, _), g in zip(self.model.named_parameters(), grads):
            parts[name in sharded].append(torch.sum(g * g))
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        if parts[True]:
            total = mesh_lib.all_reduce_(torch.stack(parts[True]).sum(), self.mesh.model_group)
        if parts[False]:
            total = total + torch.stack(parts[False]).sum()
        return total

    def _average_gradients(self, model) -> None:
        """Every gradient summed over the data group and divided by its
        degree, in one ``all_reduce`` of one flat buffer."""
        if self.mesh.data_group is None:
            return
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        mesh_lib.all_reduce_(flat, self.mesh.data_group).div_(self.mesh.data)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))

    def _global_metrics(self, loss, accuracy):
        if self.mesh is None:
            return loss, accuracy
        both = mesh_lib.mean_over_data(torch.stack([loss.detach(), accuracy.detach()]),
                                       self.mesh)
        return both[0], both[1]

    def checkpoint_state(self, state: TrainState) -> dict:
        """``state.state_dict()`` in the single-device layout: on a mesh the
        parameters and Adam's moments gathered over the model group (every
        rank of it must call this)."""
        saved = state.state_dict()
        if not mesh_lib.tensor_parallel(self.mesh):
            return saved
        names = [name for name, _ in state.model.named_parameters()]
        saved["params"] = mesh_lib.gather_params(saved["params"], self.mesh)
        opt = saved["opt_state"]
        for moment in ("mu", "nu"):
            full = mesh_lib.gather_params(dict(zip(names, opt[moment])), self.mesh)
            opt[moment] = [full[name] for name in names]
        return saved

    def _load_checkpoint_state(self, state: TrainState, restored: dict) -> None:
        """Loads a single-device checkpoint, cut to this rank's slices on a mesh."""
        params, opt = restored["params"], dict(restored["opt_state"])
        if mesh_lib.tensor_parallel(self.mesh):
            names = [name for name, _ in state.model.named_parameters()]
            params = mesh_lib.shard_params(params, self.mesh)
            for moment in ("mu", "nu"):
                if len(opt[moment]) != len(names):
                    raise ValueError("optimizer state does not match the parameters")
                cut = mesh_lib.shard_params(dict(zip(names, opt[moment])), self.mesh)
                opt[moment] = [cut[name] for name in names]
        state.model.load_state_dict(params)
        state.optimizer.load_state_dict(opt)

    # ------------------------------------------------------------------ steps
    def _place_batch(self, x, y):
        """The batch on the device: on a mesh, this data coordinate's rows."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if self.mesh is not None:
            x, y = mesh_lib.local_rows(self.mesh, x), mesh_lib.local_rows(self.mesh, y)
        return x.to(self.device, torch.long), y.to(self.device, torch.long)

    def _forward(self, model, x, carry, **kwargs):
        """The model's logits and, for MusicRNN, its new carry (detached)."""
        if self.model_type == ModelType.TRANSFORMER:
            logits, _ = model(x, **kwargs)
            return logits, carry
        logits, new_carry = model(x, carry, **kwargs)
        return logits, tuple((c.detach(), h.detach()) for c, h in new_carry)

    def train_step(self, state: TrainState, x, y, generator=None, carry=None) -> dict:
        """One update; returns the step's loss and accuracy as device scalars
        (no host synchronisation) and, for MusicRNN, the new carry under
        ``"carry"`` (``carry`` None starts from zeros)."""
        x, y = self._place_batch(x, y)
        state.model.train()
        state.optimizer.zero_grad()
        logits, carry = self._forward(state.model, x, carry, deterministic=False,
                                      generator=generator)
        loss, accuracy = cross_entropy_and_accuracy(logits, y)
        loss.backward()
        if self.mesh is not None:
            self._average_gradients(state.model)
        state.optimizer.step()
        state.step += 1
        loss, accuracy = self._global_metrics(loss.detach(), accuracy)
        metrics = {"loss": loss, "accuracy": accuracy}
        if carry is not None:
            metrics["carry"] = carry
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, x, y, carry=None) -> dict:
        """Loss and accuracy as device scalars and, for MusicRNN, the new
        carry under ``"carry"``."""
        x, y = self._place_batch(x, y)
        state.model.eval()
        logits, carry = self._forward(state.model, x, carry)
        loss, accuracy = self._global_metrics(*cross_entropy_and_accuracy(logits, y))
        metrics = {"loss": loss, "accuracy": accuracy}
        if carry is not None:
            metrics["carry"] = carry
        return metrics

    # ------------------------------------------------------------------- loop
    def train(self, dataset, state: TrainState, logdir, epochs: Optional[int] = 10,
              save_frequency_mode=ModelSaveFrequencyMode.EPOCH, save_frequency: int = 1,
              max_checkpoints: int = 1, show_progress_bar: bool = True,
              reset_rnn_state_each_epoch: bool = True, profile_dir=None,
              profile_steps: int = 5) -> TrainState:
        """Runs the epoch/batch loop with checkpointing and scalars under
        ``<logdir>/train``; always leaves a final checkpoint. MusicRNN's
        carry starts at zeros and runs on through the batches, reset at each
        epoch when ``reset_rnn_state_each_epoch``.

        ``profile_dir`` captures a ``torch.profiler`` trace of this call's
        steps [2, 2 + profile_steps) into ``<profile_dir>/trace.json`` (a
        Chrome trace; CUDA activity included on the card). Step 1 is left
        out, as in the JAX package, so that warm-up does not dominate the
        trace; each step is a ``train_step <global step>`` range in it. The
        JAX package counts the global step, so a resumed run never
        profiles there; here a resumed run profiles its own second step on.
        """
        logdir = Path(logdir)
        save_frequency_mode = ModelSaveFrequencyMode(save_frequency_mode)
        checkpoints = _Checkpoints(self, logdir, max_checkpoints)
        writer = MetricsWriter(logdir / "train") if self.is_leader else _NoMetrics()
        show_progress_bar = show_progress_bar and self.is_leader
        generator = self.make_dropout_generator()
        carry = self.init_rnn_carry(dataset.batch_size)
        steps_per_epoch = len(dataset)
        events_per_batch = dataset.batch_size * dataset.window_size

        # Step metrics stay on the device and are fetched every
        # ``metrics_flush_steps`` steps in one transfer, so the host does not
        # wait for the device after every step.
        metrics_flush_steps = 16
        global_step = state.step - 1
        run_steps = 0
        profiler = None

        try:
            while epochs is None or state.epoch <= epochs:
                current_epoch = state.epoch
                logging.info("Epoch %s",
                             current_epoch if epochs is None else f"{current_epoch}/{epochs}")
                if reset_rnn_state_each_epoch:
                    carry = self.init_rnn_carry(dataset.batch_size)
                epoch_loss, epoch_accuracy, batch_count = 0.0, 0.0, 0
                pending = []  # (global_step, device metrics) not yet fetched
                progress = tqdm(total=steps_per_epoch, disable=not show_progress_bar)
                epoch_start = time.perf_counter()

                def drain(force=False):
                    nonlocal epoch_loss, epoch_accuracy, batch_count
                    if not pending or (not force and len(pending) < metrics_flush_steps):
                        return
                    values = torch.stack([torch.stack([m["loss"], m["accuracy"]])
                                          for _, m in pending]).tolist()
                    for (step_index, _), (loss, accuracy) in zip(pending, values):
                        epoch_loss += loss
                        epoch_accuracy += accuracy
                        batch_count += 1
                        writer.scalar("loss", loss, step_index)
                        writer.scalar("accuracy", accuracy, step_index)
                    progress.set_description(f"- loss: {loss:.4f} - accuracy: {accuracy:.4f}")
                    pending.clear()

                try:
                    for x, y in dataset:
                        run_steps += 1
                        if profile_dir is not None and profile_steps > 0 and run_steps == 2:
                            profiler = self._start_profile()
                        span = (torch.profiler.record_function(f"train_step {global_step + 1}")
                                if profiler is not None else contextlib.nullcontext())
                        with span:
                            metrics = self.train_step(state, x, y, generator, carry)
                        carry = metrics.pop("carry", None)
                        global_step += 1
                        if profiler is not None and run_steps == 1 + profile_steps:
                            self._stop_profile(profiler, profile_dir)
                            profiler, profile_dir = None, None
                        pending.append((global_step, metrics))
                        drain()
                        progress.update(1)
                        if (save_frequency_mode == ModelSaveFrequencyMode.GLOBAL_STEP
                                and global_step % save_frequency == 0):
                            checkpoints.save(global_step, state)
                finally:
                    # Record already-computed step metrics even when an
                    # exception escapes mid-epoch.
                    drain(force=True)
                elapsed = time.perf_counter() - epoch_start
                if batch_count:
                    writer.scalar("epoch_loss", epoch_loss / batch_count, current_epoch)
                    writer.scalar("epoch_accuracy", epoch_accuracy / batch_count, current_epoch)
                    writer.scalar("events_per_second",
                                  batch_count * events_per_batch / max(elapsed, 1e-9),
                                  current_epoch)
                progress.close()

                state.epoch += 1
                if (save_frequency_mode == ModelSaveFrequencyMode.EPOCH
                        and current_epoch % save_frequency == 0):
                    checkpoints.save(state.step - 1, state)
                writer.flush()

            final_step = state.step - 1
            if final_step > 0 and checkpoints.latest != final_step:
                checkpoints.save(final_step, state)
        finally:
            if profiler is not None:  # the run ended inside the profiled steps
                self._stop_profile(profiler, profile_dir)
            checkpoints.wait()
            writer.close()
        return state

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler, profile_dir) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        profile_dir = Path(profile_dir)
        profile_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(profile_dir / "trace.json"))
        logging.info("Wrote a profiler trace to '%s'.", profile_dir / "trace.json")

    def evaluate(self, dataset, state: TrainState, scan_chunk: int = 64) -> dict:
        """Mean loss/accuracy/perplexity over a dataset (the NLL parity
        surface). Batch metrics stay on the device and are fetched every
        ``scan_chunk`` batches. MusicRNN's carry starts at zeros and runs
        through every batch in dataset order, as the JAX package's scan."""
        carry = self.init_rnn_carry(dataset.batch_size)
        total_loss, total_accuracy, batches = 0.0, 0.0, 0
        pending = []

        def drain():
            nonlocal total_loss, total_accuracy
            for loss, accuracy in torch.stack(pending).tolist():
                total_loss += loss
                total_accuracy += accuracy
            pending.clear()

        for x, y in dataset:
            metrics = self.eval_step(state, x, y, carry)
            carry = metrics.get("carry")
            pending.append(torch.stack([metrics["loss"], metrics["accuracy"]]))
            batches += 1
            if len(pending) >= scan_chunk:
                drain()
        if pending:
            drain()

        if batches == 0:
            return {"loss": float("nan"), "accuracy": float("nan"), "perplexity": float("nan")}
        mean_loss = total_loss / batches
        return {"loss": mean_loss, "accuracy": total_accuracy / batches,
                "perplexity": float(torch.tensor(mean_loss, dtype=torch.float64).exp())}

    # ------------------------------------------------------------- restoring
    def restore(self, logdir, batch_size: int, window_size: int) -> TrainState:
        """Restores the latest checkpoint under ``logdir`` (on a mesh, each
        rank its slices of it)."""
        state = self.init_state(batch_size, window_size)
        restored = CheckpointManager(Path(logdir)).restore(map_location=self.device)
        try:
            self._load_checkpoint_state(state, restored)
        except (KeyError, RuntimeError, ValueError) as error:
            raise CheckpointError(
                f"Checkpoint under '{logdir}' does not match the "
                f"{type(self.model).__name__} being restored (wrong model type for "
                f"this run, or an incompatible config?): {error}"
            ) from error
        state.step, state.epoch = int(restored["step"]), int(restored["epoch"])
        return state


class _Checkpoints:
    """The train loop's checkpoints: saved in the single-device layout by
    the leader; on a mesh every rank gathers (``Trainer.checkpoint_state``)
    and knows the latest step saved, so that all take the same decisions."""

    def __init__(self, trainer: Trainer, logdir: Path, max_to_keep: int):
        self.trainer = trainer
        self.manager = (CheckpointManager(logdir, max_to_keep=max_to_keep)
                        if trainer.is_leader else None)
        latest = self.manager.latest_step() if self.manager is not None else None
        mesh = trainer.mesh
        if mesh is not None and mesh.group is not None:
            known = torch.tensor([-1 if latest is None else latest], device=mesh.device)
            mesh_lib.broadcast_(known, mesh.leader, mesh.group)
            latest = None if int(known) < 0 else int(known)
        self.latest = latest

    def save(self, step: int, state: TrainState) -> None:
        saved = self.trainer.checkpoint_state(state)
        if self.manager is not None:
            self.manager.save(step, saved)
        mesh = self.trainer.mesh
        if mesh is not None and mesh.group is not None:
            # Written before any rank goes on (and might restore it).
            mesh_lib.broadcast_(torch.zeros(1, device=mesh.device), mesh.leader, mesh.group)
        self.latest = step

    def wait(self) -> None:
        if self.manager is not None:
            self.manager.wait()


class _NoMetrics:
    """The metrics writer of a rank other than the leader."""

    def scalar(self, *args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
