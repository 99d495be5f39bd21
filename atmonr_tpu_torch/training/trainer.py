"""Training runtime: one step covering gather -> draws -> forward -> loss ->
backward -> clip -> AdamW -> progress-pixel scatter, the occupancy-grid
refresh on its cadence, and the host-side epoch loop for metrics, the RGB
comparison image, logging, asynchronous checkpoints and profiling.
Counterpart of the JAX package's ``training/trainer.py``, on one device.

Nothing in a step waits for the device: the batch is gathered from the
device-resident ray set, the random draws come from generators that live on
the device, the clip is computed there, and the loss is logged one print
block late from a copy that was enqueued at the block's end. The only
fetches are one at ``restart_on_plateau.check_iter`` and those at an epoch's
end. ``check_numerics`` gives that up to raise at the first non-finite loss
or gradient.

Random streams: the Trainer owns four ``torch.Generator``s on its device,
seeded from ``seed`` (parameter init, epoch permutations, per-step draws,
occupancy jitter). A checkpoint holds their states, so a resumed run on the
CPU continues exactly as the uninterrupted run would.

On several devices (``shard(mesh)``, one process per device): each data
index of the mesh holds its own contiguous rows of the ray set and permutes
them every epoch (the JAX package draws one permutation over the whole
sharded set instead; both visit every ray once an epoch), the sample ranks
of a data index march slices of the same rays, and after the backward one
``all_reduce`` of a flat buffer per mesh axis makes the gradient and the
loss the same on every rank (``parallel/train.py::reduce_gradients``)
before the clip and AdamW. The init, permutation and occupancy streams are
the same on every rank, so the parameters and the occupancy grid stay
equal with no other collective; the draws stream is seeded by the data
index, so that the sample ranks of a row place the same samples. The
mesh's first rank prints, logs and writes checkpoints; every rank loads
them.
"""

from __future__ import annotations

import contextlib
import json
import signal
import warnings
from datetime import datetime
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from atmonr_tpu_torch.data import batching
from atmonr_tpu_torch.parallel import mesh as pmesh
from atmonr_tpu_torch.training import checkpoint as ckpt
from atmonr_tpu_torch.training.metrics import image_metrics
from atmonr_tpu_torch.training.schedules import make_lr_schedule
from atmonr_tpu_torch.utils import spans
from atmonr_tpu_torch.utils.device import resolve_device

# the color maps whose prediction in each ray's own band the step keeps
_PROGRESS_MAPS = ("color_map_fine", "color_map_surf", "color_map_atmo")


class _ScalarLogger:
    """JSONL always; TensorBoard too when its writer can be imported (the
    epoch images go to TensorBoard only)."""

    def __init__(self, log_dir: Path) -> None:
        log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(log_dir / "metrics.jsonl", "a")
        self.tb = None
        try:
            from torch.utils.tensorboard.writer import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(str(log_dir))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        if self.tb is not None:
            self.tb.add_image(tag, np.transpose(img_hwc, (2, 0, 1)), step)

    def flush(self) -> None:
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class _NullLogger:
    """The logger of a rank that does not write: the mesh's first rank
    writes for all."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _quiet(*args, **kwargs) -> None:
    pass


class _LaggedScalar:
    """A 0-d device tensor on its way to the host: the copy is enqueued at
    construction, behind the work that computes the value, and ``get`` waits
    for that copy alone, not for what was enqueued after it."""

    def __init__(self, value: torch.Tensor) -> None:
        self.event = None
        if value.is_cuda:
            self.host = torch.empty((), dtype=value.dtype, pin_memory=True)
            self.host.copy_(value, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = value

    def get(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.host)


def _stream_seed(seed: int, *stream: int) -> int:
    """A well-mixed 64-bit seed for one of the Trainer's random streams."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0])


def _draws_seed(seed: int, data_index: int) -> int:
    """The draws stream of a data index; index 0's is the unsharded one."""
    return _stream_seed(seed, 2, *([data_index] if data_index else []))


class Trainer:
    """Trains a neural rendering pipeline on a HARP2 ray dataset, on
    ``device`` (``cuda`` unless the caller names another; raises when there
    is no card). The pipeline's parameters are drawn anew from ``seed``."""

    def __init__(
        self,
        config: dict,
        dataset,
        pipeline,
        exp_name: str,
        data_root: str | Path = "data",
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        if pipeline.device.type != self.device.type:
            raise ValueError(
                f"the pipeline lives on {pipeline.device}, the Trainer was asked "
                f"for {self.device}"
            )
        self.config = config
        self.dataset = dataset
        self.pipeline = pipeline
        self.seed = int(seed)
        self.batch_size = int(config["batch_size"])
        if self.batch_size > len(dataset):
            warnings.warn(
                f"batch_size {self.batch_size} exceeds the ray count "
                f"{len(dataset)}; clamping to the dataset size."
            )
            self.batch_size = len(dataset)
        self.num_iters = int(config["num_iters"])
        self.print_frequency = int(config.get("print_frequency", 10))
        self.check_numerics = bool(config.get("check_numerics", False))
        # progress metrics: the per-band prediction gather and the pixel
        # scatter of every step; "progress": false drops them, the epoch
        # PSNR/SSIM and the RGB image (loss logging and checkpoints are
        # unaffected)
        self.progress = bool(config.get("progress", True))
        # collapse guard: a run whose recent loss is still above the
        # threshold check_iter steps after its (re)start is re-initialised,
        # at most max_restarts times; a healthy run is checked once
        rop = config.get("restart_on_plateau") or None
        if rop:
            rop = {
                "check_iter": int(rop.get("check_iter", 150)),
                "loss_threshold": float(rop.get("loss_threshold", 1.0)),
                "max_restarts": int(rop.get("max_restarts", 3)),
            }
        self.restart_on_plateau = rop
        self._restarts = 0
        self._restart_base = 0
        # gradient micro-batching: micro-batches of this many rays, their
        # gradients averaged before the one optimizer update (the full-batch
        # step, since losses are per-ray means) at a micro-batch's memory
        self.micro_batch = self._normalize_micro(
            int(config.get("micro_batch_size", 0)) or None, self.batch_size
        )

        self.mesh = None
        self.axes: pmesh.MeshAxes | None = None  # this rank's view of the mesh
        self.rays = dataset.rays(self.device)
        self.num_rays = len(dataset)
        # this rank's rays and rays per step (the whole set and batch
        # without a mesh)
        self.rank_rays, self.rank_batch = self.num_rays, self.batch_size
        self.steps_per_epoch = max(1, self.num_rays // self.batch_size)
        self.num_epochs = -(-self.num_iters // self.steps_per_epoch)
        self.lr_schedule = make_lr_schedule(
            config["scheduler"], config["optimizer"], self.num_iters, self.steps_per_epoch
        )

        self.generators = {
            name: torch.Generator(device=self.device).manual_seed(
                _draws_seed(self.seed, 0) if name == "draws" else _stream_seed(self.seed, i)
            )
            for i, name in enumerate(("init", "perm", "draws", "aux"))
        }
        self._init_model()
        # each ray's latest predicted radiance in its own band: the full
        # render, its surface part and its atmosphere part (columns; the
        # parts stay 0 for NeRF), for the epoch's PSNR/SSIM and RGB image
        self.progress_pixels = torch.zeros(
            (self.num_rays, len(_PROGRESS_MAPS)), dtype=torch.float32, device=self.device
        )
        occ_cfg = getattr(pipeline, "occ_cfg", None)
        self.aux_update_every = int(occ_cfg.update_every) if occ_cfg is not None else 0
        self.epoch_idx = 0
        self.iter_count = 0
        self.last_loss: torch.Tensor | None = None
        # set here (not in iterate()) so a SIGTERM that lands before the
        # first step is kept
        self._preempted = False

        now = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.tensorboard_dir = Path(data_root) / "tensorboard" / f"{exp_name}_{now}"
        # rank 0 of a process group (until shard() names the mesh's first)
        self.is_main = pmesh.is_first_rank(None)
        self.logger = _ScalarLogger(self.tensorboard_dir) if self.is_main else _NullLogger()
        self._print = print if self.is_main else _quiet
        # per-epoch saves overlap the next epoch; iterate() waits for the
        # last one before it returns
        self.checkpointer = ckpt.AsyncCheckpointManager()

    @property
    def pred_pixels(self) -> torch.Tensor:
        """Each ray's latest predicted radiance (a view of
        ``progress_pixels``)."""
        return self.progress_pixels[:, 0]

    def _init_model(self) -> None:
        """Draw the parameters from the init stream, reset the occupancy
        grid, and build a fresh optimizer (moments and step count at 0)."""
        self.pipeline.init_params(self.generators["init"])
        self.pipeline.init_aux()
        self.optimizer = self.pipeline.make_optimizer(
            self.config["optimizer"], self.lr_schedule
        )

    @staticmethod
    def _normalize_micro(micro: int | None, batch_size: int, n_data: int = 1) -> int | None:
        """Fit a configured micro-batch size to the (possibly clamped) batch
        size: the loop needs ``batch_size % micro == 0`` and, under a mesh,
        equal micro-batches on every data index (``micro % n_data == 0``).
        A config tuned for a full-size granule must not crash on a small
        one, so shrink to the largest valid divisor (or disable) with a
        warning instead."""
        if not micro:
            return None
        if micro >= batch_size:
            if micro > batch_size:
                warnings.warn(
                    f"micro_batch_size {micro} >= batch_size {batch_size}; "
                    "micro-batching disabled."
                )
            return None
        if batch_size % micro == 0 and micro % n_data == 0:
            return micro
        fitted = next(
            (d for d in range(micro, 0, -1) if batch_size % d == 0 and d % n_data == 0), None
        )
        if fitted is None or fitted == batch_size:
            warnings.warn(
                f"micro_batch_size {micro} has no valid divisor of batch_size {batch_size} "
                f"on {n_data} data shards; micro-batching disabled."
            )
            return None
        warnings.warn(
            f"micro_batch_size {micro} does not divide batch_size {batch_size} into whole "
            f"{n_data}-shard micro-batches; shrinking to {fitted}."
        )
        return fitted

    @property
    def sample_sharded(self) -> bool:
        return self.axes is not None and self.axes.sample.size > 1

    def shard(self, mesh) -> None:
        """Train on a (data, sample) mesh (``parallel/mesh.py``), one process
        per device, every rank of the mesh calling it: this rank keeps its
        data index's rows of the ray set, the batch is split over "data"
        (trimmed to a multiple of it, the micro-batch refitted), the
        parameters, moments and occupancy grid are the mesh's first rank's,
        and the draws stream is seeded by the data index. With a "sample"
        axis over 1 (Instant-NGP only) the step runs
        ``parallel/train.py::ngp_forward_sample_sharded``; otherwise the
        pipeline's own forward on the rank's rows. The gradients are
        all-reduced before the clip."""
        from atmonr_tpu_torch.parallel.data import host_ray_slice, shard_rays_from_hosts
        from atmonr_tpu_torch.parallel.sharding import replicate
        from atmonr_tpu_torch.parallel.train import sample_sharded_samples

        if not pmesh.in_mesh(mesh):
            raise ValueError("this rank is not in the mesh")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a Trainer on {self.device}")
        if self.check_numerics:
            raise ValueError(
                "check_numerics is single-device only, as in the JAX package: train "
                "without a mesh (one device per granule) to localize the NaN, or drop "
                "--check-numerics to train sharded"
            )
        shape = pmesh.mesh_shape(mesh)
        n_data, ns = shape["data"], shape["sample"]
        if ns > 1:
            if "num_samples_per_ray" not in self.pipeline.config:
                raise ValueError(
                    "a 'sample' mesh axis > 1 requires the Instant-NGP pipeline "
                    "(hierarchical NeRF resamples adaptively; shard its rays over "
                    "'data' instead)"
                )
            n_samples = sample_sharded_samples(self.pipeline)
            if n_samples % ns:
                raise ValueError(
                    f"samples per ray ({n_samples}) must divide the mesh 'sample' axis ({ns})"
                )
        self.mesh, self.axes = mesh, pmesh.mesh_axes(mesh)
        host = self.dataset.host_rays()
        n_total = host["origin"].shape[0]
        sl = host_ray_slice(n_total, mesh)
        self.rays = shard_rays_from_hosts(
            {k: v[sl] for k, v in host.items()}, n_total, mesh, self.device
        )
        self.rank_rays = sl.stop - sl.start
        self.num_rays = self.rank_rays * n_data
        # trimming to a mesh multiple can drop below a dataset-clamped batch
        self.batch_size = min(self.batch_size, self.num_rays)
        self.batch_size -= self.batch_size % n_data
        if self.batch_size <= 0:
            raise ValueError(f"{self.num_rays} rays give no batch on {n_data} data shards")
        self.rank_batch = self.batch_size // n_data
        self.micro_batch = self._normalize_micro(self.micro_batch, self.batch_size, n_data)
        self.steps_per_epoch = max(1, self.num_rays // self.batch_size)
        self.num_epochs = -(-self.num_iters // self.steps_per_epoch)
        self.progress_pixels = torch.zeros(
            (self.rank_rays, len(_PROGRESS_MAPS)), dtype=torch.float32, device=self.device
        )
        self.generators["draws"].manual_seed(_draws_seed(self.seed, self.axes.data.index))
        replicate(self._replicated_tensors(), mesh)

        main = pmesh.is_first_rank(mesh)
        if main and not self.is_main:
            self.logger = _ScalarLogger(self.tensorboard_dir)
        elif self.is_main and not main:
            self.logger.close()
            self.logger = _NullLogger()
        self.is_main = main
        self._print = print if main else _quiet

    def _replicated_tensors(self) -> list[torch.Tensor]:
        """The tensors every rank must hold equal: the pipeline's
        parameters and buffers and the optimizer's moments."""
        tensors = list(self.pipeline.state_dict().values())
        for state in self.optimizer.adamw.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v) and v.device == self.device]
        return tensors

    def place(self, device) -> None:
        """Move this trainer (rays, parameters, occupancy grid, moments,
        random streams) to ``device`` without a mesh: one granule of a
        multi-granule run in one process. Between devices of one type; the
        streams go on from where they were."""
        dev = resolve_device(device)
        if dev.type != self.device.type:
            raise ValueError(f"place moves between devices of one type: {self.device} -> {dev}")
        if self.mesh is not None:
            raise ValueError("place is for a Trainer without a mesh")
        self.pipeline.to(dev)
        self.pipeline.device = dev
        self.optimizer.load_state_dict(self.optimizer.state_dict())  # moments to dev
        self.rays = {k: v.to(dev) for k, v in self.rays.items()}
        self.progress_pixels = self.progress_pixels.to(dev)
        for name, g in self.generators.items():
            moved = torch.Generator(device=dev)
            moved.set_state(g.get_state())
            self.generators[name] = moved
        self.device = dev

    # -- one step --------------------------------------------------------------

    def step(
        self,
        idx: torch.Tensor,
        draws: Mapping[str, torch.Tensor] | Sequence[Mapping[str, torch.Tensor]] | None = None,
        aux_jitter: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One training step on the rays ``idx``; returns the loss (a 0-d
        tensor on the device, detached). Every ``update_every`` steps it
        ends with an occupancy refresh.

        ``draws`` (one dict of ``make_draws``, or one per micro-batch) and
        ``aux_jitter`` replace the Trainer's own random streams; by default
        they come from the ``draws`` and ``aux`` generators."""
        with spans.span("trainer.step", count=len(idx), step=self.iter_count + 1):
            return self._step(idx, draws, aux_jitter)

    def _step(self, idx, draws, aux_jitter) -> torch.Tensor:
        """The body of ``step``, inside its span."""
        pipe = self.pipeline
        with spans.span("trainer.batch"):
            batch = batching.gather_batch(self.rays, idx)
        n_data = self.axes.data.size if self.axes is not None else 1
        micro = self.micro_batch // n_data if self.micro_batch else self.rank_batch
        n_micro = idx.shape[0] // micro if self.micro_batch else 1
        if draws is None or isinstance(draws, Mapping):
            draws = [draws] * n_micro
        if len(draws) != n_micro:
            raise ValueError(f"{len(draws)} sets of draws for {n_micro} micro-batches")

        self.optimizer.zero_grad()
        losses = []
        for i in range(n_micro):
            mbatch = (
                batch
                if n_micro == 1
                else {k: v[i * micro : (i + 1) * micro] for k, v in batch.items()}
            )
            mdraws = draws[i]
            if mdraws is None:
                with spans.span("trainer.batch"):
                    mdraws = self._make_draws(mbatch["idx"].shape[0])
            with spans.span("pipeline.forward"):
                results = self._forward(mbatch, mdraws)
            # this rank's share of the mean over the micro-batches and the
            # data indices; the shares' gradients accumulate in .grad
            with spans.span("pipeline.loss"):
                loss = pipe.compute_loss(mbatch, results)
                if n_data > 1:
                    loss = loss / n_data
            with spans.span("trainer.backward"):
                (loss / n_micro).backward()
            losses.append(loss.detach())
            if self.progress:
                with spans.span("trainer.progress"):
                    self._scatter_progress(mbatch, results)
        loss = losses[0] if n_micro == 1 else torch.mean(torch.stack(losses))
        if self.mesh is not None:
            from atmonr_tpu_torch.parallel.train import reduce_gradients

            loss = reduce_gradients(list(pipe.named_parameters()), self.axes, loss)
        if self.check_numerics:
            self._raise_if_not_finite(loss)
        self.optimizer.step()
        self.iter_count += 1
        self.last_loss = loss
        if self.aux_update_every and self.iter_count % self.aux_update_every == 0:
            if aux_jitter is not None:
                pipe.update_aux(jitter=aux_jitter)
            else:
                pipe.update_aux(generator=self.generators["aux"])
        return loss

    def _make_draws(self, batch_size: int) -> dict[str, torch.Tensor]:
        if self.sample_sharded:
            from atmonr_tpu_torch.parallel.train import sample_sharded_draws

            return sample_sharded_draws(self.pipeline, batch_size, self.generators["draws"])
        return self.pipeline.make_draws(batch_size, self.generators["draws"])

    def _forward(self, batch, draws) -> dict[str, torch.Tensor]:
        if self.sample_sharded:
            from atmonr_tpu_torch.parallel.train import ngp_forward_sample_sharded

            return ngp_forward_sample_sharded(self.pipeline, batch, self.axes, draws)
        return self.pipeline(batch, draws=draws)

    @torch.no_grad()
    def _scatter_progress(self, batch, results) -> None:
        """The batch's predictions in their own bands into
        ``progress_pixels``: the three color maps stacked, then one gather
        and one index write."""
        irgb = batch["irgb_idx"].long()
        if _PROGRESS_MAPS[1] not in results:  # NeRF: no surface/atmosphere split
            pred = torch.gather(results[_PROGRESS_MAPS[0]], 1, irgb[:, None])[:, 0]
            self.progress_pixels[batch["idx"], 0] = pred.float()
            return
        maps = torch.stack([results[k] for k in _PROGRESS_MAPS], dim=-1)
        pred = torch.gather(maps, 1, irgb[:, None, None].expand(-1, 1, maps.shape[-1]))[:, 0]
        self.progress_pixels[batch["idx"]] = pred.float()

    def _raise_if_not_finite(self, loss: torch.Tensor) -> None:
        """``check_numerics``: one host synchronisation per step."""
        step = self.iter_count + 1
        if not bool(torch.isfinite(loss)):
            raise FloatingPointError(f"non-finite loss {float(loss)} at step {step}")
        for name, p in self.pipeline.named_parameters():
            if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
                raise FloatingPointError(f"non-finite gradient of {name} at step {step}")

    # -- the epoch loop ----------------------------------------------------------

    def _log_loss_block(self, step: int, mean: _LaggedScalar) -> None:
        """Emit one print block's mean loss (scalar log + console line),
        from the copy enqueued at the block's end."""
        mean_loss = mean.get()
        self.logger.scalar("Loss", mean_loss, step)
        line = f"{step}/{self.num_iters} | Loss: {mean_loss:.5f}"
        self._print(line + max(0, self._last_len - len(line)) * " ", end="\r")
        self._last_len = len(line)

    def check_restart(self, running: list[torch.Tensor]) -> bool:
        """The ``restart_on_plateau`` guard, after a step: ``check_iter``
        steps after the run's (re)start, a mean of the last 5 losses of
        ``running`` above ``loss_threshold`` re-draws the init, at most
        ``max_restarts`` times. Returns whether it did. It fetches the loss
        at that step only."""
        rop = self.restart_on_plateau
        if (
            rop is None
            or self._restarts >= rop["max_restarts"]
            or self.iter_count - self._restart_base != rop["check_iter"]
        ):
            return False
        recent = float(torch.mean(torch.stack(running[-5:])))
        if not recent > rop["loss_threshold"]:
            # a healthy run stays healthy (the collapse is an init
            # phenomenon); stop checking
            self._restarts = rop["max_restarts"]
            return False
        self._reinit_for_restart(recent)
        self._restart_base = self.iter_count
        return True

    def _reinit_for_restart(self, recent_loss: float) -> None:
        """Re-draw the init after a detected collapse. The iteration budget
        keeps counting: a restart costs the iterations already spent."""
        self._restarts += 1
        self._print(
            f"\n[restart {self._restarts}] loss {recent_loss:.3f} still above "
            f"{self.restart_on_plateau['loss_threshold']:g} at iter "
            f"{self.iter_count}; re-drawing the init"
        )
        self.generators["init"].manual_seed(_stream_seed(self.seed, 0, self._restarts))
        self._init_model()
        if self.mesh is not None:
            from atmonr_tpu_torch.parallel.sharding import replicate

            replicate(self._replicated_tensors(), self.mesh)

    def install_preemption_handler(self) -> None:
        """On SIGTERM finish the step in flight, write a checkpoint and
        return from ``train``, so that ``--resume`` carries on from there."""

        def _on_sigterm(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, _on_sigterm)

    def train(self, output_path: str | Path, profile: bool = False) -> None:
        for _ in self.iterate(output_path, profile):
            pass

    def iterate(self, output_path: str | Path, profile: bool = False):
        """The training loop as a generator that yields the iteration count
        after every step; ``train()`` drains it."""
        output_path = Path(output_path)
        output_path.mkdir(parents=True, exist_ok=True)
        running: list[torch.Tensor] = []
        # loss logging lags one print block, so no step waits on a fetch
        prev_block: tuple[int, _LaggedScalar] | None = None
        self._last_len = 0
        profiling = contextlib.ExitStack()
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profiling.enter_context(torch_profile(activities=activities))
            # the steps' spans, as ranges over their kernels in the trace
            profiling.enter_context(spans.recording())

        with profiling:  # a loop left early stops the profiler too
            while self.iter_count < self.num_iters:
                # this rank's rows (all rows without a mesh), permuted
                perm = batching.epoch_permutation(
                    self.generators["perm"], self.rank_rays, self.rank_batch
                )
                for i in range(self.steps_per_epoch):
                    loss = self.step(perm[i * self.rank_batch : (i + 1) * self.rank_batch])
                    # exactly the last print_frequency losses, so each block
                    # mean averages its own block only
                    running = (running + [loss])[-self.print_frequency :]
                    self.check_restart(running)
                    yield self.iter_count
                    if self.iter_count % self.print_frequency == 0:
                        if prev_block is not None:
                            self._log_loss_block(*prev_block)
                        prev_block = (
                            self.iter_count,
                            _LaggedScalar(torch.mean(torch.stack(running))),
                        )
                    if self.iter_count >= self.num_iters or self._preempted:
                        break

                if prev_block is not None:  # the epoch's end syncs anyway; flush
                    self._log_loss_block(*prev_block)
                    prev_block = None
                self.epoch_idx += 1
                self._end_of_epoch(self._last_len)
                self._last_len = 0
                self.save(output_path, self.epoch_idx)
                if prof is not None:
                    profiling.close()
                    prof.export_chrome_trace(str(self.tensorboard_dir / "trace.json"))
                    prof = None
                if self._preempted:
                    self._print(
                        f"\npreempted: checkpoint epoch {self.epoch_idx} saved, "
                        "resume with --resume"
                    )
                    break
        self._wait_checkpoint()  # the last epoch's save must have landed
        self.logger.flush()
        self._print()

    def _end_of_epoch(self, last_len: int = 0) -> None:
        line = f"Epoch {self.epoch_idx}/{self.num_epochs}"
        # every rank of a mesh gathers; the first scores and logs
        pixels = self._host_progress() if self.progress else None
        if pixels is not None and self.is_main:
            ds = self.dataset
            pred_img = ds.scatter_image(pixels[:, 0])
            metrics = image_metrics(pred_img, ds.target_image(), ds.max_i)
            for name, val in metrics.items():
                if isinstance(val, list):
                    continue
                line += f" | {name}: {val:.3f}"
                self.logger.scalar(name, val, self.epoch_idx)
            self.logger.image(f"Epoch {self.epoch_idx}", self.epoch_image(pixels), self.epoch_idx)
        self._print(line + max(0, last_len - len(line)) * " ")
        self.logger.flush()

    def _host_progress(self) -> np.ndarray:
        """``progress_pixels`` of every ray on the host, (num rays of the
        dataset, 3): under a mesh, the data indices' rows gathered in order
        (a collective: every rank of the mesh calls it), the trimmed rows
        zero."""
        if self.mesh is None:
            return self.progress_pixels.cpu().numpy()
        from atmonr_tpu_torch.parallel.sharding import all_gather

        rows = all_gather(self.progress_pixels, self.axes.data, False)
        pixels = np.zeros((len(self.dataset), len(_PROGRESS_MAPS)), np.float32)
        pixels[: self.num_rays] = rows.reshape(-1, len(_PROGRESS_MAPS)).cpu().numpy()
        return pixels

    def epoch_image(self, pixels: np.ndarray | None = None) -> np.ndarray:
        """The side-by-side RGB comparison, surface | atmosphere | full |
        target, each the dataset's RGB view in [0, 1]: an (H, 4 W, 3) array.
        ``pixels`` is ``progress_pixels`` on the host, fetched if not given."""
        ds = self.dataset
        if pixels is None:
            pixels = self._host_progress()
        cubes = [ds.scatter_image(pixels[:, i]) for i in (1, 2, 0)] + [ds.target_image()]
        return np.concatenate([ds.get_rgb(c.transpose(2, 0, 1)) for c in cubes], axis=1)

    # -- checkpointing -------------------------------------------------------------

    def checkpoint_state(self) -> dict[str, Any]:
        """What a checkpoint holds: live tensors (state dicts), not copies.
        Under a mesh also every data index's draws stream (a collective:
        every rank of the mesh calls it)."""
        state = {
            # parameters and the occupancy grid
            "pipeline": self.pipeline.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generators": {k: g.get_state() for k, g in self.generators.items()},
            "epoch_idx": self.epoch_idx,
            "iter_count": self.iter_count,
            "restarts": self._restarts,
            "restart_base": self._restart_base,
            "tensorboard_dir": str(self.tensorboard_dir),
        }
        if self.mesh is not None:
            import torch.distributed as dist

            data = self.axes.data
            draws = [None] * data.size
            own = self.generators["draws"].get_state()
            if data.group is None:
                draws[0] = own
            else:
                dist.all_gather_object(draws, own, group=data.group)
            state["draws_by_data_index"] = draws
        return state

    def save(self, output_path: str | Path, epoch: int) -> None:
        """Save a checkpoint asynchronously (``checkpointer.wait()`` blocks
        until it has landed); under a mesh the first rank writes."""
        state = self.checkpoint_state()
        if self.is_main:
            self.checkpointer.save(output_path, epoch, state)

    def _wait_checkpoint(self) -> None:
        """Wait for the save in flight; under a mesh, then for every rank
        of the mesh, so that none reads a checkpoint before it is on disk."""
        self.checkpointer.wait()
        if self.mesh is not None:
            pmesh.mesh_barrier(self.mesh)

    def load(self, output_path: str | Path) -> None:
        """Restore the latest checkpoint under ``output_path`` (after any
        save in flight has landed: it may be the latest). Under a mesh every
        rank reads it and takes its data index's draws stream, where the
        checkpoint has one for each (a checkpoint of an unsharded run holds
        index 0's alone; the other indices then keep their own)."""
        self._wait_checkpoint()
        state, _ = ckpt.restore_checkpoint(output_path)
        self.pipeline.load_state_dict(state["pipeline"])
        self.optimizer.load_state_dict(state["optimizer"])
        for k, g in self.generators.items():
            g.set_state(state["generators"][k])
        if self.mesh is not None:
            data = self.axes.data
            by_index = state.get("draws_by_data_index")
            if by_index is not None:
                if len(by_index) != data.size:
                    raise ValueError(
                        f"the checkpoint holds draws for {len(by_index)} data indices, "
                        f"the mesh has {data.size}"
                    )
                self.generators["draws"].set_state(by_index[data.index])
            elif data.index:
                self.generators["draws"].manual_seed(_draws_seed(self.seed, data.index))
        self.epoch_idx = int(state["epoch_idx"])
        self.iter_count = int(state["iter_count"])
        self._restarts = int(state["restarts"])
        self._restart_base = int(state["restart_base"])
        self.logger.close()
        self.tensorboard_dir = Path(state["tensorboard_dir"])
        self.logger = _ScalarLogger(self.tensorboard_dir) if self.is_main else _NullLogger()
