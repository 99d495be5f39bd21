"""Training runtime: one step covering gather -> draws -> forward -> loss ->
backward -> clip -> AdamW -> progress-pixel scatter, the occupancy-grid
refresh on its cadence, and the host-side epoch loop for metrics, logging,
checkpointing and profiling. Counterpart of the JAX package's
``training/trainer.py``, on one device.

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
"""

from __future__ import annotations

import json
import signal
import warnings
from datetime import datetime
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from atmonr_tpu_torch.data import batching
from atmonr_tpu_torch.training import checkpoint as ckpt
from atmonr_tpu_torch.training.metrics import image_metrics
from atmonr_tpu_torch.training.schedules import make_lr_schedule
from atmonr_tpu_torch.utils.device import resolve_device

MULTI_DEVICE_NOT_PORTED = (
    "multi-device and multi-granule training are not ported yet "
    "(ROADMAP.md queue 1, 'Multi-device')"
)


class _ScalarLogger:
    """JSONL always; TensorBoard too when its writer can be imported."""

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

    def flush(self) -> None:
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


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
        # scatter of every step; "progress": false drops them and the epoch
        # PSNR/SSIM (loss logging and checkpoints are unaffected)
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

        self.rays = dataset.rays(self.device)
        self.num_rays = len(dataset)
        self.steps_per_epoch = max(1, self.num_rays // self.batch_size)
        self.num_epochs = -(-self.num_iters // self.steps_per_epoch)
        self.lr_schedule = make_lr_schedule(
            config["scheduler"], config["optimizer"], self.num_iters, self.steps_per_epoch
        )

        self.generators = {
            name: torch.Generator(device=self.device).manual_seed(_stream_seed(self.seed, i))
            for i, name in enumerate(("init", "perm", "draws", "aux"))
        }
        self._init_model()
        # each ray's latest predicted radiance, for the epoch's PSNR/SSIM (the
        # JAX package also keeps the surface and atmosphere parts, for its
        # TensorBoard imagery, which is not ported)
        self.pred_pixels = torch.zeros((self.num_rays,), dtype=torch.float32, device=self.device)
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
        self.logger = _ScalarLogger(self.tensorboard_dir)

    def _init_model(self) -> None:
        """Draw the parameters from the init stream, reset the occupancy
        grid, and build a fresh optimizer (moments and step count at 0)."""
        self.pipeline.init_params(self.generators["init"])
        self.pipeline.init_aux()
        self.optimizer = self.pipeline.make_optimizer(
            self.config["optimizer"], self.lr_schedule
        )

    @staticmethod
    def _normalize_micro(micro: int | None, batch_size: int) -> int | None:
        """Fit a configured micro-batch size to the (possibly clamped) batch
        size: the loop needs ``batch_size % micro == 0``. A config tuned for
        a full-size granule must not crash on a small one, so shrink to the
        largest divisor (or disable) with a warning instead."""
        if not micro:
            return None
        if micro >= batch_size:
            if micro > batch_size:
                warnings.warn(
                    f"micro_batch_size {micro} >= batch_size {batch_size}; "
                    "micro-batching disabled."
                )
            return None
        if batch_size % micro == 0:
            return micro
        fitted = next(d for d in range(micro, 0, -1) if batch_size % d == 0)
        warnings.warn(
            f"micro_batch_size {micro} does not divide batch_size {batch_size}; "
            f"shrinking to {fitted}."
        )
        return fitted

    def shard(self, mesh) -> None:
        raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)

    def place(self, device) -> None:
        raise NotImplementedError(MULTI_DEVICE_NOT_PORTED)

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
        pipe = self.pipeline
        batch = batching.gather_batch(self.rays, idx)
        micro = self.micro_batch or self.batch_size
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
                mdraws = pipe.make_draws(mbatch["idx"].shape[0], self.generators["draws"])
            results = pipe(mbatch, draws=mdraws)
            loss = pipe.compute_loss(mbatch, results)
            # the mean of the micro-batches' gradients accumulates in .grad
            (loss / n_micro).backward()
            losses.append(loss.detach())
            if self.progress:
                self._scatter_progress(mbatch, results)
        loss = losses[0] if n_micro == 1 else torch.mean(torch.stack(losses))
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

    @torch.no_grad()
    def _scatter_progress(self, batch, results) -> None:
        irgb = batch["irgb_idx"][:, None].long()
        pred = torch.gather(results["color_map_fine"], 1, irgb)[:, 0]
        self.pred_pixels[batch["idx"]] = pred.float()

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
        print(line + max(0, self._last_len - len(line)) * " ", end="\r")
        self._last_len = len(line)

    def _reinit_for_restart(self, recent_loss: float) -> None:
        """Re-draw the init after a detected collapse. The iteration budget
        keeps counting: a restart costs the iterations already spent."""
        self._restarts += 1
        print(
            f"\n[restart {self._restarts}] loss {recent_loss:.3f} still above "
            f"{self.restart_on_plateau['loss_threshold']:g} at iter "
            f"{self.iter_count}; re-drawing the init"
        )
        self.generators["init"].manual_seed(_stream_seed(self.seed, 0, self._restarts))
        self._init_model()

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
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = torch_profile(activities=activities)
            prof.start()
        rop = self.restart_on_plateau

        while self.iter_count < self.num_iters:
            perm = batching.epoch_permutation(
                self.generators["perm"], self.num_rays, self.batch_size
            )
            for i in range(self.steps_per_epoch):
                loss = self.step(perm[i * self.batch_size : (i + 1) * self.batch_size])
                # exactly the last print_frequency losses, so each block
                # mean averages its own block only
                running = (running + [loss])[-self.print_frequency :]
                if (
                    rop is not None
                    and self._restarts < rop["max_restarts"]
                    and self.iter_count - self._restart_base == rop["check_iter"]
                ):
                    recent = float(torch.mean(torch.stack(running[-5:])))
                    if recent > rop["loss_threshold"]:
                        self._reinit_for_restart(recent)
                        self._restart_base = self.iter_count
                    else:
                        # a healthy run stays healthy (the collapse is an
                        # init phenomenon); stop checking
                        self._restarts = rop["max_restarts"]
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
                prof.stop()
                prof.export_chrome_trace(str(self.tensorboard_dir / "trace.json"))
                prof = None
            if self._preempted:
                print(
                    f"\npreempted: checkpoint epoch {self.epoch_idx} saved, "
                    "resume with --resume"
                )
                break
        self.logger.flush()
        print()

    def _end_of_epoch(self, last_len: int = 0) -> None:
        line = f"Epoch {self.epoch_idx}/{self.num_epochs}"
        if self.progress:
            ds = self.dataset
            pred_img = ds.scatter_image(self.pred_pixels.cpu().numpy())
            metrics = image_metrics(pred_img, ds.target_image(), ds.max_i)
            for name, val in metrics.items():
                if isinstance(val, list):
                    continue
                line += f" | {name}: {val:.3f}"
                self.logger.scalar(name, val, self.epoch_idx)
        print(line + max(0, last_len - len(line)) * " ")
        self.logger.flush()

    # -- checkpointing -------------------------------------------------------------

    def save(self, output_path: str | Path, epoch: int) -> None:
        state: dict[str, Any] = {
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
        ckpt.save_checkpoint(output_path, epoch, state)

    def load(self, output_path: str | Path) -> None:
        """Restore the latest checkpoint under ``output_path``."""
        state, _ = ckpt.restore_checkpoint(output_path)
        self.pipeline.load_state_dict(state["pipeline"])
        self.optimizer.load_state_dict(state["optimizer"])
        for k, g in self.generators.items():
            g.set_state(state["generators"][k])
        self.epoch_idx = int(state["epoch_idx"])
        self.iter_count = int(state["iter_count"])
        self._restarts = int(state["restarts"])
        self._restart_base = int(state["restart_base"])
        self.logger.close()
        self.tensorboard_dir = Path(state["tensorboard_dir"])
        self.logger = _ScalarLogger(self.tensorboard_dir)
