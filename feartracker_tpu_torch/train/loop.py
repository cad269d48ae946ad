"""Config-driven training loop on one device, the counterpart of
``feartracker_tpu/train/loop.py`` call for call: epochs of the train step
with per-step metric logging and best/worst-batch mosaics, online-tracking
validation over real sequences (the sequential ``FEARTracker``, or
``ScanTracker`` with ``val_batched``: K1 and K2 run there), plateau LR,
early stopping, top-k checkpoints, resume from ``last``, per-epoch dataset
resampling and the dynamic frame-offset curriculum. ``resume`` also goes on
from an experiment folder that the JAX ``Trainer`` wrote: its Orbax
``last/state`` gives the weights, the optimizer's state, the step and the
injected learning rate, and ``last/meta.json`` the epoch
(``train/checkpoint.py``).

Where PyTorch's idiom differs:

* ``platform`` picks the device: ``""`` (the JAX package's ``tpu.yaml``)
  or ``gpu`` is the card, ``cpu`` the host; there is no fallback, so the
  card without one raises. ``precision: bfloat16`` trains in mixed
  precision (``make_train_step(dtype=torch.bfloat16)``).
* Data parallelism is one process a card (launched by ``torchrun``, or by
  hand with ``distributed.coordinator_address`` / ``num_processes`` /
  ``process_id``), joined by ``torch.distributed`` when
  ``distributed.enabled`` is set or ``num_devices`` > 1. The process drives
  card ``LOCAL_RANK`` (else its rank modulo the cards it sees). The global
  batch keeps JAX's meaning, ``batch_size`` × hosts: each process draws
  ``batch_size // processes on its host`` from its own shard of the data.
  The step averages gradients, losses and BatchNorm statistics over the
  group; validation tracks a rank-strided share of the sequences and
  gathers the rows; rank 0 alone writes the event log and checkpoints. The
  best/worst mosaics see the rank's own rows (JAX's single-process
  ``tpu_dp`` sees the global batch).
* Only the step's keys go to the device (``prefetch_to_device``); dataset
  names stay on the host, as ids that ride the batch's copy. The step's five
  scalars and the learning rate come back in one read a step.
* The validation trackers run float32 copies of the trained model
  (``ScanTracker`` deep-copies it) under TF32 off, restoring the caller's
  flags, so the mixed-precision step after them is unchanged.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from feartracker_tpu_torch.convert.load import load_fear_net, load_variables, transfer_variables, variables_of
from feartracker_tpu_torch.core import box_coder as bc
from feartracker_tpu_torch.core.geometry_np import bbox_iou
from feartracker_tpu_torch.data.dataset import ConcatDataset, get_training_datasets, read_img
from feartracker_tpu_torch.data.device_augs import STAGED_SEARCH_BBOX_KEY, STAGED_SEARCH_KEY, DeviceAugConfig
from feartracker_tpu_torch.data.loader import BatchLoader, prefetch_to_device
from feartracker_tpu_torch.data.sequence import get_sequence_datasets
from feartracker_tpu_torch.models.fbnet import TRUNKS
from feartracker_tpu_torch.models.blocks import set_sync_bn
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.parallel import multihost
from feartracker_tpu_torch.parallel.mesh import local_batch_size
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.tracker import FEARTracker
from feartracker_tpu_torch.train.callbacks import BestWorstMiner, EarlyStopping
from feartracker_tpu_torch.train.checkpoint import CheckpointManager
from feartracker_tpu_torch.train.metrics import DatasetAwareSums
from feartracker_tpu_torch.train.optim import PlateauScheduler, build_optimizer, get_learning_rate, set_learning_rate
from feartracker_tpu_torch.train.step import _device, create_train_state, make_train_step
from feartracker_tpu_torch.utils import constants as C
from feartracker_tpu_torch.utils.logging import create_logger

logger = create_logger(__name__)

_DEVICE_KEYS = (
    C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY,
    C.TRACKER_TARGET_SEARCH_IMAGE_KEY,
    C.TARGET_CLASSIFICATION_KEY,
    C.TARGET_REGRESSION_LABEL_KEY,
    C.TARGET_REGRESSION_WEIGHT_KEY,
    C.TRACKER_TARGET_BBOX_KEY,
    C.TARGET_VISIBILITY_KEY,
    C.TRACKER_TARGET_AUX_IMAGE_KEY,
    STAGED_SEARCH_KEY,  # device-augs staged batch (data/device_augs.py)
    STAGED_SEARCH_BBOX_KEY,
)
_IDS_KEY = "DATASET_ID"  # the batch's dataset names as ids, copied with the batch
_SCALARS = ("loss", "cls_loss", "reg_loss", "box_iou", "failure_rate")
_MOSAIC_KEYS = (C.TRACKER_TARGET_TEMPLATE_IMAGE_KEY, C.TRACKER_TARGET_SEARCH_IMAGE_KEY,
                C.TRACKER_TARGET_BBOX_KEY, C.TARGET_VISIBILITY_KEY)


def platform_device(platform: Optional[str], index: Optional[int] = None) -> torch.device:
    """The device a config's ``platform`` names: ``""``/None or ``gpu`` the
    card (card ``index`` of several), ``cpu`` the host. The card without one
    raises."""
    if platform in ("", None, "gpu"):
        dev = _device("cuda")
        return dev if index is None else torch.device("cuda", index)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"platform {platform!r}: the port trains on 'gpu' (or '') or 'cpu'")


class _NullWriter:
    """The event log of a process other than rank 0: writes nothing."""

    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        # one process a card, joined into a process group (the reference's
        # DDP backends; JAX: one process a host over a global mesh)
        dist_cfg = config.get("distributed") or {}
        n_dev = int(config.get("num_devices", 1) or 0)
        if dist_cfg.get("enabled") or n_dev > 1:
            multihost.initialize(dist_cfg)
            if n_dev > 1 and n_dev != multihost.local_process_count():
                raise ValueError(f"num_devices {n_dev}: {multihost.local_process_count()} processes run on this "
                                 "host; launch one process a card (torchrun --nproc_per_node num_devices)")
        self.is_master = multihost.is_master()
        self.rank, self.world = multihost.process_index(), multihost.process_count()
        # the group's step, also for one process (then bit for bit the
        # no-group step's)
        self.mesh = multihost.process_group() if dist.is_initialized() else None
        self.sync_bn = bool(config.get("sync_bn", False)) and self.world > 1
        index = None
        if self.mesh is not None and config.get("platform") != "cpu":
            index = multihost.local_rank()
            index = self.rank % torch.cuda.device_count() if index is None else index
        self.device = platform_device(config.get("platform"), index)
        if index is not None:
            torch.cuda.set_device(self.device)

        self.dtype = {"bfloat16": torch.bfloat16, "float32": None}.get(str(config.get("precision", "float32")), None)
        model_cfg = config.get("model", {})
        tracker_cfg = config.get("tracker", {})
        self.model_kw = dict(
            trunk_blocks=TRUNKS[model_cfg.get("name", "fear_xs")],
            adjust_channels=int(model_cfg.get("adjust_channels", 256)),
            towernum=int(model_cfg.get("towernum", 2)),
            template_size=int(tracker_cfg.get("template_size", 128)),
        )

        opt_cfg = dict(config.get("optimizer", {}))
        sched_cfg = dict(config.get("scheduler", {}))
        opt_cfg.setdefault("warmup_steps", sched_cfg.get("warmup_steps", 0))
        # a trainer-level key, as the reference has it (trainer.py:59)
        opt_cfg.setdefault("gradient_clip_val", config.get("gradient_clip_val", 0.0))
        self.tx = build_optimizer(opt_cfg)
        self.plateau = PlateauScheduler(
            mode=sched_cfg.get("mode", config.get("metric_mode", "max")),
            factor=float(sched_cfg.get("factor", 0.5)),
            patience=int(sched_cfg.get("patience", 5)),
            min_lr=float(sched_cfg.get("min_lr", 1e-6)),
        )
        self.early_stopping = EarlyStopping(
            patience=int(config.get("early_stopping", 20)),
            mode=config.get("metric_mode", "max"),
        )
        self.miner = BestWorstMiner()
        self.tracker_config = TrackerConfig(
            **{k: v for k, v in tracker_cfg.items() if k in TrackerConfig._fields}
        )

        exp = config.get("experiment", {})
        self.exp_dir = os.path.join(exp.get("folder", "experiments"), exp.get("name", "FEAR"))
        os.makedirs(self.exp_dir, exist_ok=True)
        self.ckpt = CheckpointManager(
            os.path.join(self.exp_dir, config.get("checkpoint_dir", "checkpoints")),
            max_to_keep=int(config.get("save_top_k", 3)),
            metric_mode=config.get("metric_mode", "max"),
            optimizer=self.tx,  # maps a JAX run's Orbax state on resume
        )
        self._writer = None

        self.box_spec = bc.BoxCoderSpec(
            score_size=int(tracker_cfg.get("score_size", 16)),
            total_stride=int(tracker_cfg.get("total_stride", 16)),
            instance_size=int(tracker_cfg.get("instance_size", 256)),
        )
        # device augmentations: the random crop, colour, labels and normalize
        # run in the step; the loader emits staged uint8 crops only
        self.device_augs_cfg = None
        if config.get("device_augs", False):
            ds0 = (config.get("train", {}).get("datasets") or [{}])[0]
            sizes = ds0.get("sizes", {})
            self.device_augs_cfg = DeviceAugConfig(
                search_size=int(sizes.get("search_image_size", tracker_cfg.get("instance_size", 256))),
                scale=float(sizes.get("search_image_scale", 0.2)),
                shift=float(sizes.get("search_image_shift", 32)),
                grid_size=int(ds0.get("regression_weight_label_size", tracker_cfg.get("score_size", 16))),
                total_stride=int(tracker_cfg.get("total_stride", 16)),
            )

        self.train_step = make_train_step(
            self.tx,
            coeffs=config.get("loss", {}).get("coeffs"),
            spec=self.box_spec,
            mesh=self.mesh,
            dual_template=bool(config.get("dual_template", False)),
            device_augs=self.device_augs_cfg,
            aug_seed=int(config.get("seed", 0)),
            guard_non_finite=int(opt_cfg.get("skip_non_finite", 0)) > 0,
            dtype=self.dtype,
        )

        bs = config.get("batch_size", 32)
        # JAX's batch_size is a host's; its processes (one a card) split it
        self.batch_size = local_batch_size(int(bs["train"] if isinstance(bs, dict) else bs),
                                           multihost.local_process_count() if self.mesh is not None else 1)
        self.train_dataset: Optional[ConcatDataset] = None
        self.val_datasets: List[Any] = []
        self.state = None
        self.transfer_report: Optional[Dict[str, list]] = None
        # the last epoch's steps, wall seconds and seconds spent waiting for
        # the next batch (the loader and its copy to the device)
        self.epoch_timing: Dict[str, float] = {}

    # -- setup -------------------------------------------------------------

    @property
    def writer(self):
        if self._writer is None:
            if not self.is_master:
                # the other ranks compute the same metrics (their plateau
                # and early-stop decisions stay in step) but write nothing
                self._writer = _NullWriter()
            else:
                from feartracker_tpu_torch.train.summary import SummaryWriter

                self._writer = SummaryWriter(os.path.join(self.exp_dir, "logs"))
        return self._writer

    def setup_data(self) -> None:
        if self.config.get("dual_template", False):
            # dual-template training needs every dataset to emit the aux
            # template crop: a partial config must not make aux-less batches
            for ds_cfg in self.config.get("train", {}).get("datasets", []):
                ds_cfg["dynamic_template"] = True
        if self.device_augs_cfg is not None:
            # one DeviceAugConfig serves the whole (concatenated) batch, so
            # every dataset must agree on the geometry the augmentations use
            ref = self.device_augs_cfg
            for ds_cfg in self.config.get("train", {}).get("datasets", []):
                sizes = ds_cfg.get("sizes", {})
                got = (
                    int(sizes.get("search_image_size", ref.search_size)),
                    float(sizes.get("search_image_scale", ref.scale)),
                    float(sizes.get("search_image_shift", ref.shift)),
                    int(ds_cfg.get("regression_weight_label_size", ref.grid_size)),
                )
                want = (ref.search_size, ref.scale, ref.shift, ref.grid_size)
                if got != want:
                    raise ValueError(
                        f"device_augs requires identical aug geometry across train "
                        f"datasets; {ds_cfg.get('name', '?')!r} has {got}, expected {want}"
                    )
                ds_cfg["device_augs"] = True
        self.train_dataset = get_training_datasets(self.config, seed=self.config.get("seed", 0))
        self.val_datasets = get_sequence_datasets(self.config.get("val", {}).get("datasets", []))
        logger.info(
            "train samples: %d, val datasets: %s",
            len(self.train_dataset),
            [f"{d.name}({len(d)})" for d in self.val_datasets],
        )

    def setup_state(self, rng_seed: int = 0) -> None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            model = FEARNet(**self.model_kw)
        set_sync_bn(model, self.sync_bn)
        self.state = create_train_state(model, self.tx, device=self.device)
        # warm start from recovered weights (the reference's pretrained
        # backbone, config/model/fear.yaml:5)
        pretrained = self.config.get("model", {}).get("pretrained_weights")
        if not pretrained:
            return
        model_cfg = self.config.get("model", {})
        try:
            loaded = load_variables(
                pretrained,
                channels=int(model_cfg.get("adjust_channels", 256)),
                towernum=int(model_cfg.get("towernum", 2)),
            )
        except Exception as first_err:
            # the .mlmodel/.ckpt importers parse the SOURCE's structure; when
            # the target differs, retry at the source's own FEAR-XS shape and
            # let the transfer reconcile. The first error is logged: the real
            # cause must not be swallowed if the retry half-loads.
            logger.warning(
                "load_variables(%r) with target arch params failed (%s: %s); "
                "retrying with the source's natural FEAR-XS shape",
                pretrained, type(first_err).__name__, first_err,
            )
            loaded = load_variables(pretrained)
        # non-strict by-path, by-shape transfer: exact matches copy verbatim
        # (the fear_xs full start equals a strict load), the rest keeps init
        merged, report = transfer_variables(loaded, variables_of(self.state.model))
        if not report["transferred"]:
            raise ValueError(
                f"no weights transferred from {pretrained!r} — source is "
                f"incompatible with model.name={model_cfg.get('name', 'fear_xs')!r} "
                f"(skipped_shape={len(report['skipped_shape'])}, missing={len(report['missing'])})"
            )
        partial = report["skipped_shape"] or report["missing"] or report["unused"]
        if partial:
            logger.warning(
                "PARTIAL warm start from %s: %d leaves transferred, "
                "%d shape-mismatched (kept init: %s%s), %d missing, %d unused",
                pretrained,
                len(report["transferred"]),
                len(report["skipped_shape"]),
                ", ".join(report["skipped_shape"][:4]),
                "…" if len(report["skipped_shape"]) > 4 else "",
                len(report["missing"]),
                len(report["unused"]),
            )
        load_fear_net(self.state.model, merged)
        self.transfer_report = report
        logger.info("initialized from pretrained weights: %s (%s)", pretrained, "partial" if partial else "full")

    def _loader(self) -> BatchLoader:
        # one loader for the whole fit: its epoch counter drives the
        # per-epoch reshuffle (a fresh loader would replay one permutation);
        # each rank reads its disjoint shard (the reference's
        # DistributedSampler)
        if not hasattr(self, "_loader_cache"):
            self._loader_cache = BatchLoader(
                self.train_dataset,
                batch_size=self.batch_size,
                num_workers=int(self.config.get("num_workers", 2)),
                seed=int(self.config.get("seed", 0)),
                host_id=multihost.process_index(),
                num_hosts=multihost.process_count(),
            )
        return self._loader_cache

    # -- epochs ------------------------------------------------------------

    def _steps_per_epoch(self) -> int:
        n = len(self._loader())
        limit = self.config.get("train_percent")
        return max(1, min(n, int(limit))) if limit else n

    def _device_batches(self, name_to_id: Dict[str, int]) -> Iterator[Dict[str, Any]]:
        """The loader's batches with the step's keys only, the dataset names
        as ids, copied to the device ``device_prefetch`` batches ahead."""

        def view(batch):
            out = {k: batch[k] for k in _DEVICE_KEYS if k in batch}
            out[_IDS_KEY] = np.asarray([name_to_id.get(n, 0) for n in batch[C.DATASET_NAME_KEY]], np.int64)
            return out

        depth = int(self.config.get("device_prefetch", 2))
        return prefetch_to_device(map(view, self._loader()), self.device, depth)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        assert self.state is not None
        n_batches = self._steps_per_epoch()
        log_every = int(self.config.get("log_every_n_steps", 50))
        self.miner.reset()
        names = self._dataset_names()
        dataset_sums = DatasetAwareSums.zeros(len(names), device=self.device)
        sums: Dict[str, float] = {}
        count = 0
        wait = 0.0
        t0 = time.time()
        batches = self._device_batches({n: i for i, n in enumerate(names)})
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None or count >= n_batches:
                break
            ids = batch.pop(_IDS_KEY)
            self.state, out = self.train_step(self.state, batch)
            # the step's one read: five scalars and the learning rate
            read = torch.stack([out[k].float() for k in _SCALARS] + [self.state.opt_state["lr"].float()]).cpu()
            *values, lr = read.tolist()
            scalars = dict(zip(_SCALARS, values))
            for k, v in scalars.items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            dataset_sums = dataset_sums.update(ids, out["ious"], out["visibility"])
            if self.device_augs_cfg is None:
                # mosaics draw the step's inputs; with device augmentations
                # the final crops never exist on the host: no miner there
                self.miner.update(
                    scalars["loss"],
                    {k: batch[k].cpu().numpy() for k in _MOSAIC_KEYS},
                    {
                        C.TARGET_CLASSIFICATION_KEY: out["cls_map"].cpu().numpy(),
                        C.TARGET_REGRESSION_LABEL_KEY: out["reg_map"].cpu().numpy(),
                    },
                )
            step = self.state.step
            if step % log_every == 0:
                for k, v in scalars.items():
                    self.writer.add_scalar(f"train/{k}", v, step)
                self.writer.add_scalar("train/lr", lr, step)
                logger.info(
                    "epoch %d step %d loss %.4f box_iou %.3f (%.2f s/it)",
                    epoch, step, scalars["loss"], scalars["box_iou"], (time.time() - t0) / count,
                )
        batches.close()
        self.epoch_timing = {"steps": count, "wall_s": time.time() - t0, "wait_s": wait}

        epoch_means = {k: v / max(count, 1) for k, v in sums.items()}
        for k, v in dataset_sums.compute(names).items():
            self.writer.add_scalar(f"train/metrics/{k}", v, epoch)
        if self.miner.best_mosaic is not None:
            self.writer.add_image("train/best_batch", self.miner.best_mosaic, epoch, dataformats="HWC")
            self.writer.add_image("train/worst_batch", self.miner.worst_mosaic, epoch, dataformats="HWC")
        return epoch_means

    def _dataset_names(self) -> List[str]:
        if self.train_dataset is None:
            return ["dataset"]
        return [d.name for d in self.train_dataset.datasets]

    def validate(self, epoch: int) -> Dict[str, float]:
        """Online tracking over the val sequences with the trained weights:
        the mean IoU per sequence (+1-pixel IoU, frames below 0.01 failed);
        ``{}`` when nothing can be scored. ``val_batched`` tracks
        ``val_streams`` sequences together through ``ScanTracker``."""
        assert self.state is not None
        if not self.val_datasets:
            return {}
        if self.config.get("val_batched"):
            return self._validate_batched(epoch)
        if not hasattr(self, "_val_tracker"):
            self._val_tracker = FEARTracker(self.state.model, self.tracker_config, dtype=torch.float32,
                                            device=self.device)
        else:
            self._val_tracker.set_variables(self.state.model)
        tracker = self._val_tracker

        max_samples = int(self.config.get("max_val_samples", 200))
        val_percent = self.config.get("val_percent")
        iou_threshold = 0.01
        # several processes: each tracks a rank-strided share of the
        # sequences, and the gathered rows give every rank the same metrics
        rank, world = multihost.process_index(), multihost.process_count()
        local_rows: List[List[float]] = []  # (dataset index, sequence mean IoU, sequence failure rate)
        for d_idx, ds in enumerate(self.val_datasets):
            n_seq = len(ds)
            if val_percent:
                # at most val_percent sequences (at least 1); an empty
                # dataset stays empty
                n_seq = min(n_seq, max(1, int(val_percent)))
            for s in range(rank, n_seq, world):
                files, anno, _ = ds[s]
                tracker.initialize(read_img(files[0]), np.asarray(anno[0], int))
                n = min(max_samples, len(files), len(anno))
                ious, fails = [], []
                for i in range(1, n):
                    bbox = tracker.update(read_img(files[i]))["bbox"]
                    iou = bbox_iou(np.asarray(bbox), np.asarray(anno[i], int))
                    ious.append(iou)
                    fails.append(float(iou < iou_threshold))
                if ious:
                    local_rows.append([float(d_idx), float(np.mean(ious)), float(np.mean(fails))])

        table = multihost.allgather_rows(np.asarray(local_rows, np.float64).reshape(-1, 3))
        metrics: Dict[str, float] = {}
        if len(table):
            metrics["box_iou"] = float(np.mean(table[:, 1]))
            self.writer.add_scalar("valid/metrics/box_iou", metrics["box_iou"], epoch)
        for d_idx, ds in enumerate(self.val_datasets):
            sel = table[table[:, 0] == d_idx]
            if not len(sel):
                continue
            metrics[f"{ds.name}_box_iou"] = float(np.mean(sel[:, 1]))
            self.writer.add_scalar(f"valid/metrics/{ds.name}_box_iou", np.mean(sel[:, 1]), epoch)
            self.writer.add_scalar(f"valid/metrics/{ds.name}_failure_rate", np.mean(sel[:, 2]), epoch)
        return metrics

    def _validate_batched(self, epoch: int) -> Dict[str, float]:
        from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
        from feartracker_tpu_torch.tracker.runtime import ScanTracker

        if not hasattr(self, "_batched_val_tracker"):
            self._batched_val_tracker = ScanTracker(self.state.model, self.tracker_config, dtype=torch.float32,
                                                    device=self.device)
        else:
            self._batched_val_tracker.set_variables(self.state.model)

        streams = int(self.config.get("val_streams", 16))
        frame_hw = tuple(self.config.get("val_frame_hw", (360, 640)))
        max_samples = int(self.config.get("max_val_samples", 200))
        val_percent = self.config.get("val_percent")
        iou_threshold = 0.01
        rank, world = multihost.process_index(), multihost.process_count()
        metrics: Dict[str, float] = {}
        local_rows: List[List[float]] = []  # (dataset index, sequence mean, failure, precision@20px)
        for d_idx, ds in enumerate(self.val_datasets):
            res = batched_evaluate(
                self._batched_val_tracker, ds,
                streams=streams, frame_hw=frame_hw, max_frames=max_samples,
                max_sequences=int(val_percent) if val_percent else None,
                sequence_stride=(rank, world),
            )
            prec = res.get("per_sequence_precision_20px", {})
            local_rows += [
                [float(d_idx), float(np.mean(ov)),
                 float(np.mean(np.asarray(ov) < iou_threshold)),
                 float(prec.get(name, np.nan))]
                for name, ov in res["per_sequence"].items()
            ]
        # one collective for every dataset's rows
        table = multihost.allgather_rows(np.asarray(local_rows, np.float64).reshape(-1, 4))
        for d_idx, ds in enumerate(self.val_datasets):
            sel = table[table[:, 0] == d_idx]
            if not len(sel):
                continue
            metrics[f"{ds.name}_box_iou"] = float(np.mean(sel[:, 1]))
            self.writer.add_scalar(f"valid/metrics/{ds.name}_box_iou", metrics[f"{ds.name}_box_iou"], epoch)
            self.writer.add_scalar(f"valid/metrics/{ds.name}_failure_rate", float(np.mean(sel[:, 2])), epoch)
            if np.isfinite(sel[:, 3]).all():
                # the mean over per-sequence precision == the aggregate curve[20]
                metrics[f"{ds.name}_precision_20px"] = float(np.mean(sel[:, 3]))
                self.writer.add_scalar(
                    f"valid/metrics/{ds.name}_precision_20px", metrics[f"{ds.name}_precision_20px"], epoch,
                )
        if not len(table):
            # nothing scorable (a test split with init-only groundtruth):
            # {} as the sequential path gives, for fit's monitor=None branch
            return {}
        metrics["box_iou"] = float(np.mean(table[:, 1]))
        self.writer.add_scalar("valid/metrics/box_iou", metrics["box_iou"], epoch)
        return metrics

    def _update_frame_offset(self, epoch: int) -> None:
        """Dynamic frame-offset curriculum (ref: fear_lightning_model.py:266-284)."""
        params = self.config.get("dynamic_frame_offset")
        if not params or self.train_dataset is None:
            return
        if (epoch + 1) >= params["start_epoch"] and (epoch + 1) % params["freq"] == 0:
            for ds in self.train_dataset.datasets:
                old = ds.item_sampler.frame_offset
                ds.item_sampler.frame_offset = min(params["max_value"], old + params["step"])
                logger.info("%s frame_offset %d -> %d", ds.name, old, ds.item_sampler.frame_offset)

    # -- fit ---------------------------------------------------------------

    def fit(self) -> None:
        if self.train_dataset is None:
            self.setup_data()
        if self.state is None:
            self.setup_state(self.config.get("seed", 0))
        # resume the whole train state (weights, BatchNorm statistics,
        # optimizer, step) from the 'last' checkpoint when asked
        start_epoch = 0
        if self.config.get("resume", False):
            # a rank that cannot see the checkpoint would start fresh while
            # the others restore: their parameters would part. Fail instead.
            if not multihost.all_equal(int(self.ckpt.has_last())):
                raise RuntimeError("resume: checkpoint visibility differs across ranks; "
                                   "experiment.folder must be a shared filesystem")
            if self.ckpt.has_last():
                # a corrupt or incompatible checkpoint fails loudly
                self.state = self.ckpt.restore_last(self.state)
                # max_epochs is TOTAL epochs; the epoch comes from the
                # checkpoint's metadata: step // steps_per_epoch shifts it
                # when train_percent, the CSVs or the batch size changed
                meta = self.ckpt.load_meta()
                if meta is not None and "epoch" in meta:
                    start_epoch = int(meta["epoch"])
                else:
                    start_epoch = self.state.step // max(self._steps_per_epoch(), 1)
                    logger.warning(
                        "resume: checkpoint has no epoch metadata; deriving "
                        "epoch %d from step — incorrect if the dataset or "
                        "batch size changed since the crashed run",
                        start_epoch,
                    )
                logger.info("resumed from last checkpoint at step %d (epoch %d)", self.state.step, start_epoch)
                # replay the per-epoch dataset state (resample draws, the
                # curriculum) and the loader's shuffle counter
                for past in range(start_epoch):
                    self.train_dataset.resample()
                    self._update_frame_offset(past)
                self._loader().epoch = start_epoch
            else:
                logger.info("no checkpoint to resume at %s; starting fresh", self.ckpt.directory)
        self.resumed_epoch = start_epoch

        # sanity validation: a few real sequences before training, so that a
        # broken validation fails in seconds (ref: trainer.py:64)
        sanity = int(self.config.get("sanity_steps", 5))
        if sanity > 0 and self.val_datasets:
            saved = self.config.get("val_percent")
            self.config["val_percent"] = sanity
            logger.info("sanity check: %d val sequences", sanity)
            self.validate(epoch=-1)
            self.config["val_percent"] = saved

        max_epochs = int(self.config.get("max_epochs", 150))
        min_epochs = int(self.config.get("min_epochs", 0))
        val_every = int(self.config.get("check_val_every_n_epoch", 1))  # (ref: trainer.py:69)
        for epoch in range(start_epoch, max_epochs):
            train_metrics = self.train_epoch(epoch)
            val_metrics = self.validate(epoch) if (epoch + 1) % val_every == 0 else {}
            logger.info("epoch %d done: train %s valid %s (%s)", epoch, train_metrics, val_metrics,
                        ", ".join(f"{k} {v:.3f}" for k, v in self.epoch_timing.items()))

            # the monitor is val box_iou; train box_iou stands in only when
            # there is no val data at all: the two are incommensurable
            if val_metrics:
                monitor = val_metrics["box_iou"]
            elif not self.val_datasets:
                monitor = train_metrics.get("box_iou", 0.0)
            else:
                monitor = None

            if monitor is not None:
                lr = get_learning_rate(self.state.opt_state)
                new_lr = self.plateau.update(monitor, lr)
                if new_lr != lr:
                    logger.info("plateau: lr %.2e -> %.2e", lr, new_lr)
                    self.state.opt_state = set_learning_rate(self.state.opt_state, new_lr)
            # checkpoint ids are GLOBAL steps, so a resumed run never reuses
            # an id of the run before it; the ranks hold the same state, so
            # rank 0 alone writes it
            if self.is_master:
                self.ckpt.save(self.state.step, self.state, monitor, extra={"epoch": epoch + 1})

            if monitor is not None and self.early_stopping.update(monitor) and epoch + 1 >= min_epochs:
                logger.info("early stopping at epoch %d (best %.4f)", epoch, self.early_stopping.best)
                break
            self.train_dataset.resample()
            self._update_frame_offset(epoch)
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def train(config: Dict[str, Any]) -> Trainer:
    """(ref: model_training/train.py:17-22)"""
    trainer = Trainer(config)
    trainer.fit()
    return trainer
