"""Train the UNet mask detector (Stack C): the port of
``train_mask_detector.py`` with its flags and defaults.

    python -m face_mask_inpaint_tpu_torch.cli.train_mask_detector \\
        --dir_img <images_masked> --dir_mask <binary_map> [--device cuda]
    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m face_mask_inpaint_tpu_torch.cli.train_mask_detector ...

Cross-entropy plus multiclass Dice, Adam (train/unet.py); the split of
``--validation`` percent of the images, the train loader shuffled from
``--seed`` and the validation loader in order, both dropping a short last
batch; a validation Dice every n_train // (10 * batch) steps; the JAX
trainer's plateau tracker ('max' on the validation Dice, patience 2), which
is logged and, as in the JAX trainer, never reaches the optimizer; a
checkpoint ``unet_checkpoint_epoch<N>`` after every epoch and
``INTERRUPTED_checkpoint_epoch0`` on Ctrl-C, under ``--dir_checkpoint``, in
the port's own format (train/checkpoint.py: the model's state dict, Adam's
state and the step). Metrics go to ``<dir_checkpoint>/logs/metrics.jsonl``.

``--load`` takes one of those checkpoints (model, Adam and step), or a model
file through the CLIs' loader (convert.py): the port's own state dict, or a
reference ``mask_detector.pth``/``.pt`` converted with ``convert_unet``
(the model replaced, Adam fresh, as the JAX CLI does). A directory raises.

``--amp`` runs the model in bfloat16 over float32 parameters, as the JAX CLI
builds it (``dtype=bfloat16``). ``--device`` defaults to cuda and fails when
CUDA is absent; ``--device cpu`` runs on the CPU. ``--seed`` seeds the
weights and the shuffle.

Under ``torch.distributed.run`` the W ranks train data parallel, as the JAX
trainer does over its mesh (parallel/dist.py): the global batch is
``--batch-size`` rounded to ``max(b, W) // W * W``, each rank takes its
slice of it and the step computes the one-process step on the global batch
(BatchNorm's moments, the Dice's sums and the gradients over the ranks).
Every rank builds the weights from ``--seed`` and reads ``--load``; rank
0's are then broadcast. Only rank 0 validates, logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint
from face_mask_inpaint_tpu_torch.data.dataset import BasicDataset
from face_mask_inpaint_tpu_torch.data.loader import DataLoader, split_dataset
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_unet
from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt
from face_mask_inpaint_tpu_torch.train.optim import adam
from face_mask_inpaint_tpu_torch.train.unet import make_unet_eval_step, make_unet_train_step
from face_mask_inpaint_tpu_torch.utils.metrics_logger import MetricsLogger, NullLogger
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow, add_profile_args

__all__ = ["get_args", "build_model", "Trainer", "train_net", "main"]

DIR_IMG = Path("../CelebAHQ/images_masked")
DIR_MASK = Path("../CelebAHQ/binary_map")
DIR_CHECKPOINT = Path("./checkpoints256_mask_detector/")


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the UNet on images and target masks")
    parser.add_argument("--epochs", "-e", metavar="E", type=int, default=5,
                        help="Number of epochs")
    parser.add_argument("--batch-size", "-b", dest="batch_size", metavar="B",
                        type=int, default=1, help="Batch size")
    parser.add_argument("--learning-rate", "-l", metavar="LR", type=float,
                        default=0.00001, help="Learning rate", dest="lr")
    parser.add_argument("--load", "-f", type=str, default=False,
                        help="Load model from a checkpoint")
    parser.add_argument("--scale", "-s", type=float, default=1,
                        help="Downscaling factor of the images")
    parser.add_argument("--validation", "-v", dest="val", type=float, default=10.0,
                        help="Percent of the data that is used as validation (0-100)")
    parser.add_argument("--amp", action="store_true", default=False,
                        help="Use mixed precision (bf16 compute, f32 parameters)")
    parser.add_argument("--threshold", "-t", type=float, default=0.5,
                        help="Threshold for deciding mask")
    add_profile_args(parser)
    parser.add_argument("--dir_img", type=str, default=str(DIR_IMG))
    parser.add_argument("--dir_mask", type=str, default=str(DIR_MASK))
    parser.add_argument("--dir_checkpoint", type=str, default=str(DIR_CHECKPOINT))
    parser.add_argument("--use_wandb", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and the shuffle")
    return parser.parse_args(argv)


def build_model(args, device: torch.device) -> MaskDetector:
    """MaskDetector(3, bilinear) with weights from ``--seed``, bf16 compute
    with ``--amp``, on ``device``."""
    dtype = torch.bfloat16 if args.amp else torch.float32
    model = MaskDetector(n_channels=3, bilinear=True, dtype=dtype,
                         generator=torch.Generator().manual_seed(args.seed))
    return model.to(device)


class Trainer:
    """The model, Adam and the step: what a checkpoint holds. ``dist`` is
    this rank's data-parallel environment, or the device of a run on one rank."""

    def __init__(self, args, dist: pdist.DistEnv | torch.device):
        self.dist = dist if isinstance(dist, pdist.DistEnv) else pdist.DistEnv(dist)
        self.device = device = self.dist.device
        self.model = build_model(args, device)
        self.optimizer = adam(self.model.parameters(), args.lr)
        self.step = 0
        self.train_step = make_unet_train_step(self.model, self.optimizer, self.dist.group)
        self.eval_step = make_unet_eval_step(self.model)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "opt": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["opt"])
        self.step = int(state["step"])

    def load(self, path: str) -> None:
        """``--load``: a train state of this CLI, else a model file through
        the CLIs' loader (the port's own state dict or a reference one)."""
        state = read_checkpoint(path, "mask detector")
        if state is None:
            raise FileNotFoundError(f"--load {path}: no such file")
        if {f"model.{k}" for k in self.model.state_dict()} <= set(state):
            self.load_state_dict(ckpt.restore_state(path))
            logging.info("Model loaded from %s (train state, step %d)", path, self.step)
            return
        with torch.no_grad():
            load_checkpoint(self.model, state, convert_unet, "mask detector", path)
        logging.info("Model loaded from %s", path)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {"image": batch["image"].to(device, non_blocking=True),
            "mask": (batch["mask"] > 0).long().to(device, non_blocking=True)}


def make_loaders(args, rank: int = 0, world_size: int = 1):
    """(train loader, val loader, n_train, n_val) over BasicDataset with the
    JAX CLI's split (train_mask_detector.py:69-84); ``args.batch_size`` is
    the global batch, of which the train loader hands rank ``rank`` its
    slice."""
    dataset = BasicDataset(args.dir_img, args.dir_mask, args.scale)
    n_val = int(len(dataset) * args.val / 100)
    n_train = len(dataset) - n_val
    train_idx, val_idx = split_dataset(len(dataset), n_val / len(dataset))
    pin = str(args.device).startswith("cuda")
    train_loader = DataLoader(torch.utils.data.Subset(dataset, train_idx), args.batch_size,
                              shuffle=True, drop_last=True, seed=args.seed, pin_memory=pin,
                              rank=rank, world_size=world_size)
    val_loader = DataLoader(torch.utils.data.Subset(dataset, val_idx), args.batch_size,
                            shuffle=False, drop_last=True, pin_memory=pin)
    return train_loader, val_loader, n_train, n_val


def train_net(trainer: Trainer, args, save_checkpoint: bool = True) -> Trainer:
    dist = trainer.dist
    train_loader, val_loader, n_train, n_val = make_loaders(args, dist.rank, dist.world_size)
    logger = (MetricsLogger(Path(args.dir_checkpoint) / "logs", "Mask Detector",
                            config=vars(args), use_wandb=bool(args.use_wandb))
              if dist.is_main else NullLogger())
    logging.info("Starting training: epochs=%d batch=%d lr=%g train=%d val=%d scale=%g "
                 "device=%s amp=%s ranks=%d", args.epochs, args.batch_size, args.lr, n_train,
                 n_val, args.scale, trainer.device, args.amp, dist.world_size)

    def evaluate() -> float:
        scores = [float(trainer.eval_step(_to_device(b, trainer.device))["dice"])
                  for b in val_loader]
        return float(np.mean(scores)) if scores else 0.0

    profiler = ProfileWindow(args.profile_dir if dist.is_main else "", args.profile_steps)
    # the JAX CLI's plateau tracking ('max', patience 2): its scale is
    # logged as the learning rate and never reaches the optimizer
    # (train_mask_detector.py:127-146)
    best, patience_left, lr_scale = -1.0, 2, 1.0
    division_step = n_train // (10 * args.batch_size)
    try:
        for epoch in range(args.epochs):
            for batch in train_loader:
                profiler.tick(trainer.step)
                loss = float(trainer.train_step(_to_device(batch, trainer.device))["loss"])
                trainer.step += 1
                logger.log({"train loss": loss, "epoch": epoch}, step=trainer.step)
                if division_step > 0 and trainer.step % division_step == 0 and dist.is_main:
                    val_score = evaluate()
                    if val_score > best + 1e-4:
                        best, patience_left = val_score, 2
                    else:
                        patience_left -= 1
                        if patience_left < 0:
                            lr_scale *= 0.1
                            patience_left = 2
                    logging.info("Validation Dice score: %s", val_score)
                    logger.log({"validation Dice": val_score,
                                "learning rate": args.lr * lr_scale}, step=trainer.step)
            if save_checkpoint and dist.is_main:
                path = ckpt.save_state(args.dir_checkpoint, "unet", epoch + 1,
                                       trainer.state_dict())
                logging.info("Checkpoint %d saved to %s!", epoch + 1, path)
    except KeyboardInterrupt:
        if dist.is_main:
            ckpt.save_state(args.dir_checkpoint, "INTERRUPTED", 0, trainer.state_dict())
            logging.info("Saved interrupt")
        sys.exit(0)
    finally:
        profiler.close()
        logger.close()
    return trainer


def main(argv=None) -> Trainer:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    dist = pdist.init_from_env(args.device)
    try:
        if not dist.is_main:
            logging.getLogger().setLevel(logging.WARNING)
        args.batch_size = pdist.round_batch(args.batch_size, dist.world_size)
        logging.info("Using device %s", dist.device)
        if dist.is_main:
            Path(args.dir_checkpoint).mkdir(parents=True, exist_ok=True)
        trainer = Trainer(args, dist)
        logging.info("Network: 3 input channels, 2 output classes, bilinear upscaling")
        if args.load:
            trainer.load(args.load)
        pdist.agree([trainer.step], "the step loaded", dist.group)
        pdist.broadcast_module(trainer.model, dist.group)
        return train_net(trainer, args)
    finally:
        pdist.shutdown()


if __name__ == "__main__":
    main()
