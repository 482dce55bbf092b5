"""Batch loading: a torch DataLoader with the JAX loader's batch semantics.

Port of face_mask_inpaint_tpu/data/loader.py. Items (dicts of numpy arrays)
stack into dicts of tensors. With ``pad_last`` a short final batch is padded
to ``batch_size`` by repeating its last item, and ``_valid`` (1 for real
rows, 0 for padding) is added, so every batch has one shape.
``split_dataset`` draws the JAX package's train/val split (the same numpy
permutation), and ``get_reference_dataloader`` builds the trainer's two
loaders over it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["DataLoader", "split_dataset", "get_reference_dataloader"]


def split_dataset(n: int, val_amount: float, seed: int = 0):
    """Deterministic random train/val index split: n_train = floor(n (1 -
    val)), the reference's torch.random_split sizes (dataloader.py:38-41),
    drawn with the JAX package's numpy permutation."""
    n_train = math.floor(n * (1 - val_amount))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[:n_train].tolist(), perm[n_train:].tolist()


class _Collate:
    """Stack items into tensors; pad a short batch when asked. A class (not a
    closure) so spawned workers can unpickle it."""

    def __init__(self, batch_size: int, pad_last: bool):
        self.batch_size, self.pad_last = batch_size, pad_last

    def __call__(self, items: list[dict]) -> dict:
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        if self.pad_last and len(items) < self.batch_size:
            pad = self.batch_size - len(items)
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in batch.items()}
            batch["_valid"] = np.asarray([1] * len(items) + [0] * pad, np.float32)
        return {k: torch.from_numpy(v) for k, v in batch.items()}


class DataLoader(torch.utils.data.DataLoader):
    """Batches of an indexable dataset of dict[str, ndarray].

    Worker processes (``num_workers > 0``) start with the ``spawn`` method;
    ``seed`` fixes the shuffle order.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0,
                 pad_last: bool = False, seed: int = 0, pin_memory: bool = False):
        super().__init__(
            dataset, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
            num_workers=num_workers, collate_fn=_Collate(batch_size, pad_last),
            pin_memory=pin_memory,
            generator=torch.Generator().manual_seed(seed) if shuffle else None,
            multiprocessing_context="spawn" if num_workers > 0 else None)


def get_reference_dataloader(dir_src_img, dir_ref_img, dir_mask, identity_file,
                             batch_size: int, apply_transform: bool = False,
                             val_amount: float = 0.1, num_workers: int = 0,
                             img_scale: float = 1.0, use_ssim: bool = False, device=None,
                             seed: int = 0, pin_memory: bool = False):
    """(train loader, val loader) over one ReferenceDataset
    (dataloader.py:19-46): the train split shuffled from ``seed``, the val
    split in order with drop_last. On one device a short last train batch
    is kept, as the reference keeps it."""
    from face_mask_inpaint_tpu_torch.data.dataset import ReferenceDataset

    dataset = ReferenceDataset(dir_src_img, dir_ref_img, dir_mask, identity_file,
                               apply_transform=apply_transform, scale=img_scale,
                               use_ssim=use_ssim, seed=seed, device=device)
    train_idx, val_idx = split_dataset(len(dataset), val_amount, seed)
    train_loader = DataLoader(torch.utils.data.Subset(dataset, train_idx), batch_size,
                              shuffle=True, num_workers=num_workers, seed=seed,
                              pin_memory=pin_memory)
    val_loader = DataLoader(torch.utils.data.Subset(dataset, val_idx), batch_size,
                            shuffle=False, drop_last=True, num_workers=num_workers,
                            pin_memory=pin_memory)
    return train_loader, val_loader
