"""CelebA / CelebA-HQ datasets.

Port of face_mask_inpaint_tpu/data/dataset.py: ``BasicDataset``, the
(image, mask) pairs of the mask-detector trainer (``<id>_surgical.jpg``
with ``<id><mask_suffix>.npy``), and ``ReferenceDataset``, with the same
on-disk conventions: image id = filename stem before '_', source
``<id>_surgical.jpg``, ground truth and references ``<id>.jpg``, mask
``<id>.npy``; identities with fewer than two images are dropped; the
reference is a random other image of the same identity or, with
``use_ssim``, the one of highest SSIM. That best-reference map is cached as a
pickled dict from id to id in ``source_dir.parent / "best_reference_map.pkl"``,
the JAX package's file name and format, so a map written by either package
loads in the other.

Items are dicts of HWC numpy arrays. PIL is imported on use, so importing
this module needs only numpy and torch.
"""

from __future__ import annotations

import logging
import pickle
import random
from os import listdir
from os.path import splitext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["BasicDataset", "ReferenceDataset"]

log = logging.getLogger(__name__)


def _load(filename):
    """npy/npz via numpy, .pt/.pth as a saved tensor image, else PIL."""
    from PIL import Image

    ext = splitext(str(filename))[1]
    if ext in (".npz", ".npy"):
        return Image.fromarray(np.load(filename))
    if ext in (".pt", ".pth"):
        return Image.fromarray(torch.load(filename).numpy())
    return Image.open(filename)


def _preprocess(pil_img, scale: float, is_mask: bool) -> np.ndarray:
    """Resize by ``scale`` (NEAREST masks, BICUBIC images); images /255 as
    float32 HWC, masks int64 HW."""
    from PIL import Image

    w, h = pil_img.size
    new_w, new_h = int(scale * w), int(scale * h)
    if new_w <= 0 or new_h <= 0:
        raise ValueError("Scale is too small, resized images would have no pixel")
    pil_img = pil_img.resize((new_w, new_h),
                             resample=Image.NEAREST if is_mask else Image.BICUBIC)
    arr = np.asarray(pil_img)
    if is_mask:
        return arr.astype(np.int64)
    if arr.ndim == 2:
        arr = arr[..., None]
    return (arr / 255.0).astype(np.float32)


class BasicDataset(torch.utils.data.Dataset):
    """(image, mask) pairs for mask-detector training (dataloader.py:49-119):
    ids in ``listdir`` order, as the JAX package lists them."""

    def __init__(self, images_dir, masks_dir, scale: float = 1.0, mask_suffix: str = ""):
        if not 0 < scale <= 1:
            raise ValueError("Scale must be between 0 and 1")
        self.images_dir, self.masks_dir = Path(images_dir), Path(masks_dir)
        self.scale, self.mask_suffix = scale, mask_suffix
        self.ids = [splitext(f)[0].split("_")[0] for f in listdir(images_dir)
                    if not f.startswith(".")]
        if not self.ids:
            raise RuntimeError(f"No input file found in {images_dir}")
        log.info("Creating dataset with %d examples", len(self.ids))

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> dict:
        name = self.ids[idx]
        mask = _load(self.masks_dir / f"{name}{self.mask_suffix}.npy")
        img = _load(self.images_dir / f"{name}_surgical.jpg")
        if img.size != mask.size:
            raise ValueError(f"Image and mask {name} should be the same size")
        return {"image": _preprocess(img, self.scale, is_mask=False),
                "mask": _preprocess(mask, self.scale, is_mask=True)}


class ReferenceDataset(torch.utils.data.Dataset):
    """(source, ground truth, reference, mask) items (dataloader.py:122-266)."""

    def __init__(self, source_dir, reference_dir, masks_dir, identity_file,
                 apply_transform: bool = True, scale: float = 1.0,
                 use_ssim: bool = False, return_id: bool = False,
                 seed: Optional[int] = None, device=None):
        """device: where the best-reference SSIM scores run (``use_ssim``
        without a cached map); the CPU by default."""
        if not 0 < scale <= 1:
            raise ValueError("Scale must be between 0 and 1")
        self.source_dir = Path(source_dir)
        self.masks_dir = Path(masks_dir)
        self.reference_dir = Path(reference_dir)
        self.identity_map, self.img2identity = self.read_identity_file(identity_file)
        filter_id = {i for v in self.identity_map.values() if len(v) < 2 for i in v}
        self.scale = scale
        self.ids = []
        for f in sorted(listdir(source_dir)):
            f_id = splitext(f)[0].split("_")[0]
            if not f.startswith(".") and f_id not in filter_id:
                self.ids.append(f_id)
        if not self.ids:
            raise RuntimeError(f"No input file found in {source_dir}")
        log.info("Creating dataset with %d examples", len(self.ids))
        self.use_ssim = use_ssim
        if use_ssim:
            cache = self.source_dir.parent / "best_reference_map.pkl"
            if cache.is_file():
                with open(cache, "rb") as f:
                    self.best_reference_map = pickle.load(f)
            else:
                log.info("Creating best_reference_map")
                self.best_reference_map = self.find_best_reference(device)
        self.apply_transform = apply_transform
        self.return_id = return_id
        self._rng = random.Random(seed)

    @staticmethod
    def read_identity_file(identity_file):
        """Lines ``<img> <identity>`` -> (identity -> [ids], id -> identity)."""
        identity_map: dict[int, list[str]] = {}
        img2identity: dict[str, int] = {}
        with open(identity_file) as f:
            for line in f:
                img, identity = line.strip().split(" ")
                img_id = splitext(img)[0].split("_")[0]
                img2identity[img_id] = int(identity)
                identity_map.setdefault(int(identity), []).append(img_id)
        return identity_map, img2identity

    def __len__(self) -> int:
        return len(self.ids)

    def find_best_reference(self, device=None) -> dict:
        """Best-SSIM reference per image over its identity group, cached to
        pkl (dataloader.py:191-218; JAX data/dataset.py:166-208). Each group's
        images are decoded once and all its ordered pairs score in one
        batched SSIM call on ``device``; the image itself is excluded."""
        from face_mask_inpaint_tpu_torch.evaluations.ssim import ssim

        device = torch.device("cpu") if device is None else torch.device(device)
        wanted = set(self.ids)
        best: dict[str, str] = {}
        for group in self.identity_map.values():
            if len(group) < 2 or not any(m in wanted for m in group):
                continue
            imgs = torch.from_numpy(np.stack([
                _preprocess(_load(self.reference_dir / f"{m}.jpg"), self.scale, False)
                for m in group])).to(device)
            k = len(group)
            with torch.no_grad():  # pair (i, j) is row i * k + j
                scores = ssim(imgs.repeat_interleave(k, dim=0), imgs.repeat(k, 1, 1, 1),
                              data_range=1.0, size_average=False)
            scores = scores.view(k, k).cpu().numpy()
            np.fill_diagonal(scores, -np.inf)
            for i, m in enumerate(group):
                if m in wanted:
                    best[m] = group[int(np.argmax(scores[i]))]
        with open(self.source_dir.parent / "best_reference_map.pkl", "wb") as f:
            pickle.dump(best, f)
        return best

    def sample_reference_image(self, img_name: str) -> str:
        if self.use_ssim:
            return self.best_reference_map[img_name]
        images = self.identity_map[self.img2identity[img_name]]
        ref = self._rng.choice(images)
        while ref == img_name:
            ref = self._rng.choice(images)
        return ref

    def __getitem__(self, idx: int) -> dict:
        name = self.ids[idx]
        mask = _load(self.masks_dir / f"{name}.npy")
        src = _load(self.source_dir / f"{name}_surgical.jpg")
        gt = _load(self.reference_dir / f"{name}.jpg")
        ref = _load(self.reference_dir / f"{self.sample_reference_image(name)}.jpg")
        if src.size != mask.size:
            raise ValueError(f"Image and mask {name} should be the same size")
        src_img = _preprocess(src, self.scale, is_mask=False)
        raw_gt_img = _preprocess(gt, self.scale, is_mask=False)
        ref_img = _preprocess(ref, self.scale, is_mask=False)
        if self.apply_transform:
            src_img = (src_img - 0.5) / 0.5
            ref_img = (ref_img - 0.5) / 0.5
            gt_img = (raw_gt_img - 0.5) / 0.5
        else:
            gt_img = raw_gt_img
        items = {
            "src_img": src_img,
            "gt_img": gt_img,
            "raw_gt_img": raw_gt_img,
            "ref_img": ref_img,
            "mask": _preprocess(mask, self.scale, is_mask=True),
        }
        if self.return_id:
            items["id"] = np.asarray([int(name)], np.int64)
        return items
