"""Port data layer and SSIM against the JAX package: dataset items, the
best-SSIM reference map and its pkl cache, the loader's pad_last/_valid
batches, and SSIM/MS-SSIM (f32 max-abs 1e-5)."""

import pickle
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from face_mask_inpaint_tpu.data.dataset import ReferenceDataset as JReferenceDataset
from face_mask_inpaint_tpu.data.loader import DataLoader as JDataLoader
from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu.evaluations import ssim as jssim
from face_mask_inpaint_tpu_torch.data.dataset import ReferenceDataset, _load, _preprocess
from face_mask_inpaint_tpu_torch.data.loader import DataLoader
from face_mask_inpaint_tpu_torch.evaluations import ssim as tssim
from face_mask_inpaint_tpu_torch.utils.images import mask2im, tensor2im


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread each keeps torch from oversubscribing them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_data_celeba"),
                                 n_identities=3, images_per_identity=2, size=(40, 48))


def _dirs(tree):
    return (tree["src_dir"], tree["ref_dir"], tree["mask_dir"], tree["identity_file"])


@pytest.mark.parametrize("apply_transform", [False, True])
def test_dataset_items_match_jax(tree, apply_transform):
    jds = JReferenceDataset(*_dirs(tree), apply_transform=apply_transform, return_id=True)
    tds = ReferenceDataset(*_dirs(tree), apply_transform=apply_transform, return_id=True,
                           seed=0)
    assert sorted(jds.ids) == tds.ids
    for i, name in enumerate(tds.ids):
        want, got = jds[jds.ids.index(name)], tds[i]
        assert set(got) == set(want)
        for k in ("src_img", "gt_img", "raw_gt_img", "mask", "id"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["ref_img"].shape == want["ref_img"].shape


def test_best_reference_map_matches_jax(tmp_path):
    """The port's best-SSIM map against JAX ``ReferenceDataset(use_ssim=True)``:
    equal wherever the best score leads the runner-up by more than 1e-4 (the
    two SSIMs differ in f32 rounding only). Each package's pkl loads in the
    other."""
    tree = make_synthetic_celeba(tmp_path / "celeba", n_identities=3,
                                 images_per_identity=4, size=(40, 48))
    cache = tree["root"] / "best_reference_map.pkl"
    want = JReferenceDataset(*_dirs(tree), use_ssim=True).best_reference_map
    jax_pkl = tmp_path / "jax_map.pkl"
    shutil.move(cache, jax_pkl)
    got = ReferenceDataset(*_dirs(tree), use_ssim=True, seed=0).best_reference_map
    assert cache.is_file() and set(got) == set(want)

    tds = ReferenceDataset(*_dirs(tree), seed=0)
    decided = 0
    for group in tds.identity_map.values():
        imgs = np.stack([_preprocess(_load(tree["ref_dir"] / f"{m}.jpg"), 1.0, False)
                         for m in group])
        k = len(group)
        scores = np.array(jssim.ssim(jnp.asarray(np.repeat(imgs, k, axis=0)),
                                     jnp.asarray(np.tile(imgs, (k, 1, 1, 1))),
                                     size_average=False)).reshape(k, k)
        np.fill_diagonal(scores, -np.inf)
        for i, m in enumerate(group):
            top2 = np.sort(scores[i])[-2:]
            if top2[1] - top2[0] > 1e-4:
                decided += 1
                assert got[m] == want[m] == group[int(np.argmax(scores[i]))], m
    assert decided > 0

    with open(cache, "rb") as f:  # the port's pkl: the same format
        assert pickle.load(f) == got
    assert JReferenceDataset(*_dirs(tree), use_ssim=True).best_reference_map == got
    shutil.move(jax_pkl, cache)  # the JAX package's pkl loads in the port
    ds = ReferenceDataset(*_dirs(tree), apply_transform=False, use_ssim=True, seed=0)
    assert ds.best_reference_map == want
    item = ds[0]
    np.testing.assert_array_equal(
        item["ref_img"], _preprocess(_load(tree["ref_dir"] / f"{want[ds.ids[0]]}.jpg"),
                                     1.0, False))


def test_loader_pads_last_batch_like_jax():
    rs = np.random.RandomState(0)
    items = [{"x": rs.rand(3, 2).astype(np.float32), "id": np.asarray([i], np.int64)}
             for i in range(5)]
    want = list(JDataLoader(items, 2, pad_last=True, num_workers=1))
    got = list(DataLoader(items, 2, pad_last=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert got[-1]["_valid"].tolist() == [1.0, 0.0]


def test_loader_shuffle_is_seeded():
    items = [{"i": np.asarray([i])} for i in range(9)]

    def order(seed):
        return [int(v) for b in DataLoader(items, 4, shuffle=True, seed=seed) for v in b["i"]]

    assert order(3) == order(3) and sorted(order(3)) == list(range(9))


@pytest.mark.parametrize("shape,fn", [((2, 48, 40, 3), "ssim"), ((1, 176, 168, 3), "ms_ssim")])
def test_ssim_matches_jax(shape, fn):
    rs = np.random.RandomState(1)
    x = rs.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.1 * rs.randn(*shape), 0, 1).astype(np.float32)
    want = getattr(jssim, fn)(jnp.asarray(x), jnp.asarray(y), size_average=False)
    got = getattr(tssim, fn)(torch.from_numpy(x), torch.from_numpy(y), size_average=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_image_helpers_clip_and_expand():
    img = tensor2im(np.array([[[-0.5, 0.5, 2.0]]], np.float32))
    assert np.asarray(img).tolist() == [[[0, 127, 255]]]
    assert np.asarray(mask2im(np.ones((2, 3), np.float32))).shape == (2, 3, 3)
