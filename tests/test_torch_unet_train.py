"""Stack C training in the port (losses/dice.py, train/unet.py,
data/dataset.BasicDataset, cli/train_mask_detector.py, hub.py,
tools/predict_mask.py), held against the JAX package on the CPU.

- The Dice trio and ``unet_loss`` against JAX's, f32, to 1e-6 relative.
- One train step and one eval step against ``make_unet_train_step`` and
  ``make_unet_eval_step``: the full-width UNet at 32^2, batch 2, f32, from
  the same JAX variables carried across, Adam at 1e-5. The loss to 1e-5
  relative; batch statistics and Adam's first and second moments per
  tensor to 1e-4 of the tensor's largest entry plus 1e-6 (the gradients'
  f32 sums taken in another order); the updated parameters likewise where
  the gradient exceeds 1e-3 of the tensor's largest, and to 2 lr where it
  does not (Adam's first step is +-lr whatever the gradient's size); the
  validation Dice to 1e-6.
- ``BasicDataset`` item for item against JAX's on a synthetic tree.
- The trainer CLI for one epoch with ``--device cpu`` from a reference
  ``--load``, its checkpoint, and ``--load`` of that checkpoint.
- ``hub`` and ``predict_mask`` with a reference file.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_mask_inpaint_tpu.data.synthetic import make_synthetic_celeba
from face_mask_inpaint_tpu.losses import dice as jdice
from face_mask_inpaint_tpu.train import unet as junet
from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.losses import dice as tdice
from face_mask_inpaint_tpu_torch.tools import convert_torch as tct
from face_mask_inpaint_tpu_torch.train import unet as tunet

from tests.test_torch_reference_ckpt import unet_reference_sd
from tests.test_torch_stylegan2 import random_variables

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (got, want)


@pytest.mark.parametrize("empty", [False, True])
def test_dice_trio_and_loss_match_jax(empty):
    """dice_coeff per sample and batch-first, multiclass_dice_coeff,
    dice_loss and unet_loss on random [2, 9, 11, C] maps; ``empty`` zeroes
    one sample of both maps (the sets_sum == 0 guard)."""
    rs = np.random.RandomState(1)
    inp = rs.rand(2, 9, 11, 2).astype(np.float32)
    tgt = (rs.rand(2, 9, 11, 2) > 0.5).astype(np.float32)
    if empty:
        inp[1], tgt[1] = 0.0, 0.0
    ti, tt = torch.from_numpy(inp), torch.from_numpy(tgt)
    ji, jt = jnp.asarray(inp), jnp.asarray(tgt)
    for rbf in (False, True):
        _rel(tdice.dice_coeff(ti[..., 0], tt[..., 0], rbf),
             jdice.dice_coeff(ji[..., 0], jt[..., 0], rbf), 1e-6)
        _rel(tdice.multiclass_dice_coeff(ti, tt, rbf),
             jdice.multiclass_dice_coeff(ji, jt, rbf), 1e-6)
    for mc in (False, True):
        _rel(tdice.dice_loss(ti, tt, mc), jdice.dice_loss(ji, jt, mc), 1e-6)
    logits = rs.randn(2, 9, 11, 2).astype(np.float32) * 3
    labels = (rs.rand(2, 9, 11) > 0.4).astype(np.int32)
    _rel(tunet.unet_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
         junet.unet_loss(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)


def test_train_and_eval_step_match_jax():
    from face_mask_inpaint_tpu.models.unet import MaskDetector as JMaskDetector
    from face_mask_inpaint_tpu.train.optim import adam as jadam
    from face_mask_inpaint_tpu.train.state import ModuleState, TrainState
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.train.optim import adam

    rs = np.random.RandomState(2)
    image = rs.rand(2, 32, 32, 3).astype(np.float32)
    mask = np.zeros((2, 32, 32), np.int32)
    mask[:, 14:26, 6:24] = 1
    mask[1, :4] = 1
    jnet = JMaskDetector()
    variables = random_variables(lambda: jnet.init(KEY, jnp.asarray(image)), 3)
    tx = jadam(1e-5)
    mstate = ModuleState.from_variables(variables)
    state = TrainState(step=jnp.zeros([], jnp.int32), model=mstate,
                       opt_state=tx.init(mstate.params), rng=KEY)
    batch = {"image": jnp.asarray(image), "mask": jnp.asarray(mask)}
    state, metrics = jax.jit(junet.make_unet_train_step(jnet, tx))(state, batch)
    dice = jax.jit(junet.make_unet_eval_step(jnet))(state, batch)["dice"]

    net = MaskDetector()
    net.load_state_dict(convert.state_dict_from_jax(net, variables), strict=True)
    opt = adam(net.parameters(), 1e-5)
    tbatch = {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask).long()}
    loss = tunet.make_unet_train_step(net, opt)(tbatch)["loss"]
    tdice_ = tunet.make_unet_eval_step(net)(tbatch)["dice"]
    _rel(loss, metrics["loss"], 1e-5)
    _rel(tdice_, dice, 1e-6)

    def close(got, want, what):
        for k, w in want.items():
            g, w = got[k].detach().numpy(), w.numpy()
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, f"{what} {k}"

    adam_state = state.opt_state[0]
    names = dict(net.named_parameters())
    for moment, key in ((adam_state.mu, "exp_avg"), (adam_state.nu, "exp_avg_sq")):
        want = convert.state_dict_from_jax(net, {"params": moment})
        close({k: opt.state[names[k]][key] for k in want}, want, key)
    want = convert.state_dict_from_jax(net, state.model.variables())
    close({k: v for k, v in net.state_dict().items() if k not in names},
          {k: v for k, v in want.items() if k not in names}, "batch stats")
    # Adam's first step moves each weight by lr * g / (|g| + eps): +-lr
    # whatever |g|, so where the gradient is at the level of the two sides'
    # f32 rounding its sign, and the step, may differ. The update is held
    # to the tolerance above where |g| exceeds 1e-3 of the tensor's largest,
    # and to 2 lr elsewhere.
    mu = convert.state_dict_from_jax(net, {"params": adam_state.mu})
    for k, w in want.items():
        if k not in names:
            continue
        g, w, m = names[k].detach().numpy(), w.numpy(), np.abs(mu[k].numpy())
        err = np.abs(g - w)
        big = m > 1e-3 * m.max()
        assert err[big].max() <= 1e-4 * np.abs(w).max() + 1e-6, f"param {k}"
        assert err.max() <= 2e-5 * (1 + 1e-3), f"param {k}"


def test_basic_dataset_matches_jax(tmp_path):
    from face_mask_inpaint_tpu.data.dataset import BasicDataset as JBasicDataset
    from face_mask_inpaint_tpu_torch.data.dataset import BasicDataset

    tree = make_synthetic_celeba(tmp_path, n_identities=3, images_per_identity=2,
                                 size=(40, 36))
    for scale in (1.0, 0.5):
        got = BasicDataset(tree["root"] / "img_align_celeba_masked1",
                           tree["root"] / "binary_map", scale)
        want = JBasicDataset(tree["root"] / "img_align_celeba_masked1",
                             tree["root"] / "binary_map", scale)
        assert got.ids == want.ids and len(got) == 6
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """24 images at 32^2: with --validation 10 and batch 2, 22 train
    images, 11 steps an epoch, a validation round after each."""
    return make_synthetic_celeba(tmp_path_factory.mktemp("torch_unet_celeba"),
                                 n_identities=12, images_per_identity=2, size=(32, 32))


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    sd, _ = unet_reference_sd(5)
    path = tmp_path_factory.mktemp("unet_ref") / "mask_detector.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path, sd


def _flags(tree, out):
    return ["--device", "cpu", "--dir_img", str(tree["root"] / "img_align_celeba_masked1"),
            "--dir_mask", str(tree["root"] / "binary_map"), "--dir_checkpoint", str(out),
            "--batch-size", "2"]


def test_train_mask_detector_cli_epoch_and_load(tree, reference_pth, tmp_path):
    """--load of a reference .pth sets the converted weights bit for bit
    (--epochs 0); one epoch from it writes unet_checkpoint_epoch1 and the
    metrics; --load of that checkpoint restores model, Adam and step."""
    from face_mask_inpaint_tpu_torch.cli import train_mask_detector as cli
    from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt

    path, sd = reference_pth
    loaded = cli.main([*_flags(tree, tmp_path / "a"), "--epochs", "0", "--load", str(path)])
    want = convert.state_dict_from_jax(loaded.model, tct.convert_unet(sd))
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    out = tmp_path / "b"
    trainer = cli.main([*_flags(tree, out), "--epochs", "1", "--load", str(path),
                        "--learning-rate", "1e-4"])
    assert trainer.step == 11
    state = ckpt.restore_state(out / "unet_checkpoint_epoch1")
    assert state["step"] == 11
    recs = [json.loads(x) for x in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train loss"] for r in recs if "train loss" in r]
    vals = [r for r in recs if "validation Dice" in r]
    assert len(losses) == 11 and all(np.isfinite(losses))
    assert len(vals) == 11 and all(0 <= r["validation Dice"] <= 1 for r in vals)
    assert vals[0]["learning rate"] == pytest.approx(1e-4)

    resumed = cli.main([*_flags(tree, tmp_path / "c"), "--epochs", "0",
                        "--load", str(out / "unet_checkpoint_epoch1")])
    assert resumed.step == 11
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert resumed.optimizer.state_dict()["state"].keys() == \
        trainer.optimizer.state_dict()["state"].keys()


def test_hub_and_predict_mask(tree, reference_pth, tmp_path):
    """hub.mask_detector and hub.unet_carvana load the reference file's
    tensors; predict_mask writes each image's argmax mask with --device cpu."""
    from PIL import Image

    from face_mask_inpaint_tpu_torch import hub
    from face_mask_inpaint_tpu_torch.tools import predict_mask

    path, sd = reference_pth
    det = hub.mask_detector(str(path))
    want = convert.state_dict_from_jax(det, tct.convert_unet(sd))
    for k, v in det.state_dict().items():
        assert torch.equal(v, want[k]), k
    unet = hub.unet_carvana(str(path))
    for k, v in unet.state_dict().items():
        assert torch.equal(v, want[f"model.{k}"]), k
    seeded = hub.reference_fill(seed=1, out_size=32)
    assert not seeded.training

    images = sorted((tree["root"] / "img_align_celeba_masked1").glob("*.jpg"))[:2]
    outs = [str(tmp_path / f"m{i}.png") for i in range(2)]
    masks = predict_mask.main(["--model", str(path), "--device", "cpu",
                               "-i", *map(str, images), "-o", *outs])
    for img, out, m in zip(images, outs, masks):
        arr = np.asarray(Image.open(img).convert("RGB"), np.float32) / 255.0
        with torch.no_grad():
            ref = det.predict_mask(torch.from_numpy(arr)[None])[0].numpy()
        assert np.array_equal(m, ref)
        assert np.array_equal(np.asarray(Image.open(out)), (ref * 255).astype(np.uint8))
