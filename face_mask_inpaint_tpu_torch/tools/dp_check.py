"""One train step of a trainer on W ranks against the same step in one
process, on the card.

    python -m face_mask_inpaint_tpu_torch.tools.dp_check --trainer gan \\
        [--world 2] [--seed 0] [--out build/dp_check]

Each trainer is the CLI's own ``Trainer`` at full width, built from
``--seed`` on every rank:

- ``gan``: BASELINE config 5 (``cli/train_reference_fill.py``, the flagship
  widths, the pluralistic encoders, bf16-mixed, Adam at 1e-4), global batch
  16 at 256^2; ``gan_f32`` the same in f32;
- ``psp``: config 4 (``cli/train_psp.py``, the ``scripts/train_psp.sh``
  recipe with ``--use_attention``, f32, Adam at 1e-4), global batch 8;
- ``unet``: the Stack C UNet (``cli/train_mask_detector.py``, f32, Adam at
  1e-5), global batch 16 at 256^2.

The W ranks are processes started with ``torch.multiprocessing`` (spawn)
and joined at a ``file://`` rendezvous; when they share one card they talk
over gloo (parallel/dist.py). Each rank takes a warm-up step on its slice
of a seeded global batch, returns to the starting state and takes the
measured step, its kernel launches counted; each reports how far its
parameters sit from rank 0's. The ranks then return to the starting state
once more and take the step with one sync cut (``CUT``: the noise drawn at
the slice's shape for the f32 GAN, BatchNorm's moments kept per rank for
the others; none for the bf16 GAN), the negative control. Rank 0 then takes, alone and without a
group, the warm-up and the measured step on the whole global batch, and the
same step with the source image moved by a rounding-sized amount (1e-6 of
itself in f32, 2^-8 in bf16): the step's own drift. It writes what it
measured to ``<out>/<trainer>.json``: the metrics of the steps; the L2
distance of the two-rank, the cut and the drifted gradients (averaged over
the ranks, before the optimizer steps) and parameter updates from the
one-process ones; the step times and the launches of each rank.
``chip_smoke.py`` phase 13 gates them. With ranks that share one card the
times measure the collectives' cost through gloo, not scaling.

``nccl_check`` runs one rank over NCCL: a collective of one, and the UNet's
step at 64^2 with that group against the step without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import time
import types
from pathlib import Path

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from face_mask_inpaint_tpu_torch import kernels
from face_mask_inpaint_tpu_torch.losses import dice, vgg
from face_mask_inpaint_tpu_torch.models import picnet, stylegan2
from face_mask_inpaint_tpu_torch.nn import layers
from face_mask_inpaint_tpu_torch.parallel import dist as pdist

__all__ = ["TRAINERS", "CUT", "SYNCS", "unsynced", "run", "nccl_check", "main"]

HW = 256
# cli/train_reference_fill.py at BASELINE config 5 (chip_smoke.py phase 7)
GAN_ARGS = ["--learning_rate", "1e-4", "--decoder_img_f", "256"]
# cli/train_psp.py at config 4: scripts/train_psp.sh with --use_attention
# (chip_smoke.py phase 9)
PSP_ARGS = ["--use_ref", "--use_attention", "--output_size", "1024", "--train_decoder", "1",
            "--lpips_lambda", "0.8", "--l2_lambda", "2", "--id_lambda", "0.1",
            "--style_lambda", "1000", "--cx_lambda", "1", "--w_norm_lambda", "0",
            "--start_from_latent_avg", "--randomize_noise", "--optimizer", "adam",
            "--learning_rate", "1e-4", "--img_scale", "1"]
TRAINERS = {"gan": 16, "gan_f32": 16, "psp": 8, "unet": 16}  # the global batch of each
# the modules whose reads of the active group ``unsynced`` cuts, by sync
SYNCS = {"batch_norm": (layers,), "dice": (dice,), "y_mu": (vgg,),
         "noise": (picnet, stylegan2)}
# each trainer's negative control. In bf16 at init a noise cut moves the GAN's
# gradients by less than bf16 rounds them (PERF.md, section 6), so the GAN's
# control runs in f32
CUT = {"gan": None, "gan_f32": "noise", "psp": "batch_norm", "unet": "batch_norm"}


@contextlib.contextmanager
def unsynced(name):
    """The modules of sync ``name`` (a key of ``SYNCS``, or None for none)
    see no group: their reduction, or noise draw, stays on this rank's
    slice."""
    if name is None:
        yield
        return
    stub = types.SimpleNamespace(**{**{k: getattr(pdist, k) for k in pdist.__all__},
                                    "active": lambda: None})
    mods = SYNCS[name]
    saved = [m._dp for m in mods]
    for m in mods:
        m._dp = stub
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m._dp = s


def _images(gen: torch.Generator, n: int, hw: int) -> dict:
    """A seeded batch on the host: images in [0, 1], NHWC, and a mask of
    one random rectangle each, as chip_smoke.py's train batches."""
    batch = {k: torch.rand(n, hw, hw, 3, generator=gen) for k in ("src_img", "gt_img",
                                                                   "ref_img")}
    mask = torch.zeros(n, hw, hw)
    for i, (y, x) in enumerate(torch.randint(0, hw // 2, (n, 2), generator=gen).tolist()):
        mask[i, y:y + hw // 2, x:x + hw // 2] = 1.0
    batch["mask"] = mask
    return batch


class _Case:
    """A trainer, its trained parameters, a step over its modules for a
    group, the gradients a step took (averaged over the ranks), its global
    batch and the source key that the drift moves."""

    def __init__(self, name: str, seed: int, dist: pdist.DistEnv, hw: int):
        gen = torch.Generator().manual_seed(seed + 61)
        self.dtype, self.device = torch.float32, dist.device
        common = ["--device", dist.device.type, "--seed", str(seed)]
        if name.startswith("gan"):
            from face_mask_inpaint_tpu_torch.cli import train_reference_fill as cli
            from face_mask_inpaint_tpu_torch.train.gan import make_gan_train_step

            args = cli.get_args([*common, "--batch_size", str(TRAINERS[name]), *GAN_ARGS,
                                 "--out_size", str(hw), "--compute_dtype",
                                 "float32" if name == "gan_f32" else "bfloat16"])
            tr = cli.Trainer(args, dist)
            with torch.no_grad():  # gamma starts at zero: set it so attention trains
                tr.generator.decoder.attn1.gamma.fill_(
                    float(torch.rand(1, generator=torch.Generator().manual_seed(seed))) + 0.5)
            self.modules = (tr.generator, tr.discriminator)
            self.make_step = lambda g: make_gan_train_step(
                tr.generator, tr.discriminator, tr.vgg, tr.g_opt, tr.d_opt, group=g)
            self.call = lambda step, b: step(b, noise=tr.noise, return_grads=True)
            self.grads = lambda out: {**{f"0.{n}": g for n, g in out["g_grads"].items()},
                                      **{f"1.{n}": g for n, g in out["d_grads"].items()}}
            self.batch, self.key = _images(gen, TRAINERS[name], hw), "src_img"
            self.dtype = getattr(torch, args.compute_dtype)
            self.snapshot = lambda: copy.deepcopy(tr.state_dicts())
            self.restore = lambda s: tr.load_state_dicts(*copy.deepcopy(s))
        elif name == "psp":
            from face_mask_inpaint_tpu_torch.cli import train_psp as cli
            from face_mask_inpaint_tpu_torch.train.psp import make_psp_train_step

            args = cli.get_args([*common, "--batch_size", str(TRAINERS[name]), *PSP_ARGS])
            tr = cli.Trainer(args, dist)
            self.modules = (tr.psp,)
            self.make_step = lambda g: make_psp_train_step(
                tr.psp, tr.optimizer, tr.cfg, tr.nets, use_ref=args.use_ref,
                randomize_noise=args.randomize_noise, group=g)
            self.call = lambda step, b: step(b, noise=tr.noise, return_grads=True)
            self.grads = lambda out: {f"0.{n}": g for n, g in out["grads"].items()}
            self.batch = {k: v * 2 - 1 if k != "mask" else v
                          for k, v in _images(gen, TRAINERS[name], hw).items()}
            self.key = "src_img"
            self.snapshot = lambda: copy.deepcopy(tr.state_dict())
            self.restore = lambda s: tr.load_state_dict(copy.deepcopy(s))
        else:
            from face_mask_inpaint_tpu_torch.cli import train_mask_detector as cli
            from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

            args = cli.get_args([*common, "--batch-size", str(TRAINERS[name])])
            tr = cli.Trainer(args, dist)
            self.modules = (tr.model,)
            self.make_step = lambda g: make_unet_train_step(tr.model, tr.optimizer, g)
            self.call = lambda step, b: step(b)
            self.grads = lambda out: {f"0.{n}": p.grad for n, p in tr.model.named_parameters()}
            images = _images(gen, TRAINERS[name], hw)
            self.batch = {"image": images["src_img"], "mask": images["mask"].long()}
            self.key = "image"
            self.snapshot = lambda: copy.deepcopy(tr.state_dict())
            self.restore = lambda s: tr.load_state_dict(copy.deepcopy(s))
        self.params = {f"{i}.{n}": p for i, m in enumerate(self.modules)
                       for n, p in m.named_parameters() if p.requires_grad}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def take(self, step, batch: dict) -> tuple[dict, float, dict]:
        """One step: (float metrics, host seconds to the end of its device
        work, the gradients the optimizers stepped on)."""
        self._sync()
        t0 = time.perf_counter()
        out = self.call(step, {k: v.to(self.device, non_blocking=True) for k, v in batch.items()})
        self._sync()
        seconds = time.perf_counter() - t0
        grads = {k: g.detach().clone() for k, g in self.grads(out).items()}
        assert set(grads) == set(self.params), "a trained parameter without its gradient"
        return ({k: float(v) for k, v in out.items()
                 if isinstance(v, torch.Tensor) and v.dim() == 0}, seconds, grads)

    def update(self, start: dict) -> dict:
        return {n: p.detach() - start[n] for n, p in self.params.items()}


def _distance(a: dict, b: dict) -> float:
    return math.sqrt(sum(float((a[k] - b[k]).double().square().sum()) for k in a))


def _norm(a: dict) -> float:
    return math.sqrt(sum(float(v.double().square().sum()) for v in a.values()))


def _rank(rank: int, world: int, init_file: str, name: str, seed: int, out: str,
          device: str, hw: int, tf32: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dist = pdist.init(rank, world, device, f"file://{init_file}", rank, world)
    try:
        case = _Case(name, seed, dist, hw)
        for m in case.modules:  # as the trainer CLIs do after their loads
            pdist.broadcast_module(m, dist.group)
        start = case.snapshot()
        theta0 = {n: p.detach().clone() for n, p in case.params.items()}
        local = {k: pdist.rank_slice(v, dist.group) for k, v in case.batch.items()}
        step = case.make_step(dist.group)
        case.take(step, local)  # warm-up
        case.restore(start)
        kernels.reset_launch_counts()
        metrics, seconds, dp_grads = case.take(step, local)
        launches = kernels.launch_counts()
        dp_update = case.update(theta0)
        gap = 0.0
        if dist.group is not None:
            mine = [t.detach().clone() for m in case.modules
                    for t in (*m.parameters(), *m.buffers()) if t.is_floating_point()]
            theirs = [t.clone() for t in mine]
            pdist.broadcast_(theirs, dist.group)
            gap = max(float((a - b).abs().max()) for a, b in zip(mine, theirs))
            del mine, theirs
        result = dict(rank=rank, world=world, backend=dist.backend, device=str(dist.device),
                      metrics=metrics, seconds=seconds, launches=launches, replica_gap=gap,
                      cut=CUT[name])
        if CUT[name] is not None:  # the negative control: the step with one sync cut
            case.restore(start)
            with unsynced(CUT[name]):
                result["cut_metrics"], _, cut_grads = case.take(step, local)
            cut_update = case.update(theta0)
        if rank == 0:
            one = case.make_step(None)
            for label, batch in (("warmup", case.batch), ("one", case.batch),
                                 ("drift", _moved(case.batch, case.key, case.dtype, seed))):
                case.restore(start)
                result[f"{label}_metrics"], result[f"{label}_seconds"], grads = case.take(
                    one, batch)
                if label == "one":
                    one_grads, one_update = grads, case.update(theta0)
                elif label == "drift":
                    drift_grads, drift_update = grads, case.update(theta0)
                del grads
            result.update(
                dp_distance=_distance(dp_update, one_update),
                drift_distance=_distance(drift_update, one_update),
                update_norm=_norm(one_update),
                dp_grad_distance=_distance(dp_grads, one_grads),
                drift_grad_distance=_distance(drift_grads, one_grads),
                grad_norm=_norm(one_grads),
                n_params=sum(p.numel() for p in case.params.values()),
                peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                          if dist.device.type == "cuda" else None))
            if CUT[name] is not None:
                result.update(cut_distance=_distance(cut_update, one_update),
                              cut_grad_distance=_distance(cut_grads, one_grads))
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / f"{name}.rank{rank}.json").write_text(json.dumps(result))
    finally:
        pdist.shutdown()


def _moved(batch: dict, key: str, dtype: torch.dtype, seed: int) -> dict:
    """``batch`` with ``key`` moved by a rounding-sized amount of itself:
    1e-6 in f32, 2^-8 (about one ulp) in bf16."""
    scale = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    noise = torch.randn(batch[key].shape, generator=torch.Generator().manual_seed(seed + 62))
    return dict(batch, **{key: batch[key] * (1.0 + scale * noise)})


def _nccl_rank(_: int, init_file: str, seed: int, out: str) -> None:
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method=f"file://{init_file}", rank=0, world_size=1,
                             timeout=pdist.TIMEOUT)
    group = pdist.Group(0, 1, torch.device("cuda", 0))
    try:
        x = torch.arange(4.0, device="cuda")
        tdist.all_reduce(x)
        tdist.broadcast(x, 0)
        gen = torch.Generator().manual_seed(seed + 63)
        batch = {"image": torch.rand(2, 64, 64, 3, generator=gen).cuda(),
                 "mask": (torch.rand(2, 64, 64, generator=gen) > 0.5).long().cuda()}
        runs = {}
        for label, g in (("group", group), ("none", None)):
            net = MaskDetector(generator=torch.Generator().manual_seed(seed)).cuda()
            step = make_unet_train_step(net, torch.optim.SGD(net.parameters(), lr=1e-3), g)
            loss = float(step(batch)["loss"])
            runs[label] = (loss, {k: v.detach().clone() for k, v in net.state_dict().items()
                                  if v.is_floating_point()})
        (loss_g, sd_g), (loss_1, sd_1) = runs["group"], runs["none"]
        # the JAX data-parallel tests' tolerances: parameters rtol 5e-3 atol
        # 2.5e-4 (SGD), running statistics rtol 1e-4 atol 1e-5
        used = max(float(((sd_g[k] - v).abs() / ((1e-5 if "running" in k else 2.5e-4)
                                                  + (1e-4 if "running" in k else 5e-3)
                                                  * v.abs())).max()) for k, v in sd_1.items())
        result = dict(all_reduce=x.tolist(), loss_group=loss_g, loss_none=loss_1, used=used)
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / "nccl.json").write_text(json.dumps(result))
    finally:
        pdist.shutdown()


def _spawn(fn, args: tuple, nprocs: int, what: str, timeout: float) -> None:
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"{what} did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def run(name: str, world: int = 2, seed: int = 0, out: str = "build/dp_check",
        timeout: float = 600.0, device: str = "cuda", hw: int = HW) -> dict:
    """Start ``world`` ranks of trainer ``name`` and wait for them (failing
    after ``timeout`` seconds); returns rank 0's result with every rank's
    launches, times and replica gaps under ``ranks``. ``device`` cpu and a
    smaller ``hw`` (the UNet's widths are fixed) rehearse the run on the
    CPU. The ranks take the caller's TF32 settings."""
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    init_file = out_dir / f"{name}.rendezvous"
    init_file.unlink(missing_ok=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    _spawn(_rank, (world, str(init_file.resolve()), name, seed, str(out_dir), device, hw,
                   tf32), world, f"{world} ranks of {name}", timeout)
    ranks = [json.loads((out_dir / f"{name}.rank{r}.json").read_text()) for r in range(world)]
    return dict(ranks[0], ranks=ranks)


def nccl_check(seed: int = 0, out: str = "build/dp_check", timeout: float = 300.0) -> dict:
    """One rank over NCCL, in a process of its own: a collective of one, and
    the UNet's step with that group and without (``used``: the largest share
    of the JAX data-parallel tests' tolerances its state uses)."""
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    init_file = out_dir / "nccl.rendezvous"
    init_file.unlink(missing_ok=True)
    _spawn(_nccl_rank, (str(init_file.resolve()), seed, str(out_dir)), 1, "the NCCL rank",
           timeout)
    return json.loads((out_dir / "nccl.json").read_text())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trainer", choices=sorted(TRAINERS) + ["nccl"], required=True)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="build/dp_check")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_check runs on the card: CUDA is not available")
    if args.trainer == "nccl":
        print(json.dumps(nccl_check(args.seed, args.out)))
    else:
        print(json.dumps(run(args.trainer, args.world, args.seed, args.out)))


if __name__ == "__main__":
    main()
