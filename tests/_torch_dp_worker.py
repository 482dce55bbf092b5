"""The ranks of the data-parallel tests (tests/test_torch_dp*.py).

``run_ranks`` starts W processes with ``torch.multiprocessing`` (spawn),
joined through a ``file://`` rendezvous under the test's tmp_path, so the
suite's xdist workers never compete for a port; each runs one intra-op
thread over gloo, and the join fails the test after ``timeout`` seconds.

Each case (``gan_steps``, ``psp_steps``, ``unet_steps``) takes one train
step per run of its job on every rank, from the job's weights, on the rank's
slice of the global batch. Rank 0 then takes the same step in one process
on the whole global batch (no group) and holds the two against each other
in place, so no model crosses a process boundary twice: each comparison is
the largest share of its tolerance a tensor uses (``used``; <= 1 passes),
with the JAX data-parallel tests' tolerances (``TOL``). Every rank reports
how far its parameters and buffers sit from rank 0's (``replica_gap``).
This module imports no JAX, so the spawned ranks start fast.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from face_mask_inpaint_tpu_torch.losses import vgg as tvgg
from face_mask_inpaint_tpu_torch.models import picnet as tpicnet
from face_mask_inpaint_tpu_torch.models import stylegan2 as tsg
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from face_mask_inpaint_tpu_torch.tools.dp_check import unsynced

# (rtol, atol) of tests/test_dp_equivalence*.py: metrics, parameters, the
# BatchNorm running statistics
TOL = {"metrics": (2e-4, 1e-5), "params": (5e-3, 2.5e-4), "stats": (1e-4, 1e-5)}


def _entry(rank, world, init_file, case, job_path, out_dir):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    if case == "clis":
        out = clis(rank, world, init_file, job)
    else:
        env = pdist.init(rank, world, "cpu", f"file://{init_file}")
        try:
            out = CASES[case](env.group, job)
        finally:
            pdist.shutdown()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def run_ranks(tmp_path, case: str, job: dict, world: int = 2, timeout: float = 120.0):
    """Run ``CASES[case](group, job)`` on ``world`` gloo ranks; returns
    each rank's result."""
    tmp_path = Path(tmp_path)
    job_path, init_file = tmp_path / f"{case}_job.pt", tmp_path / f"{case}_rendezvous"
    torch.save(job, job_path)
    ctx = mp.start_processes(_entry, args=(world, str(init_file), case, str(job_path),
                                           str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{world} ranks of {case!r} did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def used(got: dict, want: dict, kind: str) -> float:
    """The largest share of tolerance ``kind`` any entry of ``got`` uses
    against ``want`` (|got - want| / (atol + rtol |want|)); NaN counts as a
    miss."""
    rtol, atol = TOL[kind]
    worst = 0.0
    for k, w in want.items():
        w = torch.as_tensor(w, dtype=torch.float64)
        g = torch.as_tensor(got[k], dtype=torch.float64)
        share = ((g - w).abs() / (atol + rtol * w.abs())).nan_to_num(float("inf"))
        same_nan = torch.isnan(g) & torch.isnan(w)
        worst = max(worst, float(share.masked_fill(same_nan, 0.0).max()))
    return worst


def _replica_gap(modules, group) -> float:
    """max |this rank's parameters and buffers - rank 0's|."""
    if group is None:
        return 0.0
    mine = [t.detach().clone() for m in modules for t in (*m.parameters(), *m.buffers())
            if t.is_floating_point()]
    theirs = [t.clone() for t in mine]
    pdist.broadcast_(theirs, group)
    return max(float((a - b).abs().max()) for a, b in zip(mine, theirs))


def _local(x, group):
    return pdist.rank_slice(torch.as_tensor(np.asarray(x)), group)


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items() if isinstance(v, torch.Tensor)
            and v.dim() == 0}


def _split(state: dict, buffers: set) -> tuple[dict, dict]:
    """(parameters, floating buffers) of a state dict."""
    return ({k: v for k, v in state.items() if k not in buffers},
            {k: v for k, v in state.items() if k in buffers and v.is_floating_point()})


def _held(group, run_step, run: dict) -> dict:
    """``run_step(group, run) -> (metrics, params, stats, modules)`` on the
    ranks, then on rank 0 alone without a group; rank 0's comparison."""
    metrics, params, stats, modules = run_step(group, run)
    out = dict(metrics=metrics, replica_gap=_replica_gap(modules, group))
    del modules  # free the models' gradients before the one-process step
    if group is None or group.rank != 0:
        return out
    m1, p1, s1, _ = run_step(None, run)
    out.update(metrics_one=m1, used={"metrics": used(metrics, m1, "metrics"),
                                     "params": used(params, p1, "params"),
                                     "stats": used(stats, s1, "stats") if s1 else 0.0})
    if run.get("keep"):
        out.update(params=params, stats=stats)
    return out


# -- the Stack A GAN step -----------------------------------------------------

def contextual(group, x: np.ndarray, y: np.ndarray, off=None) -> dict:
    """The contextual loss of this rank's slice of feature maps ``x``
    (NCHW, differentiated) and ``y``, and the one-process loss of the
    whole: the shares of tolerance that the ranks' mean loss and this rank's
    gradient (over the rank count, its share in the mean of the ranks'
    losses) use against the one-process ones, the loss at the metrics'
    tolerance, the gradient at 1e-4 of its largest entry."""
    xs = _local(x, group).clone().requires_grad_()
    with pdist.data_parallel(group), unsynced(off):
        loss = tvgg.contextual_loss(xs, _local(y, group))
    loss.backward()
    loss = pdist.mean_over_ranks({"loss": loss.detach()}, group)["loss"]
    xf = torch.as_tensor(x).clone().requires_grad_()
    want = tvgg.contextual_loss(xf, torch.as_tensor(y))
    want.backward()
    g, w = xs.grad / group.size, _local(xf.grad, group)
    return {"metrics": used({"loss": loss}, {"loss": want.detach()}, "metrics"),
            "grads": float((g - w).abs().max() / (1e-4 * w.abs().max())),
            "loss": float(want)}


def gan_steps(group, job: dict) -> dict:
    """One GAN step (Adam) a run from the job's weights, on ``run["batch"]``
    (``job["batch"]`` by default): ``eps`` (the global eps_q, eps_p) or
    noise from a generator seeded ``job["noise_seed"]``; ``off`` names a
    sync to cut. Then ``contextual`` on the job's feature
    maps, with and without the feature mean's sync."""
    from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
    from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
    from face_mask_inpaint_tpu_torch.train.gan import make_gan_train_step
    from face_mask_inpaint_tpu_torch.train.optim import adam

    def run_step(g, run):
        gen = ReferenceFill(job["enc"], job["dec"], use_att=True,
                            out_size=(job["hw"], job["hw"]))
        gen.load_state_dict(job["g_state"], strict=True)
        disc = tpicnet.define_d(input_nc=3, **job["disc"])
        disc.load_state_dict(job["d_state"], strict=True)
        vgg = VGG16Features()
        vgg.load_state_dict(job["vgg_state"], strict=True)
        step = make_gan_train_step(gen, disc, vgg, adam(gen.parameters(), job["lr"]),
                                   adam(disc.parameters(), job["lr"]), group=g)
        batch = {k: _local(v, g) for k, v in run.get("batch", job["batch"]).items()}
        eps = run.get("eps")
        kw = (dict(eps_q=_local(eps[0], g), eps_p=_local(eps[1], g)) if eps is not None
              else dict(noise=torch.Generator().manual_seed(job["noise_seed"])))
        with unsynced(run.get("off")):
            metrics = step(batch, **kw)
        state = {**{f"G.{k}": v for k, v in gen.state_dict().items()},
                 **{f"D.{k}": v for k, v in disc.state_dict().items()}}
        bufs = {f"G.{k}" for k, _ in gen.named_buffers()} | {f"D.{k}" for k, _ in
                                                             disc.named_buffers()}
        params, spectral = _split(state, bufs)
        return _floats(metrics), params, spectral, (gen, disc)

    x, y = job["features"]
    return dict(runs=[_held(group, run_step, run) for run in job["runs"]],
                contextual=contextual(group, x, y),
                contextual_unsynced=contextual(group, x, y, "y_mu"))


# -- the pSp step -------------------------------------------------------------

def psp_models(job: dict):
    """PSP(**job["small"]) and LPIPS(alex) drawn from ``job["seed"]`` (the
    same on every rank), the noise weights at 0.5 so the noise reaches the
    image, a seeded latent average, LPIPS's linear heads made non-negative
    (as trained ones are, and as tests/test_dp_equivalence_bc.py makes
    them)."""
    from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet
    from face_mask_inpaint_tpu_torch.models.psp import PSP
    from face_mask_inpaint_tpu_torch.nn.layers import init_weights

    weights = torch.Generator().manual_seed(job["seed"])
    psp = PSP(**job["small"], generator=weights)
    lp = init_weights(LPIPSNet("alex"), weights)
    with torch.no_grad():
        for m in psp.modules():
            if isinstance(m, tsg.NoiseInjection):
                m.weight.fill_(0.5)
        psp.latent_avg.copy_(0.1 * torch.randn(psp.latent_avg.shape, generator=weights))
        for n, p in lp.named_parameters():
            if n.startswith("lin"):
                p.abs_()
    return psp, lp


def psp_steps(group, job: dict) -> list[dict]:
    """One pSp step (SGD, the encoder alone) a run from the job's weights,
    on ``run["batch"]``, the randomized noise drawn from a generator seeded
    ``job["noise_seed"]``, the loss weights ``job["loss"]`` updated by
    ``run["loss"]`` (a VGG16 drawn from ``job["seed"]`` joins the loss nets
    for the contextual term); ``off`` names a sync to cut. The metrics hold
    whether the decoder's parameters stayed as they were."""
    from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig
    from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
    from face_mask_inpaint_tpu_torch.nn.layers import init_weights
    from face_mask_inpaint_tpu_torch.train.psp import make_psp_train_step, partition_params

    def run_step(g, run):
        psp, lp = psp_models(job)
        decoder = {k: v.clone() for k, v in psp.state_dict().items() if k.startswith("decoder.")}
        named = partition_params(psp, False)
        cfg = PSPLossConfig(**{**job["loss"], **run.get("loss", {})})
        nets = {"lpips": lp}
        if cfg.cx_lambda > 0:
            nets["vgg"] = init_weights(VGG16Features(),
                                       torch.Generator().manual_seed(job["seed"] + 1))
        step = make_psp_train_step(psp, torch.optim.SGD([p for _, p in named], lr=job["lr"]),
                                   cfg, nets, use_ref=True, resize=False, group=g)
        with unsynced(run.get("off")):
            metrics = step({k: _local(v, g) for k, v in run["batch"].items()},
                           noise=torch.Generator().manual_seed(job["noise_seed"]))
        state = psp.state_dict()
        frozen = all(torch.equal(state[k], v) for k, v in decoder.items())
        params, stats = _split({k: v for k, v in state.items() if k.startswith("encoder.")},
                               {k for k, _ in psp.named_buffers()})
        return {**_floats(metrics), "decoder_frozen": float(frozen)}, params, stats, (psp,)

    return [_held(group, run_step, run) for run in job["runs"]]


# -- the UNet step ------------------------------------------------------------

def unet_steps(group, job: dict) -> list[dict]:
    """One UNet step (SGD) a run from the job's weights, on ``run["batch"]``;
    ``off`` names a sync to cut."""
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
    from face_mask_inpaint_tpu_torch.train.unet import make_unet_train_step

    def run_step(g, run):
        net = MaskDetector()
        net.load_state_dict(job["state"], strict=True)
        step = make_unet_train_step(net, torch.optim.SGD(net.parameters(), lr=job["lr"]), g)
        batch = {"image": _local(run["batch"]["image"], g),
                 "mask": _local(run["batch"]["mask"], g).long()}
        with unsynced(run.get("off")):
            loss = step(batch)["loss"]
        params, stats = _split(net.state_dict(), {k for k, _ in net.named_buffers()})
        return {"loss": float(loss)}, params, stats, (net,)

    return [_held(group, run_step, run) for run in job["runs"]]


# -- the trainer CLIs ---------------------------------------------------------

def clis(rank: int, world: int, init_file: str, job: dict) -> dict:
    """Each CLI of ``job["argv"]`` (module name -> arguments) in-process as
    rank ``rank`` of ``world``: torchrun's environment read by
    ``parallel.dist.init_from_env`` is replaced by the ``file://``
    rendezvous. Returns each run's trained step count and the float64 sum of
    its parameters and buffers (equal on every rank when the replicas
    agree)."""
    import importlib

    out = {}
    for i, (module, argv) in enumerate(job["argv"].items()):
        cli = importlib.import_module(f"face_mask_inpaint_tpu_torch.cli.{module}")
        real = pdist.init_from_env
        pdist.init_from_env = lambda device, i=i: pdist.init(
            rank, world, device, f"file://{init_file}.{i}")
        try:
            trainer = cli.main(argv)
        finally:
            pdist.init_from_env = real
        modules = ([trainer.model] if hasattr(trainer, "model")
                   else [trainer.generator, trainer.discriminator])
        out[module] = dict(step=trainer.step, checksum=sum(
            float(t.detach().double().sum()) for m in modules
            for t in (*m.parameters(), *m.buffers())))
    return out


# -- the ranks' agreement ----------------------------------------------------

def agreements(group, job: dict) -> list:
    """``parallel.dist.agree`` on each run's values for this rank: the
    message it raised, or None."""
    out = []
    for values in job["runs"]:
        try:
            pdist.agree(values[group.rank], "the values", group)
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out


CASES = {"gan": gan_steps, "psp": psp_steps, "unet": unet_steps, "agree": agreements}
