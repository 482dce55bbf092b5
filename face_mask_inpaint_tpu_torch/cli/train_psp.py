"""Train the Stack B RefpSp (pSp encoder -> StyleGAN2): the port of
``train_psp.py`` with its flags and defaults.

    python -m face_mask_inpaint_tpu_torch.cli.train_psp \\
        --data_root <celeba root> --use_ref --run_name <name> [--device cuda]
    python -m torch.distributed.run --standalone --nproc_per_node W \\
        -m face_mask_inpaint_tpu_torch.cli.train_psp ...

Encoder-only optimization unless ``--train_decoder 1`` (train/psp.py),
adam or ranger, the pSpLoss lambda surface (losses/psp_loss.py, style and
contextual computed and logged, never added), the non-finite-loss guard, an
eval round every n_train // (10 * batch) steps with the validation loss and
SSIM (and MS-SSIM) of (gen + 1) / 2 against the raw ground truth, the plateau
tracker (mode 'max', patience 2, factor 0.8) stepped on the validation loss,
weight and gradient histograms without the style MLP (``decoder.style_*``)
on eval steps, a per-epoch checkpoint under ``<checkpoint_path>/<run_name>/``
and ``--resume`` from the latest (train/checkpoint.py: the model, the
optimizer with Ranger's slow buffers, the tracker, the step and the noise
generator's state). Metrics go to ``<checkpoint_path>/<run_name>/
metrics.jsonl`` with the JAX trainer's keys.

``--device`` defaults to cuda and fails when CUDA is absent; ``--device
cpu`` runs on the CPU. ``--seed`` seeds the weights (drawn on ``--device``),
the shuffle and the noise. Training is float32, as the JAX trainer is.
Without weight files the nets start from the JAX initialisers'
distributions. The weight files go through the CLIs' loader (convert.py),
as ``train_psp.py:122-158`` and ``:203-226`` read them:

- ``--pt_ckpt_path``: the port's own PSP state_dict loads strictly; a
  reference pSp checkpoint converts with ``convert_psp`` and merges by key
  and shape;
- otherwise ``--stylegan_weights``: the ``g_ema.`` keys (or the whole dict)
  convert with ``convert_stylegan2_generator`` and merge into the decoder
  and its noises;
- ``--irse50_weights``: the identity loss's ArcFace backbone, through
  ``convert_irse_backbone``;
- ``--alexnet_weights`` with ``--lpips_lin_weights``: LPIPS(alex), through
  ``convert_lpips_alex``;
- ``--vgg_weights``: a torchvision ``vgg16``.

An Orbax directory, or a file that holds no state dict of its net, raises.
``--eval_options fid`` accumulates the InceptionV3 activations of the
ground truth and of (gen + 1) / 2 over the validation round into one
Fréchet distance, with ``--inception_weights`` (a torchvision
``inception_v3``) or, without them, a random InceptionV3 from ``--seed``.

Under ``torch.distributed.run`` the W ranks train data parallel, as the JAX
trainer does over its mesh (parallel/dist.py): the global batch is
``--batch_size`` rounded to ``max(b, W) // W * W``, each rank takes its
slice of it and the step computes the one-process step on the global batch
(the trainable gradients, the encoder's BatchNorm moments, the noise and the
guard's decision over the ranks). Every rank builds the weights from
``--seed`` and reads the same weight files and ``--resume``'s checkpoint;
rank 0's model is then broadcast. Only rank 0 validates, logs and writes
checkpoints; the validation loss that steps the learning rate is broadcast
from it.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import torch

from face_mask_inpaint_tpu_torch.cli.train_reference_fill import (
    load_vgg, reference_loaders, resolve_device, start)
from face_mask_inpaint_tpu_torch.convert import jax_leading_dims, load_checkpoint, read_checkpoint
from face_mask_inpaint_tpu_torch.evaluations.fid import FIDAccumulator, build_inception
from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
from face_mask_inpaint_tpu_torch.losses.id_loss import make_backbone
from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet
from face_mask_inpaint_tpu_torch.losses.psp_loss import PSPLossConfig
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.parallel import dist as pdist
from face_mask_inpaint_tpu_torch.tools.convert_torch import (
    convert_irse_backbone, convert_lpips_alex, convert_psp, convert_stylegan2_generator)
from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt
from face_mask_inpaint_tpu_torch.train.optim import (
    PlateauTracker, adam, ranger, set_learning_rate)
from face_mask_inpaint_tpu_torch.train.psp import (
    make_psp_eval_step, make_psp_train_step, partition_params)
from face_mask_inpaint_tpu_torch.utils.metrics_logger import (
    MetricsLogger, NullLogger, histogram_summary)
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow, add_profile_args

__all__ = ["get_args", "loss_config", "build_models", "Trainer", "train_net", "main"]

def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=5, help='Number of epochs')
    parser.add_argument('--batch_size', dest='batch_size', type=int, default=8)
    parser.add_argument('--learning_rate', type=float, default=1e-5)
    parser.add_argument('--eval_options', nargs="+", default={'ssim'})
    parser.add_argument('--debug', type=int, default=0,
                        help='debug with turning off not implemented parts')
    parser.add_argument('--img_scale', type=float, default=1.)
    parser.add_argument('--optimizer', type=str, default='adam')
    parser.add_argument('--use_ref', action='store_true', help='use reference image')
    parser.add_argument('--use_attention', action='store_true', help='use attention')

    # path args
    parser.add_argument('--run_name', type=str, default='', help='exp name')
    parser.add_argument('--checkpoint_path', type=str, default='saved_model')
    parser.add_argument('--mask_detector_path', type=str, default='')
    parser.add_argument('--data_root', type=str, default='/data/mohaa/project1/CelebA')
    parser.add_argument('--src_img_path', type=str, default='img_align_celeba_masked1')
    parser.add_argument('--ref_img_path', type=str, default='img_align_celeba')
    parser.add_argument('--mask_path', type=str, default='binary_map')
    parser.add_argument('--identity_file_path', type=str, default='identity_CelebA.txt')

    # pSp args
    parser.add_argument('--encoder_type', type=str, default='GradualStyleEncoder')
    parser.add_argument('--output_size', default=1024, type=int,
                        help='Output size of generator')
    parser.add_argument('--train_decoder', default=0, type=int,
                        help='Whether to train the decoder model')
    parser.add_argument('--start_from_latent_avg', action='store_true',
                        help='Whether to add average latent vector')
    parser.add_argument('--learn_in_w', action='store_true',
                        help='Whether to learn in w space instead of w+')
    parser.add_argument('--randomize_noise', action='store_true',
                        help='whether to randomize noise in stylegan')

    # loss weights
    parser.add_argument('--lpips_lambda', default=0.8, type=float)
    parser.add_argument('--id_lambda', default=0, type=float)
    parser.add_argument('--l2_lambda', default=1.0, type=float)
    parser.add_argument('--w_norm_lambda', default=0, type=float)
    parser.add_argument('--lpips_lambda_ref', default=0, type=float)
    parser.add_argument('--l2_lambda_ref', default=0, type=float)
    parser.add_argument('--style_lambda', default=250, type=float)
    parser.add_argument('--cx_lambda', default=1, type=float)

    # pretrained weight paths
    parser.add_argument('--stylegan_weights', default=None, type=str,
                        help='Path to StyleGAN model weights')
    parser.add_argument('--pt_ckpt_path', default=None, type=str,
                        help='Path to pretrained pSp model checkpoint')
    parser.add_argument('--irse50_weights', default='', type=str,
                        help='ir_se50 .pth for encoder init + ID loss')
    parser.add_argument('--inception_weights', type=str, default='',
                        help='torchvision inception_v3 .pth for --eval_options fid')
    parser.add_argument('--alexnet_weights', default='', type=str)
    parser.add_argument('--lpips_lin_weights', default='', type=str)
    parser.add_argument('--vgg_weights', default='', type=str)
    parser.add_argument('--use_wandb', type=int, default=0)
    parser.add_argument('--resume', type=int, default=0,
                        help='resume from the latest checkpoint under '
                             '<checkpoint_path>/<run_name> (full state)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, the shuffle and the noise')
    add_profile_args(parser)
    args = parser.parse_args(argv)

    args.src_img_path = os.path.join(args.data_root, args.src_img_path)
    args.ref_img_path = os.path.join(args.data_root, args.ref_img_path)
    args.mask_path = os.path.join(args.data_root, args.mask_path)
    args.identity_file_path = os.path.join(args.data_root, args.identity_file_path)
    args.train_decoder = bool(args.train_decoder)
    return args


def loss_config(args) -> PSPLossConfig:
    return PSPLossConfig(
        id_lambda=args.id_lambda, lpips_lambda=args.lpips_lambda, l2_lambda=args.l2_lambda,
        style_lambda=args.style_lambda, lpips_lambda_ref=args.lpips_lambda_ref,
        l2_lambda_ref=args.l2_lambda_ref, cx_lambda=args.cx_lambda,
        w_norm_lambda=args.w_norm_lambda, start_from_latent_avg=args.start_from_latent_avg)


def _g_ema(sd: dict) -> dict:
    """The generator of a StyleGAN2 file: its ``g_ema.`` keys, or the whole
    dict (train_psp.py:141-143)."""
    g = {k[len('g_ema.'):]: v for k, v in sd.items() if k.startswith('g_ema.')}
    return g or sd


def build_models(args, cfg: PSPLossConfig, device: torch.device):
    """(psp, nets): PSP with weights from ``--seed`` drawn on ``device``,
    then ``--pt_ckpt_path`` or ``--stylegan_weights``, its latent average
    when ``--start_from_latent_avg`` finds it zero, and the loss nets the
    active lambdas need, from their weight files or ``--seed``, frozen, in
    eval mode. Every weight file is read before anything is built."""
    psp_state = read_checkpoint(args.pt_ckpt_path, 'pSp')
    sg_state = read_checkpoint(args.stylegan_weights, 'StyleGAN2') if psp_state is None else None
    lpips_files = args.alexnet_weights and args.lpips_lin_weights and (cfg.lpips_lambda > 0
                                                                       or cfg.lpips_lambda_ref > 0)
    alex_state = read_checkpoint(args.alexnet_weights, 'AlexNet') if lpips_files else None
    lin_state = read_checkpoint(args.lpips_lin_weights, 'LPIPS lin') if lpips_files else None
    irse_state = read_checkpoint(args.irse50_weights, 'ir_se50') if cfg.id_lambda > 0 else None
    weights = torch.Generator(device=device).manual_seed(args.seed)
    with torch.device(device):
        psp = PSP(encoder_type=args.encoder_type, output_size=args.output_size,
                  start_from_latent_avg=args.start_from_latent_avg,
                  learn_in_w=args.learn_in_w, use_attention=args.use_attention,
                  generator=weights, init=False)
        if psp_state is None or set(psp_state) != set(psp.state_dict()):
            init_weights(psp, weights)
        if psp_state is not None:
            load_checkpoint(psp, psp_state, lambda sd: convert_psp(sd, args.output_size),
                            'pSp', args.pt_ckpt_path,
                            merge=('params', 'batch_stats', 'noises', 'latent_avg'))
            logging.info('Loaded pSp from checkpoint: %s', args.pt_ckpt_path)
        elif sg_state is not None:
            def decoder_vars(sd):
                conv = convert_stylegan2_generator(_g_ema(sd), args.output_size)
                return {'params': {'decoder': conv['params']},
                        'noises': {'decoder': conv.get('noises', {})}}
            load_checkpoint(psp, sg_state, decoder_vars, 'StyleGAN2 decoder',
                            args.stylegan_weights, merge=('params', 'noises'))
            logging.info('Loaded decoder weights from %s', args.stylegan_weights)
        else:
            logging.warning('No pretrained pSp weights; using random init')
        if args.start_from_latent_avg and not bool(psp.latent_avg.any()):
            psp.latent_avg.copy_(psp.compute_latent_avg(10_000, weights))
            logging.info('Computed latent_avg from decoder.mean_latent')
        nets = {}
        if cfg.lpips_lambda > 0 or cfg.lpips_lambda_ref > 0:
            nets['lpips'] = init_weights(LPIPSNet('alex'), weights).eval()
            if alex_state is not None and lin_state is not None:
                lin_sd = {k: v.numpy() for k, v in lin_state.items()}
                load_checkpoint(nets['lpips'], alex_state,
                                lambda sd: {'params': convert_lpips_alex(sd, lin_sd)},
                                'LPIPS(alex)', args.alexnet_weights)
            else:
                logging.warning('LPIPS running with random weights')
        if cfg.id_lambda > 0:
            nets['facenet'] = init_weights(make_backbone(), weights).eval()
            if irse_state is not None:
                load_checkpoint(nets['facenet'], irse_state, convert_irse_backbone,
                                'ir_se50', args.irse50_weights)
            else:
                logging.warning('No pretrained ir_se50 weights; using random init')
    if cfg.style_lambda > 0 or cfg.cx_lambda > 0:
        nets['vgg'] = load_vgg(args.vgg_weights, torch.Generator().manual_seed(args.seed)
                               ).to(device).eval()
    return psp.train(), nets


def _to_device(batch: dict, device: torch.device) -> dict:
    b = {k: batch[k].to(device, non_blocking=True) for k in ("src_img", "gt_img", "ref_img")}
    b["mask"] = (batch["mask"] > 0).float().to(device, non_blocking=True)
    return b


class Trainer:
    """The model, the loss nets, the optimizer and plateau tracker, the step
    counter and the noise generator; ``state_dict``/``load_state_dict`` are
    what a checkpoint holds. ``dist`` is this rank's data-parallel
    environment, or the device of a run on one rank."""

    def __init__(self, args, dist: pdist.DistEnv | torch.device):
        self.dist = dist if isinstance(dist, pdist.DistEnv) else pdist.DistEnv(dist)
        self.device = device = self.dist.device
        self.cfg = loss_config(args)
        self.psp, self.nets = build_models(args, self.cfg, device)
        named = partition_params(self.psp, args.train_decoder)
        params = [p for _, p in named]
        if args.optimizer == 'ranger':
            dims = jax_leading_dims(self.psp)
            self.optimizer = ranger(params, args.learning_rate,
                                    keep_dims={p: dims[n] for n, p in named if n in dims})
        else:
            self.optimizer = adam(params, args.learning_rate)
        # ReduceLROnPlateau parity (train_psp.py:294-298, stepped on the val
        # loss at :382): mode 'max', patience 2, factor 0.8
        self.sched = PlateauTracker(args.learning_rate, mode='max', patience=2, factor=0.8)
        self.noise = torch.Generator(device=device).manual_seed(args.seed)
        self.step = 0
        self.train_step = make_psp_train_step(self.psp, self.optimizer, self.cfg, self.nets,
                                              use_ref=args.use_ref,
                                              randomize_noise=args.randomize_noise,
                                              group=self.dist.group)
        self.eval_step = make_psp_eval_step(self.psp, self.cfg, self.nets,
                                            use_ref=args.use_ref)
        self.inception = None
        if 'fid' in set(args.eval_options):
            self.inception = build_inception(
                args.inception_weights, device, torch.Generator().manual_seed(args.seed),
                'fid eval uses a randomly initialized InceptionV3 (--inception_weights '
                'unset); values are relative only')

    def state_dict(self) -> dict:
        return {'model': self.psp.state_dict(), 'opt': self.optimizer.state_dict(),
                'sched': self.sched.state_dict(), 'step': self.step,
                'rng': self.noise.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.psp.load_state_dict(state['model'])
        self.optimizer.load_state_dict(state['opt'])
        self.sched.load_state_dict(state['sched'])
        self.step = int(state['step'])
        self.noise.set_state(state['rng'].cpu())


def evaluate(trainer: Trainer, val_loader, eval_options: set) -> dict:
    """Mean validation loss (and SSIM, MS-SSIM of (gen + 1) / 2 against the
    raw ground truth) over the val loader; with 'fid', one Fréchet distance
    of the whole round's activations."""
    metrics = {'validation loss': 0.0}
    fid = FIDAccumulator(trainer.inception) if 'fid' in eval_options else None
    n = 0
    for batch in val_loader:
        out = trainer.eval_step(_to_device(batch, trainer.device))
        metrics['validation loss'] += float(out['loss'])
        gen01 = (out['gen'].float() + 1) / 2
        gt = batch['raw_gt_img'].to(trainer.device)
        if 'ssim' in eval_options:
            metrics['ssim'] = metrics.get('ssim', 0.0) + float(ssim(gt, gen01))
        if 'ms_ssim' in eval_options and gen01.shape[1] > 160:
            metrics['ms_ssim'] = metrics.get('ms_ssim', 0.0) + float(ms_ssim(gt, gen01))
        if fid is not None:
            fid.add(gt, gen01)
        n += 1
    metrics = {k: v / max(n, 1) for k, v in metrics.items()}
    if fid is not None and fid.gt:
        metrics['fid'] = fid.value()
    return metrics


def _drop_style(named) -> list:
    """Without the style MLP, as the reference logs (train_psp.py:352-359)."""
    items = named.items() if isinstance(named, dict) else named
    return [(n, t) for n, t in items if not n.startswith('decoder.style_')]


def train_net(trainer: Trainer, train_loader, val_loader, args):
    dist = trainer.dist
    run_dir = (ckpt.checkpoint_dir(args.checkpoint_path, args.run_name) if dist.is_main
               else Path(args.checkpoint_path) / args.run_name)
    logger = (MetricsLogger(run_dir, 'RefpSp', args.run_name, config=vars(args),
                            use_wandb=bool(args.use_wandb)) if dist.is_main else NullLogger())
    if len(train_loader) == 0:
        raise SystemExit(f'train loader is empty: need at least one batch of '
                         f'{args.batch_size}')
    n_train = len(train_loader) * args.batch_size

    start_epoch = 0
    if args.resume:
        last = ckpt.latest_epoch(run_dir, 'G')
        if last is None:
            logging.warning('--resume set but no checkpoint under %s; starting fresh', run_dir)
        else:
            trainer.load_state_dict(ckpt.restore_state(run_dir / f'G_checkpoint_epoch{last}'))
            start_epoch = last
            logging.info('Resumed from epoch %d (step %d, lr=%g)', last, trainer.step,
                         trainer.sched.lr)
    # every rank resumes from the same files, optimizer state, trackers and
    # noise included: a rank that found none fails the run on every rank
    pdist.agree([start_epoch, trainer.step], 'the epoch and step resumed from', dist.group)
    pdist.broadcast_module(trainer.psp, dist.group)

    eval_options = set(args.eval_options)
    profiler = ProfileWindow(args.profile_dir if dist.is_main else '', args.profile_steps)
    division_step = max(n_train // (10 * args.batch_size), 1)
    for epoch in range(start_epoch, args.epochs):
        for batch in train_loader:
            profiler.tick(trainer.step)
            is_eval_step = (trainer.step + 1) % division_step == 0
            metrics = trainer.train_step(_to_device(batch, trainer.device),
                                         noise=trainer.noise, return_grads=is_eval_step)
            grads = metrics.pop('grads', None)
            trainer.step += 1
            logger.log({k: float(v) for k, v in metrics.items()} | {'epoch': epoch},
                       step=trainer.step)
            if is_eval_step:
                # rank 0 validates alone, on the unsharded model; every rank
                # steps its learning rate on its validation loss
                val_metrics = None
                if dist.is_main:
                    hists = histogram_summary(_drop_style(trainer.psp.named_parameters()),
                                              'Weights')
                    hists.update(histogram_summary(_drop_style(grads), 'Gradients'))
                    val_metrics = evaluate(trainer, val_loader, eval_options)
                val_loss, = pdist.broadcast_values(
                    val_metrics and [val_metrics['validation loss']], 1, dist.group)
                set_learning_rate(trainer.optimizer, trainer.sched.step(val_loss))
                if dist.is_main:
                    val_metrics['lr'] = trainer.sched.lr
                    logging.info('Validation: %s', val_metrics)
                    logger.log({**val_metrics, **hists}, step=trainer.step)
        if dist.is_main:
            ckpt.save_state(run_dir, 'G', epoch + 1, trainer.state_dict())
            logging.info('Checkpoint epoch %d saved under %s', epoch + 1, run_dir)
    profiler.close()
    logger.close()
    return trainer


def main(argv=None):
    args = get_args(argv)
    dist = start(args)
    try:
        trainer = Trainer(args, dist)
        train_loader, val_loader = reference_loaders(args, dist, True, True)
        return train_net(trainer, train_loader, val_loader, args)
    finally:
        pdist.shutdown()


if __name__ == '__main__':
    main()
