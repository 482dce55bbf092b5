"""Train the Stack A ReferenceFill GAN: the port of ``train_reference_fill.py``
with its flags and defaults, on one device.

    python -m face_mask_inpaint_tpu_torch.cli.train_reference_fill \\
        --data_root <celeba root> --run_name <name> [--device cuda]

Two Adam optimizers, the GANOptimizer losses (lsgan + L1 + VGG perceptual,
style and contextual; train/gan.py), an eval round every
n_train // (10 * batch) steps with the D/G validation losses and SSIM
(and MS-SSIM), both plateau trackers stepped on the validation losses,
weight and gradient histograms on eval steps, per-epoch G/D checkpoints under
``<checkpoint_path>/<run_name>/`` and ``--resume`` from the latest of them
(train/checkpoint.py). Metrics go to ``<checkpoint_path>/<run_name>/
metrics.jsonl``.

``--device`` defaults to cuda and fails when CUDA is absent; ``--device
cpu`` runs on the CPU. ``--seed`` seeds the weights, the shuffle and the
latent noise. ``--compute_dtype bfloat16`` (the default) is bf16-mixed:
float32 parameters, optimizer state and loss reductions, bfloat16 compute.
``--vgg_weights`` loads a torchvision ``vgg16`` ``.pth``; without it the VGG
losses use random features, with a warning. ``--pt_ckpt_path`` names a
directory of reference ``latest_net_{G,E,D}.pth``: each file present is read
and converted with ``convert_picnet_module`` and nothing is loaded, as
``train_reference_fill.py:161-178`` does on purpose (the reference's warm
start is a no-op). ``--eval_options fid`` accumulates the InceptionV3
activations of the ground truth and the generated images over the
validation round into one Fréchet distance, with ``--inception_weights`` (a
torchvision ``inception_v3``) or, without them, a random InceptionV3 from
``--seed``. ``--encoder_type drn`` trains ReferenceFill with two DRN-C-42
encoders (their BatchNorm on the batch statistics, the running ones moved
once a step, as the JAX step moves them) and a decoder without its latent
branch; it clears ``--pt_ckpt_path``, as ``train_reference_fill.py:128-129``
does.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import torch

from face_mask_inpaint_tpu_torch.convert import read_checkpoint, vgg16_state_dict_from_torchvision
from face_mask_inpaint_tpu_torch.data.loader import get_reference_dataloader
from face_mask_inpaint_tpu_torch.evaluations.fid import FIDAccumulator, build_inception
from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.models.picnet import define_d
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_picnet_module
from face_mask_inpaint_tpu_torch.train import checkpoint as ckpt
from face_mask_inpaint_tpu_torch.train.gan import make_gan_eval_step, make_gan_train_step
from face_mask_inpaint_tpu_torch.train.optim import PlateauTracker, adam, set_learning_rate
from face_mask_inpaint_tpu_torch.utils.metrics_logger import MetricsLogger, histogram_summary
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow, add_profile_args

__all__ = ["get_args", "process_params", "build_models", "read_picnet_checkpoints", "Trainer",
           "main"]

def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=5, help='Number of epochs')
    parser.add_argument('--batch_size', dest='batch_size', type=int, default=8)
    parser.add_argument('--learning_rate', type=float, default=1e-5)
    parser.add_argument('--eval_options', nargs="+", default={'ssim'})
    parser.add_argument('--debug', type=int, default=0,
                        help='debug with turning off not implemented parts')
    parser.add_argument('--img_scale', type=float, default=1.)

    parser.add_argument('--run_name', type=str, default='', help='exp name')
    parser.add_argument('--checkpoint_path', type=str, default='saved_model')
    parser.add_argument('--mask_detector_path', type=str, default='')
    parser.add_argument('--data_root', type=str, default='/data/mohaa/project1/CelebA')
    parser.add_argument('--src_img_path', type=str, default='img_align_celeba_masked1')
    parser.add_argument('--ref_img_path', type=str, default='img_align_celeba')
    parser.add_argument('--mask_path', type=str, default='binary_map')
    parser.add_argument('--identity_file_path', type=str, default='identity_CelebA.txt')
    parser.add_argument('--use_best_reference', type=int, default=0)
    parser.add_argument('--pt_ckpt_path', type=str, default='')

    parser.add_argument('--encoder_type', type=str, default='pluralistic',
                        choices=['pluralistic', 'drn'])
    parser.add_argument('--encoder_ngf', type=int, default=32, help='base filters')
    parser.add_argument('--encoder_z_nc', type=int, default=128, help='z_nc')
    parser.add_argument('--encoder_img_f', type=int, default=128, help='final filters')
    parser.add_argument('--encoder_layers', type=int, default=5)
    parser.add_argument('--encoder_norm', type=str, default='none')
    parser.add_argument('--encoder_activation', type=str, default='LeakyReLU')
    parser.add_argument('--encoder_init_type', type=str, default='orthogonal')

    parser.add_argument('--decoder_ngf', type=int, default=32, help='base filters')
    parser.add_argument('--decoder_z_nc', type=int, default=128, help='z_nc')
    parser.add_argument('--decoder_img_f', type=int, default=128, help='final filters')
    parser.add_argument('--decoder_L', type=int, default=0, help='z layers')
    parser.add_argument('--decoder_layers', type=int, default=5)
    parser.add_argument('--decoder_norm', type=str, default='instance')
    parser.add_argument('--decoder_activation', type=str, default='LeakyReLU')
    parser.add_argument('--decoder_init_type', type=str, default='orthogonal')

    parser.add_argument('--disc_ndf', type=int, default=32, help='base filters')
    parser.add_argument('--disc_layers', type=int, default=5)
    parser.add_argument('--disc_model_type', type=str, default='ResDis')
    parser.add_argument('--disc_init_type', type=str, default='orthogonal')

    parser.add_argument('--use_att', type=int, default=1, help='whether to use attention')

    parser.add_argument('--vgg_weights', type=str, default='',
                        help='torchvision vgg16 .pth for the VGG losses')
    parser.add_argument('--use_wandb', type=int, default=0)
    parser.add_argument('--out_size', type=int, default=256)
    parser.add_argument('--resume', type=int, default=0,
                        help='resume from the latest checkpoint under '
                             '<checkpoint_path>/<run_name> (full state)')
    parser.add_argument('--inception_weights', type=str, default='',
                        help='torchvision inception_v3 .pth for the fid eval option')
    parser.add_argument('--compute_dtype', type=str, default='bfloat16',
                        choices=['float32', 'bfloat16'],
                        help='compute precision of the G/D/VGG passes; parameters, '
                             'optimizer state and loss reductions stay float32')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the weights, the shuffle and the latent noise')
    add_profile_args(parser)
    args = parser.parse_args(argv)

    args.src_img_path = os.path.join(args.data_root, args.src_img_path)
    args.ref_img_path = os.path.join(args.data_root, args.ref_img_path)
    args.mask_path = os.path.join(args.data_root, args.mask_path)
    args.identity_file_path = os.path.join(args.data_root, args.identity_file_path)
    if args.encoder_type != 'pluralistic':
        args.pt_ckpt_path = ''
    return args


def process_params(args):
    """Prefix-split argparse namespace (train_reference_fill.py:88-104)."""
    kwargs = vars(args)
    encoder_params = {k.replace('encoder_', ''): v for k, v in kwargs.items()
                      if k.startswith('encoder')}
    decoder_params = {k.replace('decoder_', ''): v for k, v in kwargs.items()
                      if k.startswith('decoder')}
    disc_params = {k.replace('disc_', ''): v for k, v in kwargs.items()
                   if k.startswith('disc')}
    disc_params['img_f'] = encoder_params['img_f']
    return encoder_params, decoder_params, disc_params


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return device


def load_vgg(path: str, generator: torch.Generator) -> VGG16Features:
    vgg = init_weights(VGG16Features(), generator)
    if path and Path(path).is_file():
        sd = torch.load(path, map_location="cpu", weights_only=True)
        vgg.load_state_dict(vgg16_state_dict_from_torchvision(sd), strict=True)
        logging.info('Loaded VGG16 weights from %s', path)
    else:
        logging.warning('No pretrained VGG16 weights (--vgg_weights); '
                        'perceptual/style/contextual losses use random features')
    return vgg


def build_models(args, device: torch.device):
    """(generator, discriminator, vgg) with weights from ``--seed``, on
    ``device``, G and D in training mode."""
    encoder_params, decoder_params, disc_params = process_params(args)
    dtype = getattr(torch, args.compute_dtype)
    weights = torch.Generator().manual_seed(args.seed)
    generator = ReferenceFill(encoder_params, decoder_params, use_att=bool(args.use_att),
                              out_size=(args.out_size, args.out_size), dtype=dtype,
                              generator=weights)
    discriminator = init_weights(define_d(input_nc=3, **disc_params), weights)
    vgg = load_vgg(args.vgg_weights, weights)
    return (generator.to(device).train(), discriminator.to(device).train(),
            vgg.to(device).eval())


def read_picnet_checkpoints(path: str) -> list[str]:
    """The reference's warm start (train_reference_fill.py:107-140, JAX
    :161-178): each ``latest_net_{G,E,D}.pth`` under ``path`` is read and
    converted, and nothing is loaded, since the reference's shape-matched
    partial load copies the current tensors. Returns the files converted."""
    done = []
    for name in ('G', 'E', 'D'):
        file = os.path.join(path, f'latest_net_{name}.pth') if path else ''
        if not os.path.isfile(file):
            continue
        logging.info('Converting PICNet checkpoint %s (not loaded: the reference\'s '
                     'warm start is a no-op)', file)
        state = read_checkpoint(file, f'PICNet {name}')
        convert_picnet_module({k: v.numpy() for k, v in state.items()})
        done.append(file)
    return done


def _to_device(batch: dict, device: torch.device) -> dict:
    b = {k: batch[k].to(device, non_blocking=True)
         for k in ("src_img", "gt_img", "ref_img")}
    b["mask"] = (batch["mask"] > 0).float().to(device, non_blocking=True)
    return b


class Trainer:
    """The models, their optimizers and plateau trackers, the step counter
    and the noise generator: the port's counterpart of ``GANTrainState``.
    ``state_dicts``/``load_state_dicts`` are what a checkpoint holds."""

    def __init__(self, args, device: torch.device):
        self.device = device
        self.generator, self.discriminator, self.vgg = build_models(args, device)
        self.g_opt = adam(self.generator.parameters(), args.learning_rate)
        self.d_opt = adam(self.discriminator.parameters(), args.learning_rate)
        # ReduceLROnPlateau parity: mode 'max' on the val losses, as the
        # reference quirkily uses it (train_reference_fill.py:310-319)
        self.sched_g = PlateauTracker(args.learning_rate, mode='max', patience=2, factor=0.8)
        self.sched_d = PlateauTracker(args.learning_rate, mode='max', patience=2, factor=0.8)
        self.noise = torch.Generator(device=device).manual_seed(args.seed)
        self.step = 0
        self.train_step = make_gan_train_step(self.generator, self.discriminator, self.vgg,
                                              self.g_opt, self.d_opt)
        self.eval_step = make_gan_eval_step(self.generator, self.discriminator, self.vgg)
        self.inception = None
        if 'fid' in set(args.eval_options):
            self.inception = build_inception(
                args.inception_weights, device, torch.Generator().manual_seed(args.seed),
                'fid eval uses a randomly initialized InceptionV3 (--inception_weights '
                'unset); values are relative only')

    def state_dicts(self) -> tuple[dict, dict]:
        g = {'model': self.generator.state_dict(), 'opt': self.g_opt.state_dict(),
             'sched': self.sched_g.state_dict(), 'step': self.step,
             'rng': self.noise.get_state()}
        d = {'model': self.discriminator.state_dict(), 'opt': self.d_opt.state_dict(),
             'sched': self.sched_d.state_dict()}
        return g, d

    def load_state_dicts(self, g: dict, d: dict) -> None:
        self.generator.load_state_dict(g['model'])
        self.discriminator.load_state_dict(d['model'])
        self.g_opt.load_state_dict(g['opt'])
        self.d_opt.load_state_dict(d['opt'])
        self.sched_g.load_state_dict(g['sched'])
        self.sched_d.load_state_dict(d['sched'])
        self.step = int(g['step'])
        self.noise.set_state(g['rng'].cpu())

    def set_learning_rates(self, val_metrics: dict) -> None:
        """Step both trackers on the val losses (train_reference_fill.py:403-404)."""
        set_learning_rate(self.d_opt, self.sched_d.step(val_metrics['D validation loss']))
        set_learning_rate(self.g_opt, self.sched_g.step(val_metrics['G validation loss']))


def evaluate(trainer: Trainer, val_loader, eval_options: set, step: int):
    """Mean val losses (and SSIM, MS-SSIM) over the val loader, with noise
    from a generator seeded by the step, and the first sample pair; with
    'fid', one Fréchet distance of the whole round's activations."""
    metrics = {'D validation loss': 0.0, 'G validation loss': 0.0}
    fid = FIDAccumulator(trainer.inception) if 'fid' in eval_options else None
    noise = torch.Generator(device=trainer.device).manual_seed(step)
    n, sample = 0, None
    for batch in val_loader:
        b = _to_device(batch, trainer.device)
        out = trainer.eval_step(b, noise=noise)
        metrics['D validation loss'] += float(out['D_loss'])
        metrics['G validation loss'] += float(out['G_loss'])
        gen, gt = out['gen'].float(), b['gt_img']
        if sample is None:
            sample = (gen[0].cpu().numpy(), gt[0].cpu().numpy())
        if 'ssim' in eval_options:
            metrics['ssim'] = metrics.get('ssim', 0.0) + float(ssim(gt, gen))
        if 'ms_ssim' in eval_options and gen.shape[1] > 160:
            metrics['ms_ssim'] = metrics.get('ms_ssim', 0.0) + float(ms_ssim(gt, gen))
        if fid is not None:
            fid.add(gt, gen)
        n += 1
    metrics = {k: v / max(n, 1) for k, v in metrics.items()}
    if fid is not None and fid.gt:
        metrics['fid'] = fid.value()
    return metrics, sample


def train_net(trainer: Trainer, train_loader, val_loader, args):
    run_dir = ckpt.checkpoint_dir(args.checkpoint_path, args.run_name)
    logger = MetricsLogger(run_dir, 'reference_fill', args.run_name, config=vars(args),
                           use_wandb=bool(args.use_wandb))
    if len(train_loader) == 0:
        raise SystemExit(f'train loader is empty: need at least one batch of {args.batch_size}')
    n_train = len(train_loader.dataset)
    logging.info('Starting training: epochs=%d batch=%d lr=%g train=%d', args.epochs,
                 args.batch_size, args.learning_rate, n_train)
    read_picnet_checkpoints(args.pt_ckpt_path)
    if args.mask_detector_path:
        logging.info('Mask detector checkpoint noted at %s (training uses GT masks, as '
                     'the reference does)', args.mask_detector_path)

    start_epoch = 0
    if args.resume:
        last = ckpt.latest_epoch(run_dir, 'G')
        if last is None:
            logging.warning('--resume set but no checkpoint under %s; starting fresh', run_dir)
        else:
            trainer.load_state_dicts(ckpt.restore_state(run_dir / f'G_checkpoint_epoch{last}'),
                                     ckpt.restore_state(run_dir / f'D_checkpoint_epoch{last}'))
            start_epoch = last
            logging.info('Resumed from epoch %d (step %d, lr G=%g D=%g)', last, trainer.step,
                         trainer.sched_g.lr, trainer.sched_d.lr)

    eval_options = set(args.eval_options)
    profiler = ProfileWindow(args.profile_dir, args.profile_steps)
    division_step = max(n_train // (10 * args.batch_size), 1)
    for epoch in range(start_epoch, args.epochs):
        for batch in train_loader:
            profiler.tick(trainer.step)
            b = _to_device(batch, trainer.device)
            is_eval_step = (trainer.step + 1) % division_step == 0
            metrics = trainer.train_step(b, noise=trainer.noise, return_grads=is_eval_step)
            trainer.step += 1
            logger.log({'D loss': float(metrics['D_loss']), 'G loss': float(metrics['G_loss']),
                        'perceptual loss': float(metrics['perc_loss']),
                        'style loss': float(metrics['style_loss']),
                        'contextual loss': float(metrics['cx_loss']), 'epoch': epoch},
                       step=trainer.step)
            if is_eval_step:
                hists = histogram_summary(trainer.generator.named_parameters(), 'Weights/G')
                hists.update(histogram_summary(trainer.discriminator.named_parameters(),
                                               'Weights/D'))
                hists.update(histogram_summary(metrics['g_grads'], 'Gradients/G'))
                hists.update(histogram_summary(metrics['d_grads'], 'Gradients/D'))
                val_metrics, sample = evaluate(trainer, val_loader, eval_options, trainer.step)
                trainer.set_learning_rates(val_metrics)
                val_metrics['lr G'] = trainer.sched_g.lr
                val_metrics['lr D'] = trainer.sched_d.lr
                logging.info('Validation: %s', val_metrics)
                logger.log({**val_metrics, **hists}, step=trainer.step)
                if sample is not None:
                    logger.log_image('gen', sample[0], step=trainer.step)
                    logger.log_image('gt', sample[1], step=trainer.step)
        g_state, d_state = trainer.state_dicts()
        ckpt.save_state(run_dir, 'G', epoch + 1, g_state)
        ckpt.save_state(run_dir, 'D', epoch + 1, d_state)
        logging.info('Checkpoint epoch %d saved under %s', epoch + 1, run_dir)
    profiler.close()
    logger.close()
    return trainer


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(levelname)s: %(message)s')
    device = resolve_device(args.device)
    logging.info('Using device %s', device)
    trainer = Trainer(args, device)
    train_loader, val_loader = get_reference_dataloader(
        args.src_img_path, args.ref_img_path, args.mask_path, args.identity_file_path,
        args.batch_size, apply_transform=False, val_amount=0.1, img_scale=args.img_scale,
        use_ssim=bool(args.use_best_reference), device=device, seed=args.seed,
        pin_memory=device.type == "cuda")
    return train_net(trainer, train_loader, val_loader, args)


if __name__ == '__main__':
    main()
