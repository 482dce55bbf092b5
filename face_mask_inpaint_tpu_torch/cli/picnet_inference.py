"""Reference-guided inpainting inference (Stack A), the port of
``PICNet_inference.py`` with its flags and outputs.

    python -m face_mask_inpaint_tpu_torch.cli.picnet_inference \\
        --data_root <celeba root> --pt_ckpt_path <run>/model.pt [--device cuda]

For each batch: the mask from the UNet detector (argmax), ReferenceFill
generation, SSIM/MS-SSIM against the raw ground truth. Writes
``test_results/<run>/gen_<id>.jpg`` (and ``mask_<id>.jpg`` with
``--save_src_mask 1``) and ``metrics.csv`` with the dataset means.

Checkpoints go through the CLIs' loader (convert.py), which tells a file by
its content: the port's own state_dict loads strictly; a reference
checkpoint (``.pth`` or ``.pt``, as the JAX CLI reads both) converts as
``PICNet_inference.py:98-131`` does it. The detector's variables are
replaced whole by ``convert_unet`` (parameters and batch statistics); the
generator merges ``convert_picnet_module``'s parameters by key and shape and
keeps its own spectral ``u``/``v``, as the JAX CLI drops the checkpoint's. A
missing path means random weights from ``--seed``; an Orbax directory and
any other file raise.
``--encoder_type drn`` builds ReferenceFill with two DRN-C-42 encoders and a
decoder without its latent branch. ``--old_model 1`` is the reference's
CelebA-aligned path (``PICNet_inference.py:143-199``): after the mask is
predicted, the source, the reference and the mask are resized bilinearly to
218x178, the generator decodes without z (``no_prior``) and returns 218x178
images, and the ground truth is resized the same way before SSIM and
MS-SSIM.
``--use_best_reference 1`` takes each image's best-SSIM reference, scored on
``--device`` (or read from the dataset's cached map). ``--device`` defaults
to cuda and fails when CUDA is absent; ``--device cpu`` runs on the CPU.

``--profile_dir`` writes a ``torch.profiler`` Chrome trace of batches 2 to
``2 + --profile_steps`` (utils/profiling.py), as the JAX CLI traces its window.

``FMI_PACKED_CONVT=1`` in the environment, the JAX package's own switch,
builds the generator with ``packed_convt=True``: the decoder blocks above
``pack_threshold`` run their fused tail, kernels K4b and K4a.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from pathlib import Path

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint
from face_mask_inpaint_tpu_torch.data.dataset import ReferenceDataset
from face_mask_inpaint_tpu_torch.data.loader import DataLoader
from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
from face_mask_inpaint_tpu_torch.models.reference_fill import ReferenceFill
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.ops.resize import scale_img
from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_picnet_module, convert_unet
from face_mask_inpaint_tpu_torch.utils.images import mask2im, tensor2im
from face_mask_inpaint_tpu_torch.utils.metrics_logger import write_metrics_csv
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow, add_profile_args, spanned

__all__ = ["get_args", "process_params", "build_models", "make_infer_batch", "main"]

OLD_MODEL_SIZE = (218, 178)  # CelebA's aligned size, PICNet_inference.py:145


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_root', type=str, default='/data/mohaa/project1/CelebA')
    parser.add_argument('--src_img_path', type=str, default='img_align_celeba_masked1')
    parser.add_argument('--ref_img_path', type=str, default='img_align_celeba')
    parser.add_argument('--mask_path', type=str, default='binary_map')
    parser.add_argument('--identity_file_path', type=str, default='identity_CelebA.txt')
    parser.add_argument('--use_best_reference', type=int, default=0)
    parser.add_argument('--mask_detector_path', type=str,
                        default='saved_model/mask_detector.pth')
    parser.add_argument('--batch_size', default=8, type=int)
    parser.add_argument('--pt_ckpt_path', default='pretrained_models/psp_ffhq_encode.pt',
                        type=str, help='Path to pretrained model checkpoint')
    parser.add_argument('--img_scale', type=float, default=1.)
    parser.add_argument('--save_src_mask', type=int, default=0)

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

    parser.add_argument('--use_att', type=int, default=1, help='whether to use attention')
    parser.add_argument('--old_model', type=int, default=0)
    parser.add_argument('--out_size', type=int, default=256)
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the random weights and of the latent noise')
    add_profile_args(parser)
    args = parser.parse_args(argv)

    args.src_img_path = os.path.join(args.data_root, args.src_img_path)
    args.ref_img_path = os.path.join(args.data_root, args.ref_img_path)
    args.mask_path = os.path.join(args.data_root, args.mask_path)
    args.identity_file_path = os.path.join(args.data_root, args.identity_file_path)
    return args


def process_params(args):
    kwargs = vars(args)
    encoder_params = {k.replace('encoder_', ''): v for k, v in kwargs.items()
                      if k.startswith('encoder')}
    decoder_params = {k.replace('decoder_', ''): v for k, v in kwargs.items()
                      if k.startswith('decoder')}
    return encoder_params, decoder_params


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return device


def build_models(args, device: torch.device):
    """MaskDetector and ReferenceFill with weights from ``--seed`` or the
    checkpoints, on ``device``, in eval mode."""
    det_state = read_checkpoint(args.mask_detector_path, 'mask detector')
    gen_state = read_checkpoint(args.pt_ckpt_path, 'generator')
    encoder_params, decoder_params = process_params(args)
    decoder_params["packed_convt"] = os.environ.get("FMI_PACKED_CONVT") == "1"
    weights = torch.Generator().manual_seed(args.seed)
    detector = MaskDetector(n_channels=3, bilinear=True, generator=weights)
    out_size = OLD_MODEL_SIZE if args.old_model else (args.out_size, args.out_size)
    generator = ReferenceFill(encoder_params, decoder_params, use_att=bool(args.use_att),
                              out_size=out_size, generator=weights)
    if det_state is not None:
        load_checkpoint(detector, det_state, convert_unet, 'mask detector',
                        args.mask_detector_path)
    if gen_state is not None:
        load_checkpoint(generator, gen_state, convert_picnet_module, 'generator',
                        args.pt_ckpt_path, merge=('params',))
    return detector.to(device), generator.to(device)


def _scale_nhwc(x: torch.Tensor, size) -> torch.Tensor:
    return scale_img(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def make_infer_batch(detector: MaskDetector, generator: ReferenceFill,
                     old_model: bool = False):
    """The per-batch step: ``infer_batch(src, ref, noise)`` with src/ref
    [N, H, W, 3] in [0, 1] on the models' device and ``noise`` a
    torch.Generator on that device; returns (images [N, out, out, 3] in
    [-1, 1], masks [N, H, W]). With ``old_model`` the images, the mask and
    the output are 218x178 and the generator runs ``no_prior``
    (``PICNet_inference.py:167-176``)."""

    @torch.no_grad()
    @spanned("step")
    def infer_batch(src: torch.Tensor, ref: torch.Tensor, noise: torch.Generator):
        src_mask = detector.predict_mask(src)
        if old_model:
            src, ref = _scale_nhwc(src, OLD_MODEL_SIZE), _scale_nhwc(ref, OLD_MODEL_SIZE)
            src_mask = scale_img(src_mask[:, None], OLD_MODEL_SIZE)[:, 0]
        return generator(src, ref, src_mask, generator=noise, no_prior=old_model), src_mask

    return infer_batch


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(levelname)s: %(message)s')
    device = resolve_device(args.device)
    logging.info('Using device %s', device)
    detector, generator = build_models(args, device)
    infer_batch = make_infer_batch(detector, generator, bool(args.old_model))

    dataset = ReferenceDataset(args.src_img_path, args.ref_img_path, args.mask_path,
                               args.identity_file_path, apply_transform=False,
                               scale=args.img_scale,
                               use_ssim=bool(args.use_best_reference), return_id=True,
                               seed=args.seed, device=device)
    loader = DataLoader(dataset, args.batch_size, shuffle=False, drop_last=False,
                        pad_last=True, pin_memory=device.type == "cuda")

    run_name = os.path.split(os.path.split(str(args.pt_ckpt_path))[0])[1]
    out_dir = Path(f'test_results/{run_name}')
    out_dir.mkdir(parents=True, exist_ok=True)

    noise = torch.Generator(device=device).manual_seed(args.seed)
    profiler = ProfileWindow(args.profile_dir, args.profile_steps)
    eval_results = []
    for step, batch in enumerate(loader):
        profiler.tick(step)
        src = batch['src_img'].to(device, non_blocking=True)
        ref = batch['ref_img'].to(device, non_blocking=True)
        gen, src_mask = infer_batch(src, ref, noise)
        gt = batch['raw_gt_img'].to(device)
        if args.old_model:
            gt = _scale_nhwc(gt, OLD_MODEL_SIZE)
        s = float(ssim(gt, gen))
        ms = float(ms_ssim(gt, gen)) if gen.shape[1] > 160 else math.nan
        eval_results.append([s, ms])

        gen_np = gen.float().cpu().numpy()
        mask_np = src_mask.cpu().numpy()
        ids = batch['id'][:, 0].tolist()
        valid = batch.get('_valid')
        n_real = int(valid.sum()) if valid is not None else len(ids)
        for i in range(n_real):
            tensor2im(gen_np[i]).save(out_dir / f'gen_{ids[i]}.jpg')
            if args.save_src_mask:
                mask2im(mask_np[i]).save(out_dir / f'mask_{ids[i]}.jpg')

    profiler.close()
    means = np.array(eval_results).mean(0)
    write_metrics_csv(out_dir / 'metrics.csv', {'ssim': [means[0]], 'ms_ssim': [means[1]]})


if __name__ == '__main__':
    main()
