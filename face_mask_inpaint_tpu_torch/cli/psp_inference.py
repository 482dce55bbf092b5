"""Stack B inference (pSp -> StyleGAN2), the port of ``psp_inference.py`` with
its flags and outputs.

    python -m face_mask_inpaint_tpu_torch.cli.psp_inference \\
        --data_root <celeba-hq root> --use_ref [--use_attention 1] [--device cuda]

The data are fixed as in the JAX CLI: inputs scaled by 0.25 and normalized
to [-1, 1], references of best SSIM. For each batch: the mask from the UNet
detector on (src + 1) / 2, pSp with the fixed noise (as the JAX CLI runs it,
whatever ``--randomize_noise`` says), SSIM/MS-SSIM of (gen + 1) / 2 against
the raw ground truth. Writes ``test_results/<run>/gen_<id>.jpg`` (and
``mask_<id>.jpg`` with ``--save_src_mask 1``) and ``metrics.csv`` with the
dataset means.

Checkpoints go through the CLIs' loader (convert.py), which reads each file
before a model is built and tells it by its content: the port's own
state_dict loads strictly; a reference ``mask_detector.pth`` converts with
``convert_unet`` and replaces the detector's variables; a reference pSp
checkpoint (``.pt`` or ``.pth``) converts with ``convert_psp`` and merges by
key and shape, parameters, batch statistics, noises and the latent average,
as ``psp_inference.py:107-127`` does; a missing path warns and uses random
weights from ``--seed``; an Orbax directory or any other file raises.
``--split_jit`` is accepted for script compatibility and has no effect:
there is no jit under eager PyTorch. ``--device`` defaults to cuda and fails
when CUDA is absent; ``--device cpu`` runs on the CPU. The models are built
on ``--device``, their random weights drawn there.

``--profile_dir`` writes a ``torch.profiler`` Chrome trace of a window of
batches (utils/profiling.py), as the JAX CLI traces its window.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from pathlib import Path

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.cli.picnet_inference import resolve_device
from face_mask_inpaint_tpu_torch.convert import load_checkpoint, read_checkpoint
from face_mask_inpaint_tpu_torch.data.dataset import ReferenceDataset
from face_mask_inpaint_tpu_torch.data.loader import DataLoader
from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
from face_mask_inpaint_tpu_torch.models.psp import PSP
from face_mask_inpaint_tpu_torch.models.unet import MaskDetector
from face_mask_inpaint_tpu_torch.nn.layers import init_weights
from face_mask_inpaint_tpu_torch.tools.convert_torch import convert_psp, convert_unet
from face_mask_inpaint_tpu_torch.utils.images import mask2im, tensor2im
from face_mask_inpaint_tpu_torch.utils.metrics_logger import write_metrics_csv
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow, add_profile_args, spanned

__all__ = ["get_args", "build_models", "make_infer_batch", "main"]


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_root', type=str, default='/data/mohaa/project1/CelebAHQ')
    parser.add_argument('--identity_file_path', type=str, default='CelebA-HQ-identity.txt')
    parser.add_argument('--mask_path', type=str, default='binary_map')
    parser.add_argument('--src_img_path', type=str, default='images_masked_test')
    parser.add_argument('--ref_img_path', type=str, default='images')
    parser.add_argument('--mask_detector_path', type=str,
                        default='saved_model/mask_detector.pth')
    parser.add_argument('--batch_size', default=8, type=int)
    parser.add_argument('--pt_ckpt_path', default='pretrained_models/psp_ffhq_encode.pt',
                        type=str, help='Path to pretrained pSp model checkpoint')
    parser.add_argument('--save_src_mask', type=int, default=0)

    # pSp args
    parser.add_argument('--use_ref', action='store_true', help='use reference image')
    parser.add_argument('--use_attention', default=0, type=int, help='use attention')
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
    parser.add_argument('--stylegan_weights', default=None, type=str,
                        help='Path to StyleGAN model weights')
    add_profile_args(parser)
    parser.add_argument('--split_jit', default=-1, type=int,
                        help='accepted for compatibility with the JAX script; no effect: '
                             'there is no jit under eager PyTorch')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument('--seed', type=int, default=0, help='seed of the random weights')
    args = parser.parse_args(argv)

    args.src_img_path = os.path.join(args.data_root, args.src_img_path)
    args.ref_img_path = os.path.join(args.data_root, args.ref_img_path)
    args.mask_path = os.path.join(args.data_root, args.mask_path)
    args.identity_file_path = os.path.join(args.data_root, args.identity_file_path)
    return args


def build_models(args, device: torch.device):
    """MaskDetector and PSP with weights from ``--seed`` (drawn on
    ``device``) or the checkpoints, on ``device``, in eval mode. The
    checkpoints are read first, so a file that does not load raises before
    anything is built; the port's own pSp state dict sets every weight, so
    none is drawn for it."""
    det_state = read_checkpoint(args.mask_detector_path, 'mask detector')
    psp_state = read_checkpoint(args.pt_ckpt_path, 'pSp')
    weights = torch.Generator(device=device).manual_seed(args.seed)
    with torch.device(device):
        detector = MaskDetector(n_channels=3, bilinear=True, generator=weights)
        psp = PSP(encoder_type=args.encoder_type, output_size=args.output_size,
                  start_from_latent_avg=bool(args.start_from_latent_avg),
                  learn_in_w=bool(args.learn_in_w), use_attention=bool(args.use_attention),
                  generator=weights, init=False)
        if psp_state is None or set(psp_state) != set(psp.state_dict()):
            init_weights(psp, weights)
    if det_state is not None:
        load_checkpoint(detector, det_state, convert_unet, 'mask detector',
                        args.mask_detector_path)
    if psp_state is not None:
        load_checkpoint(psp, psp_state, lambda sd: convert_psp(sd, args.output_size), 'pSp',
                        args.pt_ckpt_path, merge=('params', 'batch_stats', 'noises',
                                                  'latent_avg'))
    return detector, psp.eval()


def make_infer_batch(detector: MaskDetector, psp: PSP, use_ref: bool):
    """The per-batch step: ``infer_batch(src, ref)`` with src/ref
    [N, H, W, 3] in [-1, 1] on the models' device; returns (images
    [N, 256, 256, 3] in about [-1, 1], masks [N, H, W]). With ``use_ref``
    the reference and the detected mask are fused in the encoder."""

    @torch.inference_mode()
    @spanned("step")
    def infer_batch(src: torch.Tensor, ref: torch.Tensor):
        src_mask = detector.predict_mask((src + 1) / 2)
        gen = psp(src, ref if use_ref else None, src_mask if use_ref else None,
                  resize=True, randomize_noise=False)
        return gen, src_mask

    return infer_batch


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(levelname)s: %(message)s')
    device = resolve_device(args.device)
    logging.info('Using device %s', device)
    detector, psp = build_models(args, device)
    infer_batch = make_infer_batch(detector, psp, args.use_ref)

    dataset = ReferenceDataset(args.src_img_path, args.ref_img_path, args.mask_path,
                               args.identity_file_path, apply_transform=True, scale=0.25,
                               use_ssim=True, return_id=True, seed=args.seed, device=device)
    loader = DataLoader(dataset, args.batch_size, shuffle=False, drop_last=False,
                        pad_last=True, pin_memory=device.type == "cuda")

    run_name = os.path.split(os.path.split(str(args.pt_ckpt_path))[0])[1]
    out_dir = Path(f'test_results/{run_name}')
    out_dir.mkdir(parents=True, exist_ok=True)

    profiler = ProfileWindow(args.profile_dir, args.profile_steps)
    eval_results = []
    for step, batch in enumerate(loader):
        profiler.tick(step)
        src = batch['src_img'].to(device, non_blocking=True)
        ref = batch['ref_img'].to(device, non_blocking=True)
        gen, src_mask = infer_batch(src, ref)
        gt = batch['raw_gt_img'].to(device)
        gen01 = (gen.float() + 1) / 2
        s = float(ssim(gt, gen01))
        ms = float(ms_ssim(gt, gen01)) if gen.shape[1] > 160 else math.nan
        eval_results.append([s, ms])

        gen_np = gen01.cpu().numpy()
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
