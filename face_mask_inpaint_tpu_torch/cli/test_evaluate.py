"""Offline metrics over a folder of generated images: the port of
``test_evaluate.py`` with its flags and output.

    python -m face_mask_inpaint_tpu_torch.cli.test_evaluate \\
        --test_folder test_results/<run> --data_root <celeba-hq root> \\
        --inception_weights <inception_v3 .pth> [--device cuda]

For each ``gen_<id>.jpg`` in ``--test_folder`` the ground truth
``<data_root>/<gt_img_path>/<id>.jpg`` is read at ``--gt_scale``; SSIM and
MS-SSIM are averaged over the images, and FID is one Fréchet distance of
the InceptionV3 activations of the whole set (test_evaluate.py:72-121).
Without ``--inception_weights`` fid is skipped with a warning, as in the
JAX CLI. Writes ``<test_folder>/metrics.csv`` with the ``csv`` module, in
the JAX CLI's column order, one row.

``--device`` defaults to cuda and fails when CUDA is absent; ``--device
cpu`` runs on the CPU. The images and InceptionV3 run on ``--device``; the
Fréchet distance runs on the host.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.cli.picnet_inference import resolve_device
from face_mask_inpaint_tpu_torch.data.dataset import _load, _preprocess
from face_mask_inpaint_tpu_torch.evaluations.fid import FIDAccumulator, build_inception
from face_mask_inpaint_tpu_torch.evaluations.ssim import ms_ssim, ssim
from face_mask_inpaint_tpu_torch.utils.metrics_logger import write_metrics_csv

__all__ = ["get_args", "load_images", "main"]


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--eval_options', nargs="+", default=['ssim', 'ms_ssim', 'fid'])
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--data_root', type=str, default='/data/mohaa/project1/CelebAHQ')
    parser.add_argument('--gt_img_path', type=str, default='images')
    parser.add_argument('--test_folder', type=str, default='')
    parser.add_argument('--specific_img', nargs="+", default={})
    parser.add_argument('--inception_weights', type=str, default='',
                        help='torchvision inception_v3 .pth for FID')
    parser.add_argument('--gt_scale', type=float, default=0.25)
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    args = parser.parse_args(argv)
    args.gt_img_path = os.path.join(args.data_root, args.gt_img_path)
    return args


def load_images(args, test_id):
    gt = _preprocess(_load(Path(args.gt_img_path) / f'{test_id}.jpg'), args.gt_scale, False)
    gen = _preprocess(_load(Path(args.test_folder) / f'gen_{test_id}.jpg'), 1.0, False)
    return gt, gen


def main(argv=None) -> dict:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(levelname)s: %(message)s')
    device = resolve_device(args.device)

    test_ids = [os.path.basename(x).split('.')[0].split('_')[1]
                for x in os.listdir(args.test_folder) if x.startswith('gen')]
    if args.specific_img:
        test_ids = list(args.specific_img)

    options = set(args.eval_options)
    fid = None
    if 'fid' in options:
        if args.inception_weights and Path(args.inception_weights).is_file():
            fid = FIDAccumulator(build_inception(args.inception_weights, device))
        else:
            logging.warning('fid requested but no --inception_weights; skipping fid')
            options.discard('fid')

    eval_results = {k: 0.0 for k in options if k in ('ssim', 'ms_ssim')}
    for i in range(0, len(test_ids), args.batch_size):
        batch_ids = test_ids[i:i + args.batch_size]
        pairs = [load_images(args, bid) for bid in batch_ids]
        gt = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
        gen = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
        if 'ssim' in options:
            eval_results['ssim'] += float(ssim(gt, gen)) * len(batch_ids)
        if 'ms_ssim' in options:
            eval_results['ms_ssim'] += float(ms_ssim(gt, gen)) * len(batch_ids)
        if 'fid' in options:
            fid.add(gt, gen)  # gen, read from 8-bit files, is in [0, 1] already

    eval_results = {k: [v / len(test_ids)] for k, v in eval_results.items()}
    if 'fid' in options:
        eval_results['fid'] = [fid.value()]
    write_metrics_csv(os.path.join(args.test_folder, 'metrics.csv'), eval_results)
    return eval_results


if __name__ == '__main__':
    main()
