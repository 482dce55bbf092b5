"""Serving demo, the port of ``gradio_serve.py``: ModelInterface and a web UI.

    python -m face_mask_inpaint_tpu_torch.cli.gradio_serve --selftest [--device cuda]

``ModelInterface`` preprocesses (256^2 BICUBIC resize, normalize to
[-1, 1]), infers (mask detector on (src + 1) / 2, pSp with the reference,
the mask and the fixed noise) and postprocesses ((gen + 1) / 2 and the mask
rescaled to the source's size, uint8). The models are built once, on
``--device`` (cuda by default), and every request reuses them.

gradio is optional: without it, ``--selftest`` runs one inference through
the serving path and exits, and ``ModelInterface.infer`` serves
programmatically.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from face_mask_inpaint_tpu_torch.cli.picnet_inference import resolve_device
from face_mask_inpaint_tpu_torch.cli.psp_inference import build_models
from face_mask_inpaint_tpu_torch.ops.resize import scale_img

__all__ = ["ModelInterface", "get_args", "main"]


class ModelInterface:
    """gradio_serve.py:14-77: preprocess, infer, postprocess."""

    def __init__(self, args, device: torch.device):
        self.device = device
        self.mask_detector, self.generator = build_models(args, device)

    @torch.inference_mode()
    def _infer(self, src: torch.Tensor, ref: torch.Tensor):
        src_mask = self.mask_detector.predict_mask((src + 1) / 2)
        gen = self.generator(src, ref, src_mask, resize=True, randomize_noise=False)
        return gen, src_mask

    def preprocess_img(self, img):
        """PIL image -> ([1, 256, 256, C] in [-1, 1] on the device, (H, W))."""
        from PIL import Image

        org_size = (img.size[1], img.size[0])
        arr = np.asarray(img.resize((256, 256), resample=Image.BICUBIC))
        if arr.ndim == 2:
            arr = arr[..., None]
        arr = (arr / 255.0 - 0.5) / 0.5
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)[None], org_size

    @staticmethod
    def tensor2im(img_hwc: np.ndarray) -> np.ndarray:
        img = np.clip(np.asarray(img_hwc, np.float32), 0.0, 1.0)
        return (img * 255).astype('uint8')

    def infer(self, src_img, ref_img):
        """Two PIL images -> (inpainted image, mask), uint8 [H, W, 3] at the
        source's size."""
        src, src_size = self.preprocess_img(src_img)
        ref, _ = self.preprocess_img(ref_img)
        gen, mask = self._infer(src, ref)
        gen = scale_img(((gen.float() + 1) / 2).permute(0, 3, 1, 2), src_size)
        mask3 = scale_img(mask[:, None].expand(-1, 3, -1, -1), src_size)
        return (self.tensor2im(gen[0].permute(1, 2, 0).cpu().numpy()),
                self.tensor2im(mask3[0].permute(1, 2, 0).cpu().numpy()))


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pt_ckpt_path',
                        default='saved_model/RefpSp_train_decoder/G_checkpoint_epoch5.pth',
                        type=str, help='Path to pretrained pSp model checkpoint')
    parser.add_argument('--mask_detector_path',
                        default='saved_model/new_mask_detector.pth', type=str,
                        help='Path to pretrained mask detector checkpoint')
    parser.add_argument('--use_attention', default=0, type=int, help='use attention')

    # pSp args: DO NOT MODIFY
    parser.add_argument('--use_ref', default=1, type=int, help='use reference image')
    parser.add_argument('--encoder_type', type=str, default='GradualStyleEncoder')
    parser.add_argument('--output_size', default=1024, type=int,
                        help='Output size of generator')
    parser.add_argument('--train_decoder', default=0, type=int,
                        help='Whether to train the decoder model')
    parser.add_argument('--start_from_latent_avg', type=int, default=1,
                        help='Whether to add average latent vector')
    parser.add_argument('--learn_in_w', type=int, default=0,
                        help='Whether to learn in w space instead of w+')
    parser.add_argument('--stylegan_weights', default=None, type=str,
                        help='Path to StyleGAN model weights')
    parser.add_argument('--selftest', action='store_true',
                        help='run one inference through the serving path and exit')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device; 'cpu' must be asked for explicitly")
    parser.add_argument('--seed', type=int, default=0, help='seed of the random weights')
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(levelname)s: %(message)s')
    model = ModelInterface(args, resolve_device(args.device))

    if args.selftest:
        from PIL import Image

        rng = np.random.RandomState(0)
        src = Image.fromarray(rng.randint(0, 255, (300, 260, 3), dtype=np.uint8))
        ref = Image.fromarray(rng.randint(0, 255, (300, 260, 3), dtype=np.uint8))
        gen, mask = model.infer(src, ref)
        print('selftest ok:', gen.shape, gen.dtype, mask.shape)
        return gen, mask

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit('gradio is not installed; use --selftest or call '
                         'ModelInterface.infer programmatically')

    iface = gr.Interface(
        fn=model.infer,
        inputs=[gr.Image(image_mode="RGB", type="pil", label="Image with mask"),
                gr.Image(image_mode="RGB", type="pil", label="Image of the same person")],
        outputs=[gr.Image(label="Unmasked Image"), gr.Image(label="Mask Region")],
        title='Remove Facial Mask Demo')
    iface.launch(share=True)


if __name__ == '__main__':
    main()
