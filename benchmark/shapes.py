"""Layer shapes that follow from a configuration's sizes, for the kernels'
counts in ``metrics/roofline.<kernel>.py``."""

from __future__ import annotations

import math


def decoder_channels(dec: dict) -> list[int]:
    """ResGenerator: each decoder block's output channels (``decoder``)."""
    ngf, img_f, layers = dec["ngf"], dec["img_f"], dec["layers"]
    return [ngf * min(2 ** (layers - i - 1), img_f // ngf) for i in range(layers)]


def feature_side(config: dict, side: int) -> int:
    """ResGenerator: the encoders' feature side for ``side``-pixel images."""
    return side // 2 ** (1 + (config["encoder"]["layers"] - 1) // 2)


def stylegan_channels(config: dict) -> dict[int, int]:
    """StyleGAN2 (``psp``): side -> the synthesis network's channels there."""
    s = config["psp"].get("decoder_base_channels", 512) / 512
    m = config.get("channel_multiplier", 2)
    return {4: int(512 * s), 8: int(512 * s), 16: int(512 * s), 32: int(512 * s),
            64: int(256 * m * s), 128: int(128 * m * s), 256: int(64 * m * s),
            512: int(32 * m * s), 1024: int(16 * m * s)}


def stylegan_sides(config: dict) -> list[int]:
    """StyleGAN2: the sides from 8 up to ``psp.output_size``."""
    return [2 ** i for i in range(3, int(math.log2(config["psp"]["output_size"])) + 1)]
