"""Core layers: convs with optional spectral norm, norms, activations.

Port of face_mask_inpaint_tpu/nn/layers.py over NCHW tensors with OIHW conv
and IOHW transposed-conv weights. Parameters stay float32; each layer casts
them to the input's dtype, so a bfloat16 input runs the layer in bfloat16, as
the JAX layers do with ``dtype=bfloat16``.

Spectral norm keeps ``u`` and ``v`` as buffers in the JAX package's layout
(``u`` over the matrix's columns, ``v`` over its rows): one power iteration
runs on every call, train or eval, and ``u``/``v`` are written back only in
training mode (layers.py:130-161).

Weights are set by ``init_weights(module, generator)`` (which the top-level
models call) or by ``load_state_dict``; constructors only allocate.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from face_mask_inpaint_tpu_torch.kernels import norm_act as na
from face_mask_inpaint_tpu_torch.ops.conv import conv2d, conv_transpose2d
from face_mask_inpaint_tpu_torch.parallel import dist as _dp

__all__ = ["get_initializer", "get_activation", "Activation", "PReLU", "Conv2d",
           "ConvTranspose2d", "Dense", "BatchNorm2d", "InstanceNorm2d", "make_norm",
           "init_weights", "LEAKY_SLOPE"]

LEAKY_SLOPE = 0.1  # the reference registry's LeakyReLU slope (base_function.py:61)


def get_initializer(init_type: str, gain: float = 0.02) -> Callable:
    """Weight initializer registry (base_function.py:13-38); each returned
    function fills ``w`` in place from ``generator`` given its fan-in.
    ``lecun_normal`` is flax's default for layers built without one."""
    if init_type == "normal":
        return lambda w, fan_in, g: nn.init.normal_(w, 0.0, gain, generator=g)
    if init_type == "xavier":
        return lambda w, fan_in, g: nn.init.xavier_normal_(w, gain, generator=g)
    if init_type == "kaiming":
        return lambda w, fan_in, g: nn.init.normal_(
            w, 0.0, math.sqrt(2.0 / fan_in), generator=g)
    if init_type == "orthogonal":
        return lambda w, fan_in, g: nn.init.orthogonal_(w, gain, generator=g)
    if init_type == "lecun_normal":
        # truncated at 2 std, rescaled so the std is 1/sqrt(fan_in); drawn
        # as standard normals with those beyond 2 dropped (4.6% of them),
        # several times faster than nn.init.trunc_normal_ for the pSp
        # encoder's 10^8 weights
        def lecun(w, fan_in, g):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            kept, n = [], 0
            while n < w.numel():
                r = torch.randn(int((w.numel() - n) * 1.06) + 64, generator=g,
                                device=w.device, dtype=w.dtype)
                kept.append(r[r.abs() <= 2.0])
                n += kept[-1].numel()
            return w.copy_(torch.cat(kept)[:w.numel()].view_as(w) * std)
        return lecun
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def get_activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Parameter-free activation for the registry name (not PReLU)."""
    if kind == "ReLU":
        return F.relu
    if kind == "SELU":
        return F.selu
    if kind == "LeakyReLU":
        return lambda x: F.leaky_relu(x, LEAKY_SLOPE)
    raise NotImplementedError(f"activation layer [{kind}] is not found")


class Activation(nn.Module):
    """Registry-dispatched parameter-free activation."""

    def __init__(self, kind: str = "ReLU"):
        super().__init__()
        self.fn = get_activation(kind)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class PReLU(nn.Module):
    """torch.nn.PReLU with one slope a channel (dim 1), from 0.25
    (layers.py:74-89)."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_parameters))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.alpha.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha * x)


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class _SpectralMixin:
    """One power iteration from the stored ``u``. The weight is matricized
    as the JAX package does it: OIHW conv and IOHW convT weights both become
    ``weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])``, i.e. HWIO
    rows against output columns for a conv, and the torch ConvTranspose2d
    matricization ``[in, out*k*k]`` (transposed) for a convT."""

    def _init_spectral(self, rows: int, cols: int) -> None:
        self.register_buffer("u", torch.empty(cols))
        self.register_buffer("v", torch.empty(rows))

    def _reset_spectral(self, generator) -> None:
        with torch.no_grad():
            self.u.copy_(_l2normalize(torch.randn(self.u.shape, generator=generator)))
            self.v.copy_(_l2normalize(torch.randn(self.v.shape, generator=generator)))

    def _spectral_normalize(self, w: torch.Tensor) -> torch.Tensor:
        w_mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        acc = torch.promote_types(w.dtype, torch.float32)  # f32, or f64 for f64 weights
        with torch.no_grad():
            w32 = w_mat.to(acc)
            v = _l2normalize(w32 @ self.u)
            u = _l2normalize(w32.t() @ v)
            if self.training:
                self.u.copy_(u)
                self.v.copy_(v)
        sigma = torch.einsum("w,wo,o->", v, w_mat.to(acc), u)
        return w / sigma.to(w.dtype)


class Conv2d(nn.Module, _SpectralMixin):
    """Conv2d with torch padding semantics and optional spectral norm;
    ``kernel_size`` and ``padding`` are an int or an (h, w) pair."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride: int = 1, padding=0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, use_spect: bool = False,
                 init_type: str = "lecun_normal"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.use_spect = use_spect
        self.init_type = init_type
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        if use_spect:
            self._init_spectral(kh * kw * (in_channels // groups), out_channels)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            get_initializer(self.init_type)(self.weight, self.weight[0].numel(), generator)
            if self.bias is not None:
                self.bias.zero_()
        if self.use_spect:
            self._reset_spectral(generator)

    def effective_weight(self) -> torch.Tensor:
        return self._spectral_normalize(self.weight) if self.use_spect else self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return conv2d(x, self.effective_weight().to(x.dtype), b, self.stride,
                      self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.Module, _SpectralMixin):
    """torch-semantics transposed conv (IOHW weight) with optional spectral
    norm; ResBlockDecoder uses k=3, s=2, p=1, op=1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 bias: bool = True, use_spect: bool = False,
                 init_type: str = "lecun_normal"):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.use_spect = use_spect
        self.init_type = init_type
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        if use_spect:
            self._init_spectral(k * k * out_channels, in_channels)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            k = self.weight.shape[-1]
            get_initializer(self.init_type)(self.weight, self.weight.shape[0] * k * k,
                                            generator)
            if self.bias is not None:
                self.bias.zero_()
        if self.use_spect:
            self._reset_spectral(generator)

    def effective_weight(self) -> torch.Tensor:
        return self._spectral_normalize(self.weight) if self.use_spect else self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return conv_transpose2d(x, self.effective_weight().to(x.dtype), b, self.stride,
                                self.padding, self.output_padding)


class Dense(nn.Module):
    """Linear layer (layers.py:375-403) with the torch [out, in] weight
    (the JAX kernel is [in, out]), lecun-normal, with bias. No spectral
    norm: nothing in the port uses it."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            get_initializer("lecun_normal")(self.weight, self.weight.shape[1], generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.Module):
    """torch BatchNorm2d(eps=1e-5, affine) with flax's training semantics.

    Eval mode normalizes with the running statistics. Training mode is the
    JAX package's ``BatchNorm2d``, a ``flax.linen.BatchNorm(momentum=0.9)``
    (layers.py:406-429), not torch's: it normalizes with the batch mean and
    the biased batch variance E[x^2] - E[x]^2 (clipped at 0), both in f32
    (f64 for an f64 input), and moves each running statistic 0.1 of the way
    to the batch's, the variance being the same biased one (torch would
    store the unbiased).

    Inside a data-parallel train step (``parallel.dist.data_parallel``) the
    per-channel sums of x and x^2 and the count are summed over the ranks,
    differentiably, so every rank normalizes with the global batch's moments
    and moves its running statistics alike, as the JAX step's statistics
    over the sharded global batch do.
    """

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(x.dtype),
                                self.running_var.to(x.dtype), self.weight.to(x.dtype),
                                self.bias.to(x.dtype), False, 0.0, self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if _dp.active() is None:
            mean = x32.mean(dim=dims)
            var = torch.clamp_min((x32 * x32).mean(dim=dims) - mean * mean, 0.0)
        else:
            c = x32.shape[1]
            sums = _dp.all_reduce_sum(torch.cat([
                x32.sum(dim=dims), (x32 * x32).sum(dim=dims),
                x32.new_full((1,), x32.numel() // c)]))
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp_min(sums[c:2 * c] / sums[2 * c] - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.detach().to(self.running_var.dtype), self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class InstanceNorm2d(nn.Module):
    """torch InstanceNorm2d(affine=True, eps=1e-5), no running stats.

    ``fuse_act`` ('LeakyReLU' | 'ReLU') fuses the following activation: the
    normalization then runs as kernel K2 (kernels/norm_act.py), the port of
    the JAX package's ``norm_act.set_impl("pallas")`` configuration.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 fuse_act: Optional[str] = None, act_slope: float = LEAKY_SLOPE):
        super().__init__()
        self.eps, self.affine = eps, affine
        self.fuse_act, self.act_slope = fuse_act, act_slope
        if affine:
            self.weight = nn.Parameter(torch.empty(num_features))
            self.bias = nn.Parameter(torch.empty(num_features))
        else:
            self.weight = self.bias = None

    def reset_parameters(self, generator=None) -> None:
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_act is not None and self.affine:
            return na.instance_norm_act(x.contiguous(), self.weight, self.bias,
                                        self.fuse_act, self.act_slope, self.eps)
        y = na.instance_norm_act_plain(x, self.weight, self.bias, "none", 0.0, self.eps)
        if self.fuse_act == "LeakyReLU":
            return F.leaky_relu(y, self.act_slope)
        if self.fuse_act == "ReLU":
            return F.relu(y)
        return y


def make_norm(norm_type: str, num_features: int) -> Optional[nn.Module]:
    """Norm registry (base_function.py:41-51); None for 'none'."""
    if norm_type == "batch":
        return BatchNorm2d(num_features)
    if norm_type == "instance":
        return InstanceNorm2d(num_features)
    if norm_type == "none":
        return None
    raise NotImplementedError(f"normalization layer [{norm_type}] is not found")


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every layer of ``module`` from ``generator``, in module
    order (the explicit-generator counterpart of flax ``init``)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
