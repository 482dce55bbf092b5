"""Gated end-to-end parity report of the port against real pretrained checkpoints.

Port of face_mask_inpaint_tpu/tools/parity_report.py, with the same flags
and report keys plus ``--device``. Point it at a directory with the
reference's ``.pth`` files and it converts each one, loads it into the port's
module, runs the port's inference CLIs on a fixture set and writes
SSIM/MS-SSIM (and FID with the InceptionV3 weights), with per-module
differences from recorded reference activations where given. It downloads
nothing: with no assets it reports what it lacks and exits 0.

    python -m face_mask_inpaint_tpu_torch.tools.parity_report --assets DIR
        [--data_root DIR] [--activations ACTS.npz] [--out parity_report.json]
        [--skip_inference] [--device cuda|cpu]

Asset discovery (file name patterns, first match wins), each converted by
the port's ``tools/convert_torch.py`` and loaded by ``convert.py``:
  mask detector   *mask_detector*.pth | MODEL.pth      -> MaskDetector
  PICNet G/E/D    latest_net_G/E/D.pth                 -> converted (the CLI merges it)
  PICNet trained  *PICNet*G_checkpoint*.pth            -> converted (the CLI merges it)
  pSp combined    *psp*G_checkpoint*.pth | *pSp*.pth   -> PSP
  ArcFace         model_ir_se50.pth                    -> Backbone
  StyleGAN2 FFHQ  stylegan2-ffhq-config-f.pt           -> Generator
  VGG16           vgg16*.pth                           -> VGG16Features
  InceptionV3     *inception*.pth                      -> InceptionV3Features (enables FID)

Recorded activations (.npz from the reference): "<module>:input" and
"<module>:output" NCHW arrays for module in {mask_detector, irse, psp}.
The committed recorded-torch fixtures (tests/fixtures/parity/*.npz) need no
asset: ``module_fixture_parity`` runs them through the port's StyledConv
(K6 and K7a on the card), an IR-SE bottleneck, VGG block 1 and the LPIPS lin
stage.

``--device`` defaults to ``cuda`` and the tool exits 2 without CUDA unless
``--device cpu`` is given; the CLIs it runs get the same ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch import nn

from face_mask_inpaint_tpu_torch import convert
from face_mask_inpaint_tpu_torch.tools import convert_torch as ct

__all__ = ["discover", "convert_all", "activation_parity", "module_fixture_parity", "main",
           "DEFAULT_FIXTURE_DIR"]

_PATTERNS = [
    ("mask_detector", ["*mask_detector*.pth", "MODEL.pth"]),
    ("picnet_g", ["latest_net_G.pth", "*PICNet*G_checkpoint*.pth"]),
    ("picnet_e", ["latest_net_E.pth"]),
    ("picnet_d", ["latest_net_D.pth"]),
    ("psp", ["*psp*G_checkpoint*.pth", "*pSp*.pth", "*RefpSp*.pth"]),
    ("ir_se50", ["model_ir_se50.pth"]),
    ("stylegan2_ffhq", ["stylegan2-ffhq-config-f.pt"]),
    ("vgg16", ["vgg16*.pth"]),
    ("inception_v3", ["*inception*.pth", "*inception*.pt"]),
]


def discover(assets_dir: str) -> dict:
    found = {}
    for name, pats in _PATTERNS:
        for pat in pats:
            hits = sorted(glob.glob(os.path.join(assets_dir, "**", pat), recursive=True))
            if hits:
                found[name] = hits[0]
                break
    return found


def _tree_stats(tree) -> dict:
    leaves = list(convert._leaves(tree))
    return {"n_arrays": len(leaves),
            "n_params": int(sum(np.asarray(a).size for _, a in leaves))}


def _psp(variables) -> nn.Module:
    """The PSP whose keys the converted tree fills: with or without the
    encoder's attention, whichever loads strictly."""
    from face_mask_inpaint_tpu_torch.models.psp import PSP

    err = None
    for attention in (False, True):
        model = PSP(output_size=1024, start_from_latent_avg=True, use_attention=attention,
                    init=False)
        try:
            model.load_state_dict(convert.convert_psp(model, variables), strict=True)
            return model
        except (KeyError, RuntimeError, AttributeError) as e:
            err = e
    raise err


def _port_module(name: str, out) -> nn.Module | None:
    """The port's module loaded strictly from the converted tree ``out``, or
    None for the PICNet files (the inference CLI merges them by key and
    shape into a model its flags choose)."""
    from face_mask_inpaint_tpu_torch.evaluations.fid import InceptionV3Features
    from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
    from face_mask_inpaint_tpu_torch.models.irse import Backbone
    from face_mask_inpaint_tpu_torch.models.stylegan2 import Generator
    from face_mask_inpaint_tpu_torch.models.unet import MaskDetector

    if name == "psp":
        return _psp(out)
    builders = {
        "mask_detector": (lambda: MaskDetector(3, bilinear=True), convert.convert_mask_detector),
        "ir_se50": (lambda: Backbone(112, 50, "ir_se"), convert.convert_backbone),
        "stylegan2_ffhq": (lambda: Generator(1024), convert.convert_stylegan2_generator),
        "vgg16": (VGG16Features, convert.convert_vgg16),
        "inception_v3": (InceptionV3Features, convert.convert_inception),
    }
    if name not in builders:
        return None
    build, to_state = builders[name]
    model = build()
    model.load_state_dict(to_state(model, out), strict=True)
    return model.eval()


_CONVERTERS = {
    "mask_detector": ct.convert_unet,
    "picnet_g": ct.convert_picnet_module,
    "picnet_e": ct.convert_picnet_module,
    "picnet_d": ct.convert_picnet_module,
    "psp": ct.convert_psp,
    "ir_se50": ct.convert_irse_backbone,
    "stylegan2_ffhq": ct.convert_stylegan2_generator,
    "vgg16": ct.convert_vgg16_features,
    "inception_v3": ct.convert_inception_v3,
}


def convert_all(found: dict, report: dict) -> dict:
    """Convert every discovered asset and load it into the port's module;
    returns {name: the loaded module, or the converted tree for PICNet's}.
    Each entry reports the converted tree's arrays and values and the port
    module's parameter count (``port_params``)."""
    converted = {}
    for name, path in found.items():
        entry = {"path": path}
        try:
            out = _CONVERTERS[name](ct.load_torch_state_dict(path))
            module = _port_module(name, out)
            entry.update(status="converted", **_tree_stats(out))
            entry["port_params"] = (None if module is None
                                    else int(sum(p.numel() for p in module.parameters())))
            converted[name] = out if module is None else module
        except Exception as e:  # report, don't abort the whole run
            entry.update(status="error", error=f"{type(e).__name__}: {e}")
        report["convert"][name] = entry
    for name, _ in _PATTERNS:
        if name not in found:
            report["convert"][name] = {"status": "asset missing"}
    return converted


def _diff_row(got: np.ndarray, want: np.ndarray) -> dict:
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    denom = np.maximum(np.abs(want.astype(np.float64)), 1e-3)
    return {"status": "ok", "max_abs_diff": float(diff.max()),
            "max_rel_diff": float((diff / denom).max()), "mean_abs_diff": float(diff.mean())}


def activation_parity(npz_path: str, converted: dict, report: dict,
                      device: str = "cpu") -> None:
    """Per-module max-abs diff against recorded reference activations (NCHW)."""
    data = np.load(npz_path)
    mods = sorted({k.split(":")[0] for k in data.files if ":" in k})
    for mod in mods:
        try:
            x = torch.from_numpy(np.asarray(data[f"{mod}:input"], np.float32)).to(device)
            want = np.asarray(data[f"{mod}:output"], np.float32)
            with torch.no_grad():
                if mod == "mask_detector" and "mask_detector" in converted:
                    got = converted["mask_detector"].to(device)(x.permute(0, 2, 3, 1))
                    got = got.permute(0, 3, 1, 2)
                elif mod == "irse" and "ir_se50" in converted:
                    got = converted["ir_se50"].to(device)(x)
                    want = want.reshape(tuple(got.shape))
                elif mod == "psp" and "psp" in converted:
                    got = converted["psp"].to(device)(x.permute(0, 2, 3, 1), resize=True,
                                                      randomize_noise=False)
                    got = got.permute(0, 3, 1, 2)
                else:
                    report["activations"][mod] = {"status": "no converter/asset"}
                    continue
            report["activations"][mod] = _diff_row(got.float().cpu().numpy(), want)
        except Exception as e:
            report["activations"][mod] = {"status": "error",
                                          "error": f"{type(e).__name__}: {e}"}


def _load_fixture(path: str):
    """Split a fixture .npz into (torch-layout state dict, inputs, outputs)
    per the key convention of tests/fixtures/make_parity_fixtures.py."""
    data = np.load(path)
    sd = {k[3:]: np.asarray(data[k]) for k in data.files if k.startswith("sd:")}
    ins = {k[3:]: np.asarray(data[k]) for k in data.files if k.startswith("in:")}
    outs = {k[4:]: np.asarray(data[k]) for k in data.files if k.startswith("out:")}
    return sd, ins, outs


def _loaded(module: nn.Module, variables: dict, device: str) -> nn.Module:
    module.load_state_dict(convert.state_dict_from_jax(module, variables), strict=True)
    return module.eval().to(device)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _fixture_styled_conv_up(sd, ins, device):
    from face_mask_inpaint_tpu_torch.models.stylegan2 import StyledConv

    w = sd["blk.conv.weight"]  # [1, Cout, Cin, k, k]
    mod = StyledConv(w.shape[2], w.shape[1], w.shape[3],
                     sd["blk.conv.modulation.weight"].shape[1], upsample=True)
    mod = _loaded(mod, {"params": ct._styled_conv(sd, "blk")}, device)
    return mod(_t(ins["x"], device), _t(ins["style"], device), _t(ins["noise"], device))


def _fixture_irse_bottleneck(sd, ins, device):
    from face_mask_inpaint_tpu_torch.models.irse import BottleneckIR

    params, stats = ct._split_bn(ct._irse_unit(sd, "unit"))
    depth, in_c = sd["unit.res_layer.1.weight"].shape[:2]
    mod = _loaded(BottleneckIR(in_c, depth, 2, use_se=True),
                  {"params": params, "batch_stats": stats}, device)
    return mod(_t(ins["x"], device))


class _Block1(nn.Module):
    """VGG16 block 1: conv1_1, ReLU, conv1_2, ReLU (torchvision features[:4])."""

    def __init__(self):
        super().__init__()
        from face_mask_inpaint_tpu_torch.nn.layers import Conv2d

        self.conv1_1 = Conv2d(3, 64, 3, padding=1)
        self.conv1_2 = Conv2d(64, 64, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv1_2(torch.relu(self.conv1_1(x))))


def _fixture_vgg_block1(sd, ins, device):
    # the index -> name mapping of convert_vgg16_features' first block
    params = {name: {"kernel": ct.conv_w(sd[f"features.{idx}.weight"]),
                     "bias": sd[f"features.{idx}.bias"]}
              for name, idx in (("conv1_1", 0), ("conv1_2", 2))}
    return _loaded(_Block1(), {"params": params}, device)(_t(ins["x"], device))


def _fixture_lpips_lin(sd, ins, device):
    from face_mask_inpaint_tpu_torch.losses.lpips import LPIPSNet

    net = LPIPSNet("alex").to(device)
    n = 0
    while f"feat{n}_a" in ins:
        getattr(net, f"lin{n}").weight.data.copy_(_t(sd[f"lin.{n}.1.weight"], device))
        n += 1
    return net.distance([_t(ins[f"feat{i}_a"], device) for i in range(n)],
                        [_t(ins[f"feat{i}_b"], device) for i in range(n)])


_FIXTURE_RUNNERS = {
    "styled_conv_up": _fixture_styled_conv_up,
    "irse_bottleneck": _fixture_irse_bottleneck,
    "vgg_block1": _fixture_vgg_block1,
    "lpips_lin": _fixture_lpips_lin,
}

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
# committed fixtures live here; module_fixture_parity takes another directory
DEFAULT_FIXTURE_DIR = os.path.join(_REPO_ROOT, "tests", "fixtures", "parity")


def module_fixture_parity(fix_dir: str, report: dict, device: str = "cpu") -> None:
    """Per-module max-abs diff against the committed recorded-torch fixtures
    (tests/fixtures/parity/*.npz), float32 on ``device``: the asset-free
    counterpart of activation_parity. Populates report['module_fixtures']."""
    out = report.setdefault("module_fixtures", {})
    for name, runner in _FIXTURE_RUNNERS.items():
        path = os.path.join(fix_dir, f"{name}.npz")
        if not os.path.exists(path):
            out[name] = {"status": "fixture missing", "path": path}
            continue
        try:
            sd, ins, outs = _load_fixture(path)
            with torch.no_grad():
                got = runner(sd, ins, device).float().cpu().numpy()
            out[name] = _diff_row(got, outs["y"] if "y" in outs else outs["distance"])
        except Exception as e:
            out[name] = {"status": "error", "error": f"{type(e).__name__}: {e}"}


def _read_metrics_csv(path: str) -> dict:
    with open(path) as f:
        lines = [ln.strip().split(",") for ln in f if ln.strip()]
    return dict(zip(lines[0], lines[-1]))


def _run_cli(cmd: list[str], report: dict, key: str, workdir: str, gt_dir: str | None,
             inception_pth: str | None, device: str) -> None:
    """Run an inference CLI of the port in ``workdir`` (it writes its images
    and in-loop SSIM/MS-SSIM to <cwd>/test_results/<run_name>/), then the
    port's test_evaluate over the saved images against ``gt_dir``:
    SSIM/MS-SSIM always, FID when the InceptionV3 weights were found."""
    entry: dict = {"cmd": " ".join(cmd)}
    env = dict(os.environ, PYTHONPATH=_REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, cwd=workdir,
                              env=env)
        entry["returncode"] = proc.returncode
        if proc.returncode != 0:
            entry["stderr_tail"] = proc.stderr[-2000:]
        gen_dirs = sorted(d for d in glob.glob(os.path.join(workdir, "test_results", "*"))
                          if os.path.isdir(d))
        if gen_dirs:
            entry["gen_dir"] = gen_dirs[-1]
            csv = os.path.join(gen_dirs[-1], "metrics.csv")
            if os.path.exists(csv):
                entry["in_loop_metrics"] = _read_metrics_csv(csv)
        if gt_dir and gen_dirs:
            opts = ["ssim", "ms_ssim"] + (["fid"] if inception_pth else [])
            ev = [sys.executable, "-m", "face_mask_inpaint_tpu_torch.cli.test_evaluate",
                  "--device", device,
                  "--data_root", os.path.dirname(os.path.abspath(gt_dir)),
                  "--gt_img_path", os.path.basename(gt_dir),
                  "--test_folder", gen_dirs[-1], "--eval_options", *opts]
            if inception_pth:
                ev += ["--inception_weights", inception_pth]
            proc2 = subprocess.run(ev, capture_output=True, text=True, timeout=3600,
                                   cwd=workdir, env=env)
            entry["eval_returncode"] = proc2.returncode
            if proc2.returncode != 0:
                entry["eval_stderr_tail"] = proc2.stderr[-2000:]
            csv = os.path.join(gen_dirs[-1], "metrics.csv")
            if os.path.exists(csv):
                entry["dataset_metrics"] = _read_metrics_csv(csv)
    except Exception as e:
        entry["error"] = f"{type(e).__name__}: {e}"
    report["inference"][key] = entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets", required=True,
                    help="directory containing the real .pth checkpoints")
    ap.add_argument("--data_root", default=None,
                    help="CelebA(HQ)-style fixture tree for the inference CLIs")
    ap.add_argument("--src_img_path", default="images_masked_test")
    ap.add_argument("--ref_img_path", default="images")
    ap.add_argument("--mask_path", default="binary_map")
    ap.add_argument("--identity_file_path", default="CelebA-HQ-identity.txt")
    ap.add_argument("--gt_dir", default=None,
                    help="ground-truth image dir for FID (defaults to "
                         "<data_root>/<ref_img_path>)")
    ap.add_argument("--activations", default=None, help=".npz of recorded torch activations")
    ap.add_argument("--out", default="parity_report.json")
    ap.add_argument("--skip_inference", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the modules and the CLIs run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("parity_report: CUDA is not available (pass --device cpu)", file=sys.stderr)
        return 2

    report = {"assets_dir": args.assets, "device": args.device, "convert": {},
              "activations": {}, "inference": {}}
    found = discover(args.assets)
    converted = convert_all(found, report)

    if args.activations:
        activation_parity(args.activations, converted, report, args.device)

    if args.data_root and not args.skip_inference:
        gt = os.path.abspath(args.gt_dir or os.path.join(args.data_root, args.ref_img_path))
        inception = found.get("inception_v3")
        data_flags = [
            "--device", args.device,
            "--data_root", os.path.abspath(args.data_root),
            "--src_img_path", args.src_img_path,
            "--ref_img_path", args.ref_img_path,
            "--mask_path", args.mask_path,
            "--identity_file_path", args.identity_file_path,
        ]
        if "picnet_g" in found and "mask_detector" in found:
            _run_cli(
                [sys.executable, "-m", "face_mask_inpaint_tpu_torch.cli.picnet_inference",
                 *data_flags,
                 "--mask_detector_path", os.path.abspath(found["mask_detector"]),
                 "--pt_ckpt_path", os.path.abspath(found["picnet_g"]),
                 "--img_scale", "0.25", "--use_att", "1", "--batch_size", "4",
                 "--decoder_img_f", "256", "--decoder_z_nc", "256"],
                report, "picnet", tempfile.mkdtemp(prefix="parity_picnet_"), gt, inception,
                args.device)
        if "psp" in found and "mask_detector" in found:
            _run_cli(
                [sys.executable, "-m", "face_mask_inpaint_tpu_torch.cli.psp_inference",
                 *data_flags,
                 "--mask_detector_path", os.path.abspath(found["mask_detector"]),
                 "--pt_ckpt_path", os.path.abspath(found["psp"]),
                 "--use_ref", "--use_attention", "1", "--batch_size", "4"],
                report, "psp", tempfile.mkdtemp(prefix="parity_psp_"), gt, inception,
                args.device)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    ok = [k for k, v in report["convert"].items() if v.get("status") == "converted"]
    missing = [k for k, v in report["convert"].items() if v.get("status") == "asset missing"]
    print(f"parity report -> {args.out}: {len(ok)} converted ({', '.join(ok) or 'none'}); "
          f"missing: {', '.join(missing) or 'none'}")
    for k, v in report["inference"].items():
        print(f"  {k}: in_loop={v.get('in_loop_metrics')} dataset={v.get('dataset_metrics')}")
    for k, v in report["activations"].items():
        print(f"  act {k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
