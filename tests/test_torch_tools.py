"""The port's tools on the CPU: the parity report (the JAX package's four
tests of tools/parity_report.py, for the port, at the same tolerances, and
one synthetic asset), the kernel validation with ``--device cpu`` (the plain
versions against the float64 references), and the trace readers on a
synthetic card-format trace and on a real CPU trace from ``ProfileWindow``.
Without CUDA, both device tools exit non-zero unless given ``--device cpu``.
"""

import json

import pytest
import torch
import torch.nn.functional as F

from face_mask_inpaint_tpu_torch.losses.vgg import VGG16Features
from face_mask_inpaint_tpu_torch.tools import parity_report, trace_sweep, trace_top
from face_mask_inpaint_tpu_torch.tools import validate_kernels
from face_mask_inpaint_tpu_torch.utils.profiling import ProfileWindow

no_cuda = pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only exit")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- parity report ---------------------------------------------------------------

def test_harness_smoke_empty_assets(tmp_path):
    """No assets: every inventory row reports 'asset missing', the report is
    written, exit code 0: the harness itself must not require assets."""
    out = tmp_path / "report.json"
    rc = parity_report.main(["--assets", str(tmp_path), "--out", str(out), "--skip_inference",
                             "--device", "cpu"])
    assert rc == 0
    report = json.loads(out.read_text())
    names = [n for n, _ in parity_report._PATTERNS]
    assert set(report["convert"]) == set(names)
    assert all(v["status"] == "asset missing" for v in report["convert"].values())
    assert report["inference"] == {} and report["activations"] == {}
    assert report["device"] == "cpu"


def test_discover_prefers_first_pattern(tmp_path):
    (tmp_path / "latest_net_G.pth").write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "model_ir_se50.pth").write_bytes(b"x")
    found = parity_report.discover(str(tmp_path))
    assert found["picnet_g"].endswith("latest_net_G.pth")
    assert found["ir_se50"].endswith("model_ir_se50.pth")
    assert "psp" not in found


def test_offline_module_fixture_parity():
    """The committed recorded-torch fixtures (tests/fixtures/parity/*.npz)
    through the port's modules and converter within the JAX test's
    tolerances: StyledConv (upsample), one IR-SE bottleneck, VGG block 1 and
    the LPIPS lin-head stage."""
    report = {}
    parity_report.module_fixture_parity(parity_report.DEFAULT_FIXTURE_DIR, report)
    rows = report["module_fixtures"]
    assert set(rows) == set(parity_report._FIXTURE_RUNNERS)
    tol = {"styled_conv_up": 5e-4, "irse_bottleneck": 5e-4, "vgg_block1": 2e-4,
           "lpips_lin": 1e-5}
    for name, row in rows.items():
        assert row["status"] == "ok", (name, row)
        assert row["max_abs_diff"] < tol[name], (name, row)


def test_module_fixtures_missing_dir_reports(tmp_path):
    report = {}
    parity_report.module_fixture_parity(str(tmp_path), report)
    assert all(v["status"] == "fixture missing" for v in report["module_fixtures"].values())


def test_parity_report_converts_an_asset(tmp_path):
    """A torchvision-layout vgg16 file is found, converted and loaded
    strictly into the port's VGG16Features, whose parameters it counts; the
    rest are missing."""
    g = torch.Generator().manual_seed(0)
    chans = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256), (256, 256),
             (512, 256), (512, 512), (512, 512)]
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21]
    sd = {}
    for i, (co, ci) in zip(idx, chans):
        sd[f"features.{i}.weight"] = torch.randn(co, ci, 3, 3, generator=g) * 0.01
        sd[f"features.{i}.bias"] = torch.zeros(co)
    torch.save(sd, tmp_path / "vgg16_test.pth")
    out = tmp_path / "report.json"
    assert parity_report.main(["--assets", str(tmp_path), "--out", str(out),
                               "--skip_inference", "--device", "cpu"]) == 0
    row = json.loads(out.read_text())["convert"]["vgg16"]
    assert row["status"] == "converted", row
    n = sum(p.numel() for p in VGG16Features().parameters())
    assert row["port_params"] == row["n_params"] == n and row["n_arrays"] == 20


@no_cuda
def test_parity_report_needs_cuda_by_default(tmp_path, capsys):
    assert parity_report.main(["--assets", str(tmp_path), "--out",
                               str(tmp_path / "r.json")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "r.json").exists()


# -- kernel validation ------------------------------------------------------------

def test_validate_kernels_cpu_all_ok(tmp_path, capsys):
    out = tmp_path / "kv.json"
    assert validate_kernels.main(["--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"kernel_validation": True, "device": "cpu", "path": str(out)}
    report = json.loads(out.read_text())
    assert report["all_ok"] and "plain versions" in report["kernels"]
    ids = ["K1", "K2", "K3", "K4a", "K4b", "K5", "K6", "K6_bwd", "K7a", "K7b", "RES"]
    assert list(report["checks"]) == ids
    for name, row in report["checks"].items():
        assert row["ok"], (name, row)
        for dtype in ("float32", "bfloat16"):
            assert row[dtype]["rel_diff"] <= row[dtype]["tol"], (name, dtype, row)
        assert row["float32"]["rel_diff"] < 1e-5, (name, row)  # the plain versions sum in f32
        assert not any(row["launches"].values()), (name, row)  # no kernel on the CPU


def test_validate_kernels_check_fails_on_a_wrong_kernel(monkeypatch):
    """A negative control: K7a's plain version with the slope of the wrong
    sign misses the reference."""
    from face_mask_inpaint_tpu_torch.kernels import fused_act as act

    plain = act.fused_leaky_relu_plain
    monkeypatch.setattr(act, "fused_leaky_relu_plain",
                        lambda x, b=None, s=0.2, sc=act.SQRT2: plain(x, b, -s, sc))
    res = validate_kernels.check_k7a(torch.float32, "cpu")
    assert res["rel_diff"] > 0.1


@no_cuda
def test_validate_kernels_needs_cuda_by_default(tmp_path, capsys):
    assert validate_kernels.main(["--out", str(tmp_path / "kv.json")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


# -- trace readers ------------------------------------------------------------------

def _op(name, ext, ts, dur, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": {"External id": ext, **args}}


def _gpu(cat, name, ext, corr, ts, dur):
    """A device event; without ``ext`` it carries only its correlation."""
    args = {"correlation": corr, "device": 0}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": args}


def _runtime(ext, corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
            "ts": ts, "dur": 2, "args": {"External id": ext, "correlation": corr}}


def synthetic_card_trace(steps=3, spans=False):
    """Steps of a card-format trace: a cuDNN conv (an aten::conv2d with the
    profiler's count, its kernels launched from aten::cudnn_convolution inside
    it: a transpose and the GEMM, the GEMM found through its launch's
    correlation), K6 and K7a with no count, a copy. With ``spans``, each step
    also lies inside the port's ``fmi.*`` ranges, as host user annotations
    and their shadows on the device timeline."""
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for s in range(steps):
        t, e = 10_000 * s, 100 * s
        if spans:
            events += [
                {"ph": "X", "cat": "user_annotation", "name": f"fmi.{n}", "pid": 1, "tid": 1,
                 "ts": t - 5, "dur": 2200, "args": {"External id": e + 90 + i}}
                for i, n in enumerate(("step", "generator"))]
            events += [_gpu("gpu_user_annotation", f"fmi.{n}", e + 90 + i, e + 90 + i, t + 500,
                            1700) for i, n in enumerate(("step", "generator"))]
        events += [
            _op("aten::conv2d", e + 1, t, 400, flops=4e9, **{"Input type": ["c10::BFloat16"]}),
            _op("aten::cudnn_convolution", e + 2, t + 10, 300),
            _runtime(e + 2, e + 50, t + 20), _runtime(e + 2, e + 51, t + 30),
            _gpu("kernel", "nchwToNhwcKernel", e + 2, e + 50, t + 500, 50),
            _gpu("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", None, e + 51, t + 560, 1000),
            _op("fmi::upfirdn2d", e + 3, t + 600, 20),
            _gpu("kernel", "void upfirdn2d_kernel<float, 2, 1>(...)", e + 3, e + 52, t + 1600, 300),
            _op("fmi::fused_leaky_relu", e + 4, t + 700, 20),
            _gpu("kernel", "fwd_kernel", e + 4, e + 53, t + 1900, 200),
            _gpu("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", e + 5, e + 54, t + 2100, 5),
        ]
    return {"traceEvents": events}


@pytest.mark.parametrize("spans", [False, True], ids=["no_spans", "fmi_spans"])
def test_trace_readers_on_a_card_format_trace(tmp_path, capsys, spans):
    """The same sums with and without the port's spans: their host ranges and
    device shadows are no kernels and no ops."""
    (tmp_path / "run" / "a").mkdir(parents=True)
    (tmp_path / "run" / "a" / "trace.json").write_text(
        json.dumps(synthetic_card_trace(spans=spans)))
    tot, cnt, kind = trace_top.op_totals(trace_top.load_trace_events(tmp_path)[0])
    assert kind == trace_top.DEVICE_KIND
    assert tot["sm90_xmma_fprop_implicit_gemm_bf16"] == 3000 and cnt["fwd_kernel"] == 3
    assert "aten::conv2d" not in tot and tot["Memcpy HtoD (Pageable -> Device)"] == 15
    secs, n_exec = trace_top.device_op_stats(tmp_path)
    assert secs == pytest.approx(3 * 1555e-6) and n_exec == 3
    assert trace_top.main([str(tmp_path), "3"]) == 0
    out = capsys.readouterr().out
    assert "read: device kernels" in out and "upfirdn2d_kernel" in out

    agg, path, kind = trace_sweep.sweep(str(tmp_path))
    assert path.name == "trace.json" and kind == trace_top.DEVICE_KIND
    conv = agg["aten::conv2d [c10::BFloat16]"]
    assert conv["flops"] == 3 * 4e9 and conv["calls"] == 3 and conv["ms"] == pytest.approx(3.15)
    assert conv["kernels"].most_common(1)[0][0] == "sm90_xmma_fprop_implicit_gemm_bf16"
    assert "nchwToNhwcKernel" not in agg  # the conv's transpose is in the conv's row
    for name in ("void upfirdn2d_kernel<float, 2, 1>(...)", "fwd_kernel"):
        assert agg[name]["flops"] == 0.0 and agg[name]["calls"] == 3, name
    assert trace_sweep.main([str(tmp_path), "--min-ms", "0"]) == 0
    out = capsys.readouterr().out
    assert "3.8 TF/s" in out and "fwd_kernel" in out  # 12 GFLOP in 3.15 ms; K7a at 0


def test_trace_readers_on_a_cpu_profile_window(tmp_path, capsys):
    """A real ProfileWindow trace of a few convs on the CPU: no device
    events, so both readers take the top-level CPU ops; the trace carries
    the profiler's flop counts."""
    window = ProfileWindow(str(tmp_path / "prof"), num_steps=3, start_step=1)
    x, w = torch.randn(2, 4, 12, 12), torch.randn(6, 4, 3, 3)
    for step in range(5):
        window.tick(step)
        F.leaky_relu(F.conv2d(x, w, padding=1))
    window.close()
    events, path = trace_top.load_trace_events(tmp_path)
    assert path.parent.name == "prof"
    flops = [e["args"]["flops"] for e in events
             if e.get("cat") == "cpu_op" and e["name"] == "aten::conv2d"]
    assert flops == [2 * 2 * 6 * 144 * 4 * 9] * 3
    tot, cnt, kind = trace_top.op_totals(events)
    assert kind == trace_top.CPU_KIND and cnt["aten::conv2d"] == 3
    assert "aten::convolution" not in cnt  # nested ops are not top-level
    assert trace_top.device_op_stats(tmp_path)[1] == 3
    assert trace_top.main([str(tmp_path)]) == 0
    assert "read: top-level CPU ops" in capsys.readouterr().out
    agg, _, kind = trace_sweep.sweep(str(tmp_path))
    assert kind == trace_top.CPU_KIND
    (conv,) = [r for r in agg.values() if r["op"] == "aten::conv2d"]
    assert conv["flops"] == 3 * flops[0] and conv["calls"] == 3 and conv["dtype"] == "float"
    assert conv["dims"].startswith("[2, 4, 12, 12]x[6, 4, 3, 3]")
    assert agg["aten::leaky_relu"]["flops"] == 0 and agg["aten::leaky_relu"]["calls"] == 3
    assert trace_sweep.main([str(tmp_path), "--min-ms", "0", "--max-frac", "1"]) == 0
    assert "read: top-level CPU ops" in capsys.readouterr().out


def test_trace_top_without_a_trace(tmp_path, capsys):
    assert trace_top.main([str(tmp_path)]) == 1
    assert trace_top.device_op_stats(tmp_path) == (0.0, 0)
    with pytest.raises(FileNotFoundError):
        trace_sweep.sweep(str(tmp_path))
