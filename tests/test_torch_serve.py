"""The port's HTTP sampling server, generate CLI and image helpers, on the
CPU (``--device cpu``), and the guard that the port never imports JAX.

The server is driven as the JAX package's ``tests/test_serve.py`` drives
its own: ``make_server`` on an ephemeral port in a thread, requests over
urllib.
"""

import io
import json
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from diffusion_model_universal_tpu.utils import images as jax_images
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts.serve import (build_argparser,
                                                           make_server)
from diffusion_model_universal_torch.utils import images

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = {"num_timesteps": 4, "image_size": 32, "in_channels": 3,
        "model_channels": 8, "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    ckpt = str(tmp / "model.ckpt")
    DDPM(TINY, device="cpu", seed=1).save(ckpt)
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"model_config": TINY}, f)
    return cfg_path, ckpt


def _args(files, *extra):
    cfg_path, ckpt = files
    return build_argparser().parse_args([
        "--config", cfg_path, "--model_type", "ddpm", "--checkpoint", ckpt,
        "--port", "0", "--serve_batch", "4", *extra])


@pytest.fixture(scope="module")
def server(files):
    srv = make_server(_args(files, "--device", "cpu"))
    srv.service.warmup()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def _post(srv, body: dict):
    req = urllib.request.Request(
        _url(srv, "/generate"), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _post_error(srv, body: dict):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, body)
    return e.value.code, json.loads(e.value.read())["error"]


def test_healthz(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["model"] == "ddpm"
    assert info["serve_batch"] == 4 and info["devices"] == 1
    assert info["requests"] >= 1   # the warmup


def test_generate_npy_shape_and_determinism(server):
    def fetch(seed, n=3):
        with _post(server, {"num_samples": n, "seed": seed,
                            "format": "npy"}) as r:
            assert r.headers["Content-Type"] == "application/octet-stream"
            return np.load(io.BytesIO(r.read()))

    a, b, c = fetch(5), fetch(5), fetch(6)
    assert a.shape == (3, 32, 32, 3) and a.dtype == np.float32
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)       # same seed → same images
    assert np.abs(a - c).max() > 0            # another seed differs
    np.testing.assert_array_equal(fetch(5, 1), a[:1])  # sliced from a batch


def test_generate_png_decodes(server):
    with _post(server, {"num_samples": 4, "seed": 1}) as r:
        assert r.headers["Content-Type"] == "image/png"
        body = r.read()
    grid = images.decode_png(body)
    assert grid.shape == (2 * 34 + 2, 2 * 34 + 2, 3)


@pytest.mark.parametrize("body,fragment", [
    ({"num_samples": 99}, "serve_batch"),
    ({"num_samples": 0}, "serve_batch"),
    ({"num_samples": 2, "format": "jpeg"}, "format"),
    ({"num_samples": None}, ""),
    ({"num_samples": 2, "sampler": "euler"}, "sampler must be one of"),
    # T = 4: DPM++'s default 20 steps and 5 strided steps exceed it.
    ({"num_samples": 2, "sampler": "dpm++"}, "num_steps must be in [2, 4]"),
    ({"num_samples": 2, "sampler": "strided", "sampler_steps": 5},
     "num_steps must be in [2, 4] (got 5)"),
    ({"num_samples": 2, "class_id": 3}, "model is unconditional"),
    ({"num_samples": 2, "class_id": 0, "guidance_scale": "x"},
     "model is unconditional"),
])
def test_generate_rejects_bad_or_unported_requests(server, body, fragment):
    code, error = _post_error(server, body)
    assert code == 400 and fragment in error


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert e.value.code == 404


@pytest.mark.parametrize("extra", [
    pytest.param(("--device", "cpu", "--num_devices", "2"),
                 id="extra0---num_devices"),
    pytest.param(("--device", "cpu", "--num_devices", "4"),
                 id="extra1---num_devices > 1 is not yet ported"),
])
def test_make_server_refuses_unported_options(files, extra):
    """The name is from when ``--num_devices > 1`` was refused. ``main``
    now reads it and spawns the ranks (``tests/test_torch_parallel.py``
    serves over two); ``make_server`` serves on the ranks this process
    has joined, here none: one rank (a spatial group of one), all rows
    of the serve batch."""
    srv = make_server(_args(files, *extra))
    try:
        assert srv.service.scope == (0, 1, None, 1)
        assert srv.service.scope.rows(4) == (0, 4, 4)
    finally:
        srv.server_close()


def test_server_defaults_to_cuda_and_raises_without_it(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        make_server(_args(files))


def test_generate_cli_on_cpu(files, tmp_path):
    cfg_path, ckpt = files
    base = ["--config", cfg_path, "--model_type", "ddpm",
            "--checkpoint", ckpt, "--device", "cpu", "--num_samples", "2",
            "--output_dir", str(tmp_path)]
    assert gen_cli.main(base) == 0
    grid = images.decode_png((tmp_path / "samples_grid.png").read_bytes())
    assert grid.shape == (34 + 2, 2 * 34 + 2, 3)
    assert images.decode_png(
        (tmp_path / "sample_0001.png").read_bytes()).shape == (32, 32, 3)
    assert gen_cli.main(base + ["--sampler", "dpm++", "--sampler_steps",
                                "3"]) == 0
    for extra, fragment in (
            (["--sampler", "dpm++"], "--sampler dpm++: num_steps must be"),
            (["--class_id", "1"], "--class_id: model is unconditional"),
            (["--inpaint_image", "x.npy"],
             "--inpaint_image requires --inpaint_mask")):
        with pytest.raises(SystemExit, match=re.escape(fragment)):
            gen_cli.main(base + extra)
    # A directory that is not one of the port's trainer checkpoints (a
    # JAX Orbax directory, say) is refused with a clear error.
    with pytest.raises(ValueError, match="Orbax"):
        gen_cli.load_params(None, str(tmp_path), use_ema=True)


def test_images_match_jax_helpers_and_png_roundtrips():
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, size=(5, 8, 8, 3)).astype(np.float32)
    u8 = images.to_uint8(x)
    np.testing.assert_array_equal(u8, jax_images.to_uint8(x))
    np.testing.assert_array_equal(images.make_grid(u8, 3),
                                  jax_images.make_grid(u8, 3))
    png = images.to_grid_png_bytes(x, 3)
    ours = images.decode_png(png)
    np.testing.assert_array_equal(
        ours, np.asarray(PIL.open(io.BytesIO(png)).convert("RGB")))
    np.testing.assert_array_equal(ours, np.asarray(PIL.open(io.BytesIO(
        jax_images.to_grid_png_bytes(x, 3))).convert("RGB")))
    with pytest.raises(ValueError):
        images.decode_png(png[:-5] + b"xxxxx")


def test_port_never_imports_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax,
    flax, optax, orbax and the JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import diffusion_model_universal_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "        'diffusion_model_universal_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
