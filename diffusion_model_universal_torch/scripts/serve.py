"""Sampling server of the port: serve a trained diffusion model over HTTP
(counterpart of the reference's ``scripts/serve.py``, same endpoints and
JSON).

* **One batch shape.** Each request samples a full ``--serve_batch``
  batch and returns the first ``num_samples`` images, as the reference
  does, so every request costs the same.
* **One request on the card at a time.** The service holds a lock around
  sampling; the HTTP server's threads queue on it.
* **Stdlib only** (``http.server`` threading server).

Endpoints:
    GET  /healthz             → 200 JSON {status, model, serve_batch,
                                devices, requests}
    POST /generate            → PNG grid (default) or raw .npy
         body: {"num_samples": int ≤ serve_batch, "seed": int,
                "format": "png" | "npy",
                "class_id": int (conditional checkpoints; CFG),
                "guidance_scale": float (default 3.0),
                "sampler": "default" | "dpm++" | "heun" | "strided",
                "sampler_steps": int (default 20)}
    ``default`` is the family's own sampler: DDPM's T ancestral steps,
    DDIM's ``ddim_sampling_steps``, the score family's annealed Langevin
    ladder, the energy family's reverse sweep. ``class_id`` and the fast
    samplers are refused (400) for the score and energy families.

Usage:
    python -m diffusion_model_universal_torch.scripts.serve \
        --config diffusion_model_universal_torch/configs/ddim_config.yaml \
        --model_type ddim --checkpoint model.ckpt --port 8000 --device cuda

(``--model_type`` is any of ddpm, ddim, score_based, energy_based.)
"""

from __future__ import annotations

import argparse
import io
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .generate import FAST_SAMPLERS, MODEL_TYPES


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--model_type", type=str, required=True,
                   choices=MODEL_TYPES)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--serve_batch", type=int, default=16,
                   help="Batch sampled per request (max num_samples)")
    p.add_argument("--ema", action="store_true",
                   help="Serve the EMA weights from a trainer checkpoint")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


class SamplerService:
    """Owns the model and serves fixed-batch sampling requests.

    Sampling holds a lock, so concurrent requests run one after another
    and the launch counters of the kernels advance by whole requests.
    """

    def __init__(self, model, serve_batch: int):
        self.model = model
        self.serve_batch = serve_batch
        self.requests = 0
        self._lock = threading.Lock()

    def warmup(self) -> float:
        t0 = time.perf_counter()
        self.generate(self.serve_batch, seed=0)
        return time.perf_counter() - t0

    def generate(self, num_samples: int, seed: int, class_id=None,
                 guidance_scale: float = 3.0, sampler: str = "default",
                 sampler_steps: int = 20):
        """Sample ``num_samples`` images (≤ serve_batch) as float32 NHWC
        numpy in [-1, 1], always a whole serve_batch: ``sampler`` picks
        the family's own sampler or a fast one of ``sampler_steps``
        steps; ``class_id`` conditions on a class with classifier-free
        guidance at ``guidance_scale`` (1.0 without labels)."""
        import numpy as np
        import torch

        if not 1 <= num_samples <= self.serve_batch:
            raise ValueError(
                f"num_samples must be in [1, {self.serve_batch}] "
                f"(got {num_samples}); raise --serve_batch to serve more")
        if sampler != "default" and sampler not in FAST_SAMPLERS:
            raise ValueError(f"sampler must be one of "
                             f"{('default', *FAST_SAMPLERS)} "
                             f"(got {sampler!r})")
        if sampler != "default" and not hasattr(self.model,
                                                FAST_SAMPLERS[sampler]):
            raise ValueError(f"sampler {sampler!r} needs an ε-prediction "
                             "model (ddpm/ddim)")
        labels = None
        if class_id is not None:
            if not hasattr(self.model, "make_class_labels"):
                raise ValueError(
                    "class_id unsupported for this model family")
            labels = self.model.make_class_labels(class_id,
                                                  self.serve_batch)
        with self._lock:
            gen = torch.Generator(device=self.model.device)
            gen.manual_seed(seed)
            if sampler != "default":
                batch = getattr(self.model, FAST_SAMPLERS[sampler])(
                    self.serve_batch, num_steps=int(sampler_steps),
                    labels=labels,
                    guidance_scale=(float(guidance_scale)
                                    if labels is not None else 1.0),
                    generator=gen)
            elif labels is not None:
                batch = self.model.generate_samples_cfg(
                    self.serve_batch, labels,
                    guidance_scale=float(guidance_scale), generator=gen)
            else:
                batch = self.model.generate_samples(self.serve_batch,
                                                    generator=gen)
            out = batch[:num_samples].cpu().numpy()
            self.requests += 1
        return np.asarray(out, dtype=np.float32)


def make_handler(service: SamplerService, model_type: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path != "/healthz":
                return self._send_json(404, {"error": "not found"})
            import torch
            device = service.model.device
            self._send_json(200, {
                "status": "ok",
                "model": model_type,
                "serve_batch": service.serve_batch,
                "devices": (torch.cuda.device_count()
                            if device.type == "cuda" else 1),
                "requests": service.requests,
            })

        def do_POST(self):
            if self.path != "/generate":
                return self._send_json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                num = int(req.get("num_samples", 1))
                seed = int(req.get("seed", 0))
                fmt = req.get("format", "png")
                if fmt not in ("png", "npy"):
                    raise ValueError(
                        f"format must be 'png' or 'npy' (got {fmt!r})")
                samples = service.generate(
                    num, seed, class_id=req.get("class_id"),
                    guidance_scale=req.get("guidance_scale", 3.0),
                    sampler=req.get("sampler", "default"),
                    sampler_steps=req.get("sampler_steps", 20))
            except (ValueError, TypeError) as e:
                # TypeError covers malformed field types (null num_samples,
                # string guidance_scale, ...) — client errors, not 500s.
                return self._send_json(400, {"error": str(e)})
            except Exception as e:  # surface, don't kill the server
                return self._send_json(500, {"error": repr(e)})
            if fmt == "npy":
                import numpy as np
                buf = io.BytesIO()
                np.save(buf, samples)
                return self._send(200, buf.getvalue(),
                                  "application/octet-stream")
            from ..utils.images import to_grid_png_bytes
            nrow = int(math.ceil(math.sqrt(len(samples))))
            return self._send(200, to_grid_png_bytes(samples, nrow),
                              "image/png")

    return Handler


def make_server(args) -> ThreadingHTTPServer:
    """Build the service + HTTP server (separated from main() so tests
    can run it on an ephemeral port in a thread)."""
    from ..models import MODEL_REGISTRY
    from ..utils.config import load_config, resolve_interpolations
    from .generate import check_ported, load_params, resolve_model_config

    check_ported(args)
    config = resolve_interpolations(load_config(args.config))
    model_cfg = resolve_model_config(config, args.checkpoint)
    model = MODEL_REGISTRY[args.model_type](model_cfg, device=args.device)
    load_params(model, args.checkpoint, args.ema)

    service = SamplerService(model, args.serve_batch)
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(service, args.model_type))
    srv.service = service  # for tests / introspection
    return srv


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    srv = make_server(args)
    dt = srv.service.warmup()
    host, port = srv.server_address[:2]
    print(f"serving {args.model_type} on http://{host}:{port} "
          f"(batch {args.serve_batch} on {srv.service.model.device}, "
          f"warmed in {dt:.1f}s)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
