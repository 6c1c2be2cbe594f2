"""Sampling server of the port: serve a trained diffusion model over HTTP
(counterpart of the reference's ``scripts/serve.py``, same endpoints and
JSON).

* **One batch shape.** Each request samples a full ``--serve_batch``
  batch and returns the first ``num_samples`` images, as the reference
  does, so every request costs the same.
* **One request on the card at a time.** The service holds a lock around
  sampling; the HTTP server's threads queue on it.
* **Stdlib only** (``http.server`` threading server).
* **Over ranks** (``--num_devices N``; on the CPU, N gloo processes):
  rank 0 runs the HTTP server and sends each request's parameters to
  the other ranks (``mesh.broadcast_object``); every rank samples its
  rows of the ``--serve_batch`` batch, each drawing the whole batch's
  noise, and rank 0 gathers them, so the images are one process's.
  SIGTERM or Ctrl-C on rank 0 stops the server and then every rank; a
  failed rank fails the server (``mesh.spawn``).

Endpoints:
    GET  /healthz             → 200 JSON {status, model, serve_batch,
                                devices (the ranks), requests}
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
        --model_type ddim --checkpoint model.ckpt --port 8000 --device cuda \
        [--num_devices N]

(``--model_type`` is any of ddpm, ddim, score_based, energy_based.)
"""

from __future__ import annotations

import argparse
import io
import json
import math
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..parallel import mesh
from .generate import FAST_SAMPLERS, MODEL_TYPES, rank_samples


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
    Over ranks (``scope`` of more than one), rank 0's service sends each
    request to the others, which :meth:`follow`, and gathers their rows.
    """

    def __init__(self, model, serve_batch: int, scope=None):
        self.model = model
        self.serve_batch = serve_batch
        self.scope = scope or mesh.Scope(0, 1)
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
        if class_id is not None:
            if not hasattr(self.model, "make_class_labels"):
                raise ValueError(
                    "class_id unsupported for this model family")
            self.model.make_class_labels(class_id, 1)
            class_id = int(class_id)
        request = {"seed": int(seed), "class_id": class_id,
                   "guidance_scale": (float(guidance_scale)
                                      if class_id is not None else 1.0),
                   "sampler": sampler,
                   "sampler_steps": (int(sampler_steps)
                                     if sampler != "default" else 0)}
        with self._lock:
            if self.scope.world > 1:
                mesh.broadcast_object(request)
            parts = self.scope.gather(self._sample(request))
            for part in parts:
                if isinstance(part, ValueError):
                    raise part
            out = np.concatenate(parts)[:num_samples]
            self.requests += 1
        return np.asarray(out, dtype=np.float32)

    def _sample(self, request):
        """This rank's rows of the serve_batch batch of ``request``, or
        the ValueError the sampler raised for it (every rank's goes to
        rank 0, which answers 400, and the ranks serve on)."""
        import torch
        b = self.serve_batch
        labels = None
        if request["class_id"] is not None:
            labels = self.model.make_class_labels(request["class_id"], b)
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(request["seed"])
        sampler = request["sampler"]

        def sample(rows):
            if sampler != "default":
                return getattr(self.model, FAST_SAMPLERS[sampler])(
                    b, num_steps=request["sampler_steps"], labels=labels,
                    guidance_scale=request["guidance_scale"],
                    generator=gen, rows=rows)
            if labels is not None:
                return self.model.generate_samples_cfg(
                    b, labels, guidance_scale=request["guidance_scale"],
                    generator=gen, rows=rows)
            return self.model.generate_samples(b, generator=gen, rows=rows)

        try:
            return rank_samples(sample, self.scope.rows(b), self.model)
        except ValueError as e:
            return e

    def follow(self) -> None:
        """A rank other than 0: sample its rows of each request rank 0
        sends, until rank 0 sends the stop (:meth:`stop`)."""
        while True:
            request = mesh.broadcast_object(None)
            if request is None:
                return
            self.scope.gather(self._sample(request))

    def stop(self) -> None:
        """Rank 0: release the ranks that :meth:`follow`."""
        if self.scope.world > 1:
            with self._lock:
                mesh.broadcast_object(None)


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
            self._send_json(200, {
                "status": "ok",
                "model": model_type,
                "serve_batch": service.serve_batch,
                "devices": service.scope.world,
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


def load_service(args, device=None) -> SamplerService:
    """The model of ``args`` on ``device`` (default ``--device``) in a
    service over the ranks this process has joined."""
    from ..models import MODEL_REGISTRY
    from ..utils.config import load_config, resolve_interpolations
    from .generate import load_params, resolve_model_config

    config = resolve_interpolations(load_config(args.config))
    model_cfg = resolve_model_config(config, args.checkpoint)
    model = MODEL_REGISTRY[args.model_type](
        model_cfg, device=args.device if device is None else device)
    load_params(model, args.checkpoint, args.ema)
    return SamplerService(model, args.serve_batch, mesh.sampling_scope())


def make_server(args, service=None) -> ThreadingHTTPServer:
    """Build the service (unless given) + HTTP server (separated from
    main() so tests can run it on an ephemeral port in a thread)."""
    service = service or load_service(args)
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(service, args.model_type))
    srv.service = service  # for tests / introspection
    return srv


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..models.base import resolve_device

    device = resolve_device(args.device)
    n = len(mesh.local_devices(args.num_devices, device.type))
    if n == 1:
        return serve(args, make_server(args))
    if device.type == "cuda":
        from ..ops._build import build_all
        build_all()
    return mesh.spawn(run_rank, n, args=(args,), device_type=device.type)


def run_rank(device, args) -> int:
    """One rank of ``--num_devices N`` (``mesh.spawn``'s target): rank 0
    serves until SIGTERM or SIGINT, then stops the others, which follow
    its requests (they ignore both signals and wait for its stop)."""
    service = load_service(args, device)
    srv = make_server(args, service) if mesh.rank() == 0 else None

    def shut_down(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    handler = signal.SIG_IGN if srv is None else shut_down
    prev = {sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        if srv is None:
            service.follow()
            return 0
        try:
            return serve(args, srv)
        finally:
            service.stop()
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)


def serve(args, srv) -> int:
    """Warm ``srv``'s service up, then serve until shut down."""
    dt = srv.service.warmup()
    host, port = srv.server_address[:2]
    print(f"serving {args.model_type} on http://{host}:{port} "
          f"(batch {args.serve_batch} on {srv.service.model.device}, "
          f"{srv.service.scope.world} rank(s), warmed in {dt:.1f}s)",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
